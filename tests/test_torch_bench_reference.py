"""The bench's plain references (``cat_tpu_torch.bench_reference``).

The reference's mass matrix and bias forces come from the kinetic and
potential energy by automatic differentiation; they are held against the
JAX package's Newton-Euler terms (``cat_tpu/sim/dynamics.py``) on seeded
random states of both robots, within 2e-5 of the largest entry (the JAX
terms are float32). Then the checks the bench builds on them must pass on
the sound program and fail on a faulty one: the learner check on a tiny
PPO whose Adam epsilon, learning rate, GAE lambda or minibatch draw is
wrong, and its ``timed_path`` check on a graphed iteration whose replay
is stale; the control-step check on an engine whose base mass, armature or
centres of mass differ from the model the reference reads.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from _torch_steps import stand_in_graphs
from cat_tpu.models.go2 import go2_model as jax_go2
from cat_tpu.models.solo12 import solo12_model as jax_solo12
from cat_tpu.sim import dynamics as jdyn
from cat_tpu_torch import bench
from cat_tpu_torch import bench_reference as ref
from cat_tpu_torch.models.go2 import go2_model
from cat_tpu_torch.models.solo12 import solo12_model
from cat_tpu_torch.rl import ppo as ppo_mod
from cat_tpu_torch.tasks import registry
from cat_tpu_torch.utils import graphs

ROBOTS = {"solo12": (solo12_model, jax_solo12), "go2": (go2_model, jax_go2)}


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_energy_terms_match_the_jax_dynamics(robot):
    model, jmodel = ROBOTS[robot][0](), ROBOTS[robot][1]()
    n = 6
    rng = np.random.default_rng(3)
    quat = rng.standard_normal((n, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    qpos = np.concatenate([
        rng.uniform(-2, 2, (n, 3)), quat,
        model.default_qpos_joints + 0.3 * rng.standard_normal((n, model.nj))],
        axis=1)
    qvel = rng.standard_normal((n, model.nv))

    def terms(q, v):
        kin = jdyn.fk(jmodel, q, v)
        jacs = jdyn.body_jacobians(jmodel, kin, jmodel.ancestor_mask())
        I_w = jdyn.world_inertias(jmodel, kin)
        return (jdyn.mass_matrix(jmodel, jacs, I_w),
                jdyn.bias_forces(jmodel, kin, jacs, I_w, v))

    M_j, C_j = jax.vmap(terms)(jnp.asarray(qpos, jnp.float32),
                               jnp.asarray(qvel, jnp.float32))
    M, C = ref.mass_and_bias(model, torch.as_tensor(qpos),
                             torch.as_tensor(qvel))
    assert ref.relative_err(torch.as_tensor(np.array(M_j)), M) < 2e-5
    assert ref.relative_err(torch.as_tensor(np.array(C_j)), C) < 2e-5


def test_stored_values_are_allowed_one_float32_ulp():
    x = torch.tensor([40.0, 1.0], dtype=torch.float64)
    step = torch.tensor([1e-4, 1e-4], dtype=torch.float64)
    near = x + torch.tensor([3e-6, 0.0], dtype=torch.float64)  # < 1 ulp at 40
    assert ref.relative_err(near, x, step) == pytest.approx(0.03)
    assert ref.relative_err(near, x, step, stored=True) == 0.0
    far = x + torch.tensor([1e-5, 0.0], dtype=torch.float64)
    assert ref.relative_err(far, x, step, stored=True) == pytest.approx(
        (1e-5 - ref.F32_ULP * 40.0) / 1e-4)


def _half_batch(mp, ppo):
    real = torch.randperm
    mp.setattr(torch, "randperm", lambda n, **k: real(n, **k) % (n // 2))


def _gae_lambda(mp, ppo):
    real = ppo_mod.gae
    mp.setattr(ppo_mod, "gae", lambda *a: real(*a[:-1], 0.9))


LEARNER_FAULTS = {
    "none": lambda mp, ppo: None,
    "adam_eps": lambda mp, ppo: ppo.opt.param_groups[0].update(eps=1e-8),
    "learning_rate": lambda mp, ppo: mp.setattr(
        ppo, "set_iteration_lr", lambda: ppo.lr.fill_(1.1 * 3e-4)),
    "gae_lambda": _gae_lambda,
    "half_batch": _half_batch,
}


@pytest.mark.parametrize("fault", LEARNER_FAULTS)
def test_learner_check_passes_the_trainer_and_catches_faults(fault,
                                                             monkeypatch):
    """4 envs, the recipe's 24 steps, 6 minibatches of 16 rows; one
    iteration first, so Adam and the normalisers carry state."""
    spec = registry.get(bench.FLAT_TASK)
    env = spec.make_env(4, device="cpu")
    cfg = dataclasses.replace(spec.make_agent_cfg(), minibatch_size=16)
    gen = torch.Generator().manual_seed(0)
    es = env.init(gen, 4)
    ppo = ppo_mod.PPO(env, cfg, torch.Generator().manual_seed(0))
    ppo.start(env.observe(es, gen))
    es, _ = ppo.train_iteration(es, gen)
    cell = bench.Cell("test", "cpu", ())
    with monkeypatch.context() as mp:
        LEARNER_FAULTS[fault](mp, ppo)
        bench.learner_check(cell, env, ppo, es, gen)
    assert cell.checks["learner"] == (fault == "none"), cell.counts
    if fault != "half_batch":     # that one stops at the minibatch rows
        assert cell.checks["learner_control"]


def _stale_outputs(mp):
    """A replay that copies its inputs in and runs nothing: its outputs,
    the parameters and Adam's state stay as the capture left them (a
    value baked in at capture)."""
    mp.setattr(graphs.Graph, "replay", lambda self, inputs: None)


def _unregistered_generator(mp):
    """A replay that draws what its capture drew and leaves the generator
    where it was, as a graph whose generator was not registered with it
    (the minibatch permutations and the actions repeat)."""
    capture, replay = graphs.Graph.capture, graphs.Graph.replay

    def captured(self, fn, inputs):
        self.drawn = [g.get_state() for g in self.generators]
        capture(self, fn, inputs)

    def replayed(self, inputs):
        now = [g.get_state() for g in self.generators]
        for g, state in zip(self.generators, self.drawn):
            g.set_state(state)
        replay(self, inputs)
        for g, state in zip(self.generators, now):
            g.set_state(state)

    mp.setattr(graphs.Graph, "capture", captured)
    mp.setattr(graphs.Graph, "replay", replayed)


TIMED_PATH_FAULTS = {
    "none": lambda mp: None,
    "stale_outputs": _stale_outputs,
    "unregistered_generator": _unregistered_generator,
}


@pytest.mark.parametrize("fault", TIMED_PATH_FAULTS)
def test_timed_path_check_holds_the_graphed_iteration(fault, monkeypatch):
    """The learner check on the iteration the card's window times, the
    replays of ``PPO.rollout`` and ``PPO.learn``, here with the stand-in
    graphs of ``_torch_steps.stand_in_graphs`` (a replay runs the body on
    the graph's buffers again): after the warm-up and the capture, the
    check's timed iteration is a replay. A replay at fault fails
    ``timed_path`` and leaves the tape's check passing: the tape runs the
    iteration launched from the host, from the same state."""
    stand_in_graphs(monkeypatch)
    spec = registry.get(bench.FLAT_TASK)
    env = spec.make_env(4, device="cpu")
    cfg = dataclasses.replace(spec.make_agent_cfg(), minibatch_size=16)
    gen = torch.Generator().manual_seed(0)
    es = env.init(gen, 4)
    ppo = ppo_mod.PPO(env, cfg, torch.Generator().manual_seed(0))
    ppo.start(env.observe(es, gen))
    if fault == "unregistered_generator":
        TIMED_PATH_FAULTS[fault](monkeypatch)
    monkeypatch.setattr(ppo, "train_iteration",
                        lambda es, gen: ppo.learn(*ppo.rollout(es, gen), gen))
    for _ in range(2):      # the warm-up, the capture
        es, _ = ppo.train_iteration(es, gen)
    if fault == "stale_outputs":
        TIMED_PATH_FAULTS[fault](monkeypatch)
    cell = bench.Cell("test", "cpu", ())
    bench.learner_check(cell, env, ppo, es, gen)
    assert cell.checks["timed_path"] == (fault == "none")
    assert cell.checks["learner"] and ppo.iteration == 3
    assert sorted(k[0] for k in ppo.graphs) == ["learn", "rollout"]


ENGINE_FAULTS = {
    "none": lambda mt: mt,
    "base_mass": lambda mt: dataclasses.replace(
        mt, mass=mt.mass * torch.tensor([1.02] + [1.0] * (len(mt.mass) - 1))),
    "armature": lambda mt: dataclasses.replace(
        mt, armature_diag=torch.zeros_like(mt.armature_diag)),
    "com": lambda mt: dataclasses.replace(mt, com=mt.com + 0.002),
}


@pytest.mark.parametrize("fault", ENGINE_FAULTS)
def test_control_step_check_passes_the_engine_and_catches_faults(fault):
    """The engine cell's traffic at 8 envs, 10 control steps in (contacts
    made), then the check of one more on an engine whose tensors may
    differ from the model the reference reads."""
    eng, s, targets, mu = bench.rough_traffic("cpu", 8, 11, seed=0)
    for k in range(10):
        s = eng(s, targets[k], mu)
    cell = bench.Cell("test", "cpu", ())
    bench.control_step_check(cell, eng._replace(mt=ENGINE_FAULTS[fault](
        eng.mt)), s, targets[10], mu)
    assert cell.checks["control_step"] == (fault == "none"), cell.counts
    assert cell.checks["control_step_control"]
