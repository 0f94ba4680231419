"""What the env step's CUDA graph changed in the port's state, against the
JAX package where it has a counterpart:

  * the step counter ``EnvState.common_step`` is a () int32 tensor, and
    ``ConstraintSet.curriculum_max_p`` computes the anneal's progress from
    it on its device in float32, as cat_tpu/envs/cat.py:150
    ``curriculum_max_p`` does: both agree within rtol 1e-6 (each side
    rounds the division and the anneal's four float32 operations, at most
    a few float32 spacings, 1.2e-7 each), at the anneal's start, middle,
    end and past it, and the env step anneals from the counter it is given;
  * ``CatEnv._reset_sim`` starts from a reset template made once, not from
    ``make_batched_init`` at every step: its states equal the ones of the
    code it replaced bit for bit, and it draws as much from the generator;
  * a checkpoint written while ``common_step`` was a Python int loads,
    and one written on a card (a capturable Adam) resumes on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from cat_tpu.envs.cat import curriculum_max_p
from cat_tpu.models.solo12 import solo12_model as jax_solo12
from cat_tpu.tasks.solo12_flat import solo12_constraint_terms as jax_terms
from cat_tpu_torch.envs.env import SimState
from cat_tpu_torch.rl import checkpoint
from cat_tpu_torch.rl.ppo import PPO, PpoCfg
from cat_tpu_torch.sim import engine
from cat_tpu_torch.sim import terrain as terrain_mod
from cat_tpu_torch.sim.maths import quat_from_euler_zyx
from cat_tpu_torch.tasks import solo12_flat, solo12_rough

N = 8
CURRICULUM_STEPS = 24000
RTOL = 1e-6


@pytest.fixture(scope="module")
def flat():
    return solo12_flat.make_env(N, device="cpu")


@pytest.mark.parametrize("step", [0, 1, 12000, 23999, 24000, 30000])
def test_curriculum_from_a_device_counter_matches(flat, step):
    ref = curriculum_max_p(jax_terms(jax_solo12()), jnp.asarray(step, jnp.int32),
                           CURRICULUM_STEPS)
    port = flat.cset.curriculum_max_p(torch.tensor(step, dtype=torch.int32),
                                      CURRICULUM_STEPS)
    assert port.dtype == torch.float32
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL)


def test_env_step_anneals_from_its_counter(flat):
    """A state whose counter is mid-anneal steps to the next count and the
    caps the JAX curriculum gives that count."""
    gen = torch.Generator().manual_seed(0)
    es = flat.init(gen, N)._replace(
        common_step=torch.tensor(12000, dtype=torch.int32))
    out = flat.step(es, torch.zeros(N, flat.num_actions), gen)[0]
    assert out.common_step.dtype == torch.int32 and int(out.common_step) == 12001
    ref = curriculum_max_p(jax_terms(jax_solo12()), jnp.asarray(12001, jnp.int32),
                           CURRICULUM_STEPS)
    np.testing.assert_allclose(out.max_p.numpy(), np.asarray(ref), rtol=RTOL)


def _reset_sim_before(env, gen, n, origin):
    """``CatEnv._reset_sim`` as it was: ``make_batched_init`` at every call."""
    ev = env.cfg.events
    u = env._rand(gen, n, 3 + env.model.nj)
    xy = origin + (2.0 * u[:, 0:2] - 1.0) * ev.reset_pose_xy
    yaw = (2.0 * u[:, 2] - 1.0) * ev.reset_yaw
    zero = torch.zeros_like(yaw)
    quat = quat_from_euler_zyx(zero, zero, yaw)
    lo, hi = ev.reset_joint_scale
    qj = env._qj_default * (lo + (hi - lo) * u[:, 3:])
    qj = torch.clamp(qj, env._qj_lo, env._qj_hi)
    z = (float(env.model.default_base_pos[2])
         + terrain_mod.height_at(env.cfg.terrain, xy))[:, None]
    base = engine.make_batched_init(env.model, n, env.device)
    return base._replace(qpos=torch.cat([xy, z, quat, qj], dim=1))


@pytest.mark.parametrize("task", ["flat", "rough"])
def test_reset_template_equals_make_batched_init(flat, task):
    env = flat if task == "flat" else solo12_rough.make_env(
        N, rows=3, cols=2, device="cpu")
    origin = (torch.zeros(N, 2) if task == "flat" else env._patch_origins(
        torch.arange(N, dtype=torch.int32) % 3,
        torch.arange(N, dtype=torch.int32) % 2))
    for seed in (0, 1):
        g_new = torch.Generator().manual_seed(seed)
        g_old = torch.Generator().manual_seed(seed)
        new = env._reset_sim(g_new, N, origin)
        old = _reset_sim_before(env, g_old, N, origin)
        for f, a, b in zip(SimState._fields, new, old):
            assert a.dtype == b.dtype and torch.equal(a, b), f
        assert torch.equal(g_new.get_state(), g_old.get_state())
    assert env._reset_template(N) is env._reset_template(N)


def _learner(env):
    es = env.init(torch.Generator().manual_seed(0), N)
    ppo = PPO(env, PpoCfg(num_steps=2, minibatch_size=N),
              torch.Generator().manual_seed(0))
    ppo.start(env.observe(es, torch.Generator()))
    return ppo, es


def test_checkpoint_with_an_int_counter_loads(flat, tmp_path):
    ppo, es = _learner(flat)
    tree = checkpoint.state_dict(ppo, es)
    tree["env"]["common_step"] = 4321
    torch.save(tree, str(tmp_path / "old.pt"))
    restored = checkpoint.restore(str(tmp_path / "old"), ppo, es)
    assert restored.common_step.dtype == torch.int32
    assert restored.common_step.shape == () and int(restored.common_step) == 4321
    assert torch.equal(restored.sim.qpos, es.sim.qpos)


def test_a_capturable_adams_checkpoint_resumes_on_the_cpu(flat, tmp_path):
    """The card's Adam is capturable (its step can be captured); the CPU's
    may not be: a restore keeps the live Adam's implementation."""
    ppo, es = _learner(flat)
    gen = torch.Generator().manual_seed(3)
    ppo.train_iteration(es, gen)
    tree = checkpoint.state_dict(ppo, es)
    for group in tree["ppo"]["opt"]["param_groups"]:
        group["capturable"] = True
    torch.save(tree, str(tmp_path / "card.pt"))
    fresh, es2 = _learner(flat)
    es2 = checkpoint.restore(str(tmp_path / "card"), fresh, es2)
    assert all(not g["capturable"] and g["fused"]
               for g in fresh.opt.param_groups)
    fresh.train_iteration(es2, gen)
    assert fresh.iteration == 2
