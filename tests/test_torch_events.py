"""The port's domain-randomization events against the JAX package's: the
randomize_body_coms startup event (the counterpart of
tests/test_events.py::test_com_randomization_changes_dynamics) and the
three firing modes of ``EventTerm`` (tests/test_events_ext.py).

Both envs run the deterministic configuration of tests/_torch_port.py; the
JAX one runs its lanes engine with the block-Jacobi solve. The CoM offsets
the port draws are injected into the JAX env's state, so both step the same
shifted bodies. Tolerances are those of tests/test_torch_env.py: qpos atol
1e-4, velocities atol 2e-3 (its observation bound of 1e-4 on joint
velocities scaled by 0.05); what a term sets (friction, a velocity) to
1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import deterministic_cfgs, jax_env_lanes_bj, port_env
from cat_tpu.envs import env as jenv
from cat_tpu.utils.overrides import apply_overrides as japply
from cat_tpu_torch.envs import env as tenv
from cat_tpu_torch.rl import checkpoint
from cat_tpu_torch.rl.ppo import PPO, PpoCfg
from cat_tpu_torch.tasks import solo12_flat
from cat_tpu_torch.utils.overrides import apply_overrides

N, STEPS = 8, 5
COM = dict(com_displacement=0.05, com_bodies=("base_link",))
ON_ITS_SIDE = np.array([np.sqrt(0.5), np.sqrt(0.5), 0.0, 0.0], np.float32)


def _with_events(cfg, **kw):
    return dataclasses.replace(cfg, events=dataclasses.replace(cfg.events,
                                                               **kw))


@pytest.fixture(scope="module")
def com_runs():
    """The port's CoM env from seed 0 and the JAX env with its offsets,
    STEPS zero-action steps each; the port's env without offsets beside."""
    jc, tc = deterministic_cfgs(N)
    te, te0 = port_env(_with_events(tc, **COM)), port_env(tc)
    je = jax_env_lanes_bj(_with_events(jc, **COM))
    ts = te.init(torch.Generator().manual_seed(0), N)
    ts0 = te0.init(torch.Generator().manual_seed(0), N)
    js = jax.jit(je.init, static_argnums=1)(jax.random.PRNGKey(0), N)
    js = js._replace(com_offset=jnp.asarray(ts.com_offset.numpy()))
    init = (ts, ts0)
    step = jax.jit(je.step)
    gen, gen0 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    zero = torch.zeros(N, te.num_actions)
    for _ in range(STEPS):
        js = step(js, jnp.zeros((N, te.num_actions)))[0]
        ts = te.step(ts, zero, gen)[0]
        ts0 = te0.step(ts0, zero, gen0)[0]
    return dict(env=te, init=init, final=(js, ts, ts0))


def test_com_offsets_in_range_on_the_named_bodies(com_runs):
    te = com_runs["env"]
    ts, ts0 = com_runs["init"]
    off = ts.com_offset.numpy()
    assert off.shape == (N, te.model.nbody, 3)
    assert np.abs(off).max() <= 0.05
    base = te.model.body_names.index("base_link")
    np.testing.assert_array_equal(np.unique(np.nonzero(np.abs(off).sum(-1))[1]),
                                  [base])
    assert not np.allclose(off[0, base], off[1, base])
    # drawn after every other startup draw: the rest of the state is the
    # one the env without the event starts from
    assert not ts0.com_offset.any()
    for f in ts.sim._fields:
        assert torch.equal(getattr(ts.sim, f), getattr(ts0.sim, f)), f
    assert torch.equal(ts.mu, ts0.mu) and torch.equal(ts.command, ts0.command)


def test_com_randomization_changes_dynamics(com_runs):
    js, ts, ts0 = com_runs["final"]
    np.testing.assert_allclose(ts.sim.qpos.numpy(), np.asarray(js.sim.qpos),
                               atol=1e-4)
    dq = (ts.sim.qpos - ts0.sim.qpos).abs().max().item()
    assert dq > 1e-5, "CoM offsets had no effect on dynamics"


# the three modes, one term each, in both packages (tests/test_events_ext.py)

def _jax_startup_mu(key, n, model, value):
    return {"mu": jnp.full((n,), value)}


def _jax_reset_lift(key, sim, rmask, model, dz):
    return sim._replace(qpos=sim.qpos.at[:, 2].add(jnp.where(rmask, dz, 0.0)))


def _jax_interval_spin(key, sim, state, cfg, wz):
    return sim._replace(qvel=sim.qvel.at[:, 5].set(wz))


def _startup_mu(gen, n, model, value):
    return {"mu": torch.full((n,), value)}


def _reset_lift(gen, sim, reset, model, dz):
    qpos = sim.qpos.clone()
    qpos[:, 2] += torch.where(reset, dz, 0.0)
    return sim._replace(qpos=qpos)


def _interval_spin(gen, sim, state, cfg, wz):
    qvel = sim.qvel.clone()
    qvel[:, 5] = wz
    return sim._replace(qvel=qvel)


def _terms(m, startup, reset, interval):
    return (m.EventTerm("fix_mu", "startup", startup, dict(value=0.123)),
            m.EventTerm("lift", "reset", reset, dict(dz=3.0)),
            m.EventTerm("spin", "interval", interval, dict(wz=2.5)))


@pytest.fixture(scope="module")
def term_runs():
    """Both packages with one term of each mode; env 0 starts on its side,
    so it resets (upside down) at the first step."""
    jc, tc = deterministic_cfgs(N)
    je = jax_env_lanes_bj(_with_events(jc, extra_terms=_terms(
        jenv, _jax_startup_mu, _jax_reset_lift, _jax_interval_spin)))
    te = port_env(_with_events(tc, extra_terms=_terms(
        tenv, _startup_mu, _reset_lift, _interval_spin)))
    js = jax.jit(je.init, static_argnums=1)(jax.random.PRNGKey(0), N)
    ts = te.init(torch.Generator().manual_seed(0), N)
    init = (js, ts)
    js = js._replace(sim=js.sim._replace(
        qpos=js.sim.qpos.at[0, 3:7].set(ON_ITS_SIDE)))
    qpos = ts.sim.qpos.clone()
    qpos[0, 3:7] = torch.from_numpy(ON_ITS_SIDE)
    ts = ts._replace(sim=ts.sim._replace(qpos=qpos))
    js = jax.jit(je.step)(js, jnp.zeros((N, te.num_actions)))[0]
    ts = te.step(ts, torch.zeros(N, te.num_actions), torch.Generator())[0]
    return dict(init=init, step=(js, ts))


def test_startup_term_sets_env_state_fields(term_runs):
    js, ts = term_runs["init"]
    np.testing.assert_allclose(ts.mu.numpy(), 0.123, atol=1e-6)
    np.testing.assert_allclose(ts.mu.numpy(), np.asarray(js.mu), atol=1e-6)


def test_reset_term_fires_only_on_reset_envs(term_runs):
    js, ts = term_runs["step"]
    reset = ts.episode_len.numpy() == 0
    np.testing.assert_array_equal(reset, np.asarray(js.episode_len) == 0)
    assert reset[0] and not reset[1:].any()
    z = ts.sim.qpos[:, 2].numpy()
    # lifted 3 m by the reset event (the spawn height is ~0.3 m)
    assert (z[reset] > 2.0).all() and (z[~reset] < 2.0).all()
    np.testing.assert_allclose(ts.sim.qpos.numpy(), np.asarray(js.sim.qpos),
                               atol=1e-4)


def test_interval_term_fires_every_step(term_runs):
    js, ts = term_runs["step"]
    np.testing.assert_allclose(ts.sim.qvel[:, 5].numpy(), 2.5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(js.sim.qvel[:, 5]), 2.5, atol=1e-6)
    np.testing.assert_allclose(ts.sim.qvel.numpy(), np.asarray(js.sim.qvel),
                               atol=2e-3)


def test_com_overrides_coerce_as_the_reference():
    overrides = ["events.com_displacement=0.05",
                 "events.com_bodies=('base_link',)"]
    jc, tc = deterministic_cfgs(N)
    ours, ref = apply_overrides(tc, overrides), japply(jc, overrides)
    assert ours.events.com_displacement == ref.events.com_displacement == 0.05
    assert ours.events.com_bodies == ref.events.com_bodies == ("base_link",)
    env = solo12_flat.make_env(4, overrides=overrides, device="cpu")
    es = env.init(torch.Generator().manual_seed(0), 4)
    assert es.com_offset.abs().max() > 0.0


def test_checkpoint_without_com_offset_restores_zeros(tmp_path):
    """A checkpoint written before EnvState had com_offset restores with
    no CoM shift in its place."""
    env = solo12_flat.make_env(4, overrides=["events.com_displacement=0.05"],
                               device="cpu")
    es = env.init(torch.Generator().manual_seed(0), 4)
    ppo = PPO(env, PpoCfg(), torch.Generator().manual_seed(0))
    ppo.start(env.observe(es, torch.Generator()))
    tree = checkpoint.state_dict(ppo, es)
    del tree["env"]["com_offset"]
    torch.save(tree, str(tmp_path / "old.pt"))
    assert es.com_offset.abs().max() > 0.0
    restored = checkpoint.restore(str(tmp_path / "old"), ppo, es)
    assert restored.com_offset.shape == es.com_offset.shape
    assert not restored.com_offset.any()
    assert torch.equal(restored.sim.qpos, es.sim.qpos)
