"""The port's CaT env against the JAX package's, step for step.

Both envs run the deterministic configuration of tests/_torch_port.py
(observation noise, pushes and DR ranges switched off through EnvCfg
fields, zero-width command ranges), so every random draw is irrelevant and
the two must agree; the JAX env runs its lanes engine with the
block-Jacobi solve (the path the port reproduces). Env 0 starts rolled on
its side, so the masked reset and the episode accumulators are exercised.

Tolerances: observations atol 1e-4 (joint velocities x 0.05 after a few
contact-rich control steps; measured ~3e-6), rewards atol 1e-6, constraint
probabilities atol 1e-5; the CaT running maxes rtol 1e-4 (they track
cross-env maxima of raw violations up to ~1e4, e.g. joint accelerations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import deterministic_cfgs, jax_env_lanes_bj, port_env
from cat_tpu.envs import env as jenv
from cat_tpu_torch.envs import env as tenv
from cat_tpu_torch.envs.types import StepData

N, STEPS = 6, 4
ON_ITS_SIDE = np.array([np.sqrt(0.5), np.sqrt(0.5), 0.0, 0.0], np.float32)


@pytest.fixture(scope="module")
def rollout():
    jc, tc = deterministic_cfgs(N)
    je, te = jax_env_lanes_bj(jc), port_env(tc)
    js = jax.jit(je.init, static_argnums=1)(jax.random.PRNGKey(0), N)
    ts = te.init(torch.Generator().manual_seed(0), N)
    init = (js, ts)
    js = js._replace(sim=js.sim._replace(qpos=js.sim.qpos.at[0, 3:7].set(ON_ITS_SIDE)))
    qpos = ts.sim.qpos.clone()
    qpos[0, 3:7] = torch.from_numpy(ON_ITS_SIDE)
    ts = ts._replace(sim=ts.sim._replace(qpos=qpos))
    step = jax.jit(je.step)
    gen = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(0)
    out = {k: ([], []) for k in ("obs", "reward", "dones", "time_out",
                                 "episode_prob", "episode_len", "running_max",
                                 "max_p", "command", "qpos")}
    for _ in range(STEPS):
        a = rng.uniform(-1.0, 1.0, (N, 12)).astype(np.float32)
        js, jo, jr, jd, jt = step(js, jnp.asarray(a))
        ts, to, tr, td, tt = te.step(ts, torch.from_numpy(a), gen)
        for k, (jv, tv) in dict(
                obs=(jo, to), reward=(jr, tr), dones=(jd, td),
                time_out=(jt, tt), episode_prob=(js.episode_prob, ts.episode_prob),
                episode_len=(js.episode_len, ts.episode_len),
                running_max=(js.running_max, ts.running_max),
                max_p=(js.max_p, ts.max_p), command=(js.command, ts.command),
                qpos=(js.sim.qpos, ts.sim.qpos)).items():
            out[k][0].append(np.asarray(jv))
            out[k][1].append(tv.numpy())
    return dict(env=(je, te), init=init, final=(js, ts), out=out)


@pytest.mark.parametrize("field,tol", [
    ("obs", dict(atol=1e-4)), ("reward", dict(atol=1e-6)),
    ("dones", dict(atol=1e-5)), ("time_out", dict()),
    ("episode_prob", dict(atol=1e-5)), ("episode_len", dict()),
    ("running_max", dict(rtol=1e-4, atol=1e-6)), ("max_p", dict(rtol=1e-6)),
    ("command", dict(atol=1e-7)), ("qpos", dict(atol=1e-4)),
])
def test_env_steps_match(rollout, field, tol):
    ref, port = rollout["out"][field]
    np.testing.assert_allclose(np.stack(port), np.stack(ref), **tol)


def test_tilted_env_resets(rollout):
    lens = np.stack(rollout["out"]["episode_len"][1])
    dones = np.stack(rollout["out"]["dones"][1])
    assert lens[0, 0] == 0 and dones[0, 0] == 1.0
    assert (lens[-1, 1:] == STEPS).all()


def test_init_state_matches(rollout):
    js, ts = rollout["init"]
    for f in js.sim._fields:
        np.testing.assert_allclose(getattr(ts.sim, f).numpy(),
                                   np.asarray(getattr(js.sim, f)), atol=1e-7,
                                   err_msg=f)
    for f in ("command", "mu", "running_max", "max_p", "command_time_left"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), err_msg=f)
    je, te = rollout["env"]
    np.testing.assert_allclose(
        te.observe(ts, torch.Generator()).numpy(),
        np.asarray(jax.jit(je.observe)(js)), atol=1e-6)


def test_drain_metrics_match(rollout):
    je, te = rollout["env"]
    js, ts = rollout["final"]
    _, jm = je.drain_metrics(js)
    ts2, tm = te.drain_metrics(ts)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert float(tm["Episode/count"]) == 1.0
    assert float(ts2.acc_count) == 0.0


def test_constraint_layout_matches(rollout):
    je, te = rollout["env"]
    assert [t.name for t in te.cset.terms] == [t.name for t in je.cset.terms]
    assert te.cset.slices == je.cset.slices
    assert te.cset.total_cols == je.cset.total_cols == 78
    assert te.num_obs == je.num_obs == 45


def _random_step_data(env_j, env_t, rng, n=16):
    """The same random StepData for both packages (contact history and
    touchdowns included, so every term fires somewhere)."""
    nr, nf = 13, 4
    arrs = dict(
        joint_pos=rng.normal(0, 1.0, (n, 12)), joint_vel=rng.normal(0, 10, (n, 12)),
        joint_acc=rng.normal(0, 500, (n, 12)), applied_torque=rng.normal(0, 3, (n, 12)),
        base_pos=rng.normal(0, 0.1, (n, 3)) + [0, 0, 0.25],
        base_yaw=rng.uniform(-3, 3, n), base_lin_vel_b=rng.normal(0, 0.5, (n, 3)),
        base_ang_vel_b=rng.normal(0, 0.5, (n, 3)),
        projected_gravity=rng.normal(0, 0.3, (n, 3)) - [0, 0, 1],
        command=rng.uniform(-1, 1, (n, 3)), action=rng.normal(0, 1, (n, 12)),
        prev_action=rng.normal(0, 1, (n, 12)),
        force_hist=np.abs(rng.normal(0, 20, (n, 3, nr, 3))),
        last_air_time=rng.uniform(0, 0.5, (n, nf)),
    )
    arrs = {k: np.asarray(v, np.float32) for k, v in arrs.items()}
    touchdown = rng.uniform(size=(n, nf)) < 0.5
    dj = jenv.StepData(**{k: jnp.asarray(v) for k, v in arrs.items()},
                       touchdown=jnp.asarray(touchdown),
                       default_joint_pos=env_j.default_joint_pos_task,
                       step_dt=0.02)
    dt = StepData(**{k: torch.from_numpy(v) for k, v in arrs.items()},
                  touchdown=torch.from_numpy(touchdown),
                  default_joint_pos=env_t.default_joint_pos_task,
                  step_dt=0.02)
    return dj, dt


@pytest.mark.parametrize("seeded", [False, True])
def test_cat_transform_matches(rollout, seeded):
    """ConstraintSet.compute: probabilities, running max (from the unseeded
    sentinel and from a seeded state), per-term maxima and violations."""
    je, te = rollout["env"]
    dj, dt = _random_step_data(je, te, np.random.default_rng(5))
    rng = np.random.default_rng(6)
    rmax = (rng.uniform(0.5, 50.0, te.cset.total_cols).astype(np.float32)
            if seeded else np.full(te.cset.total_cols, -1.0, np.float32))
    max_p = rng.uniform(0.05, 1.0, te.cset.n_terms).astype(np.float32)
    ref = je.cset.compute(dj, jnp.asarray(rmax), jnp.asarray(max_p))
    port = te.cset.compute(dt, torch.from_numpy(rmax), torch.from_numpy(max_p))
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("common_step", [0, 1, 5000, 24000, 90000])
def test_curriculum_max_p_matches(rollout, common_step):
    from cat_tpu.envs.cat import curriculum_max_p

    je, te = rollout["env"]
    ref = curriculum_max_p(je.cset.terms, jnp.asarray(common_step, jnp.int32),
                           24000)
    np.testing.assert_allclose(
        te.cset.curriculum_max_p(common_step, 24000).numpy(), np.asarray(ref),
        rtol=1e-6)


def test_resolve_names_matches():
    names = ["FL_HAA", "FL_HFE", "FR_HAA", "HR_KFE", "HL_HAA"]
    for pats, keep in (([".*_HAA"], False), (["HL_.*", "FL_.*"], True),
                       (["FR_HAA", "FL_HAA"], True)):
        np.testing.assert_array_equal(tenv.resolve_names(pats, names, keep),
                                      jenv.resolve_names(pats, names, keep))
