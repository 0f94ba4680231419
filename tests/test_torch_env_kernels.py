"""The env step's plain stages (envs/env.py CatEnv terms_stage,
update_stage, obs_stage: the plain versions of ops/env_step.py's three
kernels) against the JAX package, and the constraint descriptor table the
kernels read.

Both envs start from one state made with numpy from a seed (a random
post-physics SimState on the flat and on a small rough grid,
``generate_rough(rows=2, cols=2)``, with envs forced to time out, to tip
over and to touch with their base), and both steps take the same draws:
the JAX step's ``jax.random.uniform`` and the port's ``CatEnv._rand`` pop
one list of numpy uniforms, and each env's physics step returns that state
(the JAX step un-jitted, on the CPU). Then:
  * the raw constraint columns and their maxima against the JAX term
    functions (cat_tpu/envs/constraints.py through cat_tpu/envs/cat.py's
    terms): rtol 1e-5, atol 1e-5 (the force norms of the two packages sum
    their squares in another order; accelerations reach ~1e3);
  * the whole step (terminations, cstr_prob and the reward, dones, the
    running max, max_p, the accumulators, the curriculum, the masked
    reset, the commands, the push, the observation with the noise)
    against the JAX step's fields: atol 1e-5 and rtol 1e-5 (a reset pose's
    cos and sin and the height scan's grid coordinate round differently in
    XLA; the probabilities divide by the running max), the flags equal;
  * the height scan of obs_stage against the JAX observation (its scan
    through cat_tpu/sim/terrain.py height_at) at rotated scan points, with
    bases off the grid and one at a NaN position: atol 1e-5 (the grid
    coordinate x / cell rounds once more or less: ~1e-6 m at 8 m, times a
    slope up to 0.25), NaN where the JAX scan is NaN;
  * the term table covers every term of the six registered tasks, and
    rebuilt from the table alone (the kernels' view of the terms, a
    task's own PyTorch function for a term outside the kernels' kinds)
    the raw columns equal ``ConstraintSet.raw`` bit for bit;
  * the measuring side: ``measure.env_counts`` counts each heightfield
    cell a step reads once, and ``measure.plain_stages`` records a step's
    stages without changing what the step gives.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import deterministic_cfgs, jax_env_lanes_bj, port_env
from cat_tpu.envs import env as jenv
from cat_tpu.envs.cat import _as_2d as jax_as_2d
from cat_tpu.sim import terrain as jterrain
from cat_tpu_torch.envs import constraints as C
from cat_tpu_torch.envs import env as tenv
from cat_tpu_torch.envs.cat import GIVEN, KERNEL_TERMS, ConstraintTerm, _as_2d
from cat_tpu_torch.envs.types import StepData
from cat_tpu_torch.models.solo12 import SOLO12_ACTUATED_JOINT_ORDER
from cat_tpu_torch.ops.env_step import ObsDraws
from cat_tpu_torch.sim import terrain as tterrain
from cat_tpu_torch.sim.engine import SimState
from cat_tpu_torch.tasks import registry

N = 48
ROUGH = dict(rows=2, cols=2, patch_m=8.0, cell=0.1, seed=3)
RTOL = ATOL = 1e-5


def _cfgs(kind):
    """(JAX, port) EnvCfgs: the deterministic configurations of
    tests/_torch_port.py with the draws back on (noise, pushes, command
    and reset ranges) and, for rough, the small grid with the scan and the
    curriculum."""
    out = []
    for m, t, c in zip((jenv, tenv), (jterrain, tterrain), deterministic_cfgs(N)):
        c = dataclasses.replace(
            c, commands=m.CommandsCfg(), events=m.EventsCfg(),
            noise=m.NoiseCfg())
        if kind == "rough":
            c = dataclasses.replace(
                c, terrain=t.generate_rough(**ROUGH),
                height_scan=m.HeightScanCfg(), terrain_curriculum=True,
                terminations=m.TerminationsCfg(upside_down_limit=0.7))
        out.append(c)
    return out


def _state_arrays(env, rng):
    """numpy arrays of an EnvState and of the post-physics SimState: a
    random pose near the patches, random velocities and forces; env 0
    times out, env 1 lies on its side, env 2 has its base in contact, env 3
    walked far from its origin (a curriculum promotion), env 4 is on its
    last step of a command."""
    m, cfg = env.model, env.cfg
    nq, nv, nj, nr, nf = m.nq, m.nv, m.nj, m.nreport, len(m.foot_report_ids)
    nt, K = env.cset.n_terms, env.cset.total_cols
    f32 = np.float32
    yaw = rng.uniform(-np.pi, np.pi, N)
    tilt = rng.normal(0, 0.05, (N, 2))
    quat = np.stack([np.cos(yaw / 2), tilt[:, 0], tilt[:, 1], np.sin(yaw / 2)], 1)
    quat[1] = [np.sqrt(0.5), np.sqrt(0.5), 0, 0]
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    if cfg.terrain.kind == "hfield":
        row = rng.integers(0, cfg.terrain.rows, N)
        col = np.arange(N) % cfg.terrain.cols
        H, W = cfg.terrain.size_m
        origin = np.stack([(row + 0.5) * cfg.terrain.patch_m - H / 2,
                           (col + 0.5) * cfg.terrain.patch_m - W / 2], 1)
    else:
        row = col = np.zeros(N, int)
        origin = np.zeros((N, 2))
    xy = origin + rng.normal(0, 0.5, (N, 2))
    command = rng.uniform(-0.8, 0.8, (N, 3))
    xy[3] = origin[3] + command[3, :2] * cfg.episode_length_s
    qpos = np.concatenate([xy, rng.uniform(0.2, 0.35, (N, 1)), quat,
                           m.default_qpos_joints + rng.normal(0, 0.3, (N, nj))], 1)
    hist = np.abs(rng.normal(0, 0.2, (N, 3, nr, 3)))
    hist[:, :, np.asarray(m.foot_report_ids)] *= 180.0
    hist[2, 1, 0] = [0.0, 0.0, 5.0]
    episode_len = rng.integers(0, cfg.max_episode_length - 1, N)
    episode_len[0] = cfg.max_episode_length - 1
    time_left = rng.uniform(0.05, 10.0, N)
    time_left[4] = 0.01
    sim = dict(
        qpos=qpos, qvel=rng.normal(0, 0.8, (N, nv)),
        lam=rng.uniform(0, 0.1, (N, 3 * m.ncand)),
        applied_torque=rng.normal(0, 3, (N, nj)),
        joint_acc=rng.normal(0, 600, (N, nj)),
        forces=rng.normal(0, 10, (N, 3 * nr)),
        force_hist=hist.reshape(N, 9 * nr),
        current_air_time=rng.uniform(0, 0.4, (N, nf)),
        last_air_time=rng.uniform(0, 0.4, (N, nf)),
        current_contact_time=rng.uniform(0, 0.4, (N, nf)),
        last_contact_time=rng.uniform(0, 0.4, (N, nf)),
        touchdown=rng.uniform(size=(N, nf)) < 0.5)
    state = dict(
        action=rng.normal(0, 1, (N, nj)), prev_action=rng.normal(0, 1, (N, nj)),
        episode_len=episode_len.astype(np.int32), command=command,
        command_time_left=time_left, mu=rng.uniform(0.5, 1.25, N),
        com_offset=np.zeros((N, m.nbody, 3)),
        running_max=rng.uniform(0.5, 50.0, K),
        max_p=np.full(nt, 0.25), episode_viol=rng.integers(0, 5, (N, nt)),
        episode_prob=rng.uniform(0, 2, (N, nt)),
        episode_rew=rng.uniform(0, 3, N), origin=origin,
        terrain_row=row.astype(np.int32), terrain_col=col.astype(np.int32),
        common_step=np.int32(5000), acc_viol=rng.uniform(0, 9, nt),
        acc_prob=rng.uniform(0, 9, nt), acc_rew=f32(1.5), acc_len=f32(300.0),
        acc_count=f32(3.0), acc_term=rng.uniform(0, 3, 3))
    cast = {k: (v if v.dtype in (np.int32, np.bool_) else v.astype(f32))
            for k, v in ((k, np.asarray(v)) for k, v in {**sim, **state}.items())}
    state["running_max"][:5] = -1.0     # some columns not yet seeded
    cast["running_max"] = state["running_max"].astype(f32)
    return ({k: cast[k] for k in sim}, {k: cast[k] for k in state})


def _states(je, te, sim_a, state_a):
    """(JAX EnvState, port EnvState, JAX sim, port sim) of the arrays; the
    states' sims are the post-physics ones too (the physics is replaced)."""
    from cat_tpu.sim.engine import SimState as JSim

    jsim = JSim(**{k: jnp.asarray(v) for k, v in sim_a.items()})
    js = jenv.EnvState(sim=jsim, **{k: jnp.asarray(v) for k, v in state_a.items()},
                       seed=jnp.zeros(N, jnp.uint32))
    ts, tsim = _states_port(te, sim_a, state_a)
    return js, ts, jsim, tsim


class _Draws:
    """One list of numpy uniforms both packages pop, in their draws' order;
    the flip, resample and push chances made small in a few envs so that
    those paths fire."""

    def __init__(self, rng):
        self.rng, self.made, self.i = rng, [], 0

    def next(self, shape):
        if self.i == len(self.made):
            u = self.rng.uniform(size=shape).astype(np.float32)
            if len(shape) == 1:
                u[::5] *= 1e-4
            self.made.append(u)
        u = self.made[self.i]
        assert u.shape == tuple(shape)
        self.i += 1
        return u


@pytest.fixture(scope="module", params=["flat", "rough"])
def stepped(request):
    """Both steps from one state with one list of draws: (kind, JAX env,
    port env, the JAX step's outputs, the port's, the JAX and port states
    and sims)."""
    jc, tc = _cfgs(request.param)
    je, te = jax_env_lanes_bj(jc), port_env(tc)
    sim_a, state_a = _state_arrays(te, np.random.default_rng(11))
    js, ts, jsim, tsim = _states(je, te, sim_a, state_a)
    draws = _Draws(np.random.default_rng(12))
    je._engine_step = lambda *a: jsim
    te.engine = lambda *a: tsim

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(minval + (maxval - minval) * draws.next(shape))

    action = np.random.default_rng(13).uniform(-1, 1, (N, 12)).astype(np.float32)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax.random, "uniform", uniform)
        jout = je.step(js, jnp.asarray(action))
    finally:
        mp.undo()
    n_jax = draws.i
    draws.i = 0
    te._rand = lambda gen, *shape: torch.from_numpy(draws.next(shape))
    tout = te._step_eager(ts, torch.from_numpy(action), torch.Generator())
    assert draws.i == n_jax          # the same draws, in the same order
    return request.param, je, te, jout, tout, (js, ts, jsim, tsim, action)


def test_raw_columns_and_maxima_match_the_jax_terms(stepped):
    kind, je, te, _, _, (js, ts, jsim, tsim, action) = stepped
    dj = je._step_data(jsim, js.command, jnp.asarray(action), js.action)
    raw_j = np.asarray(jnp.concatenate(
        [jax_as_2d(t.func(dj, **t.params)) for t in je.cset.terms], 1))
    terms = te.terms_stage(ts, tsim, torch.from_numpy(action), ts.action)
    assert terms.raw.shape == raw_j.shape == (N, 78)
    np.testing.assert_allclose(terms.raw.numpy(), raw_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(terms.col_max.numpy(),
                               np.maximum(raw_j.max(0), 1e-6),
                               rtol=RTOL, atol=ATOL)
    # the forced envs: a time out, a tilt, a base contact
    assert bool(terms.time_out[0]) and bool(terms.upside[1])
    assert bool(terms.illegal[2])


@pytest.mark.parametrize("field", [
    "obs", "reward", "dones", "time_out", "running_max", "max_p",
    "episode_len", "episode_viol", "episode_prob", "episode_rew", "acc_viol",
    "acc_prob", "acc_rew", "acc_len", "acc_count", "acc_term", "command",
    "command_time_left", "origin", "terrain_row", "action", "prev_action",
    "qpos", "qvel", "lam", "force_hist", "touchdown"])
def test_step_fields_match_the_jax_step(stepped, field):
    """The port's step through its three plain stages against the JAX step
    from the same state and draws; cstr_prob shows in dones (every env
    that does not reset) and in the reward."""
    _, _, _, jout, tout, _ = stepped
    jstate, tstate = jout[0], tout[0]
    outs = dict(obs=1, reward=2, dones=3, time_out=4)
    if field in outs:
        a, b = np.asarray(jout[outs[field]]), tout[outs[field]].numpy()
    elif hasattr(tstate.sim, field):
        a, b = np.asarray(getattr(jstate.sim, field)), getattr(tstate.sim,
                                                               field).numpy()
    else:
        a, b = np.asarray(getattr(jstate, field)), getattr(tstate, field).numpy()
    if a.dtype in (np.bool_, np.int32):
        np.testing.assert_array_equal(b, a)
    else:
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


def test_the_step_exercised_its_paths(stepped):
    """Resets, a scheduled command, resamples and pushes happened; on rough
    the curriculum moved env 3 up a row."""
    kind, _, te, _, tout, (js, ts, *_ ) = stepped
    state = tout[0]
    assert int(state.acc_count - ts.acc_count) >= 3
    assert float(state.command_time_left[4]) == pytest.approx(
        te.cfg.commands.resampling_time)
    if kind == "rough":
        assert int(state.terrain_row[3]) == min(int(ts.terrain_row[3]) + 1,
                                                te.cfg.terrain.rows - 1)


def test_scan_matches_jax_height_at_off_the_grid_and_at_nan():
    """obs_stage's height scan against the JAX observation's scan (its
    height_at at the yaw-rotated grid) with bases on, at the edge of and
    off the grid, and one base at a NaN position."""
    jc, tc = _cfgs("rough")
    jc = dataclasses.replace(jc, noise=jenv.NoiseCfg(enabled=False))
    tc = dataclasses.replace(tc, noise=tenv.NoiseCfg(enabled=False))
    je, te = jax_env_lanes_bj(jc), port_env(tc)
    sim_a, state_a = _state_arrays(te, np.random.default_rng(21))
    H, W = tc.terrain.size_m
    qpos = sim_a["qpos"]
    qpos[:8, 0] = np.linspace(-H, H, 8)           # across and off the grid
    qpos[8:16, 1] = np.linspace(-W / 2 - 1, W / 2 + 1, 8)
    qpos[16, 0] = H / 2 - 0.05                     # the last cell's edge
    qpos[17, :2] = np.nan
    js, ts, jsim, tsim = _states(je, te, sim_a, state_a)
    action = np.zeros((N, 12), np.float32)
    dj = je._step_data(jsim, js.command, jnp.asarray(action), js.action)
    ref = np.asarray(je._observations(dj, jax.random.PRNGKey(0)))
    obs = te.obs_stage(tsim, ts.command, torch.from_numpy(action),
                       ObsDraws(None, None, None, None, None)).numpy()
    scan = slice(45, 45 + tc.height_scan.num_points)
    assert np.isnan(ref[17, scan]).all() and np.isnan(obs[17, scan]).all()
    np.testing.assert_allclose(obs, ref, rtol=RTOL, atol=ATOL)


def _random_data(env, rng, n=16):
    m = env.model
    nj, nr, nf = m.nj, m.nreport, len(m.foot_report_ids)

    def r(*shape, s=1.0):
        return torch.from_numpy(rng.normal(0, s, shape).astype(np.float32))

    return StepData(
        joint_pos=r(n, nj), joint_vel=r(n, nj, s=10), joint_acc=r(n, nj, s=500),
        applied_torque=r(n, nj, s=5), default_joint_pos=env.default_joint_pos_task,
        base_pos=r(n, 3, s=0.2), base_yaw=r(n), base_lin_vel_b=r(n, 3),
        base_ang_vel_b=r(n, 3), projected_gravity=r(n, 3, s=0.5),
        command=r(n, 3, s=0.4), action=r(n, nj), prev_action=r(n, nj),
        force_hist=r(n, 3, nr, 3, s=30).abs(),
        touchdown=torch.from_numpy(rng.uniform(size=(n, nf)) < 0.5),
        last_air_time=r(n, nf, s=0.3).abs(), step_dt=env.cfg.step_dt)


def _raw_from_table(cset, data):
    """The raw columns as the kernels see the terms: each row of the term
    table through the function of its kind with the table's own floats
    and ids, a given term's columns from the given block."""
    tab = cset.descriptors
    given = (cset.raw(data, [cset.terms[i] for i in tab.given])
             if tab.given else None)
    cols = []
    for (kind, c0, nc, first, nids), vals in zip(tab.ints, tab.floats):
        if kind == GIVEN:
            cols.append(given[:, first:first + nc])
            continue
        func, names, idx = KERNEL_TERMS[kind]
        params = dict(zip(names, (float(v) for v in vals)))
        if idx is not None:
            params[idx] = tab.ids[first:first + nids].astype(np.int64)
        cols.append(_as_2d(func(data, **params)))
    return torch.cat(cols, dim=1)


@pytest.mark.parametrize("task", sorted(registry.list_tasks()))
def test_term_table_covers_every_registered_task(task):
    env = registry.get(task).make_env(num_envs=4, device="cpu")
    tab = env.cset.descriptors
    assert tab.given == () and (tab.ints[:, 0] != GIVEN).all()
    assert tab.ints[:, 2].sum() == env.cset.total_cols
    data = _random_data(env, np.random.default_rng(3))
    assert torch.equal(_raw_from_table(env.cset, data), env.cset.raw(data))


def _tilt(data, *, gain):
    """A term outside the kernels' kinds: two columns of scaled tilt."""
    return gain * data.projected_gravity[:, :2]


def test_a_term_outside_the_kinds_goes_through_the_given_block():
    base = port_env(deterministic_cfgs(8)[1])
    joints = base.cset.terms[0].params["joint_ids"].numpy()
    terms = [t._replace(params={k: (v.numpy() if isinstance(v, torch.Tensor)
                                    else v) for k, v in t.params.items()})
             for t in base.cset.terms] + [
        ConstraintTerm("tilt", _tilt, dict(gain=3.0), 0.25, True),
        ConstraintTerm("joint_range", C.joint_range,
                       dict(limit=0.3, joint_ids=joints), 0.25, True),
        ConstraintTerm("no_move_arr", C.no_move,
                       dict(velocity_deadzone=0.1,
                            joint_vel_limit=np.full(12, 4.0, np.float32),
                            joint_ids=joints), 0.1, False),
        ConstraintTerm("min_base_height", C.min_base_height,
                       dict(limit=0.2), 1.0, False)]
    env = tenv.CatEnv(base.model, base.cfg, terms,
                      SOLO12_ACTUATED_JOINT_ORDER, device="cpu")
    tab = env.cset.descriptors
    # the custom function and the kind with a per-joint limit array go
    # through the given block; the kinds with number limits do not
    assert tab.given == (13, 15)
    assert list(tab.ints[13]) == [GIVEN, 78, 2, 0, 0]
    assert list(tab.ints[15]) == [GIVEN, 92, 12, 2, 0]
    data = _random_data(env, np.random.default_rng(4))
    assert torch.equal(_raw_from_table(env.cset, data), env.cset.raw(data))



@pytest.mark.parametrize("kernel", ["env_terms", "env_update", "env_obs"])
def test_the_wrappers_refuse_what_the_kernels_cannot_take(kernel):
    """A kernel wrapper called directly takes CUDA tensors of the model's
    shapes alone: a wrong shape raises before any pointer goes out, a CPU
    tensor raises rather than falling back to the plain stage; the
    dispatchers run the plain stage on the CPU."""
    from cat_tpu_torch.ops import env_step

    env = port_env(deterministic_cfgs(4)[1])
    gen = torch.Generator().manual_seed(0)
    es = env.init(gen, 4)
    action = torch.zeros(4, 12)
    terms = env.terms_stage(es, es.sim, action, es.action)
    draws = env._update_draws(gen, 4, env._rand(gen, 4, 15))
    calls = {
        "env_terms": lambda a: env_step.ENV_TERMS(env, es, es.sim, a,
                                                  es.action),
        "env_update": lambda a: env_step.ENV_UPDATE(env, es, es.sim, a,
                                                    es.action, terms, draws),
        "env_obs": lambda a: env_step.ENV_OBS(
            env, es.sim, es.command, a, env._obs_draws(gen, 4))}
    launches = dict(env_step.ENV_KERNELS)[kernel].launches
    with pytest.raises(ValueError, match="expected"):
        calls[kernel](torch.zeros(4, 11))
    with pytest.raises(ValueError, match="CUDA device"):
        calls[kernel](action)
    assert dict(env_step.ENV_KERNELS)[kernel].launches == launches
    dispatch = {"env_terms": lambda: env_step.env_terms(
                    env, es, es.sim, action, es.action),
                "env_update": lambda: env_step.env_update(
                    env, es, es.sim, action, es.action, terms, draws),
                "env_obs": lambda: env_step.env_obs(
                    env, es.sim, es.command, action, env._obs_draws(gen, 4))}
    assert dispatch[kernel]() is not None


@pytest.mark.parametrize("kind", ["flat", "rough"])
def test_env_counts_cover_each_stage_s_outputs(kind):
    """``measure.env_counts``, the bound of each env kernel, counts at
    least the bytes of its plain stage's outputs, and grows with the envs
    as their count does (the tables once)."""
    from cat_tpu_torch import measure

    te = port_env(_cfgs(kind)[1])
    sim_a, state_a = _state_arrays(te, np.random.default_rng(31))
    ts, tsim = _states_port(te, sim_a, state_a)
    action = torch.zeros(N, 12)
    terms = te.terms_stage(ts, tsim, action, ts.action)
    gen = torch.Generator().manual_seed(0)
    draws = te._update_draws(gen, N, te._rand(gen, N, 15))
    up = te.update_stage(ts, tsim, action, ts.action, terms, draws)
    obs = te.obs_stage(up.sim, up.command, up.action, te._obs_draws(gen, N))

    def nbytes(x):
        return sum(t.numel() * t.element_size() for t in
                   torch.utils._pytree.tree_leaves(x) if t is not None)

    counts = measure.env_counts(te, N, terms)
    assert counts["env_terms"][0] >= nbytes(terms)
    assert counts["env_update"][0] >= nbytes(up)
    assert counts["env_obs"][0] >= nbytes(obs)
    double = measure.env_counts(te, 2 * N)
    for name, (b, f) in measure.env_counts(te, N).items():
        assert b < double[name][0] <= 2 * b and double[name][1] == 2 * f


def _states_port(te, sim_a, state_a):
    """(port EnvState, port sim) of the arrays."""
    tsim = SimState(**{k: torch.from_numpy(v.copy()) for k, v in sim_a.items()})
    ts = tenv.EnvState(sim=tsim, **{k: torch.from_numpy(np.array(v))
                                    for k, v in state_a.items()})
    return ts, tsim


def test_cells_read_counts_each_packed_cell_once():
    """``measure.cells_read`` (the bound's terrain bytes) against a float64
    numpy count of the packed corner table's distinct cells under random
    points on the small rough grid, ~40% of them off it (they read its
    edge cells) and one NaN point (it reads cell 0)."""
    from cat_tpu_torch import measure

    terr = tterrain.generate_rough(**ROUGH)
    R, Cn = terr.height.shape
    H, W = terr.size_m
    xy = np.random.default_rng(41).uniform(-0.7, 0.7, (600, 2)) * [H, W]
    xy[0] = np.nan
    u = np.clip(xy[:, 0] / terr.cell + R / 2 - 0.5, 0.0, R - 1.001)
    v = np.clip(xy[:, 1] / terr.cell + Cn / 2 - 0.5, 0.0, Cn - 1.001)
    iu, iv = (np.nan_to_num(np.floor(a), nan=0.0).astype(int) for a in (u, v))
    want = len(set((iu * (Cn - 1) + iv).tolist()))
    assert 1 < want < len(xy)
    assert measure.cells_read(terr, torch.tensor(xy, dtype=torch.float32)) \
        == want


@pytest.mark.parametrize("kind", ["flat", "rough"])
def test_env_counts_read_each_terrain_cell_once(kind):
    """Given the observed state's qpos, ``measure.env_counts`` counts 16
    bytes for each cell of the corner table that the height scan reads
    and that the reset envs' spawn positions read, each cell once; without
    it, one cell a lookup. Envs at one pose read one env's cells. On the
    plane there is no table."""
    from cat_tpu_torch import measure
    from cat_tpu_torch.sim.maths import quat_yaw

    te = port_env(_cfgs(kind)[1])
    sim_a, state_a = _state_arrays(te, np.random.default_rng(31))
    ts, tsim = _states_port(te, sim_a, state_a)
    terms = te.terms_stage(ts, tsim, torch.zeros(N, 12), ts.action)
    qpos = tsim.qpos
    base = measure.env_counts(te, N)
    got = measure.env_counts(te, N, terms, qpos=qpos)
    if kind == "flat":
        assert got == measure.env_counts(te, N, terms) == base
        return
    terr, pts = te.cfg.terrain, te.cfg.height_scan.num_points
    R, Cn = terr.height.shape
    per_lookup = min(N * pts, (R - 1) * (Cn - 1))

    def scan_cells(q):
        return measure.cells_read(terr, te.scan_points(q[:, 0:3],
                                                       quat_yaw(q[:, 3:7])))

    resets = terms.time_out | terms.illegal | terms.upside
    assert int(resets.sum()) >= 3
    assert got["env_terms"] == base["env_terms"]
    assert (got["env_update"][0] - base["env_update"][0]
            == 16 * measure.cells_read(terr, qpos[resets, 0:2]))
    assert (got["env_obs"][0] - base["env_obs"][0]
            == 16 * (scan_cells(qpos) - per_lookup))
    # every env at env 0's pose: the scan reads env 0's cells alone
    same = qpos[:1].expand(N, -1)
    one = scan_cells(qpos[:1])
    assert one <= pts < scan_cells(qpos)
    assert (measure.env_counts(te, N, qpos=same)["env_obs"][0]
            == base["env_obs"][0] - 16 * (per_lookup - one))


def test_plain_stages_record_the_step_and_restore_the_dispatch():
    """``measure.plain_stages``, the kernel-env phase's record of a step's
    stage inputs: under it a step runs the plain stages in the step's
    order and gives what the step gives, bit for bit, generator included;
    each call is recorded with its inputs and output; the dispatch of
    ops/env_step.py is restored after it."""
    from cat_tpu_torch import measure
    from cat_tpu_torch.ops import env_step

    te = port_env(_cfgs("rough")[1])
    sim_a, state_a = _state_arrays(te, np.random.default_rng(51))
    ts, tsim = _states_port(te, sim_a, state_a)
    te.engine = lambda *a: tsim
    action = torch.from_numpy(np.random.default_rng(52).uniform(
        -1, 1, (N, 12)).astype(np.float32))
    dispatch = [env_step.env_terms, env_step.env_update, env_step.env_obs]
    g_ref, g_rec = torch.Generator().manual_seed(3), torch.Generator()
    g_rec.set_state(g_ref.get_state())
    ref = te._step_eager(ts, action, g_ref)
    calls = []
    with measure.plain_stages(calls):
        out = te._step_eager(ts, action, g_rec)
    assert [env_step.env_terms, env_step.env_update,
            env_step.env_obs] == dispatch
    assert torch.equal(g_ref.get_state(), g_rec.get_state())
    for a, b in zip(torch.utils._pytree.tree_leaves(out),
                    torch.utils._pytree.tree_leaves(ref)):
        assert torch.equal(a, b)
    assert [c[0] for c in calls] == ["env_terms", "env_update", "env_obs"]
    (_, t_args, _, terms), (_, u_args, _, up), (_, o_args, _, obs) = calls
    assert t_args[1] is tsim and u_args[4] is terms
    assert o_args[0] is up.sim and torch.equal(obs, out[1])
