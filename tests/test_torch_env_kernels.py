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
  * the column table env_terms reads (``envs/cat.py`` ``column_table``),
    evaluated column by column from a SimState's rows the way the kernel
    reads them (the joint, foot or staged report slot of each row, the
    slots in contact as a mask), equals ``ConstraintSet.raw`` bit for bit
    for every registered task and for a task with a term of its own
    function, and on the stepped states the JAX package's raw columns
    within the tolerances above;
  * ``env_geometry`` covers every env with its blocks and keeps each
    kernel's shared memory a block under 227 KB for every registered
    task; ``fold_shares`` (the order in which env_update sums the
    accumulators) is a one-by-one float32 sum in that order, bit for bit,
    and within (N - 1) unit roundoffs of the float64 sum;
  * the observation noise as raw draws (``ObsDraws``: each part's U(0, 1)
    draw and its float32 lo and span) gives the observation
    ``CatEnv._uniform``'s U(-mag, mag) draws gave, bit for bit, from the
    same generator state; ``env_obs``'s geometry covers every env in one
    wave and its shared bytes are its kernel's ``ObsLayout``, read region
    by region from ``csrc/env_obs.cu``;
  * the measuring side: ``measure.env_counts`` counts each heightfield
    cell a step reads once, and ``measure.plain_stages`` records a step's
    stages without changing what the step gives.
"""

import dataclasses
from pathlib import Path

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



def _raw_from_columns(env, sim, command, action, prev_action):
    """The raw columns as env_terms reads the column table: a row a
    column, its kind, its id (a qpos or qvel place, a model or task
    joint, a foot, a staged report slot or a mask of them, a given
    column) and its term's two float32 numbers, from the SimState's rows
    in the model's joint order; each staged slot's history norm once, the
    slots in contact (norm > 1) once."""
    from cat_tpu_torch.envs.cat import column_table

    cset = env.cset
    tab = column_table(cset.descriptors, env.t2m.numpy(),
                       env.illegal_ids.numpy())
    n = action.shape[0]
    hist = sim.force_hist.reshape(n, 3, env.model.nreport, 3)
    norms = torch.amax(torch.linalg.vector_norm(
        hist[:, :, torch.as_tensor(tab.slots, dtype=torch.long)], dim=-1),
        dim=1)
    contact = norms > 1.0
    data = env.step_data(sim, command, action, prev_action)
    g = data.projected_gravity
    cmd_norm = torch.linalg.vector_norm(command, dim=-1)
    djp = env.default_joint_pos_task
    given = (cset.raw(data, [cset.terms[i] for i in cset.descriptors.given])
             if cset.descriptors.given else None)
    K = {f.__name__: k for k, (f, _, _) in enumerate(KERNEL_TERMS)}
    cols = []
    for (kind, a, b), (p0, p1) in zip(tab.ints.tolist(),
                                      tab.floats.tolist()):
        mask = (a & 0xffffffff) | ((b & 0xffffffff) << 32)
        places = [s for s in range(len(tab.slots)) if mask >> s & 1]
        name = KERNEL_TERMS[kind][0].__name__ if kind != GIVEN else "given"
        v = {
            "joint_position": lambda: torch.abs(sim.qpos[:, a]) - p0,
            "joint_position_when_moving_forward": lambda: (
                torch.abs(sim.qpos[:, a] - djp[b]) - p0)
            * (torch.abs(command[:, 1]) < p1).float(),
            "joint_torque": lambda: torch.abs(sim.applied_torque[:, a]) - p0,
            "joint_velocity": lambda: torch.abs(sim.qvel[:, a]) - p0,
            "joint_acceleration": lambda: torch.abs(sim.joint_acc[:, a]) - p0,
            "upsidedown": lambda: (g[:, 2] > p0).float(),
            "contact": lambda: contact[:, places].any(dim=1).float(),
            "base_orientation": lambda: torch.linalg.vector_norm(
                g[:, :2], dim=1) - p0,
            "air_time": lambda: (p0 - sim.last_air_time[:, a])
            * sim.touchdown[:, a].float() * (cmd_norm > p1).float(),
            "n_foot_contact": lambda: torch.abs(
                contact[:, places].sum(dim=1).float() - p0)
            * (cmd_norm > p1).float(),
            "joint_range": lambda: torch.abs(sim.qpos[:, a] - djp[b]) - p0,
            "action_rate": lambda: torch.abs(action[:, a] - prev_action[:, a])
            / env.cfg.step_dt - p0,
            "foot_contact_force": lambda: norms[:, a] - p0,
            "min_base_height": lambda: p0 - sim.qpos[:, 2],
            "no_move": lambda: (torch.abs(sim.qvel[:, a]) - p0)
            * (cmd_norm < p1).float(),
            "given": lambda: given[:, a],
        }[name]()
        assert name == "given" or kind == K[name]
        cols.append(v)
    return torch.stack(cols, dim=1)


def _random_sim(env, rng, n=16):
    """A random post-physics SimState of ``env``'s model, forces large
    enough that some report slots are in contact, touchdown bytes."""
    from cat_tpu_torch.ops.env_step import sim_shapes

    shapes = sim_shapes(env.model, n)
    fields = [torch.from_numpy(rng.normal(0, s, sh).astype(np.float32))
              for s, sh in zip((0.5, 5.0, 1.0, 5.0, 500.0, 10.0, 1.0, 0.3,
                                0.3, 0.3, 0.3, 1.0), shapes)]
    q = fields[0]
    q[:, 3:7] = q[:, 3:7] / torch.linalg.vector_norm(q[:, 3:7], dim=1,
                                                     keepdim=True)
    nr = env.model.nreport
    big = rng.choice([0.3, 30.0], (n, 1, nr, 1), p=[0.92, 0.08])
    fields[6] = torch.abs(fields[6]) * torch.from_numpy(np.broadcast_to(
        big, (n, 3, nr, 3)).reshape(shapes[6]).astype(np.float32))
    fields[11] = fields[11] > 0
    return SimState(*fields)


@pytest.mark.parametrize("task", sorted(registry.list_tasks()))
def test_column_table_gives_the_raw_columns_of_every_registered_task(task):
    env = registry.get(task).make_env(num_envs=4, device="cpu")
    rng = np.random.default_rng(5)
    n, nj = 16, env.model.nj
    sim = _random_sim(env, rng, n)
    command = torch.from_numpy(rng.normal(0, 0.5, (n, 3)).astype(np.float32))
    command[:3] = 0.0                      # below every deadzone
    action, prev = (torch.from_numpy(rng.normal(0, 1, (n, nj)).astype(
        np.float32)) for _ in range(2))
    data = env.step_data(sim, command, action, prev)
    ref = env.cset.raw(data)
    got = _raw_from_columns(env, sim, command, action, prev)
    assert torch.equal(got, ref)
    # every kind of the task's terms took part, contacts both ways
    assert 0 < int(ref[:, 48].sum()) < n


def test_column_table_of_a_task_with_a_term_of_its_own_function():
    base = port_env(deterministic_cfgs(8)[1])
    joints = base.cset.terms[0].params["joint_ids"].numpy()
    terms = [t._replace(params={k: (v.numpy() if isinstance(v, torch.Tensor)
                                    else v) for k, v in t.params.items()})
             for t in base.cset.terms] + [
        ConstraintTerm("tilt", _tilt, dict(gain=3.0), 0.25, True),
        ConstraintTerm("joint_range", C.joint_range,
                       dict(limit=0.3, joint_ids=joints), 0.25, True),
        ConstraintTerm("min_base_height", C.min_base_height,
                       dict(limit=0.2), 1.0, False),
        ConstraintTerm("feet_pairs", C.n_foot_contact,
                       dict(number_of_desired_feet=2.0, min_command_value=0.1,
                            body_ids=np.array([3, 3, 6])), 0.25, True)]
    env = tenv.CatEnv(base.model, base.cfg, terms,
                      SOLO12_ACTUATED_JOINT_ORDER, device="cpu")
    # the repeated slot's count is no mask: that term is given too
    assert env.cset.descriptors.given == (13, 16)
    rng = np.random.default_rng(6)
    sim = _random_sim(env, rng)
    command = torch.from_numpy(rng.normal(0, 0.5, (16, 3)).astype(np.float32))
    action, prev = (torch.from_numpy(rng.normal(0, 1, (16, 12)).astype(
        np.float32)) for _ in range(2))
    data = env.step_data(sim, command, action, prev)
    assert torch.equal(_raw_from_columns(env, sim, command, action, prev),
                       env.cset.raw(data))


def test_column_table_on_the_stepped_states_matches_the_jax_terms(stepped):
    kind, je, te, _, _, (js, ts, jsim, tsim, action) = stepped
    dj = je._step_data(jsim, js.command, jnp.asarray(action), js.action)
    raw_j = np.asarray(jnp.concatenate(
        [jax_as_2d(t.func(dj, **t.params)) for t in je.cset.terms], 1))
    got = _raw_from_columns(te, tsim, ts.command, torch.from_numpy(action),
                            ts.action)
    np.testing.assert_allclose(got.numpy(), raw_j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [1, 33, 4095, 4096])
def test_env_geometry_covers_every_env_within_shared_memory(n):
    from cat_tpu_torch.ops import env_step

    for task in sorted(registry.list_tasks()):
        env = registry.get(task).make_env(num_envs=4, device="cpu")
        geo = env_step.env_geometry(n, env)
        assert (geo.blocks - 1) * geo.envs < n <= geo.blocks * geo.envs
        assert geo.threads >= 3 * geo.envs and geo.threads % 32 == 0
        assert 0 < geo.terms_bytes <= 227 * 1024
        assert 0 < geo.update_bytes <= 227 * 1024
        assert geo.terms_bytes % 16 == geo.update_bytes % 16 == 0
        if n == 4096:
            # one wave on the H100's 132 SMs, two blocks an SM: the shared
            # memory of two blocks (and the 1 KB the card keeps a block)
            # within an SM's 228 KB
            assert geo.blocks <= 2 * 132
            assert 2 * (max(geo.terms_bytes, geo.update_bytes) + 1024) \
                <= 228 * 1024


@pytest.mark.parametrize("kind", ["flat", "rough"])
def test_raw_obs_draws_keep_the_uniform_noise_bits(kind):
    """``obs_stage`` with ``_obs_draws``' raw U(0, 1) draws and their
    affine gives, bit for bit, the observation whose noise is each part's
    ``_uniform`` U(-mag, mag) (drawn from the same generator state, the
    same ``torch.rand`` calls) added to it before its scale; both leave
    the generator in the same state."""
    te = port_env(_cfgs(kind)[1])
    sim_a, state_a = _state_arrays(te, np.random.default_rng(61))
    ts, tsim = _states_port(te, sim_a, state_a)
    g_raw, g_old = torch.Generator().manual_seed(5), torch.Generator()
    g_old.set_state(g_raw.get_state())
    draws = te._obs_draws(g_raw, N)
    assert sum(d is not None for d in draws.draws) == (
        5 if kind == "rough" else 4)
    z = [None if mag is None else te._uniform(g_old, (N, w), -mag, mag)
         for mag, w in zip(te.obs_noise(), te.obs_noise_widths())]
    assert torch.equal(g_raw.get_state(), g_old.get_state())

    def noise(x, k):
        return x if z[k] is None else x + z[k]

    d = te.step_data(tsim, ts.command, ts.action, None)
    want = [noise(d.base_ang_vel_b, 0) * te.ang_vel_scale,
            d.command * te._cmd_scale,
            noise(d.projected_gravity, 1) * te.gravity_scale,
            noise(d.joint_pos, 2), noise(d.joint_vel, 3) * te.joint_vel_scale,
            d.action]
    if kind == "rough":
        quiet = te.obs_stage(tsim, ts.command, ts.action,
                             ObsDraws(None, None, None, None, None))
        want.append(noise(quiet[:, 9 + 3 * te.model.nj:], 4))
    got = te.obs_stage(tsim, ts.command, ts.action, draws)
    assert torch.equal(got, torch.cat(want, dim=1))


def _obs_layout_words(source, envs, nj, nq, nv, n_obs, n_scan):
    """4-byte words of ``csrc/env_obs.cu``'s ``ObsLayout``: each of its
    ``l.take(...)`` regions, read from the source and evaluated, rounded
    up to 16 bytes."""
    import re
    from types import SimpleNamespace

    body = source[source.index("struct ObsLayout"):]
    body = body[:body.index("words = l.words;")]
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", source))
    scope = dict(E=envs, a=SimpleNamespace(nj=nj, nq=nq, nv=nv, n_obs=n_obs,
                                           n_scan=n_scan),
                 **{k: int(v) for k, v in consts.items()})
    regions = re.findall(r"l\.take\((.+?)\);", body)
    assert len(regions) == 12
    return sum(-(-eval(r, scope) // 4) * 4 for r in regions)


@pytest.mark.parametrize("envs", [1, 7, 16, 32])
def test_env_obs_shared_bytes_are_its_kernel_s_layout(envs):
    """``env_step.obs_smem`` (the bytes ``env_geometry`` passes and the
    launch checks) counts ``ObsLayout`` of the kernel's source region by
    region, for every registered task."""
    from cat_tpu_torch.ops import env_step

    source = (Path(env_step.__file__).parent / "csrc"
              / "env_obs.cu").read_text()
    for task in sorted(registry.list_tasks()):
        env = registry.get(task).make_env(num_envs=4, device="cpu")
        m, hs = env.model, env.cfg.height_scan
        words = _obs_layout_words(
            source, envs, m.nj, m.nq, m.nv, env.num_obs,
            hs.num_points if hs is not None else 0)
        assert env_step.obs_smem(env, envs) == 4 * words, task


@pytest.mark.parametrize("n", [1, 9, 4096, 4097])
def test_env_obs_geometry_covers_every_env_in_one_wave(n):
    """``env_geometry``'s env_obs part: its blocks cover the envs, its
    threads are whole warps, a thread an env at least, within the
    kernel's bound; at 4096 envs every block fits on the H100's 132 SMs
    at once (2048 threads and 228 KB of shared memory an SM, 1 KB of it
    kept a block)."""
    from cat_tpu_torch.ops import env_step

    for task in sorted(registry.list_tasks()):
        env = registry.get(task).make_env(num_envs=4, device="cpu")
        geo = env_step.env_geometry(n, env)
        E, T = geo.obs_envs, geo.obs_threads
        assert (geo.obs_blocks - 1) * E < n <= geo.obs_blocks * E
        assert T % 32 == 0 and E <= T <= env_step.OBS_THREADS_MAX
        assert 0 < geo.obs_bytes <= 227 * 1024 and geo.obs_bytes % 16 == 0
        assert geo.obs_bytes == env_step.obs_smem(env, E)
        if n == 4096:
            per_sm = min(2048 // T, 228 * 1024 // (geo.obs_bytes + 1024))
            assert geo.obs_blocks <= 132 * per_sm, task


def test_the_obs_geometry_sweep_takes_only_geometries_env_obs_takes():
    """``tools/env_kernel_sweep.py``'s env_obs geometries: whole warps, a
    thread an env at least, no more than its launch bound."""
    from cat_tpu_torch.tools.env_kernel_sweep import parse_obs_geometries

    assert parse_obs_geometries("16x256,32x512,8x32") == (
        (16, 256), (32, 512), (8, 32))
    for bad in ("16x16", "16x100", "0x64", "64x32", "8x1024"):
        with pytest.raises(ValueError):
            parse_obs_geometries(bad)


def test_the_geometry_sweep_takes_only_geometries_the_kernels_take():
    """``tools/env_kernel_sweep.py``'s geometries: envs x threads, threads
    whole warps, at least three envs' worth (env_update's roles) and no
    more than the kernels' launch bound."""
    from cat_tpu_torch.tools.env_kernel_sweep import parse_geometries

    assert parse_geometries("16x256,32x96") == ((16, 256), (32, 96))
    for bad in ("16x32", "16x100", "0x64", "8x512"):
        with pytest.raises(ValueError):
            parse_geometries(bad)


def test_fold_shares_sums_in_the_kernel_s_order():
    from cat_tpu_torch.ops.env_step import fold_shares

    rng = np.random.default_rng(8)
    n, width, envs = 77, 32, 32
    x = (rng.uniform(0, 1, (n, width))
         * 10.0 ** rng.integers(-3, 4, (n, width))).astype(np.float32)
    got = fold_shares(torch.from_numpy(x), envs).numpy()
    # one float32 addition at a time: each block from 0 in env order, then
    # the blocks from 0 in block order
    want = np.zeros(width, np.float32)
    for j in range(width):
        total = np.float32(0.0)
        for b0 in range(0, n, envs):
            part = np.float32(0.0)
            for e in range(b0, min(b0 + envs, n)):
                part = np.float32(part + x[e, j])
            total = np.float32(total + part)
        want[j] = total
    assert got.dtype == np.float32 and np.array_equal(got, want)
    exact = x.astype(np.float64).sum(0)
    assert np.all(np.abs(got - exact) <= (n - 1) * 2.0 ** -24 * exact)


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
