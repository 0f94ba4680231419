"""Rough terrain in the port against the JAX package: heightfield contact
rows, the raw engine with its default Gauss-Seidel solve, the rough env
(height scan, patch spawning, terrain curriculum) step for step, and the
EnvCfg solver fields.

One rough training iteration is in tests/test_torch_rough_train.py.

Sizes are small (2-3 x 2-4 patches of 4 m, 4-8 envs). Tolerances: contact
rows atol 1e-5 and 2e-5 as tests/test_lanes.py::test_contacts_match_hfield
holds the JAX package's two layouts; control steps and env steps to the
bounds of tests/test_torch_engine.py and tests/test_torch_env.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import TERRAIN, jax_env_lanes_bj, rough_cfgs
from cat_tpu.envs import env as jenv
from cat_tpu.models.solo12 import SOLO12_ACTUATED_JOINT_ORDER
from cat_tpu.models.solo12 import solo12_model as jax_solo12
from cat_tpu.sim import dynamics_lanes as dl
from cat_tpu.sim import engine as jem
from cat_tpu.sim import terrain as jt
from cat_tpu.sim.maths import quat_from_euler_zyx
from cat_tpu.tasks.solo12_rough import rough_constraint_terms as jax_rough_terms
from cat_tpu_torch.envs import env as tenv
from cat_tpu_torch.models.solo12 import SOLO12_KD, SOLO12_KP
from cat_tpu_torch.models.solo12 import solo12_model as port_solo12
from cat_tpu_torch.ops import pgs
from cat_tpu_torch.ops.env_step import ObsDraws
from cat_tpu_torch.sim import collision as tc
from cat_tpu_torch.sim import dynamics as td
from cat_tpu_torch.sim import engine as tem
from cat_tpu_torch.sim import terrain as tt
from cat_tpu_torch.tasks import registry
from cat_tpu_torch.tasks import solo12_rough

def _spawn(terr, n, seed, dz=0.22, tilt=0.0, joints=0.0):
    """Solo12 states spread over the patches, dz above the local surface."""
    model = jax_solo12()
    rng = np.random.default_rng(seed)
    qpos = np.tile(model.default_qpos(), (n, 1)).astype(np.float32)
    xy = np.stack([terr.patch_origin(i % terr.rows, i % terr.cols)
                   for i in range(n)]) + rng.uniform(-1.5, 1.5, (n, 2))
    qpos[:, 0:2] = xy
    qpos[:, 2] = np.asarray(jt.height_at(terr, jnp.asarray(xy, jnp.float32))) + dz
    if tilt:
        ang = rng.uniform(-tilt, tilt, (n, 3))
        qpos[:, 3:7] = np.asarray(quat_from_euler_zyx(*map(jnp.asarray, ang.T)))
    qpos[:, 7:] += rng.uniform(-joints, joints, (n, model.nj))
    qvel = rng.uniform(-0.3, 0.3, (n, model.nv)).astype(np.float32)
    return qpos, qvel


# ---------------------------------------------------------------------------
# contact rows and the raw engine
# ---------------------------------------------------------------------------

def test_hfield_contacts_match():
    """phi, the contact-frame rows E and the frames, against
    detect_contacts_lanes, for feet and shins over pyramids, pits and noise
    (and self-collision pairs, whose rows follow the terrain ones)."""
    n = 8
    terr_j, terr_t = jt.generate_rough(**TERRAIN), tt.generate_rough(**TERRAIN)
    qpos, qvel = _spawn(terr_j, n, seed=0, dz=0.18, tilt=0.3, joints=0.3)
    model = jax_solo12()
    anc = model.ancestor_mask()
    ref = jax.jit(lambda q, v: dl.detect_contacts_lanes(
        model, terr_j, dl.fk_lanes(model, q, v), anc))(
            jnp.asarray(qpos.T), jnp.asarray(qvel.T))
    mt = td.ModelTensors.build(port_solo12(), "cpu")
    port = tc.detect_contacts(
        mt, terr_t, td.fk(mt, torch.from_numpy(qpos), torch.from_numpy(qvel)))
    phi = np.asarray(ref.phi).T
    assert (phi[:, :28] < 0.02).sum() >= 8       # candidates near the surface
    np.testing.assert_allclose(port.phi.numpy(), phi, atol=1e-5)
    np.testing.assert_allclose(port.E.numpy(), np.moveaxis(np.asarray(ref.E), -1, 0),
                               atol=2e-5)
    frame = np.moveaxis(np.asarray(ref.frame), -1, 0)
    np.testing.assert_allclose(port.frame.numpy(), frame, atol=1e-5)
    assert np.abs(frame[:, :28, 2, :2]).max() > 0.05   # tilted normals


@pytest.fixture(scope="module")
def raw_steps():
    """10 chained raw-engine control steps, default EngineParams (the
    serial Gauss-Seidel solve, 5 sweeps), on a small rough terrain.

    The JAX side is its env-leading ("vmap") engine, whose serial sweep
    solver.pgs_solve loops over the sweeps: control_step_lanes unrolls all
    5 x 36 contact updates of _pgs_lanes_xla into one program that is slow
    to compile on a CPU. tests/test_lanes.py holds the two layouts to each
    other, and tests/test_torch_pgs_gs.py holds the port's solve to
    _pgs_lanes_xla."""
    n = 4
    terr_j, terr_t = jt.generate_rough(**TERRAIN), tt.generate_rough(**TERRAIN)
    model = jax_solo12()
    qpos, qvel = _spawn(terr_j, n, seed=1, tilt=0.1, joints=0.2)
    mu = np.random.default_rng(2).uniform(0.6, 1.2, n).astype(np.float32)
    step_j = jax.jit(jem.make_batched_step(model, jem.EngineParams(),
                                           terrain=terr_j, layout="vmap"))
    step_t = tem.make_batched_step(port_solo12(), tem.EngineParams(),
                                   terrain=terr_t, device="cpu")
    assert step_t.solve is pgs.pgs_gs
    sj = jem.make_batched_init(model, n)._replace(
        qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel))
    st = tem.make_batched_init(port_solo12(), n, "cpu")._replace(
        qpos=torch.from_numpy(qpos), qvel=torch.from_numpy(qvel))
    for i in range(10):
        target = (np.tile(model.default_qpos_joints, (n, 1))
                  + 0.1 * np.sin(0.3 * i)).astype(np.float32)
        sj = step_j(sj, jnp.asarray(target), jnp.asarray(mu))
        st = step_t(st, torch.from_numpy(target), torch.from_numpy(mu))
    return sj, st


@pytest.mark.parametrize("field,tol", [
    ("qpos", dict(atol=2e-3)), ("qvel", dict(atol=2e-2)),
    ("lam", dict(atol=1e-4)), ("forces", dict(rtol=0.05, atol=0.05)),
    ("current_air_time", dict(atol=1e-6)), ("touchdown", dict()),
])
def test_raw_engine_gs_steps_match(raw_steps, field, tol):
    sj, st = raw_steps
    if field == "lam":
        assert np.abs(np.asarray(sj.lam)).max() > 1e-3   # in contact
    np.testing.assert_allclose(getattr(st, field).numpy(),
                               np.asarray(getattr(sj, field)), **tol)


def test_solo12_stands_on_obstacle_patch():
    """tests/test_hfield_edges.py::test_solo12_stands_on_obstacle_patch in
    the port: the raw engine (GS-5) PD-holds the default pose on the hardest
    steps patch and on a noise patch for 100 control steps, neither
    tunnelling nor drifting off the pad."""
    model = port_solo12()
    terr = tt.generate_rough(rows=2, cols=4, patch_m=4.0, cell=0.1, seed=0)
    step = tem.make_batched_step(
        model, tem.EngineParams(kp=SOLO12_KP, kd=SOLO12_KD), terrain=terr,
        device="cpu")
    s = tem.make_batched_init(model, 2, "cpu")
    spots = torch.tensor(np.stack([terr.patch_origin(1, 3),
                                   terr.patch_origin(1, 0)]), dtype=torch.float32)
    qpos = s.qpos.clone()
    qpos[:, 0:2] = spots
    qpos[:, 2] = tt.height_at(terr, spots) + 0.30
    s = s._replace(qpos=qpos)
    target = torch.as_tensor(model.default_qpos_joints,
                             dtype=torch.float32).expand(2, 12)
    for _ in range(100):
        s = step(s, target, torch.ones(2))
    q = s.qpos
    assert torch.isfinite(q).all()
    rel_z = q[:, 2] - tt.height_at(terr, q[:, 0:2])
    assert bool(((rel_z > 0.12) & (rel_z < 0.40)).all()), rel_z
    assert bool((torch.linalg.vector_norm(q[:, 0:2] - spots, dim=1) < 0.5).all())


@pytest.mark.parametrize("start,bound", [("landing", None), ("standing", 2e-3)])
def test_one_step_sensitivity_to_ulp_changes(start, bound):
    """Why tests/test_torch_gpu.py compares the card with the CPU from a
    standing start: 64 Solo12s dropped 0.3 m onto the rough terrain, at
    their landing (the 5th control step), move their joint velocities by
    more than that test's 2e-2 bound when the state changes by 1e-6
    relative (~8 float32 ulps) on one device, while robots standing on
    their pads move them by under 2e-3."""
    import test_torch_gpu as card

    n = 64
    kw = (dict(spread=1.2, dz=0.3, joints=0.2) if start == "landing"
          else dict(spread=0.15, dz=0.2892, joints=0.0))
    model, step, s = card._rough_raw_engine("cpu", n, **kw)
    mu = torch.full((n,), 0.9)

    def target(i):
        return torch.from_numpy(
            np.tile(model.default_qpos_joints, (n, 1)).astype(np.float32)
            + np.float32(0.1 * np.sin(0.3 * i)))

    for i in range(4):
        s = step(s, target(i), mu)
    base = step(s, target(4), mu)
    gen = torch.Generator().manual_seed(0)
    moved = max(
        float((step(s._replace(qpos=s.qpos * (1 + 1e-6 * (2 * torch.rand(
            s.qpos.shape, generator=gen) - 1))), target(4), mu).qvel
            - base.qvel).abs().max())
        for _ in range(3))
    if bound is None:
        assert moved > 2e-2, moved
    else:
        assert moved < bound, moved


# ---------------------------------------------------------------------------
# the rough env
# ---------------------------------------------------------------------------

def _jax_obs_noise(env, state):
    """The raw U(0, 1) draws under the observation noise the JAX env's next
    step draws (the step key's last split, folded with the term index), in
    term order: ``jax.random.uniform`` of each key and shape, which its
    ``_uniform`` turns into U(-mag, mag)."""
    hs = env.cfg.height_scan
    k_step = jax.random.fold_in(jax.random.PRNGKey(state.seed[0]),
                                state.common_step)
    k_noise = jax.random.split(k_step, 8)[7]
    n = state.command.shape[0]
    widths = (3, 3, 12, 12, hs.num_points)
    return [torch.from_numpy(np.array(jax.random.uniform(
        jax.random.fold_in(k_noise, i), (n, w))))
        for i, w in enumerate(widths)]


N_ENV, ENV_STEPS = 6, 5


@pytest.fixture(scope="module")
def rough_rollout():
    """5 env steps of both packages from the same spawn, with the JAX
    env's observation noise injected into the port's draws. Before step 2
    envs 0 and 1 time out far from their origins (promoted, row 0 -> 1);
    before step 4 env 1 times out where it stands (demoted, row 1 -> 0).
    Env 2 starts rolled on its side (terminated and reset at once)."""
    jc, tc_ = rough_cfgs(N_ENV, noise=True)
    je = jax_env_lanes_bj(jc, jax_rough_terms)
    te = solo12_rough.make_env(N_ENV, cfg=tc_, device="cpu")
    js = jax.jit(je.init, static_argnums=1)(jax.random.PRNGKey(0), N_ENV)
    ts = te.init(torch.Generator().manual_seed(0), N_ENV)
    init = (js, ts)
    flip = np.array([np.sqrt(0.5), np.sqrt(0.5), 0.0, 0.0], np.float32)
    js = js._replace(sim=js.sim._replace(qpos=js.sim.qpos.at[2, 3:7].set(flip)))
    qpos = ts.sim.qpos.clone()
    qpos[2, 3:7] = torch.from_numpy(flip)
    ts = ts._replace(sim=ts.sim._replace(qpos=qpos))
    step = jax.jit(je.step)
    gen = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(0)
    last = jc.max_episode_length - 1
    fields = ("obs", "reward", "dones", "origin", "terrain_row", "qpos",
              "episode_len")
    out = {k: ([], []) for k in fields}
    mp = pytest.MonkeyPatch()
    try:
        for t in range(ENV_STEPS):
            force = {1: ([0, 1], 3.0), 3: ([1], 0.0)}.get(t)
            if force is not None:
                ids, back = force
                js = js._replace(
                    episode_len=js.episode_len.at[jnp.asarray(ids)].set(last),
                    origin=js.origin.at[jnp.asarray(ids), 0].add(-back))
                ep, org = ts.episode_len.clone(), ts.origin.clone()
                ep[ids] = last
                org[ids, 0] -= back
                ts = ts._replace(episode_len=ep, origin=org)
            noise = _jax_obs_noise(je, js)

            def injected(gen, n, noise=noise):
                assert [tuple(x.shape) for x in noise] == [
                    (n, w) for w in te.obs_noise_widths()]
                draws = ObsDraws.uniform(noise, te.obs_noise())
                noise.clear()
                return draws

            mp.setattr(te, "_obs_draws", injected)
            a = rng.uniform(-1.0, 1.0, (N_ENV, 12)).astype(np.float32)
            js, jo, jr, jd, _ = step(js, jnp.asarray(a))
            ts, to, tr, td_, _ = te.step(ts, torch.from_numpy(a), gen)
            assert not noise
            for k, (jv, tv) in dict(
                    obs=(jo, to), reward=(jr, tr), dones=(jd, td_),
                    origin=(js.origin, ts.origin),
                    terrain_row=(js.terrain_row, ts.terrain_row),
                    qpos=(js.sim.qpos, ts.sim.qpos),
                    episode_len=(js.episode_len, ts.episode_len)).items():
                out[k][0].append(np.asarray(jv))
                out[k][1].append(tv.numpy())
    finally:
        mp.undo()
    return dict(env=(je, te), init=init, final=(js, ts), out=out)


@pytest.mark.parametrize("field,tol", [
    ("obs", dict(atol=1e-4)), ("reward", dict(atol=1e-6)),
    ("dones", dict(atol=1e-5)), ("origin", dict(atol=1e-6)),
    ("terrain_row", dict()), ("qpos", dict(atol=1e-4)),
    ("episode_len", dict()),
])
def test_rough_env_steps_match(rough_rollout, field, tol):
    ref, port = rough_rollout["out"][field]
    np.testing.assert_allclose(np.stack(port), np.stack(ref), **tol)


def test_rough_env_curriculum_moved_rows(rough_rollout):
    """The forced promotions and the demotion happened (in both, by the
    test above), and the height scan is the last 187 observations."""
    rows = np.stack(rough_rollout["out"]["terrain_row"][1])
    np.testing.assert_array_equal(rows[:, :2], [[0, 0], [1, 1], [1, 1],
                                                [1, 0], [1, 0]])
    assert (rows[:, 2:] == 0).all()
    lens = np.stack(rough_rollout["out"]["episode_len"][1])
    assert lens[0, 2] == 0 and lens[1, 0] == 0 and lens[3, 1] == 0
    obs = np.stack(rough_rollout["out"]["obs"][1])
    assert obs.shape == (ENV_STEPS, N_ENV, 45 + 187)
    assert np.abs(obs[..., 45:]).max() <= 1.0 + 0.1 + 1e-6


def test_rough_env_init_matches(rough_rollout):
    js, ts = rough_rollout["init"]
    for f in ("qpos", "qvel", "lam"):
        np.testing.assert_allclose(getattr(ts.sim, f).numpy(),
                                   np.asarray(getattr(js.sim, f)), atol=1e-7,
                                   err_msg=f)
    for f in ("origin", "terrain_row", "terrain_col", "command", "mu"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), err_msg=f)
    je, te = rough_rollout["env"]
    assert te.num_obs == je.num_obs == 232
    xy = ts.origin.numpy()
    terr = te.cfg.terrain
    np.testing.assert_allclose(
        xy, [terr.patch_origin(0, i % 2) for i in range(N_ENV)], atol=1e-6)


def test_rough_drain_metrics_match(rough_rollout):
    je, te = rough_rollout["env"]
    js, ts = rough_rollout["final"]
    _, jm = je.drain_metrics(js)
    _, tm = te.drain_metrics(ts)
    assert set(tm) == set(jm) and "Curriculum/terrain_levels" in tm
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(tm["Curriculum/terrain_levels"]), 1 / 6,
                               rtol=1e-6)


def test_rough_task_registry_and_constraints():
    assert set(registry._REGISTRY) >= {"Solo12-CaT-Rough-v0",
                                       "Solo12-CaT-Rough-Play-v0"}
    m = jax_solo12()
    ref = jax_rough_terms(m)
    port = solo12_rough.rough_constraint_terms(port_solo12())
    assert [(t.name, t.max_p, t.curriculum) for t in port] == \
        [(t.name, t.max_p, t.curriculum) for t in ref]
    assert dict(port[9].params)["limit"] == 0.3 == dict(ref[9].params)["limit"]
    cfg = solo12_rough.rough_cfg(16)
    assert cfg.terrain.height.shape == (800, 640) and cfg.terrain_curriculum
    assert cfg.terminations.upside_down_limit == 0.7
    play = solo12_rough.rough_cfg(16, play=True)
    assert play.num_envs == 50 and not play.noise.enabled


# ---------------------------------------------------------------------------
# the EnvCfg solver fields
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("structure,iterations", [
    (None, None), ("gs", None), (None, 8), ("bj:4:0.9:6", None),
    ("bj:4:0.9:6", 3), ("bj:2", 7), ("bj:3:0.8", None), ("gs", 3),
])
def test_env_cfg_solver_fields(structure, iterations):
    """None keeps the SolverParams default (serial GS, 5 sweeps); an
    explicit solver_iterations wins over the structure string's count;
    the env builds the engine those params ask for."""
    jc = jenv.EnvCfg(num_envs=2, solver_structure=structure,
                     solver_iterations=iterations)
    tc_ = tenv.EnvCfg(num_envs=2, solver_structure=structure,
                      solver_iterations=iterations)
    je = jenv.CatEnv(jax_solo12(), jc, jax_rough_terms(jax_solo12()),
                     SOLO12_ACTUATED_JOINT_ORDER)
    ref = je._engine_step.args[1].solver
    port = tenv.engine_params(tc_).solver
    assert port._asdict() == ref._asdict()
    te = tenv.CatEnv(port_solo12(), tc_,
                     solo12_rough.rough_constraint_terms(port_solo12()),
                     SOLO12_ACTUATED_JOINT_ORDER, device="cpu")
    assert te.engine.solve is (pgs.pgs_gs if port.structure == "gs"
                               else pgs.pgs_bj)
    assert te.engine.pgs_kwargs["iterations"] == ref.iterations
