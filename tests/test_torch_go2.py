"""The second robot family in the port: the Go2-class quadruped's model, raw
engine, env and learner against the JAX package's (the counterparts of the
4 tests of tests/test_go2.py).

* The model: the port's JSON is a byte-for-byte copy of the JAX package's,
  and its sanity checks are tests/test_go2.py's.
* The raw engine (GS-5, kp 25, kd 0.5): the JAX engine settles 4 robots
  from the default pose for 75 control steps (tests/test_go2.py's
  fixture); from that standing state both engines take 10 more steps,
  compared step for step. A landing is sensitive to rounding
  (tests/test_torch_rough.py::test_one_step_sensitivity_to_ulp_changes),
  so the chain starts from standing. Tolerances are those of
  tests/test_torch_engine.py: qpos atol 2e-3, qvel atol 2e-2, forces
  rtol/atol 0.05 (in newtons, of a 148 N weight). The port's own 75-step
  settle must stand and carry the weight as tests/test_go2.py requires.
* The env: the deterministic configuration of tests/_torch_port.py with
  Go2's gains, action scale and fall limit, both on the block-Jacobi
  solve; observations atol 1e-4, rewards atol 1e-6, constraint
  probabilities atol 1e-5 over 4 steps (tests/test_torch_env.py's bounds).
* One tiny training iteration on Go2 gives finite losses.

``python tests/test_torch_go2.py [envs steps command]`` (from the repo's
root, with ``tests`` on the path) plays the JAX-trained Go2 policy
(runs/go2_r4/policy_params.npz) in both packages on the CPU, by default at
48 envs for 200 control steps at a 0.5 m/s forward command, and prints the
share of envs that never fell, the mean step of an env's first fall and
the forward speed: the figures that set the play gate of chip_smoke.py.
"""

import dataclasses
import filecmp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from _torch_port import deterministic_cfgs
from cat_tpu.envs import env as jenv
from cat_tpu.models.go2 import GO2_ACTUATED_JOINT_ORDER
from cat_tpu.models.go2 import go2_model as jax_go2
from cat_tpu.sim import engine as jem
from cat_tpu.sim.solver import SolverParams as JSolverParams
from cat_tpu.tasks.go2_flat import go2_constraint_terms as jax_go2_terms
from cat_tpu_torch.envs import env as tenv
from cat_tpu_torch.models import go2 as tgo2
from cat_tpu_torch.sim import engine as tem
from cat_tpu_torch.tasks import go2_flat

N_ENGINE, SETTLE, CHAIN = 4, 75, 10
N_ENV, ENV_STEPS = 6, 4
BUNDLE = "runs/go2_r4/policy_params.npz"


def test_model_sanity():
    assert filecmp.cmp("cat_tpu/models/go2_model.json",
                       "cat_tpu_torch/models/go2_model.json", shallow=False)
    m = tgo2.go2_model()
    assert m.nj == 12 and m.nv == 18 and m.ncand == 28 and m.npair == 0
    assert abs(float(m.mass.sum()) - 15.1) < 0.1
    assert m.uniform_3dof_branches()     # the structured M^-1, not Cholesky
    feet = [m.report_names[i] for i in m.foot_report_ids]
    assert sorted(feet) == ["FL_foot", "FR_foot", "RL_foot", "RR_foot"]
    j = jax_go2()
    for f in ("parent", "mass", "inertia", "cand_offset", "default_qpos_joints"):
        np.testing.assert_array_equal(getattr(m, f), getattr(j, f))
    assert tgo2.GO2_ACTUATED_JOINT_ORDER == GO2_ACTUATED_JOINT_ORDER


def _target(n):
    return np.tile(jax_go2().default_qpos_joints, (n, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def engines():
    """The JAX engine's 75-step settle, then 10 steps of each engine from
    that standing state; and the port's own 75-step settle."""
    params = dict(kp=tgo2.GO2_KP, kd=tgo2.GO2_KD)
    step_j = jax.jit(jem.make_batched_step(
        jax_go2(), jem.EngineParams(solver=JSolverParams(), **params),
        num_envs=N_ENGINE))
    step_t = tem.make_batched_step(tgo2.go2_model(), tem.EngineParams(**params),
                                   device="cpu")
    target = _target(N_ENGINE)
    mu = np.ones(N_ENGINE, np.float32)
    sj = jem.make_batched_init(jax_go2(), N_ENGINE)
    st = tem.make_batched_init(tgo2.go2_model(), N_ENGINE, "cpu")
    for _ in range(SETTLE):
        sj = step_j(sj, jnp.asarray(target), jnp.asarray(mu))
        st = step_t(st, torch.from_numpy(target), torch.from_numpy(mu))
    settled = st
    st = tem.SimState(*(torch.from_numpy(np.array(x)) for x in sj))
    for _ in range(CHAIN):
        sj = step_j(sj, jnp.asarray(target), jnp.asarray(mu))
        st = step_t(st, torch.from_numpy(target), torch.from_numpy(mu))
    return sj, st, settled


@pytest.mark.parametrize("field,tol", [
    ("qpos", dict(atol=2e-3)), ("qvel", dict(atol=2e-2)),
    ("forces", dict(rtol=0.05, atol=0.05)), ("touchdown", dict()),
])
def test_engine_from_standing_matches_jax(engines, field, tol):
    sj, st, _ = engines
    np.testing.assert_allclose(getattr(st, field).numpy(),
                               np.asarray(getattr(sj, field)), **tol)


def test_go2_stands_and_carries_its_weight(engines):
    """tests/test_go2.py::test_go2_stands and ::test_go2_weight_supported
    on the port's own settle."""
    s = engines[2]
    m = tgo2.go2_model()
    z = s.qpos[:, 2].numpy()
    assert np.all(z > 0.2) and np.all(z < 0.45), z
    quat = s.qpos[:, 3:7].numpy()
    tilt = 2 * np.sqrt(quat[:, 1] ** 2 + quat[:, 2] ** 2)
    assert np.all(tilt < 0.25), tilt
    assert np.all(np.abs(s.qvel.numpy()) < 0.6)
    fz = s.forces.reshape(N_ENGINE, m.nreport, 3)[:, :, 2].sum(dim=1)
    np.testing.assert_allclose(fz.numpy(), float(m.mass.sum()) * 9.81,
                               rtol=0.25)


def go2_cfgs(n):
    """(JAX, port) deterministic EnvCfgs with Go2's gains, action scale and
    fall limit."""
    return [dataclasses.replace(
        c, kp=tgo2.GO2_KP, kd=tgo2.GO2_KD, action_scale=0.25,
        terminations=m.TerminationsCfg(upside_down_limit=0.35))
        for m, c in zip((jenv, tenv), deterministic_cfgs(n))]


def jax_go2_env(cfg):
    """The JAX Go2 CatEnv on the lanes engine with the cfg's block-Jacobi
    solve through its pure-XLA mirror (the path the port reproduces)."""
    model = jax_go2()
    env = jenv.CatEnv(model, cfg, jax_go2_terms(model), GO2_ACTUATED_JOINT_ORDER,
                      illegal_contact_bodies=go2_flat.ILLEGAL_CONTACT_BODIES)
    structure, blocks, omega, iters = cfg.solver_structure.split(":")
    params = jem.EngineParams(
        dt=cfg.sim_dt, decimation=cfg.decimation, kp=cfg.kp, kd=cfg.kd,
        solver=JSolverParams(structure=structure, bj_blocks=int(blocks),
                             omega=float(omega), iterations=int(iters)))
    env._engine_step = jem.make_batched_step(model, params, num_envs=0,
                                             terrain=cfg.terrain, layout="lanes")
    return env


def port_go2_env(cfg):
    """The port's Go2 CatEnv under ``cfg`` on the CPU (the task's make_env
    builds the task's own cfg)."""
    model = tgo2.go2_model()
    return tenv.CatEnv(model=model, cfg=cfg,
                       constraint_terms=go2_flat.go2_constraint_terms(model),
                       actuated_joint_order=tgo2.GO2_ACTUATED_JOINT_ORDER,
                       illegal_contact_bodies=go2_flat.ILLEGAL_CONTACT_BODIES,
                       device="cpu")


@pytest.fixture(scope="module")
def env_rollout():
    jc, tc = go2_cfgs(N_ENV)
    je = jax_go2_env(jc)
    te = port_go2_env(tc)
    assert te.num_obs == 45 and te.num_actions == 12
    js = jax.jit(je.init, static_argnums=1)(jax.random.PRNGKey(0), N_ENV)
    gen = torch.Generator().manual_seed(0)
    ts = te.init(gen, N_ENV)
    step = jax.jit(je.step)
    rng = np.random.default_rng(0)
    out = []
    for _ in range(ENV_STEPS):
        a = rng.uniform(-1.0, 1.0, (N_ENV, 12)).astype(np.float32)
        js, jo, jr, jd, _ = step(js, jnp.asarray(a))
        ts, to, tr, td, _ = te.step(ts, torch.from_numpy(a), gen)
        out.append(((jo, jr, jd, js.episode_prob), (to, tr, td, ts.episode_prob)))
    return out


@pytest.mark.parametrize("i,name,atol", [
    (0, "obs", 1e-4), (1, "reward", 1e-6), (2, "dones", 1e-5),
    (3, "episode_prob", 1e-5),
])
def test_env_step_matches_jax(env_rollout, i, name, atol):
    for k, (jv, tv) in enumerate(env_rollout):
        np.testing.assert_allclose(tv[i].numpy(), np.asarray(jv[i]), atol=atol,
                                   err_msg=f"{name} at step {k}")
        assert np.all(np.isfinite(tv[i].numpy()))
    assert np.all(env_rollout[-1][1][1].numpy() >= 0.0)


def test_go2_train_iteration_is_finite():
    """tests/test_go2.py::test_go2_env_step_and_learn on the port."""
    from cat_tpu_torch.rl.ppo import PPO, PpoCfg

    env = go2_flat.make_env(8, device="cpu")
    gen = torch.Generator().manual_seed(0)
    es = env.init(gen, 8)
    ppo = PPO(env, PpoCfg(num_steps=4, num_iterations=2, minibatch_size=16),
              torch.Generator().manual_seed(1))
    ppo.start(env.observe(es, gen))
    es, metrics = ppo.train_iteration(es, gen)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert ppo.iteration == 1


def _play_cfg(m, n, vx):
    """Go2's task cfg at a fixed forward command, no pushes, no noise: the
    play gate's setting (``m`` is either package's env module)."""
    return m.EnvCfg(
        num_envs=n, kp=tgo2.GO2_KP, kd=tgo2.GO2_KD, action_scale=0.25,
        commands=m.CommandsCfg(lin_vel_x=(vx, vx), lin_vel_y=(0.0, 0.0),
                               ang_vel_z=(0.0, 0.0), rel_standing_envs=0.0),
        events=m.EventsCfg(push_enabled=False), noise=m.NoiseCfg(enabled=False),
        terminations=m.TerminationsCfg(upside_down_limit=0.35))


@pytest.mark.parametrize("robot", ["solo12", "go2"])
def test_play_overrides_give_the_gate_setting(robot):
    """chip_smoke.py's play phases set their task through make_env's
    overrides; their gates were set at these cfgs (Go2's is the one the
    JAX package's play below runs)."""
    from cat_tpu_torch.models.solo12 import SOLO12_KD, SOLO12_KP
    from cat_tpu_torch.tasks import solo12_flat
    from chip_smoke import PLAY_OVERRIDES, PLAY_VX

    if robot == "go2":
        cfg = go2_flat.make_env(8, overrides=PLAY_OVERRIDES, device="cpu").cfg
        assert cfg == _play_cfg(tenv, 8, PLAY_VX)
        return
    cfg = solo12_flat.make_env(8, overrides=PLAY_OVERRIDES, device="cpu").cfg
    assert cfg == tenv.EnvCfg(
        num_envs=8, kp=SOLO12_KP, kd=SOLO12_KD,
        commands=tenv.CommandsCfg(lin_vel_x=(PLAY_VX, PLAY_VX),
                                  lin_vel_y=(0.0, 0.0), ang_vel_z=(0.0, 0.0),
                                  rel_standing_envs=0.0),
        events=tenv.EventsCfg(push_enabled=False),
        noise=tenv.NoiseCfg(enabled=False))


def play_jax(n, steps, vx_cmd):
    bundle = dict(np.load(BUNDLE))
    env = jax_go2_env(_play_cfg(jenv, n, vx_cmd))

    def act(obs):
        x = (obs - bundle["obs_mean"]) / jnp.sqrt(bundle["obs_var"] + 1e-8)
        for i in range(4):
            x = x @ bundle[f"actor_w{i}"] + bundle[f"actor_b{i}"]
            if i < 3:
                x = jax.nn.elu(x)
        return x

    from cat_tpu.sim.maths import quat_rotate_inv

    @jax.jit
    def one(es, obs):
        es, obs, _, _, _ = env.step(es, act(obs))
        vx = jax.vmap(quat_rotate_inv)(es.sim.qpos[:, 3:7],
                                       es.sim.qvel[:, 0:3])[:, 0]
        return es, obs, es.episode_len == 0, vx

    es = jax.jit(env.init, static_argnums=1)(jax.random.PRNGKey(1), n)
    obs = jax.jit(env.observe)(es)
    first, vx = np.full(n, steps), []
    for t in range(steps):
        es, obs, reset, v = one(es, obs)
        first = np.where(np.asarray(reset) & (first == steps), t, first)
        vx.append(np.asarray(v))
    return ((first == steps).mean(), first.mean(),
            float(np.mean(vx[steps // 2:])))


def play_port(n, steps, vx_cmd):
    from cat_tpu_torch.play import rollout
    from cat_tpu_torch.rl.convert import actor_from_bundle
    from cat_tpu_torch.rl.networks import ActorCritic

    sd, mean, var = actor_from_bundle(dict(np.load(BUNDLE)))
    net = ActorCritic(45, 12)
    net.load_state_dict(sd, strict=False)
    env = port_go2_env(_play_cfg(tenv, n, vx_cmd))
    gen = torch.Generator().manual_seed(1)
    run = rollout(env, env.init(gen, n),
                  lambda obs: net.actor((obs - mean) / torch.sqrt(var + 1e-8)),
                  steps, gen)
    first = run["first_reset"]
    return ((first == steps).float().mean().item(), first.float().mean().item(),
            run["vx"][steps // 2:].mean().item())


if __name__ == "__main__":
    args = sys.argv[1:] or ("48", "200", "0.5")
    n, steps, vx_cmd = int(args[0]), int(args[1]), float(args[2])
    for name, fn in (("JAX package", play_jax), ("port", play_port)):
        survive, first, vx = fn(n, steps, vx_cmd)
        print(f"{name}: {survive * 100:.1f}% of {n} envs never fell in {steps}"
              f" steps (first fall at step {first:.1f} on average, {steps} "
              f"for none); forward velocity {vx:.3f} m/s over the last "
              f"{steps // 2} (command {vx_cmd} m/s)", flush=True)
