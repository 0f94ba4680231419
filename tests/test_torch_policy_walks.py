"""The policy the port learned on the H100 walks in the JAX package.

runs/torch_solo12_flat_2000it/policy_params.npz, written by
``python -m cat_tpu_torch.play`` after the port's 2000-iteration flat run,
is read in the JAX package's bundle layout (cat_tpu/rl/export.py: the
observation normaliser, then the 512-256-128 ELU actor; the mean action)
and played in cat_tpu's CatEnv of Solo12-CaT-Flat-v0 at the play setting
of chip_smoke.py (a fixed 1.0 m/s forward command, no pushes, no noise),
64 envs for 200 control steps on the CPU, on the lanes engine with the
block-Jacobi solve through its pure-XLA mirror (the path the port
reproduces). The gate is chip_smoke.py's for the JAX-trained policy: at
least half the envs never hit a hard termination, and the forward velocity
over the last 100 steps is at least half the command. This is the reverse
of the port playing the JAX-trained policy.

``PYTHONPATH=.:tests python tests/test_torch_policy_walks.py [bundle]``
prints the figures the test gates (for any bundle of that layout, e.g.
runs/solo12_flat_2000it/policy_params.npz).
"""

import jax
import jax.numpy as jnp
import numpy as np

from cat_tpu.sim import engine as jem
from cat_tpu.sim.maths import quat_rotate_inv
from cat_tpu.sim.solver import SolverParams
from cat_tpu.tasks import solo12_flat
from chip_smoke import PLAY_OVERRIDES, PLAY_STEPS, PLAY_VX

BUNDLE = "runs/torch_solo12_flat_2000it/policy_params.npz"
N = 64


def _actor(bundle):
    """The bundle's deterministic policy: observation -> mean action."""
    layers = [(jnp.asarray(bundle[f"actor_w{i}"]),
               jnp.asarray(bundle[f"actor_b{i}"])) for i in range(4)]
    mean = jnp.asarray(bundle["obs_mean"])
    std = jnp.sqrt(jnp.asarray(bundle["obs_var"]) + 1e-8)

    def act(obs):
        x = (obs - mean) / std
        for i, (w, b) in enumerate(layers):
            x = x @ w + b
            if i < len(layers) - 1:
                x = jax.nn.elu(x)
        return x
    return act


def _env(n):
    env = solo12_flat.make_env(n, overrides=PLAY_OVERRIDES)
    cfg = env.cfg
    structure, blocks, omega, iters = cfg.solver_structure.split(":")
    env._engine_step = jem.make_batched_step(
        env.model, jem.EngineParams(
            dt=cfg.sim_dt, decimation=cfg.decimation, kp=cfg.kp, kd=cfg.kd,
            solver=SolverParams(structure=structure, bj_blocks=int(blocks),
                                omega=float(omega), iterations=int(iters))),
        num_envs=0, terrain=cfg.terrain, layout="lanes")
    return env


def play(path, n=N, steps=PLAY_STEPS):
    """The bundle at ``path`` in the JAX env: (share of envs that never
    fell, mean step of an env's first fall with ``steps`` for none, mean
    forward velocity over the second half)."""
    bundle = dict(np.load(path))
    shapes = [bundle[f"actor_w{i}"].shape for i in range(4)]
    assert shapes == [(45, 512), (512, 256), (256, 128), (128, 12)]
    assert bundle["obs_mean"].shape == bundle["obs_var"].shape == (45,)
    env, act = _env(n), _actor(bundle)

    @jax.jit
    def one(es, obs):
        es, obs, _, _, _ = env.step(es, act(obs))
        vx = jax.vmap(quat_rotate_inv)(es.sim.qpos[:, 3:7],
                                       es.sim.qvel[:, 0:3])[:, 0]
        return es, obs, es.episode_len == 0, vx

    es = jax.jit(env.init, static_argnums=1)(jax.random.PRNGKey(1), n)
    obs = jax.jit(env.observe)(es)
    # no episode times out in these steps, so a reset is a fall
    first, vx = np.full(n, steps), []
    for t in range(steps):
        es, obs, reset, v = one(es, obs)
        first = np.where(np.asarray(reset) & (first == steps), t, first)
        vx.append(np.asarray(v))
    return (float((first == steps).mean()), float(first.mean()),
            float(np.mean(vx[steps // 2:])))


def test_port_trained_policy_walks_in_the_jax_package():
    survive, first, vx = play(BUNDLE)
    assert survive >= 0.5, (survive, first)
    assert vx >= 0.5 * PLAY_VX, vx


if __name__ == "__main__":
    # python tests/test_torch_policy_walks.py [bundle] (from the repo's
    # root, with tests on the path): the figures the test gates
    import sys

    import conftest  # noqa: F401  (JAX on the CPU)

    path = sys.argv[1] if len(sys.argv) > 1 else BUNDLE
    survive, first, vx = play(path)
    print(f"{path}: {survive * 100:.1f}% of {N} envs never fell in "
          f"{PLAY_STEPS} steps (first fall at step {first:.1f} on average, "
          f"{PLAY_STEPS} for none); forward velocity {vx:.3f} m/s over the "
          f"last {PLAY_STEPS // 2} (command {PLAY_VX} m/s)")
