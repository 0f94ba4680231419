"""Shared set-up for the tests that hold the PyTorch port (cat_tpu_torch)
against the JAX package: the same deterministic env configurations, the JAX
env on the engine path the port reproduces, and one torch thread."""

import torch

from cat_tpu.envs import env as jenv
from cat_tpu.models.solo12 import SOLO12_ACTUATED_JOINT_ORDER
from cat_tpu.models.solo12 import solo12_model as jax_solo12
from cat_tpu.sim import engine as jengine
from cat_tpu.sim.solver import SolverParams
from cat_tpu.tasks.solo12_flat import solo12_constraint_terms as jax_terms
from cat_tpu_torch.envs import env as tenv
from cat_tpu_torch.tasks import solo12_flat as tflat

# The port's CPU tests run tiny tensors: one intra-op thread each keeps the
# test workers from oversubscribing the cores (with the default thread count
# they ran ~50x slower on a loaded 8-core CPU).
torch.set_num_threads(1)


def deterministic_cfgs(n):
    """(JAX EnvCfg, port EnvCfg) with every random draw made irrelevant:
    observation noise and pushes off, zero-width friction, command and
    reset ranges, no standing envs, zero yaw command (so the random
    yaw-rate flip changes nothing)."""
    def build(m):
        return m.EnvCfg(
            num_envs=n, kp=4.0, kd=0.2,
            commands=m.CommandsCfg(lin_vel_x=(0.5, 0.5),
                                   lin_vel_y=(0.2, 0.2),
                                   ang_vel_z=(0.0, 0.0),
                                   rel_standing_envs=0.0),
            events=m.EventsCfg(friction_range=(0.8, 0.8), reset_pose_xy=0.0,
                               reset_yaw=0.0, reset_joint_scale=(1.0, 1.0),
                               push_enabled=False),
            noise=m.NoiseCfg(enabled=False),
        )
    return build(jenv), build(tenv)


def jax_env_lanes_bj(cfg):
    """The JAX CatEnv on the lanes engine with the cfg's block-Jacobi solve
    through the pure-XLA mirror (CPU): the path the port reproduces. The
    env's own CPU default is the vmap layout with the serial solver."""
    model = jax_solo12()
    env = jenv.CatEnv(model, cfg, jax_terms(model), SOLO12_ACTUATED_JOINT_ORDER)
    structure, blocks, omega, iters = cfg.solver_structure.split(":")
    params = jengine.EngineParams(
        dt=cfg.sim_dt, decimation=cfg.decimation, kp=cfg.kp, kd=cfg.kd,
        solver=SolverParams(structure=structure, bj_blocks=int(blocks),
                            omega=float(omega), iterations=int(iters)))
    env._engine_step = jengine.make_batched_step(
        model, params, num_envs=0, layout="lanes")
    return env


def port_env(cfg):
    return tflat.make_env(cfg.num_envs, cfg=cfg, device="cpu")


