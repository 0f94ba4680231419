"""Shared set-up for the tests that hold the PyTorch port (cat_tpu_torch)
against the JAX package: the same deterministic env configurations (flat
and rough), the JAX env on the engine path the port reproduces, and one
torch thread."""

import dataclasses

import torch

from cat_tpu.envs import env as jenv
from cat_tpu.models.solo12 import SOLO12_ACTUATED_JOINT_ORDER
from cat_tpu.models.solo12 import solo12_model as jax_solo12
from cat_tpu.sim import engine as jengine
from cat_tpu.sim import terrain as jterrain
from cat_tpu.sim.solver import SolverParams
from cat_tpu.tasks.solo12_flat import solo12_constraint_terms as jax_terms
from cat_tpu_torch.envs import env as tenv
from cat_tpu_torch.sim import terrain as tterrain
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


# a small rough terrain: 3 difficulty rows (so every env starts on row 0)
# x 2 terrain types of 4 m patches
TERRAIN = dict(rows=3, cols=2, patch_m=4.0, cell=0.1, seed=3)


def rough_cfgs(n, noise):
    """(JAX, port) rough EnvCfgs: the deterministic configurations above
    on the TERRAIN heightfield, with the height scan, the terrain
    curriculum and the rough fall limit; observation noise on if asked."""
    out = []
    for m, t, c in zip((jenv, tenv), (jterrain, tterrain), deterministic_cfgs(n)):
        c = dataclasses.replace(
            c, terrain=t.generate_rough(**TERRAIN),
            height_scan=m.HeightScanCfg(), terrain_curriculum=True,
            terminations=m.TerminationsCfg(upside_down_limit=0.7))
        if noise:
            c = dataclasses.replace(c, noise=m.NoiseCfg())
        out.append(c)
    return out


def jax_env_lanes_bj(cfg, terms=jax_terms):
    """The JAX CatEnv on the lanes engine with the cfg's block-Jacobi solve
    through the pure-XLA mirror (CPU) on the cfg's terrain: the path the
    port reproduces. The env's own CPU default is the vmap layout with the
    serial solver."""
    model = jax_solo12()
    env = jenv.CatEnv(model, cfg, terms(model), SOLO12_ACTUATED_JOINT_ORDER)
    structure, blocks, omega, iters = cfg.solver_structure.split(":")
    params = jengine.EngineParams(
        dt=cfg.sim_dt, decimation=cfg.decimation, kp=cfg.kp, kd=cfg.kd,
        solver=SolverParams(structure=structure, bj_blocks=int(blocks),
                            omega=float(omega), iterations=int(iters)))
    env._engine_step = jengine.make_batched_step(
        model, params, num_envs=0, terrain=cfg.terrain, layout="lanes")
    return env


def port_env(cfg):
    return tflat.make_env(cfg.num_envs, cfg=cfg, device="cpu")


