"""Inputs of one physics substep in each configuration the substep kernels
(cat_tpu_torch/ops/substep.py) serve, made from a numpy seed: Solo12 on
the plane, on a small rough heightfield (two envs at and beyond the
grid's edge, where the lookup clamps), with CoM offsets (the DR event),
in fast motion (large velocity terms in the bias forces C); Go2 on the
plane (no self-collision pairs: no frame); the joint-less box on its 25
degree slope (the Cholesky M^-1). Imports no JAX, so the card tests use
it too."""

from typing import NamedTuple, Optional

import numpy as np
import torch

from cat_tpu_torch.models.box import box_model, on_slope_qpos, slope_terrain
from cat_tpu_torch.models.go2 import GO2_KD, GO2_KP, go2_model
from cat_tpu_torch.models.solo12 import SOLO12_KD, SOLO12_KP, solo12_model
from cat_tpu_torch.sim import engine, terrain
from cat_tpu_torch.sim.maths import quat_from_euler_zyx

CASES = ("solo12-plane", "solo12-rough", "solo12-com", "solo12-fast", "go2",
         "box")
ROUGH = dict(rows=3, cols=2, patch_m=4.0, cell=0.1, seed=3)


class Case(NamedTuple):
    model: object                # the port's RobotModel
    params: engine.EngineParams
    terrain: terrain.Terrain
    qpos: np.ndarray             # (n, nq) float32
    qvel: np.ndarray             # (n, nv)
    target: np.ndarray           # (n, nj)
    com_offset: Optional[np.ndarray]   # (n, nb, 3) or None


def make_case(name: str, n: int, seed: int = 0) -> Case:
    """Varied states: the base moved and turned a little (on the
    heightfield anywhere over the grid, 0.25 m above it), joints +-0.3 rad
    off the default pose, velocities in +-1 (in "solo12-fast" the base's
    linear velocity in +-2 m/s, its angular velocity in +-5 rad/s and the
    joints' in +-10 rad/s), PD targets +-0.5 rad about the default
    pose."""
    rng = np.random.default_rng(seed)
    terr, com = terrain.plane(), None
    if name == "box":
        model, terr = box_model(), slope_terrain(25.0)
        params = engine.EngineParams()
        qpos = on_slope_qpos(25.0, n)
        qpos[:, 0:3] += rng.uniform(-0.2, 0.2, (n, 3))
    else:
        if name == "go2":
            model = go2_model()
            params = engine.EngineParams(kp=GO2_KP, kd=GO2_KD)
        else:
            model = solo12_model()
            params = engine.EngineParams(kp=SOLO12_KP, kd=SOLO12_KD)
        qpos = np.tile(model.default_qpos(), (n, 1))
        qpos[:, 0:3] += rng.uniform(-0.1, 0.1, (n, 3))
        ang = torch.from_numpy(rng.uniform(-0.3, 0.3, (n, 3)))
        qpos[:, 3:7] = quat_from_euler_zyx(*ang.T).numpy()
        qpos[:, 7:] += rng.uniform(-0.3, 0.3, (n, model.nj))
        if name == "solo12-rough":
            terr = terrain.generate_rough(**ROUGH)
            h, w = terr.size_m
            qpos[:, 0] = rng.uniform(-h / 2, h / 2, n)
            qpos[:, 1] = rng.uniform(-w / 2, w / 2, n)
            qpos[0, 0:2] = (h / 2 - 0.02, w / 2 - 0.05)     # at the edge
            qpos[1, 0:2] = (-h / 2 + 0.01, -w / 2 - 0.3)    # beyond it
            qpos[:, 2] = terrain.height_at(
                terr, torch.from_numpy(qpos[:, 0:2]).float()).numpy() + 0.25
        if name == "solo12-com":
            com = rng.uniform(-0.05, 0.05, (n, model.nbody, 3))
    qvel = rng.uniform(-1.0, 1.0, (n, model.nv))
    if name == "solo12-fast":
        qvel[:, 0:3] = rng.uniform(-2.0, 2.0, (n, 3))
        qvel[:, 3:6] = rng.uniform(-5.0, 5.0, (n, 3))
        qvel[:, 6:] = rng.uniform(-10.0, 10.0, (n, model.nj))
    target = model.default_qpos_joints + rng.uniform(-0.5, 0.5, (n, model.nj))

    def f32(x):
        return None if x is None else np.ascontiguousarray(x, np.float32)

    return Case(model, params, terr, f32(qpos), f32(qvel), f32(target),
                f32(com))


def torch_inputs(case: Case, device):
    """(qpos, qvel, target, com_offset) as float32 tensors on ``device``."""
    return tuple(None if x is None else torch.from_numpy(x).to(device)
                 for x in (case.qpos, case.qvel, case.target,
                           case.com_offset))
