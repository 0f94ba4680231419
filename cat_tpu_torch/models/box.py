"""A free box with four corner contact spheres and no joint, and a
constant-slope heightfield to set it on.

The smallest model the raw engine runs (4 contacts, 6 velocity dofs), and
one whose branches are not 3-dof legs, so its M^-1 comes from the unrolled
Cholesky. It is the body of the JAX package's slope and heightfield-edge
tests (tests/test_slope.py, tests/test_hfield_edges.py): with friction
1.0 > tan(25 deg) it must stick on a 25 degree slope, and slide with
friction 1e-3.
"""

from __future__ import annotations

import numpy as np

from cat_tpu_torch.sim.model import RobotModel
from cat_tpu_torch.sim.terrain import Terrain

HALF = 0.05      # half the box's side (m)
RADIUS = 0.01    # corner sphere radius (m)


def box_model() -> RobotModel:
    """One free body of 0.5 kg with contact spheres at its four lower
    corners."""
    corners = np.array([[HALF, HALF, 0.0], [HALF, -HALF, 0.0],
                        [-HALF, HALF, 0.0], [-HALF, -HALF, 0.0]])
    return RobotModel(
        body_names=("box",),
        parent=np.array([-1]),
        joint_pos=np.zeros((1, 3)),
        joint_rot=np.eye(3)[None],
        joint_axis=np.zeros((1, 3)),
        joint_names=(),
        mass=np.array([0.5]),
        com=np.zeros((1, 3)),
        inertia=np.eye(3)[None] * 1e-3,
        armature=np.zeros(0),
        joint_limit_lower=np.zeros(0),
        joint_limit_upper=np.zeros(0),
        effort_limit=np.zeros(0),
        velocity_limit=np.zeros(0),
        default_base_pos=np.array([0.0, 0.0, 0.1]),
        default_qpos_joints=np.zeros(0),
        cand_body=np.zeros(4, dtype=np.int32),
        cand_offset=corners,
        cand_radius=np.full(4, RADIUS),
        cand_report=np.zeros(4, dtype=np.int32),
        report_names=("box",),
        site_names=(),
        site_body=np.zeros(0, dtype=np.int32),
        site_offset=np.zeros((0, 3)),
        foot_report_ids=np.array([0]),
    )


def slope_terrain(deg: float, n: int = 128, cell: float = 0.1) -> Terrain:
    """Heightfield h(x, y) = tan(deg) x over an n x n grid of `cell` m,
    centred on the origin (downhill is -x)."""
    xs = (np.arange(n) - n / 2 + 0.5) * cell
    grid = np.broadcast_to(np.tan(np.deg2rad(deg)) * xs[:, None], (n, n))
    return Terrain(kind="hfield", height=np.ascontiguousarray(grid, np.float32),
                   cell=cell, rows=1, cols=1, patch_m=n * cell)


def on_slope_qpos(deg: float, n: int) -> np.ndarray:
    """(n, 7) float32: the box 3 cm above the origin, tilted to lie along
    the slope."""
    half = np.deg2rad(deg) / 2.0
    q = np.array([0.0, 0.0, 0.03, np.cos(half), 0.0, np.sin(half), 0.0])
    return np.tile(q, (n, 1)).astype(np.float32)
