"""Go2-class quadruped model (the port's copy of cat_tpu/models/go2.py).

``go2_model.json`` is a byte-for-byte copy of the JAX package's asset,
compiled from a Go2-class URDF: 12 revolute joints in three-dof legs (so
the engine takes the structured M^-1), 28 contact spheres, no
self-collision pair. Gains follow common Go2-class recipes (stiffness 25,
damping 0.5; the task's action scale is 0.25).
"""

import functools
import os

from cat_tpu_torch.sim.model import RobotModel

_JSON = os.path.join(os.path.dirname(__file__), "go2_model.json")

GO2_KP = 25.0
GO2_KD = 0.5

GO2_ACTUATED_JOINT_ORDER = (
    "FL_hip_joint", "FL_thigh_joint", "FL_calf_joint",
    "FR_hip_joint", "FR_thigh_joint", "FR_calf_joint",
    "RL_hip_joint", "RL_thigh_joint", "RL_calf_joint",
    "RR_hip_joint", "RR_thigh_joint", "RR_calf_joint",
)


@functools.lru_cache(maxsize=1)
def go2_model() -> RobotModel:
    with open(_JSON) as f:
        return RobotModel.from_json(f.read())
