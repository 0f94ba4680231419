"""Go2-class quadruped model (the port's copy of cat_tpu/models/go2.py).

``go2_model.json`` is a byte-for-byte copy of the JAX package's asset,
compiled from ``assets/go2.urdf`` (``compile_go2``; the committed file
predates the ten empty ``pair_*`` fields a compile writes): 12 revolute
joints in three-dof legs (so the engine takes the structured M^-1), 28
contact spheres, no self-collision pair. Actuators follow public Go2-class
spec sheets (23.7 N m, 30 rad/s, ~0.01 kg m^2 reflected rotor armature);
gains follow common Go2-class recipes (stiffness 25, damping 0.5; the
task's action scale is 0.25).
"""

import functools
import os

from cat_tpu_torch.sim.model import RobotModel
from cat_tpu_torch.sim.urdf import compile_urdf

_JSON = os.path.join(os.path.dirname(__file__), "go2_model.json")
GO2_URDF = os.path.join(os.path.dirname(__file__), "assets", "go2.urdf")

GO2_KP = 25.0
GO2_KD = 0.5

GO2_ACTUATED_JOINT_ORDER = (
    "FL_hip_joint", "FL_thigh_joint", "FL_calf_joint",
    "FR_hip_joint", "FR_thigh_joint", "FR_calf_joint",
    "RL_hip_joint", "RL_thigh_joint", "RL_calf_joint",
    "RR_hip_joint", "RR_thigh_joint", "RR_calf_joint",
)


GO2_DEFAULT_JOINT_POS = {
    "FL_hip_joint": 0.1, "FL_thigh_joint": 0.8, "FL_calf_joint": -1.5,
    "FR_hip_joint": -0.1, "FR_thigh_joint": 0.8, "FR_calf_joint": -1.5,
    "RL_hip_joint": 0.1, "RL_thigh_joint": 1.0, "RL_calf_joint": -1.5,
    "RR_hip_joint": -0.1, "RR_thigh_joint": 1.0, "RR_calf_joint": -1.5,
}


def compile_go2(urdf: str = GO2_URDF) -> RobotModel:
    """The Go2 model compiled from ``urdf`` with the committed JSON's
    actuator values, default pose and base height."""
    return compile_urdf(urdf, armature=0.01, effort_limit=23.7,
                        velocity_limit=30.0,
                        default_joint_pos=GO2_DEFAULT_JOINT_POS,
                        default_base_pos=(0.0, 0.0, 0.34))


@functools.lru_cache(maxsize=1)
def go2_model() -> RobotModel:
    with open(_JSON) as f:
        return RobotModel.from_json(f.read())
