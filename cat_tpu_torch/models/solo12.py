"""Solo12 robot model (the port's copy of cat_tpu/models/solo12.py).

``solo12_model.json`` is compiled from the Solo12 URDF; the gains and the
joint order follow the reference task (odri.py:81-82,
cat_flat_env_cfg.py:116-128: HR before HL).
"""

import functools
import os

from cat_tpu_torch.sim.model import RobotModel

_JSON = os.path.join(os.path.dirname(__file__), "solo12_model.json")

SOLO12_KP = 4.0
SOLO12_KD = 0.2

SOLO12_ACTUATED_JOINT_ORDER = (
    "FL_HAA", "FL_HFE", "FL_KFE",
    "FR_HAA", "FR_HFE", "FR_KFE",
    "HR_HAA", "HR_HFE", "HR_KFE",
    "HL_HAA", "HL_HFE", "HL_KFE",
)

# Self-collision capsules: lower leg (shin + foot, blended radius) and the
# base box approximated by an x-axis capsule.
_SHIN = dict(p0=(0.0, 0.0, -0.03), p1=(0.0, 0.0, -0.16), r=0.016)
_BASE = dict(p0=(-0.2, 0.0, 0.03), p1=(0.2, 0.0, 0.03), r=0.06)


def _cap_pair(body_a, cap_a, body_b, cap_b):
    return dict(
        body_a=body_a, p0_a=cap_a["p0"], p1_a=cap_a["p1"], radius_a=cap_a["r"],
        body_b=body_b, p0_b=cap_b["p0"], p1_b=cap_b["p1"], radius_b=cap_b["r"],
    )


SOLO12_SELF_COLLISION_PAIRS = (
    _cap_pair("FL_LOWER_LEG", _SHIN, "FR_LOWER_LEG", _SHIN),
    _cap_pair("HL_LOWER_LEG", _SHIN, "HR_LOWER_LEG", _SHIN),
    _cap_pair("FL_LOWER_LEG", _SHIN, "HL_LOWER_LEG", _SHIN),
    _cap_pair("FR_LOWER_LEG", _SHIN, "HR_LOWER_LEG", _SHIN),
    _cap_pair("FL_LOWER_LEG", _SHIN, "base_link", _BASE),
    _cap_pair("FR_LOWER_LEG", _SHIN, "base_link", _BASE),
    _cap_pair("HL_LOWER_LEG", _SHIN, "base_link", _BASE),
    _cap_pair("HR_LOWER_LEG", _SHIN, "base_link", _BASE),
)


@functools.lru_cache(maxsize=2)
def solo12_model(self_collisions: bool = True) -> RobotModel:
    with open(_JSON) as f:
        model = RobotModel.from_json(f.read())
    if self_collisions:
        model = model.with_self_collision_pairs(SOLO12_SELF_COLLISION_PAIRS)
    return model
