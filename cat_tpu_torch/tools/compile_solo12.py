"""Compile the Solo12 URDF (``solo12_mpi.urdf`` of the ODRI
solo12_description) into its model JSON.

  python -m cat_tpu_torch.tools.compile_solo12 URDF [--out PATH]

PATH defaults to ``models/solo12_model.json``. The URDF is not in the
repository, so it has no default. Actuator overrides mirror the reference
robot config (odri.py:43-84): armature 3.6207e-4, effort limit 10,
velocity limit 100, base z 0.3, joint defaults HAA +-0.05 / HFE 0.4 /
KFE -0.8.
"""

import argparse
import os
import sys
from typing import Optional, Sequence

from cat_tpu_torch.sim.urdf import compile_urdf
from cat_tpu_torch.tools import MODELS_DIR, write_model

DEFAULT_JOINT_POS = {
    "FL_HAA": 0.05, "FL_HFE": 0.4, "FL_KFE": -0.8,
    "FR_HAA": -0.05, "FR_HFE": 0.4, "FR_KFE": -0.8,
    "HR_HAA": -0.05, "HR_HFE": 0.4, "HR_KFE": -0.8,
    "HL_HAA": 0.05, "HL_HFE": 0.4, "HL_KFE": -0.8,
}


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("urdf")
    p.add_argument("--out", default=os.path.join(MODELS_DIR,
                                                 "solo12_model.json"))
    args = p.parse_args(argv)
    if not os.path.isfile(args.urdf):
        sys.exit(f"no Solo12 URDF at {args.urdf}: pass the path of "
                 f"solo12_mpi.urdf (solo12_description)")
    model = compile_urdf(args.urdf, armature=0.00036207, effort_limit=10.0,
                         velocity_limit=100.0,
                         default_joint_pos=DEFAULT_JOINT_POS,
                         default_base_pos=(0.0, 0.0, 0.3))
    write_model(model, args.out)


if __name__ == "__main__":
    main()
