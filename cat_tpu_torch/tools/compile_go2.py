"""Compile the Go2-class quadruped URDF into its model JSON.

  python -m cat_tpu_torch.tools.compile_go2 [URDF] [--out PATH]

URDF defaults to the port's ``models/assets/go2.urdf`` and PATH to
``models/go2_model.json``. Actuator values follow public Go2-class spec
sheets: 23.7 N m joints, 30 rad/s, rotor armature ~0.01 kg m^2 reflected
(``models/go2.py``: ``compile_go2``).
"""

import argparse
import os
from typing import Optional, Sequence

from cat_tpu_torch.models.go2 import GO2_URDF, compile_go2
from cat_tpu_torch.tools import MODELS_DIR, write_model


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("urdf", nargs="?", default=GO2_URDF)
    p.add_argument("--out", default=os.path.join(MODELS_DIR,
                                                 "go2_model.json"))
    args = p.parse_args(argv)
    write_model(compile_go2(args.urdf), args.out)


if __name__ == "__main__":
    main()
