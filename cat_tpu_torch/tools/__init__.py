"""Command-line tools: the asset pipeline's compile scripts
(``compile_go2`` and ``compile_solo12`` compile a robot's URDF into its
model JSON), the contact solve's structure probe
(``pgs_structure_probe``) and the preemption drill (``resume_drill``)."""

import os

from cat_tpu_torch.sim.model import RobotModel

MODELS_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "models")


def write_model(model: RobotModel, out: str):
    """Write ``model.to_json()`` to ``out`` and print the counts, the total
    mass and the path written."""
    with open(out, "w") as f:
        f.write(model.to_json())
    print(f"bodies={model.nbody} joints={model.nj} cands={model.ncand} "
          f"reports={model.report_names}")
    print(f"total mass={model.mass.sum():.4f} kg")
    print(f"wrote {os.path.abspath(out)}")
