"""Contact solver parameters (port of cat_tpu/sim/solver.py:35-69).

The solve itself is ``cat_tpu_torch.ops.pgs``: the block-Jacobi projected
Gauss-Seidel kernel and its plain PyTorch version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SolverParams(NamedTuple):
    iterations: int = 5          # PGS sweeps (PhysX 4 position + 1 velocity)
    erp: float = 0.2             # penetration correction per step
    cfm: float = 1e-4            # constraint regularization
    slop: float = 0.002          # penetration tolerance (m)
    margin: float = 0.0          # activation distance
    max_depen_vel: float = 2.0   # cap on the Baumgarte push-out speed (m/s)
    structure: str = "gs"        # "gs" serial sweep | "bj" block-Jacobi
    bj_blocks: int = 1           # contact groups for structure="bj"
    omega: float = 1.0           # under-relaxation for structure="bj"


def contact_bias(phi: torch.Tensor, h: float, params: SolverParams) -> torch.Tensor:
    """Baumgarte stabilization velocity (<= 0), depenetration-clamped."""
    return torch.clamp(
        (params.erp / h) * torch.clamp(phi + params.slop, max=0.0),
        min=-params.max_depen_vel,
    )
