"""Contact solver parameters and the dense serial PGS solve (port of
cat_tpu/sim/solver.py).

The engine's solves are ``cat_tpu_torch.ops.pgs``: the block-Jacobi and
serial Gauss-Seidel kernels, which work on (E, W) and never form the
Delassus operator, and their plain PyTorch versions. ``pgs_solve`` here is
the reference's A-form solve, plain PyTorch: the converged reference of
``tools/pgs_structure_probe.py``.
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


def pgs_solve(A: torch.Tensor, b: torch.Tensor, phi: torch.Tensor, mu,
              lam0: torch.Tensor, h: float,
              params: SolverParams) -> torch.Tensor:
    """Serial projected Gauss-Seidel on the Delassus operator A = J M^-1 J^T
    (..., 3nc, 3nc), symmetric; b (..., 3nc) = J v_free, phi (..., nc)
    signed distances, mu () / (...) / (..., nc) friction, lam0 (..., nc, 3)
    warm start; leading axes are a batch of independent problems. Returns
    the impulses (..., nc, 3) in the contact frame, in the reference's
    order of operations (cat_tpu/sim/solver.py:72)."""
    nc = phi.shape[-1]
    batch = phi.shape[:-1]
    active = (phi < params.margin).to(A.dtype)                 # (..., nc)
    lam = lam0 * active[..., None]                             # (..., nc, 3)
    bias = contact_bias(phi, h, params)
    mu = torch.as_tensor(mu, dtype=A.dtype, device=A.device)
    if mu.dim() == phi.dim() - 1 and mu.dim() > 0:
        mu = mu[..., None]                                     # per problem
    mu = torch.broadcast_to(mu, phi.shape)

    # row blocks A_blk[i] = A[3i:3i+3, :]; by symmetry also the column
    # blocks, so the rank-3 update reads rows
    A_blk = A.reshape(*batch, nc, 3, 3 * nc)
    D = torch.stack([A_blk[..., i, :, 3 * i:3 * i + 3] for i in range(nc)],
                    dim=-3)                                    # (..., nc, 3, 3)
    inv_d = 1.0 / (torch.diagonal(D, dim1=-2, dim2=-1) + params.cfm)
    b_blk = b.reshape(*batch, nc, 3)
    w = torch.matmul(A, lam.reshape(*batch, 3 * nc, 1)).reshape(*batch, nc, 3)

    for _ in range(params.iterations):
        for i in range(nc):
            v = w[..., i, :] + b_blk[..., i, :]
            li = lam[..., i, :]
            act = active[..., i]
            ln_new = torch.clamp(
                li[..., 2] - (v[..., 2] + bias[..., i]) * inv_d[..., i, 2],
                min=0.0) * act
            dn = ln_new - li[..., 2]
            vt1 = v[..., 0] + D[..., i, 0, 2] * dn
            vt2 = v[..., 1] + D[..., i, 1, 2] * dn
            lt1 = li[..., 0] - vt1 * inv_d[..., i, 0]
            lt2 = li[..., 1] - vt2 * inv_d[..., i, 1]
            tn = torch.sqrt(lt1 * lt1 + lt2 * lt2 + 1e-12)
            scale = torch.clamp(mu[..., i] * ln_new / tn, max=1.0) * act
            new_i = torch.stack([lt1 * scale, lt2 * scale, ln_new], dim=-1)
            delta = new_i - li
            # w += A[:, 3i:3i+3] delta == delta A_blk[i] (A symmetric)
            w = w + torch.matmul(delta[..., None, :],
                                 A_blk[..., i, :, :]).reshape(*batch, nc, 3)
            lam[..., i, :] = new_i
    return lam * active[..., None]
