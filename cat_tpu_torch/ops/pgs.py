"""PGS contact solves: the CUDA kernels, their wrappers, and their plain
PyTorch versions.

Two kernels, one per sweep structure of ``SolverParams``:
  * ``pgs_bj`` (``csrc/pgs_bj.cu``) replaces the TPU kernel
    ``_pgs_kernel_bj`` (cat_tpu/ops/pgs_pallas.py:419, launched by
    ``pgs_solve_lanes_bj``): block-Jacobi sweeps over contact blocks;
  * ``pgs_gs`` (``csrc/pgs_gs.cu``) replaces the TPU kernel ``_pgs_kernel``
    (cat_tpu/ops/pgs_pallas.py:103, launched by ``pgs_solve_lanes``): the
    serial Gauss-Seidel sweep over contacts, omega 1.

Layout: envs LEADING and contiguous, E (N, 3nc, nv), W = M^-1 E^T
(N, nv, 3nc), b / lam0 / result (N, 3nc) interleaved (t1, t2, n) per
contact, bias / active (N, nc), mu (N,).

``pgs_bj`` and ``pgs_gs`` dispatch on the tensors' device: on a CUDA tensor
they launch the kernel (built by plain nvcc and bound with ctypes) or
raise; on a CPU tensor they run the plain version. There is no fallback
from the card to the plain version.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import build

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "pgs_bj.cu"
GS_SOURCE = CSRC / "pgs_gs.cu"
MAX_CONTACTS = 64
MAX_SMEM_BYTES = 232448  # opt-in shared memory of one block on Hopper


def contact_row_dofs(model, anc_mask) -> tuple:
    """Per-row nonzero dof sets of E (port of pgs_pallas.contact_row_dofs):
    terrain rows touch the base and the owning body's ancestor joints, pair
    rows the base and the union of both bodies' ancestor joints."""
    m = np.asarray(anc_mask) != 0
    rows = []

    def ks_for(mask_row):
        return tuple(range(6)) + tuple(
            6 + j for j in range(mask_row.shape[0]) if mask_row[j])

    for c in range(model.ncand_terrain):
        rows += [ks_for(m[model.cand_body[c]])] * 3
    for p in range(model.npair):
        rows += [ks_for(m[model.pair_body_a[p]] | m[model.pair_body_b[p]])] * 3
    return tuple(rows)


def plan_contact_blocks(model, n_blocks: int):
    """Partition contacts into n_blocks equal blocks, spreading contacts that
    share a rigid body over different blocks (port of
    pgs_pallas.plan_contact_blocks). Returns (contact_perm, blocks):
    block k is the permuted range [k*g, (k+1)*g), blocks = ((0, g), ...)."""
    bodies = [
        {int(model.cand_body[c])} for c in range(model.ncand_terrain)
    ] + [
        {int(model.pair_body_a[p]), int(model.pair_body_b[p])}
        for p in range(model.npair)
    ]
    nc = len(bodies)
    if nc % n_blocks:
        raise ValueError(f"{nc} contacts do not split into {n_blocks} blocks")
    g = nc // n_blocks
    blocks: list = [[] for _ in range(n_blocks)]
    for c in sorted(range(nc), key=lambda c: -len(bodies[c])):
        open_blocks = [b for b in range(n_blocks) if len(blocks[b]) < g]
        best = min(open_blocks, key=lambda b: (
            sum(1 for o in blocks[b] if bodies[o] & bodies[c]),
            len(blocks[b]),
        ))
        blocks[best].append(c)
    perm = tuple(c for blk in blocks for c in blk)
    return perm, tuple((k * g, g) for k in range(n_blocks))


def pgs_bj_reference(
    E, W, b, bias, active, mu, lam0, *, iterations: int, cfm: float,
    omega: float, contact_perm: Sequence[int], blocks: Sequence[Tuple[int, int]],
) -> torch.Tensor:
    """Plain PyTorch version of the kernel. Mirrors pgs_lanes_xla_bj and
    _bj_sweeps (pgs_pallas.py:551, :300): the same dense assembly, the same
    static contact permutation, the same block loop."""
    n, n3, nv = E.shape
    nc = n3 // 3
    A = torch.zeros(n, n3, n3, dtype=E.dtype, device=E.device)
    for k in range(nv):
        A = A + E[:, :, k, None] * W[:, None, k, :]
    ids = torch.as_tensor(list(contact_perm), device=E.device)
    r1, r2, rn = 3 * ids, 3 * ids + 1, 3 * ids + 2
    lam = lam0 * active.repeat_interleave(3, dim=1)
    w = torch.einsum("nri,nr->ni", A, lam)
    diag = torch.diagonal(A, dim1=1, dim2=2)
    inv_dt1 = 1.0 / (diag[:, r1] + cfm)
    inv_dt2 = 1.0 / (diag[:, r2] + cfm)
    inv_dn = 1.0 / (diag[:, rn] + cfm)
    c_t1n, c_t2n = A[:, r1, rn], A[:, r2, rn]
    act_p, bias_p = active[:, ids], bias[:, ids]
    b_t1, b_t2, b_n = b[:, r1], b[:, r2], b[:, rn]
    lt1, lt2, ln = lam[:, r1].clone(), lam[:, r2].clone(), lam[:, rn].clone()
    mu = mu[:, None]
    for _ in range(iterations):
        for i0, g in blocks:
            sl = slice(i0, i0 + g)
            ln_b, lt1_b, lt2_b = ln[:, sl], lt1[:, sl], lt2[:, sl]
            act = act_p[:, sl]
            vn = w[:, rn[sl]] + b_n[:, sl] + bias_p[:, sl]
            ln_new = torch.clamp(ln_b - omega * vn * inv_dn[:, sl], min=0.0) * act
            dn = ln_new - ln_b
            vt1 = w[:, r1[sl]] + b_t1[:, sl] + c_t1n[:, sl] * dn
            vt2 = w[:, r2[sl]] + b_t2[:, sl] + c_t2n[:, sl] * dn
            lt1_c = lt1_b - omega * vt1 * inv_dt1[:, sl]
            lt2_c = lt2_b - omega * vt2 * inv_dt2[:, sl]
            tn = torch.sqrt(lt1_c * lt1_c + lt2_c * lt2_c + 1e-12)
            scale = torch.clamp(mu * ln_new / tn, max=1.0) * act
            n1, n2 = lt1_c * scale, lt2_c * scale
            # w += A[:, block cols] dlam (A symmetric: rows serve as columns)
            for rows, d in ((r1[sl], n1 - lt1_b), (r2[sl], n2 - lt2_b),
                            (rn[sl], dn)):
                w = w + torch.einsum("ngi,ng->ni", A[:, rows], d)
            lt1[:, sl], lt2[:, sl], ln[:, sl] = n1, n2, ln_new
    out = torch.empty_like(lam)
    out[:, r1], out[:, r2], out[:, rn] = lt1, lt2, ln
    return out


def _check_operands(E, W, b, bias, active, mu, lam0) -> Tuple[int, int, int]:
    """The checks both kernels make before a launch: CUDA float32
    contiguous operands on E's device, of the shapes E implies, with
    1..MAX_CONTACTS contacts. Returns (N, nc, nv)."""
    n, n3, nv = E.shape
    nc = n3 // 3
    shapes = {"E": (E, (n, n3, nv)), "W": (W, (n, nv, n3)),
              "b": (b, (n, n3)), "bias": (bias, (n, nc)),
              "active": (active, (n, nc)), "mu": (mu, (n,)),
              "lam0": (lam0, (n, n3))}
    if n3 % 3 or not 0 < nc <= MAX_CONTACTS:
        raise ValueError(f"3nc={n3} rows: need 1..{MAX_CONTACTS} contacts")
    for name, (t, shape) in shapes.items():
        if t.device != E.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, E on {E.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}, not float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return n, nc, nv


def _device_and_stream(t: torch.Tensor):
    index = t.device.index
    if index is None:
        index = torch.cuda.current_device()
    return index, torch.cuda.current_stream(t.device).cuda_stream


class PgsBjKernel:
    """ctypes binding of ``csrc/pgs_bj.cu``.

    ``launches`` counts the kernel launches this wrapper made; nothing
    else changes it. The library is built at the first launch (or by
    ``load``), and the contact plan is cached on the device per plan.
    """

    def __init__(self):
        self.launches = 0
        self.built: Optional[build.Built] = None
        self._lib = None
        self._plans = {}

    def load(self) -> build.Built:
        if self._lib is None:
            self.built = build.build_shared_library(SOURCE)
            lib = ctypes.CDLL(str(self.built.path))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.pgs_bj_launch.argtypes = (
                [p] * 10 + [i] * 5 + [ctypes.c_float, ctypes.c_float, i, p])
            lib.pgs_bj_launch.restype = i
            lib.pgs_bj_smem_bytes.argtypes = [i, i]
            lib.pgs_bj_smem_bytes.restype = ctypes.c_size_t
            lib.pgs_bj_error_string.argtypes = [i]
            lib.pgs_bj_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self.built

    def _plan(self, device, contact_perm, blocks):
        key = (str(device), tuple(contact_perm), tuple(blocks))
        if key not in self._plans:
            self._plans[key] = (
                torch.tensor(list(contact_perm), dtype=torch.int32,
                             device=device),
                torch.tensor([list(bk) for bk in blocks], dtype=torch.int32,
                             device=device).reshape(-1),
            )
        return self._plans[key]

    def __call__(self, E, W, b, bias, active, mu, lam0, *, iterations: int,
                 cfm: float, omega: float, contact_perm, blocks) -> torch.Tensor:
        n, nc, nv = _check_operands(E, W, b, bias, active, mu, lam0)
        if sorted(contact_perm) != list(range(nc)):
            raise ValueError("contact_perm is not a permutation of the contacts")
        if sum(g for _, g in blocks) != nc:
            raise ValueError("blocks do not cover the contacts")
        self.load()
        smem = self._lib.pgs_bj_smem_bytes(nc, nv)
        if smem > MAX_SMEM_BYTES:
            raise ValueError(f"nc={nc}, nv={nv} needs {smem} B of shared memory")
        cperm, blk = self._plan(E.device, contact_perm, blocks)
        out = torch.empty_like(lam0)
        err = self._lib.pgs_bj_launch(
            E.data_ptr(), W.data_ptr(), b.data_ptr(), bias.data_ptr(),
            active.data_ptr(), mu.data_ptr(), lam0.data_ptr(),
            cperm.data_ptr(), blk.data_ptr(), out.data_ptr(),
            n, nc, nv, len(blocks), iterations, cfm, omega,
            *_device_and_stream(E),
        )
        if err != 0:
            raise RuntimeError("pgs_bj kernel launch failed: "
                               + self._lib.pgs_bj_error_string(err).decode())
        self.launches += 1
        return out


KERNEL = PgsBjKernel()


def pgs_bj(E, W, b, bias, active, mu, lam0, **kw) -> torch.Tensor:
    """The contact solve on the operands' device: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if E.device.type == "cpu":
        return pgs_bj_reference(E, W, b, bias, active, mu, lam0, **kw)
    return KERNEL(E, W, b, bias, active, mu, lam0, **kw)


def pgs_gs_reference(
    E, W, b, bias, active, mu, lam0, *, iterations: int, cfm: float,
    row_dofs: Optional[Sequence[Sequence[int]]] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the serial Gauss-Seidel kernel. Mirrors
    _pgs_lanes_xla (cat_tpu/sim/engine_lanes.py:79) and _pgs_kernel
    (pgs_pallas.py:103) in operation order: dense A, the warm start summed
    row by row, then one contact at a time. ``row_dofs`` (the nonzero dofs
    of each row of E) only tells the kernel which terms of the assembly
    it may skip; the plain version sums all of them, which adds exact
    zeros and gives the same A."""
    n, n3, nv = E.shape
    A = torch.zeros(n, n3, n3, dtype=E.dtype, device=E.device)
    for k in range(nv):
        A = A + E[:, :, k, None] * W[:, None, k, :]
    lam = lam0 * active.repeat_interleave(3, dim=1)
    w = torch.zeros_like(b)
    for r in range(n3):
        w = w + A[:, r] * lam[:, r, None]
    inv_d = 1.0 / (torch.diagonal(A, dim1=1, dim2=2) + cfm)
    # a contact inactive in every env keeps lam = 0 and moves w by exact
    # zeros: the sweep leaves it out, as the kernel does per env
    live = [i for i, a in enumerate(active.any(dim=0).tolist()) if a]
    for _ in range(iterations):
        for i in live:
            k = 3 * i
            act = active[:, i]
            v = w[:, k:k + 3] + b[:, k:k + 3]
            l0, l1, l2 = lam[:, k], lam[:, k + 1], lam[:, k + 2]
            ln_new = torch.clamp(l2 - (v[:, 2] + bias[:, i]) * inv_d[:, k + 2],
                                 min=0.0) * act
            dn = ln_new - l2
            vt1 = v[:, 0] + A[:, k, k + 2] * dn
            vt2 = v[:, 1] + A[:, k + 1, k + 2] * dn
            lt1 = l0 - vt1 * inv_d[:, k]
            lt2 = l1 - vt2 * inv_d[:, k + 1]
            tn = torch.sqrt(lt1 * lt1 + lt2 * lt2 + 1e-12)
            scale = torch.clamp(mu * ln_new / tn, max=1.0) * act
            n0, n1 = lt1 * scale, lt2 * scale
            # w += A[:, k:k+3] dlam (A symmetric: rows serve as columns)
            w = (w + A[:, k] * (n0 - l0)[:, None]
                 + A[:, k + 1] * (n1 - l1)[:, None]
                 + A[:, k + 2] * dn[:, None])
            lam[:, k], lam[:, k + 1], lam[:, k + 2] = n0, n1, ln_new
    return lam


class PgsGsKernel:
    """ctypes binding of ``csrc/pgs_gs.cu``.

    ``launches`` counts the kernel launches this wrapper made; nothing
    else changes it. The library is built at the first launch (or by
    ``load``); the table of nonzero dofs per row is cached on the device.
    """

    def __init__(self):
        self.launches = 0
        self.built: Optional[build.Built] = None
        self._lib = None
        self._dofs = {}

    def load(self) -> build.Built:
        if self._lib is None:
            self.built = build.build_shared_library(GS_SOURCE)
            lib = ctypes.CDLL(str(self.built.path))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.pgs_gs_launch.argtypes = (
                [p] * 10 + [i] * 4 + [ctypes.c_float, i, p])
            lib.pgs_gs_launch.restype = i
            lib.pgs_gs_smem_bytes.argtypes = [i, i]
            lib.pgs_gs_smem_bytes.restype = ctypes.c_size_t
            lib.pgs_gs_error_string.argtypes = [i]
            lib.pgs_gs_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self.built

    def _dof_table(self, device, n3: int, nv: int, row_dofs):
        """(dofs (3nc, nv) int32, counts (3nc,) int32): row r of the
        assembly sums over dofs[r, :counts[r]]; every dof when row_dofs is
        None."""
        rows = (tuple(tuple(range(nv)) for _ in range(n3)) if row_dofs is None
                else tuple(tuple(int(k) for k in r) for r in row_dofs))
        if len(rows) != n3 or any(not r or min(r) < 0 or max(r) >= nv
                                  for r in rows):
            raise ValueError(f"row_dofs must give 1..{nv} dofs in [0, {nv}) "
                             f"for each of the {n3} rows")
        key = (str(device), nv, rows)
        if key not in self._dofs:
            table = np.zeros((n3, nv), np.int32)
            for r, ks in enumerate(rows):
                table[r, :len(ks)] = ks
            self._dofs[key] = (
                torch.as_tensor(table, device=device),
                torch.tensor([len(r) for r in rows], dtype=torch.int32,
                             device=device),
            )
        return self._dofs[key]

    def __call__(self, E, W, b, bias, active, mu, lam0, *, iterations: int,
                 cfm: float, row_dofs=None) -> torch.Tensor:
        n, nc, nv = _check_operands(E, W, b, bias, active, mu, lam0)
        self.load()
        smem = self._lib.pgs_gs_smem_bytes(nc, nv)
        if smem > MAX_SMEM_BYTES:
            raise ValueError(f"nc={nc}, nv={nv} needs {smem} B of shared memory")
        dofs, counts = self._dof_table(E.device, 3 * nc, nv, row_dofs)
        out = torch.empty_like(lam0)
        err = self._lib.pgs_gs_launch(
            E.data_ptr(), W.data_ptr(), b.data_ptr(), bias.data_ptr(),
            active.data_ptr(), mu.data_ptr(), lam0.data_ptr(),
            dofs.data_ptr(), counts.data_ptr(), out.data_ptr(),
            n, nc, nv, iterations, cfm, *_device_and_stream(E),
        )
        if err != 0:
            raise RuntimeError("pgs_gs kernel launch failed: "
                               + self._lib.pgs_gs_error_string(err).decode())
        self.launches += 1
        return out


GS_KERNEL = PgsGsKernel()


def pgs_gs(E, W, b, bias, active, mu, lam0, **kw) -> torch.Tensor:
    """The serial Gauss-Seidel contact solve on the operands' device: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if E.device.type == "cpu":
        return pgs_gs_reference(E, W, b, bias, active, mu, lam0, **kw)
    return GS_KERNEL(E, W, b, bias, active, mu, lam0, **kw)
