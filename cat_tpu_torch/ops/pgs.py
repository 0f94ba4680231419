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

Both kernels solve in the space of the dofs, one warp per env, and share
``csrc/pgs_vspace.cuh``: they never form the Delassus operator A = E W
that the plain versions (and the TPU kernels) assemble, and they skip the
contacts that are not active; only the summation order differs.

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
MAX_DOFS = 32            # a lane of the warp owns each dof
WARPS_A_BLOCK = (1, 2, 4)


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
    1..MAX_CONTACTS contacts and 1..MAX_DOFS dofs. Returns (N, nc, nv)."""
    n, n3, nv = E.shape
    nc = n3 // 3
    shapes = {"E": (E, (n, n3, nv)), "W": (W, (n, nv, n3)),
              "b": (b, (n, n3)), "bias": (bias, (n, nc)),
              "active": (active, (n, nc)), "mu": (mu, (n,)),
              "lam0": (lam0, (n, n3))}
    if n3 % 3 or not 0 < nc <= MAX_CONTACTS:
        raise ValueError(f"3nc={n3} rows: need 1..{MAX_CONTACTS} contacts")
    if not 0 < nv <= MAX_DOFS:
        raise ValueError(f"nv={nv} dofs: need 1..{MAX_DOFS} (a lane of the "
                         "warp owns each dof)")
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


class _VspaceKernel:
    """ctypes binding of one kernel built on ``csrc/pgs_vspace.cuh``,
    ``csrc/<prefix>.cu``.

    ``launches`` counts the kernel launches this wrapper made; nothing
    else changes it. The library is built at the first launch (or by
    ``load``). Once a device, the kernel is allowed all the shared memory
    a block may opt into; once a shape, the occupancy calculator picks the
    warps a block (those that fit the most warps on an SM) and the
    persistent grid.
    """

    prefix = ""
    source: Path
    launch_argtypes: list = []

    def __init__(self):
        self.launches = 0
        self.built: Optional[build.Built] = None
        self._lib = None
        self._sms = {}        # device index -> SM count
        self._configs = {}    # (device, nc, nv) -> (blocks an SM, warps)

    def _fn(self, name):
        return getattr(self._lib, f"{self.prefix}_{name}")

    def load(self) -> build.Built:
        if self._lib is None:
            self.built = build.build_shared_library(self.source)
            self._lib = ctypes.CDLL(str(self.built.path))
            i, pi = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
            for name, args, res in (
                    ("launch", self.launch_argtypes, i),
                    ("warp_bytes", [i, i], ctypes.c_size_t),
                    ("error_string", [i], ctypes.c_char_p),
                    ("setup", [i, pi], i),
                    ("occupancy", [i, i, ctypes.c_size_t, pi], i)):
                self._fn(name).argtypes = args
                self._fn(name).restype = res
        return self.built

    def _raise_on(self, err: int, what: str):
        if err != 0:
            raise RuntimeError(f"{self.prefix} {what} failed: "
                               + self._fn("error_string")(err).decode())

    def _config(self, device: int, nc: int, nv: int, n: int):
        """(grid, warps a block) of a launch over n envs."""
        key = (device, nc, nv)
        if key not in self._configs:
            if device not in self._sms:
                sms = ctypes.c_int()
                self._raise_on(self._fn("setup")(device, ctypes.byref(sms)),
                               "setup")
                self._sms[device] = sms.value
            per_warp = self._fn("warp_bytes")(nc, nv)
            best = (0, 0)
            for warps in WARPS_A_BLOCK:
                blocks = ctypes.c_int()
                self._raise_on(self._fn("occupancy")(
                    device, warps, warps * per_warp, ctypes.byref(blocks)),
                    "occupancy")
                if blocks.value and blocks.value * warps >= best[0] * best[1]:
                    best = (blocks.value, warps)
            if not best[0]:
                raise ValueError(f"nc={nc}, nv={nv} needs {per_warp} B of "
                                 "shared memory a warp: more than an SM has")
            self._configs[key] = best
        blocks, warps = self._configs[key]
        return min(-(-n // warps), blocks * self._sms[device]), warps

    def _launch(self, E, W, n, nc, nv, args):
        """Launch over the operand pointers and scalars ``args`` on E's
        device and current stream; count it."""
        self.load()
        device, stream = _device_and_stream(E)
        grid, warps = self._config(device, nc, nv, n)
        bulk = int(E.data_ptr() % 16 == 0 and W.data_ptr() % 16 == 0
                   and 12 * nc * nv % 16 == 0)
        launch = self._fn("launch")
        if device == torch.cuda.current_device():
            err = launch(*args, grid, warps, bulk, stream)
        else:
            with torch.cuda.device(device):
                err = launch(*args, grid, warps, bulk, stream)
        self._raise_on(err, "kernel launch")
        self.launches += 1


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class PgsBjKernel(_VspaceKernel):
    """``csrc/pgs_bj.cu``: block-Jacobi sweeps over the contact blocks of a
    plan; the plan (contact permutation, blocks) is cached on the device."""

    prefix = "pgs_bj"
    source = SOURCE
    # E W b bias active mu lam0 cperm blocks out, n nc nv nblocks iterations,
    # cfm omega, grid warps bulk, stream
    launch_argtypes = [_P] * 10 + [_I] * 5 + [_F, _F] + [_I] * 3 + [_P]

    def __init__(self):
        super().__init__()
        self._plans = {}

    def _plan(self, device, nc: int, contact_perm, blocks):
        """The plan as int32 device tensors (cperm (nc,), blocks flattened),
        checked once and cached by the identity of the plan's objects (the
        engine passes the same ones every substep)."""
        key = (str(device), nc, id(contact_perm), id(blocks))
        hit = self._plans.get(key)
        if hit is not None and hit[0] is contact_perm and hit[1] is blocks:
            return hit[2]
        if sorted(contact_perm) != list(range(nc)):
            raise ValueError("contact_perm is not a permutation of the contacts")
        if (sum(g for _, g in blocks) != nc
                or any(i0 < 0 or g < 1 or i0 + g > nc for i0, g in blocks)):
            raise ValueError("blocks do not cover the contacts")
        plan = (torch.tensor(list(contact_perm), dtype=torch.int32,
                             device=device),
                torch.tensor([list(bk) for bk in blocks], dtype=torch.int32,
                             device=device).reshape(-1))
        self._plans[key] = (contact_perm, blocks, plan)
        return plan

    def __call__(self, E, W, b, bias, active, mu, lam0, *, iterations: int,
                 cfm: float, omega: float, contact_perm, blocks) -> torch.Tensor:
        n, nc, nv = _check_operands(E, W, b, bias, active, mu, lam0)
        cperm, blk = self._plan(E.device, nc, contact_perm, blocks)
        out = torch.empty_like(lam0)
        self._launch(E, W, n, nc, nv, (
            E.data_ptr(), W.data_ptr(), b.data_ptr(), bias.data_ptr(),
            active.data_ptr(), mu.data_ptr(), lam0.data_ptr(),
            cperm.data_ptr(), blk.data_ptr(), out.data_ptr(),
            n, nc, nv, len(blocks), iterations, cfm, omega))
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


class PgsGsKernel(_VspaceKernel):
    """``csrc/pgs_gs.cu``: the serial Gauss-Seidel sweep; the rows' dof
    masks are cached on the device."""

    prefix = "pgs_gs"
    source = GS_SOURCE
    # E W b bias active mu lam0 masks out, n nc nv iterations, cfm,
    # grid warps bulk, stream
    launch_argtypes = [_P] * 9 + [_I] * 4 + [_F] + [_I] * 3 + [_P]

    def __init__(self):
        super().__init__()
        self._masks = {}

    def _row_masks(self, device, n3: int, nv: int, row_dofs):
        """(3nc,) int32: bit k of row r is set when dof k enters row r of
        E (the kernel leaves the others out of its sums); None when
        row_dofs is None (every dof). Checked once and cached by the
        identity of row_dofs (the engine passes the same tuple every
        substep)."""
        if row_dofs is None:
            return None
        key = (str(device), n3, nv, id(row_dofs))
        hit = self._masks.get(key)
        if hit is not None and hit[0] is row_dofs:
            return hit[1]
        rows = tuple(tuple(int(k) for k in r) for r in row_dofs)
        if len(rows) != n3 or any(not r or min(r) < 0 or max(r) >= nv
                                  for r in rows):
            raise ValueError(f"row_dofs must give 1..{nv} dofs in [0, {nv}) "
                             f"for each of the {n3} rows")
        bits = np.array([sum(1 << k for k in set(r)) for r in rows],
                        dtype=np.uint32)
        masks = torch.as_tensor(bits.view(np.int32), device=device)
        self._masks[key] = (row_dofs, masks)
        return masks

    def __call__(self, E, W, b, bias, active, mu, lam0, *, iterations: int,
                 cfm: float, row_dofs=None) -> torch.Tensor:
        n, nc, nv = _check_operands(E, W, b, bias, active, mu, lam0)
        masks = self._row_masks(E.device, 3 * nc, nv, row_dofs)
        out = torch.empty_like(lam0)
        self._launch(E, W, n, nc, nv, (
            E.data_ptr(), W.data_ptr(), b.data_ptr(), bias.data_ptr(),
            active.data_ptr(), mu.data_ptr(), lam0.data_ptr(),
            None if masks is None else masks.data_ptr(), out.data_ptr(),
            n, nc, nv, iterations, cfm))
        return out


GS_KERNEL = PgsGsKernel()


def pgs_gs(E, W, b, bias, active, mu, lam0, **kw) -> torch.Tensor:
    """The serial Gauss-Seidel contact solve on the operands' device: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if E.device.type == "cpu":
        return pgs_gs_reference(E, W, b, bias, active, mu, lam0, **kw)
    return GS_KERNEL(E, W, b, bias, active, mu, lam0, **kw)
