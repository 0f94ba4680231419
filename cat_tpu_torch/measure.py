"""Measuring on the card: kernel times, the contact solve's bound, a
kernel held against its plain version, and the card's name and power limit.

Shared by ``cat_tpu_torch.bench`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import subprocess

import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s off the
# tensor cores (TF32 is off on the port's path: ``resolve_device``)
PEAK_BYTES_S, PEAK_F32_FLOP_S = 3.35e12, 67e12
# kernel vs plain version: |k - p| <= ATOL_REL * max|p| + RTOL * |p|, the
# JAX package's own kernel-vs-reference tolerance (test_pgs_pallas.py);
# the two sum in different orders (fused multiply-adds, the plain version's
# batched contractions), nothing else differs
RTOL, ATOL_REL = 2e-4, 2e-5


def cuda_ms(fn, reps: int) -> float:
    """The card's time of one call of ``fn`` over ``reps`` eager calls one
    after another (CUDA events; the host's cost of a call shows where it
    exceeds the card's)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int) -> float:
    """The card's time for one call of ``fn``: ``reps`` calls captured in
    one CUDA graph and replayed, so the host's cost of a call (the
    wrapper's Python, the launch) is left out of the time. A kernel
    wrapper counts its launches at the capture, not at the replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def pgs_counts(active, nv, iterations, table_words):
    """Bytes and f32 operations the solve needs for these inputs (its
    (N, nc) ``active``), as the kernels compute it, in the space of the
    dofs: E's rows and W's columns of the active contacts read once, the
    other operands whole (b, bias, active, mu, lam0 read, the result
    written, ``table_words`` of plan or dof table); per active contact the
    five entries of A (5 dot products of nv terms), three divisions, its
    part of the warm start (3 nv multiply-adds) and, in each sweep, three
    rows of w (3 x 2nv), the projection (~32) and three rows of the update
    (3 x 2nv). An inactive contact needs none of it."""
    n, nc = active.shape
    n_act = float((active != 0).sum())
    byts = (4 * n_act * 2 * 3 * nv
            + 4 * n * (3 * 3 * nc + 2 * nc + 1) + 4 * table_words)
    flops = n_act * (5 * 2 * nv + 3 + 3 * 2 * nv
                     + iterations * (3 * 2 * nv + 32 + 3 * 2 * nv))
    return byts, flops


def bound(byts, flops):
    """(bound_ms, bound_by): the larger of the bytes over the card's memory
    rate and the f32 operations over its peak rate."""
    t_bytes = byts / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def disagreement(out, plain):
    """(max abs error, max|plain|, entries outside the tolerance) of a
    kernel's ``out`` against its plain version's; a non-finite entry of
    ``out`` counts as outside."""
    err = (out - plain).abs()
    scale = plain.abs().max().item()
    outside = (err > ATOL_REL * scale + RTOL * plain.abs()) | ~torch.isfinite(out)
    return err.max().item(), scale, int(outside.sum())


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)
    if proc.returncode != 0 or not proc.stdout.strip():
        raise RuntimeError(f"nvidia-smi gave no card: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


# The substep stages' tolerances, a kernel of ops/substep.py against its
# plain version and a plain version against the JAX package's lanes
# functions: those the JAX package holds its lanes layout to against its
# vmap layout (tests/test_lanes.py): kinematics, E, phi and the frames
# atol 1e-5 (sums of a few unit-scale products); M^-1 rtol and atol 2e-3
# (M is ill-conditioned: entries of M^-1 reach ~2e3); what M^-1 multiplies
# (v_free, W, b) 2e-3 of the output's largest entry; on a heightfield E
# and the frames atol 2e-5 (HFIELD_ATOL, test_lanes.py's heightfield rows:
# a cell's fraction carries the rounding of the grid coordinate, ~1e-5 at
# 100 cells, and the bilinear gradient moves with it). The summation orders
# differ (fused multiply-adds, the plain version's batched contractions).
# name -> (rtol, atol, atol as a share of max|plain|)
STAGE_TOL = {
    "tau_j": (0.0, 1e-5, 0.0), "R": (0.0, 1e-5, 0.0), "o": (0.0, 1e-5, 0.0),
    "a_w": (0.0, 1e-5, 0.0), "Minv": (2e-3, 2e-3, 0.0),
    "v_free": (0.0, 0.0, 2e-3), "E": (0.0, 1e-5, 0.0), "W": (0.0, 0.0, 2e-3),
    "b": (0.0, 0.0, 2e-3), "phi": (0.0, 1e-5, 0.0),
    "frame": (0.0, 1e-5, 0.0)}
HFIELD_ATOL = 2e-5


def _contact_axis(name, keep, shape):
    """``keep`` (N, nc) broadcast over the entries of output ``name``."""
    if name in ("phi", "frame"):
        return keep.reshape(keep.shape + (1,) * (len(shape) - 2)).expand(shape)
    rows = keep.repeat_interleave(3, dim=1)          # E, W, b: a row a 3
    return (rows[:, None, :] if name == "W" else
            rows.reshape(rows.shape + (1,) * (len(shape) - 2))).expand(shape)


def stage_disagreement(name, out, plain, keep=None, hfield=False):
    """(max abs error, that over max|plain|, entries outside STAGE_TOL[name])
    of a substep stage's output against its plain version's; ``keep`` (N,
    nc) bool, for a contact output: the contacts compared; ``hfield``: the
    rows of a heightfield (E and the frames at HFIELD_ATOL). A non-finite
    entry of ``out`` counts as outside."""
    rtol, atol, atol_rel = STAGE_TOL[name]
    if hfield and name in ("E", "frame"):
        atol = HFIELD_ATOL
    out, plain = out.float(), plain.float()
    if keep is not None:
        mask = _contact_axis(name, keep, out.shape)
        out, plain = out[mask], plain[mask]
    if plain.numel() == 0:
        return 0.0, 0.0, 0
    err = (out - plain).abs()
    scale = plain.abs().max().item()
    outside = ((err > atol + atol_rel * scale + rtol * plain.abs())
               | ~torch.isfinite(out))
    return err.max().item(), err.max().item() / max(scale, 1e-30), int(
        outside.sum())


# ambiguous_contacts: a probe this near a grid line (in cells: some five
# roundings of a grid coordinate of 100 cells), a gap this near the deepest
# (m: some five roundings of a candidate's centre 40 m off the origin)
SEAM_CELLS, GAP_M = 2e-4, 1e-5


def ambiguous_contacts(mt, terrain, kin):
    """(N, nc) bool: the heightfield candidates whose contact normal a
    rounding of the candidate's centre can switch, so that the substep's
    outputs of two summation orders need not agree there: of the probes of
    ``terrain.surface_gap`` within GAP_M of the deepest, one lies within
    SEAM_CELLS of a grid line across which the bilinear gradient jumps,
    or two have different normals (the winner may be either). All False
    on the plane and for the pairs."""
    from cat_tpu_torch.sim import terrain as terrain_mod

    m = mt.model
    n = kin.o.shape[0]
    out = torch.zeros(n, m.ncand, dtype=torch.bool, device=kin.o.device)
    if terrain.kind == "plane":
        return out
    body = mt.cand_body
    x = kin.o[:, body] + torch.matmul(kin.R[:, body],
                                      mt.cand_offset[..., None])[..., 0]
    offs = torch.tensor([[0.0, 0.0], [1.0, 0.0], [-1.0, 0.0], [0.0, 1.0],
                         [0.0, -1.0]], device=x.device)
    xy = x[..., None, :2] + offs * mt.cand_radius[:, None, None]
    h, gx, gy = terrain_mod.height_grad_at(terrain, xy)
    inv = torch.rsqrt(1.0 + gx * gx + gy * gy)
    nrm = torch.stack([-gx * inv, -gy * inv, inv], dim=-1)   # (N, nct, 5, 3)
    d = ((gx * (xy[..., 0] - x[..., None, 0])
          + gy * (xy[..., 1] - x[..., None, 1])) * inv
         + inv * (x[..., None, 2] - h))                     # (N, nct, 5)
    near = d - d.min(dim=-1, keepdim=True).values < GAP_M
    seam = torch.zeros_like(near)
    for axis, size in enumerate(terrain.height.shape):
        u = xy[..., axis] / terrain.cell + size / 2.0 - 0.5
        shift = torch.zeros(2, device=x.device)
        shift[axis] = SEAM_CELLS * terrain.cell
        g = [torch.stack(terrain_mod.height_grad_at(terrain, xy + sg * shift)
                         [1:], dim=-1) for sg in (-1.0, 1.0)]
        seam |= (((u - torch.round(u)).abs() < SEAM_CELLS)
                 & ((g[1] - g[0]).abs().amax(dim=-1) > 1e-6))
    n_win = torch.gather(nrm, -2, torch.argmin(d, dim=-1)[..., None, None]
                         .expand(d.shape[:-1] + (1, 3)))
    differ = (nrm - n_win).abs().amax(dim=-1) > 1e-6
    out[:, :m.ncand_terrain] = (near & (seam | differ)).any(dim=-1)
    return out


def substep_counts(model, n, hfield=False):
    """{kernel: (bytes, f32 operations)} the substep's two kernels need for
    n envs of ``model``: each input read once and each output written once
    (the model's tables and, on a heightfield, one 16-byte corner record a
    probe); the operations as ``csrc/substep_dyn.cu`` and
    ``csrc/contact_rows.cu`` do them: M and C by the composite sums over
    each body's subtree, M entries only for dofs on one chain, the rows of
    E, b and W over each row's nonzero dofs (a body's or a contact's
    ancestor joints and the base's six)."""
    nb, nv, nj, nq = model.nbody, model.nv, model.nj, model.nq
    nct, npair, nc = model.ncand_terrain, model.npair, model.ncand
    anc = model.ancestor_mask()
    live = [6 + int(anc[b].sum()) for b in range(nb)]   # nonzero columns
    tables = 4 * (3 + 28 * nb + nv + nj + 4 * nct + 13 * npair
                  + 3 * nb + nct + 2 * npair)
    dyn_bytes = (4 * n * (nq + nv + nj + nj + nv + nv * nv + 12 * nb + 3 * nj)
                 + tables)
    # per env: the tree and the bodies' forces (a body ~450: frames, joint
    # axis, Rodrigues, the bias recursion, x_com, I_w, force, torque) and
    # their parts of the sums about o0 (~45); the subtree sums (16 adds a
    # body and member); a dof's motion, momentum and C (~65); an entry of
    # M on one chain (11); M^-1; v_free (2 nv^2)
    members = nb + int(anc.sum())           # the base's subtree is all
    related = sum(1 for k in range(nv) for l in range(nv)
                  if min(k, l) < 6 or anc[max(k, l) - 5, min(k, l) - 6])
    if model.uniform_3dof_branches():
        # leg inverses, W = X D^-1, S, its Cholesky factor, H, H^T H
        inv = (45 * (nj // 3) + 30 * nj + 21 * (2 * nj + 1) + 80
               + 36 * nv + 11 * nv * nv)
    else:
        inv = nv ** 3 // 3 + 2 * nv ** 3
    dyn_flops = n * (495 * nb + 16 * members + 65 * nv + 11 * related
                     + inv + 2 * nv * nv)
    row_dofs = []
    for c in range(nct):
        row_dofs += [live[int(model.cand_body[c])]] * 3
    for p in range(npair):
        both = anc[int(model.pair_body_a[p])] | anc[int(model.pair_body_b[p])]
        row_dofs += [6 + int(both.sum())] * 3
    con_bytes = 4 * n * (12 * nb + 3 * nj + nv * nv + nv
                         + 2 * 3 * nc * nv + 3 * nc + nc
                         + (9 * nc if hfield or npair else 0)) + tables
    if hfield:
        con_bytes += n * nct * 5 * 16
    # per env: a candidate's centre 18, on a heightfield 5 probes ~60 and
    # the frame ~30; a pair ~200; a row's nonzero entry of E ~20 (a pair's
    # two points ~40), of b 2, of W's column 2 nv
    geo = nct * (18 + (330 if hfield else 0)) + 200 * npair
    rows = sum(k * (22 + 2 * nv) for k in row_dofs[:3 * nct]) + sum(
        k * (42 + 2 * nv) for k in row_dofs[3 * nct:])
    return {"substep_dynamics": (dyn_bytes, dyn_flops),
            "contact_rows": (con_bytes, n * (geo + rows))}
