"""Measuring on the card: kernel times, the contact solve's and the substep
kernels' bounds, a kernel held against its plain version (the substep's two
kernels against the plain stages: ``compare_stages``), and the card's name
and power limit.

Shared by ``cat_tpu_torch.bench`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import functools
import subprocess
from typing import NamedTuple

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
    from cat_tpu_torch.utils.graphs import no_collection

    graph = torch.cuda.CUDAGraph()
    with no_collection(), torch.cuda.graph(graph):
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


def stage_disagreement(name, out, plain, keep=None, hfield=False,
                       hfield_tol=HFIELD_ATOL):
    """(max abs error, that over max|plain|, entries outside STAGE_TOL[name])
    of a substep stage's output against its plain version's; ``keep`` (N,
    nc) bool, for a contact output: the contacts compared; ``hfield``: the
    rows of a heightfield (E and the frames at ``hfield_tol``). A
    non-finite entry of ``out`` counts as outside."""
    rtol, atol, atol_rel = STAGE_TOL[name]
    if hfield and name in ("E", "frame"):
        atol = hfield_tol
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
# ambiguous_contacts: a self-collision pair whose capsule axes are parallel
# to within sin^2 PAIR_SIN2 (but not to the last bit) and which lies more
# than PAIR_CLEAR_M clear of touching. The closest-point solve
# (sim/collision.py detect_pair_contacts; csrc/contact_rows.cu does the
# same) divides by a e - b^2 = a e sin^2, which float32 carries with the
# roundings of a, e and b (sums of three products) and of its two
# products: up to some 14 unit roundoffs (2^-24) of a e, 8.3e-7. Below
# PAIR_SIN2 the denominator may be rounding alone, even of the wrong sign;
# the first s then goes to 0 or 1 by that sign, and the closest points a
# side returns follow its summation order, not the pair
# (tools/pair_probe.py reads them beside float64's). Clear of touching, the
# pair's rows multiply an impulse of 0 (the solve activates a contact at
# phi < solver.SolverParams.margin, 0 in every configuration), and its phi
# moves by at most the angle times a capsule's length (1e-3 x 0.13 m).
# Pairs parallel to the last bit (sin^2 under 1e-12: a side's two legs at
# the symmetric default pose) stay compared
PAIR_SIN2, PAIR_CLEAR_M = 1e-6, 1e-3


def float64_tensors(mt):
    """``mt`` (a ModelTensors) with its floating tables in float64."""
    import dataclasses

    return dataclasses.replace(mt, **{
        f.name: getattr(mt, f.name).double()
        for f in dataclasses.fields(mt)
        if isinstance(getattr(mt, f.name), torch.Tensor)
        and getattr(mt, f.name).is_floating_point()})


def parallel_pairs(mt, kin):
    """(N, npair) bool: the self-collision pairs ``ambiguous_contacts``
    leaves out: axes parallel to within PAIR_SIN2 but not to the last
    float32 bit (sin^2 over 1e-12), more than PAIR_CLEAR_M clear of
    touching (sim/collision.py detect_pair_contacts in float64 on the
    float32 kinematics)."""
    from cat_tpu_torch.sim import collision
    from cat_tpu_torch.sim.dynamics import ContactKin

    def axis(bodies, p0, p1):
        return torch.matmul(kin.R[:, bodies].double(),
                            (p1 - p0).double()[..., None])[..., 0]

    d1 = axis(mt.pair_body_a, mt.pair_p0_a, mt.pair_p1_a)
    d2 = axis(mt.pair_body_b, mt.pair_p0_b, mt.pair_p1_b)
    a, e = (d1 * d1).sum(-1), (d2 * d2).sum(-1)
    b = (d1 * d2).sum(-1)
    sin2 = (a * e - b * b) / (a * e)
    phi = collision.detect_pair_contacts(
        float64_tensors(mt), ContactKin(kin.R.double(), kin.o.double(),
                         kin.a_w.double()))[0]
    return (sin2 > 1e-12) & (sin2 < PAIR_SIN2) & (phi > PAIR_CLEAR_M)


def ambiguous_contacts(mt, terrain, kin):
    """(N, nc) bool: the contacts whose outputs of two summation orders
    need not agree: the heightfield candidates whose contact normal a
    rounding of the candidate's centre can switch (of the probes of
    ``terrain.surface_gap`` within GAP_M of the deepest, one lies within
    SEAM_CELLS of a grid line across which the bilinear gradient jumps,
    or two have different normals: the winner may be either; none on the
    plane), and the self-collision pairs clear of touching whose axes are
    parallel to within PAIR_SIN2 (``parallel_pairs``: float32 does not
    resolve their closest points)."""
    from cat_tpu_torch.sim import terrain as terrain_mod

    m = mt.model
    n = kin.o.shape[0]
    out = torch.zeros(n, m.ncand, dtype=torch.bool, device=kin.o.device)
    if m.npair:
        out[:, m.ncand_terrain:] = parallel_pairs(mt, kin)
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


# compare_stages: the share of contacts ambiguous_contacts may leave out
# before a comparison fails (~2% of random rough states, none on the pads)
AMBIGUOUS_MAX_SHARE = 0.02


class StageComparison(NamedTuple):
    """What ``compare_stages`` found: the max abs error over the outputs,
    the outputs with entries outside STAGE_TOL (name -> how many, or "given
    by one side"), the contacts left out and all contacts, and a line that
    says so."""
    worst: float
    outside: dict
    left_out: int
    contacts: int
    text: str

    @property
    def ok(self) -> bool:
        return (not self.outside
                and self.left_out <= AMBIGUOUS_MAX_SHARE * self.contacts)


def compare_stages(mt, terrain, kern, kern_c, plain, plain_c, kin,
                   hfield_tol=HFIELD_ATOL):
    """Each output of the substep's two kernels against the plain stages'
    within STAGE_TOL: ``kern`` / ``plain`` the (tau_j, v_free, Minv, kin)
    of ``ops/substep.py`` ``substep_dynamics`` / ``sim/engine.py``
    ``dynamics_stage``, ``kern_c`` / ``plain_c`` the (E, W, b, phi, frame)
    of ``contact_rows`` / ``contact_stage``; ``kin`` the kinematics that
    place the contacts. On a heightfield E and the frames are held at
    ``hfield_tol``; the contacts whose outputs one rounding may switch
    (``ambiguous_contacts``: a heightfield normal, the closest points of a
    nearly parallel pair clear of touching) are left out; the
    comparison fails (``ok`` false) on an entry outside the tolerance or
    when more than AMBIGUOUS_MAX_SHARE of the contacts are left out."""
    from cat_tpu_torch.ops.substep import CONTACT_OUTPUTS, DYN_OUTPUTS

    left_out = ambiguous_contacts(mt, terrain, kin)
    hfield = terrain.kind == "hfield"
    outs = zip(DYN_OUTPUTS + CONTACT_OUTPUTS,
               (*kern[:3], *kern[3], *kern_c),
               (*plain[:3], *plain[3], *plain_c))
    errs, bad, worst = [], {}, 0.0
    for name, a, b in outs:
        if a is None or b is None:
            if (a is None) != (b is None):
                bad[name] = "given by one side"
            continue
        keep = ~left_out if name in CONTACT_OUTPUTS else None
        err, rel, outside = stage_disagreement(name, a, b, keep, hfield,
                                               hfield_tol)
        errs.append(f"{name} {err:.3g}/{rel:.3g}")
        worst = max(worst, err)
        if outside:
            bad[name] = outside
    n_left = int(left_out.sum())
    return StageComparison(
        worst, bad, n_left, left_out.numel(),
        f"max abs/rel err {', '.join(errs)}; {n_left} of "
        f"{left_out.numel()} contacts left out (normal switchable by a "
        f"rounding, or a pair clear of touching with axes nearly "
        f"parallel; at most "
        f"{AMBIGUOUS_MAX_SHARE:g} of them); outside "
        f"tolerance{f' (E, frame at {hfield_tol:g})' if hfield else ''} "
        f"{bad or 'none'}")


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


# The post stage (``ops/substep.py`` ``substep_post`` against
# ``sim/engine.py`` ``post_stage``, and ``post_stage`` against the JAX
# package's): v = v_free + W lam sums up to 3 x 64 products, which two
# summation orders round differently, by a few float32 unit roundoffs
# (2^-24) of the sum of their magnitudes (|v_free| + sum |W lam|, up to
# ~160 m/s on tests/_substep_cases.py's drops, where the plain float32
# version alone is 1.7e-5 off a float64 one): qvel within atol 1e-5 plus
# POST_SUM_UNITS of them, joint_acc = dv / h within that over h plus 1e-5
# of its largest entry; qpos (q + h v, the quaternion's exponential map)
# atol 1e-5; forces and their history 1e-5 of the largest entry (the
# frames' impulses into the world, a few terms a slot); the air times and
# touchdown equal. A decision (a joint clamped at its limit, a foot in
# contact) may come out otherwise only where its deciding quantity, read
# from the reference side (the new joint angle, the foot's force norm),
# lies within POST_FLIP_SPACINGS float32 spacings of its limit; the
# entries it decides are left out of their fields' comparison.
POST_SUM_UNITS = 8
POST_FLIP_SPACINGS = 4


class PostComparison(NamedTuple):
    """What ``compare_post`` found: the max abs error of each output over
    the entries compared, the outputs with entries outside the tolerance
    (name -> how many), each decision that came out otherwise (kind, env,
    index, margin in float32 spacings), the decisions near their limit,
    and a line that says so."""
    errors: dict
    outside: dict
    flips: list
    near: int
    text: str

    @property
    def ok(self) -> bool:
        return not self.outside and all(
            margin <= POST_FLIP_SPACINGS for *_, margin in self.flips)


def _spacings(x, limit):
    """|x - limit| in float32 spacings of |limit| (float64)."""
    lim = limit.double().abs()
    ulp = torch.nextafter(lim.float(), torch.full_like(lim.float(),
                                                       float("inf"))).double() - lim
    return (x.double() - limit.double()).abs() / ulp


def compare_post(mt, params, s, v_free, W, lam, out, ref) -> PostComparison:
    """The post stage's outputs ``out`` (a SimState) against the
    reference side's ``ref`` from the same state ``s`` and operands
    (v_free, W, lam), at the tolerances above."""
    m = mt.model
    h = params.dt
    n, nj = v_free.shape[0], m.nj
    nr = m.nreport
    terms = torch.matmul(W.abs().double(), lam.abs().double()[..., None])[..., 0]
    v_tol = 1e-5 + POST_SUM_UNITS * 2.0 ** -24 * (v_free.abs().double() + terms)
    # the deciding quantities on the reference side
    v_pre = v_free + torch.matmul(W, lam[..., None])[..., 0]
    qj_new = s.qpos[:, 7:] + h * v_pre[:, 6:]
    joint_margin = torch.minimum(
        _spacings(qj_new, mt.joint_lower.expand(n, nj)),
        _spacings(qj_new, mt.joint_upper.expand(n, nj)))
    foot = ref.forces.reshape(n, nr, 3)[:, mt.foot_ids].double()
    norm = torch.sqrt((foot * foot).sum(-1))
    thr = torch.full_like(norm, params.contact_force_threshold)
    foot_margin = _spacings(norm, thr)
    joint_flip = (out.qvel[:, 6:] == 0) != (ref.qvel[:, 6:] == 0)
    foot_flip = (out.current_air_time == 0) != (ref.current_air_time == 0)
    flips = [("joint", int(e), int(j), float(joint_margin[e, j]))
             for e, j in joint_flip.nonzero().tolist()]
    flips += [("foot", int(e), int(f), float(foot_margin[e, f]))
              for e, f in foot_flip.nonzero().tolist()]
    near = int((joint_margin <= POST_FLIP_SPACINGS).sum()
               + (foot_margin <= POST_FLIP_SPACINGS).sum())
    keep_j = ~joint_flip
    keep_v = torch.cat([torch.ones(n, 6, dtype=torch.bool,
                                   device=keep_j.device), keep_j], dim=1)
    keep_q = torch.cat([torch.ones(n, 7, dtype=torch.bool,
                                   device=keep_j.device), keep_j], dim=1)
    acc_scale = ref.joint_acc.abs().max().item() if nj else 0.0
    frc_scale = ref.forces.abs().max().item()
    tol = {"qpos": (1e-5, keep_q), "qvel": (v_tol, keep_v),
           "joint_acc": (1e-5 * acc_scale + v_tol[:, 6:] / h, keep_j),
           "forces": (1e-5 * frc_scale, None),
           "force_hist": (1e-5 * max(frc_scale,
                                     ref.force_hist.abs().max().item()),
                          None)}
    for name in ("current_air_time", "last_air_time", "current_contact_time",
                 "last_contact_time", "touchdown"):
        tol[name] = (0.0, ~foot_flip)
    errors, outside = {}, {}
    for name, (t, keep) in tol.items():
        a, b = getattr(out, name), getattr(ref, name)
        err = (a.double() - b.double()).abs()
        bad = (err > t) | ~torch.isfinite(a.double())
        if keep is not None:
            err, bad = err[keep], bad[keep]
        errors[name] = err.max().item() if err.numel() else 0.0
        if int(bad.sum()):
            outside[name] = int(bad.sum())
    for name in ("lam", "applied_torque"):
        if not torch.equal(getattr(out, name), getattr(ref, name)):
            outside[name] = "differs"
    margins = sorted(f"{k} {e}/{i} at {mg:.2f}" for k, e, i, mg in flips)
    return PostComparison(
        errors, outside, flips, near,
        "max abs err " + ", ".join(f"{k} {v:.3g}" for k, v in errors.items())
        + f"; {near} decisions within {POST_FLIP_SPACINGS} spacings of "
        f"their limit, {len(flips)} flipped"
        + (f" (kind env/index at spacings: {', '.join(margins[:8])}"
           f"{' ...' if len(margins) > 8 else ''})" if flips else "")
        + f"; outside tolerance {outside or 'none'}")


def post_contrived(mt, params, s, lam):
    """The post stage's three contrived inputs from a state ``s`` and its
    impulses ``lam``: "on-limits" (every joint exactly on its lower limit
    in even envs and its upper limit in odd ones, the impulses kept),
    "at-threshold" (each foot's force from the normal impulse of its first
    terrain candidate alone, its norm spread evenly over the contact
    threshold +- 1e-3 N across envs and feet; every other impulse 0),
    "zero-lam" (every impulse 0). Returns {label: (state, lam)}."""
    m = mt.model
    n = lam.shape[0]
    odd = (torch.arange(n, device=lam.device) % 2 == 1)[:, None]
    qpos = s.qpos.clone()
    qpos[:, 7:] = torch.where(odd, mt.joint_upper, mt.joint_lower)
    feet = [int(f) for f in m.foot_report_ids]
    cand = [int(list(m.cand_report).index(f)) for f in feet]
    delta = torch.linspace(-1e-3, 1e-3, n * len(feet), device=lam.device,
                           dtype=torch.float64).reshape(len(feet), n).T
    at = torch.zeros_like(lam)
    for k, c in enumerate(cand):
        at[:, 3 * c + 2] = ((params.contact_force_threshold + delta[:, k])
                            * params.dt).float()
    return {"on-limits": (s._replace(qpos=qpos), lam),
            "at-threshold": (s, at), "zero-lam": (s, torch.zeros_like(lam))}


def post_counts(model, n, frames, lam):
    """(bytes, f32 operations) the post stage needs for n envs of
    ``model`` as ``csrc/substep_post.cu`` does it: each input the function
    uses read once and each output written once (touchdown a byte, the
    packed tables); of the force history the newer two thirds (the oldest
    third is dropped), of qvel the joints' (``joint_acc``); of W and the
    frames (``frames``: the terrain or the pairs give them) the column and
    the frame's row of each impulse these inputs hold, nonzero in ``lam``
    (N, 3nc).
    Operations: 2 nv a column of W
    read, a frame's 15, the forces' divisions and report sums, and per env
    the integration (~120) and a foot's norm and times (~12)."""
    nv, nj, nq, nc = model.nv, model.nj, model.nq, model.ncand
    nct, npair, nr = model.ncand_terrain, model.npair, model.nreport
    nf = len(model.foot_report_ids)
    cols = float((lam != 0).sum())
    active = float((lam.reshape(-1, nc, 3) != 0).any(-1).sum())
    reads = 3 * nc + nq + nv + nj + 6 * nr + 4 * nf
    writes = nq + nv + nj + 12 * nr + 4 * nf
    tables = 4 * (2 * nj + 4 * nr + nf)
    byts = (4 * (cols * (nv + (3 if frames else 0))
                 + n * (reads + writes)) + 2 * n * nf + tables)
    flops = (2 * nv * cols + (15 * active if frames else 0)
             + n * (3 * nc + 3 * (nct + 2 * npair) + nv + 120 + 4 * nj
                    + 12 * nf))
    return byts, flops


# The env step's three kernels (ops/env_step.py) against their plain
# stages on the same inputs (compare_env). Each kernel runs the plain
# stage's operations in its order with one rounding each (-fmad=false);
# what is left is PyTorch's own kernels contracting or reordering inside
# one operation (a 3-vector norm's sum of squares, the cross products of a
# rotation) and the library's exp, atan2, sin and cos: an output entry
# within ENV_SPACINGS float32 spacings of its column's largest magnitude
# (a norm minus a limit carries the norm's rounding, of the size of the
# column). The accumulators sum each env's share in another order than
# the plain stage's reductions: every share is >= 0, so their relative
# error is at most (N - 1) unit roundoffs, ENV_ACC_RTOL at N = 4096. A
# decision (a flag, a binary column, a gate, a curriculum row) may come
# out otherwise only in an env with a deciding quantity within
# ENV_FLIP_SPACINGS float32 spacings of its limit (env_margins); that
# env's entries are then left out of the tolerance and listed as flips.
ENV_SPACINGS = 8
ENV_ACC_RTOL = 4096 * 2.0 ** -24
ENV_FLIP_SPACINGS = 4


def _norm(x):
    return torch.sqrt((x.double() ** 2).sum(-1))


def env_margins(env, state, sim, action, prev_action, command=None):
    """(N,) float64: each env's smallest distance, in float32 spacings of
    the limit, of a quantity a step's decision compares with its limit,
    read from the plain side's inputs: each report slot's force norm
    against 1 N and the contact threshold, the tilt |g_xy| and g_z
    against the upside-down limits, the command's norms against the terms'
    and the commands' deadzones, and on the terrain curriculum the walked
    distance against a half and a quarter of the commanded one.
    ``command``: the command the commands' deadzone reads (default the
    state's)."""
    cfg, cset = env.cfg, env.cset
    n = action.shape[0]
    data = env.step_data(sim, state.command, action, prev_action)
    hist = sim.force_hist.reshape(n, 3, env.model.nreport, 3)
    norms = torch.amax(torch.linalg.vector_norm(hist.double(), dim=-1), dim=1)

    def lim(x, limit):
        return _spacings(x, torch.full_like(x, float(limit))).reshape(n, -1)

    g = data.projected_gravity.double()
    cmd = state.command.double()
    m = [lim(norms, 1.0), lim(norms, cfg.terminations.contact_threshold),
         lim(_norm(g[:, :2]), cfg.terminations.upside_down_limit),
         lim(g[:, 2], 0.0), lim(cmd[:, 1].abs(), cfg.commands.velocity_deadzone),
         lim(_norm(cmd), cfg.commands.velocity_deadzone)]
    for row, vals in zip(cset.descriptors.ints, cset.descriptors.floats):
        for v in vals:
            if v != 0.0:
                m += [lim(_norm(cmd), v), lim(g[:, 2], v),
                      lim(_norm(g[:, :2]), v)]
    if command is not None:
        m.append(lim(_norm(command.double()), cfg.commands.velocity_deadzone))
    if cfg.terrain_curriculum and cfg.terrain.kind == "hfield":
        dist = _norm(sim.qpos[:, :2].double() - state.origin.double())
        required = _norm(cmd[:, :2]) * cfg.episode_length_s
        for share in (0.5, 0.25):
            r = (share * required).float()
            m.append(_spacings(dist, r).reshape(n, 1))
    return torch.cat(m, dim=1).amin(dim=1)


class EnvComparison(NamedTuple):
    """What ``compare_env`` found: the max abs error of each output over
    the entries compared, the outputs with entries outside the tolerance
    (name -> how many), the flips (output, env, margin in spacings), the
    envs near a limit, and a line that says so."""
    errors: dict
    outside: dict
    flips: list
    near: int
    text: str

    @property
    def ok(self) -> bool:
        return not self.outside and all(
            margin <= ENV_FLIP_SPACINGS for *_, margin in self.flips)


def _fields(x, prefix=""):
    """name -> tensor of a NamedTuple of tensors (nested: ``sim.qpos``)."""
    out = {}
    for k, v in x._asdict().items():
        if isinstance(v, tuple):
            out.update(_fields(v, f"{prefix}{k}."))
        elif v is not None:
            out[prefix + k] = v
    return out


def compare_env(out, ref, margins) -> EnvComparison:
    """A stage's outputs ``out`` (a NamedTuple of tensors, ``sim`` nested)
    against the plain stage's ``ref`` from the same inputs, at the
    tolerances above; ``margins`` (N,): ``env_margins`` of those inputs."""
    n = margins.shape[0]
    near_env = margins <= ENV_FLIP_SPACINGS
    errors, outside, flips = {}, {}, []
    a_all, b_all = _fields(out), _fields(ref)
    for name, b in b_all.items():
        a = a_all.get(name)
        if a is None or a.shape != b.shape:
            outside[name] = "given by one side" if a is None else "shape"
            continue
        per_env = b.dim() > 0 and b.shape[0] == n
        if not b.is_floating_point():
            bad = a != b
            err = bad.double()
        else:
            err = (a.double() - b.double()).abs()
            if name.startswith("acc_"):
                tol = ENV_ACC_RTOL * b.double().abs()
            elif name == "col_max":
                # a column's maximum carries its column's rounding
                tol = ENV_SPACINGS * 2.0 ** -24 * b_all["raw"].double().abs(
                ).amax(0)
            else:
                scale = (b.double().abs().amax(0, keepdim=True) if per_env
                         else b.double().abs())
                tol = ENV_SPACINGS * 2.0 ** -24 * scale
            bad = (err > tol) | (torch.isnan(a) != torch.isnan(b))
            err = torch.where(torch.isnan(a) & torch.isnan(b),
                              torch.zeros_like(err), err)
        if per_env:
            rows = bad.reshape(n, -1).any(1)
            for e in (rows & near_env).nonzero().flatten().tolist():
                flips.append((name, e, float(margins[e])))
            bad = bad & ~near_env.reshape((n,) + (1,) * (b.dim() - 1))
            err = err[~near_env] if err.dim() else err
        elif b.dim() and bool(bad.any()) and bool(near_env.any()):
            # a maximum over envs moves with a flipped env's entry
            flips += [(name, -1, float(margins[near_env].max()))]
            bad = torch.zeros_like(bad)
        errors[name] = float(err.max()) if err.numel() else 0.0
        if int(bad.sum()):
            outside[name] = int(bad.sum())
    shown = sorted({(e, round(mg, 2)) for _, e, mg in flips})
    errs = ", ".join(f"{k} {v:.3g}" for k, v in errors.items() if v)
    text = ((f"max abs err {errs} (every other output equal)" if errs
             else "every output equal")
        + f"; {int(near_env.sum())} envs with a "
        f"deciding quantity within {ENV_FLIP_SPACINGS} spacings of its "
        f"limit, {len(shown)} of them flipped"
        + (f" (env at spacings: {shown[:8]}{' ...' if len(shown) > 8 else ''})"
           if shown else "")
        + f"; outside tolerance {outside or 'none'}")
    return EnvComparison(errors, outside, flips, int(near_env.sum()), text)


def cells_read(terrain, xy) -> int:
    """How many rows of the packed corner table (``sim/terrain.py``) the
    lookups at world xy (..., 2) read: each distinct cell once."""
    from cat_tpu_torch.sim.terrain import cell_coords

    return int(torch.unique(cell_coords(terrain, xy)[0]).numel())


def env_counts(env, n, terms=None, qpos=None):
    """{kernel: (bytes, f32 operations)} the env step's three kernels need
    for n envs of ``env`` as ``ops/env_step.py`` runs them: each input the
    function uses read once and each output written once (flags a byte,
    the small tables once). The heightfield's packed corner table (16
    bytes a cell, in L2 at the production grid's 8.2 MB) counts each
    cell read once: with ``qpos`` (N, nq), the observed state (the
    update's output), the cells the height scan reads there and, with
    ``terms`` too, the cells under the reset envs' spawn positions;
    without ``qpos``, one a lookup, at most the whole table. ``terms``
    (a ``Terms``) gives the reset envs (none without it). Operations: a
    few a column and a norm's 6 a slot and history entry (env_terms), ~10
    a column and ~150 an env (env_update), ~30 a scan point and ~40 a
    proprioceptive entry (env_obs); the library's exp, atan2, sin and cos
    count as one each."""
    m, cset, cfg = env.model, env.cset, env.cfg
    nq, nv, nj, nr = m.nq, m.nv, m.nj, m.nreport
    nf, nc = len(m.foot_report_ids), m.ncand
    nt, K = cset.n_terms, cset.total_cols
    from cat_tpu_torch.envs import constraints as C
    from cat_tpu_torch.envs.cat import KERNEL_TERMS
    from cat_tpu_torch.sim.maths import quat_yaw

    # the report slots whose force history the terms and the terminations
    # read
    hist_kinds = {k for k, (f, _, _) in enumerate(KERNEL_TERMS) if f in (
        C.contact, C.n_foot_contact, C.foot_contact_force)}
    tab = cset.descriptors
    slots = len({int(i) for i in env.illegal_ids.tolist()}
                | {int(i) for row in tab.ints if row[0] in hist_kinds
                   for i in tab.ids[row[3]:row[3] + row[4]]})
    tables = 4 * (tab.ints.size + tab.floats.size + tab.ids.size + 2 * nj)
    terms_b = (4 * n * (nq + 4 * nj + 9 * slots + nf + 3 + 1 + K + 1)
               + n * (nf + 3) + 4 * K + tables)
    terms_f = n * (3 * K + 18 * slots + 60)

    # the corner table's cells each lookup reads, each counted once
    hs, terr = cfg.height_scan, cfg.terrain
    pts = hs.num_points if hs is not None else 0
    reset_cells = scan_cells = 0
    if terr.kind == "hfield":
        R, Cn = terr.height.shape
        cells = (R - 1) * (Cn - 1)
        resets = None if terms is None else (
            terms.time_out | terms.illegal | terms.upside)
        if resets is not None:
            reset_cells = (min(int(resets.sum()), cells) if qpos is None
                           else cells_read(terr, qpos[resets, 0:2]))
        if pts:
            scan_cells = (min(n * pts, cells) if qpos is None
                          else cells_read(terr, env.scan_points(
                              qpos[:, 0:3], quat_yaw(qpos[:, 3:7]))))

    sim_words = nq + nv + 3 * nc + 2 * nj + 12 * nr + 4 * nf
    draws = (3 + nj) + 13 + (3 if cfg.events.push_enabled else 0)
    reads = (K + 2 * nt + 1 + 3 + 1 + 2 + 2 + 2 * nj + sim_words + draws + 1)
    writes = (sim_words + 2 + 2 * nt + 1 + 1 + 2 * nj + 3 + 1 + 2 + 1)
    # the accumulators (2 n_terms + 6 words), read and written once
    update_b = (4 * n * (reads + writes) + 2 * n * nf + 3 * n
                + 4 * (3 * K + 2 * nt + 3 * nj) + 8 * (2 * nt + 6)
                + 16 * reset_cells)
    update_f = n * (10 * K + 150)
    noise = 6 + 2 * nj + (pts if cfg.noise.enabled and pts else 0)
    obs_b = (4 * n * (nq + nv + 3 + nj + noise + env.num_obs)
             + 16 * scan_cells + 4 * 2 * pts)
    obs_f = n * (40 * (9 + 3 * nj) + 30 * pts)
    return {"env_terms": (terms_b, terms_f), "env_update": (update_b, update_f),
            "env_obs": (obs_b, obs_f)}


def env_inputs(env, n, steps, policy, seed=0):
    """A state to step from: ``steps`` env steps of ``policy`` (obs ->
    action) from a fresh state of n envs. Returns (the state, the
    policy's next action, the generator)."""
    dev = env.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    es = env.init(gen, n)
    obs = env.observe(es, gen)
    with torch.no_grad():
        for _ in range(steps):
            es, obs, *_ = env.step(es, policy(obs), gen)
        action = policy(obs)
    return es, action, gen


@contextlib.contextmanager
def plain_stages(calls=None):
    """Within it, ``CatEnv._step_eager`` and ``observe`` run the env
    step's plain stages (``CatEnv.terms_stage``, ``update_stage``,
    ``obs_stage``) on any device, in place of ``ops/env_step.py``'s
    dispatch. With ``calls`` (a list), each stage's call is appended to
    it, in the step's order: (kernel name, its arguments after the env,
    its keyword arguments, its output)."""
    from cat_tpu_torch.ops import env_step

    saved = {name: getattr(env_step, name) for name, _ in env_step.ENV_KERNELS}

    def plain(name, stage):
        def run(env, *args, **kwargs):
            out = getattr(env, stage)(*args, **kwargs)
            if calls is not None:
                calls.append((name, args, kwargs, out))
            return out
        return run

    try:
        for name, stage in zip(saved, ("terms_stage", "update_stage",
                                       "obs_stage")):
            setattr(env_step, name, plain(name, stage))
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(env_step, name, fn)


def env_stage_pairs(env, state, action, gen):
    """Each env kernel and its plain stage on the inputs the plain stages
    get in one env step from ``state`` with ``action`` (``_step_eager``
    under ``plain_stages``: the step's own draws from ``gen``, its own
    order): {kernel name (a split ``env_update``'s parts as
    ``env_update[reset]`` and ``env_update[commands]``): (kernel's
    outputs, plain stage's, env_margins of the inputs, a call of the
    kernel, a call of the plain stage)}."""
    from cat_tpu_torch.ops import env_step

    calls = []
    with plain_stages(calls):
        env._step_eager(state, action, gen)
    kernels = dict(env_step.ENV_KERNELS)
    terms_args = calls[0][1]             # (state, sim, action, prev_action)
    margins = env_margins(env, *terms_args)
    pairs = {}
    for name, args, kwargs, ref in calls:
        kernel = functools.partial(kernels[name], env, *args, **kwargs)
        stage = functools.partial(
            getattr(env, name.replace("env_", "") + "_stage"), *args,
            **kwargs)
        out, m = kernel(), margins
        if name == "env_obs":
            out, ref = _Obs(out), _Obs(ref)
            m = torch.full_like(margins, float("inf"))
        elif name == "env_update" and ref.command is not None:
            m = torch.minimum(margins, env_margins(env, *terms_args,
                                                   command=ref.command))
        key = f"{name}[{kwargs['part']}]" if "part" in kwargs else name
        pairs[key] = (out, ref, m, kernel, stage)
    return pairs


class _Obs(NamedTuple):
    obs: torch.Tensor
