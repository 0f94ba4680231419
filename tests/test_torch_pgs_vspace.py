"""The numerics of the contact kernels' velocity-space formulation, on the
CPU, before any card.

The CUDA kernels (cat_tpu_torch/ops/csrc/pgs_bj.cu and pgs_gs.cu, sharing
pgs_vspace.cuh) never form the Delassus operator A = E W: they keep the
generalized impulse u = E^T lam (nv floats), read a group's rows of
w = A lam as W[:, rows]^T u, compute five entries of A per active contact
as dot products, add an impulse change back as u += E[rows]^T dlam, and
skip inactive contacts. ``vspace_solve`` below emulates that in float32
with the kernels' order of operations: the active-contact list in sweep
order, the warp's dot products (S lanes a row summing strided terms with
fused multiply-adds, joined by a butterfly), the warm start and u updates
as one fused multiply-add chain a dof. The projection's arithmetic is written out in
plain float32; the compiler may fuse some of its products, which changes
the last bit only.

It is held against the port's plain versions (pgs_bj_reference,
pgs_gs_reference) and the JAX package's Pallas kernels in interpret mode,
on the problems of tests/test_torch_pgs.py and tests/test_torch_pgs_gs.py,
with the tolerance chip_smoke.py holds the card's kernels to: rtol 2e-4,
atol 2e-5 x max|lam|.
"""

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from test_torch_pgs import _lanes, _physical_problem, _random_problem
from test_torch_pgs_gs import _physical_problem as _gs_physical_problem
from cat_tpu.models.solo12 import solo12_model as jax_solo12
from cat_tpu.ops import pgs_pallas as jp
from cat_tpu_torch.models.solo12 import solo12_model as port_solo12
from cat_tpu_torch.ops import pgs

RTOL, ATOL_REL = 2e-4, 2e-5
F32 = np.float32


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=ATOL_REL * np.abs(ref).max())


def _fma(a, b, c):
    """float32 a * b + c rounded once (the product is exact in float64)."""
    f64 = np.float64
    return (np.asarray(a, f64) * np.asarray(b, f64)
            + np.asarray(c, f64)).astype(F32)


def _warp_dots(rows, nv):
    """pgs_vspace.cuh warp_dots: each row (a, x) summed by S lanes, lane p
    taking terms p, p + S, ... by fused multiply-adds, joined by a
    butterfly of S / 2, S / 4, ..., 1."""
    S = 32
    while S > 1 and S * len(rows) > 32:
        S //= 2
    pad = -nv % S
    out = []
    for a, x in rows:
        a = np.concatenate([a, np.zeros(pad, F32)]).reshape(-1, S)
        x = np.concatenate([x, np.zeros(pad, F32)]).reshape(-1, S)
        acc = np.zeros(S, F32)
        for k in range(a.shape[0]):
            acc = _fma(a[k], x[k], acc)
        o = S // 2
        while o:
            acc = (acc + acc[np.arange(S) ^ o]).astype(F32)
            o //= 2
        out.append(acc[0])
    return out


def _project(rec, w, lam, omega, mu):
    """The projection of one contact (pgs_vspace.cuh Warp::group)."""
    inv_t1, inv_t2, inv_n, c_t1n, c_t2n, b0, b1, b2, bias, act = rec
    l0, l1, l2 = lam
    om = F32(omega)
    vn = F32(F32(w[2] + b2) + bias)
    ln_new = F32(max(F32(l2 - F32(F32(om * vn) * inv_n)), F32(0.0)) * act)
    dn = F32(ln_new - l2)
    vt1 = F32(F32(w[0] + b0) + F32(c_t1n * dn))
    vt2 = F32(F32(w[1] + b1) + F32(c_t2n * dn))
    lt1 = F32(l0 - F32(F32(om * vt1) * inv_t1))
    lt2 = F32(l1 - F32(F32(om * vt2) * inv_t2))
    tn = F32(np.sqrt(F32(F32(F32(lt1 * lt1) + F32(lt2 * lt2)) + F32(1e-12))))
    scale = F32(min(F32(1.0), F32(F32(mu * ln_new) / tn)) * act)
    n1, n2 = F32(lt1 * scale), F32(lt2 * scale)
    return (F32(n1 - l0), F32(n2 - l1), dn), (n1, n2, ln_new)


def _u_update(u, E, rows, d):
    """u[l] += E[rows, l] . d, one fused multiply-add chain a dof."""
    for r, dr in zip(rows, d):
        u = _fma(E[r], dr, u)
    return u


def vspace_solve(E, W, b, bias, active, mu, lam0, *, iterations, cfm,
                 omega=1.0, contact_perm=None, blocks=None, skip=True):
    """One env at a time, as a warp runs it. Without blocks: the serial
    sweep over the active contacts (pgs_gs.cu), omega 1; with blocks:
    block-Jacobi over the contact permutation (pgs_bj.cu). skip=False
    sweeps the inactive contacts too, as the kernels do not."""
    n, n3, nv = E.shape
    nc = n3 // 3
    perm = list(range(nc)) if contact_perm is None else list(contact_perm)
    out = np.zeros((n, n3), F32)
    for e in range(n):
        Ee, We = E[e], W[e]
        slots = [c for c in perm if active[e, c] != 0 or not skip]
        pos = [p for p in range(nc) if active[e, perm[p]] != 0 or not skip]
        ents = _warp_dots([(Ee[3 * c + t], We[:, 3 * c + u])
                           for c in slots for t, u in
                           ((0, 0), (1, 1), (2, 2), (0, 2), (1, 2))], nv)
        recs, lam = [], []
        for j, c in enumerate(slots):
            a = ents[5 * j:5 * j + 5]
            act = active[e, c]
            recs.append([F32(1.0) / F32(a[0] + F32(cfm)),
                         F32(1.0) / F32(a[1] + F32(cfm)),
                         F32(1.0) / F32(a[2] + F32(cfm)), a[3], a[4],
                         *b[e, 3 * c:3 * c + 3], bias[e, c], act])
            lam.append([F32(x * act) for x in lam0[e, 3 * c:3 * c + 3]])
        u = _u_update(np.zeros(nv, F32), Ee,
                      [3 * c + t for c in slots for t in range(3)],
                      [x for lj in lam for x in lj])
        if blocks is None:
            groups = [(j, 1) for j in range(len(slots))]
            om = 1.0
        else:
            groups = [(sum(p < i0 for p in pos),
                       sum(i0 <= p < i0 + g for p in pos)) for i0, g in blocks]
            om = omega
        for _ in range(iterations):
            for s0, m in groups:
                if not m:
                    continue
                group = range(s0, s0 + m)
                w = _warp_dots([(u, We[:, 3 * slots[j] + t])
                                for j in group for t in range(3)], nv)
                dls = []
                for i, j in enumerate(group):
                    d, lam[j] = _project(recs[j], w[3 * i:3 * i + 3], lam[j],
                                         om, mu[e])
                    dls.extend(d)
                u = _u_update(u, Ee, [3 * slots[j] + t for j in group
                                      for t in range(3)], dls)
        for j, c in enumerate(slots):
            out[e, 3 * c:3 * c + 3] = lam[j]
    return out


@pytest.fixture(scope="module")
def problems():
    m = port_solo12()
    return {
        "physical": _physical_problem(),
        "physical_gs": _gs_physical_problem(),
        "random": _random_problem(np.random.default_rng(8), 8, m.ncand, m.nv),
    }


def _bj_kw(iterations=6):
    perm, blocks = pgs.plan_contact_blocks(port_solo12(), 4)
    return dict(iterations=iterations, cfm=1e-4, omega=0.9,
                contact_perm=perm, blocks=blocks)


GS = dict(iterations=5, cfm=1e-4)


@pytest.mark.parametrize("kind", ["physical", "physical_gs", "random"])
def test_vspace_bj_matches_plain(problems, kind):
    """Production plan bj:4:0.9:6 against pgs_bj_reference (dense A)."""
    ops = problems[kind]
    got = vspace_solve(*ops, **_bj_kw())
    ref = pgs.pgs_bj_reference(*map(torch.from_numpy, ops), **_bj_kw())
    assert np.abs(ref.numpy()).max() > 0.0
    _close(got, ref.numpy())


@pytest.mark.parametrize("kind", ["physical", "physical_gs", "random"])
def test_vspace_gs_matches_plain(problems, kind):
    """GS-5 against pgs_gs_reference (dense A, warm start row by row)."""
    ops = problems[kind]
    got = vspace_solve(*ops, **GS)
    ref = pgs.pgs_gs_reference(*map(torch.from_numpy, ops), **GS)
    _close(got, ref.numpy())


def test_vspace_bj_matches_pallas_kernel_production_plan(problems):
    """The Pallas kernel _pgs_kernel_bj (interpret mode) at bj:4:0.9:6 on
    the physical problems captured from the flat env."""
    ops = problems["physical"]
    m = jax_solo12()
    kw = _bj_kw()
    E, W, b, bias, active, mu, lam0 = _lanes(*ops)
    ref = jp.pgs_solve_lanes_bj(
        E, W, b, bias, active, mu[None, :], lam0, nc=36, nv=18,
        row_dofs=jp.contact_row_dofs(m, m.ancestor_mask()), interpret=True,
        **kw)
    _close(vspace_solve(*ops, **kw), np.asarray(ref).T)


@pytest.mark.parametrize("warm", [True, False])
def test_vspace_gs_matches_pallas_kernel(warm):
    """The Pallas kernel _pgs_kernel (interpret mode), GS-5, on small
    problems (6 contacts, 10 dofs, as tests/test_pgs_pallas.py sets them),
    with and without a warm start. At Solo12's 36 contacts its interpreter
    takes some two minutes; there the plain version stands in for it
    (tests/test_torch_pgs_gs.py holds the two to each other)."""
    ops = _random_problem(np.random.default_rng(11 + warm), 16, 6, 10, warm)
    assert 0 < ops[4].sum() < ops[4].size
    E, W, b, bias, active, mu, lam0 = _lanes(*ops)
    ref = jp.pgs_solve_lanes(E, W, b, bias, active, mu[None, :], lam0,
                             nc=6, nv=10, interpret=True, **GS)
    _close(vspace_solve(*ops, **GS), np.asarray(ref).T)


@pytest.mark.parametrize("nc,nv", [(4, 6), (28, 18), (6, 10)])
def test_vspace_matches_plain_at_other_shapes(nc, nv):
    """The box's shape (4 contacts, 6 dofs), Go2's (28, 18) and the small
    shape of tests/test_pgs_pallas.py, both sweep orders."""
    ops = _random_problem(np.random.default_rng(nc), 8, nc, nv)
    t_ops = tuple(map(torch.from_numpy, ops))
    _close(vspace_solve(*ops, **GS), pgs.pgs_gs_reference(*t_ops, **GS).numpy())
    n_blocks = 2 if nc % 2 == 0 else 3
    g = nc // n_blocks
    kw = dict(iterations=6, cfm=1e-4, omega=0.9,
              contact_perm=tuple(reversed(range(nc))),
              blocks=tuple((k * g, g) for k in range(n_blocks)))
    _close(vspace_solve(*ops, **kw), pgs.pgs_bj_reference(*t_ops, **kw).numpy())


def test_vspace_with_a_cut_dof_table_matches_plain():
    """A dof table that leaves out dofs a row has (the kernel leaves them
    out of its sums, as if zero in E) makes A = E_cut W unsymmetric. The plain versions, like the TPU
    kernels, add impulse changes back with A's rows as columns, i.e. with
    A^T = W^T E_cut^T: the generalized impulse u = E_cut^T lam and the rows
    W[:, r]^T u are exactly that, so they agree there too."""
    nc, nv = 6, 10
    ops = list(_random_problem(np.random.default_rng(7), 8, nc, nv))
    ops[0] = ops[0].copy()
    ops[0][..., nv - 1] = 0.0
    ref = pgs.pgs_gs_reference(*map(torch.from_numpy, ops), **GS)
    _close(vspace_solve(*ops, **GS), ref.numpy())


def test_skipping_inactive_contacts_is_exact():
    """An inactive contact (active = 0) starts at lam = 0 (lam0 * 0), its
    update projects it to lam = 0 again, whatever w and its record hold,
    and moves u by E[rows]^T 0, which leaves every bit of u as it was: so
    a sweep that leaves it out computes what one that visits it does."""
    rng = np.random.default_rng(5)
    E = rng.normal(size=(18, 10)).astype(F32) * F32(1e3)
    for _ in range(200):
        w = (rng.normal(size=3) * 10.0 ** rng.uniform(-6, 3)).astype(F32)
        rec = list((rng.normal(size=10) * 100).astype(F32))
        rec[:3] = np.abs(rec[:3])
        rec[9] = F32(0.0)
        lam0 = (rng.normal(size=3) * 10.0).astype(F32)
        d, lam = _project(rec, w, [F32(x * rec[9]) for x in lam0],
                          rng.uniform(0.5, 1.0), F32(rng.uniform(0.1, 2.0)))
        assert all(x == 0.0 for x in d + lam), (d, lam)
        u = rng.normal(size=10).astype(F32)
        np.testing.assert_array_equal(_u_update(u, E, [3, 4, 5], d), u)
