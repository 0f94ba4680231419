"""The serial Gauss-Seidel PGS solve: the port's plain PyTorch version
against both JAX versions (the pure-XLA mirror _pgs_lanes_xla and the
Pallas kernel _pgs_kernel in interpret mode) and against the port's own
block-Jacobi solve with singleton blocks and omega 1; the engine's
dispatch on the solver structure; the kernel wrapper's CPU-side checks.
The CUDA kernel is held against the plain version in
tests/test_torch_gpu.py, on a card.

Tolerance (``_close`` of tests/test_torch_pgs.py, whose random problems
and layout helper this file shares): the solves run the same float32
arithmetic in the same contact order; the port's contractions sum in
another order, so they agree to rtol 2e-5 / atol 2e-5 x max|lam| (a few
hundred ulps after 5 sweeps).
"""

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from test_torch_pgs import _close, _lanes, _random_problem
from cat_tpu.ops import pgs_pallas as jp
from cat_tpu.sim.engine_lanes import _pgs_lanes_xla
from cat_tpu_torch.models.solo12 import SOLO12_KD, SOLO12_KP
from cat_tpu_torch.models.solo12 import solo12_model as port_solo12
from cat_tpu_torch.ops import pgs
from cat_tpu_torch.sim import engine, terrain
from cat_tpu_torch.sim.solver import SolverParams

GS = dict(iterations=5, cfm=1e-4)


def _physical_problem(n=8):
    """Contact problems of the raw engine (GS-5) on rough terrain, captured
    after 5 control steps: robots dropped on patch centres, feet and some
    shins on the ground, contact frames tilted by the terrain."""
    model = port_solo12()
    terr = terrain.generate_rough(rows=2, cols=4, patch_m=4.0, seed=0)
    step = engine.make_batched_step(
        model, engine.EngineParams(kp=SOLO12_KP, kd=SOLO12_KD), terrain=terr,
        device="cpu")
    s = engine.make_batched_init(model, n, "cpu")
    xy = torch.tensor(np.stack([terr.patch_origin(i % 2, i % 4)
                                for i in range(n)]), dtype=torch.float32)
    xy = xy + torch.from_numpy(np.random.default_rng(3).uniform(
        -1.2, 1.2, (n, 2)).astype(np.float32))
    qpos = s.qpos.clone()
    qpos[:, 0:2] = xy
    qpos[:, 2] = terrain.height_at(terr, xy) + 0.3
    s = s._replace(qpos=qpos)
    target = torch.as_tensor(model.default_qpos_joints,
                             dtype=torch.float32).expand(n, model.nj)
    mu = torch.full((n,), 0.9)
    for _ in range(5):
        s = step(s, target, mu)
    _, ops = step.contact_problem(s, target, mu)
    return tuple(o.numpy() for o in ops)


@pytest.fixture(scope="module")
def problems():
    m = port_solo12()
    return {
        "physical": _physical_problem(),
        "random": _random_problem(np.random.default_rng(8), 8, m.ncand, m.nv),
    }


def test_physical_problems_have_work(problems):
    E, W, b, bias, active, mu, lam0 = problems["physical"]
    per_env = active.sum(axis=1)
    assert per_env.min() >= 1 and per_env.sum() >= 16 and per_env.max() < 36
    assert np.abs(lam0).max() > 0.0       # warm-started from the last substep


@pytest.mark.parametrize("kind", ["physical", "random"])
def test_plain_gs_matches_xla_mirror(problems, kind):
    """Solo12 shapes (36 contacts, 18 dofs), 5 sweeps."""
    ops = problems[kind]
    port = pgs.pgs_gs_reference(*map(torch.from_numpy, ops), **GS)
    ref = _pgs_lanes_xla(*_lanes(*ops), nc=36, **GS)
    assert float(np.abs(np.asarray(ref)).max()) > 0.0
    _close(port.numpy(), np.asarray(ref).T)


@pytest.mark.parametrize("warm", [True, False])
def test_plain_gs_matches_pallas_kernel(warm):
    """The Pallas kernel _pgs_kernel itself (interpret mode) on small
    problems (6 contacts, 10 dofs, as tests/test_pgs_pallas.py sets them),
    with and without a warm start, about half the contacts inactive."""
    nc, nv, n = 6, 10, 16
    ops = _random_problem(np.random.default_rng(11 + warm), n, nc, nv, warm)
    assert 0 < ops[4].sum() < ops[4].size
    E, W, b, bias, active, mu, lam0 = _lanes(*ops)
    ref = jp.pgs_solve_lanes(E, W, b, bias, active, mu[None, :], lam0,
                             nc=nc, nv=nv, interpret=True, **GS)
    port = pgs.pgs_gs_reference(*map(torch.from_numpy, ops), **GS)
    _close(port.numpy(), np.asarray(ref).T)


def test_plain_gs_equals_plain_bj_with_singleton_blocks(problems):
    """Block-Jacobi with one contact a block and omega 1 is Gauss-Seidel."""
    ops = tuple(map(torch.from_numpy, problems["physical"]))
    bj = pgs.pgs_bj_reference(*ops, omega=1.0, contact_perm=tuple(range(36)),
                              blocks=tuple((i, 1) for i in range(36)), **GS)
    gs = pgs.pgs_gs_reference(*ops, **GS)
    _close(gs.numpy(), bj.numpy())


def test_plain_gs_row_dofs_change_nothing(problems):
    """row_dofs only lets the kernel skip exact zeros of the assembly."""
    ops = tuple(map(torch.from_numpy, problems["physical"]))
    m = port_solo12()
    rows = pgs.contact_row_dofs(m, m.ancestor_mask())
    E = ops[0].numpy()
    for r, ks in enumerate(rows):
        off = np.setdiff1d(np.arange(m.nv), ks)
        assert (E[:, r, off] == 0.0).all()
    torch.testing.assert_close(pgs.pgs_gs_reference(*ops, row_dofs=rows, **GS),
                               pgs.pgs_gs_reference(*ops, **GS), rtol=0, atol=0)


def test_dispatch_on_cpu_is_the_plain_version(problems):
    ops = tuple(map(torch.from_numpy, problems["random"]))
    launches = pgs.GS_KERNEL.launches
    torch.testing.assert_close(pgs.pgs_gs(*ops, **GS),
                               pgs.pgs_gs_reference(*ops, **GS), rtol=0, atol=0)
    assert pgs.GS_KERNEL.launches == launches


def test_kernel_wrapper_refuses_cpu_tensors(problems):
    """The wrapper launches on CUDA tensors or raises: no fallback."""
    ops = tuple(map(torch.from_numpy, problems["random"]))
    launches = pgs.GS_KERNEL.launches
    with pytest.raises(ValueError, match="is on cpu"):
        pgs.GS_KERNEL(*ops, **GS)
    assert pgs.GS_KERNEL.launches == launches


def test_kernel_dof_table():
    """The table of nonzero dofs the kernel takes, as a bit mask a row
    (bit k: dof k enters the row; the kernel leaves the others out): the rows
    of contact_row_dofs for the model, none when row_dofs is None (every
    dof); malformed rows are refused."""
    m = port_solo12()
    rows = pgs.contact_row_dofs(m, m.ancestor_mask())
    kern = pgs.PgsGsKernel()
    masks = kern._row_masks("cpu", 108, 18, rows).numpy().view(np.uint32)
    assert [tuple(k for k in range(18) if masks[r] >> k & 1)
            for r in range(108)] == list(rows)
    assert kern._row_masks("cpu", 9, 5, None) is None
    assert int(kern._row_masks("cpu", 3, 32, [range(32)] * 3)[0]) == -1
    for bad in (rows[:-1], [()] * 108, [(0, 18)] * 108):
        with pytest.raises(ValueError, match="row_dofs"):
            kern._row_masks("cpu", 108, 18, bad)


@pytest.mark.parametrize("structure,solve", [("gs", "pgs_gs"),
                                             ("bj", "pgs_bj"), ("cg", None)])
def test_engine_dispatches_on_the_solver_structure(structure, solve):
    """SolverParams() (structure "gs", 5 sweeps) runs the Gauss-Seidel
    solve, ignoring omega and bj_blocks; "bj" the block-Jacobi one."""
    m = port_solo12()
    sp = SolverParams(structure=structure, bj_blocks=4, omega=0.9)
    if solve is None:
        with pytest.raises(ValueError, match="solver structure"):
            engine.make_batched_step(m, engine.EngineParams(solver=sp),
                                     device="cpu")
        return
    eng = engine.make_batched_step(m, engine.EngineParams(solver=sp),
                                   device="cpu")
    assert eng.solve is getattr(pgs, solve)
    if structure == "gs":
        assert eng.pgs_kwargs == dict(
            iterations=5, cfm=1e-4,
            row_dofs=pgs.contact_row_dofs(m, m.ancestor_mask()))
    else:
        assert eng.pgs_kwargs["omega"] == 0.9
    default = engine.make_batched_step(m, engine.EngineParams(), device="cpu")
    assert default.solve is pgs.pgs_gs and default.pgs_kwargs["iterations"] == 5
