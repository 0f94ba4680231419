"""The block-Jacobi PGS contact solve: the port's plain PyTorch version
against both JAX versions (the pure-XLA mirror and the Pallas kernel in
interpret mode), the block plan and the row sparsity. The CUDA kernel is
held against the plain version in tests/test_torch_gpu.py, on a card.

Tolerance: the solves run the same float32 arithmetic in the same block
order; the port's contractions sum in another order, so they agree to
rtol 2e-5 / atol 2e-5 x max|lam| (a few hundred ulps after 6 sweeps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from cat_tpu.models.solo12 import solo12_model as jax_solo12
from cat_tpu.ops import pgs_pallas as jp
from cat_tpu_torch.models.solo12 import solo12_model as port_solo12
from cat_tpu_torch.ops import pgs

RTOL, ATOL_REL = 2e-5, 2e-5


def _close(port, ref, rtol=RTOL, atol_rel=ATOL_REL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=atol_rel * np.abs(ref).max())


@pytest.mark.parametrize("n_blocks", [1, 2, 3, 4, 6, 9])
def test_plan_contact_blocks_equal(n_blocks):
    assert pgs.plan_contact_blocks(port_solo12(), n_blocks) == \
        jp.plan_contact_blocks(jax_solo12(), n_blocks)


def test_contact_row_dofs_equal():
    m = jax_solo12()
    rows = pgs.contact_row_dofs(port_solo12(), m.ancestor_mask())
    assert rows == jp.contact_row_dofs(m, m.ancestor_mask())
    assert len(rows) == 108 and max(len(r) for r in rows) <= 12


def _random_problem(rng, n, nc, nv, warm=True):
    """Env-leading random problem: E, W = M^-1 E^T with M SPD, b, bias,
    active (about half the contacts), mu, lam0."""
    E = rng.normal(size=(n, 3 * nc, nv)).astype(np.float32)
    L = rng.normal(size=(n, nv, nv))
    M = L @ np.swapaxes(L, 1, 2) + nv * np.eye(nv)
    W = np.linalg.solve(M, np.swapaxes(E, 1, 2)).astype(np.float32)
    b = np.einsum("nrk,nk->nr", E, rng.normal(size=(n, nv))).astype(np.float32)
    phi = rng.uniform(-0.01, 0.01, size=(n, nc))
    bias = np.maximum(40.0 * np.minimum(phi + 0.002, 0.0), -2.0).astype(np.float32)
    active = (phi < 0.0).astype(np.float32)
    mu = rng.uniform(0.5, 1.25, size=n).astype(np.float32)
    lam0 = (rng.uniform(0, 0.05, size=(n, 3 * nc)) if warm
            else np.zeros((n, 3 * nc))).astype(np.float32)
    return E, W, b, bias, active, mu, lam0


def _physical_problem(n=8):
    """Contact problems captured from the port's env after a few control
    steps with random actions (feet on the ground, some pairs near)."""
    from cat_tpu_torch.tasks.solo12_flat import make_env

    env = make_env(n, device="cpu")
    gen = torch.Generator().manual_seed(0)
    es = env.init(gen, n)
    for _ in range(4):
        es = env.step(es, 0.3 * torch.randn(n, 12, generator=gen), gen)[0]
    target = env.default_joint_pos_task[env.m2t].expand(n, 12)
    _, ops = env.engine.contact_problem(es.sim, target, es.mu)
    return tuple(o.numpy() for o in ops)


def _lanes(E, W, b, bias, active, mu, lam0):
    """Env-leading numpy operands -> the JAX kernels' env-last layout."""
    return (jnp.asarray(np.moveaxis(E, 0, -1)), jnp.asarray(np.moveaxis(W, 0, -1)),
            jnp.asarray(b.T), jnp.asarray(bias.T), jnp.asarray(active.T),
            jnp.asarray(mu), jnp.asarray(lam0.T))


@pytest.fixture(scope="module")
def problems():
    m = port_solo12()
    return {
        "physical": _physical_problem(),
        "random": _random_problem(np.random.default_rng(8), 8, m.ncand, m.nv),
    }


@pytest.mark.parametrize("kind", ["physical", "random"])
def test_plain_bj_matches_xla_mirror(problems, kind):
    """Production plan: 36 contacts in 4 blocks, omega 0.9, 6 sweeps."""
    ops = problems[kind]
    perm, blocks = pgs.plan_contact_blocks(port_solo12(), 4)
    kw = dict(iterations=6, cfm=1e-4, omega=0.9, contact_perm=perm,
              blocks=blocks)
    port = pgs.pgs_bj_reference(*map(torch.from_numpy, ops), **kw)
    ref = jp.pgs_lanes_xla_bj(*_lanes(*ops), nc=36, **kw)
    assert float(np.abs(np.asarray(ref)).max()) > 0.0
    _close(port.numpy(), np.asarray(ref).T)


def test_plain_bj_matches_pallas_kernel_production_plan(problems):
    """The Pallas kernel itself (interpret mode), production plan, on the
    captured physical problems (one sweep keeps the interpreter quick)."""
    ops = problems["physical"]
    m = jax_solo12()
    perm, blocks = pgs.plan_contact_blocks(port_solo12(), 4)
    kw = dict(iterations=1, cfm=1e-4, omega=0.9, contact_perm=perm,
              blocks=blocks)
    E, W, b, bias, active, mu, lam0 = _lanes(*ops)
    ref = jp.pgs_solve_lanes_bj(
        E, W, b, bias, active, mu[None, :], lam0, nc=36, nv=18,
        row_dofs=jp.contact_row_dofs(m, m.ancestor_mask()), interpret=True,
        **kw)
    port = pgs.pgs_bj_reference(*map(torch.from_numpy, ops), **kw)
    _close(port.numpy(), np.asarray(ref).T)


def test_plain_bj_singleton_blocks_matches_gs_kernel():
    """Singleton blocks with omega 1 against the serial Gauss-Seidel Pallas
    kernel _pgs_kernel (interpret mode) on small problems (6 contacts, 10
    dofs): block-Jacobi with singleton blocks is Gauss-Seidel, the route by
    which the GS kernel may later ship."""
    nc, nv, n = 6, 10, 16
    ops = _random_problem(np.random.default_rng(9), n, nc, nv)
    E, W, b, bias, active, mu, lam0 = _lanes(*ops)
    kw = dict(iterations=5, cfm=1e-4, omega=1.0,
              contact_perm=tuple(range(nc)),
              blocks=tuple((i, 1) for i in range(nc)))
    ref = jp.pgs_solve_lanes(E, W, b, bias, active, mu[None, :], lam0,
                             nc=nc, nv=nv, iterations=5, cfm=1e-4,
                             interpret=True)
    port = pgs.pgs_bj_reference(*map(torch.from_numpy, ops), **kw)
    _close(port.numpy(), np.asarray(ref).T)


def test_dispatch_on_cpu_is_the_plain_version(problems):
    ops = tuple(map(torch.from_numpy, problems["random"]))
    perm, blocks = pgs.plan_contact_blocks(port_solo12(), 4)
    kw = dict(iterations=6, cfm=1e-4, omega=0.9, contact_perm=perm,
              blocks=blocks)
    launches = pgs.KERNEL.launches
    torch.testing.assert_close(pgs.pgs_bj(*ops, **kw),
                               pgs.pgs_bj_reference(*ops, **kw), rtol=0, atol=0)
    assert pgs.KERNEL.launches == launches


def test_kernel_wrapper_refuses_cpu_tensors(problems):
    """The wrapper launches on CUDA tensors or raises: no fallback."""
    ops = tuple(map(torch.from_numpy, problems["random"]))
    perm, blocks = pgs.plan_contact_blocks(port_solo12(), 4)
    with pytest.raises(ValueError, match="is on cpu"):
        pgs.KERNEL(*ops, iterations=6, cfm=1e-4, omega=0.9,
                   contact_perm=perm, blocks=blocks)
