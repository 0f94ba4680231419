"""The hand-written CUDA kernel against its plain PyTorch version, on a card.

These tests need a CUDA card and skip without one (the kernel has no CPU
mode). They import nothing of JAX, so they run on a machine without it:

  python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerance: the JAX package's kernel-vs-reference bound, rtol 2e-4 /
atol 2e-5 x max|lam|: the kernel and the plain version run the same float32
arithmetic in the same block order and differ only in summation order
(fused multiply-adds, batched contractions). A whole control step on the
card against the same step on the CPU is held to the tolerances of
tests/test_torch_engine.py.
"""

import numpy as np
import pytest
import torch

from cat_tpu_torch.models.solo12 import solo12_model
from cat_tpu_torch.ops import pgs
from cat_tpu_torch.sim import engine
from cat_tpu_torch.sim.solver import SolverParams

RTOL, ATOL_REL = 2e-4, 2e-5
BJ = dict(structure="bj", bj_blocks=4, omega=0.9, iterations=6)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _random_problem(n, nc, nv, seed):
    rng = np.random.default_rng(seed)
    E = rng.normal(size=(n, 3 * nc, nv))
    L = rng.normal(size=(n, nv, nv))
    M = L @ np.swapaxes(L, 1, 2) + nv * np.eye(nv)
    W = np.linalg.solve(M, np.swapaxes(E, 1, 2))
    b = np.einsum("nrk,nk->nr", E, rng.normal(size=(n, nv)))
    phi = rng.uniform(-0.01, 0.01, size=(n, nc))
    bias = np.maximum(40.0 * np.minimum(phi + 0.002, 0.0), -2.0)
    active = (phi < 0.0).astype(float)
    mu = rng.uniform(0.5, 1.25, size=n)
    lam0 = rng.uniform(0, 0.05, size=(n, 3 * nc))
    return tuple(torch.tensor(x, dtype=torch.float32)
                 for x in (E, W, b, bias, active, mu, lam0))


def _physical_problem(device, n=256):
    from cat_tpu_torch.tasks.solo12_flat import make_env

    env = make_env(n, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    es = env.init(gen, n)
    for _ in range(4):
        es = env.step(es, 0.3 * torch.randn(n, 12, generator=gen,
                                            device=device), gen)[0]
    target = env.default_joint_pos_task[env.m2t].expand(n, 12)
    _, ops = env.engine.contact_problem(es.sim, target, es.mu)
    return ops


def _plan(name, nc):
    if name == "production":
        perm, blocks = pgs.plan_contact_blocks(solo12_model(), 4)
        return dict(iterations=6, cfm=1e-4, omega=0.9, contact_perm=perm,
                    blocks=blocks)
    if name == "jacobi":
        return dict(iterations=10, cfm=1e-4, omega=0.5,
                    contact_perm=tuple(range(nc)), blocks=((0, nc),))
    return dict(iterations=5, cfm=1e-4, omega=1.0,       # Gauss-Seidel
                contact_perm=tuple(range(nc)),
                blocks=tuple((i, 1) for i in range(nc)))


def _check(lam, ref):
    lam, ref = lam.cpu().numpy(), ref.cpu().numpy()
    assert np.isfinite(lam).all()
    np.testing.assert_allclose(lam, ref, rtol=RTOL,
                               atol=ATOL_REL * np.abs(ref).max())


@pytest.mark.gpu
@pytest.mark.parametrize("plan", ["production", "jacobi", "gauss_seidel"])
def test_kernel_matches_plain_on_physical_problems(cuda, plan):
    ops = _physical_problem(cuda)
    kw = _plan(plan, 36)
    launches = pgs.KERNEL.launches
    lam = pgs.pgs_bj(*ops, **kw)
    torch.cuda.synchronize()
    assert pgs.KERNEL.launches == launches + 1
    _check(lam, pgs.pgs_bj_reference(*ops, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("nc,nv,n", [(36, 18, 1000), (6, 10, 37), (64, 18, 64)])
def test_kernel_matches_plain_on_random_problems(cuda, nc, nv, n):
    ops = tuple(t.to(cuda) for t in _random_problem(n, nc, nv, seed=nc))
    if nc == 6:
        kw = dict(iterations=8, cfm=1e-4, omega=0.8,
                  contact_perm=(3, 0, 4, 1, 5, 2), blocks=((0, 3), (3, 3)))
    else:
        kw = _plan("jacobi" if nc == 64 else "production", nc)
    lam = pgs.pgs_bj(*ops, **kw)
    torch.cuda.synchronize()
    _check(lam, pgs.pgs_bj_reference(*ops, **kw))


@pytest.mark.gpu
def test_kernel_rejects_bad_operands(cuda):
    ops = [t.to(cuda) for t in _random_problem(8, 36, 18, seed=1)]
    kw = _plan("production", 36)
    bad = list(ops)
    bad[1] = ops[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        pgs.KERNEL(*bad, **kw)
    bad = list(ops)
    bad[2] = ops[2].double()
    with pytest.raises(TypeError):
        pgs.KERNEL(*bad, **kw)
    bad = list(ops)
    bad[6] = ops[6].cpu()
    with pytest.raises(ValueError, match="is on cpu"):
        pgs.KERNEL(*bad, **kw)
    with pytest.raises(ValueError, match="permutation"):
        pgs.KERNEL(*ops, **dict(kw, contact_perm=(0,) * 36))
    too_many = [t.to(cuda) for t in _random_problem(2, 65, 18, seed=2)]
    with pytest.raises(ValueError, match="contacts"):
        pgs.KERNEL(*too_many, **_plan("jacobi", 65))


@pytest.mark.gpu
def test_control_step_on_the_card_matches_the_cpu(cuda):
    """Ten control steps through the kernel against the same steps through
    the plain version on the CPU; the kernel runs 4 times a step."""
    model = solo12_model()
    params = engine.EngineParams(solver=SolverParams(**BJ))
    rng = np.random.default_rng(0)
    n = 64
    qpos = np.tile(model.default_qpos(), (n, 1)).astype(np.float32)
    qpos[:, 7:] += rng.uniform(-0.3, 0.3, (n, model.nj)).astype(np.float32)
    mu = torch.tensor(rng.uniform(0.6, 1.2, n), dtype=torch.float32)
    states, launches = {}, pgs.KERNEL.launches
    for dev in ("cpu", cuda):
        step = engine.make_batched_step(model, params, device=dev)
        s = engine.make_batched_init(model, n, dev)._replace(
            qpos=torch.from_numpy(qpos).to(dev))
        for i in range(10):
            target = torch.from_numpy(
                np.tile(model.default_qpos_joints, (n, 1)).astype(np.float32)
                + np.float32(0.1 * np.sin(0.3 * i))).to(dev)
            s = step(s, target, mu.to(dev))
        states[str(dev)] = s
    assert pgs.KERNEL.launches == launches + 40
    a, b = states["cpu"], states[str(cuda)]
    np.testing.assert_allclose(b.qpos.cpu().numpy(), a.qpos.numpy(), atol=2e-3)
    np.testing.assert_allclose(b.qvel.cpu().numpy(), a.qvel.numpy(), atol=2e-2)
    np.testing.assert_allclose(b.forces.cpu().numpy(), a.forces.numpy(),
                               rtol=0.05, atol=0.05)
