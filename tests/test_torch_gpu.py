"""The hand-written CUDA kernels (block-Jacobi and serial Gauss-Seidel PGS,
and the substep's dynamics, contact rows and post stage) against their
plain PyTorch versions, on a card.

These tests need a CUDA card and skip without one (the kernels have no CPU
mode). They import nothing of JAX, so they run on a machine without it:

  python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerance: the JAX package's kernel-vs-reference bound, rtol 2e-4 /
atol 2e-5 x max|lam|: the kernel and the plain version run the same float32
arithmetic in the same block order and differ only in summation order
(the kernels work in the space of the dofs and never form A; fused
multiply-adds; batched contractions). A whole control step on the
card against the same step on the CPU is held to the tolerances of
tests/test_torch_engine.py. The substep kernels are held to
``measure.STAGE_TOL`` (the tolerances tests/test_lanes.py holds the JAX
lanes layout to), the post kernel to ``measure.compare_post`` (the
tolerances tests/test_torch_post.py states).
"""

import numpy as np
import pytest
import torch

from cat_tpu_torch.models.solo12 import SOLO12_KD, SOLO12_KP, solo12_model
from cat_tpu_torch.ops import pgs
from cat_tpu_torch.sim import engine, terrain
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


# ---------------------------------------------------------------------------
# the serial Gauss-Seidel kernel (pgs_gs.cu)
# ---------------------------------------------------------------------------

GS = dict(iterations=5, cfm=1e-4)


def _rough_raw_engine(device, n, spread=1.2, dz=0.3, joints=0.2):
    """The raw engine (default SolverParams: GS-5) on a rough terrain with n
    Solo12s around the patch centres (within +-spread m), dz above the
    surface, joints perturbed by up to +-joints rad."""
    model = solo12_model()
    terr = terrain.generate_rough(rows=4, cols=4, patch_m=4.0, seed=0)
    step = engine.make_batched_step(
        model, engine.EngineParams(kp=SOLO12_KP, kd=SOLO12_KD), terrain=terr,
        device=device)
    rng = np.random.default_rng(4)
    xy = np.stack([terr.patch_origin(i % 4, i // 4 % 4) for i in range(n)])
    xy = (xy + rng.uniform(-spread, spread, (n, 2))).astype(np.float32)
    qpos = np.tile(model.default_qpos(), (n, 1)).astype(np.float32)
    qpos[:, 0:2] = xy
    qpos[:, 2] = terrain.height_at(terr, torch.from_numpy(xy)).numpy() + dz
    qpos[:, 7:] += rng.uniform(-joints, joints, (n, model.nj)).astype(np.float32)
    s = engine.make_batched_init(model, n, device)._replace(
        qpos=torch.from_numpy(qpos).to(device))
    return model, step, s


def _gs_physical_problem(device, n=256):
    model, step, s = _rough_raw_engine(device, n)
    target = torch.as_tensor(model.default_qpos_joints, dtype=torch.float32,
                             device=device).expand(n, model.nj)
    mu = torch.full((n,), 0.9, device=device)
    for _ in range(5):
        s = step(s, target, mu)
    _, ops = step.contact_problem(s, target, mu)
    return ops, step.pgs_kwargs


@pytest.mark.gpu
def test_gs_kernel_matches_plain_on_physical_problems(cuda):
    ops, kw = _gs_physical_problem(cuda)
    assert kw["row_dofs"] is not None and float(ops[4].sum()) > 0
    launches = pgs.GS_KERNEL.launches
    lam = pgs.pgs_gs(*ops, **kw)
    torch.cuda.synchronize()
    assert pgs.GS_KERNEL.launches == launches + 1
    _check(lam, pgs.pgs_gs_reference(*ops, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("nc,nv,n", [(6, 10, 37), (36, 18, 1000), (64, 18, 64)])
def test_gs_kernel_matches_plain_on_random_problems(cuda, nc, nv, n):
    ops = tuple(t.to(cuda) for t in _random_problem(n, nc, nv, seed=nc + 1))
    lam = pgs.pgs_gs(*ops, **GS)
    torch.cuda.synchronize()
    _check(lam, pgs.pgs_gs_reference(*ops, **GS))
    # a sparse dof table the dense random rows do not have is not exact:
    # the kernel must take the table it is given
    rows = tuple(tuple(range(nv - 1)) for _ in range(3 * nc))
    lam_cut = pgs.pgs_gs(*ops, row_dofs=rows, **GS)
    E_cut = ops[0].clone()
    E_cut[..., nv - 1] = 0.0
    _check(lam_cut, pgs.pgs_gs_reference(E_cut, *ops[1:], **GS))


@pytest.mark.gpu
def test_gs_kernel_rejects_bad_operands(cuda):
    ops = [t.to(cuda) for t in _random_problem(8, 36, 18, seed=1)]
    bad = list(ops)
    bad[0] = ops[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        pgs.GS_KERNEL(*bad, **GS)
    bad = list(ops)
    bad[5] = ops[5].double()
    with pytest.raises(TypeError):
        pgs.GS_KERNEL(*bad, **GS)
    bad = list(ops)
    bad[3] = ops[3].cpu()
    with pytest.raises(ValueError, match="is on cpu"):
        pgs.GS_KERNEL(*bad, **GS)
    with pytest.raises(ValueError, match="row_dofs"):
        pgs.GS_KERNEL(*ops, row_dofs=((0, 18),) * 108, **GS)
    too_many = [t.to(cuda) for t in _random_problem(2, 65, 18, seed=2)]
    with pytest.raises(ValueError, match="contacts"):
        pgs.GS_KERNEL(*too_many, **GS)


@pytest.mark.gpu
def test_raw_engine_on_rough_terrain_on_the_card_matches_the_cpu(cuda):
    """Ten raw-engine control steps (GS-5) on rough terrain through the
    kernel against the same steps through the plain version on the CPU;
    the kernel runs 4 times a step.

    The robots start standing on the flat spawn pads (feet on the ground,
    the height a drop settles at), so the contact set holds. At a landing
    the step is discontinuous in the state (a contact switches on at
    phi = 0): there ulp-level differences of the state move joint
    velocities by more than these bounds on one device alone
    (tests/test_torch_rough.py::test_one_step_sensitivity_to_ulp_changes),
    and no two float orders of the same physics agree to them."""
    n = 64
    states, launches = {}, pgs.GS_KERNEL.launches
    for dev in ("cpu", cuda):
        model, step, s = _rough_raw_engine(dev, n, spread=0.15, dz=0.2892,
                                           joints=0.0)
        mu = torch.full((n,), 0.9, device=dev)
        for i in range(10):
            target = torch.from_numpy(
                np.tile(model.default_qpos_joints, (n, 1)).astype(np.float32)
                + np.float32(0.1 * np.sin(0.3 * i))).to(dev)
            s = step(s, target, mu)
        states[str(dev)] = s
    assert pgs.GS_KERNEL.launches == launches + 40
    a, b = states["cpu"], states[str(cuda)]
    assert float(a.lam.abs().max()) > 1e-3          # on the ground
    np.testing.assert_allclose(b.qpos.cpu().numpy(), a.qpos.numpy(), atol=2e-3)
    np.testing.assert_allclose(b.qvel.cpu().numpy(), a.qvel.numpy(), atol=2e-2)
    np.testing.assert_allclose(b.forces.cpu().numpy(), a.forces.numpy(),
                               rtol=0.05, atol=0.05)


# ---------------------------------------------------------------------------
# both kernels at other shapes and staging paths
# ---------------------------------------------------------------------------


def _box_problem(device, n=64):
    """Contact problems of the raw engine (GS-5) on the joint-less box (4
    contacts, 6 dofs) on the 25 degree slope, captured after 10 control
    steps, friction from 1e-3 (sliding) to 1.0 (sticking)."""
    from cat_tpu_torch.models.box import box_model, on_slope_qpos, slope_terrain

    model = box_model()
    step = engine.make_batched_step(model, engine.EngineParams(),
                                    terrain=slope_terrain(25.0), device=device)
    s = engine.make_batched_init(model, n, device)._replace(
        qpos=torch.from_numpy(on_slope_qpos(25.0, n)).to(device))
    mu = torch.linspace(1e-3, 1.0, n, device=device)
    target = torch.zeros(n, 0, device=device)
    for _ in range(10):
        s = step(s, target, mu)
    _, ops = step.contact_problem(s, target, mu)
    return model, ops, step.pgs_kwargs


@pytest.mark.gpu
def test_kernels_match_plain_on_the_box(cuda):
    model, ops, gs_kw = _box_problem(cuda)
    assert float(ops[4].sum()) > 0
    lam = pgs.pgs_gs(*ops, **gs_kw)
    torch.cuda.synchronize()
    _check(lam, pgs.pgs_gs_reference(*ops, **gs_kw))
    perm, blocks = pgs.plan_contact_blocks(model, 2)
    kw = dict(iterations=6, cfm=1e-4, omega=0.9, contact_perm=perm,
              blocks=blocks)
    lam = pgs.pgs_bj(*ops, **kw)
    torch.cuda.synchronize()
    _check(lam, pgs.pgs_bj_reference(*ops, **kw))


@pytest.mark.gpu
def test_kernels_match_plain_at_go2_shape(cuda):
    """28 contacts (Go2's spheres, no self-collision pairs), 18 dofs."""
    ops = tuple(t.to(cuda) for t in _random_problem(1000, 28, 18, seed=28))
    lam = pgs.pgs_gs(*ops, **GS)
    torch.cuda.synchronize()
    _check(lam, pgs.pgs_gs_reference(*ops, **GS))
    kw = dict(iterations=6, cfm=1e-4, omega=0.9,
              contact_perm=tuple(range(27, -1, -1)),
              blocks=tuple((7 * k, 7) for k in range(4)))
    lam = pgs.pgs_bj(*ops, **kw)
    torch.cuda.synchronize()
    _check(lam, pgs.pgs_bj_reference(*ops, **kw))


@pytest.mark.gpu
def test_kernels_refuse_33_dofs(cuda):
    ops = [t.to(cuda) for t in _random_problem(4, 6, 33, seed=3)]
    with pytest.raises(ValueError, match="dofs"):
        pgs.GS_KERNEL(*ops, **GS)
    with pytest.raises(ValueError, match="dofs"):
        pgs.KERNEL(*ops, **_plan("gauss_seidel", 6))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["pgs_bj", "pgs_gs"])
def test_staging_paths_agree(cuda, name):
    """The lanes' copy of E and W that are not 16-byte aligned computes the
    same bits as the bulk copy: each env's arithmetic is the same."""
    ops = _physical_problem(cuda)
    kern, kw = ((pgs.KERNEL, _plan("production", 36)) if name == "pgs_bj"
                else (pgs.GS_KERNEL, GS))
    bulk = kern(*ops, **kw)
    # E and W 4 bytes past a 16-byte boundary: no bulk copy
    shifted = []
    for t in ops[:2]:
        buf = torch.empty(t.numel() + 1, device=cuda)
        buf[1:] = t.reshape(-1)
        shifted.append(buf[1:].view(t.shape))
    assert shifted[0].data_ptr() % 16
    lanes = kern(*shifted, *ops[2:], **kw)
    torch.cuda.synchronize()
    assert torch.equal(bulk, lanes)
    ref = (pgs.pgs_bj_reference if name == "pgs_bj" else pgs.pgs_gs_reference)
    _check(bulk, ref(*ops, **kw))


# ---------------------------------------------------------------------------
# Go2 and the training run's lifecycle on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_kernels_match_plain_on_go2_physical_problems(cuda):
    """Both kernels on problems captured from Go2 (nc 28, nv 18): pgs_bj's
    from its flat env after 4 control steps, pgs_gs's from its raw engine
    (GS-5) dropped from the default pose for 4 control steps."""
    from cat_tpu_torch.models.go2 import GO2_KD, GO2_KP, go2_model
    from cat_tpu_torch.tasks import go2_flat

    n = 256
    env = go2_flat.make_env(n, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    es = env.init(gen, n)
    for _ in range(4):
        es = env.step(es, 0.3 * torch.randn(n, 12, generator=gen, device=cuda),
                      gen)[0]
    target = env.default_joint_pos_task[env.m2t].expand(n, 12)
    _, ops = env.engine.contact_problem(es.sim, target, es.mu)
    assert ops[0].shape[1:] == (84, 18)
    _check(pgs.pgs_bj(*ops, **env.engine.pgs_kwargs),
           pgs.pgs_bj_reference(*ops, **env.engine.pgs_kwargs))

    model = go2_model()
    step = engine.make_batched_step(
        model, engine.EngineParams(kp=GO2_KP, kd=GO2_KD), device=cuda)
    s = engine.make_batched_init(model, n, cuda)
    target = torch.as_tensor(model.default_qpos_joints, dtype=torch.float32,
                             device=cuda).expand(n, 12)
    mu = torch.ones(n, device=cuda)
    for _ in range(4):
        s = step(s, target, mu)
    _, ops = step.contact_problem(s, target, mu)
    assert step.solve is pgs.pgs_gs
    _check(pgs.pgs_gs(*ops, **step.pgs_kwargs),
           pgs.pgs_gs_reference(*ops, **step.pgs_kwargs))


@pytest.mark.gpu
def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """A card run's checkpoint restores bit for bit into a fresh trainer
    (fused Adam, CUDA generators), and the restored run steps on."""
    from cat_tpu_torch import train
    from cat_tpu_torch.rl import checkpoint

    argv = ["--task", "Go2-CaT-Flat-v0", "--agent", "rl_games",
            "--num_envs", "64", "--override", "num_steps=4",
            "minibatch_size=128"]
    tr = train.Trainer(train.parse_args(argv))
    assert tr.ppo.opt.param_groups[0]["fused"]
    tr.train_iteration()
    path = tr.save(str(tmp_path / "ckpt_1"))
    fresh = train.Trainer(train.parse_args(argv))
    fresh.restore(path)
    assert checkpoint.mismatches(
        checkpoint.load(path),
        checkpoint.state_dict(fresh.ppo, fresh.es, fresh.generators)) == []
    assert fresh.ppo.lr.device.type == "cuda"
    metrics = fresh.train_iteration()
    assert all(np.isfinite(v) for v in metrics.values())
    assert fresh.ppo.iteration == 2


@pytest.mark.gpu
def test_exported_torchscript_matches_the_actor_on_the_card(cuda, tmp_path):
    from cat_tpu_torch.rl.convert import actor_from_bundle
    from cat_tpu_torch.rl.export import export_policy
    from cat_tpu_torch.rl.networks import ActorCritic

    sd, mean, var = actor_from_bundle(dict(np.load(
        "runs/go2_r4/policy_params.npz")))
    net = ActorCritic(45, 12).to(cuda)
    net.load_state_dict(sd, strict=False)
    export_policy(net, mean, var, str(tmp_path))
    policy = torch.jit.load(str(tmp_path / "policy.pt"), map_location=cuda)
    obs = torch.randn(1024, 45, generator=torch.Generator().manual_seed(0))
    obs = obs.to(cuda)
    with torch.no_grad():
        want = net.actor((obs - mean.to(cuda)) / torch.sqrt(var.to(cuda) + 1e-8))
        got = policy(obs)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_grouped_iteration_under_nccl_equals_the_ungrouped(cuda, tmp_path):
    """One iteration through the data-parallel code path, a group of one
    process under NCCL (every collective runs on the card), leaves the
    parameters the one-card path leaves, and launches the kernel as it."""
    from cat_tpu_torch import train
    from cat_tpu_torch.parallel import distributed

    argv = ["--num_envs", "64", "--override", "num_steps=4",
            "minibatch_size=64"]
    alone = train.Trainer(train.parse_args(argv))
    alone.train_iteration()
    dist = distributed.maybe_initialize(1, f"file://{tmp_path}/store", 1, 0)
    try:
        assert torch.distributed.get_backend() == "nccl"
        grouped = train.Trainer(train.parse_args(argv), dist)
        pgs.KERNEL.launches = 0
        metrics = grouped.train_iteration()
        torch.cuda.synchronize()
        assert pgs.KERNEL.launches == 4 * 4
    finally:
        distributed.close(dist)
    assert all(np.isfinite(v) for v in metrics.values())
    for (name, a), b in zip(alone.ppo.net.state_dict().items(),
                            grouped.ppo.net.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=0, msg=name)


# ---------------------------------------------------------------------------
# the substep kernels (substep_dyn.cu, contact_rows.cu)
# ---------------------------------------------------------------------------

N_SUBSTEP = 4096


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["solo12-plane", "solo12-rough",
                                  "solo12-com", "solo12-fast", "go2", "box"])
def test_substep_kernels_match_plain(cuda, name):
    """Each kernel against its plain version on the same inputs at
    N = 4096 (tests/_substep_cases.py), output by output, within
    ``measure.STAGE_TOL`` (``HFIELD_ATOL`` for a heightfield's rows); the
    contact kernel is fed the plain dynamics stage's outputs. On the heightfield the contacts whose normal one
    rounding may switch (``measure.ambiguous_contacts``) are left out, and
    are at most 2% of them. One launch each."""
    from _substep_cases import make_case, torch_inputs
    from cat_tpu_torch import measure
    from cat_tpu_torch.ops import substep
    from cat_tpu_torch.ops.substep import CONTACT_OUTPUTS, DYN_OUTPUTS
    from cat_tpu_torch.sim.dynamics import ModelTensors

    case = make_case(name, N_SUBSTEP)
    mt = ModelTensors.build(case.model, cuda)
    args = torch_inputs(case, cuda)
    launches = (substep.DYN_KERNEL.launches, substep.CONTACT_KERNEL.launches)
    kern = substep.substep_dynamics(mt, case.params, *args)
    plain = engine.dynamics_stage(mt, case.params, *args)
    tau_j, v_free, Minv, kin = plain
    kern_c = substep.contact_rows(mt, case.terrain, kin, Minv, v_free)
    plain_c = engine.contact_stage(mt, case.terrain, kin, Minv, v_free)
    torch.cuda.synchronize()
    assert (substep.DYN_KERNEL.launches - launches[0],
            substep.CONTACT_KERNEL.launches - launches[1]) == (1, 1)
    left_out = measure.ambiguous_contacts(mt, case.terrain, kin)
    assert int(left_out.sum()) <= 0.02 * left_out.numel()
    flat = lambda out: (*out[:3], *out[3])           # noqa: E731
    bad = {}
    for names, k_out, p_out, keep in (
            (DYN_OUTPUTS, flat(kern), flat(plain), None),
            (CONTACT_OUTPUTS, kern_c, plain_c, ~left_out)):
        for out, a, b in zip(names, k_out, p_out):
            if a is None or b is None:
                assert a is None and b is None, out
                continue
            err, rel, outside = measure.stage_disagreement(
                out, a, b, keep, hfield=case.terrain.kind == "hfield")
            if outside:
                bad[out] = (outside, err, rel)
    assert bad == {}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["solo12-rough", "solo12-fast", "box"])
def test_substep_kernels_are_deterministic(cuda, name):
    """Two launches of each kernel on the same inputs give the same outputs
    bit for bit (a fixed summation order, no atomics)."""
    from _substep_cases import make_case, torch_inputs
    from cat_tpu_torch.ops import substep
    from cat_tpu_torch.sim.dynamics import ModelTensors

    case = make_case(name, N_SUBSTEP)
    mt = ModelTensors.build(case.model, cuda)
    args = torch_inputs(case, cuda)
    dyn = [substep.substep_dynamics(mt, case.params, *args) for _ in range(2)]
    con = [substep.contact_rows(mt, case.terrain, d[3], d[2], d[1])
           for d in dyn]
    torch.cuda.synchronize()
    flat = lambda out: (*out[:3], *out[3])           # noqa: E731
    for a, b in ((flat(dyn[0]), flat(dyn[1])), (con[0], con[1])):
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["lanes", "vmap"])
def test_graph_equals_eager_on_each_layout(cuda, layout):
    """The control step's CUDA graph equals the eager loop bit for bit on
    both layouts (the raw engine on a heightfield, with CoM offsets); on
    "lanes" each of the substep's three kernels launches once a substep,
    replayed or not, and on "vmap" never."""
    from cat_tpu_torch.ops import substep

    model, step, s = _rough_raw_engine(cuda, 512)
    eng = step._replace(layout=layout, graphs={})
    target = torch.as_tensor(model.default_qpos_joints, dtype=torch.float32,
                             device=cuda).expand(512, model.nj).contiguous()
    mu = torch.full((512,), 0.9, device=cuda)
    com = 0.02 * torch.ones(512, model.nbody, 3, device=cuda)
    kernels = [k for _, k in substep.SUBSTEP_KERNELS]
    before = [k.launches for k in kernels]
    eng(s, target, mu, com)                         # the warm-up, eager
    e = g = s
    for _ in range(3):
        e = eng._eager(e, target, mu, com)
        g = eng(g, target, mu, com)                 # capture, replays
    torch.cuda.synchronize()
    for f, a, b in zip(engine.SimState._fields, e, g):
        assert torch.equal(a, b), f
    per = 7 * eng.params.decimation if layout == "lanes" else 0
    assert [k.launches - b for k, b in zip(kernels, before)] == [per] * 3


@pytest.mark.gpu
def test_lanes_and_vmap_control_steps_agree_on_the_card(cuda):
    """One control step of the raw engine on the heightfield through the
    kernels and through the plain stages, from the same state: within the
    chained-step tolerances of tests/test_torch_engine.py."""
    model, step, s = _rough_raw_engine(cuda, 512)
    target = torch.as_tensor(model.default_qpos_joints, dtype=torch.float32,
                             device=cuda).expand(512, model.nj)
    mu = torch.full((512,), 0.9, device=cuda)
    out = {lay: step._replace(layout=lay, graphs={})._eager(s, target, mu)
           for lay in ("lanes", "vmap")}
    a, b = out["vmap"], out["lanes"]
    torch.testing.assert_close(b.qpos, a.qpos, rtol=0, atol=2e-3)
    torch.testing.assert_close(b.qvel, a.qvel, rtol=0, atol=2e-2)


# ---------------------------------------------------------------------------
# the post stage's kernel (substep_post.cu)
# ---------------------------------------------------------------------------


def _post_problem(device, name, n=N_SUBSTEP):
    """(mt, params, state, tau_j, v_free, W, lam, frame) of a case of
    tests/_substep_cases.py on the card: its contact problem through the
    kernels, solved by the engine's solve, and a seeded state around it
    (force history, air and contact times, touchdown)."""
    from _substep_cases import make_case, torch_inputs

    case = make_case(name, n)
    m = case.model
    eng = engine.make_batched_step(m, case.params, terrain=case.terrain,
                                   device=device)
    qpos, qvel, target, com = torch_inputs(case, device)
    rng = np.random.default_rng(1)
    nf = len(m.foot_report_ids)

    def dev(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    s = engine.make_batched_init(m, n, device)._replace(
        qpos=qpos, qvel=qvel,
        force_hist=dev(rng.normal(0.0, 5.0, (n, 9 * m.nreport))),
        current_air_time=dev(rng.integers(0, 3, (n, nf)) * case.params.dt),
        last_air_time=dev(rng.uniform(0.0, 0.5, (n, nf))),
        current_contact_time=dev(rng.integers(0, 3, (n, nf))
                                 * case.params.dt),
        last_contact_time=dev(rng.uniform(0.0, 0.5, (n, nf))),
        touchdown=dev(rng.integers(0, 2, (n, nf)), torch.bool))
    mu = dev(rng.uniform(0.5, 1.2, n))
    (tau_j, v_free, W, frame), ops = eng.contact_problem(s, target, mu, com)
    lam = eng.solve(*ops, **eng.pgs_kwargs)
    return eng.mt, case.params, s, tau_j, v_free, W, lam, frame


@pytest.mark.gpu
@pytest.mark.parametrize("label", ["solved", "on-limits", "at-threshold",
                                   "zero-lam"])
@pytest.mark.parametrize("name", ["solo12-plane", "solo12-rough", "go2",
                                  "box"])
def test_post_kernel_matches_plain(cuda, name, label):
    """The post kernel against post_stage at N = 4096 on each case's
    solved problem and on the three contrived inputs of
    ``measure.post_contrived`` (joints exactly on their limits, feet within
    1e-3 N of the contact threshold, no impulse): within
    ``measure.compare_post``, only decisions within 4 float32 spacings of
    their limit flipped; one launch; lam and the torque pass through."""
    from cat_tpu_torch import measure
    from cat_tpu_torch.ops import substep

    mt, params, s, tau_j, v_free, W, lam, frame = _post_problem(cuda, name)
    if label != "solved":
        s, lam = measure.post_contrived(mt, params, s, lam)[label]
    before = substep.POST_KERNEL.launches
    out = substep.substep_post(mt, params, s, tau_j, v_free, W, lam, frame)
    ref = engine.post_stage(mt, params, s, tau_j, v_free, W, lam, frame)
    torch.cuda.synchronize()
    assert substep.POST_KERNEL.launches == before + 1
    assert out.lam is lam and out.applied_torque is tau_j
    cmp = measure.compare_post(mt, params, s, v_free, W, lam, out, ref)
    assert cmp.ok, cmp.text
    assert len(cmp.flips) <= max(8, cmp.near), cmp.text


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["solo12-rough", "box"])
def test_post_kernel_is_deterministic(cuda, name):
    """Two launches on the same inputs give the same outputs bit for bit
    (a fixed summation order, no atomics)."""
    from cat_tpu_torch.ops import substep

    args = _post_problem(cuda, name)
    a, b = (substep.substep_post(*args) for _ in range(2))
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_post_kernel_takes_the_state_as_held(cuda):
    """Non-contiguous state fields (a slice of a wider buffer) give the
    same result as contiguous ones: the wrapper makes them contiguous."""
    from cat_tpu_torch.ops import substep

    mt, params, s, tau_j, v_free, W, lam, frame = _post_problem(
        cuda, "solo12-plane", 256)
    wide = torch.cat([s.qpos, torch.zeros_like(s.qpos)], dim=1)
    strided = s._replace(qpos=wide[:, :s.qpos.shape[1]])
    assert not strided.qpos.is_contiguous()
    a = substep.substep_post(mt, params, strided, tau_j, v_free, W, lam,
                             frame)
    b = substep.substep_post(mt, params, s, tau_j, v_free, W, lam, frame)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["solo12-plane", "go2", "box"])
def test_lanes_and_vmap_control_steps_agree_on_each_model(cuda, name):
    """One control step through the four kernels a substep ("lanes")
    against the plain stages and post_stage ("vmap") from the same state:
    within the chained-step tolerances of tests/test_torch_engine.py."""
    from _substep_cases import make_case, torch_inputs

    case = make_case(name, 512)
    step = engine.make_batched_step(case.model, case.params,
                                    terrain=case.terrain, device=cuda)
    qpos, qvel, target, _ = torch_inputs(case, cuda)
    s = engine.make_batched_init(case.model, 512, cuda)._replace(
        qpos=qpos, qvel=0.2 * qvel)
    mu = torch.full((512,), 0.9, device=cuda)
    out = {lay: step._replace(layout=lay, graphs={})._eager(s, target, mu)
           for lay in ("lanes", "vmap")}
    a, b = out["vmap"], out["lanes"]
    torch.testing.assert_close(b.qpos, a.qpos, rtol=0, atol=2e-3)
    torch.testing.assert_close(b.qvel, a.qvel, rtol=0, atol=2e-2)
