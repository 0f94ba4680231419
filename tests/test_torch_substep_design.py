"""The arithmetic of the substep kernels' design (cat_tpu_torch/ops/csrc/
substep_dyn.cu, contact_rows.cu), emulated in float64 PyTorch on the CPU
and held against the plain stages (sim/engine.py dynamics_stage,
contact_stage, float32) on tests/_substep_cases.py's inputs:

  * M by the composite-rigid-body rule: each body's mass, first and second
    moments about the base origin o0 summed over each body's subtree (the
    anc masks), M[k][l] = w_k . n_l + v_k . f_l for the deeper dof l of two
    on one chain, 0 across legs;
  * C by the backward pass of Newton-Euler: each body's bias force and its
    moment about o0 summed over the subtree, C_l = v_l . F + w_l . N;
  * M^-1 = H^T H + blockdiag(0, D^-1), H = L^-1 [I, -W], L the Cholesky
    factor of the Schur complement (the Cholesky inverse for the box);
  * the contact rows: E zero off each row's nonzero dofs
    (pgs.contact_row_dofs), so W and b summed over those dofs alone.

Tolerances: M and C as tests/test_torch_substep.py holds the stages' M and
C to the JAX package's (rtol 1e-4, atol 1e-5 and 1e-4); M^-1, W and b
``measure.STAGE_TOL``. Then the kernels' build flags, the ptxas log reader
and ``measure.substep_counts``.
"""

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from _substep_cases import CASES, make_case, torch_inputs
from cat_tpu_torch import measure
from cat_tpu_torch.models.go2 import go2_model
from cat_tpu_torch.models.solo12 import solo12_model
from cat_tpu_torch.ops import build, pgs, substep
from cat_tpu_torch.sim import dynamics as td
from cat_tpu_torch.sim import engine as tem

N = 6


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _emulate_dynamics(mt, kin, qvel):
    """(M, C) by the kernel's composite sums, float64."""
    m = mt.model
    nb, nv = m.nbody, m.nv
    f64 = lambda t: t.double()                       # noqa: E731
    R, o, w, x = f64(kin.R), f64(kin.o), f64(kin.omega), f64(kin.x_com)
    aw = f64(kin.a_w)
    n = R.shape[0]
    # the bias recursion, as the tree walk carries it
    alpha = [None] * nb
    a_o = [None] * nb
    alpha[0] = torch.zeros(n, 3, dtype=torch.float64)
    a_o[0] = f64(mt.base_acc).expand(n, 3)
    for b in range(1, nb):
        p = int(m.parent[b])
        wq = f64(qvel[:, 5 + b, None]) * aw[:, b - 1]
        dv = o[:, b] - o[:, p]
        alpha[b] = alpha[p] + _cross(w[:, p], wq)
        a_o[b] = (a_o[p] + _cross(alpha[p], dv)
                  + _cross(w[:, p], _cross(w[:, p], dv)))
    alpha, a_o = torch.stack(alpha, 1), torch.stack(a_o, 1)
    I_w = R @ f64(mt.inertia) @ R.transpose(-1, -2)
    mass = f64(mt.mass)[None, :, None]
    r = x - o
    F = mass * (a_o + _cross(alpha, r) + _cross(w, _cross(w, r)))
    Nt = ((I_w @ alpha[..., None])[..., 0]
          + _cross(w, (I_w @ w[..., None])[..., 0]))
    d = x - o[:, :1]
    eye = torch.eye(3, dtype=torch.float64)
    J = I_w + mass[..., None] * ((d * d).sum(-1)[..., None, None] * eye
                                 - d[..., :, None] * d[..., None, :])
    own = dict(m=mass[..., 0].expand(n, nb), h=mass * d, J=J, F=F,
               N=Nt + _cross(d, F))
    # each body's subtree: every body for the base, else those whose chain
    # holds its joint
    anc = torch.as_tensor(m.ancestor_mask(), dtype=torch.float64)
    member = torch.ones(nb, nb, dtype=torch.float64)     # [b, c]
    member[1:] = anc.T
    cmp = {k: torch.einsum("bc,nc...->nb...", member, v)
           for k, v in own.items()}
    # each dof's motion (w, v) and the subtree it moves
    wl = torch.zeros(n, nv, 3, dtype=torch.float64)
    vl = torch.zeros(n, nv, 3, dtype=torch.float64)
    for k in range(3):
        vl[:, k, k] = 1.0
    wl[:, 3:6] = R[:, 0].transpose(-1, -2)
    wl[:, 6:] = aw
    vl[:, 6:] = _cross(o[:, 1:] - o[:, :1], aw)
    cb = [0] * 6 + list(range(1, nb))
    c = {k: v[:, cb] for k, v in cmp.items()}
    f = c["m"][..., None] * vl + _cross(wl, c["h"])
    nl = (c["J"] @ wl[..., None])[..., 0] + _cross(c["h"], vl)
    C = (vl * c["F"]).sum(-1) + (wl * c["N"]).sum(-1)
    M = torch.zeros(n, nv, nv, dtype=torch.float64)
    for k in range(nv):
        for l in range(nv):
            lo, hi = min(k, l), max(k, l)
            if lo < 6 or anc[hi - 5, lo - 6]:
                M[:, k, l] = ((wl[:, lo] * nl[:, hi]).sum(-1)
                              + (vl[:, lo] * f[:, hi]).sum(-1))
    M = M + f64(mt.armature_diag)
    return M, C


def _emulate_inverse(model, M):
    """M^-1 as the kernel forms it, float64."""
    if not model.uniform_3dof_branches():
        L = torch.linalg.cholesky(M)
        return torch.cholesky_inverse(L)
    nv, nj = model.nv, model.nj
    X = M[:, :6, 6:]
    Dinv = torch.zeros(M.shape[0], nj, nj, dtype=M.dtype)
    for i in range(nj // 3):
        s = slice(3 * i, 3 * i + 3)
        Dinv[:, s, s] = torch.linalg.inv(M[:, 6 + 3 * i:9 + 3 * i,
                                           6 + 3 * i:9 + 3 * i])
    W = X @ Dinv
    S = M[:, :6, :6] - W @ X.transpose(1, 2)
    L = torch.linalg.cholesky(S)
    eye = torch.eye(6, dtype=M.dtype).expand_as(S)
    H = torch.linalg.solve_triangular(L, torch.cat([eye, -W], dim=2),
                                      upper=False)
    out = H.transpose(1, 2) @ H
    out[:, 6:, 6:] += Dinv
    return out


@pytest.fixture(scope="module", params=CASES)
def design(request):
    """(case name, model, emulated and plain outputs, contacts left out)."""
    name = request.param
    case = make_case(name, N)
    mt = td.ModelTensors.build(case.model, "cpu")
    qpos, qvel, target, com = torch_inputs(case, "cpu")
    kin = td.fk(mt, qpos, qvel, com)
    jacs = td.body_jacobians(mt, kin)
    I_w = td.world_inertias(mt, kin)
    M, C = _emulate_dynamics(mt, kin, qvel)
    tau_j, v_free, Minv, ckin = tem.dynamics_stage(mt, case.params, qpos,
                                                   qvel, target, com)
    E, W, b, _, _ = tem.contact_stage(mt, case.terrain, ckin, Minv, v_free)
    # W and b over each row's nonzero dofs alone
    nz = torch.zeros(E.shape[1:], dtype=torch.bool)
    for r, dofs in enumerate(pgs.contact_row_dofs(case.model,
                                                  case.model.ancestor_mask())):
        nz[r, list(dofs)] = True
    En = torch.where(nz, E, torch.zeros(())).double()
    emu = dict(M=M, C=C, Minv=_emulate_inverse(case.model, M),
               W=Minv.double() @ En.transpose(1, 2),
               b=(En @ v_free.double()[..., None])[..., 0])
    plain = dict(M=td.mass_matrix(mt, jacs, I_w),
                 C=td.bias_forces(mt, kin, jacs, I_w, qvel), Minv=Minv,
                 W=W, b=b)
    left_out = measure.ambiguous_contacts(mt, case.terrain, ckin)
    return name, emu, plain, E, nz, left_out


@pytest.mark.parametrize("what,rtol,atol", [("M", 1e-4, 1e-5),
                                            ("C", 1e-4, 1e-4)])
def test_composite_sums_give_m_and_c(design, what, rtol, atol):
    name, emu, plain = design[:3]
    np.testing.assert_allclose(emu[what].numpy(), plain[what].numpy(),
                               rtol=rtol, atol=atol, err_msg=name)


def test_m_is_symmetric_by_construction(design):
    M = design[1]["M"]
    assert torch.equal(M, M.transpose(1, 2))


def test_h_transpose_h_gives_the_inverse(design):
    name, emu, plain = design[:3]
    _, _, bad = measure.stage_disagreement("Minv", emu["Minv"].float(),
                                           plain["Minv"])
    assert bad == 0, name


def test_rows_are_zero_off_their_nonzero_dofs(design):
    name, _, _, E, nz, _ = design
    assert not E[:, ~nz].any(), name


@pytest.mark.parametrize("out", ["W", "b"])
def test_w_and_b_over_the_nonzero_dofs(design, out):
    name, emu, plain, _, _, left_out = design
    _, _, bad = measure.stage_disagreement(
        out, emu[out].float(), plain[out], ~left_out,
        hfield=name == "solo12-rough")
    assert bad == 0, name


def test_ptxas_resources_reads_each_entry_function():
    log = (
        "ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__e18_14_"
        "substep_dyn_cu_e8e57f6518substep_dyn_kernelENS_7DynArgsE' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for x\n"
        "    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 64 registers, used 0 barriers\n"
        "ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__1869f6a3_"
        "15_contact_rows_cu_6f8bbecc19contact_rows_kernelILi24EEEvNS_7Con"
        "ArgsE' for 'sm_90a'\n"
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 63 registers, used 0 barriers\n")
    assert build.ptxas_resources(log) == {
        "substep_dyn_kernel": dict(registers=64, stack=32, spill_stores=0,
                                   spill_loads=0),
        "contact_rows_kernel<24>": dict(registers=63, stack=8,
                                        spill_stores=4, spill_loads=12)}


def test_the_phase_clock_build_is_a_library_of_its_own(tmp_path,
                                                       monkeypatch):
    """Its flag reaches nvcc and names another library; the production
    wrappers never take it, and only the clock build has phase_cycles."""
    import subprocess

    calls = []

    def nvcc(cmd, **kw):
        calls.append(cmd)
        open(cmd[cmd.index("-o") + 1], "w").close()
        return subprocess.CompletedProcess(cmd, 0, "ptxas info", "")

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", nvcc)
    plain = build.build_shared_library(substep.DYN_SOURCE)
    clocked = build.build_shared_library(substep.DYN_SOURCE,
                                         substep.PHASE_CLOCK_FLAGS)
    assert plain.path != clocked.path
    assert "-DSUBSTEP_PHASE_CLOCKS" in calls[1]
    assert "-DSUBSTEP_PHASE_CLOCKS" not in calls[0]
    assert build.build_shared_library(substep.DYN_SOURCE).seconds == 0.0
    assert not substep.DYN_KERNEL.clocks and not substep.CONTACT_KERNEL.clocks
    with pytest.raises(RuntimeError, match="clocks=True"):
        substep.DYN_KERNEL.phase_cycles(1, "cpu", lambda: None)
    assert len(substep.SubstepDynKernel.phases) == 7
    assert len(substep.ContactRowsKernel.phases) == 4
    assert max(map(len, (substep.SubstepDynKernel.phases,
                         substep.ContactRowsKernel.phases))) \
        <= substep.PHASE_SLOTS


@pytest.mark.parametrize("model,hfield,mb", [
    (solo12_model, False, (9.75, 80.12)), (solo12_model, True, (9.75, 89.30)),
    (go2_model, False, (9.75, 60.13))])
def test_substep_counts_keep_the_bytes(model, hfield, mb):
    """The bytes of each kernel's bound are those its earlier shares of the
    bound were taken against; the operations are the composite-sum
    design's, fewer than the 0.166 GFLOP (dynamics, N = 4096) of summing
    J^T I J over every body."""
    counts = measure.substep_counts(model(), 4096, hfield=hfield)
    got = tuple(round(counts[k][0] / 1e6, 2)
                for k in ("substep_dynamics", "contact_rows"))
    assert got == mb
    assert 0 < counts["substep_dynamics"][1] < 0.166e9
    assert 0 < counts["contact_rows"][1]
