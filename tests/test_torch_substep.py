"""The physics substep up to the contact solve, split in two stages
(cat_tpu_torch/sim/engine.py dynamics_stage, contact_stage: the plain
versions of the two kernels of cat_tpu_torch/ops/substep.py), against the
JAX package's lanes functions (cat_tpu/sim/dynamics_lanes.py) and its
lanes pre-stage (cat_tpu/sim/engine_lanes.py _substep_pre_lanes), stage by
stage, on the inputs of tests/_substep_cases.py (one numpy seed): Solo12
on the plane, on a rough heightfield with envs at and beyond its edge,
with CoM offsets; Go2; the joint-less box on its slope (the Cholesky
M^-1). Then the engine's layouts on the CPU, the graph key, and the
wrappers' refusals.

Tolerances: ``measure.STAGE_TOL``, those tests/test_lanes.py holds the
JAX lanes layout to against its vmap layout (kinematics and contact rows
atol 1e-5, on the heightfield E and the frames 2e-5, M^-1 rtol/atol
2e-3, v_free, W and b 2e-3 of the largest entry); M and C, which no stage returns, at test_lanes.py's rtol 1e-4 /
atol 1e-5 and 1e-4. On the heightfield the contacts that
``measure.ambiguous_contacts`` marks (a probe on a grid line, or two
probes' gaps within 1e-5 m: one rounding may switch the normal) are left
out, and must be few.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from _substep_cases import CASES, make_case, torch_inputs
from test_slope import _box_model
from cat_tpu.models.go2 import go2_model as jax_go2
from cat_tpu.models.solo12 import solo12_model as jax_solo12
from cat_tpu.sim import dynamics_lanes as dl
from cat_tpu.sim import engine as jem
from cat_tpu.sim import engine_lanes as jel
from cat_tpu.sim import terrain as jterrain
from cat_tpu_torch import measure
from cat_tpu_torch.ops import substep
from cat_tpu_torch.ops.substep import CONTACT_OUTPUTS, DYN_OUTPUTS
from cat_tpu_torch.sim import dynamics as td
from cat_tpu_torch.sim import engine as tem

N = 6


def _jax_terrain(t):
    if t.kind == "plane":
        return jterrain.plane()
    return jterrain.Terrain(kind="hfield", height=t.height, cell=t.cell,
                            rows=t.rows, cols=t.cols, patch_m=t.patch_m)


def _lanes(x):
    """A JAX lanes array (..., N) as a numpy array (N, ...)."""
    return np.moveaxis(np.asarray(x), -1, 0)


@pytest.fixture(scope="module", params=CASES)
def staged(request):
    """(case name, port outputs, JAX outputs, M and C of both, contacts
    left out) of one case: the port's two stages, the JAX lanes pre-stage
    and lanes functions, from the same inputs."""
    name = request.param
    case = make_case(name, N)
    jmodel = {"go2": jax_go2, "box": _box_model}.get(name, jax_solo12)()
    jp = jem.EngineParams(dt=case.params.dt, kp=case.params.kp,
                          kd=case.params.kd)
    jt = _jax_terrain(case.terrain)
    anc = jmodel.ancestor_mask()
    com_l = (None if case.com_offset is None
             else jnp.asarray(np.moveaxis(case.com_offset, 0, -1)))
    qpos_l, qvel_l = jnp.asarray(case.qpos.T), jnp.asarray(case.qvel.T)
    tau, v_free, E, W, b, phi, frame = jel._substep_pre_lanes(
        jmodel, jp, anc, jt, qpos_l, qvel_l, jnp.asarray(case.target.T),
        com_l)
    kin = dl.fk_lanes(jmodel, qpos_l, qvel_l, com_l)
    jacs = dl.body_jacobians_lanes(jmodel, kin, anc)
    Iw = dl.world_inertias_lanes(jmodel, kin)
    M = dl.mass_matrix_lanes(jmodel, jacs, Iw)
    C = dl.bias_forces_lanes(jmodel, kin, jacs, Iw, qvel_l)
    Minv = (dl.mass_matrix_inverse_lanes(M, n_branch=jmodel.nj // 3)
            if jmodel.uniform_3dof_branches() else dl.dense_inverse_lanes(M))
    ref = dict(tau_j=tau, v_free=v_free, Minv=Minv, R=kin.R, o=kin.o,
               a_w=kin.a_w, E=E, W=W, b=b, phi=phi, frame=frame)
    ref = {k: None if v is None else _lanes(v) for k, v in ref.items()}

    mt = td.ModelTensors.build(case.model, "cpu")
    qpos, qvel, target, com = torch_inputs(case, "cpu")
    dyn_out = tem.dynamics_stage(mt, case.params, qpos, qvel, target, com)
    tau_j, vf, Minv_t, kin_t = dyn_out
    con_out = tem.contact_stage(mt, case.terrain, kin_t, Minv_t, vf)
    port = dict(zip(DYN_OUTPUTS, (tau_j, vf, Minv_t, *kin_t)))
    port.update(zip(CONTACT_OUTPUTS, con_out))
    # M and C through the stage's own building blocks
    kin_f = td.fk(mt, qpos, qvel, com)
    jacs_f = td.body_jacobians(mt, kin_f)
    Iw_f = td.world_inertias(mt, kin_f)
    mc = dict(M=(td.mass_matrix(mt, jacs_f, Iw_f).numpy(), _lanes(M)),
              C=(td.bias_forces(mt, kin_f, jacs_f, Iw_f, qvel).numpy(),
                 _lanes(C)))
    left_out = measure.ambiguous_contacts(mt, case.terrain, kin_t)
    return name, port, ref, mc, left_out


@pytest.mark.parametrize("out", DYN_OUTPUTS + CONTACT_OUTPUTS)
def test_stages_match_the_jax_lanes_prestage(staged, out):
    """Each output of the two stages against _substep_pre_lanes' (tau_j,
    v_free, E, W, b, phi, frame) and the lanes functions' (Minv, kin)."""
    name, port, ref, _, left_out = staged
    a, r = port[out], ref[out]
    if r is None or a is None:
        assert a is None and r is None, f"{name}: frame given by one side"
        return
    assert a.shape == r.shape, (name, out, a.shape, r.shape)
    keep = ~left_out if out in CONTACT_OUTPUTS else None
    _, _, bad = measure.stage_disagreement(
        out, a, torch.tensor(r), keep, hfield=name == "solo12-rough")
    assert bad == 0, f"{name}: {out} outside {measure.STAGE_TOL[out]}"
    assert int(left_out.sum()) <= 0.02 * left_out.numel(), (
        f"{name}: {int(left_out.sum())} contacts left out")


@pytest.mark.parametrize("what,rtol,atol", [("M", 1e-4, 1e-5),
                                            ("C", 1e-4, 1e-4)])
def test_mass_matrix_and_bias_match(staged, what, rtol, atol):
    port, ref = staged[3][what]
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


def test_stages_are_the_old_single_stage():
    """The plain route of the engine (layout "vmap") computes the contact
    problem as the two stages do, and the wrappers on CPU tensors are
    those stages: one substep of each layout equal bit for bit."""
    case = make_case("solo12-rough", N)
    qpos, qvel, target, _ = torch_inputs(case, "cpu")
    s = tem.make_batched_init(case.model, N, "cpu")._replace(qpos=qpos,
                                                            qvel=qvel)
    mu = torch.full((N,), 0.8)
    outs = []
    for layout in tem.LAYOUTS:
        eng = tem.make_batched_step(case.model, case.params,
                                    terrain=case.terrain, layout=layout,
                                    device="cpu")
        outs.append(eng.contact_problem(s, target, mu))
    for (pre_a, ops_a), (pre_b, ops_b) in zip(outs, outs[1:]):
        for x, y in zip((*pre_a, *ops_a), (*pre_b, *ops_b)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("layout", ["auto", "lanes", "vmap"])
def test_make_batched_step_layouts_agree_on_the_cpu(layout):
    """A control step of each layout from the same state, to 1e-6."""
    case = make_case("solo12-com", N)
    qpos, qvel, target, com = torch_inputs(case, "cpu")
    mu = torch.full((N,), 0.8)
    runs = {}
    for lay in ("vmap", layout):
        eng = tem.make_batched_step(case.model, case.params, 0,
                                    case.terrain, lay, device="cpu")
        assert eng.layout == lay
        s = tem.make_batched_init(case.model, N, "cpu")._replace(
            qpos=qpos, qvel=0.2 * qvel)
        runs[lay] = eng(s, target, mu, com)
    for x, y in zip(runs["vmap"], runs[layout]):
        assert torch.allclose(x.float(), y.float(), rtol=0.0, atol=1e-6)


def test_make_batched_step_refuses_other_layouts():
    case = make_case("box", 2)
    with pytest.raises(ValueError, match="layout"):
        tem.make_batched_step(case.model, case.params, layout="env_last",
                              device="cpu")


def test_graph_key_separates_the_layouts():
    """A vmap copy of an engine (sharing its graphs) must not replay a
    lanes capture; "auto" runs as "lanes" and keys as it."""
    case = make_case("solo12-plane", 4)
    eng = tem.make_batched_step(case.model, case.params, device="cpu")
    assert eng.layout == "auto"
    s = tem.make_batched_init(case.model, 4, "cpu")
    target, mu = torch.from_numpy(case.target), torch.ones(4)
    keys = {lay: eng._replace(layout=lay)._graph_key(s, target, mu)
            for lay in tem.LAYOUTS}
    assert keys["auto"] == keys["lanes"] != keys["vmap"]
    # the bench's positional rebuild keeps the layout
    copy = type(eng)(*eng._replace(layout="vmap"))
    assert copy.layout == "vmap" and copy.graphs is eng.graphs


def _dyn_args(n=4, **change):
    case = make_case("solo12-plane", n)
    mt = td.ModelTensors.build(case.model, "cpu")
    qpos, qvel, target, _ = torch_inputs(case, "cpu")
    args = dict(qpos=qpos, qvel=qvel, target_q=target, com_offset=None)
    args.update(change)
    return mt, case.params, args


@pytest.mark.parametrize("change,error", [
    (dict(qpos=torch.zeros(4, 19, dtype=torch.float64)), TypeError),
    (dict(qvel=torch.zeros(4, 17)), ValueError),
    (dict(target_q=torch.zeros(12, 4).t()), ValueError),
    (dict(com_offset=torch.zeros(4, 12, 3)), ValueError),
    (dict(), ValueError),            # every operand right, but on the CPU
])
def test_dynamics_kernel_refuses_bad_operands(change, error):
    """The kernel's wrapper checks dtype, shape and contiguity, then that
    the operands lie on a CUDA device, before it builds anything."""
    mt, params, args = _dyn_args(**change)
    with pytest.raises(error):
        substep.DYN_KERNEL(mt, params, **args)
    assert substep.DYN_KERNEL.launches == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "device"])
def test_contact_kernel_refuses_bad_operands(bad):
    mt, params, args = _dyn_args()
    tau_j, v_free, Minv, kin = tem.dynamics_stage(mt, params, **args)
    if bad == "dtype":
        Minv = Minv.double()
    elif bad == "shape":
        v_free = v_free[:, :17]
    elif bad == "contiguity":
        Minv = Minv.transpose(1, 2)
    error = TypeError if bad == "dtype" else ValueError
    with pytest.raises(error):
        substep.CONTACT_KERNEL(mt, make_case("solo12-plane", 1).terrain, kin,
                               Minv, v_free)
    assert substep.CONTACT_KERNEL.launches == 0


def test_kernels_refuse_more_than_32_dofs_or_64_contacts():
    """A lane owns each dof and each contact's record has a fixed room:
    a model past either is refused by its shape alone."""
    m = make_case("solo12-plane", 1).model
    wide = type("Wide", (), dict(nv=33, ncand=m.ncand))()
    with pytest.raises(ValueError, match="33 dofs"):
        substep._check_model(wide)
    many = type("Many", (), dict(nv=m.nv, ncand=65))()
    with pytest.raises(ValueError, match="65 contacts"):
        substep._check_model(many)
    substep._check_model(m)


def test_model_tables_pack_the_header_order():
    """The tables' sizes are those ``csrc/substep_model.cuh`` reads: the
    float parts, then the int parts, and the tree's depth."""
    for name in ("solo12-plane", "go2", "box"):
        m = make_case(name, 1).model
        floats, ints, depth = substep.pack_model(m)
        nb, nv, nj = m.nbody, m.nv, m.nj
        assert floats.size == (3 + 28 * nb + nv + nj + 4 * m.ncand_terrain
                               + 13 * m.npair)
        assert ints.size == 3 * nb + m.ncand_terrain + 2 * m.npair
        assert depth == (3 if nj else 0)
        assert floats.dtype == np.float32 and ints.dtype == np.int32
        # the ancestor bits of the last body: its leg's three joints
        if nj:
            assert ints[2 * nb + nb - 1] == 0b111 << (nj - 3)


def test_nearly_parallel_pairs_are_left_out():
    """A self-collision pair whose capsule axes are parallel to within
    ``measure.PAIR_SIN2`` (but not to the last bit) and which lies more
    than ``measure.PAIR_CLEAR_M`` clear of touching is left out by
    ``ambiguous_contacts``: float32 does not resolve its closest points,
    and its rows multiply no impulse. At the symmetric default pose none
    (the two legs of a side exactly parallel); with one knee turned by
    1e-4 rad the pairs of that knee's lower leg with its parallel
    neighbour; with 0.05 rad none; and none of them once the capsules are
    made wide enough to come within PAIR_CLEAR_M of touching."""
    import dataclasses

    case = make_case("solo12-plane", 1)
    m = case.model
    mt = td.ModelTensors.build(m, "cpu")
    nct = m.ncand_terrain
    q = torch.tensor(m.default_qpos(), dtype=torch.float32).repeat(3, 1)
    q[1, 7 + 11] += 1e-4                # the last leg's knee
    q[2, 7 + 11] += 0.05
    kin = td.fk(mt, q, torch.zeros(3, m.nv), None)
    left = measure.ambiguous_contacts(mt, case.terrain, kin)
    assert not left[:, :nct].any()
    assert not left[0].any() and not left[2].any()
    flagged = left[1, nct:].nonzero()[:, 0].tolist()
    assert flagged and all(
        int(m.pair_body_a[p]) == m.nbody - 1
        or int(m.pair_body_b[p]) == m.nbody - 1 for p in flagged)
    from cat_tpu_torch.sim import collision

    gap = collision.detect_pair_contacts(mt, kin)[0][1]
    wide = dataclasses.replace(
        mt, pair_rsum=mt.pair_rsum + gap - 0.5 * measure.PAIR_CLEAR_M)
    assert not measure.ambiguous_contacts(wide, case.terrain, kin)[1].any()


def test_float32_does_not_resolve_a_nearly_parallel_pairs_denominator():
    """Why ``measure.PAIR_SIN2``: at sin^2 under it the closest-point
    solve's a e - b^2 in float32 is off its float64 value by more than
    that value itself (the pair of the test above, 36 m off the origin as
    the bench's states are), above it by a small part of it."""
    from cat_tpu_torch.tools import pair_probe

    m = make_case("solo12-plane", 1).model
    mt = td.ModelTensors.build(m, "cpu")
    q = torch.tensor(m.default_qpos(), dtype=torch.float32).repeat(2, 1)
    q[:, 0:2] = torch.tensor([36.3, -21.7])
    q[0, 7 + 11] += 2e-4                # sin^2 ~ 4e-8
    q[1, 7 + 11] += 0.01                # sin^2 ~ 1e-4
    kin = td.fk(mt, q, torch.zeros(2, m.nv), None)
    _, _, den32 = pair_probe.closest(mt, kin, torch.float32)
    _, _, den64 = pair_probe.closest(mt, kin, torch.float64)
    p = int(measure.parallel_pairs(mt, kin)[0].nonzero()[0, 0])
    assert den64[0, p] < measure.PAIR_SIN2 < den64[1, p]
    assert abs(float(den32[0, p]) - float(den64[0, p])) > float(den64[0, p])
    assert abs(float(den32[1, p]) - float(den64[1, p])) < 0.1 * float(
        den64[1, p])


def test_pair_probe_readings_on_the_cpu(capsys):
    """``tools/pair_probe.py`` reads a state (on the CPU the contact kernel
    is the plain stage, so the two agree) and prints its table by sin^2."""
    from types import SimpleNamespace

    from cat_tpu_torch.tools import pair_probe

    case = make_case("solo12-plane", 4)
    mt = td.ModelTensors.build(case.model, "cpu")
    qpos, qvel, target, _ = torch_inputs(case, "cpu")
    eng = SimpleNamespace(mt=mt, params=case.params, terrain=case.terrain)
    pair_probe.readings("cpu", eng, SimpleNamespace(qpos=qpos, qvel=qvel),
                        target, None)
    out = capsys.readouterr().out
    assert "4 envs x 8 pairs" in out and "sin^2 (" in out
    assert "E kernel-plain max 0 (over 1e-5: 0" in out
