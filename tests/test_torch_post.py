"""The physics substep's post stage (cat_tpu_torch/sim/engine.py
post_stage, the plain version of ops/substep.py's post kernel) against the
JAX package's lanes post stage (cat_tpu/sim/engine_lanes.py
_substep_post_lanes, env-last) and its single-env one
(cat_tpu/sim/engine.py _substep_post, vmapped), on the same inputs: the
contact problems of tests/_substep_cases.py's cases (one numpy seed)
solved by the port's plain block-Jacobi solve, a seeded state around them
(force history, air and contact times, touchdown), and the three contrived
inputs of ``measure.post_contrived`` (joints exactly on their limits,
feet whose force lies within 1e-3 N of the contact threshold, no impulse).
Then the dispatch, the kernel wrapper's refusals, the packed report table,
and a plain mirror of the kernel's design.

Tolerances: ``measure.compare_post``. v = v_free + W lam sums up to 3 x 64
products in another order on each side, so qvel is held to atol 1e-5 plus
8 float32 unit roundoffs of |v_free| + sum |W lam| (the drops of
_substep_cases.py reach 160 m/s there; the plain float32 version alone is
up to 1.7e-5 off a float64 one, the kernel's order up to 3.2 units off
the plain one), joint_acc = dv / h to that over h plus 1e-5 of its
largest entry; qpos atol 1e-5 (q + h v and the quaternion's exponential
map, unit-scale); forces and their history 1e-5 of their largest entry;
the air times and touchdown equal. A joint clamped at its limit or a foot
in contact may come out otherwise only where its deciding quantity (the
new angle, the force norm) lies within 4 float32 spacings of its limit:
such flips are counted, must be few, and their entries are left out of
their fields' comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from _substep_cases import make_case, torch_inputs
from test_slope import _box_model
from cat_tpu.models.go2 import go2_model as jax_go2
from cat_tpu.models.solo12 import solo12_model as jax_solo12
from cat_tpu.sim import engine as jem
from cat_tpu.sim import engine_lanes as jel
from cat_tpu_torch import measure
from cat_tpu_torch.ops import substep
from cat_tpu_torch.sim import dynamics as td
from cat_tpu_torch.sim import engine as tem
from cat_tpu_torch.sim.solver import SolverParams

N = 16
POST_CASES = ("solo12-plane", "solo12-rough", "go2", "box")
CONTRIVED = ("on-limits", "at-threshold", "zero-lam")
BJ = SolverParams(structure="bj", bj_blocks=4, omega=0.9, iterations=6)


def _problem(name, n=N, seed=0):
    """(case, mt, state, tau_j, v_free, W, lam, frame) of one case: its
    contact problem by the plain stages, solved by the plain block-Jacobi
    solve, and a seeded state around it."""
    case = make_case(name, n, seed)
    m = case.model
    params = case.params._replace(solver=BJ)
    eng = tem.make_batched_step(m, params, terrain=case.terrain,
                                layout="vmap", device="cpu")
    qpos, qvel, target, com = torch_inputs(case, "cpu")
    rng = np.random.default_rng(seed + 1)
    nf = len(m.foot_report_ids)

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32))

    s = tem.make_batched_init(m, n, "cpu")._replace(
        qpos=qpos, qvel=qvel,
        force_hist=f32(rng.normal(0.0, 5.0, (n, 9 * m.nreport))),
        current_air_time=f32(rng.integers(0, 3, (n, nf)) * params.dt),
        last_air_time=f32(rng.uniform(0.0, 0.5, (n, nf))),
        current_contact_time=f32(rng.integers(0, 3, (n, nf)) * params.dt),
        last_contact_time=f32(rng.uniform(0.0, 0.5, (n, nf))),
        touchdown=torch.from_numpy(rng.integers(0, 2, (n, nf)).astype(bool)))
    mu = f32(rng.uniform(0.5, 1.2, n))
    (tau_j, v_free, W, frame), ops = eng.contact_problem(s, target, mu, com)
    lam = eng.solve(*ops, **eng.pgs_kwargs)
    return case._replace(params=params), eng.mt, s, tau_j, v_free, W, lam, \
        frame


def _jax_model(name):
    return {"go2": jax_go2, "box": _box_model}.get(name, jax_solo12)()


def _jax_params(params):
    return jem.EngineParams(dt=params.dt, kp=params.kp, kd=params.kd,
                            contact_force_threshold=params
                            .contact_force_threshold)


def _lanes(x):
    return jnp.asarray(np.moveaxis(x.numpy(), 0, -1))


def _back(x):
    return torch.from_numpy(np.moveaxis(np.asarray(x), -1, 0).copy())


def jax_post_lanes(name, params, s, tau_j, v_free, W, lam, frame):
    """_substep_post_lanes on the same inputs, env-last, as a port
    SimState."""
    air = tuple(_lanes(getattr(s, f)) for f in substep.POST_OUTPUTS[5:10])
    out = jel._substep_post_lanes(
        _jax_model(name), _jax_params(params), _lanes(s.qpos),
        _lanes(s.qvel), _lanes(s.force_hist), air, _lanes(tau_j),
        _lanes(v_free), _lanes(W), _lanes(lam),
        None if frame is None else _lanes(frame))
    qpos, qvel, lam_o, tau_o, acc, forces, hist, air_o = out
    return tem.SimState(*map(_back, (qpos, qvel, lam_o, tau_o, acc, forces,
                                     hist, *air_o)))


def jax_post_single(name, params, s, tau_j, v_free, W, lam, frame):
    """cat_tpu/sim/engine.py _substep_post vmapped over the envs (lam a
    contact's three rows, as its solve returns it; the world frame a (0, 3,
    3) sentinel, unbatched), as a port SimState."""
    jm, jp = _jax_model(name), _jax_params(params)
    js = jem.SimState(*(jnp.asarray(t.numpy()) for t in s))

    def one(st, tau, vf, w, la, fr):
        return jem._substep_post(jm, jp, st, tau, vf, w, la, fr)

    if frame is None:
        fr, ax = jnp.zeros((0, 3, 3)), None
    else:
        fr, ax = jnp.asarray(frame.numpy()), 0
    out = jax.vmap(one, in_axes=(0, 0, 0, 0, 0, ax))(
        js, *(jnp.asarray(t.numpy()) for t in (
            tau_j, v_free, W, lam.reshape(lam.shape[0], -1, 3))), fr)
    return tem.SimState(*(torch.from_numpy(np.asarray(x).copy())
                          for x in out))


def _assert_agree(mt, params, s, v_free, W, lam, out, ref, what):
    cmp = measure.compare_post(mt, params, s, v_free, W, lam, out, ref)
    assert cmp.ok, f"{what}: {cmp.text}"
    assert len(cmp.flips) <= max(2, cmp.near), f"{what}: {cmp.text}"
    return cmp


@pytest.fixture(scope="module", params=POST_CASES)
def problem(request):
    return (request.param,) + _problem(request.param)


@pytest.mark.parametrize("jax_side", ["lanes", "single"])
def test_post_stage_matches_the_jax_post_stages(problem, jax_side):
    """post_stage against _substep_post_lanes (env-last) and the vmapped
    _substep_post on the case's solved problem."""
    name, case, mt, s, tau_j, v_free, W, lam, frame = problem
    assert (frame is None) == (name == "go2")
    ref = (jax_post_lanes if jax_side == "lanes" else jax_post_single)(
        name, case.params, s, tau_j, v_free, W, lam, frame)
    out = tem.post_stage(mt, case.params, s, tau_j, v_free, W, lam, frame)
    for a, b in zip(out, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
    _assert_agree(mt, case.params, s, v_free, W, lam, out, ref,
                  f"{name} vs {jax_side}")


@pytest.mark.parametrize("label", CONTRIVED)
def test_post_stage_matches_jax_on_contrived_inputs(problem, label):
    """Joints exactly on their limits, feet at the contact threshold, no
    impulse: post_stage against _substep_post_lanes; the decisions near
    their limits are there (on-limits: every joint; at-threshold: the
    feet nearest the threshold)."""
    name, case, mt, s, tau_j, v_free, W, lam, frame = problem
    s2, lam2 = measure.post_contrived(mt, case.params, s, lam)[label]
    ref = jax_post_lanes(name, case.params, s2, tau_j, v_free, W, lam2,
                         frame)
    out = tem.post_stage(mt, case.params, s2, tau_j, v_free, W, lam2, frame)
    cmp = _assert_agree(mt, case.params, s2, v_free, W, lam2, out, ref,
                        f"{name} {label}")
    if label == "on-limits" and mt.model.nj:
        on = s2.qpos[:, 7:]
        assert torch.equal(on, torch.where(
            (torch.arange(N) % 2 == 1)[:, None], mt.joint_upper,
            mt.joint_lower))
        clamped = out.qvel[:, 6:] == 0
        assert clamped.any() and not clamped.all()
    if label == "at-threshold":
        foot = out.forces.reshape(N, -1, 3)[:, mt.foot_ids]
        norm = torch.linalg.vector_norm(foot, dim=-1)
        assert ((norm - case.params.contact_force_threshold).abs()
                <= 1.01e-3).all()
        inside = out.current_air_time == 0
        assert inside.any() and not inside.all()
    if label == "zero-lam":
        assert torch.equal(out.forces, torch.zeros_like(out.forces))
        assert cmp.errors["qvel"] == 0.0


def test_post_stage_at_the_threshold_reports_its_near_decisions():
    """At 512 envs the at-threshold spread puts feet within 4 float32
    spacings of 1 N: compare_post counts them, and post_stage against the
    JAX lanes stage flips only such decisions."""
    case, mt, s, tau_j, v_free, W, lam, frame = _problem("solo12-plane",
                                                         512, seed=3)
    s2, lam2 = measure.post_contrived(mt, case.params, s, lam)["at-threshold"]
    ref = jax_post_lanes("solo12-plane", case.params, s2, tau_j, v_free, W,
                         lam2, frame)
    out = tem.post_stage(mt, case.params, s2, tau_j, v_free, W, lam2, frame)
    cmp = _assert_agree(mt, case.params, s2, v_free, W, lam2, out, ref,
                        "solo12-plane at-threshold, 512 envs")
    assert cmp.near >= 1
    assert all(m <= measure.POST_FLIP_SPACINGS for *_, m in cmp.flips)


def test_compare_post_catches_a_flip_far_from_its_limit():
    """A seeded fault: one foot's contact decision turned over where its
    force is far from the threshold fails the comparison; a joint's
    velocity changed by 1e-3 fails it too."""
    case, mt, s, tau_j, v_free, W, lam, frame = _problem("solo12-plane")
    p = case.params
    ref = tem.post_stage(mt, p, s, tau_j, v_free, W, lam, frame)
    foot = ref.forces.reshape(N, -1, 3)[:, mt.foot_ids]
    far = torch.linalg.vector_norm(foot, dim=-1) > 2.0
    e, f = far.nonzero()[0].tolist()
    air = ref.current_air_time.clone()
    air[e, f] = s.current_air_time[e, f] + p.dt
    bad = measure.compare_post(mt, p, s, v_free, W, lam,
                               ref._replace(current_air_time=air), ref)
    assert not bad.ok and bad.flips[0][:3] == ("foot", e, f)
    qvel = ref.qvel.clone()
    qvel[0, 7] += 1e-3
    bad = measure.compare_post(mt, p, s, v_free, W, lam,
                               ref._replace(qvel=qvel), ref)
    assert not bad.ok and "qvel" in bad.outside


def test_cpu_tensors_dispatch_to_post_stage():
    """ops/substep.py substep_post and sim/engine.py substep_post on CPU
    tensors are post_stage, bit for bit, and launch nothing."""
    case, mt, s, tau_j, v_free, W, lam, frame = _problem("solo12-rough")
    before = substep.POST_KERNEL.launches
    plain = tem.post_stage(mt, case.params, s, tau_j, v_free, W, lam, frame)
    for fn in (substep.substep_post, tem.substep_post):
        out = fn(mt, case.params, s, tau_j, v_free, W, lam, frame)
        for a, b in zip(out, plain):
            assert torch.equal(a, b)
    assert substep.POST_KERNEL.launches == before


@pytest.mark.parametrize("layout", ["vmap", "lanes", "auto"])
def test_engine_layouts_pick_their_post_stage(monkeypatch, layout):
    """Engine.substep runs post_stage on "vmap" and the dispatcher
    substep_post (the kernel on a CUDA device) on "lanes" and "auto",
    which on CPU tensors runs post_stage."""
    case = make_case("solo12-plane", 4)
    eng = tem.make_batched_step(case.model, case.params, layout=layout,
                                device="cpu")
    calls = []
    for fn in ("post_stage", "substep_post"):
        real = getattr(tem, fn)
        monkeypatch.setattr(tem, fn, lambda *a, _f=fn, _r=real: (
            calls.append(_f), _r(*a))[1])
    qpos, qvel, target, _ = torch_inputs(case, "cpu")
    s = tem.make_batched_init(case.model, 4, "cpu")._replace(qpos=qpos)
    eng.substep(s, target, torch.ones(4))
    assert calls == (["post_stage"] if layout == "vmap"
                     else ["substep_post", "post_stage"])


def _kernel_args(n=4, **change):
    case, mt, s, tau_j, v_free, W, lam, frame = _problem("solo12-plane", n)
    args = dict(s=s, tau_j=tau_j, v_free=v_free, W=W, lam=lam, frame=frame)
    for k, v in change.items():
        if k in args:
            args[k] = v
        else:
            args["s"] = args["s"]._replace(**{k: v})
    return mt, case.params, args


@pytest.mark.parametrize("change,error", [
    (dict(W=torch.zeros(4, 18, 108, dtype=torch.float64)), TypeError),
    (dict(lam=torch.zeros(4, 107)), ValueError),
    (dict(frame=torch.zeros(4, 36, 3)), ValueError),
    (dict(force_hist=torch.zeros(4, 116)), ValueError),
    (dict(touchdown=torch.zeros(4, 4)), TypeError),
    (dict(current_air_time=torch.zeros(4, 3)), ValueError),
    (dict(), ValueError),            # every operand right, but on the CPU
])
def test_post_kernel_refuses_bad_operands(change, error):
    """The kernel's wrapper checks dtype and shape, then that the
    operands lie on a CUDA device, before it builds anything."""
    mt, params, args = _kernel_args(**change)
    before = substep.POST_KERNEL.launches
    with pytest.raises(error):
        substep.POST_KERNEL(mt, params, **args)
    assert substep.POST_KERNEL.launches == before


def test_post_kernel_refuses_models_past_its_limits():
    """A lane owns each dof and each foot, and the lanes' impulse registers
    hold 64 contacts: a model past any is refused by its shape alone."""
    m = make_case("solo12-plane", 1).model
    feet = m.foot_report_ids
    for kind, fields in (("33 dofs", dict(nv=33)),
                         ("65 contacts", dict(ncand=65)),
                         ("33 feet", dict(foot_report_ids=np.arange(33)))):
        base = dict(nv=m.nv, ncand=m.ncand, foot_report_ids=feet)
        fake = type("Fake", (), dict(base, **fields))()
        with pytest.raises(ValueError, match=kind):
            substep._check_post_model(fake)
    substep._check_post_model(m)


@pytest.mark.parametrize("name", ["solo12-plane", "go2", "box"])
def test_packed_report_table_reproduces_the_report_matrix(name):
    """Slot r's entries (contact c for +f, -1 - c for a pair's -f) set the
    report matrix's columns c and nc + c - nct: the same matrix, the
    entries in column order; the packed tables in the source's order."""
    m = make_case(name, 1).model
    mt = td.ModelTensors.build(m, "cpu")
    start, entry = substep.report_entries(m)
    nct, nc = m.ncand_terrain, m.ncand
    mat = np.zeros((m.nreport, nct + 2 * m.npair), np.float32)
    for r in range(m.nreport):
        cols = [c if c >= 0 else nc + (-1 - c) - nct
                for c in entry[start[r]:start[r + 1]]]
        assert cols == sorted(cols)
        mat[r, cols] = 1.0
    np.testing.assert_array_equal(mat, mt.report_matrix.numpy())
    floats, ints = substep.pack_post(m)
    nf = len(m.foot_report_ids)
    assert floats.dtype == np.float32 and ints.dtype == np.int32
    assert floats.size == 2 * m.nj
    assert ints.size == nf + m.nreport + 1 + nct + 2 * m.npair
    np.testing.assert_array_equal(ints[:nf], m.foot_report_ids)


def mirror_post(mt, params, s, tau_j, v_free, W, lam, frame):
    """The kernel's design in plain PyTorch, env by env: W's columns of
    nonzero impulse alone, the frames of the contacts with an impulse, the
    report sums over the packed table in its order."""
    m = mt.model
    h = params.dt
    start, entry = substep.report_entries(m)
    outs = []
    for e in range(lam.shape[0]):
        nz = (lam[e] != 0).nonzero()[:, 0]
        v = v_free[e] + W[e][:, nz] @ lam[e, nz]
        q = s.qpos[e]
        base = q[0:3] + h * v[0:3]
        quat = tem.quat_integrate(q[3:7], tem.quat_rotate(q[3:7], v[3:6]), h)
        qn = q[7:] + h * v[6:]
        qc = torch.clamp(qn, mt.joint_lower, mt.joint_upper)
        qd = torch.where(qc != qn, 0.0, v[6:])
        lam_c = lam[e].reshape(-1, 3)
        f = lam_c.clone()
        act = (lam_c != 0).any(-1)
        if frame is not None:
            f[act] = torch.einsum("cji,cj->ci", frame[e][act], lam_c[act])
        f = f / h
        forces = torch.stack([
            sum((f[c] if c >= 0 else -f[-1 - c]
                 for c in entry[start[r]:start[r + 1]]),
                torch.zeros(3)) for r in range(m.nreport)])
        outs.append((torch.cat([base, quat, qc]), torch.cat([v[:6], qd]),
                     forces.reshape(-1)))
    qpos, qvel, forces = (torch.stack(x) for x in zip(*outs))
    plain = tem.post_stage(mt, params, s, tau_j, v_free, W, lam, frame)
    return plain._replace(
        qpos=qpos, qvel=qvel, forces=forces,
        joint_acc=(qvel[:, 6:] - s.qvel[:, 6:]) / h,
        force_hist=torch.cat([s.force_hist[:, 3 * m.nreport:], forces], 1))


@pytest.mark.parametrize("name", POST_CASES)
def test_mirror_of_the_kernel_design_equals_post_stage(name):
    """Skipping W's columns and frames of zero impulse and summing the
    report slots by the packed table: within compare_post of post_stage,
    and W * 0 columns skipped change no sum (the zero-impulse contacts'
    forces exactly 0)."""
    case, mt, s, tau_j, v_free, W, lam, frame = _problem(name)
    assert (lam.reshape(N, -1, 3) == 0).all(-1).any()   # some skipped
    out = mirror_post(mt, case.params, s, tau_j, v_free, W, lam, frame)
    ref = tem.post_stage(mt, case.params, s, tau_j, v_free, W, lam, frame)
    _assert_agree(mt, case.params, s, v_free, W, lam, out, ref,
                  f"{name} mirror")
    zero = out._replace(qvel=v_free.clone())
    kept = mirror_post(mt, case.params, s, tau_j, v_free, W,
                       torch.zeros_like(lam), frame)
    assert torch.equal(kept.qvel[:, :6], zero.qvel[:, :6])


def test_post_counts_read_only_the_impulses_columns():
    """The bound's bytes: every column of W and every frame with every
    impulse nonzero (~11.1 KB an env at Solo12's shape), fewer with only
    some."""
    m = make_case("solo12-plane", 1).model
    full, flops = measure.post_counts(m, 4096, frames=True,
                                      lam=torch.ones(4096, 3 * m.ncand))
    assert 11_000 < full / 4096 < 11_300 and flops > 0
    lam = torch.zeros(4096, 3 * m.ncand)
    lam[:, :12] = 1.0                                    # 4 contacts
    part, _ = measure.post_counts(m, 4096, frames=True, lam=lam)
    assert part == full - 4 * 4096 * ((108 - 12) * 18 + 9 * 32)
