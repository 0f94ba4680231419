"""The port's last public helpers against the JAX package's: the 15
constraint terms, the maths helpers, the one-point Jacobian, the plane
contacts, one env's initial state and the dense serial PGS solve.

Inputs are made from numpy seeds and fed to both packages. Tolerances,
float32 throughout: constraint terms rtol 1e-6 / atol 1e-6 (the same few
operations on the same inputs); maths atol 1e-6; Jacobians and contact rows
atol 1e-5 (sums of a few unit-scale products, as tests/test_torch_dynamics.py
holds them); initial states exact; the dense solve atol 2e-6 x max|lam|
at 5 and at 100 sweeps (the two packages round the products in their own
order; measured <= 2.5e-7 x max|lam|); the dense
solve against the port's own plain serial solve on (E, W) ``measure``'s
kernel tolerance (rtol 2e-4, atol 2e-5 x max|lam|).
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from cat_tpu.envs import constraints as JC
from cat_tpu.envs.types import StepData as JStepData
from cat_tpu.models.solo12 import solo12_model as jax_solo12
from cat_tpu.sim import collision as jcol
from cat_tpu.sim import dynamics as jdyn
from cat_tpu.sim import engine as jeng
from cat_tpu.sim import maths as jm
from cat_tpu.sim import solver as jsolver
from cat_tpu_torch import measure
from cat_tpu_torch.envs import constraints as TC
from cat_tpu_torch.envs.types import StepData
from cat_tpu_torch.models.solo12 import solo12_model as port_solo12
from cat_tpu_torch.ops import pgs
from cat_tpu_torch.sim import collision as tcol
from cat_tpu_torch.sim import dynamics as tdyn
from cat_tpu_torch.sim import engine as teng
from cat_tpu_torch.sim import maths as tm
from cat_tpu_torch.sim import solver as tsolver

N = 16

# ---------------------------------------------------------------- constraints

J12 = np.arange(12, dtype=np.int64)
TERMS = [
    ("joint_position", dict(limit=0.5, joint_ids=np.array([1, 4]))),
    ("joint_position_when_moving_forward",
     dict(limit=0.2, velocity_deadzone=0.3, joint_ids=np.array([0, 3, 6, 9]))),
    ("joint_torque", dict(limit=3.0, joint_ids=J12)),
    ("joint_velocity", dict(limit=16.0, joint_ids=J12)),
    ("joint_acceleration", dict(limit=800.0, joint_ids=J12)),
    ("upsidedown", dict(limit=0.0)),
    ("contact", dict(body_ids=np.array([0, 1, 4]))),
    ("base_orientation", dict(limit=0.1)),
    ("air_time", dict(limit=0.25, velocity_deadzone=0.5,
                      body_ids=np.array([0, 1, 2, 3]))),
    ("n_foot_contact", dict(number_of_desired_feet=2, min_command_value=0.5,
                            body_ids=np.array([3, 6, 9, 12]))),
    ("joint_range", dict(limit=0.4, joint_ids=J12)),
    ("action_rate", dict(limit=80.0, joint_ids=J12)),
    ("foot_contact_force", dict(limit=50.0, body_ids=np.array([3, 6, 9, 12]))),
    ("min_base_height", dict(limit=0.25)),
    ("no_move", dict(velocity_deadzone=0.8, joint_vel_limit=4.0,
                     joint_ids=J12)),
]


def _step_data(seed=5):
    """The same random StepData for both packages (13 report bodies, 4
    feet; forces and touchdowns so that every term fires somewhere)."""
    rng = np.random.default_rng(seed)
    arrs = dict(
        joint_pos=rng.normal(0, 1.0, (N, 12)),
        joint_vel=rng.normal(0, 10, (N, 12)),
        joint_acc=rng.normal(0, 500, (N, 12)),
        applied_torque=rng.normal(0, 3, (N, 12)),
        default_joint_pos=rng.normal(0, 0.5, 12),
        base_pos=rng.normal(0, 0.1, (N, 3)) + [0, 0, 0.25],
        base_yaw=rng.uniform(-3, 3, N),
        base_lin_vel_b=rng.normal(0, 0.5, (N, 3)),
        base_ang_vel_b=rng.normal(0, 0.5, (N, 3)),
        projected_gravity=rng.normal(0, 0.3, (N, 3)) - [0, 0, 1],
        command=rng.uniform(-1, 1, (N, 3)),
        action=rng.normal(0, 1, (N, 12)),
        prev_action=rng.normal(0, 1, (N, 12)),
        force_hist=np.abs(rng.normal(0, 20, (N, 3, 13, 3))),
        last_air_time=rng.uniform(0, 0.5, (N, 4)),
    )
    arrs = {k: np.asarray(v, np.float32) for k, v in arrs.items()}
    touchdown = rng.uniform(size=(N, 4)) < 0.5
    dj = JStepData(**{k: jnp.asarray(v) for k, v in arrs.items()},
                   touchdown=jnp.asarray(touchdown), step_dt=0.02)
    dt = StepData(**{k: torch.from_numpy(v) for k, v in arrs.items()},
                  touchdown=torch.from_numpy(touchdown), step_dt=0.02)
    return dj, dt


@pytest.mark.parametrize("name,params", TERMS, ids=[t[0] for t in TERMS])
def test_constraint_term_matches(name, params):
    dj, dt = _step_data()
    ref = getattr(JC, name)(dj, **params)
    port = getattr(TC, name)(dt, **{
        k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
        for k, v in params.items()})
    assert tuple(port.shape) == tuple(ref.shape)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_every_constraint_term_is_ported():
    public = {n for n, f in vars(JC).items()
              if inspect.isfunction(f) and not n.startswith("_")
              and f.__module__ == JC.__name__}
    assert public == {name for name, _ in TERMS}
    assert all(callable(getattr(TC, name, None)) for name in public)


def test_min_base_height_literal():
    """tests/test_constraints.py's case: base heights 0.1 and 0.5."""
    _, dt = _step_data()
    d = dt._replace(base_pos=torch.tensor([[0, 0, 0.1], [0, 0, 0.5]]))
    np.testing.assert_allclose(TC.min_base_height(d, limit=0.2).numpy(),
                               [0.1, -0.3], atol=1e-6)


# ---------------------------------------------------------------- maths

def test_quat_identity():
    np.testing.assert_array_equal(tm.quat_identity(device="cpu").numpy(),
                                  np.asarray(jm.quat_identity()))


@pytest.mark.parametrize("batched_axis", [False, True])
def test_quat_from_axis_angle(batched_axis):
    rng = np.random.default_rng(1)
    angle = rng.uniform(-4, 4, N).astype(np.float32)
    axis = rng.normal(size=(N, 3) if batched_axis else 3)
    axis = (axis / np.linalg.norm(axis, axis=-1, keepdims=True)).astype(
        np.float32)
    ref = jm.quat_from_axis_angle(jnp.asarray(axis), jnp.asarray(angle))
    port = tm.quat_from_axis_angle(torch.from_numpy(axis),
                                   torch.from_numpy(angle))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-6)


def test_wrap_to_pi():
    rng = np.random.default_rng(2)
    angle = np.concatenate([
        rng.uniform(-20, 20, 64),
        [np.pi, -np.pi, 0.0, 2 * np.pi, -2 * np.pi, 4 * np.pi, -6 * np.pi,
         3 * np.pi, -3 * np.pi]]).astype(np.float32)
    ref = np.asarray(jm.wrap_to_pi(jnp.asarray(angle)))
    port = tm.wrap_to_pi(torch.from_numpy(angle)).numpy()
    np.testing.assert_allclose(port, ref, atol=1e-6)
    assert port.min() >= -np.float32(np.pi) and port.max() <= np.pi


# ------------------------------------------------- point Jacobian, contacts

def _poses(seed=0):
    model = jax_solo12()
    rng = np.random.default_rng(seed)
    qpos = np.tile(model.default_qpos(), (N, 1)).astype(np.float32)
    qpos[:, 0:3] += rng.uniform(-0.1, 0.1, (N, 3))
    ang = rng.uniform(-0.3, 0.3, (N, 3))
    qpos[:, 3:7] = np.asarray(jm.quat_from_euler_zyx(*map(jnp.asarray, ang.T)))
    qpos[:, 7:] += rng.uniform(-0.5, 0.5, (N, model.nj))
    qvel = rng.uniform(-1.0, 1.0, (N, model.nv)).astype(np.float32)
    return model, qpos, qvel


@pytest.fixture(scope="module")
def kins():
    model, qpos, qvel = _poses()
    kin_j = jax.vmap(lambda q, v: jdyn.fk(model, q, v))(jnp.asarray(qpos),
                                                        jnp.asarray(qvel))
    mt = tdyn.ModelTensors.build(port_solo12(), "cpu")
    kin_t = tdyn.fk(mt, torch.from_numpy(qpos), torch.from_numpy(qvel))
    return model, mt, kin_j, kin_t


@pytest.mark.parametrize("body", range(13))
def test_point_jacobian_matches(kins, body):
    """Each body of Solo12, at a random world point an env."""
    model, mt, kin_j, kin_t = kins
    assert model.nbody == 13
    x = np.random.default_rng(body).normal(0, 0.3, (N, 3)).astype(np.float32)
    mask_row = model.ancestor_mask()[body]
    ref = jax.vmap(lambda k, p: jdyn.point_jacobian(model, k, body, p,
                                                    mask_row))(
        kin_j, jnp.asarray(x))
    port = tdyn.point_jacobian(kin_t, mt.anc[body], torch.from_numpy(x))
    assert tuple(port.shape) == (N, 3, model.nv)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-5)
    # a numpy mask row works as well
    np.testing.assert_array_equal(
        tdyn.point_jacobian(kin_t, mask_row, torch.from_numpy(x)).numpy(),
        port.numpy())


@pytest.mark.parametrize("field", ["phi", "E", "frame"])
def test_detect_plane_contacts_matches(kins, field):
    model, mt, kin_j, kin_t = kins
    anc = model.ancestor_mask()
    ref = jax.vmap(lambda k: jcol.detect_plane_contacts(model, k, anc))(kin_j)
    port = tcol.detect_plane_contacts(mt, kin_t)
    want = {"phi": ref.phi, "frame": ref.frame,
            "E": jnp.reshape(ref.J, (N, 3 * model.ncand, model.nv))}[field]
    np.testing.assert_allclose(getattr(port, field).numpy(), np.asarray(want),
                               atol=1e-5)


# ---------------------------------------------------------------- init state

@pytest.mark.parametrize("given", [False, True])
def test_init_state_matches(given):
    model = jax_solo12()
    kw = {}
    if given:
        rng = np.random.default_rng(4)
        kw = dict(qpos=model.default_qpos() + rng.uniform(-0.1, 0.1, model.nq),
                  qvel=rng.uniform(-1, 1, model.nv))
    ref = jeng.init_state(model, **kw)
    port = teng.init_state(port_solo12(), device="cpu", **kw)
    assert port._fields == ref._fields
    for name, r, p in zip(ref._fields, ref, port):
        assert tuple(p.shape) == r.shape, name
        assert p.device.type == "cpu"
        np.testing.assert_array_equal(p.numpy(), np.asarray(r), err_msg=name)


def test_make_batched_init_matches():
    ref = jeng.make_batched_init(jax_solo12(), 4)
    port = teng.make_batched_init(port_solo12(), 4, device="cpu")
    for name, r, p in zip(ref._fields, ref, port):
        assert p.dtype == (torch.bool if name == "touchdown"
                           else torch.float32), name
        np.testing.assert_array_equal(p.numpy(), np.asarray(r), err_msg=name)
    # each env's rows are its own (written in place by the env's reset)
    port.qpos[0, 0] += 1.0
    assert port.qpos[1, 0] != port.qpos[0, 0]


def test_make_batched_init_takes_the_reference_call():
    """make_batched_init(model, n), the reference's call, runs on the card
    by default (chip_smoke.py makes that call there)."""
    sig = inspect.signature(teng.make_batched_init)
    assert list(sig.parameters)[:2] == ["model", "n"]
    assert sig.parameters["device"].default == "cuda"
    assert inspect.signature(teng.init_state).parameters[
        "device"].default == "cuda"


# ---------------------------------------------------------------- pgs_solve

def _random_problem(seed, n=4, nc=8, nv=10):
    """Random SPD Delassus problems: A = J M^-1 J^T, half the contacts
    penetrating, a warm start, per-env friction."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(n, 3 * nc, nv))
    L = rng.normal(size=(n, nv, nv))
    M = L @ np.swapaxes(L, 1, 2) + nv * np.eye(nv)
    A = (J @ np.linalg.solve(M, np.swapaxes(J, 1, 2))).astype(np.float32)
    A = 0.5 * (A + np.swapaxes(A, 1, 2))
    b = (J @ rng.normal(size=(n, nv, 1)))[..., 0].astype(np.float32)
    phi = rng.uniform(-0.01, 0.01, (n, nc)).astype(np.float32)
    mu = rng.uniform(0.5, 1.25, n).astype(np.float32)
    lam0 = rng.uniform(0, 0.05, (n, nc, 3)).astype(np.float32)
    return A, b, phi, mu, lam0


@functools.lru_cache(maxsize=1)
def _captured_problem():
    """One captured flat problem of the port's env (4 envs after 5 control
    steps under seeded actions): A = E W, b and phi of the substep."""
    from cat_tpu_torch.tasks import solo12_flat

    env = solo12_flat.make_env(4, device="cpu")
    gen = torch.Generator().manual_seed(0)
    es = env.init(gen, 4)
    rng = np.random.default_rng(0)
    for _ in range(5):
        a = torch.from_numpy(rng.uniform(-1, 1, (4, 12)).astype(np.float32))
        es = env.step(es, a, gen)[0]
    target = env.default_joint_pos_task[env.m2t].expand(4, 12)
    _, _, E, W, b, phi, _ = teng.substep_pre(env.engine.mt, env.engine.params,
                                             env.engine.terrain, es.sim.qpos,
                                             es.sim.qvel, target)
    A = torch.matmul(E, W).numpy()
    return (A, b.numpy(), phi.numpy(), es.mu.numpy(),
            es.sim.lam.reshape(4, -1, 3).numpy()), (E, W, b, phi, es)


def _solve_both(problem, iterations):
    A, b, phi, mu, lam0 = problem
    h = 0.005
    jp = jsolver.SolverParams(iterations=iterations)
    ref = jax.jit(jax.vmap(
        lambda *a: jsolver.pgs_solve(*a, h, jp)))(
        *map(jnp.asarray, (A, b, phi, mu, lam0)))
    port = tsolver.pgs_solve(*map(torch.from_numpy, (A, b, phi, mu, lam0)), h,
                             tsolver.SolverParams(iterations=iterations))
    return np.asarray(ref), port.numpy()


@pytest.mark.parametrize("kind,iterations", [
    ("random", 5), ("random", 100), ("captured", 5), ("captured", 100),
])
def test_pgs_solve_matches(kind, iterations):
    problem = (_random_problem(7) if kind == "random"
               else _captured_problem()[0])
    ref, port = _solve_both(problem, iterations)
    assert port.shape == ref.shape == problem[4].shape
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=2e-6 * np.abs(ref).max())


def test_pgs_solve_unbatched_and_scalar_mu():
    """One env with no batch axis and a scalar friction, as the reference
    takes it (a batch of one rounds its products in another order: atol
    2e-5 x max|lam|)."""
    A, b, phi, mu, lam0 = _random_problem(8, n=1)
    p = tsolver.SolverParams()
    one = tsolver.pgs_solve(*map(torch.from_numpy, (A[0], b[0], phi[0])),
                            float(mu[0]), torch.from_numpy(lam0[0]), 0.005, p)
    batched = tsolver.pgs_solve(*map(torch.from_numpy, (A, b, phi, mu, lam0)),
                                0.005, p)
    assert one.shape == batched[0].shape
    torch.testing.assert_close(one, batched[0], rtol=0,
                               atol=2e-5 * float(batched.abs().max()))


def test_pgs_solve_is_the_serial_kernels_solve():
    """The dense solve at A = E W is the serial GS-5 solve the kernel's
    plain version makes on (E, W)."""
    _, (E, W, b, phi, es) = _captured_problem()
    sp = tsolver.SolverParams()
    n = E.shape[0]
    lam = tsolver.pgs_solve(torch.matmul(E, W), b, phi, es.mu,
                            es.sim.lam.reshape(n, -1, 3), 0.005, sp)
    plain = pgs.pgs_gs_reference(
        E, W, b, tsolver.contact_bias(phi, 0.005, sp),
        (phi < sp.margin).float(), es.mu, es.sim.lam,
        iterations=sp.iterations, cfm=sp.cfm)
    err, scale, bad = measure.disagreement(lam.reshape(n, -1), plain)
    assert scale > 0 and bad == 0, (err, scale)
