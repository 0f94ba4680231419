"""Full control steps of the port's engine against the JAX package's lanes
engine with the block-Jacobi solve (bj:4:0.9:6, the env default) through
its pure-XLA mirror, as tests/test_lanes.py::test_full_control_step_matches
and ::..._with_com_offset compare the JAX package's two layouts.

Tolerances are those of tests/test_lanes.py (qpos atol 2e-3, qvel atol
2e-2, forces rtol/atol 0.05 after 10 chained steps through contact), and
tighter where the runs agree better (impulses, sensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from cat_tpu.models.solo12 import solo12_model as jax_solo12
from cat_tpu.sim import engine as jem
from cat_tpu.sim.maths import quat_from_euler_zyx
from cat_tpu.sim.solver import SolverParams as JaxSolverParams
from cat_tpu_torch.models.solo12 import solo12_model as port_solo12
from cat_tpu_torch.sim import engine as tem
from cat_tpu_torch.sim.solver import SolverParams

N = 4
BJ = dict(structure="bj", bj_blocks=4, omega=0.9, iterations=6)


def _states():
    model = jax_solo12()
    rng = np.random.default_rng(0)
    qpos = np.tile(model.default_qpos(), (N, 1)).astype(np.float32)
    qpos[:, 0:3] += rng.uniform(-0.1, 0.1, (N, 3))
    ang = rng.uniform(-0.3, 0.3, (N, 3))
    qpos[:, 3:7] = np.asarray(quat_from_euler_zyx(*map(jnp.asarray, ang.T)))
    qpos[:, 7:] += rng.uniform(-0.3, 0.3, (N, model.nj))
    qvel = rng.uniform(-1.0, 1.0, (N, model.nv)).astype(np.float32)
    return qpos, qvel


@pytest.fixture(scope="module")
def step_j():
    """One compiled JAX program for every case (the CoM offset is always
    passed; zeros where a case has none)."""
    return jax.jit(jem.make_batched_step(
        jax_solo12(), jem.EngineParams(solver=JaxSolverParams(**BJ)),
        layout="lanes"))


def _run(step_j, steps, com=None, vel_scale=0.2, seed=1):
    """Chain `steps` control steps in both engines from the same state."""
    model = jax_solo12()
    qpos, qvel = _states()
    qvel = qvel * vel_scale
    rng = np.random.default_rng(seed)
    mu = (rng.uniform(0.6, 1.2, N) if com is None else np.ones(N)).astype(np.float32)
    step_t = tem.make_batched_step(
        port_solo12(), tem.EngineParams(solver=SolverParams(**BJ)), device="cpu")
    sj = jem.make_batched_init(model, N)._replace(
        qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel))
    st = tem.make_batched_init(port_solo12(), N, "cpu")._replace(
        qpos=torch.from_numpy(qpos), qvel=torch.from_numpy(qvel))
    com_j = jnp.zeros((N, model.nbody, 3)) if com is None else jnp.asarray(com)
    com_t = None if com is None else torch.from_numpy(com)
    for i in range(steps):
        target = (np.tile(model.default_qpos_joints, (N, 1))
                  + (0.1 * np.sin(0.3 * i) if com is None else 0.0)
                  ).astype(np.float32)
        sj = step_j(sj, jnp.asarray(target), jnp.asarray(mu), com_j)
        st = step_t(st, torch.from_numpy(target), torch.from_numpy(mu), com_t)
    return sj, st


def _cmp(sj, st, field, **tol):
    np.testing.assert_allclose(getattr(st, field).numpy(),
                               np.asarray(getattr(sj, field)), **tol)


@pytest.fixture(scope="module")
def ten_steps(step_j):
    return _run(step_j, 10)


@pytest.mark.parametrize("field,tol", [
    ("qpos", dict(atol=2e-3)), ("qvel", dict(atol=2e-2)),
    ("lam", dict(atol=1e-4)), ("applied_torque", dict(atol=1e-3)),
    ("forces", dict(rtol=0.05, atol=0.05)),
    ("force_hist", dict(rtol=0.05, atol=0.05)),
    ("current_air_time", dict(atol=1e-6)), ("last_air_time", dict(atol=1e-6)),
    ("current_contact_time", dict(atol=1e-6)),
    ("last_contact_time", dict(atol=1e-6)), ("touchdown", dict()),
])
def test_full_control_step_matches(ten_steps, field, tol):
    sj, st = ten_steps
    _cmp(sj, st, field, **tol)


def test_full_control_step_matches_with_com_offset(step_j):
    rng = np.random.default_rng(2)
    com = rng.uniform(-0.01, 0.01, (N, jax_solo12().nbody, 3)).astype(np.float32)
    sj, st = _run(step_j, 5, com=com, vel_scale=1.0)
    _cmp(sj, st, "qpos", atol=2e-3)
    _cmp(sj, st, "qvel", atol=2e-2)


def test_robot_stands_on_the_plane():
    """Statics of tests/test_engine.py on the port: from the default pose
    the robot settles, its feet carry its weight, nothing sinks deep."""
    model = port_solo12()
    step = tem.make_batched_step(model, tem.EngineParams(
        solver=SolverParams(**BJ)), device="cpu")
    s = tem.make_batched_init(model, 2, "cpu")
    target = torch.as_tensor(model.default_qpos_joints,
                             dtype=torch.float32).expand(2, 12)
    mu = torch.full((2,), 0.8)
    for _ in range(50):
        s = step(s, target, mu)
    z = s.qpos[:, 2]
    assert bool(((z > 0.15) & (z < 0.4)).all()), z
    weight = float(model.mass.sum()) * 9.81
    fz = s.forces.reshape(2, model.nreport, 3)[:, model.foot_report_ids, 2]
    torch.testing.assert_close(fz.sum(dim=1), torch.full((2,), weight),
                               rtol=0.1, atol=0.0)
