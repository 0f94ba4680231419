"""The port's robot model and quaternion maths against the JAX package's.

Tolerance: the maths functions are elementwise float32 arithmetic in the
same order, so they agree to a few float32 ulps (atol 1e-6 on unit-scale
values); the model is numpy data and must be equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from cat_tpu.models.solo12 import solo12_model as jax_solo12
from cat_tpu.sim import maths as jm
from cat_tpu_torch.models.solo12 import solo12_model as port_solo12
from cat_tpu_torch.sim import maths as tm


@pytest.mark.parametrize("self_collisions", [True, False])
def test_model_fields_equal(self_collisions):
    a, b = jax_solo12(self_collisions), port_solo12(self_collisions)
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert tuple(va) == tuple(vb), f.name
    assert (a.ncand, a.nv, a.nq, a.nreport) == (b.ncand, b.nv, b.nq, b.nreport)


def test_model_topology_equal():
    a, b = jax_solo12(), port_solo12()
    np.testing.assert_array_equal(a.ancestor_mask(), b.ancestor_mask())
    assert a.branches() == b.branches()
    assert a.uniform_3dof_branches() and b.uniform_3dof_branches()
    np.testing.assert_array_equal(a.default_qpos(), b.default_qpos())
    assert b.ncand == 36 and b.nv == 18


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _cases():
    rng = np.random.default_rng(0)
    q, q2 = _unit_quats(rng, 16), _unit_quats(rng, 16)
    v = rng.normal(size=(16, 3)).astype(np.float32)
    w = rng.normal(size=(16, 3)).astype(np.float32) * 3.0
    ang = rng.uniform(-3.0, 3.0, size=(3, 16)).astype(np.float32)
    return {
        "quat_mul": ((q, q2), {}),
        "quat_conj": ((q,), {}),
        "quat_rotate": ((q, v), {}),
        "quat_rotate_inv": ((q, v), {}),
        "quat_to_mat": ((q,), {}),
        "quat_from_euler_zyx": (tuple(ang), {}),
        "quat_integrate": ((q, w, 0.005), {}),
        "quat_yaw": ((q,), {}),
        "skew": ((v,), {}),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_maths_matches_jax(name):
    args, _ = _cases()[name]
    ja = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    ta = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]
    if name == "quat_integrate":  # the JAX function is single-env
        ref = np.stack([np.asarray(jm.quat_integrate(ja[0][i], ja[1][i], 0.005))
                        for i in range(ja[0].shape[0])])
    else:
        ref = np.asarray(getattr(jm, name)(*ja))
    np.testing.assert_allclose(getattr(tm, name)(*ta).numpy(), ref,
                               atol=1e-6, rtol=1e-6)


# the cases of tests/test_maths.py, on the port

def test_quat_rotate_matches_matrix():
    q = torch.from_numpy(_unit_quats(np.random.default_rng(1), 10))
    v = torch.from_numpy(np.random.default_rng(2).normal(size=(10, 3)).astype(np.float32))
    out = tm.quat_rotate(q, v)
    ref = torch.matmul(tm.quat_to_mat(q), v[..., None])[..., 0]
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=0)


def test_quat_mul_composition_and_inverse():
    rng = np.random.default_rng(3)
    a, b = (torch.from_numpy(_unit_quats(rng, 1)[0]) for _ in range(2))
    v = torch.from_numpy(rng.normal(size=3).astype(np.float32))
    torch.testing.assert_close(tm.quat_rotate(tm.quat_mul(a, b), v),
                               tm.quat_rotate(a, tm.quat_rotate(b, v)),
                               atol=1e-6, rtol=0)
    torch.testing.assert_close(tm.quat_rotate_inv(a, tm.quat_rotate(a, v)), v,
                               atol=1e-6, rtol=0)


def test_quat_integrate_constant_omega():
    q = torch.tensor([1.0, 0.0, 0.0, 0.0])
    omega = torch.tensor([0.0, 0.0, np.pi], dtype=torch.float32)
    for _ in range(100):
        q = tm.quat_integrate(q, omega, 0.005)
    assert abs(float(tm.quat_yaw(q)) - np.pi / 2) < 1e-5


def test_quat_from_euler_yaw_and_skew():
    q = tm.quat_from_euler_zyx(torch.tensor(0.0), torch.tensor(0.0),
                               torch.tensor(1.0))
    assert abs(float(tm.quat_yaw(q)) - 1.0) < 1e-6
    v, u = torch.tensor([1.0, 2.0, 3.0]), torch.tensor([-1.0, 0.5, 2.0])
    torch.testing.assert_close(tm.skew(v) @ u, torch.linalg.cross(v, u))
