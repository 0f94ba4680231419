"""Each dynamics stage and the contact rows of the port against the JAX
package's env-last ("lanes") versions, transposed, on the states of
tests/test_lanes.py (and the crossed-legs states of
tests/test_self_collision.py for the pair rows).

Tolerances, float32 throughout: kinematics, Jacobians and contact rows
atol 1e-5 (sums of a few unit-scale products); M and C rtol 1e-4 / atol
1e-5 and 1e-4 (sums over 13 bodies); M^-1 rtol/atol 2e-3, the bound the
JAX package holds its own two layouts to (M is ill-conditioned: entries of
M^-1 reach ~2e3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from cat_tpu.models.solo12 import solo12_model as jax_solo12
from cat_tpu.sim import dynamics_lanes as dl
from cat_tpu.sim.maths import quat_from_euler_zyx
from cat_tpu.sim.terrain import plane as jax_plane
from cat_tpu_torch.models.solo12 import solo12_model as port_solo12
from cat_tpu_torch.sim import collision as tc
from cat_tpu_torch.sim import dynamics as td
from cat_tpu_torch.sim.terrain import plane as port_plane

N = 4


def _states(crossed=False):
    model = jax_solo12()
    rng = np.random.default_rng(3 if crossed else 0)
    qpos = np.tile(model.default_qpos(), (N, 1)).astype(np.float32)
    if crossed:
        # front legs swung inward by +-0.7 rad at the hip (both signs: one
        # crosses the shins), as tests/test_self_collision.py does
        jfl = 7 + model.joint_names.index("FL_HAA")
        jfr = 7 + model.joint_names.index("FR_HAA")
        s = np.array([1.0, 1.0, -1.0, -1.0], np.float32)
        qpos[:, jfl], qpos[:, jfr] = -0.7 * s, 0.7 * s
        qpos[:, 7:] += rng.uniform(-0.05, 0.05, (N, model.nj))
    else:
        qpos[:, 0:3] += rng.uniform(-0.1, 0.1, (N, 3))
        ang = rng.uniform(-0.3, 0.3, (N, 3))
        qpos[:, 3:7] = np.asarray(quat_from_euler_zyx(*map(jnp.asarray, ang.T)))
        qpos[:, 7:] += rng.uniform(-0.3, 0.3, (N, model.nj))
    qvel = rng.uniform(-1.0, 1.0, (N, model.nv)).astype(np.float32)
    return qpos, qvel


@pytest.fixture(scope="module")
def stages():
    model = jax_solo12()
    anc = model.ancestor_mask()
    qpos, qvel = _states()
    kin = dl.fk_lanes(model, jnp.asarray(qpos.T), jnp.asarray(qvel.T))
    jacs = dl.body_jacobians_lanes(model, kin, anc)
    Iw = dl.world_inertias_lanes(model, kin)
    M = dl.mass_matrix_lanes(model, jacs, Iw)
    ref = dict(
        kin=kin, jacs=jacs, Iw=Iw, M=M,
        C=dl.bias_forces_lanes(model, kin, jacs, Iw, jnp.asarray(qvel.T)),
        Minv=dl.mass_matrix_inverse_lanes(M, n_branch=model.nj // 3),
        con=dl.detect_contacts_lanes(model, jax_plane(), kin, anc),
    )
    mt = td.ModelTensors.build(port_solo12(), "cpu")
    q, v = torch.from_numpy(qpos), torch.from_numpy(qvel)
    kin2 = td.fk(mt, q, v)
    jacs2 = td.body_jacobians(mt, kin2)
    Iw2 = td.world_inertias(mt, kin2)
    M2 = td.mass_matrix(mt, jacs2, Iw2)
    port = dict(
        kin=kin2, jacs=jacs2, Iw=Iw2, M=M2,
        C=td.bias_forces(mt, kin2, jacs2, Iw2, v),
        Minv=td.mass_matrix_inverse(M2, n_branch=4),
        con=tc.detect_contacts(mt, port_plane(), kin2),
    )
    return ref, port


def _env_first(x):
    return np.moveaxis(np.asarray(x), -1, 0)


@pytest.mark.parametrize("field", ["R", "o", "omega", "v_o", "x_com", "a_w",
                                   "o_j"])
def test_kinematics_match(stages, field):
    ref, port = stages
    np.testing.assert_allclose(getattr(port["kin"], field).numpy(),
                               _env_first(getattr(ref["kin"], field)), atol=1e-5)


@pytest.mark.parametrize("stage,rtol,atol", [
    ("Jv", 0, 1e-5), ("Jw", 0, 1e-5), ("Iw", 0, 1e-7), ("M", 1e-4, 1e-5),
    ("C", 1e-4, 1e-4), ("Minv", 2e-3, 2e-3),
])
def test_dynamics_stages_match(stages, stage, rtol, atol):
    ref, port = stages
    if stage in ("Jv", "Jw"):
        a, b = getattr(ref["jacs"], stage), getattr(port["jacs"], stage)
    else:
        a, b = ref[stage], port[stage]
    np.testing.assert_allclose(b.numpy(), _env_first(a), rtol=rtol, atol=atol)


def test_mass_matrix_spd(stages):
    _, port = stages
    M = port["M"].double()
    torch.testing.assert_close(M, M.transpose(1, 2))
    assert torch.linalg.eigvalsh(M).min() > 0
    eye = torch.eye(18, dtype=torch.float64).expand_as(M)
    torch.testing.assert_close(M @ port["Minv"].double(), eye, atol=1e-3, rtol=0)


@pytest.mark.parametrize("field", ["phi", "E", "frame"])
def test_contacts_match_plane(stages, field):
    ref, port = stages
    np.testing.assert_allclose(getattr(port["con"], field).numpy(),
                               _env_first(getattr(ref["con"], field)), atol=1e-5)


def test_pair_rows_match_between_layouts():
    """Self-collision rows with the front shins crossed (penetrating):
    phi, E and the contact frames."""
    model = jax_solo12()
    anc = model.ancestor_mask()
    qpos, qvel = _states(crossed=True)
    kin = dl.fk_lanes(model, jnp.asarray(qpos.T), jnp.asarray(qvel.T))
    phi, Jc, frame = dl.detect_pair_contacts_lanes(model, kin, anc)
    mt = td.ModelTensors.build(port_solo12(), "cpu")
    kin2 = td.fk(mt, torch.from_numpy(qpos), torch.from_numpy(qvel))
    phi2, Jc2, frame2 = tc.detect_pair_contacts(mt, kin2)
    assert float(phi2[:, 0].min()) < 0.0
    np.testing.assert_allclose(phi2.numpy(), _env_first(phi), atol=1e-5)
    np.testing.assert_allclose(Jc2.numpy(), _env_first(Jc), atol=1e-4)
    np.testing.assert_allclose(frame2.numpy(), _env_first(frame), atol=1e-5)
