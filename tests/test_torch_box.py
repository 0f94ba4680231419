"""The port's raw engine on a model without 3-dof legs: the joint-less box
of tests/test_slope.py (4 corner spheres, nc = 4, nv = 6), whose M^-1
comes from the unrolled Cholesky, held step for step against the JAX
engine (its env-leading layout, the CPU default, whose serial solve
solver.pgs_solve the port's GS-5 mirrors), and the reference's positional
order of make_batched_step.

Tolerances: those of tests/test_lanes.py and tests/test_torch_engine.py
for chained control steps, qpos atol 2e-3 and qvel atol 2e-2. The two
engines run the same float32 physics with sums in other orders; over 100
control steps they agree to some 5e-6 in qpos and 3e-4 in qvel on the
slope, and to 1.0e-4 and 3.9e-3 on the pyramid's diagonal ridge, where
the box rocks on the crease. The physical criteria are those of
tests/test_slope.py and tests/test_hfield_edges.py, checked on the port's
own states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from test_hfield_edges import _corner_gaps, _pyramid_terrain
from test_linalg import _spd
from test_slope import _box_model, _slope_terrain
from cat_tpu.sim import dynamics as jdyn
from cat_tpu.sim import engine as jem
from cat_tpu.sim.terrain import height_at as jheight_at
from cat_tpu_torch.models.box import box_model, on_slope_qpos, slope_terrain
from cat_tpu_torch.sim import dynamics as tdyn
from cat_tpu_torch.sim import engine as tem
from cat_tpu_torch.sim import terrain as tt

STEPS = 100
QPOS_ATOL, QVEL_ATOL = 2e-3, 2e-2


@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_cholesky_solve_matches_jax(rhs):
    """The inputs of tests/test_linalg.py::test_cholesky_solve_vec_and_mat."""
    rng = np.random.default_rng(1)
    n = 18
    M = _spd(rng, n)
    b = rng.normal(size=n).astype(np.float32)
    B = rng.normal(size=(n, 7)).astype(np.float32)
    rhs_np = b if rhs == "vector" else B
    ref = np.asarray(jdyn.cholesky_solve(jdyn.cholesky_factor(jnp.asarray(M)),
                                         jnp.asarray(rhs_np)))
    L = tdyn.cholesky_factor(torch.from_numpy(M)[None])
    got = tdyn.cholesky_solve(L, torch.from_numpy(rhs_np)[None])[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(M @ got, rhs_np, rtol=2e-3, atol=2e-3)


def test_box_model_is_the_jax_box():
    port, ref = box_model(), _box_model()
    for f in ("parent", "mass", "com", "inertia", "cand_body", "cand_offset",
              "cand_radius", "cand_report", "default_base_pos",
              "foot_report_ids"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
    assert (port.nv, port.ncand, port.uniform_3dof_branches()) == (6, 4, False)
    slope = np.tan(np.deg2rad(25.0))
    np.testing.assert_array_equal(slope_terrain(25.0).height,
                                  _slope_terrain(slope).height)


def _run_both(terr_j, terr_t, qpos, mu):
    """STEPS control steps of the default raw engine in both packages from
    the same states; (qpos, qvel) after every step, (STEPS, n, .) each."""
    n = qpos.shape[0]
    step_j = jem.make_batched_step(_box_model(), jem.EngineParams(),
                                   num_envs=n, terrain=terr_j)

    @jax.jit
    def run(s, mu):
        def body(s, _):
            s = step_j(s, jnp.zeros((n, 0)), mu)
            return s, (s.qpos, s.qvel)
        return jax.lax.scan(body, s, None, length=STEPS)[1]

    sj = jem.make_batched_init(_box_model(), n)._replace(
        qpos=jnp.asarray(qpos))
    ref = tuple(map(np.asarray, run(sj, jnp.asarray(mu))))
    step_t = tem.make_batched_step(box_model(), tem.EngineParams(), n,
                                   terr_t, device="cpu")
    st = tem.make_batched_init(box_model(), n, "cpu")._replace(
        qpos=torch.from_numpy(qpos))
    qs, vs = [], []
    for _ in range(STEPS):
        st = step_t(st, torch.zeros(n, 0), torch.from_numpy(mu))
        qs.append(st.qpos.numpy())
        vs.append(st.qvel.numpy())
    return ref, (np.stack(qs), np.stack(vs))


@pytest.fixture(scope="module")
def slope_runs():
    """Env 0 with friction 1.0 (sticks), env 1 with 1e-3 (slides)."""
    slope = np.tan(np.deg2rad(25.0))
    return _run_both(_slope_terrain(slope), slope_terrain(25.0),
                     on_slope_qpos(25.0, 2), np.array([1.0, 1e-3], np.float32))


@pytest.mark.parametrize("field", [0, 1], ids=["qpos", "qvel"])
def test_box_on_slope_matches_jax_step_for_step(slope_runs, field):
    ref, got = slope_runs
    np.testing.assert_allclose(got[field], ref[field],
                               atol=(QPOS_ATOL, QVEL_ATOL)[field])


def test_box_settles_on_25deg_slope(slope_runs):
    """tests/test_slope.py::test_box_settles_on_25deg_slope in the port."""
    _, (q, v) = slope_runs
    q, v, x_settled = q[:, 0], v[:, 0], q[24, 0, :2]
    assert np.linalg.norm(v[-1, :3]) < 0.02, v[-1]
    assert np.linalg.norm(q[-1, :2] - x_settled) < 0.005, q[-1, :3]
    slope = np.tan(np.deg2rad(25.0))
    gaps = _corner_gaps(_slope_terrain(slope), q[-1], _box_model())
    gap_n = (gaps + 0.01) * np.cos(np.deg2rad(25.0)) - 0.01
    assert -0.01 < gap_n.min() < 0.005, gap_n


def test_box_slides_on_frictionless_slope(slope_runs):
    """tests/test_slope.py::test_box_slides_on_frictionless_slope."""
    _, (q, _) = slope_runs
    assert q[-1, 1, 0] < -0.2, q[-1, 1, :3]


SPOTS = {"apex": (0.0, 0.0), "diagonal-ridge": (2.0, 2.0),
         "near-ridge": (2.0, 1.96)}


@pytest.fixture(scope="module")
def pyramid_runs():
    """The box dropped flat 8 cm above each spot of
    tests/test_hfield_edges.py::test_box_settles_on_pyramid_features, one
    env a spot, on its sharp-apex pyramid."""
    terr_j = _pyramid_terrain()
    terr_t = tt.Terrain(kind="hfield", height=np.asarray(terr_j.height),
                        cell=terr_j.cell, rows=1, cols=1,
                        patch_m=terr_j.patch_m)
    xy = np.array(list(SPOTS.values()))
    h0 = np.asarray(jheight_at(terr_j, jnp.asarray(xy)))
    qpos = np.zeros((len(xy), 7), np.float32)
    qpos[:, :2], qpos[:, 2], qpos[:, 3] = xy, h0 + 0.08, 1.0
    return terr_j, _run_both(terr_j, terr_t, qpos,
                             np.ones(len(xy), np.float32))


@pytest.mark.parametrize("spot", list(SPOTS))
def test_box_settles_on_pyramid_features(pyramid_runs, spot):
    """The criteria of tests/test_hfield_edges.py on the port's states,
    and the port's trajectory against the JAX engine's."""
    terr_j, (ref, (q, v)) = pyramid_runs
    i = list(SPOTS).index(spot)
    np.testing.assert_allclose(q[:, i], ref[0][:, i], atol=QPOS_ATOL)
    np.testing.assert_allclose(v[:, i], ref[1][:, i], atol=QVEL_ATOL)
    qpos, qvel = q[-1, i], v[-1, i]
    assert np.isfinite(qpos).all() and np.isfinite(qvel).all()
    assert np.linalg.norm(qvel[:3]) < 0.05, qvel[:6]
    gaps = _corner_gaps(terr_j, qpos.astype(np.float64), _box_model())
    assert -0.01 < gaps.min() < 0.01, (spot, gaps)
    assert np.linalg.norm(qpos[:2] - np.asarray(SPOTS[spot])) < 0.3, qpos[:3]


def test_make_batched_step_takes_the_reference_positional_order():
    """(model, params, num_envs, terrain, layout): num_envs is ignored, a
    layout the reference knows is accepted, any other raises."""
    terr = slope_terrain(25.0)
    eng = tem.make_batched_step(box_model(), tem.EngineParams(), 0, terr,
                                device="cpu")
    assert eng.terrain is terr and eng.terrain.kind == "hfield"
    for layout in ("auto", "lanes", "vmap"):
        assert tem.make_batched_step(box_model(), tem.EngineParams(), 8, terr,
                                     layout, device="cpu").terrain is terr
    with pytest.raises(ValueError, match="layout"):
        tem.make_batched_step(box_model(), tem.EngineParams(), 0, terr,
                              "rows", device="cpu")
    assert tem.make_batched_step(box_model(), tem.EngineParams(),
                                 device="cpu").terrain.kind == "plane"
