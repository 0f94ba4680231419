"""The port's terrain against the JAX package's: the generated rough grid
bit for bit, and the height, gradient, normal and five-probe surface-gap
queries at random points on and off the grid.

Tolerance: the queries run the same float32 arithmetic on the same table;
heights (|h| < 0.3 m) agree to atol 1e-6, gradients (divided by the 0.1 m
cell) and normals to atol 1e-5, gaps to atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from cat_tpu.sim import terrain as jt
from cat_tpu_torch.sim import terrain as tt

SMALL = dict(rows=2, cols=4, patch_m=4.0, cell=0.1, seed=3)


@pytest.mark.parametrize("kw", [{}, SMALL, dict(rows=3, cols=5, seed=7)])
def test_generate_rough_is_bit_identical(kw):
    """The production grid (10 x 8 patches of 8 m at 0.1 m) and smaller
    ones: same seed, same bytes, same patch layout."""
    ref, port = jt.generate_rough(**kw), tt.generate_rough(**kw)
    assert port.height.dtype == ref.height.dtype == np.float32
    assert port.height.shape == ref.height.shape
    assert port.height.tobytes() == ref.height.tobytes()
    for f in ("kind", "cell", "rows", "cols", "patch_m", "size_m"):
        assert getattr(port, f) == getattr(ref, f), f
    for r, c in ((0, 0), (port.rows - 1, port.cols - 1), (1, 2)):
        np.testing.assert_array_equal(port.patch_origin(r, c),
                                      ref.patch_origin(r, c))
    if not kw:
        assert port.height.shape == (800, 640)


@pytest.fixture(scope="module")
def terrains():
    return jt.generate_rough(**SMALL), tt.generate_rough(**SMALL)


def _points(terr, n=512, seed=0):
    """Points over the grid and up to 1 m beyond its edges, plus exact
    cell corners and patch centres."""
    rng = np.random.default_rng(seed)
    H, W = terr.size_m
    xy = rng.uniform([-H / 2 - 1, -W / 2 - 1], [H / 2 + 1, W / 2 + 1], (n, 2))
    corners = (rng.integers(-20, 20, (32, 2)) * terr.cell).astype(np.float64)
    centres = np.stack([terr.patch_origin(r, c) for r in range(terr.rows)
                        for c in range(terr.cols)])
    return np.concatenate([xy, corners, centres]).astype(np.float32)


def test_packed_corner_table_matches(terrains):
    ref, port = terrains
    np.testing.assert_array_equal(tt._packed_corners(port, "cpu").numpy(),
                                  jt._packed_corners(ref))


def test_height_and_gradient_match(terrains):
    ref, port = terrains
    xy = _points(ref)
    h_r, gx_r, gy_r = jt.height_grad_at(ref, jnp.asarray(xy))
    h_p, gx_p, gy_p = tt.height_grad_at(port, torch.from_numpy(xy))
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h_r), atol=1e-6)
    np.testing.assert_allclose(gx_p.numpy(), np.asarray(gx_r), atol=1e-5)
    np.testing.assert_allclose(gy_p.numpy(), np.asarray(gy_r), atol=1e-5)
    np.testing.assert_allclose(
        tt.height_at(port, torch.from_numpy(xy)).numpy(),
        np.asarray(jt.height_at(ref, jnp.asarray(xy))), atol=1e-6)
    # batched (N, P, 2) queries, as the height scan makes them
    xy3 = xy[:520].reshape(8, 65, 2)
    np.testing.assert_allclose(
        tt.height_at(port, torch.from_numpy(xy3)).numpy(),
        np.asarray(jt.height_at(ref, jnp.asarray(xy3))), atol=1e-6)


def test_normal_matches(terrains):
    ref, port = terrains
    xy = _points(ref, seed=1)
    n_p = tt.normal_at(port, torch.from_numpy(xy)).numpy()
    np.testing.assert_allclose(n_p, np.asarray(jt.normal_at(ref, jnp.asarray(xy))),
                               atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(n_p, axis=-1), 1.0, atol=1e-6)


def test_surface_gap_matches(terrains):
    """Sphere centres just above, on and below the surface, radii of the
    Solo12 feet and shins, broadcast per candidate as the contacts do."""
    ref, port = terrains
    rng = np.random.default_rng(2)
    xy = _points(ref, n=240, seed=2)[:240].reshape(40, 6, 2)
    h = np.asarray(jt.height_at(ref, jnp.asarray(xy)))
    p = np.concatenate([xy, (h + rng.uniform(-0.03, 0.1, h.shape))[..., None]],
                       axis=-1).astype(np.float32)
    r = np.array([0.016, 0.016, 0.02, 0.02, 0.03, 0.05], np.float32)
    d_r, n_r = jt.surface_gap(ref, jnp.asarray(p), jnp.asarray(r))
    d_p, n_p = tt.surface_gap(port, torch.from_numpy(p), torch.from_numpy(r))
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_r), atol=1e-6)
    np.testing.assert_allclose(n_p.numpy(), np.asarray(n_r), atol=1e-5)


def test_plane_queries():
    ref, port = jt.plane(), tt.plane()
    xy = np.array([[0.0, 0.0], [3.0, -2.0]], np.float32)
    np.testing.assert_array_equal(tt.height_at(port, torch.from_numpy(xy)).numpy(),
                                  np.asarray(jt.height_at(ref, jnp.asarray(xy))))
    np.testing.assert_array_equal(tt.normal_at(port, torch.from_numpy(xy)).numpy(),
                                  np.asarray(jt.normal_at(ref, jnp.asarray(xy))))
    assert port.size_m == ref.size_m == (0.0, 0.0)


def test_nan_position_stays_in_range(terrains):
    """A NaN position reads an in-range cell (on the card an out-of-range
    gather is a device-side assert) and gives NaN; finite positions in the
    same batch are unchanged, and infinite ones clamp to the edge."""
    ref, port = terrains
    xy = torch.tensor([[0.3, -0.7], [float("nan"), 0.2], [0.1, float("nan")],
                       [float("inf"), -float("inf")], [1.5, 2.5]])
    h, gx, gy = tt.height_grad_at(port, xy)
    assert torch.isnan(h[1:3]).all()
    assert torch.isfinite(h[[0, 3, 4]]).all()
    alone = tt.height_grad_at(port, xy[[0, 4]])
    for a, b in zip((h, gx, gy), alone):
        torch.testing.assert_close(a[[0, 4]], b, rtol=0, atol=0)
    h_ref = np.asarray(jt.height_at(ref, jnp.asarray(xy.numpy())))
    np.testing.assert_allclose(h.numpy(), h_ref, atol=1e-6)  # NaN where NaN
    d, n = tt.surface_gap(port, torch.tensor([[float("nan"), 0.0, 0.1]]), 0.02)
    assert torch.isnan(d).all()


def test_terrain_rejects_what_it_cannot_query():
    with pytest.raises(ValueError):
        tt.Terrain(kind="mesh")
    with pytest.raises(ValueError):
        tt.Terrain(kind="hfield", height=np.zeros((1, 5), np.float32))
