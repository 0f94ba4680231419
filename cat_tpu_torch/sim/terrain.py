"""Terrain: the z = 0 plane and heightfields (port of cat_tpu/sim/terrain.py).

A Terrain is static numpy data:
  * kind="plane": z = 0 everywhere;
  * kind="hfield": an (R, C) height grid with cell size ``cell``, centred at
    the origin; height and gradient queries are bilinear, from one gather
    of a packed per-cell corner table kept on the query's device.

``generate_rough`` builds the rough task's grid of difficulty rows x terrain
types (noise, pyramid up, pyramid down, steps) with flat spawn pads at the
patch centres. It is numpy, as in the JAX package, so a seed gives the same
grid bit for bit in both.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Terrain:
    kind: str = "plane"                   # "plane" | "hfield"
    height: Optional[np.ndarray] = None   # (R, C) float32 meters
    cell: float = 0.1                     # grid cell size (m)
    # patch layout for curriculum spawning
    rows: int = 0                         # difficulty levels
    cols: int = 0                         # terrain types
    patch_m: float = 0.0                  # patch side length (m)

    def __post_init__(self):
        if self.kind not in ("plane", "hfield"):
            raise ValueError(f"terrain kind {self.kind!r}: 'plane' or 'hfield'")
        if self.kind == "hfield" and (
                self.height is None or np.ndim(self.height) != 2
                or min(np.shape(self.height)) < 2):
            raise ValueError("a heightfield needs an (R, C) grid, R, C >= 2")

    @property
    def size_m(self) -> Tuple[float, float]:
        if self.kind == "plane":
            return (0.0, 0.0)
        r, c = self.height.shape
        return (r * self.cell, c * self.cell)

    def patch_origin(self, row: int, col: int) -> np.ndarray:
        """World xy of the centre of patch (row, col)."""
        H, W = self.size_m
        x = (row + 0.5) * self.patch_m - H / 2.0
        y = (col + 0.5) * self.patch_m - W / 2.0
        return np.array([x, y])

    @functools.cached_property
    def _device_tables(self) -> dict:
        """The packed corner table and the probe offsets on each device
        they were asked for (built once: a CUDA graph of the control step
        may copy nothing from the host)."""
        return {}


def plane() -> Terrain:
    return Terrain(kind="plane")


def _packed_corners(terrain: Terrain, device) -> torch.Tensor:
    """(R-1)(C-1) x 4 table: the four bilinear corners of a cell come back
    from one 4-wide gather. Built once per terrain and device (~8 MB for
    the production grid)."""
    tables = terrain._device_tables
    key = str(torch.device(device))
    if key not in tables:
        Hn = np.asarray(terrain.height, dtype=np.float32)
        packed = np.ascontiguousarray(np.stack(
            [Hn[:-1, :-1], Hn[:-1, 1:], Hn[1:, :-1], Hn[1:, 1:]], axis=-1
        ).reshape(-1, 4))
        tables[key] = torch.as_tensor(packed, device=device)
    return tables[key]


def cell_coords(terrain: Terrain, xy: torch.Tensor):
    """(row of the packed corner table, fu, fv) of world xy (..., 2): the
    cell a lookup reads and the position inside it, clamped to the grid's
    edge cells; a NaN position reads cell 0 and keeps NaN fractions."""
    R, C = terrain.height.shape
    u = xy[..., 0] / terrain.cell + R / 2.0 - 0.5
    v = xy[..., 1] / terrain.cell + C / 2.0 - 0.5
    u = torch.clamp(u, 0.0, R - 1.001)
    v = torch.clamp(v, 0.0, C - 1.001)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    iu = torch.nan_to_num(u0, nan=0.0).long()
    iv = torch.nan_to_num(v0, nan=0.0).long()
    return iu * (C - 1) + iv, u - u0, v - v0


def height_grad_at(terrain: Terrain, xy: torch.Tensor):
    """Bilinear height and its in-cell gradient at world xy (..., 2).

    Returns (h, dhdx, dhdy), each (...), from one gather of the packed
    table (cat_tpu/sim/terrain.py:92-123). Positions off the grid clamp to
    its edge cells. A NaN position gives NaN values and still reads an
    in-range cell (``clamp`` passes NaN through, and a NaN cast to an index
    would read out of range)."""
    H4 = _packed_corners(terrain, xy.device)
    index, fu, fv = cell_coords(terrain, xy)
    cell = H4[index]                                     # (..., 4)
    h00, h01, h10, h11 = cell[..., 0], cell[..., 1], cell[..., 2], cell[..., 3]
    h = (h00 * (1 - fu) * (1 - fv) + h01 * (1 - fu) * fv
         + h10 * fu * (1 - fv) + h11 * fu * fv)
    dhdx = ((h10 - h00) * (1 - fv) + (h11 - h01) * fv) / terrain.cell
    dhdy = ((h01 - h00) * (1 - fu) + (h11 - h10) * fu) / terrain.cell
    return h, dhdx, dhdy


def height_at(terrain: Terrain, xy: torch.Tensor) -> torch.Tensor:
    """Terrain height at world xy: (..., 2) -> (...)."""
    if terrain.kind == "plane":
        return torch.zeros(xy.shape[:-1], dtype=xy.dtype, device=xy.device)
    return height_grad_at(terrain, xy)[0]


def normal_at(terrain: Terrain, xy: torch.Tensor) -> torch.Tensor:
    """Unit surface normal at world xy (..., 2) -> (..., 3), by central
    differences of the height one cell apart (observations, diagnostics)."""
    if terrain.kind == "plane":
        n = torch.zeros(xy.shape[:-1] + (3,), dtype=xy.dtype, device=xy.device)
        n[..., 2] = 1.0
        return n
    eps = terrain.cell
    ex = torch.tensor([eps, 0.0], dtype=xy.dtype, device=xy.device)
    ey = torch.tensor([0.0, eps], dtype=xy.dtype, device=xy.device)
    dx = (height_at(terrain, xy + ex) - height_at(terrain, xy - ex)) / (2 * eps)
    dy = (height_at(terrain, xy + ey) - height_at(terrain, xy - ey)) / (2 * eps)
    n = torch.stack([-dx, -dy, torch.ones_like(dx)], dim=-1)
    return n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))


def _probe_offsets(terrain: Terrain, dtype, device) -> torch.Tensor:
    """(5, 2): the centre and the four axis directions of surface_gap's
    probes, kept with the terrain's tables."""
    tables = terrain._device_tables
    key = ("probes", str(torch.device(device)), dtype)
    if key not in tables:
        tables[key] = torch.tensor(
            [[0.0, 0.0], [1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]],
            dtype=dtype, device=device)
    return tables[key]


def surface_gap(terrain: Terrain, p: torch.Tensor, probe_r):
    """Signed gap from sphere centres p (..., 3) to the heightfield surface
    (cat_tpu/sim/terrain.py:144-184).

    Probes five columns (the centre and four axis offsets of probe_r, the
    sphere radius): for each sample s_i = (xy_i, h_i) with surface normal
    n_i the gap is d_i = n_i . (p - s_i), and the deepest sample wins, so a
    sphere pressed sideways into a steep face sees the face.

    Returns (d (...,), n (..., 3)): the winning gap (radius not yet
    subtracted) and its surface normal."""
    offs = _probe_offsets(terrain, p.dtype, p.device)    # (5, 2)
    pr = torch.as_tensor(probe_r, dtype=p.dtype, device=p.device).expand(
        p.shape[:-1])
    xy = p[..., None, :2] + offs * pr[..., None, None]   # (..., 5, 2)
    h, gx, gy = height_grad_at(terrain, xy)              # (..., 5) each
    inv = torch.rsqrt(1.0 + gx * gx + gy * gy)
    n = torch.stack([-gx * inv, -gy * inv, inv], dim=-1)  # (..., 5, 3)
    dxy = xy - p[..., None, :2]
    d = (-n[..., 0] * dxy[..., 0] - n[..., 1] * dxy[..., 1]
         + n[..., 2] * (p[..., None, 2] - h))            # (..., 5)
    i = torch.argmin(d, dim=-1, keepdim=True)
    d_min = torch.gather(d, -1, i)[..., 0]
    n_min = torch.gather(n, -2, i[..., None].expand(i.shape + (3,)))[..., 0, :]
    return d_min, n_min


# ---------------------------------------------------------------------------
# procedural generation (numpy, as cat_tpu/sim/terrain.py:187-258)
# ---------------------------------------------------------------------------

def generate_rough(
    rows: int = 10,            # difficulty levels
    cols: int = 8,             # terrain types (cycled over 4 generators)
    patch_m: float = 8.0,
    cell: float = 0.1,
    seed: int = 0,
    # difficulty-interpolated (easy, hard) ranges, scaled for Solo12
    noise_amp: Tuple[float, float] = (0.01, 0.05),
    slope: Tuple[float, float] = (0.05, 0.25),
    step_h: Tuple[float, float] = (0.02, 0.08),
) -> Terrain:
    """Difficulty-graded patch grid: noise / slope up / slope down / steps.

    Every patch's border sits at height 0, so neighbouring patches join
    without cliffs; pyramids rise (or sink) from the border to a flat
    centre platform, and the spawn pad at each patch centre is flat at the
    platform height (spawn z comes from a height query)."""
    rng = np.random.default_rng(seed)
    n = int(round(patch_m / cell))
    grid = np.zeros((rows * n, cols * n), dtype=np.float32)
    pad = max(2, n // 8)  # flat spawn pad at the patch centre

    def lerp(lo_hi, d):
        return lo_hi[0] + (lo_hi[1] - lo_hi[0]) * d

    for r in range(rows):
        difficulty = (r + 1) / rows
        for c in range(cols):
            kind = c % 4
            if kind == 0:      # uniform noise
                amp = lerp(noise_amp, difficulty)
                patch = rng.uniform(-amp, amp, size=(n, n))
            elif kind == 1:    # pyramid: hill rising from border to platform
                patch = _pyramid(n, cell, lerp(slope, difficulty), pad)
            elif kind == 2:    # inverted pyramid: pit
                patch = -_pyramid(n, cell, lerp(slope, difficulty), pad)
            else:              # discrete steps / obstacles
                patch = _steps(n, rng, lerp(step_h, difficulty))
            c0 = n // 2
            patch[c0 - pad:c0 + pad, c0 - pad:c0 + pad] = patch[c0, c0]
            grid[r * n:(r + 1) * n, c * n:(c + 1) * n] = patch
    return Terrain(kind="hfield", height=grid.astype(np.float32), cell=cell,
                   rows=rows, cols=cols, patch_m=patch_m)


def _pyramid(n: int, cell: float, slope: float, pad: int) -> np.ndarray:
    """Height 0 at the patch border, rising at ``slope`` toward a flat
    centre platform of half-width ``pad`` cells."""
    ax = np.abs(np.arange(n) - n / 2 + 0.5) * cell
    d = np.maximum(ax[:, None], ax[None, :])    # Chebyshev distance
    edge = ax.max()
    platform = pad * cell
    rise = np.clip(edge - d, 0.0, edge - platform)
    return (rise * slope).astype(np.float32)


def _steps(n: int, rng, hmax: float) -> np.ndarray:
    blocks = 8
    bs = max(1, n // blocks)
    hs = rng.uniform(-hmax, hmax, size=(blocks + 1, blocks + 1))
    patch = np.zeros((n, n), dtype=np.float32)
    for i in range(blocks + 1):
        for j in range(blocks + 1):
            patch[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = hs[i, j]
    return patch[:n, :n]
