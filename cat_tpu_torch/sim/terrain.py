"""Terrain (port of cat_tpu/sim/terrain.py, plane only).

The flat task runs on the z = 0 plane. The heightfield, its packed-corner
gradient queries and the rough-terrain generator are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Terrain:
    kind: str = "plane"

    def __post_init__(self):
        if self.kind != "plane":
            raise ValueError(f"terrain kind {self.kind!r} is not ported; "
                             "only 'plane' is")


def plane() -> Terrain:
    return Terrain(kind="plane")


def height_at(terrain: Terrain, xy: torch.Tensor) -> torch.Tensor:
    """Terrain height at world xy: (..., 2) -> (...)."""
    return torch.zeros(xy.shape[:-1], dtype=xy.dtype, device=xy.device)
