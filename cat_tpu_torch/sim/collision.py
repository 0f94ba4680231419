"""Contact detection on a fixed candidate set, envs leading.

Port of detect_contacts_lanes / detect_pair_contacts_lanes
(cat_tpu/sim/dynamics_lanes.py:416-549): sphere candidates against the
plane, then self-collision capsule pairs. Rows are (t1, t2, n) per contact;
on the plane the frame is the world frame (t1 = x, t2 = y, n = z).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .dynamics import Kin, ModelTensors, _cross, _mv, point_jacobians
from .terrain import Terrain


class Contacts(NamedTuple):
    phi: torch.Tensor                # (N, nc) signed distances
    E: torch.Tensor                  # (N, 3nc, nv) Jacobian rows, contact frame
    frame: Optional[torch.Tensor]    # (N, nc, 3, 3) rows (t1, t2, n); None = world


def _dot(u, v):
    return torch.sum(u * v, dim=-1)


def detect_pair_contacts(mt: ModelTensors, kin: Kin):
    """Capsule-capsule self-collision rows. Returns (phi (N, np),
    Jc (N, np, 3, nv), frame (N, np, 3, 3))."""
    ba, bb = mt.pair_body_a, mt.pair_body_b
    eps = 1e-12

    def endpoints(bodies, p0, p1):
        R, o = kin.R[:, bodies], kin.o[:, bodies]
        return o + _mv(R, p0), o + _mv(R, p1)

    p0a, p1a = endpoints(ba, mt.pair_p0_a, mt.pair_p1_a)
    p0b, p1b = endpoints(bb, mt.pair_p0_b, mt.pair_p1_b)
    d1, d2, r = p1a - p0a, p1b - p0b, p0a - p0b
    a, e, b = _dot(d1, d1), _dot(d2, d2), _dot(d1, d2)
    c, f = _dot(d1, r), _dot(d2, r)
    denom = a * e - b * b
    s = torch.clamp((b * f - c * e) / (denom + eps), 0.0, 1.0)
    t = torch.clamp((b * s + f) / (e + eps), 0.0, 1.0)
    s = torch.clamp((b * t - c) / (a + eps), 0.0, 1.0)
    ca = p0a + s[..., None] * d1
    cb = p0b + t[..., None] * d2
    delta = ca - cb
    dist = torch.sqrt(_dot(delta, delta) + eps)
    # robust normal: +-cross(d1, d2) when the axes (nearly) intersect,
    # tie-broken by the midpoint difference; ez when parallel
    cr = _cross(d1, d2)
    crn = torch.sqrt(_dot(cr, cr))[..., None]
    ref = 0.5 * (p0a + p1a) - 0.5 * (p0b + p1b)
    sgn = torch.where(_dot(cr, ref)[..., None] >= 0.0, 1.0, -1.0)
    ez = torch.zeros_like(d1)
    ez[..., 2] = 1.0
    ex = torch.zeros_like(d1)
    ex[..., 0] = 1.0
    n_fb = torch.where(crn > 1e-6, sgn * cr / (crn + eps), ez)
    n = torch.where((dist > 1e-3)[..., None], delta / dist[..., None], n_fb)
    phi = dist - mt.pair_rsum

    near_z = (torch.abs(n[..., 2]) > 0.9)[..., None]
    t1 = _cross(n, torch.where(near_z, ex, ez))
    t1 = t1 / torch.sqrt(_dot(t1, t1))[..., None]
    t2 = _cross(n, t1)
    frame = torch.stack([t1, t2, n], dim=-2)                 # (N, np, 3, 3)

    Jrel = (point_jacobians(kin, mt.anc[ba], ca)
            - point_jacobians(kin, mt.anc[bb], cb))      # (N, np, 3, nv)
    return phi, torch.matmul(frame, Jrel), frame


def detect_contacts(mt: ModelTensors, terrain: Terrain, kin: Kin) -> Contacts:
    """Plane candidates (world frame) followed by the self-collision pairs."""
    m = mt.model
    n, nc = kin.o.shape[0], m.ncand_terrain
    body = mt.cand_body
    x = kin.o[:, body] + _mv(kin.R[:, body], mt.cand_offset)  # (N, nc, 3)
    Jc = point_jacobians(kin, mt.anc[body], x)
    phi = x[..., 2] - mt.cand_radius
    frame = None
    if m.npair:
        phi_p, Jp, frame_p = detect_pair_contacts(mt, kin)
        frame = torch.cat([
            torch.eye(3, device=x.device).expand(n, nc, 3, 3), frame_p], dim=1)
        phi = torch.cat([phi, phi_p], dim=1)
        Jc = torch.cat([Jc, Jp], dim=1)
    return Contacts(phi=phi, E=Jc.reshape(n, 3 * m.ncand, m.nv), frame=frame)
