"""Quaternion / rotation helpers (port of cat_tpu/sim/maths.py).

Quaternions are (w, x, y, z) on the LAST axis and rotate local -> world:
v_world = R(q) v_local. Every function broadcasts over leading axes.
"""

from __future__ import annotations

import torch


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b; R(a*b) = R(a) R(b)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q (local -> world): v + qw t + qv x t, t = 2 qv x v."""
    qw, qv = q[..., 0:1], q[..., 1:4]
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + qw * t + torch.linalg.cross(qv, t, dim=-1)


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q^-1 (world -> local)."""
    return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 3, 3), columns = rotated basis vectors."""
    w, x, y, z = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_from_euler_zyx(roll, pitch, yaw) -> torch.Tensor:
    """Quaternion from extrinsic x-y-z (roll/pitch/yaw) Euler angles."""
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack([
        cy * cp * cr + sy * sp * sr,
        cy * cp * sr - sy * sp * cr,
        cy * sp * cr + sy * cp * sr,
        sy * cp * cr - cy * sp * sr,
    ], dim=-1)


def quat_integrate(q: torch.Tensor, omega_world: torch.Tensor, dt) -> torch.Tensor:
    """Exponential-map update by world angular velocity: q' = exp(dt w/2) q."""
    angle = torch.sqrt(torch.sum(omega_world * omega_world, dim=-1,
                                 keepdim=True))
    axis = omega_world / torch.clamp(angle, min=1e-12)
    half = 0.5 * angle * dt
    dq = torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)
    out = quat_mul(dq, q)
    return out / torch.sqrt(torch.sum(out * out, dim=-1, keepdim=True))


def quat_yaw(q: torch.Tensor) -> torch.Tensor:
    """Yaw angle (rotation about world z)."""
    w, x, y, z = q.unbind(-1)
    return torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) with skew(v) @ u = v x u."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)
