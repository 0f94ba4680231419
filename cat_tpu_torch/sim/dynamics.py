"""Batched articulated rigid-body dynamics, envs on the LEADING axis.

Port of cat_tpu/sim/dynamics.py and the dynamics half of
cat_tpu/sim/dynamics_lanes.py. The JAX package kept envs LAST on the TPU
(lane width); the port keeps them first, which is PyTorch's habit, and
writes each stage as batched tensor ops over (N, ...):

  M(q)   = sum_b [ Jv_b^T m_b Jv_b + Jw_b^T I_b^w Jw_b ] + diag(armature)
  C(q,v) = sum_b [ Jv_b^T m_b a_com_b + Jw_b^T (I_b^w alpha_b + w x I_b^w w) ]

with gravity folded in as a base acceleration of -g. The kinematic tree is
walked level by level (all bodies at one depth at once), so a quadruped
costs three batched steps instead of twelve.

Shapes: qpos (N, nq), qvel (N, nv); Kin.R (N, nb, 3, 3), Kin.o/omega/v_o/
x_com (N, nb, 3), Kin.a_w/o_j (N, nj, 3); Jacobians (N, nb, 3, nv);
M/Minv (N, nv, nv).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .maths import quat_rotate, quat_to_mat, skew
from .model import RobotModel

GRAVITY = np.array([0.0, 0.0, -9.81])


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def _long(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)


@dataclasses.dataclass(frozen=True)
class ModelTensors:
    """The static RobotModel as f32/int64 tensors on one device (the JAX
    package baked them into its programs as constants)."""
    model: RobotModel
    device: torch.device
    anc: torch.Tensor             # (nb, nj) ancestor mask, float
    levels: Tuple                 # per tree depth: (bodies, parents) as
                                  # python ints, then as long tensors
    joint_pos: torch.Tensor       # (nb, 3)
    joint_rot: torch.Tensor       # (nb, 3, 3)
    joint_axis: torch.Tensor      # (nb, 3)
    mass: torch.Tensor            # (nb,)
    com: torch.Tensor             # (nb, 3)
    inertia: torch.Tensor         # (nb, 3, 3)
    armature_diag: torch.Tensor   # (nv, nv)
    effort_limit: torch.Tensor    # (nj,)
    joint_lower: torch.Tensor     # (nj,)
    joint_upper: torch.Tensor     # (nj,)
    cand_body: torch.Tensor       # (nc_terrain,)
    cand_offset: torch.Tensor     # (nc_terrain, 3)
    cand_radius: torch.Tensor     # (nc_terrain,)
    pair_body_a: torch.Tensor     # (npair,)
    pair_body_b: torch.Tensor
    pair_p0_a: torch.Tensor       # (npair, 3) capsule endpoints, body frame
    pair_p1_a: torch.Tensor
    pair_p0_b: torch.Tensor
    pair_p1_b: torch.Tensor
    pair_rsum: torch.Tensor       # (npair,) radius_a + radius_b
    report_matrix: torch.Tensor   # (nreport, nc_terrain + 2 npair) 0/1
    foot_ids: torch.Tensor        # (nfeet,)
    base_acc: torch.Tensor        # (3,) -g: gravity as a base acceleration

    @staticmethod
    def build(model: RobotModel, device) -> "ModelTensors":
        device = torch.device(device)
        depth = [0] * model.nbody
        for b in range(1, model.nbody):
            depth[b] = depth[int(model.parent[b])] + 1
        levels = []
        for d in range(1, max(depth) + 1):
            bl = tuple(b for b in range(1, model.nbody) if depth[b] == d)
            pl = tuple(int(model.parent[b]) for b in bl)
            levels.append((bl, pl, _long(bl, device), _long(pl, device)))
        arm = np.concatenate([np.zeros(6), np.asarray(model.armature)])
        rep = np.concatenate(
            [model.cand_report, model.pair_report_a, model.pair_report_b]
        ).astype(np.int64)
        rmat = np.zeros((model.nreport, len(rep)), dtype=np.float32)
        rmat[rep, np.arange(len(rep))] = 1.0
        return ModelTensors(
            model=model, device=device,
            anc=_f32(model.ancestor_mask(), device),
            levels=tuple(levels),
            joint_pos=_f32(model.joint_pos, device),
            joint_rot=_f32(model.joint_rot, device),
            joint_axis=_f32(model.joint_axis, device),
            mass=_f32(model.mass, device),
            com=_f32(model.com, device),
            inertia=_f32(model.inertia, device),
            armature_diag=_f32(np.diag(arm), device),
            effort_limit=_f32(model.effort_limit, device),
            joint_lower=_f32(model.joint_limit_lower, device),
            joint_upper=_f32(model.joint_limit_upper, device),
            cand_body=_long(model.cand_body, device),
            cand_offset=_f32(model.cand_offset, device),
            cand_radius=_f32(model.cand_radius, device),
            pair_body_a=_long(model.pair_body_a, device),
            pair_body_b=_long(model.pair_body_b, device),
            pair_p0_a=_f32(model.pair_p0_a, device),
            pair_p1_a=_f32(model.pair_p1_a, device),
            pair_p0_b=_f32(model.pair_p0_b, device),
            pair_p1_b=_f32(model.pair_p1_b, device),
            pair_rsum=_f32(model.pair_radius_a + model.pair_radius_b, device),
            report_matrix=torch.as_tensor(rmat, device=device),
            foot_ids=_long(model.foot_report_ids, device),
            base_acc=_f32(-GRAVITY, device),
        )


class Kin(NamedTuple):
    R: torch.Tensor        # (N, nb, 3, 3)
    o: torch.Tensor        # (N, nb, 3)
    omega: torch.Tensor    # (N, nb, 3)
    v_o: torch.Tensor      # (N, nb, 3)
    x_com: torch.Tensor    # (N, nb, 3)
    a_w: torch.Tensor      # (N, nj, 3) world joint axes (joint d = body d+1)
    o_j: torch.Tensor      # (N, nj, 3) world joint origins


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _mv(A, v):
    """(..., 3, 3) @ (..., 3) -> (..., 3)."""
    return torch.matmul(A, v.unsqueeze(-1)).squeeze(-1)


def fk(mt: ModelTensors, qpos: torch.Tensor, qvel: torch.Tensor,
       com_offset: Optional[torch.Tensor] = None) -> Kin:
    """Forward position + velocity kinematics.

    com_offset: optional (N, nb, 3) body-frame CoM displacement (the
    randomize_body_coms event; the inertia about the CoM is unchanged).
    """
    n, nb = qpos.shape[0], mt.model.nbody
    quat = qpos[:, 3:7]
    R = [None] * nb
    o = [None] * nb
    om = [None] * nb
    v = [None] * nb
    a_w = [None] * (nb - 1)
    R[0] = quat_to_mat(quat)
    o[0] = qpos[:, 0:3]
    om[0] = quat_rotate(quat, qvel[:, 3:6])
    v[0] = qvel[:, 0:3]
    eye = torch.eye(3, device=qpos.device)
    for bl, pl, bodies, _ in mt.levels:
        Rp = torch.stack([R[p] for p in pl], dim=1)          # (N, L, 3, 3)
        op = torch.stack([o[p] for p in pl], dim=1)
        omp = torch.stack([om[p] for p in pl], dim=1)
        vp = torch.stack([v[p] for p in pl], dim=1)
        q = qpos[:, 6 + bodies]                              # (N, L)
        qd = qvel[:, 5 + bodies]
        o_j = op + _mv(Rp, mt.joint_pos[bodies])
        R_pw = torch.matmul(Rp, mt.joint_rot[bodies])
        aw = _mv(R_pw, mt.joint_axis[bodies])
        K = skew(aw)
        R_axis = (eye + torch.sin(q)[..., None, None] * K
                  + (1.0 - torch.cos(q))[..., None, None] * torch.matmul(K, K))
        Rb = torch.matmul(R_axis, R_pw)
        omb = omp + qd[..., None] * aw
        vb = vp + _cross(omp, o_j - op)
        for i, b in enumerate(bl):
            R[b], o[b], om[b], v[b] = Rb[:, i], o_j[:, i], omb[:, i], vb[:, i]
            a_w[b - 1] = aw[:, i]
    R = torch.stack(R, dim=1)
    o = torch.stack(o, dim=1)
    com = mt.com.expand(n, nb, 3)
    if com_offset is not None:
        com = com + com_offset
    # joint d sits at the origin of body d+1 (a joint-less body has none)
    a_w = torch.stack(a_w, dim=1) if a_w else qpos.new_zeros(n, 0, 3)
    return Kin(R=R, o=o, omega=torch.stack(om, dim=1),
               v_o=torch.stack(v, dim=1), x_com=o + _mv(R, com),
               a_w=a_w, o_j=o[:, 1:])


class Jacs(NamedTuple):
    Jv: torch.Tensor  # (N, nb, 3, nv) com translational Jacobians
    Jw: torch.Tensor  # (N, nb, 3, nv) rotational Jacobians


def point_jacobians(kin: Kin, mask: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """World-frame Jacobians of points x (N, k, 3); mask (k, nj) ancestor
    rows of the owning bodies. Returns (N, k, 3, nv)."""
    n, k = x.shape[0], x.shape[1]
    Jlin = torch.eye(3, device=x.device).expand(n, k, 3, 3)
    Jang = -torch.matmul(skew(x - kin.o[:, :1]), kin.R[:, :1])
    rel = x[:, :, None] - kin.o_j[:, None]                  # (N, k, nj, 3)
    jc = _cross(kin.a_w[:, None].expand_as(rel), rel) * mask[None, :, :, None]
    return torch.cat([Jlin, Jang, jc.transpose(2, 3)], dim=3)


def point_jacobian(kin: Kin, mask_row, x: torch.Tensor) -> torch.Tensor:
    """(N, 3, nv) Jacobian of the world point x (N, 3) fixed to one body;
    mask_row (nj,): the joints on the chain from the base to that body."""
    mask = torch.as_tensor(mask_row, dtype=x.dtype, device=x.device)
    return point_jacobians(kin, mask[None], x[:, None])[:, 0]


def body_jacobians(mt: ModelTensors, kin: Kin) -> Jacs:
    n, nb = kin.o.shape[0], mt.model.nbody
    Jw = torch.cat([
        torch.zeros(n, nb, 3, 3, device=kin.o.device),
        kin.R[:, :1].expand(n, nb, 3, 3),
        mt.anc[None, :, None, :] * kin.a_w.transpose(1, 2)[:, None],
    ], dim=3)
    Jv = point_jacobians(kin, mt.anc, kin.x_com)
    return Jacs(Jv=Jv, Jw=Jw)


def world_inertias(mt: ModelTensors, kin: Kin) -> torch.Tensor:
    """(N, nb, 3, 3) rotational inertias about the com, world frame."""
    return torch.matmul(torch.matmul(kin.R, mt.inertia), kin.R.transpose(-1, -2))


def mass_matrix(mt: ModelTensors, jacs: Jacs, I_w: torch.Tensor) -> torch.Tensor:
    """(N, nv, nv) joint-space inertia matrix."""
    Jv, Jw = jacs.Jv, jacs.Jw
    M = torch.einsum("nbik,nbil->nkl", Jv * mt.mass[None, :, None, None], Jv)
    M = M + torch.einsum("nbik,nbil->nkl", Jw, torch.matmul(I_w, Jw))
    M = M + mt.armature_diag
    return 0.5 * (M + M.transpose(1, 2))


def bias_forces(mt: ModelTensors, kin: Kin, jacs: Jacs, I_w: torch.Tensor,
                qvel: torch.Tensor) -> torch.Tensor:
    """(N, nv) Coriolis + centrifugal + gravity bias (qacc = 0)."""
    n, nb = qvel.shape[0], mt.model.nbody
    alpha = [None] * nb
    a_o = [None] * nb
    alpha[0] = torch.zeros(n, 3, device=qvel.device)
    a_o[0] = mt.base_acc.expand(n, 3)
    for bl, pl, bodies, parents in mt.levels:
        alp = torch.stack([alpha[p] for p in pl], dim=1)
        aop = torch.stack([a_o[p] for p in pl], dim=1)
        omp = kin.omega[:, parents]
        qd = qvel[:, 5 + bodies]
        dvec = kin.o[:, bodies] - kin.o[:, parents]
        al = alp + _cross(omp, qd[..., None] * kin.a_w[:, bodies - 1])
        ao = aop + _cross(alp, dvec) + _cross(omp, _cross(omp, dvec))
        for i, b in enumerate(bl):
            alpha[b], a_o[b] = al[:, i], ao[:, i]
    alpha = torch.stack(alpha, dim=1)
    a_o = torch.stack(a_o, dim=1)
    w = kin.omega
    r = kin.x_com - kin.o
    a_com = a_o + _cross(alpha, r) + _cross(w, _cross(w, r))
    F = mt.mass[None, :, None] * a_com
    Nt = _mv(I_w, alpha) + _cross(w, _mv(I_w, w))
    return (torch.einsum("nbik,nbi->nk", jacs.Jv, F)
            + torch.einsum("nbik,nbi->nk", jacs.Jw, Nt))


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 3, 3) matrices (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00, co01, co02 = e * i - f * h, c * h - b * i, b * f - c * e
    co10, co11, co12 = f * g - d * i, a * i - c * g, c * d - a * f
    co20, co21, co22 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * co00 + b * co10 + c * co20
    adj = torch.stack([
        torch.stack([co00, co01, co02], dim=-1),
        torch.stack([co10, co11, co12], dim=-1),
        torch.stack([co20, co21, co22], dim=-1),
    ], dim=-2)
    return adj * (1.0 / det)[..., None, None]


def cholesky_factor(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (N, n, n) SPD matrices, column by column,
    with the pivot clamped at 1e-12 as the JAX package does."""
    n = M.shape[-1]
    cols = []
    idx = torch.arange(n, device=M.device)
    for j in range(n):
        c = M[:, :, j]
        if j:
            L = torch.stack(cols, dim=2)                     # (N, n, j)
            c = c - torch.matmul(L, L[:, j, :, None]).squeeze(-1)
        d = torch.rsqrt(torch.clamp(c[:, j], min=1e-12))
        cols.append(c * d[:, None] * (idx >= j).to(M.dtype))
    return torch.stack(cols, dim=2)


def cholesky_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) X = B by forward and back substitution unrolled over
    the n rows (cat_tpu/sim/dynamics.py:294). L (N, n, n) lower; B (N, n)
    or (N, n, k)."""
    n = L.shape[-1]
    vec = B.dim() == 2
    if vec:
        B = B[..., None]
    ys = []
    for i in range(n):
        acc = B[:, i]
        if i:
            acc = acc - torch.matmul(L[:, i, None, :i],
                                     torch.stack(ys, dim=1))[:, 0]
        ys.append(acc / L[:, i, i, None])
    xs = [None] * n
    for i in reversed(range(n)):
        acc = ys[i]
        if i < n - 1:
            acc = acc - torch.matmul(L[:, None, i + 1:, i],
                                     torch.stack(xs[i + 1:], dim=1))[:, 0]
        xs[i] = acc / L[:, i, i, None]
    X = torch.stack(xs, dim=1)
    return X[..., 0] if vec else X


def spd_inverse(M: torch.Tensor) -> torch.Tensor:
    """(L L^T)^-1 = L^-T L^-1 for small SPD (N, n, n) matrices."""
    L = cholesky_factor(M)
    eye = torch.eye(M.shape[-1], device=M.device).expand_as(M)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.matmul(Linv.transpose(1, 2), Linv)


def mass_matrix_inverse(M: torch.Tensor, n_branch: int) -> torch.Tensor:
    """Structured M^-1 for a floating base with n_branch 3-dof legs.

      M = [[B, X], [X^T, D]],  D = blockdiag(D_1..D_k),  W = X D^-1
      S = B - W X^T
      M^-1 = [[S^-1, -S^-1 W], [-W^T S^-1, D^-1 + W^T S^-1 W]]

    Closed-form 3x3 leg inverses plus one 6x6 Schur complement
    (cat_tpu/sim/dynamics.py:223).
    """
    nv = M.shape[-1]
    nj = nv - 6
    if nj != 3 * n_branch:
        raise ValueError(f"nv={nv} is not 6 + 3 * {n_branch}")
    B = M[:, :6, :6]
    X = M[:, :6, 6:]
    Db = torch.stack([M[:, 6 + 3 * i:9 + 3 * i, 6 + 3 * i:9 + 3 * i]
                      for i in range(n_branch)], dim=1)      # (N, k, 3, 3)
    Dinv = inv3(Db)
    W = torch.cat([torch.matmul(X[:, :, 3 * i:3 * i + 3], Dinv[:, i])
                   for i in range(n_branch)], dim=2)         # (N, 6, nj)
    S = B - torch.matmul(W, X.transpose(1, 2))
    Sinv = spd_inverse(S)
    SW = torch.matmul(Sinv, W)
    BR = torch.matmul(W.transpose(1, 2), SW) + _block_diag(Dinv)
    top = torch.cat([Sinv, -SW], dim=2)
    bot = torch.cat([-SW.transpose(1, 2), BR], dim=2)
    Minv = torch.cat([top, bot], dim=1)
    return 0.5 * (Minv + Minv.transpose(1, 2))


def _block_diag(blocks: torch.Tensor) -> torch.Tensor:
    """(N, k, 3, 3) -> (N, 3k, 3k) block-diagonal."""
    n, k = blocks.shape[:2]
    out = blocks.new_zeros(n, 3 * k, 3 * k)
    for i in range(k):
        out[:, 3 * i:3 * i + 3, 3 * i:3 * i + 3] = blocks[:, i]
    return out
