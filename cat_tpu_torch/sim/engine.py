"""The batched physics engine: PD actuation + dynamics + contact solve +
integration + contact sensors, envs leading.

Port of cat_tpu/sim/engine.py and cat_tpu/sim/engine_lanes.py (the lanes
branch, the JAX package's production path). One control step is
``decimation`` substeps of

  1. IdealPD torque  tau = clip(Kp (q* - q) - Kd qd, +-effort)
  2. v_free = v + h M^-1 (tau - C)
  3. contact rows, W = M^-1 E^T, b = E v_free -> block-Jacobi PGS impulses
  4. semi-implicit Euler (quaternion exponential map), joint-limit clamp
  5. per-body net contact forces with a 3-deep history, foot air time
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cat_tpu_torch.ops import pgs

from . import dynamics as dyn
from . import solver
from .collision import detect_contacts
from .maths import quat_integrate, quat_rotate
from .model import RobotModel
from .terrain import Terrain, plane


class EngineParams(NamedTuple):
    dt: float = 0.005            # physics dt
    decimation: int = 4          # substeps per control step
    kp: float = 4.0              # PD stiffness
    kd: float = 0.2              # PD damping
    contact_force_threshold: float = 1.0   # air-time contact threshold (N)
    solver: solver.SolverParams = solver.SolverParams()


class SimState(NamedTuple):
    """Batched physics state; every field has the env axis first."""
    qpos: torch.Tensor                  # (N, nq)
    qvel: torch.Tensor                  # (N, nv)
    lam: torch.Tensor                   # (N, 3 ncand) warm-start impulses
    applied_torque: torch.Tensor        # (N, nj) last substep PD torque
    joint_acc: torch.Tensor             # (N, nj)
    forces: torch.Tensor                # (N, 3 nreport) latest net forces
    force_hist: torch.Tensor            # (N, 9 nreport) last 3 substeps
    current_air_time: torch.Tensor      # (N, nfeet)
    last_air_time: torch.Tensor
    current_contact_time: torch.Tensor
    last_contact_time: torch.Tensor
    touchdown: torch.Tensor             # (N, nfeet) bool


def make_batched_init(model: RobotModel, n: int, device) -> SimState:
    """n envs at the model's default pose, at rest."""
    nf = len(model.foot_report_ids)

    def z(*shape):
        return torch.zeros((n,) + shape, device=device)

    qpos = torch.as_tensor(model.default_qpos(), dtype=torch.float32,
                           device=device).expand(n, model.nq).clone()
    return SimState(
        qpos=qpos, qvel=z(model.nv), lam=z(3 * model.ncand),
        applied_torque=z(model.nj), joint_acc=z(model.nj),
        forces=z(3 * model.nreport), force_hist=z(9 * model.nreport),
        current_air_time=z(nf), last_air_time=z(nf),
        current_contact_time=z(nf), last_contact_time=z(nf),
        touchdown=torch.zeros(n, nf, dtype=torch.bool, device=device),
    )


def substep_pre(mt: dyn.ModelTensors, params: EngineParams, terrain: Terrain,
                qpos, qvel, target_q, com_offset=None):
    """PD + dynamics + contact rows up to the contact problem.
    Returns (tau_j, v_free, E, W, b, phi, frame)."""
    h = params.dt
    m = mt.model
    tau_j = torch.clamp(params.kp * (target_q - qpos[:, 7:])
                        - params.kd * qvel[:, 6:],
                        -mt.effort_limit, mt.effort_limit)
    tau = torch.cat([torch.zeros_like(qvel[:, :6]), tau_j], dim=1)
    kin = dyn.fk(mt, qpos, qvel, com_offset)
    jacs = dyn.body_jacobians(mt, kin)
    I_w = dyn.world_inertias(mt, kin)
    M = dyn.mass_matrix(mt, jacs, I_w)
    C = dyn.bias_forces(mt, kin, jacs, I_w, qvel)
    if not m.uniform_3dof_branches():
        raise ValueError("the port's M^-1 needs legs of 3 contiguous dofs")
    Minv = dyn.mass_matrix_inverse(M, n_branch=m.nj // 3)
    v_free = qvel + h * torch.matmul(Minv, (tau - C)[..., None])[..., 0]
    con = detect_contacts(mt, terrain, kin)
    W = torch.matmul(Minv, con.E.transpose(1, 2))            # (N, nv, 3nc)
    b = torch.matmul(con.E, v_free[..., None])[..., 0]       # (N, 3nc)
    return tau_j, v_free, con.E, W, b, con.phi, con.frame


def substep_post(mt: dyn.ModelTensors, params: EngineParams, s: SimState,
                 tau_j, v_free, W, lam, frame) -> SimState:
    """Impulse application + integration + sensors."""
    h = params.dt
    m = mt.model
    n = lam.shape[0]
    v_new = v_free + torch.matmul(W, lam[..., None])[..., 0]
    quat = s.qpos[:, 3:7]
    base_pos = s.qpos[:, 0:3] + h * v_new[:, 0:3]
    base_quat = quat_integrate(quat, quat_rotate(quat, v_new[:, 3:6]), h)
    qj_new = s.qpos[:, 7:] + h * v_new[:, 6:]
    clamped = torch.clamp(qj_new, mt.joint_lower, mt.joint_upper)
    qdj_new = torch.where(clamped != qj_new, 0.0, v_new[:, 6:])
    v_new = torch.cat([v_new[:, :6], qdj_new], dim=1)
    qpos = torch.cat([base_pos, base_quat, clamped], dim=1)

    lam_c = lam.reshape(n, m.ncand, 3)
    lam_w = (lam_c if frame is None
             else torch.matmul(frame.transpose(-1, -2), lam_c[..., None])[..., 0])
    f_cand = lam_w / h                                       # (N, nc, 3)
    # self-collision rows report +f to body A's slot and -f to body B's
    f_all = torch.cat([f_cand, -f_cand[:, m.ncand_terrain:]], dim=1)
    forces = torch.einsum("rc,nci->nri", mt.report_matrix, f_all)
    forces_flat = forces.reshape(n, 3 * m.nreport)
    hist = torch.cat([s.force_hist[:, 3 * m.nreport:], forces_flat], dim=1)

    foot = forces[:, mt.foot_ids]
    in_contact = torch.sqrt(torch.sum(foot * foot, dim=-1)) \
        > params.contact_force_threshold
    cur_air, cur_con = s.current_air_time, s.current_contact_time
    touchdown_now = in_contact & (cur_air > 0.0)
    liftoff_now = ~in_contact & (cur_con > 0.0)
    return SimState(
        qpos=qpos, qvel=v_new, lam=lam, applied_torque=tau_j,
        joint_acc=(v_new[:, 6:] - s.qvel[:, 6:]) / h,
        forces=forces_flat, force_hist=hist,
        current_air_time=torch.where(in_contact, 0.0, cur_air + h),
        last_air_time=torch.where(touchdown_now, cur_air + h, s.last_air_time),
        current_contact_time=torch.where(in_contact, cur_con + h, 0.0),
        last_contact_time=torch.where(liftoff_now, cur_con + h,
                                      s.last_contact_time),
        touchdown=s.touchdown | touchdown_now,
    )


def pgs_kwargs(model: RobotModel, sp: solver.SolverParams) -> dict:
    """The block-Jacobi contact solve's keyword arguments for ``pgs_bj``."""
    if sp.structure != "bj":
        raise ValueError(
            f"solver structure {sp.structure!r} is not ported; the port runs "
            "the block-Jacobi kernel only ('bj')")
    perm, blocks = pgs.plan_contact_blocks(model, sp.bj_blocks)
    return dict(iterations=sp.iterations, cfm=sp.cfm, omega=sp.omega,
                contact_perm=perm, blocks=blocks)


class Engine(NamedTuple):
    """The batched engine of one model on one device: its tensors, its
    parameters, its terrain and the contact solve's arguments."""
    mt: dyn.ModelTensors
    params: EngineParams
    terrain: Terrain
    pgs_kwargs: dict

    def contact_problem(self, s: SimState, target_q, mu, com_offset=None):
        """Everything up to the contact solve at state s. Returns
        ((tau_j, v_free, W, frame), operands) with operands =
        (E, W, b, bias, active, mu, lam0), the contact kernel's inputs."""
        tau_j, v_free, E, W, b, phi, frame = substep_pre(
            self.mt, self.params, self.terrain, s.qpos, s.qvel, target_q,
            com_offset)
        sp = self.params.solver
        operands = (E, W, b, solver.contact_bias(phi, self.params.dt, sp),
                    (phi < sp.margin).to(E.dtype), mu, s.lam)
        return (tau_j, v_free, W, frame), operands

    def substep(self, s: SimState, target_q, mu, com_offset=None) -> SimState:
        (tau_j, v_free, W, frame), operands = self.contact_problem(
            s, target_q, mu, com_offset)
        lam = pgs.pgs_bj(*operands, **self.pgs_kwargs)
        return substep_post(self.mt, self.params, s, tau_j, v_free, W, lam,
                            frame)

    def __call__(self, s: SimState, target_q, mu, com_offset=None) -> SimState:
        """One 50 Hz control step = ``decimation`` substeps; target_q
        (N, nj), mu (N,), com_offset (N, nbody, 3) or None."""
        s = s._replace(touchdown=torch.zeros_like(s.touchdown))
        for _ in range(self.params.decimation):
            s = self.substep(s, target_q, mu, com_offset)
        return s


def make_batched_step(model: RobotModel, params: EngineParams,
                      terrain: Optional[Terrain] = None, device="cuda") -> Engine:
    """The control step of ``model`` on ``device`` (an Engine)."""
    return Engine(dyn.ModelTensors.build(model, device), params,
                  terrain if terrain is not None else plane(),
                  pgs_kwargs(model, params.solver))
