"""The batched physics engine: PD actuation + dynamics + contact solve +
integration + contact sensors, envs leading.

Port of cat_tpu/sim/engine.py and cat_tpu/sim/engine_lanes.py (the lanes
branch, the JAX package's production path). One control step is
``decimation`` substeps of

  1. IdealPD torque  tau = clip(Kp (q* - q) - Kd qd, +-effort)
  2. v_free = v + h M^-1 (tau - C)
  3. contact rows, W = M^-1 E^T, b = E v_free -> PGS impulses (the
     serial Gauss-Seidel kernel for structure "gs", the SolverParams
     default; the block-Jacobi kernel for "bj", the env default)
  4. semi-implicit Euler (quaternion exponential map), joint-limit clamp
  5. per-body net contact forces with a 3-deep history, foot air time

On a CUDA device ``Engine.__call__`` replays the control step from a CUDA
graph (``utils/graphs.py``): the first call of an input signature runs
the loop eagerly (the warm-up), the second captures it, every later call
copies its inputs into the graph's buffers and replays it. The replay runs
the same kernels in the same order as the loop (``Engine._eager``), so
its result equals the loop's bit for bit; on CPU tensors ``__call__`` is
the loop, and so it is while another step's capture is under way (the env
step's graph holds the loop).

The substep runs in one of two layouts, as in the reference
(``make_batched_step(layout=...)``): "lanes" (and "auto"), the production
path, runs it as four kernels (``ops/substep.py``: ``substep_dynamics``,
then ``contact_rows``, the contact solve, then ``substep_post`` for steps
4-5), each env's intermediates kept in its warp's registers and shared
memory; "vmap", the reference layout, runs the plain versions
``dynamics_stage``, ``contact_stage`` and ``post_stage`` op by op over the
batch around the same solve. On CPU tensors both run the plain versions.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from cat_tpu_torch.ops import pgs, substep
from cat_tpu_torch.utils import graphs

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


def init_state(model: RobotModel, qpos=None, qvel=None,
               device="cuda") -> SimState:
    """One env's state, with no env axis: at ``qpos`` (default: the
    model's default pose) and ``qvel`` (default: at rest)."""
    nf = len(model.foot_report_ids)

    def z(*shape):
        return torch.zeros(shape, device=device)

    return SimState(
        qpos=torch.as_tensor(qpos if qpos is not None else model.default_qpos(),
                             dtype=torch.float32, device=device),
        qvel=(torch.as_tensor(qvel, dtype=torch.float32, device=device)
              if qvel is not None else z(model.nv)),
        lam=z(3 * model.ncand), applied_torque=z(model.nj),
        joint_acc=z(model.nj), forces=z(3 * model.nreport),
        force_hist=z(9 * model.nreport), current_air_time=z(nf),
        last_air_time=z(nf), current_contact_time=z(nf),
        last_contact_time=z(nf),
        touchdown=torch.zeros(nf, dtype=torch.bool, device=device),
    )


def make_batched_init(model: RobotModel, n: int, device="cuda") -> SimState:
    """n envs at the model's default pose, at rest: ``init_state``
    broadcast over a leading env axis."""
    return SimState(*(x.expand((n,) + x.shape).clone()
                      for x in init_state(model, device=device)))


def dynamics_stage(mt: dyn.ModelTensors, params: EngineParams, qpos, qvel,
                   target_q, com_offset=None):
    """PD torque, kinematics, M, C, M^-1 and the free velocity: the plain
    version of ``ops/substep.py``'s dynamics kernel (the dynamics half of
    cat_tpu/sim/engine_lanes.py:38 ``_substep_pre_lanes``). Returns
    (tau_j, v_free, Minv, kin), kin the fields contacts read."""
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
    # structured inverse for legs of 3 contiguous dofs, else the unrolled
    # Cholesky (cat_tpu/sim/engine.py:121-127)
    if m.uniform_3dof_branches():
        Minv = dyn.mass_matrix_inverse(M, n_branch=m.nj // 3)
    else:
        eye = torch.eye(m.nv, dtype=M.dtype, device=M.device)
        Minv = dyn.cholesky_solve(dyn.cholesky_factor(M),
                                  eye.expand_as(M))
    v_free = qvel + h * torch.matmul(Minv, (tau - C)[..., None])[..., 0]
    return tau_j, v_free, Minv, dyn.ContactKin(kin.R, kin.o, kin.a_w)


def contact_stage(mt: dyn.ModelTensors, terrain: Terrain, kin, Minv, v_free):
    """Contact candidates and self-collision pairs, their rows E, W =
    M^-1 E^T and b = E v_free: the plain version of ``ops/substep.py``'s
    contact kernel (the contact half of ``_substep_pre_lanes``). Returns
    (E, W, b, phi, frame)."""
    con = detect_contacts(mt, terrain, kin)
    W = torch.matmul(Minv, con.E.transpose(1, 2))            # (N, nv, 3nc)
    b = torch.matmul(con.E, v_free[..., None])[..., 0]       # (N, 3nc)
    return con.E, W, b, con.phi, con.frame


def substep_pre(mt: dyn.ModelTensors, params: EngineParams, terrain: Terrain,
                qpos, qvel, target_q, com_offset=None):
    """PD + dynamics + contact rows up to the contact problem, the two plain
    stages in turn (cat_tpu/sim/engine_lanes.py:38 ``_substep_pre_lanes``).
    Returns (tau_j, v_free, E, W, b, phi, frame)."""
    tau_j, v_free, Minv, kin = dynamics_stage(mt, params, qpos, qvel,
                                              target_q, com_offset)
    return (tau_j, v_free) + contact_stage(mt, terrain, kin, Minv, v_free)


def post_stage(mt: dyn.ModelTensors, params: EngineParams, s: SimState,
               tau_j, v_free, W, lam, frame) -> SimState:
    """Impulse application + integration + sensors: the plain version of
    ``ops/substep.py``'s post kernel (cat_tpu/sim/engine_lanes.py:131
    ``_substep_post_lanes``)."""
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


def substep_post(mt: dyn.ModelTensors, params: EngineParams, s: SimState,
                 tau_j, v_free, W, lam, frame) -> SimState:
    """Impulse application + integration + sensors on the operands'
    device: the post kernel on a CUDA device, ``post_stage`` on the CPU
    (``ops/substep.py`` ``substep_post``)."""
    return substep.substep_post(mt, params, s, tau_j, v_free, W, lam, frame)


def contact_solver(model: RobotModel, sp: solver.SolverParams):
    """The contact solve ``sp.structure`` asks for and its keyword
    arguments: "gs" -> ``pgs_gs`` (``omega`` and ``bj_blocks`` ignored, as
    cat_tpu/sim/engine_lanes.py:252-257 does), "bj" -> ``pgs_bj``."""
    if sp.structure == "gs":
        return pgs.pgs_gs, dict(
            iterations=sp.iterations, cfm=sp.cfm,
            row_dofs=pgs.contact_row_dofs(model, model.ancestor_mask()))
    if sp.structure == "bj":
        perm, blocks = pgs.plan_contact_blocks(model, sp.bj_blocks)
        return pgs.pgs_bj, dict(iterations=sp.iterations, cfm=sp.cfm,
                                omega=sp.omega, contact_perm=perm,
                                blocks=blocks)
    raise ValueError(f"solver structure {sp.structure!r}: the port runs "
                     "'gs' (serial Gauss-Seidel) and 'bj' (block-Jacobi)")


class Engine(NamedTuple):
    """The batched engine of one model on one device: its tensors, its
    parameters, its terrain, the contact solve and its arguments, and the
    CUDA graphs of its control step (``graphs``, filled by ``__call__`` on
    a CUDA device; a copy made with ``_replace`` or rebuilt from the fields
    shares them), and the layout of the substep around the solve (module
    docstring)."""
    mt: dyn.ModelTensors
    params: EngineParams
    terrain: Terrain
    solve: Callable      # pgs.pgs_gs or pgs.pgs_bj
    pgs_kwargs: dict
    graphs: dict         # _graph_key -> utils.graphs.Graph
    layout: str = "auto"

    def contact_problem(self, s: SimState, target_q, mu, com_offset=None):
        """Everything up to the contact solve at state s. Returns
        ((tau_j, v_free, W, frame), operands) with operands =
        (E, W, b, bias, active, mu, lam0), the contact kernel's inputs."""
        if self.layout == "vmap":
            tau_j, v_free, E, W, b, phi, frame = substep_pre(
                self.mt, self.params, self.terrain, s.qpos, s.qvel, target_q,
                com_offset)
        else:
            tau_j, v_free, Minv, kin = substep.substep_dynamics(
                self.mt, self.params, s.qpos.contiguous(),
                s.qvel.contiguous(), target_q.contiguous(),
                None if com_offset is None else com_offset.contiguous())
            E, W, b, phi, frame = substep.contact_rows(
                self.mt, self.terrain, kin, Minv, v_free)
        sp = self.params.solver
        operands = (E, W, b, solver.contact_bias(phi, self.params.dt, sp),
                    (phi < sp.margin).to(E.dtype), mu, s.lam)
        return (tau_j, v_free, W, frame), operands

    def substep(self, s: SimState, target_q, mu, com_offset=None) -> SimState:
        (tau_j, v_free, W, frame), operands = self.contact_problem(
            s, target_q, mu, com_offset)
        lam = self.solve(*operands, **self.pgs_kwargs)
        post = post_stage if self.layout == "vmap" else substep_post
        return post(self.mt, self.params, s, tau_j, v_free, W, lam, frame)

    def __call__(self, s: SimState, target_q, mu, com_offset=None) -> SimState:
        """One 50 Hz control step = ``decimation`` substeps; target_q
        (N, nj), mu (N,), com_offset (N, nbody, 3) or None. On a CUDA
        device a replay of the step's CUDA graph (module docstring); the
        state returned shares no memory with the graph. While the current
        stream is capturing another step's graph (the env step's), the
        loop itself, so that it becomes part of that graph: a graph is
        never replayed inside another's capture."""
        if (s.qpos.device.type != "cuda"
                or torch.cuda.is_current_stream_capturing()):
            return self._eager(s, target_q, mu, com_offset)
        return self._graphed(s, target_q, mu, com_offset)

    def _graphed(self, s: SimState, target_q, mu, com_offset=None):
        """The control step from its CUDA graph for this input signature
        (``utils/graphs.py`` ``run``): the first call runs ``_eager`` (the
        warm-up: cuBLAS handles, the kernels' configurations and device
        tables, the terrain's tables), the second captures it, later calls
        replay it. Returns copies of the graph's outputs."""
        return graphs.run(
            self.graphs, self._graph_key(s, target_q, mu, com_offset),
            lambda *x: self._eager(SimState(*x[:-3]), *x[-3:]),
            (*s, target_q, mu, com_offset), owners=self.captured())

    def _eager(self, s: SimState, target_q, mu, com_offset=None) -> SimState:
        """The control step as a loop of ``decimation`` substeps, launched
        op by op from the host: what the CUDA graph captures."""
        s = s._replace(touchdown=torch.zeros_like(s.touchdown))
        for _ in range(self.params.decimation):
            s = self.substep(s, target_q, mu, com_offset)
        return s

    def _graph_key(self, s: SimState, target_q, mu, com_offset=None):
        """What a capture bakes in: each input's shape, dtype and device
        (the batch size, whether ``com_offset`` is given), and
        ``capture_key``."""
        return (graphs.signature((*s, target_q, mu, com_offset)),
                *self.capture_key())

    def captured(self) -> tuple:
        """The objects a capture of the control step reads: the model
        tensors, parameters, terrain and solve arguments."""
        return self.mt, self.params, self.terrain, self.pgs_kwargs

    def capture_key(self) -> tuple:
        """What a capture of the control step bakes in besides its inputs:
        the identity of ``captured``'s objects and the layout ("auto"
        runs as "lanes"). The solve itself is not in it: ``pgs_kwargs`` is
        made for it (``contact_solver``), and a copy whose solve wraps the
        same one (a profiler span) replays the same graph."""
        return (*map(id, self.captured()),
                "vmap" if self.layout == "vmap" else "lanes")


LAYOUTS = ("auto", "lanes", "vmap")


def make_batched_step(model: RobotModel, params: EngineParams,
                      num_envs: int = 0, terrain: Optional[Terrain] = None,
                      layout: str = "auto", *, device="cuda") -> Engine:
    """The control step of ``model`` on ``device`` (an Engine), in the
    reference's positional order (cat_tpu/sim/engine.py:296). ``num_envs``
    is ignored, as the reference's batched step ignores it off the TPU.
    ``layout`` as in the reference: "lanes" runs the substep around the
    solve as the three kernels of ``ops/substep.py`` on a CUDA device,
    "vmap" as the plain versions op by op, "auto" picks "lanes" (the reference picks
    lanes on its accelerator); on the CPU all three compute the same."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}: one of {LAYOUTS}")
    return Engine(dyn.ModelTensors.build(model, device), params,
                  terrain if terrain is not None else plane(),
                  *contact_solver(model, params.solver), {}, layout)
