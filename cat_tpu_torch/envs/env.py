"""CatEnv: the batched constrained locomotion environment, on the plane or
on a heightfield (port of cat_tpu/envs/env.py:238-804).

One ``step(state, action, generator)`` does, in the reference's order:
  1. action processing (raw action, previous action)
  2. ``decimation`` physics substeps toward default + scale * action
  3. episode / common counters
  4. terminations: time_out | illegal contact | upside down
  5. CaT constraints -> cstr_prob; reward = clip(r (1 - p), min 0);
     dones = cstr_prob, forced to 1 where an env resets
  6. terrain curriculum (heightfield), masked auto-reset at the env's own
     patch (reset events, then the reset event terms; finished-episode
     accumulators)
  7. command schedule, deadzone, stochastic resample, yaw-rate flip
  8. interval push event, then the interval event terms
  9. the 45-dim observation, plus the 187-point height scan on rough
     terrain, optionally noise-corrupted

Every random draw comes from the ``torch.Generator`` the caller passes, as
full (N, ...) tensors; resets are masked selects, so the step never waits
on the device and copies nothing from the host. On a CUDA device the whole
step, the physics control step inside it, replays a CUDA graph
(``utils/graphs.py``); ``_step_eager`` is the step it captures.

Around the physics the step runs three stages (``ops/env_step.py``), each
a CUDA kernel on the card and its plain version here on the CPU:
``terms_stage`` (3-5: the counters, the terminations, the raw constraint
columns and their maxima over envs), ``update_stage`` (5-8: the CaT
transform, the reward and dones, the accumulators, the curriculum and
masked reset, the commands and the push) and ``obs_stage`` (9). The draws
a stage reads are made before it, with the same ``torch.rand`` calls in
the same order as ever (``_update_draws``, ``_obs_draws``). Reset event
terms split ``update_stage`` in two: its "reset" part (through the masked
reset), the terms, then its "commands" part (the commands and the push).
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from cat_tpu_torch.ops import env_step
from cat_tpu_torch.ops.env_step import ObsDraws, Terms, UpdateDraws, Updated
from cat_tpu_torch.sim import engine as engine_mod
from cat_tpu_torch.sim import terrain as terrain_mod
from cat_tpu_torch.sim.engine import EngineParams, SimState
from cat_tpu_torch.sim.maths import quat_from_euler_zyx, quat_rotate_inv, quat_yaw
from cat_tpu_torch.sim.model import RobotModel
from cat_tpu_torch.sim.terrain import Terrain
from cat_tpu_torch.utils import graphs

from .cat import ConstraintSet, ConstraintTerm
from .types import EnvState, StepData


@dataclasses.dataclass(frozen=True)
class CommandsCfg:
    lin_vel_x: Tuple[float, float] = (-0.3, 1.0)
    lin_vel_y: Tuple[float, float] = (-0.7, 0.7)
    ang_vel_z: Tuple[float, float] = (-0.78, 0.78)
    resampling_time: float = 10.0
    rel_standing_envs: float = 0.02
    velocity_deadzone: float = 0.1


class EventTerm(NamedTuple):
    """An event term a task adds through ``EventsCfg.extra_terms``, fired
    beside the built-in events in one of the reference's three modes
    (cat_tpu/envs/env.py:65-90). Every draw comes from the env's
    ``torch.Generator`` ``gen``:

      startup : func(gen, n, model, **params) -> dict of EnvState field
                updates, applied once at the end of ``init``;
      reset   : func(gen, sim, reset (N,) bool, model, **params) ->
                SimState, applied to the state after the masked auto-reset
                (so it sees freshly reset envs; guard by ``reset``);
      interval: func(gen, sim, state, cfg, **params) -> SimState, applied
                every control step after the push (``state``: the step's
                input EnvState).
    """
    name: str
    mode: str
    func: Callable
    params: Optional[Dict] = None


@dataclasses.dataclass(frozen=True)
class EventsCfg:
    friction_range: Tuple[float, float] = (0.5, 1.25)   # startup, per env
    friction_num_buckets: int = 100      # PhysX material buckets
    reset_pose_xy: float = 0.05
    reset_yaw: float = 1.57
    reset_joint_scale: Tuple[float, float] = (0.95, 1.05)
    push_vel_xy: float = 0.5
    push_enabled: bool = True
    # randomize_body_coms, a startup event: the CoM of each body that
    # com_bodies names moves by U(-d, d)^3 in its frame, per env; 0 (the
    # recipes' setting) leaves it off and the engine without offsets
    com_displacement: float = 0.0
    com_bodies: Tuple[str, ...] = (".*",)
    extra_terms: Tuple[EventTerm, ...] = ()


@dataclasses.dataclass(frozen=True)
class NoiseCfg:
    enabled: bool = True
    ang_vel: float = 0.001
    gravity: float = 0.05
    joint_pos: float = 0.01
    joint_vel: float = 0.2


@dataclasses.dataclass(frozen=True)
class RewardsCfg:
    lin_weight: float = 1.0
    ang_weight: float = 0.5
    std2: float = 0.25


@dataclasses.dataclass(frozen=True)
class TerminationsCfg:
    upside_down_limit: float = 0.1
    contact_threshold: float = 1.0


@dataclasses.dataclass(frozen=True)
class HeightScanCfg:
    """Height-scanner observation grid (cat_tpu/envs/env.py:140-170): a
    yaw-aligned grid around the base, obs = clip(base_z - offset_z - h)."""
    size_x: float = 1.6
    size_y: float = 1.0
    resolution: float = 0.1
    offset_z: float = 0.5
    clip: float = 1.0
    noise: float = 0.1

    @property
    def num_points(self) -> int:
        nx = int(round(self.size_x / self.resolution)) + 1
        ny = int(round(self.size_y / self.resolution)) + 1
        return nx * ny

    def grid(self) -> np.ndarray:
        xs = np.linspace(-self.size_x / 2, self.size_x / 2,
                         int(round(self.size_x / self.resolution)) + 1)
        ys = np.linspace(-self.size_y / 2, self.size_y / 2,
                         int(round(self.size_y / self.resolution)) + 1)
        gx, gy = np.meshgrid(xs, ys, indexing="ij")
        return np.stack([gx.ravel(), gy.ravel()], axis=-1)  # (P, 2)


@dataclasses.dataclass(frozen=True)
class EnvCfg:
    num_envs: int = 4096
    episode_length_s: float = 10.0
    sim_dt: float = 0.005
    decimation: int = 4
    action_scale: float = 0.5
    curriculum_steps: int = 24 * 1000
    commands: CommandsCfg = CommandsCfg()
    events: EventsCfg = EventsCfg()
    noise: NoiseCfg = NoiseCfg()
    rewards: RewardsCfg = RewardsCfg()
    terminations: TerminationsCfg = TerminationsCfg()
    kp: float = 4.0
    kd: float = 0.2
    # PGS sweep count (None = the SolverParams default, 5); an explicit
    # count wins over the one in solver_structure
    solver_iterations: Optional[int] = None
    # "gs" or "bj:<n_blocks>[:<omega>[:<iterations>]]"; None = the
    # SolverParams default (serial Gauss-Seidel). The env default is the
    # block-Jacobi sweep of the JAX package's env.
    solver_structure: Optional[str] = "bj:4:0.9:6"
    terrain: Terrain = terrain_mod.plane()
    height_scan: Optional[HeightScanCfg] = None
    terrain_curriculum: bool = False   # promote / demote difficulty rows

    @property
    def step_dt(self) -> float:
        return self.sim_dt * self.decimation

    @property
    def max_episode_length(self) -> int:
        return int(round(self.episode_length_s / self.step_dt))


def resolve_names(patterns: Sequence[str], names: Sequence[str],
                  preserve_order: bool = False) -> np.ndarray:
    """Regex patterns -> indices; in pattern order if preserve_order, else
    in name order."""
    if preserve_order:
        out = [i for p in patterns for i, n in enumerate(names)
               if re.compile(p + "$").match(n)]
    else:
        out = [i for i, n in enumerate(names)
               if any(re.compile(p + "$").match(n) for p in patterns)]
    if not out:
        raise ValueError(f"no match for {patterns} in {names}")
    return np.array(out, dtype=np.int32)


def engine_params(cfg: EnvCfg) -> EngineParams:
    """The EngineParams an EnvCfg asks for, as cat_tpu/envs/env.py:268-286
    builds them: None fields keep the SolverParams defaults, and an
    explicit solver_iterations wins over the structure string's count."""
    params = EngineParams(dt=cfg.sim_dt, decimation=cfg.decimation,
                          kp=cfg.kp, kd=cfg.kd)
    sp = params.solver
    if cfg.solver_iterations is not None:
        sp = sp._replace(iterations=cfg.solver_iterations)
    if cfg.solver_structure is not None:
        parts = cfg.solver_structure.split(":")
        sp = sp._replace(structure=parts[0])
        if len(parts) > 1:
            sp = sp._replace(bj_blocks=int(parts[1]))
        if len(parts) > 2:
            sp = sp._replace(omega=float(parts[2]))
        if len(parts) > 3 and cfg.solver_iterations is None:
            sp = sp._replace(iterations=int(parts[3]))
    return params._replace(solver=sp)


class CatEnv:
    # the observation's scales: the base's angular velocity, the command
    # (x, y, yaw rate), the projected gravity, the joints' velocities
    ang_vel_scale = 0.25
    command_scale = (2.0, 2.0, 0.25)
    gravity_scale = 0.1
    joint_vel_scale = 0.05

    def __init__(self, model: RobotModel, cfg: EnvCfg,
                 constraint_terms: Sequence[ConstraintTerm],
                 actuated_joint_order: Sequence[str],
                 illegal_contact_bodies: Sequence[str] = (
                     "base_link", ".*_UPPER_LEG"),
                 device="cuda"):
        self.model = model
        self.cfg = cfg
        self.device = dev = torch.device(device)
        self.num_actions = model.nj
        t2m = resolve_names(list(actuated_joint_order), model.joint_names,
                            preserve_order=True)
        m2t = np.empty(model.nj, dtype=np.int64)
        m2t[t2m] = np.arange(model.nj)
        self.t2m = torch.as_tensor(t2m, dtype=torch.long, device=dev)
        self.m2t = torch.as_tensor(m2t, device=dev)
        self.default_joint_pos_task = torch.as_tensor(
            model.default_qpos_joints[t2m], dtype=torch.float32, device=dev)
        self.illegal_ids = torch.as_tensor(
            resolve_names(list(illegal_contact_bodies), model.report_names),
            dtype=torch.long, device=dev)
        self.engine = engine_mod.make_batched_step(
            model, engine_params(cfg), terrain=cfg.terrain, device=dev)
        self._qj_lo = torch.as_tensor(model.joint_limit_lower,
                                      dtype=torch.float32, device=dev)
        self._qj_hi = torch.as_tensor(model.joint_limit_upper,
                                      dtype=torch.float32, device=dev)
        self._qj_default = torch.as_tensor(model.default_qpos_joints,
                                           dtype=torch.float32, device=dev)
        c = cfg.commands
        self._cmd_lo = torch.tensor(
            [c.lin_vel_x[0], c.lin_vel_y[0], c.ang_vel_z[0]], device=dev)
        self._cmd_hi = torch.tensor(
            [c.lin_vel_x[1], c.lin_vel_y[1], c.ang_vel_z[1]], device=dev)
        self._cmd_scale = torch.tensor(self.command_scale, device=dev)
        self._gravity_dir = torch.tensor([0.0, 0.0, -1.0], device=dev)
        self._reset_templates = {}     # n -> SimState (``_reset_sim``)
        self.graphs = {}               # _graph_key -> utils.graphs.Graph
        self.kernel_tables = {}        # device -> ops/env_step.py's tables
        self.cset = ConstraintSet(constraint_terms, self._probe_data(2), dev)
        self.num_obs = 9 + 3 * self.num_actions  # 45 for Solo12
        if cfg.height_scan is not None:
            self._scan_grid = torch.as_tensor(cfg.height_scan.grid(),
                                              dtype=torch.float32, device=dev)
            self.num_obs += cfg.height_scan.num_points  # + 187

    # ---------------- helpers ----------------

    def _rand(self, gen, *shape) -> torch.Tensor:
        return torch.rand(shape, generator=gen, device=self.device)

    def _uniform(self, gen, shape, lo, hi) -> torch.Tensor:
        return lo + (hi - lo) * self._rand(gen, *shape)

    def _probe_data(self, n: int) -> StepData:
        nj, nr = self.model.nj, self.model.nreport
        nf = len(self.model.foot_report_ids)

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        return StepData(
            joint_pos=z(n, nj), joint_vel=z(n, nj), joint_acc=z(n, nj),
            applied_torque=z(n, nj),
            default_joint_pos=self.default_joint_pos_task,
            base_pos=z(n, 3), base_yaw=z(n), base_lin_vel_b=z(n, 3),
            base_ang_vel_b=z(n, 3), projected_gravity=z(n, 3),
            command=z(n, 3), action=z(n, nj), prev_action=z(n, nj),
            force_hist=z(n, 3, nr, 3), touchdown=z(n, nf, dtype=torch.bool),
            last_air_time=z(n, nf), step_dt=self.cfg.step_dt,
        )

    def step_data(self, sim: SimState, command, action, prev_action) -> StepData:
        n = command.shape[0]
        quat = sim.qpos[:, 3:7]
        g_dir = self._gravity_dir.expand_as(quat[:, :3])
        return StepData(
            joint_pos=sim.qpos[:, 7:][:, self.t2m],
            joint_vel=sim.qvel[:, 6:][:, self.t2m],
            joint_acc=sim.joint_acc[:, self.t2m],
            applied_torque=sim.applied_torque[:, self.t2m],
            default_joint_pos=self.default_joint_pos_task,
            base_pos=sim.qpos[:, 0:3],
            base_yaw=quat_yaw(quat),
            base_lin_vel_b=quat_rotate_inv(quat, sim.qvel[:, 0:3]),
            base_ang_vel_b=sim.qvel[:, 3:6],
            projected_gravity=quat_rotate_inv(quat, g_dir),
            command=command, action=action, prev_action=prev_action,
            force_hist=sim.force_hist.reshape(n, 3, self.model.nreport, 3),
            touchdown=sim.touchdown,
            last_air_time=sim.last_air_time,
            step_dt=self.cfg.step_dt,
        )

    # ---------------- init / reset ----------------

    def init(self, gen: torch.Generator, num_envs: Optional[int] = None) -> EnvState:
        n = num_envs or self.cfg.num_envs
        nj, nt = self.model.nj, self.cset.n_terms
        ev = self.cfg.events
        dev = self.device
        # startup friction: num_buckets discrete values drawn once from the
        # range, then a random bucket per env (PhysX material buckets)
        buckets = self._uniform(gen, (ev.friction_num_buckets,),
                                *ev.friction_range)
        mu = buckets[torch.randint(0, ev.friction_num_buckets, (n,),
                                   generator=gen, device=dev)]

        # terrain patch assignment: a random row of the easier half, the
        # columns in turn (plane: all at the origin)
        terr = self.cfg.terrain
        if terr.kind == "hfield":
            trow = torch.randint(0, max(1, terr.rows // 2), (n,),
                                 generator=gen, device=dev).to(torch.int32)
            tcol = (torch.arange(n, device=dev) % terr.cols).to(torch.int32)
            origin = self._patch_origins(trow, tcol)
        else:
            trow = torch.zeros(n, dtype=torch.int32, device=dev)
            tcol = torch.zeros(n, dtype=torch.int32, device=dev)
            origin = torch.zeros(n, 2, device=dev)

        def z(*shape):
            return torch.zeros(shape, device=dev)

        sim = SimState(*(x.clone() for x in self._reset_sim(gen, n, origin)))
        command = self._sample_commands(gen, n)
        # randomize_body_coms, drawn after every other startup draw, so the
        # rest of the state is the one an env without it starts from
        com_offset = z(n, self.model.nbody, 3)
        if ev.com_displacement > 0.0:
            mask = torch.zeros(self.model.nbody, 1, device=dev)
            mask[torch.as_tensor(resolve_names(list(ev.com_bodies),
                                               self.model.body_names),
                                 dtype=torch.long, device=dev)] = 1.0
            com_offset = self._uniform(gen, (n, self.model.nbody, 3),
                                       -ev.com_displacement,
                                       ev.com_displacement) * mask
        state = EnvState(
            sim=sim,
            action=z(n, nj), prev_action=z(n, nj),
            episode_len=torch.zeros(n, dtype=torch.int32, device=dev),
            command=command,
            command_time_left=torch.full(
                (n,), self.cfg.commands.resampling_time, device=dev),
            mu=mu, com_offset=com_offset,
            running_max=self.cset.init_running_max(),
            max_p=self.cset.init_max_p(),
            episode_viol=z(n, nt), episode_prob=z(n, nt), episode_rew=z(n),
            origin=origin, terrain_row=trow, terrain_col=tcol,
            common_step=torch.zeros((), dtype=torch.int32, device=dev),
            acc_viol=z(nt), acc_prob=z(nt), acc_rew=z(), acc_len=z(),
            acc_count=z(), acc_term=z(3),
        )
        for t in ev.extra_terms:
            if t.mode == "startup":
                state = state._replace(**t.func(gen, n, self.model,
                                                **(t.params or {})))
        return state

    def _sample_commands(self, gen, n: int) -> torch.Tensor:
        """Uniform command sample; a rel_standing_envs share stands still."""
        return self._commands_from(self._rand(gen, n, 4))

    def _commands_from(self, u: torch.Tensor) -> torch.Tensor:
        """``_sample_commands`` from its draw u (N, 4)."""
        cmd = self._cmd_lo + (self._cmd_hi - self._cmd_lo) * u[:, :3]
        standing = u[:, 3] < self.cfg.commands.rel_standing_envs
        return torch.where(standing[:, None], 0.0, cmd)

    def _patch_origins(self, row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
        """World xy of the centres of patches (row, col)."""
        t = self.cfg.terrain
        H, W = t.size_m
        x = (row.float() + 0.5) * t.patch_m - H / 2.0
        y = (col.float() + 0.5) * t.patch_m - W / 2.0
        return torch.stack([x, y], dim=-1)

    def _reset_sim(self, gen, n: int, origin: torch.Tensor) -> SimState:
        """Fresh randomized states for ALL envs (masked-selected later):
        pose xy = origin +-reset_pose_xy, yaw +-reset_yaw, joints =
        default * U(scale), zero velocity, default height above the
        terrain there. Every field but qpos is the reset template's own
        tensor (``_reset_template``)."""
        return self._reset_sim_from(self._rand(gen, n, 3 + self.model.nj),
                                    origin)

    def _reset_sim_from(self, u: torch.Tensor, origin: torch.Tensor) -> SimState:
        """``_reset_sim`` from its draw u (N, 3 + nj)."""
        n = u.shape[0]
        ev = self.cfg.events
        xy = origin + (2.0 * u[:, 0:2] - 1.0) * ev.reset_pose_xy
        yaw = (2.0 * u[:, 2] - 1.0) * ev.reset_yaw
        zero = torch.zeros_like(yaw)
        quat = quat_from_euler_zyx(zero, zero, yaw)
        lo, hi = ev.reset_joint_scale
        qj = self._qj_default * (lo + (hi - lo) * u[:, 3:])
        qj = torch.clamp(qj, self._qj_lo, self._qj_hi)
        z = (float(self.model.default_base_pos[2])
             + terrain_mod.height_at(self.cfg.terrain, xy))[:, None]
        return self._reset_template(n)._replace(
            qpos=torch.cat([xy, z, quat, qj], dim=1))

    def _reset_template(self, n: int) -> SimState:
        """n envs at the model's default pose, at rest
        (``make_batched_init``), made once for each n: the step copies
        nothing from the host, which a CUDA graph's capture refuses."""
        if n not in self._reset_templates:
            self._reset_templates[n] = engine_mod.make_batched_init(
                self.model, n, self.device)
        return self._reset_templates[n]

    def observe(self, state: EnvState, gen: torch.Generator) -> torch.Tensor:
        """Observation of the current state (the reset observation)."""
        draws = self._obs_draws(gen, state.action.shape[0])
        return env_step.env_obs(self, state.sim, state.command, state.action,
                                draws)

    # ---------------- the step ----------------

    def step(self, state: EnvState, raw_action: torch.Tensor,
             gen: torch.Generator):
        """Returns (state', obs, reward, dones (float), time_outs (bool)).
        On a CUDA device a replay of the env step's CUDA graph
        (``utils/graphs.py`` ``run``): the first call of an input signature
        runs ``_step_eager`` (the warm-up), the second captures it, later
        calls replay it; what it returns shares no memory with the graph.
        The graph registers ``gen``: a replay draws what the eager step
        would, and advances ``gen`` as far."""
        if raw_action.device.type != "cuda":
            return self._step_eager(state, raw_action, gen)
        leaves, spec = pytree.tree_flatten((state, raw_action))
        return graphs.run(
            self.graphs, self._graph_key(leaves, gen),
            lambda *x: self._step_eager(*pytree.tree_unflatten(x, spec), gen),
            leaves, owners=(gen, self.cfg, *self.engine.captured()),
            generators=(gen,))

    def _graph_key(self, leaves, gen) -> tuple:
        """What a capture of the env step bakes in: each input's shape,
        dtype and device, the generator, the config (the event terms
        among it), and what the control step's capture bakes in
        (``Engine.capture_key``). Not the engine itself: a copy of it whose
        calls run in profiler spans (the bench's) replays the same
        graph."""
        return (graphs.signature(leaves), id(gen), id(self.cfg),
                *self.engine.capture_key())

    def _step_eager(self, state: EnvState, raw_action: torch.Tensor,
                    gen: torch.Generator):
        """The env step launched op by op from the host: what the CUDA
        graph captures. ``ops/env_step.py`` dispatches its three stages on
        the tensors' device."""
        cfg = self.cfg
        n = raw_action.shape[0]
        terms_fn, update_fn, obs_fn = (
            functools.partial(f, self) for f in (
                env_step.env_terms, env_step.env_update, env_step.env_obs))

        # 1-2. actions -> PD targets (task order -> model order), physics
        prev_action, action = state.action, raw_action
        target = (self.default_joint_pos_task
                  + cfg.action_scale * action)[:, self.m2t]
        sim = self.engine(state.sim, target, state.mu,
                          state.com_offset if cfg.events.com_displacement > 0.0
                          else None)

        # 3-5. counters, terminations, raw constraint columns
        terms = terms_fn(state, sim, action, prev_action)

        # 5-8. CaT, reward, accumulators, curriculum, masked reset (then the
        # reset event terms), commands, push
        reset_terms = [t for t in cfg.events.extra_terms if t.mode == "reset"]
        u_reset = self._rand(gen, n, 3 + self.model.nj)
        if reset_terms:
            up = update_fn(state, sim, action, prev_action, terms,
                           UpdateDraws(u_reset), part="reset")
            sim = up.sim
            reset = terms.illegal | terms.upside | terms.time_out
            for t in reset_terms:
                sim = t.func(gen, sim, reset, self.model, **(t.params or {}))
            cmd = update_fn(state, sim, action, prev_action, terms,
                            self._update_draws(gen, n, u_reset),
                            part="commands")
            up = up._replace(sim=cmd.sim, command=cmd.command,
                             command_time_left=cmd.command_time_left)
        else:
            up = update_fn(state, sim, action, prev_action, terms,
                           self._update_draws(gen, n, u_reset))
        sim = up.sim
        for t in cfg.events.extra_terms:
            if t.mode == "interval":
                sim = t.func(gen, sim, state, cfg, **(t.params or {}))

        # 9. observations
        obs = obs_fn(sim, up.command, up.action, self._obs_draws(gen, n))

        new_state = EnvState(
            sim=sim, action=up.action, prev_action=up.prev_action,
            episode_len=up.episode_len, command=up.command,
            command_time_left=up.command_time_left, mu=state.mu,
            com_offset=state.com_offset,
            running_max=up.running_max, max_p=up.max_p,
            episode_viol=up.episode_viol, episode_prob=up.episode_prob,
            episode_rew=up.episode_rew, origin=up.origin,
            terrain_row=up.terrain_row, terrain_col=state.terrain_col,
            common_step=terms.common_step,
            acc_viol=up.acc_viol, acc_prob=up.acc_prob, acc_rew=up.acc_rew,
            acc_len=up.acc_len, acc_count=up.acc_count, acc_term=up.acc_term,
        )
        return new_state, obs, up.reward, up.dones, terms.time_out

    # ---------------- the draws ----------------

    def _update_draws(self, gen, n: int, u_reset: torch.Tensor) -> UpdateDraws:
        """The draws of ``update_stage`` after the reset's ``u_reset``, in
        the step's order: the reset envs' commands, the scheduled and the
        stochastic resample's, the yaw flip's, the push's."""
        draws = dict(reset=u_reset,
                     reset_command=self._rand(gen, n, 4),
                     expired_command=self._rand(gen, n, 4),
                     resample=self._rand(gen, n),
                     resample_command=self._rand(gen, n, 4),
                     flip=self._rand(gen, n))
        ev = self.cfg.events
        if ev.push_enabled:
            draws.update(push=self._rand(gen, n),
                         push_vel=self._uniform(gen, (n, 2), -ev.push_vel_xy,
                                                ev.push_vel_xy))
        return UpdateDraws(**draws)

    def _obs_draws(self, gen, n: int) -> ObsDraws:
        """The observation noise, in its columns' order: each noisy part's
        raw U(0, 1) draw (``_rand``, the draws ``_uniform`` made before it
        applied its affine), None where a part has none, with each part's
        affine to U(-mag, mag) (``ObsDraws.uniform``)."""
        mags = self.obs_noise()
        return ObsDraws.uniform(
            [None if mag is None else self._rand(gen, n, width)
             for mag, width in zip(mags, self.obs_noise_widths())], mags)

    def obs_noise(self) -> tuple:
        """The five noisy parts' noise magnitudes, in the columns' order
        (the angular velocity, the projected gravity, the joints' positions
        and velocities, the scan), None where a part has none."""
        nz, hs = self.cfg.noise, self.cfg.height_scan
        mags = (nz.ang_vel, nz.gravity, nz.joint_pos, nz.joint_vel,
                hs.noise if hs is not None else 0.0)
        return tuple(None if not nz.enabled or m == 0.0 else m for m in mags)

    def obs_noise_widths(self) -> tuple:
        """The five noisy parts' widths, in the columns' order."""
        hs, nj = self.cfg.height_scan, self.num_actions
        return (3, 3, nj, nj, hs.num_points if hs is not None else 0)

    # ---------------- the stages' plain versions ----------------

    def terms_stage(self, state: EnvState, sim: SimState, action,
                    prev_action) -> Terms:
        """Steps 3-5 up to the CaT transform: the counters, the
        terminations, the raw constraint columns and their maxima over
        envs (the plain version of ``ops/env_step.py`` ``env_terms``)."""
        cfg = self.cfg
        n = action.shape[0]

        # 3. counters
        episode_len = state.episode_len + 1
        common_step = state.common_step + 1
        data = self.step_data(sim, state.command, action, prev_action)

        # 4. terminations
        time_out = episode_len >= cfg.max_episode_length
        hist = sim.force_hist.reshape(n, 3, self.model.nreport, 3)
        hist_n = torch.linalg.vector_norm(hist[:, :, self.illegal_ids], dim=-1)
        illegal = torch.any(torch.amax(hist_n, dim=1)
                            > cfg.terminations.contact_threshold, dim=1)
        upside = (torch.linalg.vector_norm(data.projected_gravity[:, :2], dim=1)
                  > cfg.terminations.upside_down_limit)

        # 5. the raw constraint columns
        raw = self.cset.raw(data)
        return Terms(episode_len, common_step, time_out, illegal, upside, raw,
                     self.cset.column_max(raw))

    def update_stage(self, state: EnvState, sim: SimState, action,
                     prev_action, terms: Terms, draws: UpdateDraws,
                     part: str = "all") -> Updated:
        """Steps 5-8 from ``terms``: the CaT transform, the reward and
        dones, the finished-episode accumulators, the terrain curriculum
        and the masked reset ("reset"), then the commands and the push
        ("commands"); "all" is both (the plain version of
        ``ops/env_step.py`` ``env_update``). The "commands" part reads the
        state as the reset event terms left it (``sim``) and fills only
        ``sim``, ``command`` and ``command_time_left``."""
        cfg = self.cfg
        reset = terms.illegal | terms.upside | terms.time_out
        if part == "commands":
            out = dict.fromkeys(Updated._fields)
        else:
            out = self._update_reset(state, sim, action, prev_action, terms,
                                     draws.reset)
            sim = out["sim"]
        if part == "reset":
            return Updated(**out)

        command = torch.where(reset[:, None],
                              self._commands_from(draws.reset_command),
                              state.command)
        time_left = torch.where(reset, cfg.commands.resampling_time,
                                state.command_time_left)

        # 7. command schedule + deadzone logic
        command, time_left = self._update_commands(command, time_left, draws)

        # 8. interval push: overwrite the whole root velocity
        if cfg.events.push_enabled:
            p_push = cfg.sim_dt / (cfg.episode_length_s * 2.0)
            push = draws.push < p_push
            new_qvel = torch.cat([draws.push_vel,
                                  torch.zeros_like(sim.qvel[:, 2:6]),
                                  sim.qvel[:, 6:]], dim=1)
            sim = sim._replace(
                qvel=torch.where(push[:, None], new_qvel, sim.qvel))
        out.update(sim=sim, command=command, command_time_left=time_left)
        return Updated(**out)

    def _update_reset(self, state, sim, action, prev_action, terms,
                      u_reset) -> dict:
        """``update_stage``'s "reset" part, as a dict of ``Updated``'s
        fields."""
        cfg = self.cfg
        n = action.shape[0]
        episode_len = terms.episode_len
        illegal, upside, time_out = terms.illegal, terms.upside, terms.time_out
        terminated = illegal | upside
        reset = terminated | time_out
        data = self.step_data(sim, state.command, action, prev_action)

        # 5. CaT constraints + reward
        max_p = self.cset.curriculum_max_p(terms.common_step,
                                           cfg.curriculum_steps)
        cstr_prob, running_max, term_probs, viol = self.cset.transform(
            terms.raw, terms.col_max, state.running_max, max_p)
        rw = cfg.rewards
        lin_err = torch.sum(
            torch.square(data.command[:, :2] - data.base_lin_vel_b[:, :2]), dim=1)
        ang_err = torch.square(data.command[:, 2] - data.base_ang_vel_b[:, 2])
        base_reward = (rw.lin_weight * torch.exp(-lin_err / rw.std2)
                       + rw.ang_weight * torch.exp(-ang_err / rw.std2)
                       ) * cfg.step_dt
        reward = torch.clamp(base_reward * (1.0 - cstr_prob), min=0.0)
        dones = torch.where(reset, 1.0, cstr_prob)

        episode_viol = state.episode_viol + viol.float()
        episode_prob = state.episode_prob + term_probs
        episode_rew = state.episode_rew + reward

        # 6. finished-episode accumulators, masked auto-reset
        rf = reset.float()
        ep_len_f = torch.clamp(episode_len.float(), min=1.0)
        acc_viol = state.acc_viol + torch.sum(
            rf[:, None] * episode_viol / ep_len_f[:, None] * 100.0, dim=0)
        acc_prob = state.acc_prob + torch.sum(
            rf[:, None] * episode_prob / ep_len_f[:, None], dim=0)
        acc_rew = state.acc_rew + torch.sum(rf * episode_rew)
        acc_len = state.acc_len + torch.sum(rf * episode_len)
        acc_count = state.acc_count + torch.sum(rf)
        acc_term = state.acc_term + torch.stack([
            torch.sum(illegal.float()),
            torch.sum((upside & ~illegal).float()),
            torch.sum((time_out & ~terminated).float()),
        ])

        # terrain curriculum: an env that timed out having walked at least
        # half its commanded distance (and was commanded to move) goes one
        # row up, one that walked under a quarter goes one row down; the
        # reset below spawns it at its new patch
        origin, trow = state.origin, state.terrain_row
        if cfg.terrain_curriculum and cfg.terrain.kind == "hfield":
            dist = torch.linalg.vector_norm(sim.qpos[:, 0:2] - origin, dim=1)
            speed = torch.linalg.vector_norm(state.command[:, :2], dim=1)
            required = speed * cfg.episode_length_s
            moving = speed > cfg.commands.velocity_deadzone
            move_up = time_out & (dist > 0.5 * required) & moving
            move_down = dist < 0.25 * required
            new_row = torch.clamp(trow + move_up.int() - move_down.int(),
                                  0, cfg.terrain.rows - 1).to(torch.int32)
            trow = torch.where(reset, new_row, trow)
            origin = torch.where(reset[:, None],
                                 self._patch_origins(trow, state.terrain_col),
                                 origin)

        fresh = self._reset_sim_from(u_reset, origin)
        sim = SimState(*[
            torch.where(reset.reshape((n,) + (1,) * (old.dim() - 1)), new, old)
            for new, old in zip(fresh, sim)
        ])
        return dict(
            sim=sim, reward=reward, dones=dones,
            running_max=running_max, max_p=max_p,
            episode_len=torch.where(reset, 0, episode_len).to(torch.int32),
            episode_viol=torch.where(reset[:, None], 0.0, episode_viol),
            episode_prob=torch.where(reset[:, None], 0.0, episode_prob),
            episode_rew=torch.where(reset, 0.0, episode_rew),
            action=torch.where(reset[:, None], 0.0, action),
            prev_action=torch.where(reset[:, None], 0.0, prev_action),
            origin=origin, terrain_row=trow,
            acc_viol=acc_viol, acc_prob=acc_prob, acc_rew=acc_rew,
            acc_len=acc_len, acc_count=acc_count, acc_term=acc_term,
            command=None, command_time_left=None)

    def _update_commands(self, command, time_left, draws: UpdateDraws):
        """Scheduled resample, deadzone zeroing, stochastic resample and
        yaw-rate flip; the stochastic rates use the PHYSICS dt."""
        c, cfg = self.cfg.commands, self.cfg
        time_left = time_left - cfg.step_dt
        expired = time_left <= 0.0
        command = torch.where(expired[:, None],
                              self._commands_from(draws.expired_command),
                              command)
        time_left = torch.where(expired, c.resampling_time, time_left)

        keep = torch.any(torch.abs(command) > c.velocity_deadzone, dim=1)
        command = command * keep[:, None].float()

        no_cmd = (torch.linalg.vector_norm(command, dim=1)
                  < c.velocity_deadzone).float()
        p_res = 0.01 * no_cmd + (cfg.sim_dt / cfg.episode_length_s) * (1 - no_cmd)
        resample = draws.resample < p_res
        command = torch.where(resample[:, None],
                              self._commands_from(draws.resample_command),
                              command)
        time_left = torch.where(resample, c.resampling_time, time_left)

        flip = draws.flip < cfg.sim_dt / cfg.episode_length_s
        command = torch.cat([command[:, :2],
                             command[:, 2:] * (1.0 - 2.0 * flip.float())[:, None]],
                            dim=1)
        return command, time_left

    def obs_stage(self, sim: SimState, command, action,
                  draws: ObsDraws) -> torch.Tensor:
        """Step 9: the observation (the plain version of
        ``ops/env_step.py`` ``env_obs``)."""
        return self._observations(self.step_data(sim, command, action, None),
                                  draws)

    def _observations(self, data: StepData, draws: ObsDraws) -> torch.Tensor:
        def noise(x, k):
            z = draws.noise(k)
            return x if z is None else x + z

        parts = [
            noise(data.base_ang_vel_b, 0) * self.ang_vel_scale,
            data.command * self._cmd_scale,
            noise(data.projected_gravity, 1) * self.gravity_scale,
            noise(data.joint_pos, 2),
            noise(data.joint_vel, 3) * self.joint_vel_scale,
            data.action,
        ]
        hs = self.cfg.height_scan
        if hs is not None:
            h = terrain_mod.height_at(
                self.cfg.terrain, self.scan_points(data.base_pos,
                                                   data.base_yaw))
            scan = torch.clamp(data.base_pos[:, 2:3] - hs.offset_z - h,
                               -hs.clip, hs.clip)
            parts.append(noise(scan, 4))
        return torch.cat(parts, dim=1)

    def scan_points(self, base_pos, base_yaw) -> torch.Tensor:
        """(N, points, 2) world xy of the height scan: its grid turned by
        the base's yaw, around the base."""
        cy, sy = torch.cos(base_yaw), torch.sin(base_yaw)
        gx, gy = self._scan_grid[:, 0], self._scan_grid[:, 1]
        px = base_pos[:, 0:1] + cy[:, None] * gx - sy[:, None] * gy
        py = base_pos[:, 1:2] + sy[:, None] * gx + cy[:, None] * gy
        return torch.stack([px, py], dim=-1)

    # ---------------- metrics ----------------

    def drain_metrics(self, state: EnvState) -> Tuple[EnvState, Dict[str, torch.Tensor]]:
        """Finished-episode metrics since the last drain, then reset the
        accumulators. Names follow the reference's logs."""
        cnt = torch.clamp(state.acc_count, min=1.0)
        metrics = {}
        for i, t in enumerate(self.cset.terms):
            a, b = self.cset.slices[i]
            metrics[f"Episode_Constraint_violation/cstr_{t.name}"] = (
                state.acc_viol[i] / cnt)
            metrics[f"Episode_Constraint_probability/cstr_{t.name}"] = (
                state.acc_prob[i] / cnt)
            metrics[f"Curriculum/{t.name}_max_p"] = state.max_p[i]
            metrics[f"Constraint_running_max/cstr_{t.name}"] = torch.mean(
                state.running_max[a:b])
        metrics["Episode/reward"] = state.acc_rew / cnt
        metrics["Episode/length"] = state.acc_len / cnt
        metrics["Episode/count"] = state.acc_count
        metrics["Episode/terminated_contact_frac"] = state.acc_term[0] / cnt
        metrics["Episode/terminated_upside_down_frac"] = state.acc_term[1] / cnt
        metrics["Episode/timed_out_frac"] = state.acc_term[2] / cnt
        if self.cfg.terrain.kind == "hfield":
            # mean difficulty row now assigned (Curriculum/terrain_levels)
            metrics["Curriculum/terrain_levels"] = torch.mean(
                state.terrain_row.float())
        nt = self.cset.n_terms
        z = torch.zeros((), device=self.device)
        state = state._replace(
            acc_viol=torch.zeros(nt, device=self.device),
            acc_prob=torch.zeros(nt, device=self.device),
            acc_rew=z, acc_len=z.clone(), acc_count=z.clone(),
            acc_term=torch.zeros(3, device=self.device),
        )
        return state, metrics
