"""CatEnv: the batched constrained locomotion environment, flat terrain
(port of cat_tpu/envs/env.py:238-804).

One ``step(state, action, generator)`` does, in the reference's order:
  1. action processing (raw action, previous action)
  2. ``decimation`` physics substeps toward default + scale * action
  3. episode / common counters
  4. terminations: time_out | illegal contact | upside down
  5. CaT constraints -> cstr_prob; reward = clip(r (1 - p), min 0);
     dones = cstr_prob, forced to 1 where an env resets
  6. masked auto-reset (reset events, finished-episode accumulators)
  7. command schedule, deadzone, stochastic resample, yaw-rate flip
  8. interval push event
  9. the 45-dim observation, optionally noise-corrupted

Every random draw comes from the ``torch.Generator`` the caller passes, as
full (N, ...) tensors; resets are masked selects, so the step never waits
on the device.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from cat_tpu_torch.sim import engine as engine_mod
from cat_tpu_torch.sim import terrain as terrain_mod
from cat_tpu_torch.sim.engine import EngineParams, SimState
from cat_tpu_torch.sim.maths import quat_from_euler_zyx, quat_rotate_inv, quat_yaw
from cat_tpu_torch.sim.model import RobotModel
from cat_tpu_torch.sim.terrain import Terrain

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


@dataclasses.dataclass(frozen=True)
class EventsCfg:
    friction_range: Tuple[float, float] = (0.5, 1.25)   # startup, per env
    friction_num_buckets: int = 100      # PhysX material buckets
    reset_pose_xy: float = 0.05
    reset_yaw: float = 1.57
    reset_joint_scale: Tuple[float, float] = (0.95, 1.05)
    push_vel_xy: float = 0.5
    push_enabled: bool = True


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
    # "bj:<n_blocks>[:<omega>[:<iterations>]]": the block-Jacobi sweep the
    # CUDA kernel runs
    solver_structure: str = "bj:4:0.9:6"
    terrain: Terrain = terrain_mod.plane()

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
    """The EngineParams an EnvCfg asks for (solver structure string parsed
    as in cat_tpu/envs/env.py:275-286)."""
    params = EngineParams(dt=cfg.sim_dt, decimation=cfg.decimation,
                          kp=cfg.kp, kd=cfg.kd)
    parts = cfg.solver_structure.split(":")
    sp = params.solver._replace(structure=parts[0])
    if len(parts) > 1:
        sp = sp._replace(bj_blocks=int(parts[1]))
    if len(parts) > 2:
        sp = sp._replace(omega=float(parts[2]))
    if len(parts) > 3:
        sp = sp._replace(iterations=int(parts[3]))
    return params._replace(solver=sp)


class CatEnv:
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
            model, engine_params(cfg), cfg.terrain, dev)
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
        self._cmd_scale = torch.tensor([2.0, 2.0, 0.25], device=dev)
        self.cset = ConstraintSet(constraint_terms, self._probe_data(2), dev)
        self.num_obs = 9 + 3 * self.num_actions  # 45 for Solo12

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
        g_dir = torch.zeros_like(quat[:, :3])
        g_dir[:, 2] = -1.0
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

        def z(*shape):
            return torch.zeros(shape, device=dev)

        return EnvState(
            sim=self._reset_sim(gen, n),
            action=z(n, nj), prev_action=z(n, nj),
            episode_len=torch.zeros(n, dtype=torch.int32, device=dev),
            command=self._sample_commands(gen, n),
            command_time_left=torch.full(
                (n,), self.cfg.commands.resampling_time, device=dev),
            mu=mu,
            running_max=self.cset.init_running_max(),
            max_p=self.cset.init_max_p(),
            episode_viol=z(n, nt), episode_prob=z(n, nt), episode_rew=z(n),
            common_step=0,
            acc_viol=z(nt), acc_prob=z(nt), acc_rew=z(), acc_len=z(),
            acc_count=z(), acc_term=z(3),
        )

    def _sample_commands(self, gen, n: int) -> torch.Tensor:
        """Uniform command sample; a rel_standing_envs share stands still."""
        u = self._rand(gen, n, 4)
        cmd = self._cmd_lo + (self._cmd_hi - self._cmd_lo) * u[:, :3]
        standing = u[:, 3] < self.cfg.commands.rel_standing_envs
        return torch.where(standing[:, None], 0.0, cmd)

    def _reset_sim(self, gen, n: int) -> SimState:
        """Fresh randomized states for ALL envs (masked-selected later):
        pose xy +-reset_pose_xy, yaw +-reset_yaw, joints = default * U(scale),
        zero velocity, on the terrain."""
        ev = self.cfg.events
        u = self._rand(gen, n, 3 + self.model.nj)
        xy = (2.0 * u[:, 0:2] - 1.0) * ev.reset_pose_xy
        yaw = (2.0 * u[:, 2] - 1.0) * ev.reset_yaw
        zero = torch.zeros_like(yaw)
        quat = quat_from_euler_zyx(zero, zero, yaw)
        lo, hi = ev.reset_joint_scale
        qj = self._qj_default * (lo + (hi - lo) * u[:, 3:])
        qj = torch.clamp(qj, self._qj_lo, self._qj_hi)
        z = (float(self.model.default_base_pos[2])
             + terrain_mod.height_at(self.cfg.terrain, xy))[:, None]
        base = engine_mod.make_batched_init(self.model, n, self.device)
        return base._replace(qpos=torch.cat([xy, z, quat, qj], dim=1))

    def observe(self, state: EnvState, gen: torch.Generator) -> torch.Tensor:
        """Observation of the current state (the reset observation)."""
        data = self.step_data(state.sim, state.command, state.action,
                              state.prev_action)
        return self._observations(data, gen)

    # ---------------- the step ----------------

    def step(self, state: EnvState, raw_action: torch.Tensor,
             gen: torch.Generator):
        """Returns (state', obs, reward, dones (float), time_outs (bool))."""
        cfg = self.cfg
        n = raw_action.shape[0]

        # 1-2. actions -> PD targets (task order -> model order), physics
        prev_action, action = state.action, raw_action
        target = (self.default_joint_pos_task
                  + cfg.action_scale * action)[:, self.m2t]
        sim = self.engine(state.sim, target, state.mu)

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
        terminated = illegal | upside
        reset = terminated | time_out

        # 5. CaT constraints + reward
        max_p = self.cset.curriculum_max_p(common_step, cfg.curriculum_steps)
        cstr_prob, running_max, term_probs, viol = self.cset.compute(
            data, state.running_max, max_p)
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

        fresh = self._reset_sim(gen, n)
        sim = SimState(*[
            torch.where(reset.reshape((n,) + (1,) * (old.dim() - 1)), new, old)
            for new, old in zip(fresh, sim)
        ])
        episode_len = torch.where(reset, 0, episode_len).to(torch.int32)
        episode_viol = torch.where(reset[:, None], 0.0, episode_viol)
        episode_prob = torch.where(reset[:, None], 0.0, episode_prob)
        episode_rew = torch.where(reset, 0.0, episode_rew)
        action = torch.where(reset[:, None], 0.0, action)
        prev_action = torch.where(reset[:, None], 0.0, prev_action)
        command = torch.where(reset[:, None], self._sample_commands(gen, n),
                              state.command)
        time_left = torch.where(reset, cfg.commands.resampling_time,
                                state.command_time_left)

        # 7. command schedule + deadzone logic
        command, time_left = self._update_commands(command, time_left, gen)

        # 8. interval push: overwrite the whole root velocity
        if cfg.events.push_enabled:
            p_push = cfg.sim_dt / (cfg.episode_length_s * 2.0)
            push = self._rand(gen, n) < p_push
            push_vel = self._uniform(gen, (n, 2), -cfg.events.push_vel_xy,
                                     cfg.events.push_vel_xy)
            new_qvel = sim.qvel.clone()
            new_qvel[:, 0:2] = push_vel
            new_qvel[:, 2:6] = 0.0
            sim = sim._replace(
                qvel=torch.where(push[:, None], new_qvel, sim.qvel))

        # 9. observations
        data = self.step_data(sim, command, action, prev_action)
        obs = self._observations(data, gen)

        new_state = EnvState(
            sim=sim, action=action, prev_action=prev_action,
            episode_len=episode_len, command=command,
            command_time_left=time_left, mu=state.mu,
            running_max=running_max, max_p=max_p,
            episode_viol=episode_viol, episode_prob=episode_prob,
            episode_rew=episode_rew, common_step=common_step,
            acc_viol=acc_viol, acc_prob=acc_prob, acc_rew=acc_rew,
            acc_len=acc_len, acc_count=acc_count, acc_term=acc_term,
        )
        return new_state, obs, reward, dones, time_out

    def _update_commands(self, command, time_left, gen):
        """Scheduled resample, deadzone zeroing, stochastic resample and
        yaw-rate flip; the stochastic rates use the PHYSICS dt."""
        c, cfg = self.cfg.commands, self.cfg
        n = command.shape[0]
        time_left = time_left - cfg.step_dt
        expired = time_left <= 0.0
        command = torch.where(expired[:, None], self._sample_commands(gen, n),
                              command)
        time_left = torch.where(expired, c.resampling_time, time_left)

        keep = torch.any(torch.abs(command) > c.velocity_deadzone, dim=1)
        command = command * keep[:, None].float()

        no_cmd = (torch.linalg.vector_norm(command, dim=1)
                  < c.velocity_deadzone).float()
        p_res = 0.01 * no_cmd + (cfg.sim_dt / cfg.episode_length_s) * (1 - no_cmd)
        resample = self._rand(gen, n) < p_res
        command = torch.where(resample[:, None], self._sample_commands(gen, n),
                              command)
        time_left = torch.where(resample, c.resampling_time, time_left)

        flip = self._rand(gen, n) < cfg.sim_dt / cfg.episode_length_s
        command = torch.cat([command[:, :2],
                             command[:, 2:] * (1.0 - 2.0 * flip.float())[:, None]],
                            dim=1)
        return command, time_left

    def _observations(self, data: StepData, gen) -> torch.Tensor:
        nz = self.cfg.noise

        def noise(x, mag):
            if not nz.enabled or mag == 0.0:
                return x
            return x + self._uniform(gen, x.shape, -mag, mag)

        return torch.cat([
            noise(data.base_ang_vel_b, nz.ang_vel) * 0.25,
            data.command * self._cmd_scale,
            noise(data.projected_gravity, nz.gravity) * 0.1,
            noise(data.joint_pos, nz.joint_pos),
            noise(data.joint_vel, nz.joint_vel) * 0.05,
            data.action,
        ], dim=1)

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
        nt = self.cset.n_terms
        z = torch.zeros((), device=self.device)
        state = state._replace(
            acc_viol=torch.zeros(nt, device=self.device),
            acc_prob=torch.zeros(nt, device=self.device),
            acc_rew=z, acc_len=z.clone(), acc_count=z.clone(),
            acc_term=torch.zeros(3, device=self.device),
        )
        return state, metrics
