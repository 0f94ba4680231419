"""Env state types (port of cat_tpu/envs/types.py); env axis first."""

from __future__ import annotations

from typing import NamedTuple

import torch

from cat_tpu_torch.sim.engine import SimState


class StepData(NamedTuple):
    """Per-step view the observation / reward / constraint terms read."""
    joint_pos: torch.Tensor          # (N, 12) task-order joint positions
    joint_vel: torch.Tensor          # (N, 12)
    joint_acc: torch.Tensor          # (N, 12)
    applied_torque: torch.Tensor     # (N, 12)
    default_joint_pos: torch.Tensor  # (12,)
    base_pos: torch.Tensor           # (N, 3) world
    base_yaw: torch.Tensor           # (N,)
    base_lin_vel_b: torch.Tensor     # (N, 3) base frame
    base_ang_vel_b: torch.Tensor     # (N, 3) base frame
    projected_gravity: torch.Tensor  # (N, 3) unit gravity in base frame
    command: torch.Tensor            # (N, 3) [vx, vy, wz]
    action: torch.Tensor             # (N, 12) raw policy action
    prev_action: torch.Tensor        # (N, 12)
    force_hist: torch.Tensor         # (N, 3, nreport, 3)
    touchdown: torch.Tensor          # (N, nfeet) bool
    last_air_time: torch.Tensor      # (N, nfeet)
    step_dt: float                   # control dt (0.02 s)


class EnvState(NamedTuple):
    sim: SimState
    action: torch.Tensor             # (N, 12)
    prev_action: torch.Tensor        # (N, 12)
    episode_len: torch.Tensor        # (N,) int32
    command: torch.Tensor            # (N, 3)
    command_time_left: torch.Tensor  # (N,) seconds to the scheduled resample
    mu: torch.Tensor                 # (N,) friction
    running_max: torch.Tensor        # (Ktot,) CaT polyak maxes (global)
    max_p: torch.Tensor              # (n_terms,) curriculum-scaled caps
    episode_viol: torch.Tensor       # (N, n_terms)
    episode_prob: torch.Tensor       # (N, n_terms)
    episode_rew: torch.Tensor        # (N,)
    common_step: int                 # total control steps
    # finished-episode accumulators, drained once per train iteration
    acc_viol: torch.Tensor           # (n_terms,)
    acc_prob: torch.Tensor           # (n_terms,)
    acc_rew: torch.Tensor            # ()
    acc_len: torch.Tensor            # ()
    acc_count: torch.Tensor          # ()
    acc_term: torch.Tensor           # (3,) [illegal contact, upside down, timeout]
