"""Constraint terms (port of cat_tpu/envs/constraints.py): batched functions
of StepData, positive = violating; each returns (N,) or (N, K)."""

from __future__ import annotations

import torch

from .types import StepData


def _hist_force_norm(data: StepData, body_ids) -> torch.Tensor:
    """Max-over-history contact force norms of report bodies: (N, K)."""
    f = data.force_hist[:, :, body_ids, :]
    return torch.amax(torch.linalg.vector_norm(f, dim=-1), dim=1)


def _cmd_norm(data: StepData) -> torch.Tensor:
    return torch.linalg.vector_norm(data.command, dim=-1)


def joint_position(data: StepData, *, limit, joint_ids):
    return torch.abs(data.joint_pos[:, joint_ids]) - limit


def joint_position_when_moving_forward(data: StepData, *, limit,
                                       velocity_deadzone, joint_ids):
    """|q - q_default| - limit, gated on |cmd_y| < deadzone."""
    cstr = torch.abs(data.joint_pos[:, joint_ids]
                     - data.default_joint_pos[joint_ids]) - limit
    gate = (torch.abs(data.command[:, 1]) < velocity_deadzone).to(cstr.dtype)
    return cstr * gate[:, None]


def joint_torque(data: StepData, *, limit, joint_ids):
    return torch.abs(data.applied_torque[:, joint_ids]) - limit


def joint_velocity(data: StepData, *, limit, joint_ids):
    return torch.abs(data.joint_vel[:, joint_ids]) - limit


def joint_acceleration(data: StepData, *, limit, joint_ids):
    return torch.abs(data.joint_acc[:, joint_ids]) - limit


def upsidedown(data: StepData, *, limit):
    return (data.projected_gravity[:, 2] > limit).float()


def contact(data: StepData, *, body_ids):
    return torch.any(_hist_force_norm(data, body_ids) > 1.0, dim=1).float()


def base_orientation(data: StepData, *, limit):
    return torch.linalg.vector_norm(data.projected_gravity[:, :2], dim=1) - limit


def air_time(data: StepData, *, limit, velocity_deadzone, body_ids):
    """(limit - last_air_time) * touchdown, gated on |cmd| > deadzone."""
    touchdown = data.touchdown[:, body_ids].float()
    gate = (_cmd_norm(data) > velocity_deadzone).float()
    return (limit - data.last_air_time[:, body_ids]) * touchdown * gate[:, None]


def n_foot_contact(data: StepData, *, number_of_desired_feet,
                   min_command_value, body_ids):
    in_contact = _hist_force_norm(data, body_ids) > 1.0
    cstr = torch.abs(in_contact.sum(dim=1).float() - number_of_desired_feet)
    return cstr * (_cmd_norm(data) > min_command_value).float()


def joint_range(data: StepData, *, limit, joint_ids):
    """|q - q_default| - limit."""
    return torch.abs(data.joint_pos[:, joint_ids]
                     - data.default_joint_pos[joint_ids]) - limit


def action_rate(data: StepData, *, limit, joint_ids):
    return (torch.abs(data.action[:, joint_ids] - data.prev_action[:, joint_ids])
            / data.step_dt - limit)


def foot_contact_force(data: StepData, *, limit, body_ids):
    return _hist_force_norm(data, body_ids) - limit


def min_base_height(data: StepData, *, limit):
    """limit - base height."""
    return limit - data.base_pos[:, 2]


def no_move(data: StepData, *, velocity_deadzone, joint_vel_limit, joint_ids):
    gate = (_cmd_norm(data) < velocity_deadzone).float()
    return ((torch.abs(data.joint_vel[:, joint_ids]) - joint_vel_limit)
            * gate[:, None])
