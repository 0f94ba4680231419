"""Go2 flat-terrain CaT velocity task (port of cat_tpu/tasks/go2_flat.py):
the Solo12 flat recipe re-targeted to a 15 kg Go2-class quadruped. The same
13 constraint terms with limits scaled to the platform (23.7 Nm joints,
30 rad/s, heavier feet), kp 25, kd 0.5, action scale 0.25, wider commands,
and a fall detector at |g_xy| > 0.35 (~20 degrees) in place of the flat
recipe's 0.1 tilt kill; base and thigh contact terminate."""

from __future__ import annotations

import dataclasses
from typing import Sequence

from cat_tpu_torch.envs import constraints as C
from cat_tpu_torch.envs.cat import ConstraintTerm
from cat_tpu_torch.envs.env import (
    CatEnv, CommandsCfg, EnvCfg, NoiseCfg, TerminationsCfg, resolve_names,
)
from cat_tpu_torch.models.go2 import (
    GO2_ACTUATED_JOINT_ORDER, GO2_KD, GO2_KP, go2_model,
)
from cat_tpu_torch.utils.overrides import apply_overrides

ALL_LEG_JOINTS = [".*_hip_joint", ".*_thigh_joint", ".*_calf_joint"]
PLAY_ENVS = 50
ILLEGAL_CONTACT_BODIES = ("base", ".*_thigh")


def go2_constraint_terms(model) -> list[ConstraintTerm]:
    task_order = list(GO2_ACTUATED_JOINT_ORDER)

    def jids(patterns):
        return resolve_names(patterns, task_order)

    def rids(patterns):
        return resolve_names(patterns, model.report_names)

    def fids(patterns):
        foot_names = [model.report_names[i] for i in model.foot_report_ids]
        return resolve_names(patterns, foot_names)

    all_j = jids(ALL_LEG_JOINTS)
    return [
        # safety, soft (curriculum-annealed)
        ConstraintTerm("joint_torque", C.joint_torque,
                       dict(limit=18.0, joint_ids=all_j), 0.25, True),
        ConstraintTerm("joint_velocity", C.joint_velocity,
                       dict(limit=24.0, joint_ids=all_j), 0.25, True),
        ConstraintTerm("joint_acceleration", C.joint_acceleration,
                       dict(limit=800.0, joint_ids=all_j), 0.25, True),
        ConstraintTerm("action_rate", C.action_rate,
                       dict(limit=80.0, joint_ids=all_j), 0.25, True),
        # safety, hard
        ConstraintTerm("contact", C.contact,
                       dict(body_ids=rids(["base", ".*_thigh"])), 1.0, False),
        ConstraintTerm("foot_contact_force", C.foot_contact_force,
                       dict(limit=250.0, body_ids=rids([".*_foot"])),
                       1.0, False),
        ConstraintTerm("front_thigh_position", C.joint_position,
                       dict(limit=2.0, joint_ids=jids(["FL_thigh_joint",
                                                       "FR_thigh_joint"])),
                       1.0, False),
        ConstraintTerm("upsidedown", C.upsidedown, dict(limit=0.0), 1.0, False),
        # style
        ConstraintTerm("hip_position", C.joint_position_when_moving_forward,
                       dict(limit=0.3, velocity_deadzone=0.1,
                            joint_ids=jids([".*_hip_joint"])), 0.25, True),
        ConstraintTerm("base_orientation", C.base_orientation,
                       dict(limit=0.1), 0.25, True),
        ConstraintTerm("air_time", C.air_time,
                       dict(limit=0.25, velocity_deadzone=0.1,
                            body_ids=fids([".*_foot"])), 0.25, True),
        ConstraintTerm("no_move", C.no_move,
                       dict(velocity_deadzone=0.1, joint_vel_limit=4.0,
                            joint_ids=all_j), 0.1, False),
        ConstraintTerm("two_foot_contact", C.n_foot_contact,
                       dict(number_of_desired_feet=2, min_command_value=0.5,
                            body_ids=fids([".*_foot"])), 0.25, True),
    ]


def make_env(num_envs: int = 4096, play: bool = False,
             overrides: Sequence[str] = (), device="cuda") -> CatEnv:
    """The Go2 flat CaT env (train, or the play variant: 50 envs, no
    noise). ``overrides`` are dotted-path EnvCfg overrides
    (``utils/overrides.py``), e.g. "events.push_enabled=False"."""
    model = go2_model()
    cfg = EnvCfg(
        num_envs=PLAY_ENVS if play else num_envs,
        kp=GO2_KP, kd=GO2_KD, action_scale=0.25,
        commands=CommandsCfg(lin_vel_x=(-1.0, 1.0), lin_vel_y=(-0.7, 0.7),
                             ang_vel_z=(-1.0, 1.0)),
        terminations=TerminationsCfg(upside_down_limit=0.35),
    )
    if play:
        cfg = dataclasses.replace(cfg, noise=NoiseCfg(enabled=False))
    return CatEnv(
        model=model, cfg=apply_overrides(cfg, overrides),
        constraint_terms=go2_constraint_terms(model),
        actuated_joint_order=GO2_ACTUATED_JOINT_ORDER,
        illegal_contact_bodies=ILLEGAL_CONTACT_BODIES,
        device=device,
    )
