"""Solo12 flat-terrain CaT velocity task (port of cat_tpu/tasks/solo12_flat.py):
the 13 constraint terms of the reference recipe (cat_flat_env_cfg.py:259-355,
4 soft safety + 4 hard safety + 5 style) on the flat env; the play variant
runs 50 envs with the observation noise off (cat_flat_env_cfg.py:499-514)."""

from __future__ import annotations

import dataclasses
from typing import Sequence

from cat_tpu_torch.envs import constraints as C
from cat_tpu_torch.envs.cat import ConstraintTerm
from cat_tpu_torch.envs.env import CatEnv, EnvCfg, NoiseCfg, resolve_names
from cat_tpu_torch.models.solo12 import (
    SOLO12_ACTUATED_JOINT_ORDER, SOLO12_KD, SOLO12_KP, solo12_model,
)
from cat_tpu_torch.utils.overrides import apply_overrides

ALL_LEG_JOINTS = [".*_HAA", ".*_HFE", ".*_KFE"]


def solo12_constraint_terms(model) -> list[ConstraintTerm]:
    task_order = list(SOLO12_ACTUATED_JOINT_ORDER)

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
                       dict(limit=3.0, joint_ids=all_j), 0.25, True),
        ConstraintTerm("joint_velocity", C.joint_velocity,
                       dict(limit=16.0, joint_ids=all_j), 0.25, True),
        ConstraintTerm("joint_acceleration", C.joint_acceleration,
                       dict(limit=800.0, joint_ids=all_j), 0.25, True),
        ConstraintTerm("action_rate", C.action_rate,
                       dict(limit=80.0, joint_ids=all_j), 0.25, True),
        # safety, hard
        ConstraintTerm("contact", C.contact,
                       dict(body_ids=rids(["base_link", ".*_UPPER_LEG"])),
                       1.0, False),
        ConstraintTerm("foot_contact_force", C.foot_contact_force,
                       dict(limit=50.0, body_ids=rids([".*_FOOT"])), 1.0, False),
        ConstraintTerm("front_hfe_position", C.joint_position,
                       dict(limit=1.3, joint_ids=jids(["FL_HFE", "FR_HFE"])),
                       1.0, False),
        ConstraintTerm("upsidedown", C.upsidedown, dict(limit=0.0), 1.0, False),
        # style
        ConstraintTerm("hip_position", C.joint_position_when_moving_forward,
                       dict(limit=0.2, velocity_deadzone=0.1,
                            joint_ids=jids([".*_HAA"])), 0.25, True),
        ConstraintTerm("base_orientation", C.base_orientation,
                       dict(limit=0.1), 0.25, True),
        ConstraintTerm("air_time", C.air_time,
                       dict(limit=0.25, velocity_deadzone=0.1,
                            body_ids=fids([".*_FOOT"])), 0.25, True),
        ConstraintTerm("no_move", C.no_move,
                       dict(velocity_deadzone=0.1, joint_vel_limit=4.0,
                            joint_ids=all_j), 0.1, False),
        ConstraintTerm("two_foot_contact", C.n_foot_contact,
                       dict(number_of_desired_feet=2, min_command_value=0.5,
                            body_ids=fids([".*_FOOT"])), 0.25, True),
    ]


PLAY_ENVS = 50


def make_env(num_envs: int = 4096, play: bool = False,
             overrides: Sequence[str] = (), cfg: EnvCfg = None,
             device="cuda") -> CatEnv:
    """The Solo12 flat CaT env. ``overrides`` are dotted-path EnvCfg
    overrides (``utils/overrides.py``); ``cfg`` replaces the default EnvCfg
    (its num_envs is overridden, except in play, which runs 50 envs)."""
    model = solo12_model()
    if cfg is None:
        cfg = EnvCfg(kp=SOLO12_KP, kd=SOLO12_KD)
        if play:
            cfg = dataclasses.replace(cfg, noise=NoiseCfg(enabled=False))
    cfg = dataclasses.replace(cfg, num_envs=PLAY_ENVS if play else num_envs)
    return CatEnv(
        model=model, cfg=apply_overrides(cfg, overrides),
        constraint_terms=solo12_constraint_terms(model),
        actuated_joint_order=SOLO12_ACTUATED_JOINT_ORDER,
        illegal_contact_bodies=("base_link", ".*_UPPER_LEG"),
        device=device,
    )
