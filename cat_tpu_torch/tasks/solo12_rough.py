"""Solo12 rough-terrain CaT task (port of cat_tpu/tasks/solo12_rough.py):
the flat constraint table on a generated heightfield of difficulty rows x
terrain types, with the 187-point height scan appended to the observation
and the promote / demote terrain curriculum."""

from __future__ import annotations

import dataclasses
from typing import Sequence

from cat_tpu_torch.envs.env import (
    CatEnv, EnvCfg, HeightScanCfg, NoiseCfg, TerminationsCfg,
)
from cat_tpu_torch.models.solo12 import (
    SOLO12_ACTUATED_JOINT_ORDER, SOLO12_KD, SOLO12_KP, solo12_model,
)
from cat_tpu_torch.sim import terrain as terrain_mod
from cat_tpu_torch.tasks.solo12_flat import PLAY_ENVS, solo12_constraint_terms
from cat_tpu_torch.utils.overrides import apply_overrides


def rough_constraint_terms(model):
    """The flat table with two rough-terrain changes: base_orientation's
    limit widens from 0.1 to 0.3 (the base pitches with the slope), and
    every curriculum-annealed term keeps its initial max_p 0.05 with the
    anneal off (the soft budget frozen, as the JAX task ships it)."""
    terms = []
    for t in solo12_constraint_terms(model):
        if t.name == "base_orientation":
            t = t._replace(params=dict(t.params, limit=0.3))
        if t.curriculum:
            t = t._replace(max_p=0.05, curriculum=False)
        terms.append(t)
    return terms


def rough_cfg(num_envs: int = 4096, play: bool = False, rows: int = 10,
              cols: int = 8, seed: int = 0) -> EnvCfg:
    """The rough task's EnvCfg: the production terrain is 10 x 8 patches of
    8 m at 0.1 m (an 800 x 640 grid); the upside-down kill is a fall
    detector at |g_xy| > 0.7; the play variant runs 50 envs, no noise."""
    cfg = EnvCfg(
        num_envs=PLAY_ENVS if play else num_envs,
        kp=SOLO12_KP, kd=SOLO12_KD,
        terrain=terrain_mod.generate_rough(rows=rows, cols=cols, seed=seed),
        height_scan=HeightScanCfg(),
        terrain_curriculum=True,
        terminations=TerminationsCfg(upside_down_limit=0.7),
    )
    if play:
        cfg = dataclasses.replace(cfg, noise=NoiseCfg(enabled=False))
    return cfg


def make_env(num_envs: int = 4096, play: bool = False, rows: int = 10,
             cols: int = 8, seed: int = 0, overrides: Sequence[str] = (),
             cfg: EnvCfg = None, device="cuda") -> CatEnv:
    """The Solo12 rough CaT env. ``overrides`` are dotted-path EnvCfg
    overrides (``utils/overrides.py``); ``cfg`` replaces ``rough_cfg(...)``
    (its num_envs is overridden, except in play, which runs 50 envs)."""
    model = solo12_model()
    if cfg is None:
        cfg = rough_cfg(num_envs, play, rows, cols, seed)
    else:
        cfg = dataclasses.replace(cfg, num_envs=PLAY_ENVS if play else num_envs)
    return CatEnv(
        model=model, cfg=apply_overrides(cfg, overrides),
        constraint_terms=rough_constraint_terms(model),
        actuated_joint_order=SOLO12_ACTUATED_JOINT_ORDER,
        illegal_contact_bodies=("base_link", ".*_UPPER_LEG"),
        device=device,
    )
