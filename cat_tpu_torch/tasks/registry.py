"""Task registry: task id -> env factory + agent config (port of
cat_tpu/tasks/registry.py, with the tasks the port runs)."""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple


class TaskSpec(NamedTuple):
    make_env: Callable        # (num_envs, device=...) -> CatEnv
    make_agent_cfg: Callable  # () -> PpoCfg
    description: str


def _flat(num_envs=4096, **kw):
    from cat_tpu_torch.tasks import solo12_flat

    return solo12_flat.make_env(num_envs, **kw)


def _rough(num_envs=4096, **kw):
    from cat_tpu_torch.tasks import solo12_rough

    return solo12_rough.make_env(num_envs, **kw)


def _rough_play(num_envs=50, **kw):
    from cat_tpu_torch.tasks import solo12_rough

    return solo12_rough.make_env(num_envs, play=True, **kw)


def _ppo_cfg():
    from cat_tpu_torch.rl.ppo import PpoCfg

    return PpoCfg()


_REGISTRY: Dict[str, TaskSpec] = {
    "Solo12-CaT-Flat-v0": TaskSpec(
        _flat, _ppo_cfg, "Solo12 flat-terrain CaT velocity tracking (train)"),
    "Solo12-CaT-Rough-v0": TaskSpec(
        _rough, _ppo_cfg, "Solo12 rough-terrain CaT (heightfield + height "
        "scan + terrain curriculum)"),
    "Solo12-CaT-Rough-Play-v0": TaskSpec(
        _rough_play, _ppo_cfg, "Solo12 rough-terrain CaT (50 envs, no noise)"),
}


def get(name: str) -> TaskSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown task {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]
