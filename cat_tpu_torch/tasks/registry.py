"""Task registry: task id -> env factory + agent config (port of
cat_tpu/tasks/registry.py, the same six tasks)."""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple


class TaskSpec(NamedTuple):
    make_env: Callable        # (num_envs, play=, overrides=, device=) -> CatEnv
    make_agent_cfg: Callable  # () -> PpoCfg
    description: str


_REGISTRY: Dict[str, TaskSpec] = {}


def register(name: str, spec: TaskSpec):
    _REGISTRY[name] = spec


def get(name: str) -> TaskSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown task {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_tasks() -> Dict[str, TaskSpec]:
    return dict(_REGISTRY)


def _ppo_cfg():
    from cat_tpu_torch.rl.ppo import PpoCfg

    return PpoCfg()


def _factory(module: str, play: bool):
    """make_env of ``cat_tpu_torch.tasks.<module>``, imported at the first
    call; the play variants default to 50 envs."""
    def make_env(num_envs=50 if play else 4096, **kw):
        import importlib

        task = importlib.import_module(f"cat_tpu_torch.tasks.{module}")
        return task.make_env(num_envs, play=play, **kw)
    return make_env


for _name, _module, _play, _desc in (
    ("Solo12-CaT-Flat-v0", "solo12_flat", False,
     "Solo12 flat-terrain CaT velocity tracking (train)"),
    ("Solo12-CaT-Rough-v0", "solo12_rough", False,
     "Solo12 rough-terrain CaT (heightfield + height scan + terrain "
     "curriculum)"),
    ("Solo12-CaT-Rough-Play-v0", "solo12_rough", True,
     "Solo12 rough-terrain CaT (50 envs, no noise)"),
    ("Solo12-CaT-Flat-Play-v0", "solo12_flat", True,
     "Solo12 flat-terrain CaT (50 envs, no noise)"),
    ("Go2-CaT-Flat-v0", "go2_flat", False,
     "Go2-class quadruped flat-terrain CaT (train)"),
    ("Go2-CaT-Flat-Play-v0", "go2_flat", True,
     "Go2-class quadruped flat-terrain CaT (50 envs, no noise)"),
):
    register(_name, TaskSpec(_factory(_module, _play), _ppo_cfg, _desc))
