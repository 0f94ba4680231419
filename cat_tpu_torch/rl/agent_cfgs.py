"""Per-backend agent-config presets (port of cat_tpu/rl/agent_cfgs.py).

The reference ships the Solo12 recipe through three RL stacks; all three
map onto the one PPO through PpoCfg's backend knobs:

  * clean_rl: clean_rl_ppo_cfg.py:10-34, the PpoCfg defaults;
  * rl_games: rl_games_cat_solo.yaml:39-76, adaptive-KL learning rate
    (kl 0.008) stepped every minibatch, timeout bootstrap, separate
    actor and critic;
  * skrl: skrl_ppo_cfg.yaml, shared trunk, KLAdaptiveLR (kl 0.01) stepped
    once an epoch, lr 1e-3, entropy 5e-3, value coefficient 1.0, 4
    minibatches of num_envs x 24 / 4.
"""

from __future__ import annotations

from .ppo import PpoCfg


def clean_rl() -> PpoCfg:
    return PpoCfg()


def rl_games() -> PpoCfg:
    return PpoCfg(lr_mode="adaptive_kl", kl_target=0.008,
                  value_bootstrap=True, shared_model=False)


def skrl(num_envs: int = 4096) -> PpoCfg:
    return PpoCfg(learning_rate=1.0e-3, lr_mode="adaptive_kl_epoch",
                  kl_target=0.01, minibatch_size=num_envs * 24 // 4,
                  ent_coef=0.005, vf_coef=1.0, shared_model=True,
                  value_bootstrap=False)


_BACKENDS = {"clean_rl": clean_rl, "rl_games": rl_games, "skrl": skrl}


def get(backend: str, **kwargs) -> PpoCfg:
    if backend not in _BACKENDS:
        raise KeyError(f"unknown RL backend {backend!r}; available: "
                       f"{sorted(_BACKENDS)}")
    return _BACKENDS[backend](**kwargs)
