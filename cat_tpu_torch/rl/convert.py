"""Carry JAX-trained weights into the port's networks.

A flax ``Dense`` kernel is (in, out); a torch ``Linear`` weight is
(out, in), so kernels are transposed; biases and log_std carry over as
they are. Both network layouts carry: the separate actor and critic
(``Dense_i`` under ``actor`` / ``critic``) and the shared trunk
(``trunk_i``, ``policy_head``, ``value_head``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(np.asarray(x, np.float32)))


def _dense(sd: dict, prefix: str, d: Mapping):
    sd[f"{prefix}.weight"] = _t(np.asarray(d["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(d["bias"])


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax ActorCritic or SharedActorCritic params (numpy leaves, with or
    without the outer ``params`` key) -> the port's state_dict."""
    p = tree.get("params", tree)
    sd = {"log_std": _t(p["log_std"])}
    if "actor" in p:
        for net in ("actor", "critic"):
            i = 0
            while f"Dense_{i}" in p[net]:
                _dense(sd, f"{net}.layers.{i}", p[net][f"Dense_{i}"])
                i += 1
        return sd
    i = 0
    while f"trunk_{i}" in p:
        _dense(sd, f"trunk.{i}", p[f"trunk_{i}"])
        i += 1
    _dense(sd, "policy_head", p["policy_head"])
    _dense(sd, "value_head", p["value_head"])
    return sd


def actor_from_bundle(bundle: Mapping, shared: bool = False
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                                 torch.Tensor]:
    """An exported policy bundle (``policy_params.npz``: actor_w0..,
    actor_b0.., log_std, obs_mean, obs_var) -> (the actor's part of a
    state_dict with ``log_std``, obs_mean, obs_var). Every layer from the
    observation to the action mean is an ``actor_w{i}``: for ``shared`` the
    trunk's layers and the policy head, else the separate actor's layers."""
    n = sum(1 for k in bundle if k.startswith("actor_w"))
    names = ([f"trunk.{i}" for i in range(n - 1)] + ["policy_head"] if shared
             else [f"actor.layers.{i}" for i in range(n)])
    sd = {"log_std": _t(bundle["log_std"])}
    for i, name in enumerate(names):
        sd[f"{name}.weight"] = _t(np.asarray(bundle[f"actor_w{i}"]).T)
        sd[f"{name}.bias"] = _t(bundle[f"actor_b{i}"])
    return sd, _t(bundle["obs_mean"]), _t(bundle["obs_var"])
