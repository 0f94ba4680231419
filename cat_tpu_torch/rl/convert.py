"""Carry JAX-trained weights into the port's networks.

A flax ``Dense`` kernel is (in, out); a torch ``Linear`` weight is
(out, in), so kernels are transposed; biases and log_std carry over as
they are.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def _dense_layers(tree: Mapping) -> int:
    return sum(1 for k in tree if k.startswith("Dense_"))


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax ActorCritic params (numpy leaves, with or without the outer
    ``params`` key) -> ActorCritic state_dict."""
    p = tree.get("params", tree)
    sd = {"log_std": torch.tensor(np.asarray(p["log_std"], np.float32))}
    for net in ("actor", "critic"):
        for i in range(_dense_layers(p[net])):
            d = p[net][f"Dense_{i}"]
            sd[f"{net}.layers.{i}.weight"] = torch.tensor(
                np.ascontiguousarray(np.asarray(d["kernel"], np.float32).T))
            sd[f"{net}.layers.{i}.bias"] = torch.tensor(
                np.asarray(d["bias"], np.float32))
    return sd


def actor_from_bundle(bundle: Mapping) -> Tuple[Dict[str, torch.Tensor],
                                                torch.Tensor, torch.Tensor]:
    """An exported policy bundle (``policy_params.npz``: actor_w0..,
    actor_b0.., log_std, obs_mean, obs_var) -> (actor state_dict with
    ``log_std``, obs_mean, obs_var)."""
    sd = {"log_std": torch.tensor(np.asarray(bundle["log_std"], np.float32))}
    i = 0
    while f"actor_w{i}" in bundle:
        sd[f"actor.layers.{i}.weight"] = torch.tensor(np.ascontiguousarray(
            np.asarray(bundle[f"actor_w{i}"], np.float32).T))
        sd[f"actor.layers.{i}.bias"] = torch.tensor(
            np.asarray(bundle[f"actor_b{i}"], np.float32))
        i += 1
    return (sd, torch.tensor(np.asarray(bundle["obs_mean"], np.float32)),
            torch.tensor(np.asarray(bundle["obs_var"], np.float32)))
