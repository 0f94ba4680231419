"""Policy export for deployment (port of cat_tpu/rl/export.py; the
reference's clean_rl/play.py:118-138).

Artifacts, all of one deterministic policy (obs -> normalised -> the
actor's mean action, the observation normaliser folded in):
  * ``policy_params.npz``: the bundle in the JAX package's layout (obs_mean,
    obs_var, log_std, actor_w{i} as (in, out), actor_b{i}); a bundle from
    either package loads in the other;
  * ``policy.pt``: a TorchScript trace;
  * ``policy.pt2``: a ``torch.export`` program, batch size dynamic;
  * ``policy.onnx``: when the ``onnx`` package imports, else skipped with
    the reason printed.
The artifacts are written from CPU tensors, so they load on any device.
"""

from __future__ import annotations

import importlib.util
import os
import warnings
from typing import Dict

import numpy as np
import torch
from torch import nn


def actor_bundle(net: nn.Module, obs_mean: torch.Tensor,
                 obs_var: torch.Tensor) -> Dict[str, np.ndarray]:
    """The bundle of ``net``'s actor path (``net.actor_layers()``: the
    separate actor's layers, or the shared trunk and the policy head)."""
    def host(t):
        return t.detach().to("cpu", torch.float32).numpy().copy()

    bundle = {"obs_mean": host(obs_mean), "obs_var": host(obs_var),
              "log_std": host(net.log_std)}
    for i, layer in enumerate(net.actor_layers()):
        bundle[f"actor_w{i}"] = host(layer.weight).T.copy()
        bundle[f"actor_b{i}"] = host(layer.bias)
    return bundle


class Policy(nn.Module):
    """obs -> (obs - mean) / sqrt(var + 1e-8) -> ELU MLP -> mean action."""

    def __init__(self, bundle: Dict[str, np.ndarray]):
        super().__init__()
        self.register_buffer("obs_mean", torch.tensor(bundle["obs_mean"]))
        self.register_buffer("obs_var", torch.tensor(bundle["obs_var"]))
        self.layers = nn.ModuleList()
        i = 0
        while f"actor_w{i}" in bundle:
            w = bundle[f"actor_w{i}"]
            lin = nn.Linear(w.shape[0], w.shape[1])
            with torch.no_grad():
                lin.weight.copy_(torch.tensor(w.T))
                lin.bias.copy_(torch.tensor(bundle[f"actor_b{i}"]))
            self.layers.append(lin)
            i += 1

    def forward(self, obs):
        x = (obs - self.obs_mean) / torch.sqrt(self.obs_var + 1e-8)
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = nn.functional.elu(x)
        return x


def export_policy(net: nn.Module, obs_mean: torch.Tensor,
                  obs_var: torch.Tensor, out_dir: str) -> Dict[str, np.ndarray]:
    """Write every artifact to ``out_dir``; returns the bundle."""
    os.makedirs(out_dir, exist_ok=True)
    bundle = actor_bundle(net, obs_mean, obs_var)
    path = os.path.join(out_dir, "policy_params.npz")
    np.savez(path, **bundle)
    print(f"wrote {path}")

    model = Policy(bundle).eval()
    n_obs = bundle["obs_mean"].shape[0]
    # a batch of 2: a batch dimension of 1 would be specialised to a constant
    program = torch.export.export(
        model, (torch.zeros(2, n_obs),),
        dynamic_shapes=({0: torch.export.Dim.AUTO},))
    path = os.path.join(out_dir, "policy.pt2")
    torch.export.save(program, path)
    print(f"wrote {path}")

    path = os.path.join(out_dir, "policy.pt")
    with warnings.catch_warnings():   # TorchScript is deprecated upstream
        warnings.simplefilter("ignore")
        torch.jit.trace(model, torch.zeros(1, n_obs)).save(path)
    print(f"wrote {path}")

    if importlib.util.find_spec("onnx") is None:
        print("ONNX export skipped: the onnx package is not installed")
    else:
        path = os.path.join(out_dir, "policy.onnx")
        try:
            torch.onnx.export(model, (torch.zeros(1, n_obs),), path,
                              input_names=["obs"], output_names=["action"],
                              opset_version=18, dynamo=True)
            print(f"wrote {path}")
        except Exception as e:  # the exporter's own toolchain may be absent
            print(f"ONNX export skipped: {e}")
    return bundle
