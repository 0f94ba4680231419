"""PyTorch/CUDA port of cat_tpu: the CaT quadruped trainer on one NVIDIA GPU.

Same physics, env and PPO as ``cat_tpu`` (the JAX package, kept as the
reference), written with envs on the LEADING axis. The contact solve runs
in a hand-written CUDA kernel (``ops/csrc/pgs_bj.cu``) on the card and in
its plain PyTorch version on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Physics stays in full f32: TF32 matmuls would corrupt the
    small, ill-conditioned mass matrices (cat_tpu/sim/dynamics.py:36-48),
    so both TF32 switches are turned off here."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    return dev
