"""PyTorch/CUDA port of cat_tpu: the CaT quadruped trainer on one NVIDIA GPU.

Same physics, env and PPO as ``cat_tpu`` (the JAX package, kept as the
reference), written with envs on the LEADING axis. On the card a physics
substep runs in hand-written CUDA kernels: ``ops/csrc/substep_dyn.cu``
(PD torque, kinematics, M, C, M^-1, the free velocity) and
``ops/csrc/contact_rows.cu`` (contacts and the solve's rows E, W, b), then
the contact solve, ``ops/csrc/pgs_bj.cu`` (the block-Jacobi sweep the envs
use) or ``ops/csrc/pgs_gs.cu`` (the serial Gauss-Seidel sweep of the raw
engine's default solver). On the CPU their plain PyTorch versions run.
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
