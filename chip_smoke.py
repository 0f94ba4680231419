#!/usr/bin/env python3
"""Drive the PyTorch port (cat_tpu_torch) on one CUDA card and check it.

  python3 chip_smoke.py

Phases, each printed with its elapsed seconds:
  0. device: the card, its power limit, the torch and CUDA versions;
  1. build: the block-Jacobi PGS kernel from ops/csrc/pgs_bj.cu (plain nvcc);
  2. kernel against its plain PyTorch version at N = 4096, on contact
     problems captured from the port's own env and on seeded random
     problems, with the kernel's time, the plain version's time and the
     bound the card sets;
  3. the main path: ``cat_tpu_torch.train`` for Solo12-CaT-Flat-v0 at 4096
     envs, 2 PPO iterations; the kernel must launch 2 x 24 x 4 times;
  4. physics check: the policy the JAX package trained
     (runs/solo12_flat_2000it/policy_params.npz) walks 4096 envs for 200
     control steps; at least half must never hit a hard termination.
The last lines are a JSON line of kernel numbers, the card's name and power
limit, and the result line. Any failure exits non-zero before the result
line; a hang is cut by a faulthandler deadline.
"""

from __future__ import annotations

import faulthandler
import json
import math
import subprocess
import sys
import time
from pathlib import Path

DEADLINE_S = 900
T0 = time.perf_counter()

N_ENVS = 4096
PPO_ITERS = 2
PLAY_STEPS = 200
# the play command: forward at the top of the training range, where the
# JAX-trained policy walks from rest (at 0.5 m/s many envs stay standing,
# in the JAX package as in the port)
PLAY_VX = 1.0
# kernel vs plain version: |k - p| <= ATOL_REL * max|p| + RTOL * |p|, the
# JAX package's own kernel-vs-reference tolerance (test_pgs_pallas.py);
# the two sum in different orders (fused multiply-adds, the plain version's
# batched contractions), nothing else differs
RTOL, ATOL_REL = 2e-4, 2e-5
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s off the
# tensor cores
PEAK_BYTES_S, PEAK_F32_FLOP_S = 3.35e12, 67e12


def log(phase: str, msg: str):
    print(f"[{phase} +{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def random_problems(n, nc, nv, gen, device):
    """Seeded random contact problems: Delassus A = J M^-1 J^T with M SPD,
    mixed active and inactive contacts, a warm start."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    E = randn(n, 3 * nc, nv)
    L = randn(n, nv, nv)
    M = L @ L.transpose(1, 2) + nv * torch.eye(nv, device=device)
    W = torch.linalg.solve(M, E.transpose(1, 2)).contiguous()
    b = (E @ randn(n, nv, 1))[..., 0]
    phi = 0.02 * rand(n, nc) - 0.01
    bias = torch.clamp(40.0 * torch.clamp(phi + 0.002, max=0.0), min=-2.0)
    active = (phi < 0.0).float()
    mu = 0.5 + 0.75 * rand(n)
    lam0 = 0.05 * rand(n, 3 * nc)
    return E, W, b, bias, active, mu, lam0


def pgs_counts(model, anc, n, iterations):
    """Bytes and f32 operations one solve needs at these shapes: every
    operand read once and the result written once; the assembly over the
    nonzero dofs only (contact_row_dofs), warm start, sweeps (the column
    updates plus ~32 operations of projection per contact)."""
    from cat_tpu_torch.ops import pgs

    nc, nv = model.ncand, model.nv
    n3 = 3 * nc
    byts = 4 * n * (2 * n3 * nv + 2 * n3 + n3 + 2 * nc + 1) + 4 * (nc + 8)
    nnz = sum(len(r) for r in pgs.contact_row_dofs(model, anc))
    flops = n * (2 * n3 * nnz + 2 * n3 * n3
                 + iterations * (2 * n3 * n3 + 32 * nc))
    return byts, flops


def main() -> int:
    import torch

    phase = "device"
    if not torch.cuda.is_available():
        log(phase, "FAIL: torch.cuda.is_available() is false")
        return 2
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    try:
        import cat_tpu_torch
        from cat_tpu_torch.ops import pgs
    except ImportError as exc:
        log(phase, f"FAIL: the port is not beside this script ({exc})")
        return 2
    from cat_tpu_torch import train
    from cat_tpu_torch.envs.env import CommandsCfg, EnvCfg, EventsCfg, NoiseCfg
    from cat_tpu_torch.rl.convert import actor_from_bundle
    from cat_tpu_torch.rl.networks import ActorCritic
    from cat_tpu_torch.sim.maths import quat_rotate_inv
    from cat_tpu_torch.tasks import solo12_flat

    dev = cat_tpu_torch.resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30).stdout.strip()
    log(phase, f"{kind} | nvidia-smi: {smi} | torch {torch.__version__} "
               f"CUDA {torch.version.cuda} | {torch.cuda.device_count()} card(s)")

    phase = "build"
    built = pgs.KERNEL.load()
    log(phase, f"{built.path.name} in {built.seconds:.1f}s")
    for line in built.log.splitlines():
        if "ptxas" in line or "spill" in line:
            log(phase, line.strip())

    phase = "kernel"
    env = solo12_flat.make_env(N_ENVS, device=dev)
    model = env.model
    kw = env.engine.pgs_kwargs
    gen = torch.Generator(device=dev).manual_seed(0)
    es = env.init(gen, N_ENVS)
    for _ in range(5):
        es = env.step(es, 0.3 * torch.randn(N_ENVS, model.nj, generator=gen,
                                            device=dev), gen)[0]
    target = env.default_joint_pos_task[env.m2t].expand(N_ENVS, model.nj)
    _, physical = env.engine.contact_problem(es.sim, target, es.mu)
    physical = tuple(t.contiguous() for t in physical)
    problems = {
        "physical": physical,
        "random": random_problems(N_ENVS, model.ncand, model.nv, gen, dev),
    }
    max_abs_err = 0.0
    for name, ops in problems.items():
        lam_k = pgs.KERNEL(*ops, **kw)
        torch.cuda.synchronize()
        lam_p = pgs.pgs_bj_reference(*ops, **kw)
        err = (lam_k - lam_p).abs()
        scale = lam_p.abs().max().item()
        bad = int((err > ATOL_REL * scale + RTOL * lam_p.abs()).sum())
        log(phase, f"{name}: max|lam| {scale:.4g}, max abs err "
                   f"{err.max().item():.3g}, max rel err "
                   f"{(err.max().item() / max(scale, 1e-30)):.3g}; "
                   f"{bad} of {err.numel()} outside tolerance "
                   f"(rtol {RTOL}, atol {ATOL_REL} x max|lam|)")
        if bad or not torch.isfinite(lam_k).all():
            raise RuntimeError(f"kernel disagrees with its plain version ({name})")
        max_abs_err = max(max_abs_err, err.max().item())
    ms = cuda_ms(lambda: pgs.KERNEL(*physical, **kw), 50)
    plain_ms = cuda_ms(lambda: pgs.pgs_bj_reference(*physical, **kw), 5)
    byts, flops = pgs_counts(model, model.ancestor_mask(), N_ENVS,
                             kw["iterations"])
    t_bytes, t_ops = byts / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOP_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(phase, f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
               f"{bound_ms:.4f} ms by {bound_by} ({byts / 1e6:.1f} MB, "
               f"{flops / 1e9:.3f} GFLOP) at N={N_ENVS}")
    del env, es, physical, problems

    phase = "train"
    torch.cuda.reset_peak_memory_stats()
    pgs.KERNEL.launches = 0
    history = train.main(["--task", "Solo12-CaT-Flat-v0", "--num_envs",
                          str(N_ENVS), "--max_iterations", str(PPO_ITERS),
                          "--device", "cuda"])
    torch.cuda.synchronize()
    launches = pgs.KERNEL.launches
    expected = PPO_ITERS * 24 * env_decimation()
    for i, m in enumerate(history, 1):
        log(phase, f"iter {i}: {m['Perf/iter_seconds']:.3f} s, "
                   f"{m['Perf/env_steps_per_sec']:.0f} env-steps/s, loss "
                   f"{m['Loss/mean_surrogate_loss']:.4f}, v_loss "
                   f"{m['Loss/mean_v_loss']:.4f}, rew/step "
                   f"{m['Train/mean_reward_per_step']:.5f}, ep_len "
                   f"{m['Episode/length']:.1f}")
        if not all(math.isfinite(v) for v in m.values()):
            raise RuntimeError(f"non-finite metrics at iteration {i}")
    log(phase, f"max memory allocated "
               f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; "
               f"pgs_bj launches {launches} (expected {expected})")
    if launches != expected:
        raise RuntimeError("the main path did not run through the kernel")

    phase = "play"
    bundle_path = repo / "runs" / "solo12_flat_2000it" / "policy_params.npz"
    import numpy as np

    sd, obs_mean, obs_var = actor_from_bundle(dict(np.load(bundle_path)))
    net = ActorCritic(45, 12).to(dev)
    res = net.load_state_dict(sd, strict=False)
    if res.unexpected_keys or any(not k.startswith("critic.")
                                  for k in res.missing_keys):
        raise RuntimeError(f"policy bundle does not fit the actor: {res}")
    obs_mean, obs_std = obs_mean.to(dev), torch.sqrt(obs_var.to(dev) + 1e-8)
    cfg = EnvCfg(kp=4.0, kd=0.2,
                 commands=CommandsCfg(lin_vel_x=(PLAY_VX, PLAY_VX),
                                      lin_vel_y=(0.0, 0.0),
                                      ang_vel_z=(0.0, 0.0),
                                      rel_standing_envs=0.0),
                 events=EventsCfg(push_enabled=False),
                 noise=NoiseCfg(enabled=False))
    env = solo12_flat.make_env(N_ENVS, cfg=cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    es = env.init(gen, N_ENVS)
    obs = env.observe(es, gen)
    fell = torch.zeros(N_ENVS, dtype=torch.bool, device=dev)
    vx = []
    with torch.no_grad():
        for t in range(PLAY_STEPS):
            action = net.actor((obs - obs_mean) / obs_std)
            es, obs, _, _, _ = env.step(es, action, gen)
            # no episode times out in 200 steps, so a reset is a fall
            fell |= es.episode_len == 0
            vx.append(quat_rotate_inv(es.sim.qpos[:, 3:7],
                                      es.sim.qvel[:, 0:3])[:, 0])
    survive = 1.0 - fell.float().mean().item()
    vx_mean = torch.stack(vx[PLAY_STEPS // 2:]).mean().item()
    log(phase, f"{survive * 100:.1f}% of {N_ENVS} envs never hit a hard "
               f"termination in {PLAY_STEPS} steps; mean forward velocity "
               f"{vx_mean:.3f} m/s over the last {PLAY_STEPS // 2} steps "
               f"(command {PLAY_VX} m/s)")
    if not survive >= 0.5:
        raise RuntimeError("the JAX-trained policy falls in the port's physics")
    if not vx_mean >= 0.5 * PLAY_VX:
        raise RuntimeError("the JAX-trained policy does not walk in the port")

    print(json.dumps({"kernels": [{
        "name": "pgs_bj", "route": "cuda",
        "source": "cat_tpu_torch/ops/csrc/pgs_bj.cu",
        "replaces": "cat_tpu/ops/pgs_pallas.py:419",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def env_decimation() -> int:
    from cat_tpu_torch.envs.env import EnvCfg

    return EnvCfg().decimation


if __name__ == "__main__":
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    rc = main()
    faulthandler.cancel_dump_traceback_later()
    sys.exit(rc)
