#!/usr/bin/env python3
"""Drive the PyTorch port (cat_tpu_torch) on one CUDA card and check it.

  python3 chip_smoke.py

Phases, each printed with its elapsed seconds:
  device: the card, its power limit, the torch and CUDA versions;
  build: both PGS kernels, ops/csrc/pgs_bj.cu and ops/csrc/pgs_gs.cu, one
     plain nvcc each, started together;
  kernel: the block-Jacobi kernel against its plain PyTorch version at
     N = 4096, on contact problems captured from the port's flat env, on
     seeded random problems and on the joint-less box's problems on a 25
     degree slope (4 contacts, 6 dofs), with the active contacts an env,
     the kernel's time on the physical problems (also with no sweep) and
     on the box's, timed as CUDA-graph replays, so without the host's cost
     of a call, and the time of eager calls one after another, the plain
     version's time and the bound these inputs set, beside the bound of
     the design it replaced;
  kernel-gs: the same for the serial Gauss-Seidel kernel, on problems
     captured from the raw engine on the production rough terrain;
  train: ``cat_tpu_torch.train`` for Solo12-CaT-Flat-v0 at 4096 envs,
     2 PPO iterations; pgs_bj must launch 2 x 24 x 4 times;
  engine-gs: the raw engine with the default SolverParams (GS-5) on the
     production rough terrain, 4096 Solo12s dropped on patch centres hold
     their default pose for 100 control steps; pgs_gs must launch 400
     times and every robot must stand on its pad;
  train-rough: ``cat_tpu_torch.train`` for Solo12-CaT-Rough-v0 at 4096
     envs, 2 PPO iterations; pgs_bj must launch 192 times;
  play: the policy the JAX package trained
     (runs/solo12_flat_2000it/policy_params.npz) walks 4096 envs for 200
     control steps; at least half must never hit a hard termination.
Every launch count is set to 0 just before its path and read just after.
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

DEADLINE_S = 900
T0 = time.perf_counter()

N_ENVS = 4096
PPO_ITERS = 2
PLAY_STEPS = 200
RAW_STEPS = 100      # engine-gs: control steps of the raw engine
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


def graph_ms(fn, reps: int) -> float:
    """The card's time for one call of ``fn``: ``reps`` calls captured in
    one CUDA graph and replayed, so the host's cost of a call (the
    wrapper's Python, the launch) is left out of the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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


def pgs_counts(active, nv, iterations, table_words):
    """Bytes and f32 operations the solve needs for these inputs (its
    (N, nc) ``active``), as the kernels compute it, in the space of the
    dofs: E's rows and W's columns of the active contacts read once, the
    other operands whole (b, bias, active, mu, lam0 read, the result
    written, ``table_words`` of plan or dof table); per active contact the
    five entries of A (5 dot products of nv terms), three divisions, its
    part of the warm start (3 nv multiply-adds) and, in each sweep, three
    rows of w (3 x 2nv), the projection (~32) and three rows of the update
    (3 x 2nv). An inactive contact needs none of it."""
    n, nc = active.shape
    n_act = float((active != 0).sum())
    byts = (4 * n_act * 2 * 3 * nv
            + 4 * n * (3 * 3 * nc + 2 * nc + 1) + 4 * table_words)
    flops = n_act * (5 * 2 * nv + 3 + 3 * 2 * nv
                     + iterations * (3 * 2 * nv + 32 + 3 * 2 * nv))
    return byts, flops


def dense_counts(model, n, iterations, active=None):
    """The counts of the design these kernels replaced:
    every operand whole, the assembly of A over the nonzero dofs, the warm
    start, and the sweeps' updates of all 3nc rows of w; over all contacts
    (block-Jacobi) or the active ones (serial sweep)."""
    from cat_tpu_torch.ops import pgs

    nc, nv = model.ncand, model.nv
    n3 = 3 * nc
    byts = 4 * n * (2 * n3 * nv + 2 * n3 + n3 + 2 * nc + 1) + 4 * (nc + 8)
    nnz = sum(len(r) for r in pgs.contact_row_dofs(model,
                                                   model.ancestor_mask()))
    if active is None:
        flops = n * (2 * n3 * nnz + 2 * n3 * n3
                     + iterations * (2 * n3 * n3 + 32 * nc))
    else:
        n_act = float(active.sum())
        flops = (n * 2 * n3 * nnz + 2 * n3 * 3 * n_act
                 + iterations * n_act * (3 * 2 * n3 + 32))
    return byts, flops


def bound(byts, flops):
    """(bound_ms, bound_by): the larger of the bytes over the card's memory
    rate and the f32 operations over its peak rate."""
    t_bytes = byts / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_kernel(phase, kernel, plain, problems) -> float:
    """Hold ``kernel`` against ``plain`` on each problem, given as
    (operands, keyword arguments); the max abs error over them."""
    import torch

    max_abs_err = 0.0
    for name, (ops, kw) in problems.items():
        lam_k = kernel(*ops, **kw)
        torch.cuda.synchronize()
        lam_p = plain(*ops, **kw)
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
    return max_abs_err


def kernel_numbers(phase, row, kernel, plain, problems, old_counts,
                   table_words, plain_reps):
    """Hold ``kernel`` against ``plain`` on ``problems``; then its time on
    the card on the physical problem (also with no sweep, ``iterations=0``:
    staging, the five entries of A a contact, the warm start) and on the
    box problem, the time of eager calls one after another (which the
    host's cost of a call bounds when it exceeds the kernel's), the plain
    version's time and the bound for these inputs, beside the bound the
    replaced design was held to. Fills ``row``."""
    physical, kw = problems["physical"]
    active = physical[4]
    per_env = (active != 0).sum(1).float()
    log(phase, f"physical problem: {per_env.mean():.2f} active contacts an "
               f"env of {active.shape[1]} (min {per_env.min():.0f}, max "
               f"{per_env.max():.0f}); box problem: "
               f"{(problems['box'][0][4] != 0).sum(1).float().mean():.2f} "
               f"of {problems['box'][0][4].shape[1]}")
    row["max_abs_err"] = check_kernel(phase, kernel, plain, problems)
    row["ms"] = graph_ms(lambda: kernel(*physical, **kw), 50)
    box_ms = graph_ms(lambda: kernel(*problems["box"][0],
                                     **problems["box"][1]), 50)
    no_sweep_ms = graph_ms(lambda: kernel(*physical,
                                          **dict(kw, iterations=0)), 50)
    eager_ms = cuda_ms(lambda: kernel(*physical, **kw), 50)
    row["plain_ms"] = cuda_ms(lambda: plain(*physical, **kw), plain_reps)
    byts, flops = pgs_counts(active, physical[0].shape[2], kw["iterations"],
                             table_words)
    row["bound_ms"], row["bound_by"] = bound(byts, flops)
    old_ms, old_by = bound(*old_counts)
    log(phase, f"kernel {row['ms']:.4f} ms on the card (with no sweep "
               f"{no_sweep_ms:.4f} ms; on the box problem {box_ms:.4f} ms); "
               f"eager calls {eager_ms:.4f} ms apart; plain "
               f"{row['plain_ms']:.3f} ms; bound "
               f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
               f"({byts / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP: "
               f"{row['bound_ms'] / row['ms'] * 100:.1f}% of it); the "
               f"replaced design's bound on these inputs {old_ms:.4f} ms by "
               f"{old_by} ({old_counts[0] / 1e6:.1f} MB, "
               f"{old_counts[1] / 1e9:.3f} GFLOP) at N={N_ENVS}")


def box_on_slope(dev):
    """The raw engine (GS-5) of the joint-less box (4 contacts, 6 dofs, M^-1
    by the unrolled Cholesky) on the 25 degree slope: N_ENVS boxes with
    friction from 1e-3 (sliding) to 1.0 (sticking), captured after 10
    control steps. Returns (model, operands, the solve's kwargs)."""
    import torch

    from cat_tpu_torch.models.box import box_model, on_slope_qpos, slope_terrain
    from cat_tpu_torch.sim import engine

    model = box_model()
    eng = engine.make_batched_step(model, engine.EngineParams(),
                                   terrain=slope_terrain(25.0), device=dev)
    s = engine.make_batched_init(model, N_ENVS, dev)._replace(
        qpos=torch.from_numpy(on_slope_qpos(25.0, N_ENVS)).to(dev))
    mu = torch.linspace(1e-3, 1.0, N_ENVS, device=dev)
    target = torch.zeros(N_ENVS, 0, device=dev)
    for _ in range(10):
        s = eng(s, target, mu)
    _, ops = eng.contact_problem(s, target, mu)
    return model, tuple(t.contiguous() for t in ops), eng.pgs_kwargs


def raw_engine_on_rough(dev):
    """The raw engine with the default SolverParams (GS-5) on the
    production rough terrain, and N_ENVS Solo12s in their default pose,
    env i above the centre of patch (i // 8 % 10, i % 8) at h + 0.30 m.
    Returns (engine, state, target, mu, spots)."""
    import torch

    from cat_tpu_torch.models.solo12 import SOLO12_KD, SOLO12_KP, solo12_model
    from cat_tpu_torch.sim import engine, terrain

    model = solo12_model()
    terr = terrain.generate_rough(seed=0)
    eng = engine.make_batched_step(
        model, engine.EngineParams(kp=SOLO12_KP, kd=SOLO12_KD), terrain=terr,
        device=dev)
    i = torch.arange(N_ENVS)
    spots = torch.tensor([list(terr.patch_origin(r, c)) for r, c in zip(
        (i // terr.cols % terr.rows).tolist(), (i % terr.cols).tolist())],
        dtype=torch.float32, device=dev)
    s = engine.make_batched_init(model, N_ENVS, dev)
    qpos = s.qpos.clone()
    qpos[:, 0:2] = spots
    qpos[:, 2] = terrain.height_at(terr, spots) + 0.30
    target = torch.as_tensor(model.default_qpos_joints, dtype=torch.float32,
                             device=dev).expand(N_ENVS, model.nj)
    mu = torch.ones(N_ENVS, device=dev)
    return eng, s._replace(qpos=qpos), target, mu, spots


def train_phase(phase, task, kernel, train) -> int:
    """Two PPO iterations of ``task`` at N_ENVS with ``kernel``'s count
    set to 0 before and read after; fails unless it launched 2 x 24 x 4
    times and every metric is finite. Returns (launches, metrics of each
    iteration)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    kernel.launches = 0
    history = train.main(["--task", task, "--num_envs", str(N_ENVS),
                          "--max_iterations", str(PPO_ITERS),
                          "--device", "cuda"])
    torch.cuda.synchronize()
    launches = kernel.launches
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
               f"launches {launches} (expected {expected})")
    if launches != expected:
        raise RuntimeError("the main path did not run through the kernel")
    return launches, history


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
    from cat_tpu_torch.sim import terrain
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
    with ThreadPoolExecutor(2) as pool:   # one nvcc a source, together
        builds = list(pool.map(lambda k: k.load(), (pgs.KERNEL, pgs.GS_KERNEL)))
    for built in builds:
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
    box, box_ops, box_gs_kw = box_on_slope(dev)
    perm, blocks = pgs.plan_contact_blocks(box, 2)
    problems = {
        "physical": (physical, kw),
        "random": (random_problems(N_ENVS, model.ncand, model.nv, gen, dev),
                   kw),
        "box": (box_ops, dict(kw, contact_perm=perm, blocks=blocks)),
    }
    bj = dict(name="pgs_bj", source="cat_tpu_torch/ops/csrc/pgs_bj.cu",
              replaces="cat_tpu/ops/pgs_pallas.py:419")
    kernel_numbers(phase, bj, pgs.KERNEL, pgs.pgs_bj_reference, problems,
                   dense_counts(model, N_ENVS, kw["iterations"]),
                   table_words=model.ncand + 2 * len(kw["blocks"]),
                   plain_reps=5)
    del env, es, physical, problems

    phase = "kernel-gs"
    eng, s, target, mu, _ = raw_engine_on_rough(dev)
    for _ in range(5):
        s = eng(s, target, mu)
    _, physical = eng.contact_problem(s, target, mu)
    physical = tuple(t.contiguous() for t in physical)
    kw = eng.pgs_kwargs
    log(phase, f"raw engine solve: {eng.solve.__name__}, {kw['iterations']} "
               "sweeps")
    if eng.solve is not pgs.pgs_gs:
        raise RuntimeError("the raw engine's default solve is not pgs_gs")
    # the random rows are dense: every dof enters them
    problems = {
        "physical": (physical, kw),
        "random": (random_problems(N_ENVS, model.ncand, model.nv, gen, dev),
                   dict(kw, row_dofs=None)),
        "box": (box_ops, box_gs_kw),
    }
    gs = dict(name="pgs_gs", source="cat_tpu_torch/ops/csrc/pgs_gs.cu",
              replaces="cat_tpu/ops/pgs_pallas.py:103")
    kernel_numbers(phase, gs, pgs.GS_KERNEL, pgs.pgs_gs_reference, problems,
                   dense_counts(model, N_ENVS, kw["iterations"],
                                active=physical[4]),
                   table_words=3 * model.ncand, plain_reps=3)
    del eng, s, physical, problems, box_ops

    phase = "train"
    launches_flat, _ = train_phase(phase, "Solo12-CaT-Flat-v0", pgs.KERNEL,
                                   train)

    phase = "engine-gs"
    eng, s, target, mu, spots = raw_engine_on_rough(dev)
    pgs.GS_KERNEL.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RAW_STEPS):
        s = eng(s, target, mu)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / RAW_STEPS * 1e3
    gs["launches"] = pgs.GS_KERNEL.launches
    expected = RAW_STEPS * eng.params.decimation
    finite = all(bool(torch.isfinite(t.float()).all()) for t in s)
    rel_z = s.qpos[:, 2] - terrain.height_at(eng.terrain, s.qpos[:, 0:2])
    drift = torch.linalg.vector_norm(s.qpos[:, 0:2] - spots, dim=1)
    standing = int(((rel_z > 0.12) & (rel_z < 0.40) & (drift < 0.5)).sum())
    log(phase, f"{RAW_STEPS} control steps x {N_ENVS} envs: "
               f"{step_ms:.2f} ms a control step; pgs_gs launches "
               f"{gs['launches']} (expected {expected}); z - h in "
               f"[{rel_z.min():.4f}, {rel_z.max():.4f}] m, drift max "
               f"{drift.max():.4f} m; {standing} of {N_ENVS} standing")
    if gs["launches"] != expected:
        raise RuntimeError("the raw engine did not run through pgs_gs")
    if not finite or standing != N_ENVS:
        raise RuntimeError("robots fell, tunnelled or drifted on the pads")
    del eng, s

    phase = "train-rough"
    bj["launches"], history = train_phase(phase, "Solo12-CaT-Rough-v0",
                                          pgs.KERNEL, train)
    levels = [m["Curriculum/terrain_levels"] for m in history
              if "Curriculum/terrain_levels" in m]
    log(phase, f"Curriculum/terrain_levels {levels}; flat training launched "
               f"pgs_bj {launches_flat} times, rough training "
               f"{bj['launches']}")
    if len(levels) != len(history) or not all(0.0 <= v <= 9.0 for v in levels):
        raise RuntimeError("Curriculum/terrain_levels missing or out of [0, 9]")

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

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {k: dict(row, route="cuda", library_ms=None)[k] for k in keys}
        for row in (bj, gs)]}), flush=True)
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
