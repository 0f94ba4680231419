#!/usr/bin/env python3
"""Drive the PyTorch port (cat_tpu_torch) on one CUDA card and check it.

  python3 chip_smoke.py

Phases, each printed with its elapsed seconds:
  device: the card, its power limit, the torch and CUDA versions;
  build: both PGS kernels, ops/csrc/pgs_bj.cu and ops/csrc/pgs_gs.cu, one
     plain nvcc each, started together;
  kernel: the block-Jacobi kernel against its plain PyTorch version at
     N = 4096, on contact problems captured from the port's flat Solo12 env
     (36 contacts) and from its Go2 env (28 contacts), on seeded random
     problems and on the joint-less box's problems on a 25 degree slope (4
     contacts, 6 dofs), with the active contacts an env, the kernel's time
     on the physical problems of both robots (also with no sweep) and on
     the box's, timed as CUDA-graph replays, so without the host's cost of
     a call, and the time of eager calls one after another, the plain
     version's time and the bound these inputs set, beside the bound of
     the design it replaced;
  kernel-gs: the same for the serial Gauss-Seidel kernel, on problems
     captured from the raw engine on the production rough terrain (Solo12)
     and on flat ground (Go2);
  graph: the control step's CUDA graph (``Engine.__call__`` on the card)
     against the eager substep loop (``Engine._eager``) in each engine
     configuration the port runs: the flat env's block-Jacobi engine at
     4096 and at 256 envs (the probe's N), with the CoM event's offsets,
     the raw engine (GS-5) on the production rough terrain, Go2's env
     (block-Jacobi, 28 contacts) and raw (GS-5) engines, and the box (the
     Cholesky M^-1) on its slope: after the warm-up call, 5 control steps
     from one state, graphed and eager, equal bit for bit; the returned
     states keep their values through 5 more replays; the kernel launches
     4 times every control step; the eager and graphed ms a control step;
  train: ``cat_tpu_torch.train`` for Solo12-CaT-Flat-v0 at 4096 envs,
     2 PPO iterations, a checkpoint each; pgs_bj must launch 2 x 24 x 4
     times;
  train-nccl: the same run through the grouped code path (``--coordinator``
     with one process, so every collective runs in NCCL on the card), one
     iteration: 36 all_reduces and no other collective in it, 96
     launches, and its parameters equal the train phase's after its first
     iteration (rtol 1e-5; the obs normaliser, rebuilt from pooled
     moments, differs by rounding);
  train-dist: two processes share the card under gloo, 2048 envs each
     (4096 global), the same recipe, 2 iterations with a checkpoint each,
     then both resume from ckpt_1 and run iteration 2 again: after every
     iteration the parameters, Adam's moments, both normalisers, the
     running maxes and the metrics are equal bit for bit on both ranks;
     each rank launches pgs_bj 96 times an iteration; rank 0 alone writes,
     its checkpoint holds 4096 env rows and both ranks' generator states;
     the resumed ckpt_2 equals the first bit for bit; each rank's
     iteration seconds and card busy share (the busy time of the resumed
     iteration 2, under the profiler, over the first run's iteration 2)
     are printed: two ranks sharing one card, not a scaling figure; each
     iteration of each rank makes 36 all_reduces and no other collective;
  train-dr: Solo12-CaT-Flat-v0 at 4096 envs with the CoM event on the base
     (``events.com_displacement=0.05 events.com_bodies=('base_link',)``),
     one iteration (96 launches): the offsets are (4096, nbody, 3), within
     +-0.05, on the base's row alone and differ across envs, and from one
     seed the qpos after 5 control steps differs from the env without the
     event by more than 1e-5;
  engine-gs: the raw engine with the default SolverParams (GS-5) on the
     production rough terrain, 4096 Solo12s dropped on patch centres hold
     their default pose for 100 control steps; pgs_gs must launch 400
     times and every robot must stand on its pad;
  engine-go2: the port compiles its go2.urdf (``compile_go2()``): its
     to_json() must equal the committed go2_model.json's
     byte for byte and every field the JSON-loaded model's; then the raw
     engine (GS-5) with 4096 of those Go2s dropped from the default pose
     on flat ground for 75 control steps; pgs_gs must launch 300 times,
     every robot must stand (0.2 < z < 0.45 m, tilt < 0.25, |qvel| < 0.6)
     and its feet carry its weight to 25%;
  train-go2: ``cat_tpu_torch.train`` for Go2-CaT-Flat-v0 at 4096 envs
     with the rl_games recipe, 2 iterations, a checkpoint each (192
     launches; metrics.jsonl has 2 lines with every key of the JAX
     package's Go2 log);
  resume: ckpt_2 restored into a fresh trainer equals the saved state bit
     for bit (every tensor, the generators), and one more iteration runs
     from the carried learning rate (96 launches);
  play-run: ``cat_tpu_torch.play`` on that run directory at 4096 envs for
     200 control steps (800 launches): it restores the card's checkpoint
     non-strict into Go2-CaT-Flat-Play-v0, exports it and writes
     play_traj.npz; the trajectory must be finite and whole, and the
     TorchScript policy.pt must agree with the actor of the
     policy_params.npz written beside it;
  presets: one iteration each of the skrl and clean_rl recipes on
     Solo12-CaT-Flat-v0 at 4096 envs (96 launches each);
  train-rough: ``cat_tpu_torch.train`` for Solo12-CaT-Rough-v0 at 4096
     envs, 2 PPO iterations; pgs_bj must launch 192 times;
  play: the policy the JAX package trained
     (runs/solo12_flat_2000it/policy_params.npz) walks 4096 envs for 200
     control steps at 1.0 m/s (``play.rollout``, 800 launches); at least
     half must never hit a hard termination;
  play-go2: the JAX-trained Go2 policy (runs/go2_r4/policy_params.npz) in
     Go2-CaT-Flat-v0 at 4096 envs for 200 control steps at 1.0 m/s (800
     launches), against a gate set from the JAX package's own play; then
     its export by ``rl/export.py``: the TorchScript module on the card
     agrees with the actor;
  bench: ``cat_tpu_torch.bench`` (BENCHMARK.json's two cells) with 1 timed
     iteration of the flat cell and 1 window of 20 raw-engine control steps,
     no trace: both cells must be correct (their checks against the plain
     learner and physics references included), and their pgs_bj / pgs_gs
     launches (warm-up and timed) must be (3 + 1) x 96 and (50 + 20) x 4;
  probe: ``cat_tpu_torch.tools.pgs_structure_probe`` at 256 envs: the flat
     env's contact problems at 5 points of a 50-control-step rollout (200
     launches), each of the 26 (blocks, omega, sweeps) structures solved
     by the pgs_bj kernel (130 launches) and held against its plain
     version, the 4 serial ones also by pgs_gs (20 launches), held against pgs_bj at 36 single blocks and its own
     plain version, every structure scored against a converged 100-sweep
     serial solve; the shipped bj:4:0.9:6 row must read imp_err <= 1.5 x
     the reference's TPU reading, and leave no contact approaching faster,
     beyond what the converged solve leaves on it, than the reference's
     vn_max reading (PROBE_IMP_ERR, PROBE_VN_EXCESS);
  drill: ``cat_tpu_torch.tools.resume_drill`` at 256 envs: the trainer, a
     child process, SIGKILLed by its pid once ckpt_20.pt lands (30
     iterations, a checkpoint every 10), resumed from it: metrics 1..30
     with no gap, the resumed leg from 21, finite rewards;
  cstr: Solo12-CaT-Flat-v0 at 4096 envs with joint_range and
     min_base_height added to its 13 terms: the ConstraintSet's layout has
     their 12 + 1 columns after the 78, 24 control steps (96 launches) keep
     the CaT transform finite and both terms violated somewhere; and
     ``make_batched_init(model, n)``, the reference's two-argument call,
     lands on the card as ``init_state`` broadcast.
Training runs log to a temporary directory, never inside the repo.
Every launch count is set to 0 just before its path and read just after
(in the train-dist processes, before each iteration); the JSON line's
launches are their sums over all paths and processes (the drill's trainers,
which the drill itself checks, excepted). The last lines are
a JSON line of kernel numbers, the card's name and power
limit, and the result line. Any failure exits non-zero before the result
line; a hang is cut by a faulthandler deadline.
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import gzip
import io
import json
import math
import os
import sys
import tempfile
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
# the play phases' task setting: that command alone, no pushes, no noise
PLAY_OVERRIDES = (f"commands.lin_vel_x=({PLAY_VX},{PLAY_VX})",
                  "commands.lin_vel_y=(0.0,0.0)",
                  "commands.ang_vel_z=(0.0,0.0)",
                  "commands.rel_standing_envs=0.0",
                  "events.push_enabled=False", "noise.enabled=False")
GO2_SETTLE = 75      # engine-go2: control steps (tests/test_go2.py's fixture)
DIST_RANKS = 2       # train-dist: processes sharing the card
# train-dr: the randomize_body_coms event on the base
DR_OVERRIDES = ("events.com_displacement=0.05",
                "events.com_bodies=('base_link',)")
# play-go2 gate, set from the JAX package's own play of runs/go2_r4 at this
# command (tests/test_torch_go2.py run as a script, 48 envs on the CPU,
# 200 steps): no env survives 200 steps (the policy's thighs touch down,
# an illegal contact), the first fall comes at step 62.3 on average and
# the envs walk at 1.325 m/s; the port must reach half of each
GO2_FIRST_FALL_MIN = 0.5 * 62.3
GO2_VX_MIN = 0.5 * 1.325
PROBE_ENVS = 256     # probe: the reference tool's N
# probe gate on the shipped bj:4:0.9:6 row, against the reference's TPU
# reading (runs/profile/perf_r5.md:31-37: imp_err 0.037, vn_max 0.172). On
# the CPU (the probe at 256 envs, seeds 0-2) the port read imp_err
# 0.0364-0.0429: it may reach 1.5 x the reference's. Its vn_max, 0.331-0.398,
# is the captures' tail: the converged 100-sweep serial solve leaves
# 0.372-0.588 on the same captures. So the gate holds what the structure
# leaves beyond the converged solve on each contact (vn_excess_max):
# 0.0546-0.0739 on the CPU, against a limit of the reference's whole
# vn_max, which bounds its own excess. Structures that leave contacts
# approaching read over it there: GS-5 and bj:4:1.0:5 0.138-0.358,
# bj:1:0.5:8 0.173-0.215.
PROBE_IMP_ERR = (0.037, 1.5)
PROBE_VN_EXCESS = 0.172
GRAPH_STEPS = 5      # graph: control steps held bit for bit, then timed
DRILL = dict(num_envs=256, iters=30, save_interval=10, kill_after=20)
# cstr: the two terms the recipe leaves out, on every joint / the base, at
# limits that uniform [-1, 1] actions cross within 24 control steps
CSTR_TERMS = (("joint_range", dict(limit=0.3), 0.25, True),
              ("min_base_height", dict(limit=0.28), 1.0, False))


def log(phase: str, msg: str):
    print(f"[{phase} +{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


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


def check_kernel(phase, kernel, plain, problems) -> float:
    """Hold ``kernel`` against ``plain`` on each problem, given as
    (operands, keyword arguments); the max abs error over them."""
    import torch

    from cat_tpu_torch import measure

    max_abs_err = 0.0
    for name, (ops, kw) in problems.items():
        lam_k = kernel(*ops, **kw)
        torch.cuda.synchronize()
        err, scale, bad = measure.disagreement(lam_k, plain(*ops, **kw))
        log(phase, f"{name}: max|lam| {scale:.4g}, max abs err {err:.3g}, "
                   f"max rel err {err / max(scale, 1e-30):.3g}; {bad} of "
                   f"{lam_k.numel()} outside tolerance (rtol "
                   f"{measure.RTOL}, atol {measure.ATOL_REL} x max|lam|)")
        if bad:
            raise RuntimeError(f"kernel disagrees with its plain version ({name})")
        max_abs_err = max(max_abs_err, err)
    return max_abs_err


def kernel_numbers(phase, row, kernel, plain, problems, old_counts,
                   table_words, plain_reps):
    """Hold ``kernel`` against ``plain`` on ``problems``; then its time on
    the card on the physical problem (also with no sweep, ``iterations=0``:
    staging, the five entries of A a contact, the warm start) and on the
    box problem, the time of eager calls one after another (which the
    host's cost of a call bounds when it exceeds the kernel's), the plain
    version's time and the bound for these inputs, beside the bound the
    replaced design was held to; the same times and bound on the Go2
    problem. ``table_words(nc)``: the words of plan or dof table. Fills
    ``row``."""
    from cat_tpu_torch.measure import bound, cuda_ms, graph_ms, pgs_counts

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
    go2, go2_kw = problems["go2"]
    go2_ms = graph_ms(lambda: kernel(*go2, **go2_kw), 50)
    go2_no_sweep = graph_ms(lambda: kernel(*go2, **dict(go2_kw, iterations=0)),
                            50)
    go2_bytes, go2_flops = pgs_counts(go2[4], go2[0].shape[2],
                                      go2_kw["iterations"],
                                      table_words(go2[4].shape[1]))
    go2_bound, go2_by = bound(go2_bytes, go2_flops)
    box_ms = graph_ms(lambda: kernel(*problems["box"][0],
                                     **problems["box"][1]), 50)
    no_sweep_ms = graph_ms(lambda: kernel(*physical,
                                          **dict(kw, iterations=0)), 50)
    eager_ms = cuda_ms(lambda: kernel(*physical, **kw), 50)
    row["plain_ms"] = cuda_ms(lambda: plain(*physical, **kw), plain_reps)
    byts, flops = pgs_counts(active, physical[0].shape[2], kw["iterations"],
                             table_words(active.shape[1]))
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
    log(phase, f"at nc = {go2[4].shape[1]} (Go2, "
               f"{(go2[4] != 0).sum(1).float().mean():.2f} active contacts an "
               f"env): kernel {go2_ms:.4f} ms, with no sweep "
               f"{go2_no_sweep:.4f} ms, bound {go2_bound:.4f} ms by {go2_by} "
               f"({go2_bound / go2_ms * 100:.1f}% of it); at nc = "
               f"{active.shape[1]} (Solo12): {row['ms']:.4f} ms, "
               f"{no_sweep_ms:.4f} ms")


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


def standing_on_pads(eng, s, spots) -> int:
    """Robots standing on their pads: 0.12 < z - h < 0.40 m, drift < 0.5 m."""
    import torch

    from cat_tpu_torch.sim import terrain

    rel_z = s.qpos[:, 2] - terrain.height_at(eng.terrain, s.qpos[:, 0:2])
    drift = torch.linalg.vector_norm(s.qpos[:, 0:2] - spots, dim=1)
    return int(((rel_z > 0.12) & (rel_z < 0.40) & (drift < 0.5)).sum())


def train_argv(task, logdir, iters, *extra):
    return ["--task", task, "--num_envs", str(N_ENVS), "--max_iterations",
            str(iters), "--device", "cuda", "--logdir", logdir, "--writer",
            "none", *extra]


def check_launches(phase, kernel, expected) -> int:
    """The launches of ``kernel`` since its count was set to 0; fails
    unless they are ``expected``."""
    import torch

    from cat_tpu_torch.ops import pgs

    torch.cuda.synchronize()
    launches = kernel.launches
    name = "pgs_bj" if kernel is pgs.KERNEL else "pgs_gs"
    log(phase, f"{name} launches {launches} (expected {expected})")
    if launches != expected:
        raise RuntimeError("the main path did not run through the kernel")
    return launches


def check_finite(phase, history):
    for i, m in enumerate(history, 1):
        log(phase, f"iter {i}: {m['Perf/iter_seconds']:.3f} s, "
                   f"{m['Perf/env_steps_per_sec']:.0f} env-steps/s, loss "
                   f"{m['Loss/mean_surrogate_loss']:.4f}, v_loss "
                   f"{m['Loss/mean_v_loss']:.4f}, rew/step "
                   f"{m['Train/mean_reward_per_step']:.5f}, ep_len "
                   f"{m['Episode/length']:.1f}, lr "
                   f"{m['Train/learning_rate']:.3g}")
        if not all(math.isfinite(v) for v in m.values()):
            raise RuntimeError(f"non-finite metrics at iteration {i}")


def train_phase(phase, argv, kernel, train, iters):
    """``train.main(argv)`` with ``kernel``'s count set to 0 before and read
    after; fails unless it launched iters x 24 x 4 times and every metric
    is finite. Returns (launches, metrics of each iteration)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    kernel.launches = 0
    history = train.main(argv)
    launches = check_launches(phase, kernel, iters * 24 * env_decimation())
    check_finite(phase, history)
    log(phase, f"max memory allocated "
               f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    return launches, history


def learner_digest(tr, metrics) -> str:
    """sha256 of what every rank must agree on after an iteration: the
    parameters, Adam's moments, both normalisers, the running maxes, the
    learning rate and the metrics."""
    import hashlib

    import torch

    digest = hashlib.sha256()
    opt = tr.ppo.opt.state_dict()["state"]
    tensors = (list(tr.ppo.net.state_dict().values())
               + [opt[i][k] for i in sorted(opt)
                  for k in ("exp_avg", "exp_avg_sq")]
               + list(tr.ppo.obs_rms) + list(tr.ppo.value_rms)
               + [tr.es.running_max, tr.ppo.lr])
    for t in tensors:
        digest.update(t.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    digest.update(json.dumps(metrics, sort_keys=True).encode())
    return digest.hexdigest()


class Collectives:
    """Counts torch.distributed's collectives while installed: all_reduce,
    broadcast and any other (``counts``), and the host seconds spent in
    them (``seconds``: a call returns once its result is in place, the
    other ranks' wait included)."""
    OTHERS = ("all_gather", "all_gather_into_tensor", "all_gather_object",
              "reduce_scatter", "reduce_scatter_tensor", "reduce", "gather",
              "scatter", "all_to_all", "all_to_all_single", "barrier",
              "send", "recv", "broadcast_object_list")

    def __enter__(self):
        import torch.distributed as tdist

        self.tdist, self.real = tdist, {}
        self.counts = {"all_reduce": 0, "broadcast": 0, "other": 0}
        self.seconds = 0.0
        for name in ("all_reduce", "broadcast") + self.OTHERS:
            real = self.real[name] = getattr(tdist, name)
            key = name if name in self.counts else "other"

            def counted(*a, _real=real, _key=key, **k):
                self.counts[_key] += 1
                t0 = time.perf_counter()
                try:
                    return _real(*a, **k)
                finally:
                    self.seconds += time.perf_counter() - t0
            setattr(tdist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(self.tdist, name, real)


class Writes:
    """Records the files this process opens for writing or torch.save's
    under ``root`` while installed."""

    def __init__(self, root):
        self.root, self.paths = os.path.abspath(root), []

    def _note(self, path):
        path = os.path.abspath(os.fspath(path))
        if path.startswith(self.root):
            self.paths.append(path)

    def __enter__(self):
        import builtins

        import torch

        self.builtins, self.torch = builtins, torch
        self.open, self.save = builtins.open, torch.save

        def opened(file, mode="r", *a, **k):
            if isinstance(file, (str, os.PathLike)) and any(
                    c in mode for c in "wax+"):
                self._note(file)
            return self.open(file, mode, *a, **k)

        def saved(obj, f, *a, **k):
            if isinstance(f, (str, os.PathLike)):
                self._note(f)
            return self.save(obj, f, *a, **k)

        builtins.open, torch.save = opened, saved
        return self

    def __exit__(self, *exc):
        self.builtins.open, self.torch.save = self.open, self.save


def dist_worker(rank, coordinator, argv, resume_argv, resume_coordinator,
                logdir, out):
    """One process of train-dist: ``train.main`` over the group of
    DIST_RANKS processes sharing the card under gloo, then again resumed
    from ckpt_1. Writes its report (per iteration: pgs_bj launches, the
    collectives, host seconds, the learner digest; the files it wrote; the
    card busy time of the resumed iteration, under torch.profiler) to
    ``out/rank<rank>.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cat_tpu_torch import train
    from cat_tpu_torch.ops import pgs

    report = {"iterations": []}
    real = train.Trainer.train_iteration
    profiled = {"on": False}

    def traced(self):
        pgs.KERNEL.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with Collectives() as calls:
            if profiled["on"]:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    metrics = real(self)
                    torch.cuda.synchronize()
                report["busy_s"] = sum(
                    e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
            else:
                metrics = real(self)
                torch.cuda.synchronize()
        report["iterations"].append({
            "launches": pgs.KERNEL.launches, "collectives": calls.counts,
            "collective_s": calls.seconds,
            "seconds": time.perf_counter() - t0,
            "digest": learner_digest(self, metrics), "metrics": metrics})
        return metrics

    train.Trainer.train_iteration = traced
    flags = ["--num_processes", str(DIST_RANKS), "--process_id", str(rank)]
    with Writes(logdir) as writes:
        train.main([*argv, "--coordinator", coordinator, *flags], "gloo")
        profiled["on"] = True
        train.main([*resume_argv, "--coordinator", resume_coordinator,
                    *flags], "gloo")
    report["writes"] = sorted(set(writes.paths))
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def train_nccl_phase(logdir, flat_dir) -> int:
    """train-nccl (module docstring); returns its pgs_bj launches."""
    from cat_tpu_torch import train
    from cat_tpu_torch.ops import pgs
    from cat_tpu_torch.parallel import distributed
    from cat_tpu_torch.rl import checkpoint

    phase = "train-nccl"
    real_iteration = train.Trainer.train_iteration
    calls, seconds = [], []

    def counted(self):
        with Collectives() as c:
            metrics = real_iteration(self)
        calls.append(c.counts)
        seconds.append(c.seconds)
        return metrics

    train.Trainer.train_iteration = counted
    try:
        launches, _ = train_phase(
            phase, train_argv(
                "Solo12-CaT-Flat-v0", logdir, 1, "--run_name", "nccl",
                "--override", "save_interval=1", "--coordinator",
                distributed.free_coordinator(), "--num_processes", "1",
                "--process_id", "0"), pgs.KERNEL, train, 1)
    finally:
        train.Trainer.train_iteration = real_iteration
    grouped = checkpoint.load(os.path.join(flat_dir, "nccl", "ckpt_1"))
    alone = checkpoint.load(os.path.join(flat_dir, "flat", "ckpt_1"))
    dev_p = max((grouped["ppo"]["net"][k] - v).abs().max().item()
                for k, v in alone["ppo"]["net"].items())
    bad_p = sum(int(((grouped["ppo"]["net"][k] - v).abs()
                     > 1e-5 * v.abs()).sum())
                for k, v in alone["ppo"]["net"].items())
    dev_rms = max((grouped["ppo"]["obs_rms"][k] - v).abs().max().item()
                  for k, v in alone["ppo"]["obs_rms"].items())
    log(phase, f"collectives in the iteration {calls} (expected 36 "
               f"all_reduce, nothing else), {seconds[0]:.4f} s in them; "
               f"parameters after iteration 1 "
               f"against the train phase's: max abs deviation "
               f"{dev_p:.3g}, {bad_p} values outside rtol 1e-5; obs "
               f"normaliser max abs deviation {dev_rms:.3g}")
    if calls != [{"all_reduce": 36, "broadcast": 0, "other": 0}] or bad_p:
        raise RuntimeError("the grouped path under NCCL does not train "
                           "as the one-card path")
    return launches


def train_dist_phase(logdir, flat_dir) -> int:
    """train-dist (module docstring); returns the pgs_bj launches of
    both processes."""
    from cat_tpu_torch.parallel import distributed
    from cat_tpu_torch.rl import checkpoint

    phase = "train-dist"
    out = os.path.join(logdir, "dist-reports")
    os.makedirs(out)
    dist_argv = train_argv("Solo12-CaT-Flat-v0", logdir, PPO_ITERS,
                           "--run_name", "dist", "--override",
                           "save_interval=1")
    dist_dir = os.path.join(flat_dir, "dist")
    resume_argv = train_argv("Solo12-CaT-Flat-v0", logdir, PPO_ITERS,
                             "--run_name", "dist-resumed", "--override",
                             "save_interval=1", "--checkpoint",
                             os.path.join(dist_dir, "ckpt_1"))
    t0 = time.perf_counter()
    distributed.spawn(dist_worker, DIST_RANKS,
                      (dist_argv, resume_argv,
                       distributed.free_coordinator(), logdir, out),
                      timeout=DEADLINE_S / 2)
    reports = []
    for r in range(DIST_RANKS):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    log(phase, f"{DIST_RANKS} processes on one card (gloo), both runs, "
               f"{time.perf_counter() - t0:.1f} s with their start")
    for r, rep in enumerate(reports):
        its = rep["iterations"]
        log(phase, f"rank {r}: iteration seconds "
                   f"{[round(i['seconds'], 3) for i in its]} (2 ranks "
                   f"sharing one card; the last one, the resumed iteration "
                   f"2, under the profiler), launches "
                   f"{[i['launches'] for i in its]}, collectives "
                   f"{its[0]['collectives']} taking "
                   f"{[round(i['collective_s'], 3) for i in its]} s; card "
                   f"busy {rep['busy_s']:.4f}"
                   f" s in iteration 2, "
                   f"{rep['busy_s'] / its[1]['seconds'] * 100:.1f}% of its "
                   f"unprofiled {its[1]['seconds']:.3f} s; wrote "
                   f"{len(rep['writes'])} files")
        check_finite(f"{phase} rank {r}", [
            dict(i["metrics"], **{"Perf/iter_seconds": i["seconds"],
                                  "Perf/env_steps_per_sec":
                                  24 * N_ENVS / i["seconds"]})
            for i in its])
    digests = [[i["digest"] for i in rep["iterations"]] for rep in reports]
    launches = [i["launches"] for rep in reports
                for i in rep["iterations"]]
    first = checkpoint.load(os.path.join(dist_dir, "ckpt_1"))
    rows = first["env"]["sim"]["qpos"].shape[0]
    gens = {k: tuple(v.shape) for k, v in first["generators"].items()}
    differ = checkpoint.mismatches(
        checkpoint.load(os.path.join(dist_dir, "ckpt_2")),
        checkpoint.load(os.path.join(flat_dir, "dist-resumed", "ckpt_2")))
    log(phase, f"learner digests equal across ranks: "
               f"{digests[0] == digests[1]} ({len(digests[0])} "
               f"iterations), resumed iteration 2 equals the first: "
               f"{digests[0][2] == digests[0][1]}; ckpt_1 holds {rows} "
               f"env rows, generator states {gens}; ranks 1.. wrote "
               f"{[rep['writes'] for rep in reports[1:]]}; the resumed "
               f"ckpt_2 differs from the first in {differ[:5]}")
    calls = [i["collectives"] for rep in reports for i in rep["iterations"]]
    if (digests[0] != digests[1] or digests[0][2] != digests[0][1]
            or launches != [24 * env_decimation()] * len(launches)
            or calls != [{"all_reduce": 36, "broadcast": 0, "other": 0}]
            * len(calls)
            or any(rep["writes"] for rep in reports[1:])
            or not reports[0]["writes"] or rows != N_ENVS
            or set(gens.values()) != {(DIST_RANKS, gens["env"][1])}
            or differ):
        raise RuntimeError("the 2-process run disagrees across ranks, "
                           "missed the kernel or did not resume")
    return sum(launches)


def train_dr_phase(logdir, flat_dir, dev) -> int:
    """train-dr (module docstring); returns its pgs_bj launches."""
    import torch

    from cat_tpu_torch import train
    from cat_tpu_torch.ops import pgs
    from cat_tpu_torch.rl import checkpoint
    from cat_tpu_torch.tasks import solo12_flat

    phase = "train-dr"
    launches, _ = train_phase(
        phase, train_argv("Solo12-CaT-Flat-v0", logdir, 1, "--run_name",
                          "dr", "--env_override", *DR_OVERRIDES),
        pgs.KERNEL, train, 1)
    off = checkpoint.load(os.path.join(flat_dir, "dr", "ckpt_final"))[
        "env"]["com_offset"]
    dr_env = solo12_flat.make_env(N_ENVS, overrides=DR_OVERRIDES,
                                  device=dev)
    base = dr_env.model.body_names.index("base_link")
    rows_hit = sorted(set(off.abs().sum(-1).nonzero()[:, 1].tolist()))
    distinct = len(torch.unique(off[:, base], dim=0))
    qpos = []
    for e in (dr_env, solo12_flat.make_env(N_ENVS, device=dev)):
        es_dr = e.init(torch.Generator(device=dev).manual_seed(1), N_ENVS)
        step_gen = torch.Generator(device=dev).manual_seed(2)
        zero = torch.zeros(N_ENVS, e.num_actions, device=dev)
        for _ in range(5):
            es_dr = e.step(es_dr, zero, step_gen)[0]
        qpos.append(es_dr.sim.qpos)
    dq = (qpos[0] - qpos[1]).abs().max().item()
    log(phase, f"com_offset {tuple(off.shape)}, |max| "
               f"{off.abs().max().item():.4f}, non-zero on body rows "
               f"{rows_hit} (base_link is {base}), {distinct} distinct "
               f"base offsets; qpos after 5 control steps differs from "
               f"the env without the event by {dq:.4g} (gate > 1e-5)")
    if (tuple(off.shape) != (N_ENVS, dr_env.model.nbody, 3)
            or off.abs().max().item() > 0.05 or rows_hit != [base]
            or distinct < N_ENVS // 2 or not dq > 1e-5
            or not all(bool(torch.isfinite(q).all()) for q in qpos)):
        raise RuntimeError("the CoM event is missing, out of range or "
                           "changes nothing")
    return launches


def go2_problem(dev, kind):
    """Contact problems of Go2 (28 contacts, 18 dofs) at N_ENVS, captured
    after 5 control steps: ``kind`` "env" from its flat env under random
    actions (the block-Jacobi solve's), "raw" from the raw engine (GS-5)
    dropped from the default pose on flat ground. Returns (operands,
    kwargs)."""
    import torch

    from cat_tpu_torch.models.go2 import GO2_KD, GO2_KP, go2_model
    from cat_tpu_torch.sim import engine
    from cat_tpu_torch.tasks import go2_flat

    gen = torch.Generator(device=dev).manual_seed(2)
    if kind == "env":
        env = go2_flat.make_env(N_ENVS, device=dev)
        es = env.init(gen, N_ENVS)
        for _ in range(5):
            es = env.step(es, 0.3 * torch.randn(N_ENVS, 12, generator=gen,
                                                device=dev), gen)[0]
        eng, s, mu = env.engine, es.sim, es.mu
        target = env.default_joint_pos_task[env.m2t].expand(N_ENVS, 12)
    else:
        model = go2_model()
        eng = engine.make_batched_step(
            model, engine.EngineParams(kp=GO2_KP, kd=GO2_KD), device=dev)
        s = engine.make_batched_init(model, N_ENVS, dev)
        target = torch.as_tensor(model.default_qpos_joints,
                                 dtype=torch.float32,
                                 device=dev).expand(N_ENVS, 12)
        mu = torch.ones(N_ENVS, device=dev)
        for _ in range(5):
            s = eng(s, target, mu)
    _, ops = eng.contact_problem(s, target, mu)
    return tuple(t.contiguous() for t in ops), eng.pgs_kwargs


def graph_configs(dev):
    """graph phase: (name, make) of each engine configuration; ``make()``
    returns (engine, state, targets (GRAPH_STEPS, n, nj), mu, com_offset
    or None), the state in contact, the targets about the default pose."""
    import torch

    from cat_tpu_torch.models.go2 import GO2_KD, GO2_KP, go2_model
    from cat_tpu_torch.sim import engine
    from cat_tpu_torch.tasks import go2_flat, solo12_flat

    gen = torch.Generator(device=dev).manual_seed(5)

    def about(default, n, nj):
        return (torch.as_tensor(default, dtype=torch.float32, device=dev)
                + 0.3 * torch.randn(GRAPH_STEPS, n, nj, generator=gen,
                                    device=dev))

    def env_engine(make, n, overrides=()):
        env = make(n, overrides=overrides, device=dev)
        es = env.init(gen, n)
        com = (es.com_offset if env.cfg.events.com_displacement > 0.0
               else None)
        return (env.engine, es.sim, about(env.model.default_qpos_joints, n,
                                          env.model.nj), es.mu, com)

    def rough():
        eng, s, target, mu, _ = raw_engine_on_rough(dev)
        return eng, s, about(target[0], N_ENVS, target.shape[1]), mu, None

    def go2_raw():
        model = go2_model()
        eng = engine.make_batched_step(
            model, engine.EngineParams(kp=GO2_KP, kd=GO2_KD), device=dev)
        return (eng, engine.make_batched_init(model, N_ENVS, dev),
                about(model.default_qpos_joints, N_ENVS, model.nj),
                torch.ones(N_ENVS, device=dev), None)

    def box():
        from cat_tpu_torch.models.box import (box_model, on_slope_qpos,
                                              slope_terrain)

        model = box_model()
        eng = engine.make_batched_step(model, engine.EngineParams(),
                                       terrain=slope_terrain(25.0),
                                       device=dev)
        s = engine.make_batched_init(model, N_ENVS, dev)._replace(
            qpos=torch.from_numpy(on_slope_qpos(25.0, N_ENVS)).to(dev))
        return (eng, s, torch.zeros(GRAPH_STEPS, N_ENVS, 0, device=dev),
                torch.linspace(1e-3, 1.0, N_ENVS, device=dev), None)

    return (
        ("flat-bj", lambda: env_engine(solo12_flat.make_env, N_ENVS)),
        ("flat-bj-256", lambda: env_engine(solo12_flat.make_env,
                                           PROBE_ENVS)),
        ("flat-bj-com", lambda: env_engine(solo12_flat.make_env, N_ENVS,
                                           DR_OVERRIDES)),
        ("rough-gs", rough),
        ("go2-bj", lambda: env_engine(go2_flat.make_env, N_ENVS)),
        ("go2-gs", go2_raw),
        ("box-gs", box),
    )


def graph_phase(dev, bj, gs, smi):
    """graph (module docstring). Adds the launches to the kernels' rows."""
    import torch

    from cat_tpu_torch.ops import pgs
    from cat_tpu_torch.sim import engine

    phase = "graph"

    def bits(t):
        return t.view(torch.uint8) if t.dtype == torch.bool else t.view(
            torch.int32)

    def differ(a, b):
        return [f for f, x, y in zip(engine.SimState._fields, a, b)
                if not torch.equal(bits(x), bits(y))]

    def timed(step, s, targets, mu, com):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states = []
        for k in range(GRAPH_STEPS):
            s = step(s, targets[k], mu, com)
            states.append(s)
        torch.cuda.synchronize()
        return states, (time.perf_counter() - t0) / GRAPH_STEPS * 1e3

    rows = []
    for name, make in graph_configs(dev):
        eng, s0, targets, mu, com = make()
        row = bj if eng.solve is pgs.pgs_bj else gs
        kernel = pgs.KERNEL if row is bj else pgs.GS_KERNEL
        kernel.launches = 0
        eng(s0, targets[0], mu, com)              # the warm-up, eager
        eager, eager_ms = timed(eng._eager, s0, targets, mu, com)
        graphed, _ = timed(eng, s0, targets, mu, com)   # capture, replays
        kept = [engine.SimState(*(t.clone() for t in s)) for s in graphed]
        more, graph_ms = timed(eng, graphed[-1], targets, mu, com)
        bad = {k: differ(a, b) for k, (a, b) in enumerate(zip(eager, graphed))
               if differ(a, b)}
        moved = [k for k, (a, b) in enumerate(zip(graphed, kept))
                 if differ(a, b)]
        row["launches"] += check_launches(
            f"{phase} {name}", kernel,
            (1 + 3 * GRAPH_STEPS) * eng.params.decimation)
        finite = all(bool(torch.isfinite(t.float()).all()) for t in more[-1])
        n = s0.qpos.shape[0]
        log(phase, f"{name}: {n} envs, {eng.solve.__name__}; graphed vs "
                   f"eager over {GRAPH_STEPS} control steps: fields that "
                   f"differ in any bit {bad or 'none'}; returned states "
                   f"changed by later replays {moved or 'none'}; finite "
                   f"{finite}; eager {eager_ms:.3f} ms, graphed "
                   f"{graph_ms:.3f} ms a control step "
                   f"({eager_ms / graph_ms:.2f}x)")
        if bad or moved or not finite or len(eng.graphs) != 1:
            raise RuntimeError(f"the graphed control step ({name}) is not "
                               "the eager one bit for bit")
        rows.append(f"{name} {eager_ms:.3f} / {graph_ms:.3f}")
        del eng, s0, eager, graphed, kept, more
    log(phase, f"eager / graphed ms a control step: {'; '.join(rows)} "
               f"(host clock over {GRAPH_STEPS} synchronised steps; {smi})")


def load_actor(path, dev):
    """The network of a policy bundle (``policy_params.npz``) on the card,
    and its observation normaliser's mean and variance. Fails unless the
    bundle fills every parameter of the actor."""
    import numpy as np

    from cat_tpu_torch.rl.convert import actor_from_bundle
    from cat_tpu_torch.rl.networks import ActorCritic

    sd, obs_mean, obs_var = actor_from_bundle(dict(np.load(path)))
    net = ActorCritic(45, 12).to(dev)
    res = net.load_state_dict(sd, strict=False)
    if res.unexpected_keys or any(not k.startswith("critic.")
                                  for k in res.missing_keys):
        raise RuntimeError(f"policy bundle {path} does not fit the actor: "
                           f"{res}")
    return net, obs_mean.to(dev), obs_var.to(dev)


def play_bundle(phase, env, net, obs_mean, obs_var):
    """PLAY_STEPS control steps (``play.rollout``) of a bundle's actor, the
    mean action, from a fresh state of ``env``, with pgs_bj's count set to
    0 before and checked after. Returns (launches, share of envs that
    never fell, mean step of an env's first fall with PLAY_STEPS for none,
    mean forward velocity over the second half, the last observation)."""
    import torch

    from cat_tpu_torch.ops import pgs
    from cat_tpu_torch.play import rollout

    obs_std = torch.sqrt(obs_var + 1e-8)
    gen = torch.Generator(device=obs_mean.device).manual_seed(1)
    es = env.init(gen, env.cfg.num_envs)
    pgs.KERNEL.launches = 0
    run = rollout(env, es, lambda obs: net.actor((obs - obs_mean) / obs_std),
                  PLAY_STEPS, gen)
    launches = check_launches(phase, pgs.KERNEL, PLAY_STEPS * env_decimation())
    # no episode times out in PLAY_STEPS steps, so a reset is a fall
    first = run["first_reset"]
    return (launches, (first == PLAY_STEPS).float().mean().item(),
            first.float().mean().item(),
            run["vx"][PLAY_STEPS // 2:].mean().item(), run["obs"])


def probe_phase(logdir, bj, gs):
    """The structure probe through its command line: every kernel against
    its plain version at each structure, the GS cross-check, the gate on
    the shipped structure. Adds its launches and worst errors to the rows."""
    import torch

    from cat_tpu_torch.ops import pgs
    from cat_tpu_torch.tools import pgs_structure_probe as probe

    phase = "probe"
    t0 = time.perf_counter()
    pgs.KERNEL.launches = pgs.GS_KERNEL.launches = 0
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        records = probe.main(["--num_envs", str(PROBE_ENVS), "--device",
                              "cuda", "--out",
                              os.path.join(logdir, "probe.json")])
    for line in printed.getvalue().splitlines():
        log(phase, line)
    captures = len(probe.CAPTURE_STEPS)
    serial = sum(1 for r in records if r["n_blocks"] == 0)
    # the capture's rollout (its control steps) and one solve a structure
    # and capture
    bj["launches"] += check_launches(
        phase, pgs.KERNEL, max(probe.CAPTURE_STEPS) * env_decimation()
        + len(probe.VARIANTS) * captures)
    gs["launches"] += check_launches(phase, pgs.GS_KERNEL, serial * captures)
    bad = probe.disagreements(records)
    bj["max_abs_err"] = max([bj["max_abs_err"]]
                            + [r["kernel_max_abs_err"] for r in records])
    gs["max_abs_err"] = max([gs["max_abs_err"]]
                            + [r["gs_max_abs_err"] for r in records
                               if r["n_blocks"] == 0])
    cross = max(r["gs_vs_bj_max_abs_err"] for r in records
                if r["n_blocks"] == 0)
    shipped, = [r for r in records if (r["n_blocks"], r["omega"],
                                       r["iterations"]) == (4, 0.9, 6)]
    ref, factor = PROBE_IMP_ERR
    gate = {"imp_err": (shipped["imp_err"], ref, ref * factor)}
    gate["vn_excess_max"] = (shipped["vn_excess_max"], PROBE_VN_EXCESS,
                             PROBE_VN_EXCESS)
    torch.cuda.synchronize()
    log(phase, f"{len(records)} structures x {captures} captures at N="
        f"{PROBE_ENVS} in {time.perf_counter() - t0:.1f} s: {bad} entries "
        f"outside the kernel tolerance; pgs_bj vs plain max abs err "
        f"{max(r['kernel_max_abs_err'] for r in records):.3g}; pgs_gs vs "
        f"pgs_bj at 36 single blocks {cross:.3g}; shipped bj:4:0.9:6 "
        + ", ".join(f"{k} {v:.4f} (reference {ref}, gate <= {lim:.4f})"
                    for k, (v, ref, lim) in gate.items()))
    if bad:
        raise RuntimeError("a kernel disagrees with its plain version at a "
                           "solve structure of the probe")
    if not all(v <= lim for v, _, lim in gate.values()):
        raise RuntimeError("the shipped structure converges worse than the "
                           "reference's reading allows")


def drill_phase(logdir):
    """The preemption drill: SIGKILL after a checkpoint, resume, no gap."""
    from cat_tpu_torch.tools import resume_drill

    phase = "drill"
    t0 = time.perf_counter()
    argv = [f"--{k}={v}" for k, v in DRILL.items()]
    res = resume_drill.main(argv + [
        "--device", "cuda", "--logdir", os.path.join(logdir, "drill"),
        "--out", os.path.join(logdir, "drill.json")])
    log(phase, f"{json.dumps(res)} in {time.perf_counter() - t0:.1f} s")
    if not res["pass"]:
        raise RuntimeError("the resumed run left a gap or did not follow the "
                           "killed one")


def cstr_phase(dev) -> int:
    """The flat env with the two terms its recipe leaves out, 24 control
    steps; the reference's two-argument make_batched_init on the card.
    Returns the pgs_bj launches."""
    import numpy as np
    import torch

    from cat_tpu_torch.envs import constraints
    from cat_tpu_torch.envs.cat import ConstraintTerm
    from cat_tpu_torch.envs.env import CatEnv, EnvCfg
    from cat_tpu_torch.models.solo12 import (
        SOLO12_ACTUATED_JOINT_ORDER, SOLO12_KD, SOLO12_KP, solo12_model)
    from cat_tpu_torch.ops import pgs
    from cat_tpu_torch.sim import engine
    from cat_tpu_torch.tasks import solo12_flat

    phase = "cstr"
    t0 = time.perf_counter()
    model = solo12_model()
    joints = np.arange(model.nj)
    base = solo12_flat.solo12_constraint_terms(model)
    extra = [ConstraintTerm(name, getattr(constraints, name),
                            dict(params, joint_ids=joints)
                            if name == "joint_range" else params, max_p, cur)
             for name, params, max_p, cur in CSTR_TERMS]
    env = CatEnv(model, EnvCfg(num_envs=N_ENVS, kp=SOLO12_KP, kd=SOLO12_KD),
                 base + extra, SOLO12_ACTUATED_JOINT_ORDER, device=dev)
    cset = env.cset
    names = [t.name for t in cset.terms]
    layout = cset.slices[-2:]
    log(phase, f"{len(names)} terms, {cset.total_cols} columns; "
               f"{names[-2]} {layout[0]}, {names[-1]} {layout[1]}")
    if (names[-2:] != [n for n, *_ in CSTR_TERMS]
            or layout != [(78, 78 + model.nj), (78 + model.nj, 79 + model.nj)]
            or cset.total_cols != 79 + model.nj):
        raise RuntimeError("the ConstraintSet's layout lacks the new terms' "
                           "columns")
    gen = torch.Generator(device=dev).manual_seed(4)
    es = env.init(gen, N_ENVS)
    pgs.KERNEL.launches = 0
    outs = []
    hit = torch.zeros(N_ENVS, 2, dtype=torch.bool, device=dev)
    for _ in range(24):
        act = 2.0 * torch.rand(N_ENVS, model.nj, generator=gen,
                               device=dev) - 1.0
        es, _, reward, dones, _ = env.step(es, act, gen)
        outs += [reward, dones]
        hit |= es.episode_viol[:, -2:] > 0
    launches = check_launches(phase, pgs.KERNEL, 24 * env_decimation())
    finite = all(bool(torch.isfinite(t).all()) for t in outs + [
        es.running_max, es.episode_prob, es.max_p])
    hit = hit.float().mean(0).tolist()
    rmax = es.running_max[78:].tolist()
    log(phase, f"24 control steps x {N_ENVS} envs: CaT transform finite "
               f"{finite}; share of envs that violated {names[-2]} / "
               f"{names[-1]} {hit[0]:.3f} / {hit[1]:.3f}; running maxes of "
               f"their columns {min(rmax):.4g}-{max(rmax):.4g}")
    if not finite or not all(h > 0 for h in hit):
        raise RuntimeError("the CaT transform is not finite or a new term "
                           "never fires")
    s = engine.make_batched_init(model, 8)
    one = engine.init_state(model, device=dev)
    same = all(bool((a == b.expand_as(a)).all()) for a, b in zip(s, one))
    log(phase, f"make_batched_init(model, 8): qpos {tuple(s.qpos.shape)} on "
               f"{s.qpos.device}, equal to init_state broadcast {same}; "
               f"{time.perf_counter() - t0:.1f} s")
    if s.qpos.device.type != "cuda" or not same:
        raise RuntimeError("the reference's make_batched_init call does not "
                           "land on the card")
    return launches


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
    import numpy as np

    from cat_tpu_torch import bench, measure, play, train
    from cat_tpu_torch.models.go2 import GO2_KD, GO2_KP, compile_go2, go2_model
    from cat_tpu_torch.rl import checkpoint
    from cat_tpu_torch.rl.export import export_policy
    from cat_tpu_torch.sim import engine, terrain
    from cat_tpu_torch.sim.model import RobotModel
    from cat_tpu_torch.tasks import go2_flat, solo12_flat

    dev = cat_tpu_torch.resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = measure.card_line()
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
        "go2": go2_problem(dev, "env"),
        "random": (random_problems(N_ENVS, model.ncand, model.nv, gen, dev),
                   kw),
        "box": (box_ops, dict(kw, contact_perm=perm, blocks=blocks)),
    }
    bj = dict(name="pgs_bj", source="cat_tpu_torch/ops/csrc/pgs_bj.cu",
              replaces="cat_tpu/ops/pgs_pallas.py:419")
    kernel_numbers(phase, bj, pgs.KERNEL, pgs.pgs_bj_reference, problems,
                   dense_counts(model, N_ENVS, kw["iterations"]),
                   table_words=lambda nc: nc + 2 * len(kw["blocks"]),
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
        "go2": go2_problem(dev, "raw"),
        "random": (random_problems(N_ENVS, model.ncand, model.nv, gen, dev),
                   dict(kw, row_dofs=None)),
        "box": (box_ops, box_gs_kw),
    }
    gs = dict(name="pgs_gs", source="cat_tpu_torch/ops/csrc/pgs_gs.cu",
              replaces="cat_tpu/ops/pgs_pallas.py:103")
    kernel_numbers(phase, gs, pgs.GS_KERNEL, pgs.pgs_gs_reference, problems,
                   dense_counts(model, N_ENVS, kw["iterations"],
                                active=physical[4]),
                   table_words=lambda nc: 3 * nc, plain_reps=3)
    del eng, s, physical, problems, box_ops
    bj["launches"] = gs["launches"] = 0

    graph_phase(dev, bj, gs, smi)

    with tempfile.TemporaryDirectory() as logdir:
        phase = "train"
        launches, _ = train_phase(
            phase, train_argv("Solo12-CaT-Flat-v0", logdir, PPO_ITERS,
                              "--run_name", "flat", "--override",
                              "save_interval=1"),
            pgs.KERNEL, train, PPO_ITERS)
        bj["launches"] += launches
        flat_dir = os.path.join(logdir, "clean_rl", "Solo12-CaT-Flat-v0")

        bj["launches"] += train_nccl_phase(logdir, flat_dir)
        bj["launches"] += train_dist_phase(logdir, flat_dir)
        bj["launches"] += train_dr_phase(logdir, flat_dir, dev)

        phase = "engine-gs"
        eng, s, target, mu, spots = raw_engine_on_rough(dev)
        pgs.GS_KERNEL.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RAW_STEPS):
            s = eng(s, target, mu)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / RAW_STEPS * 1e3
        gs["launches"] += check_launches(phase, pgs.GS_KERNEL,
                                         RAW_STEPS * eng.params.decimation)
        finite = all(bool(torch.isfinite(t.float()).all()) for t in s)
        rel_z = s.qpos[:, 2] - terrain.height_at(eng.terrain, s.qpos[:, 0:2])
        drift = torch.linalg.vector_norm(s.qpos[:, 0:2] - spots, dim=1)
        up = standing_on_pads(eng, s, spots)
        log(phase, f"{RAW_STEPS} control steps x {N_ENVS} envs: "
                   f"{step_ms:.2f} ms a control step; z - h in "
                   f"[{rel_z.min():.4f}, {rel_z.max():.4f}] m, drift max "
                   f"{drift.max():.4f} m; {up} of {N_ENVS} standing")
        if not finite or up != N_ENVS:
            raise RuntimeError("robots fell, tunnelled or drifted on the pads")
        del eng, s

        phase = "engine-go2"
        model = compile_go2()
        with open(repo / "cat_tpu_torch" / "models" / "go2_model.json") as f:
            committed = RobotModel.from_json(f.read())
        if model.to_json() != committed.to_json():
            raise RuntimeError("the port's compile of go2.urdf is not the "
                               "committed go2_model.json byte for byte")
        bad = [f.name for f in dataclasses.fields(RobotModel)
               if not np.array_equal(getattr(model, f.name),
                                     getattr(committed, f.name))]
        if bad:
            raise RuntimeError(f"compiled Go2 fields differ from the "
                               f"committed JSON: {bad}")
        log(phase, f"go2.urdf compiled by the port: to_json() equals the "
                   f"committed go2_model.json's ({len(model.to_json())} "
                   f"bytes), every field equal")
        eng = engine.make_batched_step(
            model, engine.EngineParams(kp=GO2_KP, kd=GO2_KD), device=dev)
        s = engine.make_batched_init(model, N_ENVS, dev)
        target = torch.as_tensor(model.default_qpos_joints,
                                 dtype=torch.float32,
                                 device=dev).expand(N_ENVS, model.nj)
        mu = torch.ones(N_ENVS, device=dev)
        pgs.GS_KERNEL.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GO2_SETTLE):
            s = eng(s, target, mu)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / GO2_SETTLE * 1e3
        gs["launches"] += check_launches(phase, pgs.GS_KERNEL,
                                         GO2_SETTLE * eng.params.decimation)
        finite = all(bool(torch.isfinite(t.float()).all()) for t in s)
        z = s.qpos[:, 2]
        tilt = 2 * torch.sqrt(s.qpos[:, 4] ** 2 + s.qpos[:, 5] ** 2)
        qvel_max = s.qvel.abs().amax(dim=1)
        weight = float(model.mass.sum()) * 9.81
        fz = s.forces.reshape(N_ENVS, model.nreport, 3)[:, :, 2].sum(dim=1)
        standing = int(((z > 0.2) & (z < 0.45) & (tilt < 0.25)
                        & (qvel_max < 0.6)).sum())
        carried = int(((fz - weight).abs() <= 0.25 * weight).sum())
        log(phase, f"{GO2_SETTLE} control steps x {N_ENVS} Go2s: "
                   f"{step_ms:.2f} ms a control step; z in [{z.min():.4f}, "
                   f"{z.max():.4f}] m, tilt max {tilt.max():.4f}, |qvel| max "
                   f"{qvel_max.max():.4f}; summed contact force in "
                   f"[{fz.min():.2f}, {fz.max():.2f}] N (weight "
                   f"{weight:.2f} N); {standing} standing and {carried} "
                   f"carried of {N_ENVS}")
        if not finite or standing != N_ENVS or carried != N_ENVS:
            raise RuntimeError("Go2s fell, sank or were not carried")
        del eng, s

        phase = "train-go2"
        go2_argv = train_argv("Go2-CaT-Flat-v0", logdir, PPO_ITERS, "--agent",
                              "rl_games", "--run_name", "go2", "--override",
                              "save_interval=1")
        launches, history = train_phase(phase, go2_argv, pgs.KERNEL, train,
                                        PPO_ITERS)
        bj["launches"] += launches
        run_dir = os.path.join(logdir, "rl_games", "Go2-CaT-Flat-v0", "go2")
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        with gzip.open(repo / "runs" / "go2_r4" / "metrics.jsonl.gz", "rt") as f:
            ref_keys = set(json.loads(f.readline()))
        missing = sorted(set().union(*(ref_keys - set(r) for r in lines)))
        log(phase, f"metrics.jsonl: {len(lines)} lines, steps "
                   f"{[r['step'] for r in lines]}, {len(ref_keys)} keys of the "
                   f"JAX package's Go2 log, missing {missing}; "
                   f"{sorted(os.listdir(run_dir))}")
        if len(lines) != PPO_ITERS or missing:
            raise RuntimeError("metrics.jsonl lacks lines or keys")

        phase = "resume"
        ckpt = os.path.join(run_dir, f"ckpt_{PPO_ITERS}.pt")
        fresh = train.Trainer(train.parse_args(go2_argv))
        fresh.restore(ckpt)
        saved = checkpoint.load(ckpt)
        differ = checkpoint.mismatches(
            saved, checkpoint.state_dict(fresh.ppo, fresh.es, fresh.generators))
        lr_saved = float(fresh.ppo.lr)
        log(phase, f"{ckpt}: {os.path.getsize(ckpt) / 2**20:.1f} MiB, "
                   f"{len(checkpoint.flatten(saved))} leaves; {len(differ)} "
                   f"differ from the restored state {differ[:5]}; learning "
                   f"rate {lr_saved:.6g} restored, {history[-1]['Train/learning_rate']:.6g} "
                   f"logged at iteration {PPO_ITERS}")
        if differ or lr_saved != history[-1]["Train/learning_rate"]:
            raise RuntimeError("the restored state is not the saved one")
        pgs.KERNEL.launches = 0
        t0 = time.perf_counter()
        metrics = fresh.train_iteration()
        metrics["Perf/iter_seconds"] = time.perf_counter() - t0
        metrics["Perf/env_steps_per_sec"] = (
            24 * N_ENVS / metrics["Perf/iter_seconds"])
        bj["launches"] += check_launches(phase, pgs.KERNEL,
                                         24 * env_decimation())
        check_finite(phase, [metrics])
        if fresh.ppo.iteration != PPO_ITERS + 1:
            raise RuntimeError("the resumed run did not go on from its iteration")
        del fresh

        phase = "play-run"
        pgs.KERNEL.launches = 0
        play.main(["--run_dir", run_dir, "--steps", str(PLAY_STEPS),
                   "--num_envs", str(N_ENVS), "--device", "cuda"])
        bj["launches"] += check_launches(phase, pgs.KERNEL,
                                         PLAY_STEPS * env_decimation())
        files = sorted(os.listdir(run_dir))
        traj = np.load(os.path.join(run_dir, "play_traj.npz"))
        finite = all(np.isfinite(traj[k]).all() for k in ("qpos", "reward"))
        net, obs_mean, obs_var = load_actor(
            os.path.join(run_dir, "policy_params.npz"), dev)
        policy = torch.jit.load(os.path.join(run_dir, "policy.pt"),
                                map_location=dev)
        obs_std = torch.sqrt(obs_var + 1e-8)
        obs = obs_mean + obs_std * torch.randn(
            N_ENVS, 45, device=dev,
            generator=torch.Generator(device=dev).manual_seed(3))
        with torch.no_grad():
            err = (policy(obs) - net.actor((obs - obs_mean) / obs_std)).abs()
        log(phase, f"play.py on {run_dir}: play_traj.npz qpos "
                   f"{traj['qpos'].shape}, reward {traj['reward'].shape}, "
                   f"finite {finite}, mean reward/step "
                   f"{traj['reward'].mean():.5f}; policy.pt vs the exported "
                   f"bundle's actor on {N_ENVS} observations: max abs err "
                   f"{err.max().item():.3g} (atol 1e-5); {files}")
        missing = {"policy_params.npz", "policy.pt", "policy.pt2",
                   "play_traj.npz"} - set(files)
        if missing or not finite or traj["qpos"].shape != (
                PLAY_STEPS, N_ENVS, go2_model().nq):
            raise RuntimeError(f"play.py left no or a wrong trajectory, or "
                               f"no {sorted(missing)}")
        if not err.max().item() <= 1e-5:
            raise RuntimeError("play.py's TorchScript export disagrees with "
                               "its policy_params.npz")

        phase = "presets"
        for agent in ("skrl", "clean_rl"):
            launches, _ = train_phase(
                f"{phase} {agent}",
                train_argv("Solo12-CaT-Flat-v0", logdir, 1, "--agent", agent,
                           "--run_name", agent), pgs.KERNEL, train, 1)
            bj["launches"] += launches

        phase = "train-rough"
        launches, history = train_phase(
            phase, train_argv("Solo12-CaT-Rough-v0", logdir, PPO_ITERS),
            pgs.KERNEL, train, PPO_ITERS)
        bj["launches"] += launches
        levels = [m["Curriculum/terrain_levels"] for m in history
                  if "Curriculum/terrain_levels" in m]
        log(phase, f"Curriculum/terrain_levels {levels}")
        if len(levels) != len(history) or not all(0.0 <= v <= 9.0
                                                   for v in levels):
            raise RuntimeError("Curriculum/terrain_levels missing or out of "
                               "[0, 9]")

        phase = "play"
        net, obs_mean, obs_var = load_actor(
            repo / "runs" / "solo12_flat_2000it" / "policy_params.npz", dev)
        env = solo12_flat.make_env(N_ENVS, overrides=PLAY_OVERRIDES,
                                   device=dev)
        launches, survive, first, vx_mean, _ = play_bundle(
            phase, env, net, obs_mean, obs_var)
        bj["launches"] += launches
        log(phase, f"{survive * 100:.1f}% of {N_ENVS} envs never hit a hard "
                   f"termination in {PLAY_STEPS} steps (first at step "
                   f"{first:.1f} on average); mean forward velocity "
                   f"{vx_mean:.3f} m/s over the last {PLAY_STEPS // 2} steps "
                   f"(command {PLAY_VX} m/s)")
        if not survive >= 0.5:
            raise RuntimeError("the JAX-trained policy falls in the port's "
                               "physics")
        if not vx_mean >= 0.5 * PLAY_VX:
            raise RuntimeError("the JAX-trained policy does not walk in the "
                               "port")

        phase = "play-go2"
        net, obs_mean, obs_var = load_actor(
            repo / "runs" / "go2_r4" / "policy_params.npz", dev)
        env = go2_flat.make_env(N_ENVS, overrides=PLAY_OVERRIDES, device=dev)
        launches, survive, first, vx_mean, obs = play_bundle(
            phase, env, net, obs_mean, obs_var)
        bj["launches"] += launches
        log(phase, f"{survive * 100:.1f}% of {N_ENVS} Go2 envs never hit a "
                   f"hard termination in {PLAY_STEPS} steps; first at step "
                   f"{first:.1f} on average (gate >= {GO2_FIRST_FALL_MIN:.2f});"
                   f" mean forward velocity {vx_mean:.3f} m/s over the last "
                   f"{PLAY_STEPS // 2} steps (gate >= {GO2_VX_MIN:.4f}, "
                   f"command {PLAY_VX} m/s)")
        if not (first >= GO2_FIRST_FALL_MIN and vx_mean >= GO2_VX_MIN):
            raise RuntimeError("the JAX-trained Go2 policy falls sooner or "
                               "walks slower in the port than the gate")
        export_dir = os.path.join(logdir, "export")
        export_policy(net, obs_mean, obs_var, export_dir)
        policy = torch.jit.load(os.path.join(export_dir, "policy.pt"),
                                map_location=dev)
        with torch.no_grad():
            err = (policy(obs) - net.actor(
                (obs - obs_mean) / torch.sqrt(obs_var + 1e-8))).abs()
        log(phase, f"policy.pt on the card vs the actor on {obs.shape[0]} "
                   f"observations: max abs err {err.max().item():.3g} "
                   f"(atol 1e-5); {sorted(os.listdir(export_dir))}")
        if not err.max().item() <= 1e-5:
            raise RuntimeError("the exported TorchScript policy disagrees "
                               "with the actor")

    phase = "bench"
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        # the flat cell at 1 timed iteration, the engine cell at 1 window
        results = [bench.main(["--cell", bench.FLAT, "--iters", "1",
                               "--no-trace"]),
                   bench.main(["--cell", bench.ENGINE, "--iters",
                               str(bench.WINDOW), "--no-trace"])]
    for line in printed.getvalue().splitlines():
        if not line.startswith("{"):                  # not its JSON lines
            log(phase, line)
    cells = {r["cells"][0]["workload"]: r["cells"][0] for r in results}
    flat, eng_cell = cells[bench.FLAT]["counts"], cells[bench.ENGINE]["counts"]
    expected = {
        "pgs_bj": ((flat["warmup_iterations"] + flat["timed_iterations"])
                   * 24 * env_decimation()),
        "pgs_gs": ((eng_cell["warmup_steps"] + eng_cell["timed_steps"])
                   * env_decimation())}
    got = {"pgs_bj": flat["pgs_bj_launches"],
           "pgs_gs": eng_cell["pgs_gs_launches"]}
    correct = all(c["correct"] for c in cells.values())
    log(phase, f"both cells, 1 timed iteration / {bench.WINDOW} control "
               f"steps, no trace: correct {correct}; launches {got} "
               f"(expected {expected})")
    if not correct or got != expected:
        raise RuntimeError("the bench's cells are not correct or missed "
                           "their kernels")
    bj["launches"] += got["pgs_bj"]
    gs["launches"] += got["pgs_gs"]

    with tempfile.TemporaryDirectory() as logdir:
        probe_phase(logdir, bj, gs)
        drill_phase(logdir)
    bj["launches"] += cstr_phase(dev)

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
