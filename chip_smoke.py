#!/usr/bin/env python3
"""Drive the PyTorch port (cat_tpu_torch) on one CUDA card and check it.

  python3 chip_smoke.py

Phases, each printed with its elapsed seconds:
  device: the card, its power limit, the torch and CUDA versions;
  build: the eight kernels, ops/csrc/pgs_bj.cu, pgs_gs.cu, substep_dyn.cu,
     contact_rows.cu, substep_post.cu, env_terms.cu, env_update.cu and
     env_obs.cu, and the phase-clock builds of the three substep kernels
     (-DSUBSTEP_PHASE_CLOCKS, libraries of their own), one plain nvcc
     each, started together, with ptxas's registers, stack and spills;
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
  kernel-dyn: the substep's two kernels (ops/substep.py: substep_dynamics,
     contact_rows) against their plain versions (sim/engine.py
     dynamics_stage, contact_stage; the contact kernel fed the plain
     dynamics' outputs) on states captured on the card at N = 4096: the
     flat env (Solo12), the same with random CoM offsets and in fast
     motion, the raw engine on the production rough terrain, Go2's env
     and the box on its slope;
     every output within ``measure.STAGE_TOL`` (on a heightfield without
     the contacts whose normal a rounding may switch, at most 2%:
     ``measure.compare_stages``, the bench's check too), the max abs and
     relative error of each printed; on each state one launch of
     each kernel's phase-clock build, the median cycles an env of each
     phase; then each kernel's time on the flat and rough states as
     CUDA-graph replays, the plain stages' replayed and eager, the bound
     (``measure.substep_counts``) and its share; last each kernel's ptxas
     registers and spills, and at Solo12's shape its shared memory a
     block and blocks an SM: 4096 envs must run in one wave, unspilled;
  kernel-post: the post stage's kernel (ops/substep.py substep_post)
     against its plain version (sim/engine.py post_stage) on the same
     states, each with its own contact problem solved by its engine's
     solve, and on the three contrived inputs of ``measure.post_contrived``
     made from it (every joint exactly on a limit; each foot's force
     within 1e-3 N of the contact threshold; no impulse): every output
     within ``measure.compare_post``, the largest error of each printed,
     and each decision (a joint clamped, a foot in contact) that came out
     otherwise with its margin in float32 spacings (at most 4); on each
     state one launch of the kernel's phase-clock build, the median cycles
     an env of each phase, then the kernel's time as CUDA-graph replays,
     the plain stage's replayed and eager, and the bound of that state's
     impulses (``measure.post_counts``) and its share, beside the card's
     name and power limit; last its ptxas registers and spills (and its
     clock build's), its shared memory a block and blocks an SM at
     Solo12's shape: 4096 envs must run in one wave, unspilled;
  kernel-env: the env step's three kernels (ops/env_step.py env_terms,
     env_update, env_obs) against their plain stages (envs/env.py
     terms_stage, update_stage, obs_stage) on the inputs each plain stage
     gets in one env step (``measure.env_stage_pairs`` records them from
     ``_step_eager``), on states of the flat, rough (the production
     terrain) and Go2 envs at N = 4096 after 30 env steps of a
     JAX-trained policy (``measure.env_inputs``): every output within
     ``measure.compare_env``, the largest error of each printed, each
     decision that came out otherwise with its margin in float32
     spacings (at most 4); two launches from one input equal bit for
     bit; each kernel's time as CUDA-graph replays (50), the plain
     stage's replayed, the bound of ``measure.env_counts`` (each terrain
     cell the step reads counted once) and its share, beside the card's
     name and power limit; last each kernel's ptxas registers and spills;
  graph: the control step's CUDA graph (``Engine.__call__`` on the card)
     against the eager substep loop (``Engine._eager``) in each engine
     configuration the port runs: the flat env's block-Jacobi engine at
     4096 and at 256 envs (the probe's N), with the CoM event's offsets,
     the raw engine (GS-5) on the production rough terrain, Go2's env
     (block-Jacobi, 28 contacts) and raw (GS-5) engines, and the box (the
     Cholesky M^-1) on its slope: after the warm-up call, 5 control steps
     from one state, graphed and eager, equal bit for bit; the returned
     states keep their values through 5 more replays; the contact kernel
     and both substep kernels launch 4 times every control step; the
     eager and graphed ms a control step; then the engine's "lanes" route
     (the substep's three kernels) against its "vmap" route (the plain
     stages and post_stage) from the first state: a substep's outputs
     within the stage tolerances and ``measure.compare_post``, one control
     step within qpos atol 2e-3, qvel atol 2e-2;
  train: ``cat_tpu_torch.train`` for Solo12-CaT-Flat-v0 at 4096 envs,
     2 PPO iterations, a checkpoint each; pgs_bj must launch 2 x 24 x 4
     times;
  train-graph: an iteration replays two CUDA graphs (``rl/ppo.py``
     ``rollout`` and ``learn``, through ``utils/graphs.py``); for
     Solo12-CaT-Flat-v0 (clean_rl, the linear rate), Solo12-CaT-Rough-v0
     (clean_rl) and Go2-CaT-Flat-v0 (rl_games, the per-minibatch
     adaptive rate) at 4096 envs, three trainers from one seed, one as
     it runs, one with its iteration launched from the host and each env
     step, draw and Adam step a replay of its own graph
     (``steps_trainer``), and one with its iteration launched from the
     host and those steps op by op (``eager_trainer``), 5 iterations each
     in turns: after every iteration the first two's env state,
     parameters, Adam's state, normalisers, generators' states and
     metrics equal the third's bit for bit; each kernel launches 96 times
     an iteration on each, each env kernel 24 times (and env_obs once a
     trainer, for its reset observation); the graphed trainer holds the
     iteration's two graphs and no env step graph, the steps trainer the
     draw's, the Adam step's and the env step's; the last iteration runs under
     torch.profiler: the host's runtime calls that put work on the card
     (kernel and graph launches, copies, sets), the card's events, busy
     seconds and idle share of that iteration; each side's iteration
     seconds and the median of iterations 3-4, beside the card's name
     and power limit;
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
     for bit (every tensor, the generators), and 3 more iterations run
     from the carried learning rate through the iteration's graphs (its
     warm-up, capture and a replay; 96 launches each, 24 of each env
     kernel), each equal bit for bit to the same checkpoint's iteration
     op by op;
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
  bench: ``cat_tpu_torch.bench`` (BENCHMARK.json's three cells) with 1
     timed iteration of each PPO cell (flat and rough) and 1 window of 20
     raw-engine control steps, no trace: every cell must be correct (its
     checks against the plain learner and physics references and of the
     substep kernels against the plain stages included), and each of the
     kernels it counts (the contact solve, substep_dynamics, contact_rows,
     substep_post) must launch once a substep of its warm-up and timed
     window: (3 + 1) x 96 in each PPO cell, (50 + 20) x 4 in the engine
     cell;
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
Every launch count (the eight kernels', ``substep.KERNELS``) is set to 0
just before its path and read just after (in the train-dist processes,
before each iteration); the substep's three kernels must launch once a
substep wherever the contact solve does (in the bench's windows as it
counts them, and at least as often in all: its checks after each window
add launches; in the probe the rollout's and, but for the post kernel,
one a capture); the env kernels' launches are counted in train-graph
and resume (one each an env step, and env_obs one a reset
observation). The
JSON line's launches are their sums over all paths and processes (the
drill's trainers, which the drill itself checks, excepted; the
comparisons of kernel-dyn, kernel-post, kernel-env and graph not
counted). The last lines are
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
ENV_STEPS = 30       # kernel-env: env steps of a policy before the state
# kernel-env: (label, task module, policy bundle under runs/) of each state
ENV_CASES = (("flat", "solo12_flat", "solo12_flat_2000it"),
             ("rough", "solo12_rough", "solo12_flat_2000it"),
             ("go2", "go2_flat", "go2_r4"))
# the JAX lines each env kernel is the counterpart of (it replaces no
# Pallas kernel)
ENV_REPLACES = {"env_terms": "cat_tpu/envs/env.py:514",
                "env_update": "cat_tpu/envs/env.py:538",
                "env_obs": "cat_tpu/envs/env.py:719"}
GRAPH_STEPS = 5      # graph: control steps held bit for bit, then timed
# train-graph: the tasks (and agent presets) whose iterations are held
# graphed against eager, and how many iterations, the last one profiled
TRAIN_GRAPH = (("Solo12-CaT-Flat-v0", "clean_rl"),
               ("Solo12-CaT-Rough-v0", "clean_rl"),
               ("Go2-CaT-Flat-v0", "rl_games"))
TRAIN_GRAPH_ITERS = 5
RESUME_ITERS = 3     # resume: iterations after the restore (warm-up,
                     # capture, replay of the iteration's graphs)
# the runtime calls that put work on the card, as torch.profiler names them
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                 "cudaMemsetAsync")
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


# the substep and env kernels' rows of the JSON line (filled by main),
# whose launches add_launches adds up
SUBSTEP_ROWS: dict = {}


# the phase-clock builds of the substep kernels (made by substep_kernels)
CLOCK_KERNELS: tuple = ()


def substep_kernels(clocks=False):
    """(row name, wrapper) of the substep's three kernels
    (``substep.SUBSTEP_KERNELS``); with ``clocks``, wrappers of their
    phase-clock builds (never on a path)."""
    global CLOCK_KERNELS
    from cat_tpu_torch.ops import substep

    if not clocks:
        return substep.SUBSTEP_KERNELS
    if not CLOCK_KERNELS:
        CLOCK_KERNELS = tuple((name, type(kernel)(clocks=True))
                              for name, kernel in substep.SUBSTEP_KERNELS)
    return CLOCK_KERNELS


def zero_counts():
    """Sets every kernel's launch count to 0, just before a path."""
    from cat_tpu_torch.ops import substep

    for _, kernel in substep.KERNELS:
        kernel.launches = 0


def check_launches(phase, kernel, expected, substeps="same") -> int:
    """The launches of ``kernel`` since the counts were set to 0; fails
    unless they are ``expected``. Then the substep kernels' launches, which
    must be ``substeps`` each (one a substep: as many as the contact solve's
    unless given; None: not checked here), added to their rows."""
    import torch

    from cat_tpu_torch.ops import pgs

    torch.cuda.synchronize()
    launches = kernel.launches
    name = "pgs_bj" if kernel is pgs.KERNEL else "pgs_gs"
    log(phase, f"{name} launches {launches} (expected {expected})")
    if launches != expected:
        raise RuntimeError("the main path did not run through the kernel")
    if substeps is not None:
        add_substep_launches(phase, expected if substeps == "same"
                             else substeps)
    return launches


def add_launches(phase, name, kernel, expected, at_least=False):
    """Adds ``kernel``'s launches since the counts were set to 0 to its row
    ``name``; fails unless they are ``expected`` (or, with ``at_least``, no
    fewer)."""
    n = kernel.launches
    log(phase, f"{name} launches {n} (expected "
               f"{'at least ' if at_least else ''}{expected})")
    if n < expected if at_least else n != expected:
        raise RuntimeError(f"the main path did not run through {name}")
    if name in SUBSTEP_ROWS:
        SUBSTEP_ROWS[name]["launches"] += n


def add_substep_launches(phase, expected, at_least=False):
    """``add_launches`` of each substep kernel, all ``expected``."""
    for name, kernel in substep_kernels():
        add_launches(phase, name, kernel, expected, at_least)


def add_env_launches(phase, steps, observes=0):
    """``add_launches`` of each env kernel: ``steps`` env steps, and
    ``observes`` reset observations (env_obs alone)."""
    from cat_tpu_torch.ops import env_step

    for name, kernel in env_step.ENV_KERNELS:
        add_launches(phase, name, kernel,
                     steps + (observes if name == "env_obs" else 0))


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
    zero_counts()
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
        zero_counts()
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
            "launches": pgs.KERNEL.launches,
            "substep_launches": [k.launches for _, k in substep_kernels()],
            "collectives": calls.counts,
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
    substeps = [n for rep in reports for i in rep["iterations"]
                for n in i["substep_launches"]]
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
            or substeps != [24 * env_decimation()] * len(substeps)
            or calls != [{"all_reduce": 36, "broadcast": 0, "other": 0}]
            * len(calls)
            or any(rep["writes"] for rep in reports[1:])
            or not reports[0]["writes"] or rows != N_ENVS
            or set(gens.values()) != {(DIST_RANKS, gens["env"][1])}
            or differ):
        raise RuntimeError("the 2-process run disagrees across ranks, "
                           "missed the kernel or did not resume")
    log(phase, f"substep kernel launches an iteration and rank {substeps}")
    kinds = len(substep_kernels())
    for k, (name, _) in enumerate(substep_kernels()):
        SUBSTEP_ROWS[name]["launches"] += sum(substeps[k::kinds])
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


def substep_states(dev):
    """kernel-dyn: (name, engine, state, target, CoM offset or None) of
    each configuration on the card, its state captured from a run: the flat
    env (Solo12, N_ENVS, after 5 steps of random actions), the same with
    random CoM offsets on every body, the same in fast motion (velocities
    drawn as tests/_substep_cases.py's "solo12-fast": the base's linear in
    +-2 m/s, its angular in +-5 rad/s, the joints' in +-10 rad/s), the raw
    engine on the production rough terrain (after 5 control steps on the
    pads), Go2's env (after 5 steps), the box on its slope (after 10
    control steps)."""
    import torch

    from cat_tpu_torch.models.box import box_model, on_slope_qpos, slope_terrain
    from cat_tpu_torch.sim import engine
    from cat_tpu_torch.tasks import go2_flat, solo12_flat

    gen = torch.Generator(device=dev).manual_seed(6)

    def env_state(make):
        env = make(N_ENVS, device=dev)
        es = env.init(gen, N_ENVS)
        for _ in range(5):
            es = env.step(es, 0.3 * torch.randn(
                N_ENVS, env.model.nj, generator=gen, device=dev), gen)[0]
        target = env.default_joint_pos_task[env.m2t].expand(
            N_ENVS, env.model.nj).contiguous()
        return env.engine, es.sim, target

    eng, s, target = env_state(solo12_flat.make_env)
    com = 0.05 * (2.0 * torch.rand(N_ENVS, eng.mt.model.nbody, 3,
                                   generator=gen, device=dev) - 1.0)
    yield "flat", eng, s, target, None
    yield "flat-com", eng, s, target, com
    span = torch.tensor([2.0] * 3 + [5.0] * 3 + [10.0] * eng.mt.model.nj,
                        device=dev)
    fast = span * (2.0 * torch.rand(N_ENVS, eng.mt.model.nv, generator=gen,
                                    device=dev) - 1.0)
    yield "flat-fast", eng, s._replace(qvel=fast), target, None
    eng, s, target, mu, _ = raw_engine_on_rough(dev)
    for _ in range(5):
        s = eng(s, target, mu)
    yield "rough", eng, s, target.contiguous(), None
    yield ("go2",) + env_state(go2_flat.make_env) + (None,)
    model = box_model()
    eng = engine.make_batched_step(model, engine.EngineParams(),
                                   terrain=slope_terrain(25.0), device=dev)
    s = engine.make_batched_init(model, N_ENVS, dev)._replace(
        qpos=torch.from_numpy(on_slope_qpos(25.0, N_ENVS)).to(dev))
    target = torch.zeros(N_ENVS, 0, device=dev)
    mu = torch.linspace(1e-3, 1.0, N_ENVS, device=dev)
    for _ in range(10):
        s = eng(s, target, mu)
    yield "box", eng, s, target, None


def compare_stages(phase, label, mt, terrain, kern, kern_c, plain, plain_c,
                   kin):
    """``measure.compare_stages`` (the bench's check too): logs its line,
    fails unless it holds. Returns the max abs error over the outputs."""
    from cat_tpu_torch import measure

    cmp = measure.compare_stages(mt, terrain, kern, kern_c, plain, plain_c,
                                 kin)
    log(phase, f"{label}: {cmp.text}")
    if not cmp.ok:
        raise RuntimeError(f"a substep kernel disagrees with its plain "
                           f"version ({label})")
    return cmp.worst


def phase_clocks(phase, label, name, n, dev, call):
    """One launch of kernel ``name``'s phase-clock build on a state
    (``call(kernel)`` launches it once); logs the median cycles an env of
    each phase and returns them with the median total."""
    kernel = dict(substep_kernels(clocks=True))[name]
    cyc = kernel.phase_cycles(n, dev, lambda: call(kernel)).double()
    med = dict(zip(kernel.phases, cyc.median(dim=0).values.tolist()))
    med["total"] = cyc.sum(dim=1).median().item()
    log(phase, f"{label}, {name} phase clocks (median cycles an env "
               f"over {n}, the -DSUBSTEP_PHASE_CLOCKS build): "
               + ", ".join(f"{p} {c:.0f}" for p, c in med.items()))
    return med


def phase_clock_line(phase, label, mt, params, terr, args, kin, Minv,
                     v_free):
    """kernel-dyn: one launch of each kernel's phase-clock build on a
    state; logs the median cycles an env of each phase."""
    n, dev = v_free.shape[0], v_free.device
    phase_clocks(phase, label, "substep_dynamics", n, dev,
                 lambda k: k(mt, params, *args))
    phase_clocks(phase, label, "contact_rows", n, dev,
                 lambda k: k(mt, terr, kin, Minv, v_free))


def substep_shapes(m):
    """Each substep kernel's shape arguments (``block_bytes``,
    ``blocks_per_sm``) for model m."""
    return {"substep_dynamics": (m.nbody, m.nv),
            "contact_rows": (m.nbody, m.nv, m.ncand),
            "substep_post": (m.nv, m.ncand, m.nreport)}


def substep_resources(phase, dev, names):
    """kernel-dyn, kernel-post: the ptxas resources of each substep kernel
    in ``names`` (every entry function of its library, and of its
    phase-clock build, which may spill: it is never timed) and, at
    Solo12's shape, its shared memory a block and the blocks an SM holds
    (the occupancy calculator); fails unless N_ENVS envs run there in one
    wave and no entry function of the production library spills."""
    import torch

    from cat_tpu_torch.models.solo12 import solo12_model
    from cat_tpu_torch.ops import build, substep

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = substep_shapes(solo12_model())
    bad = []
    clocked = dict(substep_kernels(clocks=True))
    for name, kernel in substep_kernels():
        if name not in names:
            continue
        for fn, r in build.ptxas_resources(
                clocked[name].load().log).items():
            log(phase, f"{name} (phase-clock build): {fn}: "
                       f"{r['registers']} registers, {r['spill_stores']} B "
                       f"spill stores, {r['spill_loads']} B spill loads")
        for fn, r in build.ptxas_resources(kernel.built.log).items():
            log(phase, f"{name}: {fn}: {r['registers']} registers, "
                       f"{r['spill_stores']} B spill stores, "
                       f"{r['spill_loads']} B spill loads, {r['stack']} B "
                       f"stack frame")
            if r["spill_stores"] or r["spill_loads"]:
                bad.append(f"{fn} spills")
        smem = kernel.block_bytes(*shapes[name])
        per_sm = kernel.blocks_per_sm(dev, *shapes[name])
        blocks = -(-N_ENVS // substep.ENVS_PER_BLOCK)
        waves = -(-blocks // (per_sm * sms))
        log(phase, f"{name} at Solo12's shape: {smem} B of shared memory a "
                   f"block of {substep.ENVS_PER_BLOCK} envs, {per_sm} blocks "
                   f"an SM (occupancy calculator); {N_ENVS} envs = {blocks} "
                   f"blocks over {sms} SMs x {per_sm} = {per_sm * sms} "
                   f"slots: {waves} wave(s)")
        if waves != 1:
            bad.append(f"{name} takes {waves} waves")
    if bad:
        raise RuntimeError(f"substep kernels' resources: {bad}")


def kernel_dyn_phase(dev, smi):
    """kernel-dyn (module docstring). Returns the two kernels' rows."""
    import torch

    from cat_tpu_torch import measure
    from cat_tpu_torch.models.solo12 import solo12_model
    from cat_tpu_torch.ops import substep
    from cat_tpu_torch.sim import engine

    phase = "kernel-dyn"
    rows = {name: dict(name=name, route="cuda", launches=0, max_abs_err=0.0,
                       source=f"cat_tpu_torch/ops/csrc/{src}",
                       replaces="cat_tpu/sim/engine_lanes.py:38")
            for name, src in (("substep_dynamics", "substep_dyn.cu"),
                              ("contact_rows", "contact_rows.cu"))}
    dyn, con = rows["substep_dynamics"], rows["contact_rows"]
    timed = {}
    for label, eng, s, target, com in substep_states(dev):
        mt, params, terr = eng.mt, eng.params, eng.terrain
        args = (s.qpos.contiguous(), s.qvel.contiguous(), target, com)
        kern = substep.DYN_KERNEL(mt, params, *args)
        plain = engine.dynamics_stage(mt, params, *args)
        tau_j, v_free, Minv, kin = plain
        kern_c = substep.CONTACT_KERNEL(mt, terr, kin, Minv, v_free)
        plain_c = engine.contact_stage(mt, terr, kin, Minv, v_free)
        torch.cuda.synchronize()
        err = compare_stages(phase, label, mt, terr, kern, kern_c, plain,
                             plain_c, kin)
        dyn["max_abs_err"] = con["max_abs_err"] = max(dyn["max_abs_err"],
                                                      err)
        phase_clock_line(phase, label, mt, params, terr, args, kin, Minv,
                         v_free)
        # the kernels' time as CUDA-graph replays (no host cost); on the
        # flat and rough states also the plain stages' (replays of their
        # captured kernels, and eager), the bound and its share
        t = timed[label] = {}
        t["dyn"] = measure.graph_ms(
            lambda: substep.DYN_KERNEL(mt, params, *args), 50)
        t["con"] = measure.graph_ms(
            lambda: substep.CONTACT_KERNEL(mt, terr, kin, Minv, v_free), 50)
        if label not in ("flat", "rough"):
            log(phase, f"{label}: substep_dynamics {t['dyn']:.4f} ms, "
                       f"contact_rows {t['con']:.4f} ms (graph replays)")
            continue
        t["dyn_plain"] = measure.graph_ms(
            lambda: engine.dynamics_stage(mt, params, *args), 5)
        t["con_plain"] = measure.graph_ms(
            lambda: engine.contact_stage(mt, terr, kin, Minv, v_free), 5)
        t["dyn_eager"] = measure.cuda_ms(
            lambda: engine.dynamics_stage(mt, params, *args), 5)
        t["con_eager"] = measure.cuda_ms(
            lambda: engine.contact_stage(mt, terr, kin, Minv, v_free), 5)
        counts = measure.substep_counts(mt.model, N_ENVS,
                                        hfield=terr.kind == "hfield")
        for key, name in (("dyn", "substep_dynamics"),
                          ("con", "contact_rows")):
            byts, flops = counts[name]
            t[key + "_bound"], t[key + "_by"] = measure.bound(byts, flops)
            log(phase, f"{label}, {name}: kernel {t[key]:.4f} ms (graph "
                       f"replays); plain {t[key + '_plain']:.3f} ms replayed, "
                       f"{t[key + '_eager']:.3f} ms eager; bound "
                       f"{t[key + '_bound']:.4f} ms by {t[key + '_by']} "
                       f"({byts / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP): "
                       f"{t[key + '_bound'] / t[key] * 100:.1f}% of it; "
                       f"N = {N_ENVS}")
    for key, row in (("dyn", dyn), ("con", con)):
        t = timed["flat"]           # the flat cell's configuration
        row.update(ms=t[key], plain_ms=t[key + "_plain"],
                   bound_ms=t[key + "_bound"], bound_by=t[key + "_by"])
    shapes = substep_shapes(solo12_model())
    for name, kernel in substep_kernels()[:2]:
        log(phase, f"{name}: {kernel.built.path.name}; shared memory a "
                   f"block of 4 envs at Solo12's shape "
                   f"{kernel.block_bytes(*shapes[name])} B; launches in "
                   f"this phase {kernel.launches} (not counted: a "
                   f"comparison)")
    log(phase, f"rough (the engine cell's configuration): substep_dynamics "
               f"{timed['rough']['dyn']:.4f} ms, contact_rows "
               f"{timed['rough']['con']:.4f} ms a launch; {smi}")
    substep_resources(phase, dev, ("substep_dynamics", "contact_rows"))
    return dyn, con


def kernel_post_phase(dev, smi):
    """kernel-post (module docstring). Returns the post kernel's row."""
    import torch

    from cat_tpu_torch import measure
    from cat_tpu_torch.ops import substep
    from cat_tpu_torch.sim import engine

    phase = "kernel-post"
    row = dict(name="substep_post", route="cuda", launches=0,
               max_abs_err=0.0,
               source="cat_tpu_torch/ops/csrc/substep_post.cu",
               replaces="cat_tpu/sim/engine_lanes.py:131")
    for label, eng, s, target, com in substep_states(dev):
        mt, params = eng.mt, eng.params
        mu = torch.ones(N_ENVS, device=dev)
        (tau_j, v_free, W, frame), ops = eng.contact_problem(s, target, mu,
                                                             com)
        lam = eng.solve(*ops, **eng.pgs_kwargs)
        cases = {"solved": (s, lam)}
        cases.update(measure.post_contrived(mt, params, s, lam))
        for case, (si, li) in cases.items():
            out = substep.POST_KERNEL(mt, params, si, tau_j, v_free, W, li,
                                      frame)
            ref = engine.post_stage(mt, params, si, tau_j, v_free, W, li,
                                    frame)
            torch.cuda.synchronize()
            cmp = measure.compare_post(mt, params, si, v_free, W, li, out,
                                       ref)
            active = (li.reshape(N_ENVS, -1, 3) != 0).any(-1).sum(1).float()
            log(phase, f"{label} {case} ({active.mean():.2f} contacts of "
                       f"{mt.model.ncand} with an impulse an env): "
                       f"{cmp.text}")
            if not cmp.ok or len(cmp.flips) > max(8, cmp.near):
                raise RuntimeError(f"the post kernel disagrees with "
                                   f"post_stage ({label}, {case})")
            row["max_abs_err"] = max(
                row["max_abs_err"], *(cmp.errors[k] for k in (
                    "qpos", "qvel", "forces")))
        phase_clocks(phase, label, "substep_post", N_ENVS, dev,
                     lambda k: k(mt, params, s, tau_j, v_free, W, lam, frame))
        # its time as CUDA-graph replays (no host cost), the plain stage's
        # replayed and eager, the bound of this state's impulses
        ms = measure.graph_ms(lambda: substep.POST_KERNEL(
            mt, params, s, tau_j, v_free, W, lam, frame), 50)
        plain_ms = measure.graph_ms(lambda: engine.post_stage(
            mt, params, s, tau_j, v_free, W, lam, frame), 5)
        eager_ms = measure.cuda_ms(lambda: engine.post_stage(
            mt, params, s, tau_j, v_free, W, lam, frame), 5)
        byts, flops = measure.post_counts(mt.model, N_ENVS, frame is not None,
                                          lam)
        full, _ = measure.post_counts(mt.model, N_ENVS, frame is not None,
                                      torch.ones_like(lam))
        bound, by = measure.bound(byts, flops)
        log(phase, f"{label}: kernel {ms:.4f} ms (graph replays); plain "
                   f"{plain_ms:.3f} ms replayed, {eager_ms:.3f} ms eager; "
                   f"bound {bound:.4f} ms by {by} ({byts / 1e6:.2f} MB, "
                   f"{flops / 1e9:.4f} GFLOP; every column of W "
                   f"{full / 1e6:.2f} MB): {bound / ms * 100:.1f}% of it; "
                   f"N = {N_ENVS}; {smi}")
        if label == "flat":         # the flat cell's configuration
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
    log(phase, f"substep_post: {substep.POST_KERNEL.built.path.name}; "
               f"launches in this phase {substep.POST_KERNEL.launches} (not "
               f"counted: a comparison); {smi}")
    substep_resources(phase, dev, ("substep_post",))
    return row


def bundle_policy(run, dev):
    """The mean action of the JAX-trained policy bundle under runs/``run``
    on an observation's first 45 entries, plus noise of 0.3 from a seeded
    generator, so that the envs differ."""
    import torch

    net, obs_mean, obs_var = load_actor(
        Path(__file__).resolve().parent / "runs" / run / "policy_params.npz",
        dev)
    obs_std = torch.sqrt(obs_var + 1e-8)
    gen = torch.Generator(device=dev).manual_seed(7)

    def act(obs):
        a = net.actor((obs[:, :45] - obs_mean) / obs_std)
        return a + 0.3 * torch.randn(a.shape, generator=gen, device=dev)
    return act


def kernel_env_phase(dev, smi):
    """kernel-env (module docstring). Returns the env kernels' rows, by
    name."""
    import importlib

    import torch
    from torch.utils import _pytree as pytree

    from cat_tpu_torch import measure
    from cat_tpu_torch.ops import build, env_step

    phase = "kernel-env"
    rows = {name: dict(name=name, route="cuda", launches=0, max_abs_err=0.0,
                       source=f"cat_tpu_torch/ops/csrc/{name}.cu",
                       replaces=ENV_REPLACES[name])
            for name, _ in env_step.ENV_KERNELS}
    for label, task, run in ENV_CASES:
        env = importlib.import_module(f"cat_tpu_torch.tasks.{task}").make_env(
            N_ENVS, device=dev)
        inputs = measure.env_inputs(env, N_ENVS, ENV_STEPS,
                                    bundle_policy(run, dev))
        pairs = measure.env_stage_pairs(env, *inputs)
        torch.cuda.synchronize()
        terms = pairs["env_terms"][1]
        resets = int((terms.time_out | terms.illegal | terms.upside).sum())
        counts = measure.env_counts(env, N_ENVS, terms,
                                    qpos=pairs["env_update"][1].sim.qpos)
        for name, (out, ref, margins, call, plain) in pairs.items():
            cmp = measure.compare_env(out, ref, margins)
            again = call()
            same = all(torch.equal(a, b) for a, b in zip(
                pytree.tree_leaves(out), pytree.tree_leaves(again)))
            log(phase, f"{label} {name} ({resets} of {N_ENVS} envs reset): "
                       f"{cmp.text}; a second launch bit for bit: {same}")
            if not cmp.ok or not same:
                raise RuntimeError(f"{name} disagrees with its plain stage "
                                   f"({label})")
            ms = measure.graph_ms(call, 50)
            plain_ms = measure.graph_ms(plain, 5)
            byts, flops = counts[name]
            bound, by = measure.bound(byts, flops)
            log(phase, f"{label} {name}: kernel {ms:.4f} ms (graph replays); "
                       f"plain {plain_ms:.3f} ms replayed; bound "
                       f"{bound:.4f} ms by {by} ({byts / 1e6:.2f} MB, "
                       f"{flops / 1e9:.4f} GFLOP): {bound / ms * 100:.1f}% "
                       f"of it; N = {N_ENVS}; {smi}")
            row = rows[name]
            row["max_abs_err"] = max(row["max_abs_err"],
                                     max(cmp.errors.values(), default=0.0))
            if label == "flat":        # the flat cell's configuration
                row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                           bound_by=by)
        del env, inputs, pairs
    for name, kernel in env_step.ENV_KERNELS:
        res = build.ptxas_resources(kernel.built.log)
        log(phase, f"{name}: {kernel.built.path.name}; ptxas {res}; "
                   f"launches in this phase {kernel.launches} (not counted: "
                   f"a comparison)")
    return rows


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


def layouts_agree(phase, eng, s, target, mu, com):
    """The engine's "lanes" route (the substep's three kernels) against its
    "vmap" route (the plain stages) from state s: the contact problem of a
    substep within the stage tolerances, its post stage (the plain
    problem, solved) within ``measure.compare_post``, and one control step
    within the chained-step tolerances of tests/test_torch_engine.py (qpos
    atol 2e-3, qvel atol 2e-2)."""
    import torch

    from cat_tpu_torch import measure
    from cat_tpu_torch.ops import substep
    from cat_tpu_torch.sim import engine

    vmap = eng._replace(layout="vmap", graphs={})
    args = (s.qpos.contiguous(), s.qvel.contiguous(), target.contiguous(),
            com)
    plain = engine.dynamics_stage(eng.mt, eng.params, *args)
    plain_c = engine.contact_stage(eng.mt, eng.terrain, plain[3], plain[2],
                                   plain[1])
    kern = substep.substep_dynamics(eng.mt, eng.params, *args)
    kern_c = substep.contact_rows(eng.mt, eng.terrain, kern[3], kern[2],
                                  kern[1])
    torch.cuda.synchronize()
    compare_stages(phase, "lanes vs vmap, a substep", eng.mt, eng.terrain,
                   kern, kern_c, plain, plain_c, plain[3])
    (tau_j, v_free, W, frame), ops = vmap.contact_problem(s, target, mu, com)
    lam = eng.solve(*ops, **eng.pgs_kwargs)
    post = (substep.substep_post(eng.mt, eng.params, s, tau_j, v_free, W, lam,
                                 frame),
            engine.post_stage(eng.mt, eng.params, s, tau_j, v_free, W, lam,
                              frame))
    torch.cuda.synchronize()
    cmp = measure.compare_post(eng.mt, eng.params, s, v_free, W, lam, *post)
    log(phase, f"lanes vs vmap, a substep's post stage: {cmp.text}")
    if not cmp.ok:
        raise RuntimeError("the post kernel disagrees with post_stage")
    a = vmap._eager(s, target, mu, com)
    b = eng._eager(s, target, mu, com)
    dq = (a.qpos - b.qpos).abs().max().item()
    dv = (a.qvel - b.qvel).abs().max().item()
    log(phase, f"lanes vs vmap, a control step: max |dqpos| {dq:.3g} "
               f"(atol 2e-3), max |dqvel| {dv:.3g} (atol 2e-2)")
    if not (dq <= 2e-3 and dv <= 2e-2):
        raise RuntimeError("the two layouts' control steps disagree")


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
        zero_counts()
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
        layouts_agree(f"{phase} {name}", eng, s0, targets[0], mu, com)
        del eng, s0, eager, graphed, kept, more
    log(phase, f"eager / graphed ms a control step: {'; '.join(rows)} "
               f"(host clock over {GRAPH_STEPS} synchronised steps; {smi})")


def eager_trainer(trainer):
    """``trainer`` with its iteration launched from the host and its env
    step, draw and Adam step run op by op: their eager versions in place
    of the graphed methods, as instance attributes (the bench's hooks sit
    there too). The control step keeps its own graph: no other graph
    runs in its iteration."""
    trainer.ppo.train_iteration = trainer.ppo._train_iteration_eager
    trainer.env.step = trainer.env._step_eager
    trainer.ppo.draw = trainer.ppo._draw_eager
    trainer.ppo.sgd_step = trainer.ppo._sgd_step_eager
    return trainer


def steps_trainer(trainer):
    """``trainer`` with its iteration launched from the host and each env
    step, draw and Adam step a replay of that step's own graph (the
    graphs a group's iteration and play.py replay)."""
    trainer.ppo.train_iteration = trainer.ppo._train_iteration_eager
    return trainer


def trainer_differences(g, e, mg, me) -> list:
    """The leaves of two trainers' checkpoint trees (env state, learner,
    Adam, generators) and the metrics (``mg``, ``me``) that differ in any
    bit."""
    from cat_tpu_torch.rl import checkpoint

    def same(x, y):
        return x == y or (math.isnan(x) and math.isnan(y))

    differ = checkpoint.mismatches(
        checkpoint.state_dict(g.ppo, g.es, g.generators),
        checkpoint.state_dict(e.ppo, e.es, e.generators))
    return differ + [k for k in mg if not same(mg[k], me[k])]


def profiled_iteration(trainer):
    """One iteration under torch.profiler. Returns (metrics, host seconds
    of the synchronised iteration, the HOST_LAUNCHES runtime calls by
    name, the card's events, their busy seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        metrics = trainer.train_iteration()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    calls: dict = {}
    events = prof.events()
    for e in events:
        if e.device_type == cpu and e.name in HOST_LAUNCHES:
            calls[e.name] = calls.get(e.name, 0) + 1
    dev = [e for e in events if e.device_type == cuda
           and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e6
    return metrics, seconds, calls, len(dev), busy


def train_graph_phase(logdir, smi, tasks=TRAIN_GRAPH,
                      iters=TRAIN_GRAPH_ITERS) -> int:
    """train-graph (module docstring); returns its pgs_bj launches."""
    import numpy as np
    import torch

    from cat_tpu_torch import train
    from cat_tpu_torch.ops import pgs

    phase = "train-graph"
    total = 0
    for task, agent in tasks:
        argv = train_argv(task, logdir, iters, "--agent", agent)
        zero_counts()
        sides = {"graphed": train.Trainer(train.parse_args(argv)),
                 "steps": steps_trainer(train.Trainer(train.parse_args(argv))),
                 "eager": eager_trainer(train.Trainer(train.parse_args(argv)))}
        add_env_launches(f"{phase} {task} reset observations", 0,
                         observes=len(sides))
        seconds = {side: [] for side in sides}
        for it in range(1, iters + 1):
            metrics = {}
            for side, tr in sides.items():
                zero_counts()
                if it < iters:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    metrics[side] = tr.train_iteration()
                    torch.cuda.synchronize()
                    seconds[side].append(time.perf_counter() - t0)
                else:
                    metrics[side], s, calls, kernels, busy = (
                        profiled_iteration(tr))
                    log(phase, f"{task} {side}, profiled iteration {it}: "
                               f"{s:.4f} s, host calls "
                               f"{sum(calls.values())} "
                               f"{dict(sorted(calls.items()))}, {kernels} "
                               f"card events, busy {busy:.4f} s, idle "
                               f"{100 * (1 - busy / s):.1f}% ({smi})")
                    seconds[side].append(s)
                total += check_launches(f"{phase} {task} {side} it {it}",
                                        pgs.KERNEL, 24 * env_decimation())
                add_env_launches(f"{phase} {task} {side} it {it}", 24)
            g, st, e = sides["graphed"], sides["steps"], sides["eager"]
            for side in ("graphed", "steps"):
                differ = trainer_differences(sides[side], e, metrics[side],
                                             metrics["eager"])
                log(phase, f"{task} ({agent}) iteration {it}: {side} vs "
                           f"eager, leaves of the checkpoint's tree (env "
                           f"state, learner, Adam, generators) and metrics "
                           f"that differ in any bit: {differ or 'none'}; "
                           f"learning rate "
                           f"{metrics[side]['Train/learning_rate']!r}")
                if differ:
                    raise RuntimeError(f"the {side} iteration is not the "
                                       f"eager one bit for bit")
        kinds = sorted(k[0] for k in g.ppo.graphs)
        if kinds != ["learn", "rollout"] or g.env.graphs:
            raise RuntimeError(f"the graphed trainer's graphs: learner "
                               f"{kinds}, env {len(g.env.graphs)}; not the "
                               f"iteration's rollout and learn alone")
        kinds = sorted({k[0] for k in st.ppo.graphs})
        if kinds != ["draw", "sgd"] or not st.env.graphs:
            raise RuntimeError(f"the steps trainer's graphs: learner "
                               f"{kinds}, env {len(st.env.graphs)}; not the "
                               f"draw's, the Adam step's and the env "
                               f"step's")
        # the graphed side's first iteration warms up, its second captures
        steady = {side: float(np.median(x[2:-1]))
                  for side, x in seconds.items()}
        for side in sides:
            log(phase, f"{task} {side}: iteration seconds "
                       f"{[round(x, 4) for x in seconds[side]]} (the last "
                       f"profiled), median of iterations 3-{iters - 1} "
                       f"{steady[side]:.4f} s ({smi})")
        log(phase, f"{task}: eager / steps / graphed iteration "
                   f"{steady['eager'] / steady['graphed']:.2f}x / "
                   f"{steady['steps'] / steady['graphed']:.2f}x")
        del sides, g, st, e
    return total


def resume_phase(argv, ckpt, logged_lr) -> int:
    """resume (module docstring): ``ckpt`` of the run of ``argv``, whose
    last iteration logged ``logged_lr``; returns its pgs_bj launches."""
    from cat_tpu_torch import train
    from cat_tpu_torch.ops import pgs
    from cat_tpu_torch.rl import checkpoint

    phase = "resume"
    zero_counts()
    fresh = train.Trainer(train.parse_args(argv))
    add_env_launches(f"{phase} reset observation", 0, observes=1)
    fresh.restore(ckpt)
    saved = checkpoint.load(ckpt)
    differ = checkpoint.mismatches(
        saved, checkpoint.state_dict(fresh.ppo, fresh.es, fresh.generators))
    lr_saved = float(fresh.ppo.lr)
    log(phase, f"{ckpt}: {os.path.getsize(ckpt) / 2**20:.1f} MiB, "
               f"{len(checkpoint.flatten(saved))} leaves; {len(differ)} "
               f"differ from the restored state {differ[:5]}; learning "
               f"rate {lr_saved:.6g} restored, {logged_lr:.6g} "
               f"logged at iteration {PPO_ITERS}")
    if differ or lr_saved != logged_lr:
        raise RuntimeError("the restored state is not the saved one")
    # the graphed iteration from the restore (its warm-up, capture and a
    # replay) against the same checkpoint restored into a trainer whose
    # iteration runs op by op
    zero_counts()
    eager = eager_trainer(train.Trainer(train.parse_args(argv)))
    add_env_launches(f"{phase} eager reset observation", 0, observes=1)
    eager.restore(ckpt)
    history, launches = [], 0
    for it in range(PPO_ITERS + 1, PPO_ITERS + RESUME_ITERS + 1):
        zero_counts()
        t0 = time.perf_counter()
        metrics = fresh.train_iteration()
        seconds = time.perf_counter() - t0
        launches += check_launches(phase, pgs.KERNEL, 24 * env_decimation())
        add_env_launches(phase, 24)
        zero_counts()
        ref = eager.train_iteration()
        launches += check_launches(f"{phase} eager", pgs.KERNEL,
                                   24 * env_decimation())
        add_env_launches(f"{phase} eager", 24)
        differ = trainer_differences(fresh, eager, metrics, ref)
        log(phase, f"iteration {it} after the restore, graphed vs eager: "
                   f"leaves and metrics that differ in any bit: "
                   f"{differ or 'none'}; learning rate "
                   f"{metrics['Train/learning_rate']!r}; graphed "
                   f"{seconds:.4f} s")
        if differ:
            raise RuntimeError("the graphed iteration after a restore is "
                               "not the eager one bit for bit")
        history.append(dict(metrics, **{
            "Perf/iter_seconds": seconds,
            "Perf/env_steps_per_sec": 24 * N_ENVS / seconds}))
    check_finite(phase, history)
    kinds = sorted(k[0] for k in fresh.ppo.graphs)
    if fresh.ppo.iteration != PPO_ITERS + RESUME_ITERS or kinds != [
            "learn", "rollout"]:
        raise RuntimeError(f"the resumed run did not go on from its "
                           f"iteration through the iteration's graphs "
                           f"({fresh.ppo.iteration}, {kinds})")
    return launches


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
    zero_counts()
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

    from cat_tpu_torch.ops import pgs, substep
    from cat_tpu_torch.tools import pgs_structure_probe as probe

    phase = "probe"
    t0 = time.perf_counter()
    zero_counts()
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
    # the substep kernels: the rollout and one contact problem a capture
    # (the post kernel: the rollout alone)
    rollout = max(probe.CAPTURE_STEPS) * env_decimation()
    bj["launches"] += check_launches(
        phase, pgs.KERNEL, rollout + len(probe.VARIANTS) * captures,
        substeps=None)
    for name, kernel in substep_kernels():
        add_launches(phase, name, kernel, rollout if kernel is
                     substep.POST_KERNEL else rollout + captures)
    gs["launches"] += check_launches(phase, pgs.GS_KERNEL, serial * captures,
                                     substeps=None)
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
    zero_counts()
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
    from cat_tpu_torch.ops import env_step

    kernels = (pgs.KERNEL, pgs.GS_KERNEL,
               *(k for _, k in substep_kernels() + substep_kernels(True)
                 + env_step.ENV_KERNELS))
    with ThreadPoolExecutor(len(kernels)) as pool:   # one nvcc a source
        builds = list(pool.map(lambda k: k.load(), kernels))
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

    dyn, con = kernel_dyn_phase(dev, smi)
    post = kernel_post_phase(dev, smi)
    env_rows = kernel_env_phase(dev, smi)
    SUBSTEP_ROWS.update(substep_dynamics=dyn, contact_rows=con,
                        substep_post=post, **env_rows)
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

        bj["launches"] += train_graph_phase(logdir, smi)

        bj["launches"] += train_nccl_phase(logdir, flat_dir)
        bj["launches"] += train_dist_phase(logdir, flat_dir)
        bj["launches"] += train_dr_phase(logdir, flat_dir, dev)

        phase = "engine-gs"
        eng, s, target, mu, spots = raw_engine_on_rough(dev)
        zero_counts()
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
        zero_counts()
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

        bj["launches"] += resume_phase(
            go2_argv, os.path.join(run_dir, f"ckpt_{PPO_ITERS}.pt"),
            history[-1]["Train/learning_rate"])

        phase = "play-run"
        zero_counts()
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
    zero_counts()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        # the PPO cells at 1 timed iteration, the engine cell at 1 window
        results = [bench.main(["--cell", name, "--iters", "1", "--no-trace"])
                   for name in (bench.FLAT, bench.ROUGH_PPO)]
        results.append(bench.main(["--cell", bench.ENGINE, "--iters",
                                   str(bench.WINDOW), "--no-trace"]))
    for line in printed.getvalue().splitlines():
        if not line.startswith("{"):                  # not its JSON lines
            log(phase, line)
    cells = {r["cells"][0]["workload"]: r["cells"][0]["counts"]
             for r in results}
    per_cell = {name: ((c["warmup_iterations"] + c["timed_iterations"])
                       * 24 * env_decimation()) if name != bench.ENGINE
                else (c["warmup_steps"] + c["timed_steps"]) * env_decimation()
                for name, c in cells.items()}
    # each cell's kernels, launched once a substep of its warm-up and
    # timed window, as the bench counts them
    expected = {(name, k): per_cell[name] for name, c in cells.items()
                for k in ("pgs_bj", "pgs_gs", "substep_dynamics",
                          "contact_rows", "substep_post")
                if f"{k}_launches" in c}
    got = {(name, k): cells[name][f"{k}_launches"] for name, k in expected}
    correct = all(r["correct"] for r in results)
    log(phase, f"three cells, 1 timed iteration / {bench.WINDOW} control "
               f"steps, no trace: correct {correct}; launches {got} "
               f"(expected {expected})")
    if not correct or got != expected:
        raise RuntimeError("the bench's cells are not correct or missed "
                           "their kernels")
    bj["launches"] += sum(n for (_, k), n in got.items() if k == "pgs_bj")
    gs["launches"] += sum(n for (_, k), n in got.items() if k == "pgs_gs")
    # the substep kernels also run in the bench's checks and contact
    # problems after each window, outside its count
    add_substep_launches(phase, sum(per_cell.values()), at_least=True)

    with tempfile.TemporaryDirectory() as logdir:
        probe_phase(logdir, bj, gs)
        drill_phase(logdir)
    bj["launches"] += cstr_phase(dev)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {k: dict(row, route="cuda", library_ms=None)[k] for k in keys}
        for row in (bj, gs, dyn, con, post, *env_rows.values())]}),
        flush=True)
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
