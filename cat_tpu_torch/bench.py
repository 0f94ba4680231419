"""The port's benchmark: the cells of BENCHMARK.json on one CUDA card.

  python -m cat_tpu_torch.bench [--cell NAME] [--seed 0] [--warmup K]
      [--iters K] [--num_envs N] [--no-trace] [--device cpu]

Cells (all three by default, in turn):
  solo12_flat_ppo_4096: the trainer's PPO iteration of Solo12-CaT-Flat-v0
     (clean_rl recipe) at 4096 envs, as ``trace_iteration.py`` builds it:
     24 env steps of 4 substeps (the ``bj:4:0.9:6`` solve, ``pgs_bj``), then
     5 epochs x 6 minibatches of 16,384 rows; closed loop, each iteration
     starting when the last one ends. ``--warmup`` iterations (3), then
     ``--iters`` timed ones (30). End to end: ``env_steps_per_s``, the env
     steps of the timed window over its host seconds, synchronised at its
     start and end.
  solo12_rough_ppo_4096: the same iteration of Solo12-CaT-Rough-v0: the
     800 x 640 heightfield of ``generate_rough(seed=0)``, the terrain
     curriculum, the 187-point height scan in the observation (232 inputs),
     heightfield contacts under ``pgs_bj``. Same loop, counts and end-to-end
     metric.
  solo12_rough_engine_4096: the raw engine's default path
     (``make_batched_step`` with the default SolverParams, serial
     Gauss-Seidel, 5 sweeps, ``pgs_gs``) under the control traffic of the
     Solo12-CaT-Rough-v0 task: its terrain, its reset (patches of the
     easier half, pose, friction), and PD targets mapped from actions as
     its env step maps them, the actions drawn as the recipe's policy draws
     them at its start (a Gaussian of unit standard deviation about a mean
     near 0). ``--warmup`` control steps (50), then ``--iters`` timed
     ones (500). End to end: ``engine_ms_per_control_step``, the host
     milliseconds of the timed window over its control steps.

Every random input comes from ``--seed``. The synchronised times of each
iteration, and of each window of 20 control steps, go to ``samples``
(median, quartiles, n). Each cell checks its output (``correct``): finite
losses or state; each kernel of the cell (the contact solve, the
substep's ``substep_dynamics``, ``contact_rows`` and ``substep_post``)
launched exactly once a substep of the timed window; after the window,
the program held against plain references that share no code with it
(``bench_reference``): one more PPO iteration's minibatches and parameter
change, launched from the host on tape and bit for bit the iteration the
window times (PPO cells), and one control step's four substeps (all);
the substep kernels against the plain stages
(``measure.compare_stages``) and the contact solve against its plain
version (``measure.RTOL`` / ``ATOL_REL``) on the state after the window.
Each reference check has a limit, and a control: the reference on inputs
rounded through bfloat16 must fail it.

Then, unless ``--no-trace``, the per-layer metrics, each from a separate
run after the timed window with the bench's spans (``torch.profiler.
record_function`` around bound methods of the cell's objects, put on for
that run and taken off after; none inside the program): the card's busy
time, kernels and idle share under torch.profiler over one iteration or
10 control steps (busy and wall from that one traced run), the 12 kernels
with the most card time and the longest idle gaps, each named by the span
open on the host; the rollout's and the learner's host seconds; on the
state after the window, the card's time (CUDA-graph replays, no host cost)
of a substep's contact problem, of each substep kernel and of
``substep_post``, a control step's (CUDA events over graph replays), the
contact solve's on its captured problem, and each kernel's share of its
bound; the timed window's model FLOPs over the card's f32 peak (``mfu``);
peak memory of the timed window.

``--device cpu`` rehearses at a few envs: the counts, the checks and
``correct``, and "not measured" for every time, rate and share. Each line
before the last carries the card's name and power limit; the last line is
one JSON object: every cell's metrics, samples, counts, checks and
``correct``, and the device. The exit code is 1 unless every cell is
correct.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from cat_tpu_torch import bench_reference as ref
from cat_tpu_torch import measure, resolve_device

FLAT = "solo12_flat_ppo_4096"
ROUGH_PPO = "solo12_rough_ppo_4096"
ENGINE = "solo12_rough_engine_4096"
CELLS = (FLAT, ROUGH_PPO, ENGINE)
FLAT_TASK = "Solo12-CaT-Flat-v0"
ROUGH_TASK = "Solo12-CaT-Rough-v0"
PPO_TASKS = {FLAT: FLAT_TASK, ROUGH_PPO: ROUGH_TASK}
FULL_ENVS = 4096
WINDOW = 20            # engine cell: control steps a sample
TRACE_STEPS = 10       # engine cell: control steps under the profiler
GRAPH_REPS = 50        # kernel launches a CUDA graph replays
TOP = 12               # kernels and idle gaps in a breakdown
DEFAULTS = {FLAT: dict(warmup=3, iters=30), ROUGH_PPO: dict(warmup=3, iters=30),
            ENGINE: dict(warmup=50, iters=500)}
# the reference checks' limits on the relative errors of bench_reference
# (the learner's minibatches and parameter change; a substep's velocities,
# positions and contact rows); PERF.md section 2 has the readings, of
# sound runs and of the bfloat16 control, they were set from
LEARNER_LIMIT = 1e-3
SUBSTEP_LIMIT = 1e-3
# the substep kernels against the plain stages on a heightfield: E and the
# frames within HFIELD_LIMIT (``measure.HFIELD_ATOL`` holds for grid
# coordinates under 128 cells; the rough task's 800 x 640 grid rounds its
# coordinates to a coarser float32 spacing); PERF.md section 2 has the
# readings, of sound runs and of the control (the plain contact stage with
# the bodies' orientations rounded through bfloat16), it was set from
HFIELD_LIMIT = 1e-4
NOT_MEASURED = "not measured"
OUTSIDE = "(no span)"


def quantiles(xs) -> dict:
    a = np.asarray(xs, dtype=np.float64)
    return {"median": float(np.median(a)), "p25": float(np.percentile(a, 25)),
            "p75": float(np.percentile(a, 75)), "min": float(a.min()),
            "max": float(a.max()), "n": len(xs), "values": a.tolist()}


def model_flops(net, rollout_rows: int, learner_rows: int) -> float:
    """Matmul FLOPs of the networks in one iteration, counted from the
    widths of ``net``'s Linear layers: forward over the rollout's rows,
    forward and backward (3 x forward) over the learner's."""
    fwd = sum(2 * m.in_features * m.out_features for m in net.modules()
              if isinstance(m, torch.nn.Linear))
    return float(fwd * (rollout_rows + 3 * learner_rows))


def _span(name: str, fn):
    from torch.profiler import record_function

    def spanned(*a, **k):
        with record_function(name):
            return fn(*a, **k)
    return spanned


def spanned_engine(eng):
    """A copy of the engine (a NamedTuple, so no attribute can be set on
    it) whose contact problem and solve run in spans."""
    base = type(eng)

    class SpannedEngine(base):
        __slots__ = ()

        def contact_problem(self, *a, **k):
            from torch.profiler import record_function

            with record_function("engine.contact_problem"):
                return base.contact_problem(self, *a, **k)

    return SpannedEngine(*eng._replace(solve=_span("engine.solve", eng.solve)))


class PpoSpans:
    """A PPO cell's spans, on for one run: ``env.step``,
    ``ppo.net.forward`` (the network's ``__call__`` calls it),
    ``ppo.sgd_step`` and the engine's contact problem and solve, which
    the iteration launched op by op calls (NAMES adds the caller's span
    around the iteration), and ``ppo.rollout`` and ``ppo.learn``, the
    replays of the graphed iteration (GRAPHED). Where ``mark_after`` is
    given, it calls ``sync`` at the rollout's end and appends the host
    clock to ``marks``: after ``ppo.rollout`` on the card, whose iteration
    is the two replays; after the ``mark_after``-th env step on the CPU,
    whose iteration is launched op by op and calls no ``ppo.rollout``."""

    NAMES = ("ppo.train_iteration", "env.step", "ppo.net.forward",
             "ppo.sgd_step", "engine.contact_problem", "engine.solve")
    GRAPHED = ("ppo.rollout", "ppo.learn")

    def __init__(self, env, ppo, mark_after: Optional[int] = None,
                 sync=torch.cuda.synchronize):
        self.env, self.ppo, self.mark_after = env, ppo, mark_after
        self.sync, self.marks = sync, []

    def _mark(self):
        self.sync()
        self.marks.append(time.perf_counter())

    def __enter__(self):
        env, ppo = self.env, self.ppo
        step = _span("env.step", env.step)
        rollout = _span("ppo.rollout", ppo.rollout)
        calls = [0]

        def marked(*a, **k):
            out = step(*a, **k)
            calls[0] += 1
            if calls[0] == self.mark_after:
                self._mark()
            return out

        def marked_rollout(*a, **k):
            out = rollout(*a, **k)
            if self.mark_after is not None:
                self._mark()
            return out

        self.engine = env.engine
        env.engine = spanned_engine(env.engine)
        env.step = marked
        ppo.net.forward = _span("ppo.net.forward", ppo.net.forward)
        ppo.sgd_step = _span("ppo.sgd_step", ppo.sgd_step)
        ppo.rollout = marked_rollout
        ppo.learn = _span("ppo.learn", ppo.learn)
        return self

    def __exit__(self, *exc):
        self.env.engine = self.engine
        del self.env.step, self.ppo.net.forward, self.ppo.sgd_step
        del self.ppo.rollout, self.ppo.learn


def _innermost(spans, times):
    """For each host time, the name of the innermost span open at it
    (``spans``: (start, end, name), properly nested, as on one thread)."""
    marks = ([(s, 0, i) for i, (s, _, _) in enumerate(spans)]
             + [(t, 1, j) for j, t in enumerate(times)]
             + [(e, 2, i) for i, (_, e, _) in enumerate(spans)])
    marks.sort()
    names, stack = [OUTSIDE] * len(times), []
    for _, kind, i in marks:
        if kind == 0:
            stack.append(i)
        elif kind == 2:
            stack.remove(i)
        elif stack:
            names[i] = spans[stack[-1]][2]
    return names


def breakdown(prof, span_names) -> dict:
    """The card's events in a torch.profiler trace: busy time (the sum of
    their times; on one stream they do not overlap), their count, the TOP
    kernels by card time and the TOP longest idle gaps between them, and
    the idle time by span. A kernel is named by the span open on the host
    at its launch (the runtime's launch call, which shares the kernel's
    CUPTI correlation id; else at its own start); a gap by the span at the
    launch of the kernel that ends it."""
    cpu_t = torch.autograd.DeviceType.CPU
    cuda_t = torch.autograd.DeviceType.CUDA
    events = prof.events()
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.device_type == cpu_t and e.name in span_names]
    runtime = {e.id: e.time_range.start for e in events
               if e.device_type == cpu_t and e.name.startswith("cu")}
    dev = sorted((e for e in events if e.device_type == cuda_t
                  and not getattr(e, "is_user_annotation", False)
                  and e.name not in span_names),
                 key=lambda e: e.time_range.start)
    linked = [runtime.get(e.id) for e in dev]
    at = _innermost(spans, [t if t is not None else e.time_range.start
                            for t, e in zip(linked, dev)])
    by_name: dict = {}
    for e, span in zip(dev, at):
        row = by_name.setdefault(e.name, {"us": 0.0, "count": 0, "spans": {}})
        us = e.time_range.elapsed_us()
        row["us"] += us
        row["count"] += 1
        row["spans"][span] = row["spans"].get(span, 0.0) + us
    gaps, idle_by_span, end = [], {}, None
    for e, span in zip(dev, at):
        if end is not None and e.time_range.start > end:
            us = e.time_range.start - end
            gaps.append((us, span, e.name))
            idle_by_span[span] = idle_by_span.get(span, 0.0) + us
        end = e.time_range.end if end is None else max(end, e.time_range.end)
    top = sorted(by_name.items(), key=lambda kv: -kv[1]["us"])[:TOP]
    return {
        "busy_s": sum(r["us"] for r in by_name.values()) / 1e6,
        "kernels": len(dev),
        "linked_share": (sum(t is not None for t in linked) / len(dev)
                         if dev else 0.0),
        "top_kernels": [{
            "name": name[:120], "device_ms": r["us"] / 1e3,
            "count": r["count"],
            "span": max(r["spans"].items(), key=lambda kv: kv[1])[0]}
            for name, r in top],
        "idle_gaps": [{"ms": us / 1e3, "span": span, "before": name[:120]}
                      for us, span, name in sorted(gaps, reverse=True)[:TOP]],
        "idle_ms_by_span": {k: v / 1e3 for k, v in sorted(
            idle_by_span.items(), key=lambda kv: -kv[1])},
    }


def profiled(fn, span_names):
    """Run ``fn`` under torch.profiler (host and card); its breakdown, with
    ``wall_s``, the host seconds of that traced run, synchronised at its
    start and end (so busy and wall come from the one run)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return dict(breakdown(prof, span_names), wall_s=wall)


class Cell:
    """One cell's result: metrics (a number, or NOT_MEASURED), samples,
    counts, checks, and the lines it printed."""

    def __init__(self, name: str, card: str, metrics: Sequence[str]):
        self.name, self.card = name, card
        self.metrics = {m: NOT_MEASURED for m in metrics}
        self.samples, self.counts, self.checks = {}, {}, {}
        self.breakdown = NOT_MEASURED
        self.t0 = time.perf_counter()

    def log(self, msg: str):
        print(f"[bench {self.name} +{time.perf_counter() - self.t0:6.1f}s] "
              f"{self.card} | {msg}", flush=True)

    def check(self, name: str, ok: bool, msg: str):
        self.checks[name] = bool(ok)
        self.log(f"check {name}: {'ok' if ok else 'FAILED'} ({msg})")

    def limit_check(self, name: str, errs: dict, control: dict, limit: float,
                    what: str):
        """The program against a plain reference (``errs``, each a relative
        error) within ``limit``; and the control (the reference on inputs
        rounded through bfloat16) outside it, which shows the limit sees
        an error of that size."""
        worst, ctl = max(errs.values()), max(control.values())
        self.counts[f"{name}_err"] = errs
        self.counts[f"{name}_control_err"] = control
        parts = ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        self.check(name, worst <= limit,
                   f"{what} against its plain reference: relative errors "
                   f"{parts}; limit {limit:g}")
        self.check(f"{name}_control", ctl > limit,
                   f"the reference on bfloat16-rounded inputs: worst "
                   f"relative error {ctl:.3g}, must exceed the limit")

    def kernel_check(self, solve, plain, ops, kw):
        """The path's solve against its plain version on ``ops``."""
        err, scale, outside = measure.disagreement(solve(*ops, **kw),
                                                   plain(*ops, **kw))
        self.counts["kernel_max_abs_err"] = err
        self.check("kernel_vs_plain", outside == 0,
                   f"{solve.__name__} against {plain.__name__} on the "
                   f"captured problem: max abs err {err:.3g}, max|lam| "
                   f"{scale:.4g}, {outside} entries outside rtol "
                   f"{measure.RTOL} / atol {measure.ATOL_REL} x max|lam|")

    def bound(self, prefix: str, byts, flops) -> float:
        """A kernel's bound from the bytes and f32 operations its inputs
        need and the card's published peaks; recorded in ``counts``."""
        bound_ms, by = measure.bound(byts, flops)
        self.counts.update({
            f"{prefix}_bytes": byts, f"{prefix}_flops": flops,
            f"{prefix}_bound_ms": bound_ms, f"{prefix}_bound_by": by})
        return bound_ms

    def kernel_bound(self, prefix: str, ops, kw, table_words: int):
        """The bound of the solve on the captured problem."""
        active = ops[4]
        self.counts["active_contacts_per_env"] = float(
            (active != 0).sum(1).float().mean())
        return self.bound(prefix, *measure.pgs_counts(
            active, ops[0].shape[2], kw["iterations"], table_words))

    def kernel_time(self, prefix: str, fn, bound_ms: float):
        """A kernel's card time (``fn`` launches it once) and its share of
        the bound."""
        ms = measure.graph_ms(fn, GRAPH_REPS)
        self.metrics[f"{prefix}_ms"] = ms
        self.metrics[f"{prefix}_roofline_share"] = bound_ms / ms
        self.log(f"{prefix} {ms:.4f} ms a launch on the card ({GRAPH_REPS} "
                 f"launches replayed in a CUDA graph); bound {bound_ms:.4f} "
                 f"ms by {self.counts[prefix + '_bound_by']}: "
                 f"{bound_ms / ms * 100:.1f}% of it")

    def result(self) -> dict:
        return {"workload": self.name, "correct": all(self.checks.values()),
                "metrics": self.metrics, "samples": self.samples,
                "counts": self.counts, "checks": self.checks,
                "breakdown": self.breakdown}


# the substep's per-layer metrics, in every cell (all three run the substep
# kernels and substep_post)
SUBSTEP_METRICS = ("substep_dynamics_ms", "substep_dynamics_roofline_share",
                   "contact_rows_ms", "contact_rows_roofline_share",
                   "substep_post_ms", "substep_post_roofline_share")
PPO_METRICS = ("env_steps_per_s", "iteration_s_median", "device_busy_s",
               "device_idle_share", "kernels_launched", "rollout_s",
               "learner_s", "contact_problem_ms", "control_step_ms",
               "pgs_bj_ms", "pgs_bj_roofline_share", "mfu",
               "peak_mem_gb") + SUBSTEP_METRICS
ENGINE_METRICS = ("engine_ms_per_control_step", "window_ms_median",
                  "device_busy_ms", "device_idle_share", "kernels_launched",
                  "contact_problem_ms", "control_step_ms", "pgs_gs_ms",
                  "pgs_gs_roofline_share", "peak_mem_gb") + SUBSTEP_METRICS
CELL_METRICS = {FLAT: PPO_METRICS, ROUGH_PPO: PPO_METRICS,
                ENGINE: ENGINE_METRICS}


def cell_kernels(solve: str, solve_kernel) -> dict:
    """name -> wrapper of each kernel a cell's control step launches once
    a substep: its contact solve's (``solve``) and the substep's three
    (``substep.SUBSTEP_KERNELS``)."""
    from cat_tpu_torch.ops import substep

    return {solve: solve_kernel, **dict(substep.SUBSTEP_KERNELS)}


def load_kernels(cell: Cell, kernels: dict):
    for kernel in kernels.values():
        built = kernel.load()
        cell.log(f"{built.path.name}: {built.seconds:.1f} s in nvcc")


def launch_checks(cell: Cell, solve: str, got: dict, expected: int,
                  what: str):
    """A check a kernel: its launches in each sample of the timed window
    (``got``: name -> list) all ``expected``. The contact solve's (``solve``)
    check is ``launches``, a substep kernel's ``launches_<name>``."""
    for name, seq in got.items():
        key = "launches" if name == solve else f"launches_{name}"
        cell.check(key, seq == [expected] * len(seq),
                   f"{name} launches {what} {seq}, expected {expected}")


def control_step_check(cell: Cell, eng, s, target, mu, com_offset=None):
    """One control step of ``eng`` from ``s``, substep by substep (the
    body of ``Engine.substep``: contact problem, solve, integration),
    each held against ``bench_reference.substep_reference`` from the same
    state with the step's contact frames and impulses. Returns the state
    after the step."""
    from cat_tpu_torch.sim.engine import substep_post

    p, m = eng.params, eng.mt.model
    s = s._replace(touchdown=torch.zeros_like(s.touchdown))
    errs, control = {}, {}
    with torch.no_grad():
        for _ in range(p.decimation):
            (tau_j, v_free, W, frame), ops = eng.contact_problem(
                s, target, mu, com_offset)
            lam = eng.solve(*ops, **eng.pgs_kwargs)
            nxt = substep_post(eng.mt, p, s, tau_j, v_free, W, lam, frame)
            for out, rounded in ((errs, False), (control, True)):
                r = ref.substep_reference(m, p.dt, p.kp, p.kd, s.qpos, s.qvel,
                                          target, frame, lam, com_offset,
                                          rounded=rounded)
                for k, v in ref.substep_errors(s, nxt, ops, r).items():
                    out[k] = max(out.get(k, 0.0), v)
            s = nxt
    cell.limit_check("control_step", errs, control, SUBSTEP_LIMIT,
                     f"one control step ({p.decimation} substeps, "
                     f"{s.qpos.shape[0]} envs)")
    return s


def learner_snapshot(ppo, gen):
    """Clones of what an iteration changes of the learner (the parameters,
    Adam's state, the rate, the device's iteration counter, the
    normalisers, the carry, the host's iteration) and of the generator
    ``gen``; returns a function that puts them back. It copies into the
    tensors that the iteration's graphs write and replaces no object that
    a graph's key holds (``checkpoint.restore`` replaces Adam's state)."""
    owned = [ppo.lr, ppo.device_iteration, *ppo.net.parameters(),
             *(t for st in ppo.opt.state.values() for t in st.values()
               if isinstance(t, torch.Tensor))]
    saved = [t.detach().clone() for t in owned]
    kept = pytree.tree_map(torch.clone, (
        ppo.obs_rms, ppo.value_rms, ppo.next_obs, ppo.next_done,
        ppo.next_true_done))
    iteration, state = ppo.iteration, gen.get_state()

    def put_back():
        with torch.no_grad():
            for t, s in zip(owned, saved):
                t.copy_(s)
        (ppo.obs_rms, ppo.value_rms, ppo.next_obs, ppo.next_done,
         ppo.next_true_done) = kept
        ppo.iteration = iteration
        gen.set_state(state)

    return put_back


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def learner_check(cell: Cell, env, ppo, es, gen):
    """One more PPO iteration, run twice from one state: as the timed
    window runs it (``ppo.train_iteration``: on the card the replays of
    its two graphs), then launched from the host on tape
    (``bench_reference.LearnerTape``), which the plain learner replays
    (``bench_reference.learner_reference``). Check ``timed_path``: the two
    agree bit for bit in every leaf of the checkpoint's tree (env state,
    learner, Adam, generator) and every metric, so that the plain
    learner's check holds for the timed path. Returns the env state after
    the iteration."""
    from cat_tpu_torch.rl import checkpoint

    put_back = learner_snapshot(ppo, gen)
    es_timed, m_timed = ppo.train_iteration(es, gen)
    timed = pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
        checkpoint.state_dict(ppo, es_timed, {"ppo": gen}))
    put_back()
    with ref.LearnerTape(env, ppo) as tape:
        es, metrics = ppo._train_iteration_eager(es, gen)
    differ = checkpoint.mismatches(
        timed, checkpoint.state_dict(ppo, es, {"ppo": gen})) + [
        f"metrics.{k}" for k in sorted(metrics)
        if not torch.equal(_bits(m_timed[k]), _bits(metrics[k]))]
    cell.check("timed_path", not differ,
               f"one iteration as the timed window runs it against the "
               f"same one launched from the host on tape, from one state: "
               f"leaves and metrics that differ in any bit: "
               f"{differ[:8] or 'none'} ({len(differ)})")
    try:
        sound = ref.learner_reference(tape, ppo.cfg)
    except ref.Mismatch as e:
        cell.check("learner", False, f"the iteration's minibatches: {e}")
        return es
    # how much the clip-boundary rows loosen the gradient check: the
    # largest allowance over its tensor's largest gradient entry
    cell.counts["learner_clip_allowance_share"] = max(
        float(a.max() / g.abs().max()) for al, gr in zip(sound.allow,
                                                         sound.grads)
        for a, g in zip(al.values(), gr.values()))
    cell.limit_check(
        "learner", ref.learner_errors(tape, sound),
        ref.learner_errors(tape, sound, ref.learner_reference(
            tape, ppo.cfg, rounded=True)),
        LEARNER_LIMIT, f"one PPO iteration ({len(tape.minibatches)} Adam "
                       f"steps; {sound.ambiguous} rows at a clip boundary, "
                       f"allowed up to "
                       f"{cell.counts['learner_clip_allowance_share']:.3g} "
                       f"of a tensor's largest gradient entry): "
                       f"its minibatches, gradients and Adam updates")
    return es


def ppo_cell(name: str, dev, n: int, args, card: str) -> Cell:
    """A PPO cell: the trainer's iteration of its task (``PPO_TASKS``)."""
    from cat_tpu_torch.ops import pgs
    from cat_tpu_torch.rl.ppo import PPO
    from cat_tpu_torch.tasks import registry

    cell = Cell(name, card, CELL_METRICS[name])
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    solve = "pgs_bj"
    kernels = cell_kernels(solve, pgs.KERNEL)
    if on_card:
        load_kernels(cell, kernels)
    spec = registry.get(PPO_TASKS[name])
    env = spec.make_env(n, device=dev)
    cfg = spec.make_agent_cfg()
    if n != FULL_ENVS:   # a rehearsal: the recipe's 6 minibatches
        cfg = dataclasses.replace(
            cfg, minibatch_size=cfg.minibatch_size * n // FULL_ENVS)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    es = env.init(gen, n)
    ppo = PPO(env, cfg, torch.Generator().manual_seed(args.seed))
    ppo.start(env.observe(es, gen))
    env_steps = cfg.num_steps * n
    # each kernel launches once a substep on the card; the plain versions
    # run on the CPU and launch nothing
    per_iteration = cfg.num_steps * env.cfg.decimation if on_card else 0

    t_setup = time.perf_counter()
    start = {k: kernel.launches for k, kernel in kernels.items()}
    for _ in range(args.warmup):
        es, _ = ppo.train_iteration(es, gen)
    sync()
    cell.log(f"{args.warmup} warm-up iterations in "
             f"{time.perf_counter() - t_setup:.1f} s")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    seconds, metrics = [], []
    launches = {k: [] for k in kernels}
    sync()
    t_start = time.perf_counter()
    for _ in range(args.iters):
        before = {k: kernel.launches for k, kernel in kernels.items()}
        t0 = time.perf_counter()
        es, m = ppo.train_iteration(es, gen)
        sync()
        seconds.append(time.perf_counter() - t0)
        for k, kernel in kernels.items():
            launches[k].append(kernel.launches - before[k])
        metrics.append(m)
    window_s = time.perf_counter() - t_start
    finite = all(bool(torch.isfinite(v).all()) for m in metrics
                 for v in m.values())
    for k, kernel in kernels.items():
        cell.counts[f"{k}_launches"] = kernel.launches - start[k]
        cell.counts[f"{k}_launches_per_iteration"] = launches[k]
    cell.counts.update({
        "env_steps_per_iteration": env_steps,
        "timed_iterations": args.iters, "warmup_iterations": args.warmup,
        "model_flops_per_iteration": model_flops(
            ppo.net, (cfg.num_steps + 1) * n,
            cfg.updates_epochs * (env_steps // cfg.minibatch_size)
            * cfg.minibatch_size)})
    cell.check("finite", finite, f"every loss and metric of the "
                                 f"{args.iters} timed iterations finite")
    launch_checks(cell, solve, launches, per_iteration, "an iteration")
    if on_card:
        peak = torch.cuda.max_memory_allocated() / 1e9
        rate = env_steps * args.iters / window_s
        q = quantiles(seconds)
        cell.samples["iteration_s"] = q
        cell.metrics.update({
            "env_steps_per_s": rate, "iteration_s_median": q["median"],
            "peak_mem_gb": peak,
            "mfu": cell.counts["model_flops_per_iteration"] * args.iters
            / (window_s * measure.PEAK_F32_FLOP_S)})
        cell.log(f"env_steps_per_s {rate:.1f} ({args.iters} iterations x "
                 f"{env_steps} env steps in {window_s:.4f} s); an "
                 f"iteration: median {q['median']:.4f} s (p25 "
                 f"{q['p25']:.4f}, p75 {q['p75']:.4f}, min {q['min']:.4f}, "
                 f"max {q['max']:.4f}, n {q['n']}); peak memory "
                 f"{peak:.3f} GB; mfu {cell.metrics['mfu'] * 100:.3f}% of "
                 f"{cell.counts['model_flops_per_iteration']:.4g} FLOP an "
                 f"iteration at {measure.PEAK_F32_FLOP_S:.3g} FLOP/s")

    es = learner_check(cell, env, ppo, es, gen)
    target = (env.default_joint_pos_task
              + env.cfg.action_scale * es.action)[:, env.m2t]
    com = es.com_offset if env.cfg.events.com_displacement > 0.0 else None
    control_step_check(cell, env.engine, es.sim, target, es.mu, com)

    eng, kw = env.engine, env.engine.pgs_kwargs
    traced = on_card and not args.no_trace
    if traced:
        # the host split of a spanned iteration, then one under the profiler
        with PpoSpans(env, ppo, mark_after=cfg.num_steps) as spans:
            sync()
            t0 = time.perf_counter()
            es, _ = ppo.train_iteration(es, gen)
            sync()
            t1 = time.perf_counter()
        cell.metrics["rollout_s"] = spans.marks[0] - t0
        cell.metrics["learner_s"] = t1 - spans.marks[0]
        holder = {}

        def iteration():
            from torch.profiler import record_function

            with record_function("ppo.train_iteration"):
                holder["es"], _ = ppo.train_iteration(es, gen)

        with PpoSpans(env, ppo):
            bd = profiled(iteration, PpoSpans.NAMES + PpoSpans.GRAPHED)
        es = holder["es"]
        trace_device(cell, bd, per=1, unit="s")
        cell.log(f"spanned iteration {t1 - t0:.4f} s: rollout "
                 f"{cell.metrics['rollout_s']:.4f} s, learner "
                 f"{cell.metrics['learner_s']:.4f} s")

    # the substep and the contact problem after the window, at the default
    # pose
    target = env.default_joint_pos_task[env.m2t].expand(n, env.num_actions)
    com = es.com_offset if env.cfg.events.com_displacement > 0.0 else None
    physics_parts(cell, eng, es.sim, target, es.mu, com, traced)
    _, ops = eng.contact_problem(es.sim, target, es.mu, com)
    ops = tuple(t.contiguous() for t in ops)
    cell.check("solve", eng.solve is pgs.pgs_bj,
               f"the env's solve is {eng.solve.__name__}")
    cell.kernel_check(eng.solve, pgs.pgs_bj_reference, ops, kw)
    bound_ms = cell.kernel_bound("pgs_bj", ops, kw,
                                 ops[4].shape[1] + 2 * len(kw["blocks"]))
    if traced:
        cell.kernel_time("pgs_bj", lambda: eng.solve(*ops, **kw), bound_ms)
    return cell


def rough_traffic(dev, n: int, steps: int, seed: int):
    """The raw engine (the default SolverParams: GS-5, ``pgs_gs``) of the
    Solo12-CaT-Rough-v0 task's robot and terrain, the task's reset state
    of n envs, and the PD targets of ``steps`` control steps: each the
    env step's mapping (default pose + action_scale x action, in the
    model's joint order) of an action drawn as the recipe's policy draws
    its first ones, N(0, 1) (log std 0 about an action head initialised
    at gain 0.01). Returns (engine, state, targets (steps, n, nj), mu)."""
    from cat_tpu_torch.sim import engine
    from cat_tpu_torch.tasks import registry

    env = registry.get(ROUGH_TASK).make_env(n, device=dev)
    c = env.cfg
    eng = engine.make_batched_step(
        env.model, engine.EngineParams(dt=c.sim_dt, decimation=c.decimation,
                                       kp=c.kp, kd=c.kd),
        terrain=c.terrain, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    es = env.init(gen, n)
    actions = torch.randn((steps, n, env.num_actions), generator=gen,
                          device=dev)
    targets = (env.default_joint_pos_task
               + c.action_scale * actions)[..., env.m2t]
    return eng, es.sim, targets, es.mu


def engine_cell(dev, n: int, args, card: str) -> Cell:
    from cat_tpu_torch.ops import pgs
    from cat_tpu_torch.sim import terrain

    cell = Cell(ENGINE, card, ENGINE_METRICS)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    solve = "pgs_gs"
    kernels = cell_kernels(solve, pgs.GS_KERNEL)
    if on_card:
        load_kernels(cell, kernels)
    if args.iters % WINDOW:
        raise ValueError(f"--iters {args.iters}: the engine cell times "
                         f"whole windows of {WINDOW} control steps")
    steps = args.iters
    # then one step's check, the traced steps, the captured problem's
    extra = 2 + (TRACE_STEPS if on_card and not args.no_trace else 0)
    eng, s, targets, mu = rough_traffic(dev, n, args.warmup + steps + extra,
                                        args.seed)
    per_step = eng.params.decimation if on_card else 0

    t_setup = time.perf_counter()
    start = {k: kernel.launches for k, kernel in kernels.items()}
    for k in range(args.warmup):
        s = eng(s, targets[k], mu)
    sync()
    cell.log(f"{args.warmup} control steps in "
             f"{time.perf_counter() - t_setup:.1f} s")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    before = {k: kernel.launches for k, kernel in kernels.items()}
    windows = []
    sync()
    t_start = time.perf_counter()
    for w in range(steps // WINDOW):
        t0 = time.perf_counter()
        for k in range(WINDOW):
            s = eng(s, targets[args.warmup + w * WINDOW + k], mu)
        sync()
        windows.append((time.perf_counter() - t0) / WINDOW * 1e3)
    window_s = time.perf_counter() - t_start
    timed = {k: kernel.launches - before[k] for k, kernel in kernels.items()}
    k = args.warmup + steps
    rel_z = s.qpos[:, 2] - terrain.height_at(eng.terrain, s.qpos[:, 0:2])
    for name, kernel in kernels.items():
        cell.counts[f"{name}_launches"] = kernel.launches - start[name]
        cell.counts[f"{name}_launches_timed"] = timed[name]
    cell.counts.update({
        "timed_steps": steps, "warmup_steps": args.warmup,
        "base_height_over_terrain_m": {"median": float(rel_z.median()),
                                       "min": float(rel_z.min())}})
    launch_checks(cell, solve, {name: [t] for name, t in timed.items()},
                  per_step * steps, f"over the {steps} timed control steps")
    cell.check("finite", all(bool(torch.isfinite(t.float()).all())
                             for t in s), "the state after the timed steps")
    if on_card:
        peak = torch.cuda.max_memory_allocated() / 1e9
        ms = window_s / steps * 1e3
        q = quantiles(windows)
        cell.samples["window_ms"] = q
        cell.metrics.update({"engine_ms_per_control_step": ms,
                             "window_ms_median": q["median"],
                             "peak_mem_gb": peak})
        cell.log(f"engine_ms_per_control_step {ms:.3f} ({steps} control "
                 f"steps in {window_s:.4f} s); a window of {WINDOW}: "
                 f"median {q['median']:.3f} ms a step (p25 {q['p25']:.3f}, "
                 f"p75 {q['p75']:.3f}, min {q['min']:.3f}, max "
                 f"{q['max']:.3f}, n {q['n']}); peak memory {peak:.3f} GB")
    cell.log("base height over the terrain after the window: median "
             f"{float(rel_z.median()):.3f} m, min {float(rel_z.min()):.3f} m")

    s = control_step_check(cell, eng, s, targets[k], mu)
    k += 1
    traced = on_card and not args.no_trace
    if traced:
        spanned = spanned_engine(eng)
        holder = {"s": s}

        def control_steps():
            from torch.profiler import record_function

            for i in range(TRACE_STEPS):
                with record_function("engine.control_step"):
                    holder["s"] = spanned(holder["s"], targets[k + i], mu)

        bd = profiled(control_steps, ("engine.control_step",
                                      "engine.contact_problem",
                                      "engine.solve"))
        s = holder["s"]
        k += TRACE_STEPS
        trace_device(cell, bd, per=TRACE_STEPS, unit="ms")

    physics_parts(cell, eng, s, targets[k], mu, None, traced)
    _, ops = eng.contact_problem(s, targets[k], mu)
    ops = tuple(t.contiguous() for t in ops)
    kw = eng.pgs_kwargs
    cell.check("solve", eng.solve is pgs.pgs_gs,
               f"the raw engine's solve is {eng.solve.__name__}, "
               f"{kw['iterations']} sweeps")
    cell.kernel_check(eng.solve, pgs.pgs_gs_reference, ops, kw)
    bound_ms = cell.kernel_bound("pgs_gs", ops, kw, 3 * ops[4].shape[1])
    if traced:
        cell.kernel_time("pgs_gs", lambda: eng.solve(*ops, **kw), bound_ms)
    return cell


def trace_device(cell: Cell, bd: dict, per: int, unit: str):
    """The device metrics of a breakdown over ``per`` iterations or control
    steps: busy time and idle share of the traced run's own wall time (the
    profiler slows the host, so the share is that of the traced run)."""
    busy_s = bd["busy_s"] / per
    cell.metrics[f"device_busy_{unit}"] = busy_s * (1e3 if unit == "ms" else 1)
    cell.metrics["device_idle_share"] = 1.0 - bd["busy_s"] / bd["wall_s"]
    cell.metrics["kernels_launched"] = bd["kernels"] / per
    cell.breakdown = bd
    cell.check("trace", bd["busy_s"] <= bd["wall_s"],
               f"card busy {bd['busy_s']:.6f} s within the traced run's "
               f"{bd['wall_s']:.6f} s")
    cell.log(f"card busy {busy_s:.6f} s, idle "
             f"{cell.metrics['device_idle_share'] * 100:.1f}% of the traced "
             f"run's {bd['wall_s'] / per:.6f} s, {bd['kernels'] / per:.0f} "
             f"kernels (per {'iteration' if per == 1 else 'control step'}, "
             f"over {per}; {bd['linked_share'] * 100:.0f}% of them linked to "
             f"their launch call); top: " + "; ".join(
                 f"{k['name'][:60]} {k['device_ms']:.2f} ms x{k['count']} "
                 f"[{k['span']}]" for k in bd["top_kernels"][:5])
             + "; idle by span (ms): " + ", ".join(
                 f"{k} {v:.2f}" for k, v in list(
                     bd["idle_ms_by_span"].items())[:5]))


def physics_parts(cell: Cell, eng, sim, target, mu, com, timed: bool):
    """The substep on the state after the window: the substep kernels
    against the plain stages (check ``substep_vs_plain``; the contact
    kernel takes the plain dynamics' outputs; on a heightfield E and the
    frames at HFIELD_LIMIT, and the control ``substep_vs_plain_control``:
    the plain contact stage with the orientations R rounded through
    bfloat16 must put E or the frames outside it) and their bounds
    (counts), ``substep_post``'s from the impulses of the substep's own
    problem, solved;
    with ``timed``, the card's time of a substep's contact problem, of
    each substep kernel and of ``substep_post`` on the substep's own
    problem and impulses (CUDA-graph replays: no host cost), and a control
    step's (CUDA events over its graph replays)."""
    from cat_tpu_torch.ops import substep
    from cat_tpu_torch.sim import engine

    mt, params, terr = eng.mt, eng.params, eng.terrain
    args = (sim.qpos.contiguous(), sim.qvel.contiguous(),
            target.contiguous(), None if com is None else com.contiguous())
    with torch.no_grad():
        kern = substep.substep_dynamics(mt, params, *args)
        plain = engine.dynamics_stage(mt, params, *args)
        _, v_free, Minv, kin = plain
        kern_c = substep.contact_rows(mt, terr, kin, Minv, v_free)
        plain_c = engine.contact_stage(mt, terr, kin, Minv, v_free)
    cmp = measure.compare_stages(mt, terr, kern, kern_c, plain, plain_c, kin,
                                 HFIELD_LIMIT)
    cell.counts["substep_max_abs_err"] = cmp.worst
    cell.check("substep_vs_plain", cmp.ok,
               f"substep_dynamics / contact_rows against dynamics_stage / "
               f"contact_stage on the state after the window: {cmp.text}")
    if terr.kind == "hfield":
        rounded = kin._replace(R=kin.R.bfloat16().float())
        with torch.no_grad():
            ctl_c = engine.contact_stage(mt, terr, rounded, Minv, v_free)
        ctl = measure.compare_stages(mt, terr, plain, ctl_c, plain, plain_c,
                                     kin, HFIELD_LIMIT)
        caught = {"E", "frame"} & set(ctl.outside)
        cell.counts["substep_control_max_abs_err"] = ctl.worst
        cell.check("substep_vs_plain_control", bool(caught),
                   f"contact_stage with bfloat16-rounded orientations "
                   f"against it on the sound ones: {ctl.text}; E or frame "
                   f"must be outside")
    n = sim.qpos.shape[0]
    counts = measure.substep_counts(mt.model, n, hfield=terr.kind == "hfield")
    bounds = {name: cell.bound(name, *counts[name]) for name in counts}
    # the post stage's bound: the bytes and operations of the substep's own
    # impulses (W's columns and the frames of the contacts that hold one)
    with torch.no_grad():
        (tau_j, vf, W, frame), ops = eng.contact_problem(sim, target, mu, com)
        lam = eng.solve(*ops, **eng.pgs_kwargs)
    bounds["substep_post"] = cell.bound("substep_post", *measure.post_counts(
        mt.model, n, frame is not None, lam))
    if not timed:
        return
    with torch.no_grad():
        cell.metrics["contact_problem_ms"] = measure.graph_ms(
            lambda: eng.contact_problem(sim, target, mu, com), GRAPH_REPS)
        cell.metrics["control_step_ms"] = measure.cuda_ms(
            lambda: eng(sim, target, mu, com), 10)
        cell.kernel_time("substep_post",
                         lambda: engine.substep_post(mt, params, sim, tau_j,
                                                     vf, W, lam, frame),
                         bounds["substep_post"])
        cell.kernel_time("substep_dynamics",
                         lambda: substep.DYN_KERNEL(mt, params, *args),
                         bounds["substep_dynamics"])
        cell.kernel_time("contact_rows",
                         lambda: substep.CONTACT_KERNEL(mt, terr, kin, Minv,
                                                        v_free),
                         bounds["contact_rows"])
    cell.log(f"contact problem {cell.metrics['contact_problem_ms']:.4f} ms, "
             f"substep_post {cell.metrics['substep_post_ms']:.4f} ms a "
             f"substep ({GRAPH_REPS} replayed in a CUDA graph); control step "
             f"{cell.metrics['control_step_ms']:.3f} ms (CUDA events)")


RUNNERS = {FLAT: functools.partial(ppo_cell, FLAT),
           ROUGH_PPO: functools.partial(ppo_cell, ROUGH_PPO),
           ENGINE: engine_cell}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cell", choices=CELLS, action="append",
                   help="a cell to run (repeatable; default: all in turn)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--warmup", type=int, default=None,
                   help="PPO cells: iterations (3); engine: control steps "
                        "(50)")
    p.add_argument("--iters", type=int, default=None,
                   help="PPO cells: timed iterations (30); engine: timed "
                        f"control steps, whole windows of {WINDOW} (500)")
    p.add_argument("--num_envs", type=int, default=FULL_ENVS,
                   help="for rehearsals only: the cells are at 4096")
    p.add_argument("--no-trace", dest="no_trace", action="store_true",
                   help="no per-layer run after the timed window")
    p.add_argument("--device", default="cuda",
                   help="cpu rehearses: counts and checks, no times")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        card = measure.card_line()
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": torch.cuda.device_count(), "card": card}
    else:
        card = f"{dev.type}: no card, times not measured"
        device = {"platform": dev.type, "kind": dev.type, "count": 0}
    print(f"[bench] {card} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | seed {args.seed}", flush=True)
    results = []
    for name in args.cell or CELLS:
        cell_args = argparse.Namespace(**vars(args))
        for k, v in DEFAULTS[name].items():
            if getattr(cell_args, k) is None:
                setattr(cell_args, k, v)
        results.append(RUNNERS[name](dev, args.num_envs, cell_args,
                                     card).result())
    out = {"correct": all(r["correct"] for r in results), "cells": results,
           "device": device}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["correct"] else 1)
