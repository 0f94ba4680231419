"""Preemption drill: SIGKILL a training run once a checkpoint lands, resume
it, and check that its metrics log has no gap (the port's counterpart of
tools/resume_drill.py).

  python -m cat_tpu_torch.tools.resume_drill [--num_envs 256] [--iters 40]
      [--save_interval 10] [--kill_after 20] [--device cuda]
      [--logdir DIR] [--out PATH]

  1. starts ``python -m cat_tpu_torch.train --task Solo12-CaT-Flat-v0``
     (``--iters`` iterations, a checkpoint every ``--save_interval``,
     minibatch_size = num_envs x 24 / 6) as a child process, logging under
     its own ``--logdir`` (default: a new temporary directory);
  2. SIGKILLs that child, by its pid, once ``ckpt_<kill_after>.pt`` exists.
     The trainer writes a checkpoint to a temporary file and renames it
     (``rl/checkpoint.py``), so the file is whole once it exists;
  3. resumes with ``--checkpoint ckpt_<kill_after>`` into the same run
     directory;
  4. requires that metrics.jsonl covers iterations 1..iters with no gap,
     that the lines the resumed leg appended are exactly kill_after + 1
     .. iters, in order, and that every reward is finite. The log is
     appended to, so iterations the killed run logged after the
     checkpoint appear twice: harmless.

Each leg may take LEG_TIMEOUT_S seconds.

Writes the result as JSON to runs/smokes/torch_resume_drill.json or
``--out``; exits 1 unless it passes.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

TASK = "Solo12-CaT-Flat-v0"
AGENT = "clean_rl"
RUN = "resume_drill"
SEED = 11
OUT = os.path.join("runs", "smokes", "torch_resume_drill.json")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
POLL_S = 0.05
LEG_TIMEOUT_S = 300.0


def _child_env() -> dict:
    """The environment of a child: this one, with the repository on the
    import path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num_envs", type=int, default=256)
    p.add_argument("--iters", type=int, default=40)
    p.add_argument("--save_interval", type=int, default=10)
    p.add_argument("--kill_after", type=int, default=20)
    p.add_argument("--device", default="cuda")
    p.add_argument("--logdir", default=None)
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    if args.kill_after % args.save_interval or not (
            0 < args.kill_after < args.iters):
        raise SystemExit("--kill_after must be a checkpoint before --iters")

    n = args.num_envs
    logdir = args.logdir or tempfile.mkdtemp(prefix="resume_drill_")
    run_dir = os.path.join(logdir, AGENT, TASK, RUN)
    ckpt = os.path.join(run_dir, f"ckpt_{args.kill_after}")
    metrics = os.path.join(run_dir, "metrics.jsonl")
    for f in (ckpt + ".pt", metrics):
        if os.path.exists(f):
            os.remove(f)

    base_cmd = [
        sys.executable, "-m", "cat_tpu_torch.train", "--task", TASK,
        "--agent", AGENT, "--num_envs", str(n), "--seed", str(SEED),
        "--max_iterations", str(args.iters), "--device", args.device,
        "--logdir", logdir, "--run_name", RUN, "--writer", "none",
        "--override", f"minibatch_size={n * 24 // 6}",
        f"save_interval={args.save_interval}",
    ]
    print("==> starting:", " ".join(base_cmd), flush=True)
    t0 = time.time()
    child = subprocess.Popen(base_cmd, cwd=REPO, env=_child_env())
    try:
        while not os.path.exists(ckpt + ".pt"):
            if child.poll() is not None:
                raise SystemExit(
                    f"trainer exited early, rc {child.returncode}")
            if time.time() - t0 > LEG_TIMEOUT_S:
                raise SystemExit(f"timeout waiting for {ckpt}.pt")
            time.sleep(POLL_S)
        landed = time.time() - t0
        print(f"==> {os.path.basename(ckpt)}.pt landed after {landed:.1f} s; "
              f"SIGKILL pid {child.pid}", flush=True)
        os.kill(child.pid, signal.SIGKILL)  # the exact pid: a preemption
        child.wait()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    killed = child.returncode == -signal.SIGKILL
    with open(metrics) as f:
        before = [json.loads(line)["step"] for line in f]

    resume_cmd = base_cmd + ["--checkpoint", ckpt]
    print("==> resuming:", " ".join(resume_cmd), flush=True)
    t1 = time.time()
    subprocess.run(resume_cmd, cwd=REPO, env=_child_env(), check=True,
                   timeout=LEG_TIMEOUT_S)
    resumed_s = time.time() - t1

    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    steps = [r["step"] for r in rows]
    rewards = [r["Train/mean_reward_per_step"] for r in rows]
    covered = sorted(set(steps))
    no_gap = set(range(1, args.iters + 1)) <= set(covered) and (
        covered[0] == 1 and covered[-1] == args.iters)
    # the lines the resumed leg appended after the killed run's
    resumed_leg = steps[len(before):]
    resumed_from = resumed_leg[0] if resumed_leg else None
    finite = all(math.isfinite(r) and abs(r) < 1e6 for r in rewards)
    out = {
        "num_envs": n, "iterations": args.iters,
        "save_interval": args.save_interval,
        "killed_after_ckpt": args.kill_after,
        "child_pid": child.pid, "killed_by_sigkill": killed,
        "ckpt_landed_s": landed, "resumed_leg_s": resumed_s,
        "logged_before_kill": [min(before), max(before)] if before else [],
        "lines_before_kill": len(before),
        "resumed_leg_lines": len(resumed_leg),
        "iterations_covered": [covered[0], covered[-1]],
        f"no_gap_1_to_{args.iters}": no_gap,
        "resumed_from_iteration": resumed_from,
        "resumed_leg_in_order": resumed_leg == list(
            range(args.kill_after + 1, args.iters + 1)),
        "rewards_finite": finite,
        "final_reward_window": sum(rewards[-5:]) / len(rewards[-5:]),
    }
    out["pass"] = bool(killed and no_gap and finite
                       and resumed_from == args.kill_after + 1
                       and out["resumed_leg_in_order"])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1), flush=True)
    print(("PASS" if out["pass"] else "FAIL") + f": SIGKILL after "
          f"ckpt_{args.kill_after}, resumed, metrics 1..{args.iters}",
          flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["pass"] else 1)
