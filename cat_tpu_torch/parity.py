"""Compare the learning curve of a port run with a reference run.

  python -m cat_tpu_torch.parity PORT/metrics.jsonl \
      runs/solo12_flat_2000it/metrics.jsonl.gz [--first 1] [--last 2000]

Both logs are ``metrics.jsonl`` files (or ``.jsonl.gz``) with the
reference's keys and a ``step`` field; a log in which a step repeats (a
resumed run appends to its log) is refused. The compared span is the
iterations [first, last] (by default the port log's first and last) of both
runs; the final window is its last WINDOW iterations. The gates are copies
of those of tools/backend_parity.py:40-65, 137-200:
  * the final window's mean reward per step within REL_TOL of the
    reference's;
  * the final window's mean episode length within EP_LEN_REL_TOL of the
    reference's, or within EP_LEN_ABS_TOL steps of it;
  * every hard constraint (a term whose Curriculum max_p is 1.0) violated
    in under HARD_VIOL_PCT percent of the port's episodes in the window;
  * the reward rises: the span's first WINDOW iterations have a lower mean
    reward per step than its last WINDOW (on where the span holds two
    windows that do not overlap);
  * the curve gates, on where the span holds CURVE_MIN_ITERS iterations:
    each hard term's violation curve, smoothed by the centered SMOOTH-
    iteration mean, over the span's last 75%, deviates from the
    REFERENCE's smoothed curve by at most CURVE_MAD_PP percentage points
    on average and CURVE_MAX_PP at any point. (tools/backend_parity.py
    measures a backend against the median of three; against one
    reference, the median of the two curves would halve every deviation.)
Prints one JSON object; exits 1 if a gate fails.
"""

from __future__ import annotations

import argparse
import gzip
import json
import sys
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np

REL_TOL = 0.35
EP_LEN_REL_TOL = 0.20
EP_LEN_ABS_TOL = 75.0
HARD_VIOL_PCT = 10.0
WINDOW = 30
SMOOTH = 51             # centered moving-average window (iterations)
CURVE_MAD_PP = 1.5      # mean |deviation| over the span's last 75%
CURVE_MAX_PP = 6.0      # pointwise max |deviation| there
CURVE_MIN_ITERS = 1000  # the curve gates need a recipe-length span


def load_metrics(path: str) -> List[Dict[str, float]]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return [json.loads(line) for line in f if line.strip()]


def hard_terms(row: Dict[str, float]) -> List[str]:
    """The hard constraints: max_p 1.0, no curriculum."""
    pre, post = "Curriculum/", "_max_p"
    return sorted(f"cstr_{k[len(pre):-len(post)]}" for k, v in row.items()
                  if k.startswith(pre) and k.endswith(post) and v == 1.0)


def _mean(rows, key) -> float:
    return sum(r[key] for r in rows) / len(rows)


def _smooth(x) -> np.ndarray:
    return np.convolve(np.asarray(x, dtype=np.float64),
                       np.ones(SMOOTH) / SMOOTH, mode="valid")


def _span(rows: List[dict], first: int, last: int, name: str) -> List[dict]:
    dup = sorted(s for s, n in Counter(r["step"] for r in rows).items()
                 if n > 1)
    if dup:
        raise ValueError(f"the {name} log repeats steps {dup[:5]}"
                         f"{'...' if len(dup) > 5 else ''} (a resumed run "
                         f"appends): keep one copy of each")
    out = sorted((r for r in rows if first <= r["step"] <= last),
                 key=lambda r: r["step"])
    if not out:
        raise ValueError(f"no iterations in [{first}, {last}] in the {name} "
                         f"log")
    return out


def compare(port: List[dict], ref: List[dict], first: Optional[int] = None,
            last: Optional[int] = None) -> dict:
    last = last if last is not None else max(r["step"] for r in port)
    first = first if first is not None else min(r["step"] for r in port)
    ps, rs = _span(port, first, last, "port"), _span(ref, first, last,
                                                     "reference")
    if [r["step"] for r in ps] != [r["step"] for r in rs]:
        raise ValueError(f"[{first}, {last}] holds other steps in the two "
                         f"logs ({len(ps)} port, {len(rs)} reference)")
    pw, rw = ps[-WINDOW:], rs[-WINDOW:]
    failures = []
    rew_p = _mean(pw, "Train/mean_reward_per_step")
    rew_r = _mean(rw, "Train/mean_reward_per_step")
    rew_rel = abs(rew_p - rew_r) / max(abs(rew_r), 1e-9)
    if rew_rel > REL_TOL:
        failures.append(f"reward/step {rew_p:.5f} is {rew_rel:.0%} from the "
                        f"reference's {rew_r:.5f} (> {REL_TOL:.0%})")
    len_p, len_r = _mean(pw, "Episode/length"), _mean(rw, "Episode/length")
    len_dev = abs(len_p - len_r)
    len_rel = len_dev / max(len_r, 1e-9)
    if len_rel > EP_LEN_REL_TOL and len_dev > EP_LEN_ABS_TOL:
        failures.append(f"episode length {len_p:.1f} is {len_rel:.0%} and "
                        f"{len_dev:.0f} steps from the reference's {len_r:.1f}"
                        f" (> {EP_LEN_REL_TOL:.0%} and > {EP_LEN_ABS_TOL:.0f})")
    terms = hard_terms(ps[0])
    hard = {}
    for term in terms:
        key = f"Episode_Constraint_violation/{term}"
        hard[term] = {"port": _mean(pw, key), "reference": _mean(rw, key)}
        if hard[term]["port"] >= HARD_VIOL_PCT:
            failures.append(f"{term} violated in {hard[term]['port']:.2f}% "
                            f"of episodes (>= {HARD_VIOL_PCT}%)")

    rises_on = len(ps) >= 2 * WINDOW
    start = _mean(ps[:WINDOW], "Train/mean_reward_per_step")
    if rises_on and not start < rew_p:
        failures.append(f"reward/step did not rise ({start:.5f} in the first "
                        f"{WINDOW} iterations, {rew_p:.5f} in the last)")

    curves_on = len(ps) >= CURVE_MIN_ITERS
    curves = {}
    if curves_on:
        tail = slice((len(ps) - SMOOTH + 1) // 4, None)
        for term in terms:
            key = f"Episode_Constraint_violation/{term}"
            dev = np.abs(_smooth([r[key] for r in ps])
                         - _smooth([r[key] for r in rs]))[tail]
            mad, mx = float(dev.mean()), float(dev.max())
            curves[term] = {"mean_pp": mad, "max_pp": mx}
            if mad > CURVE_MAD_PP:
                failures.append(f"{term} curve mean deviation {mad:.2f} pp "
                                f"> {CURVE_MAD_PP} pp")
            if mx > CURVE_MAX_PP:
                failures.append(f"{term} curve max deviation {mx:.2f} pp > "
                                f"{CURVE_MAX_PP} pp")
    secs = np.array([r["Perf/iter_seconds"] for r in ps
                     if "Perf/iter_seconds" in r])
    return {
        "span": [first, last], "iterations": len(ps),
        "window": [pw[0]["step"], last],
        "reward_per_step": {"port": rew_p, "reference": rew_r,
                            "rel_diff": rew_rel, "limit": REL_TOL},
        "episode_length": {"port": len_p, "reference": len_r,
                           "rel_diff": len_rel, "abs_diff": len_dev,
                           "limits": [EP_LEN_REL_TOL, EP_LEN_ABS_TOL]},
        "hard_violation_pct": hard, "hard_limit_pct": HARD_VIOL_PCT,
        "reward_rises": {"on": rises_on, "first_window": start,
                         "last_window": rew_p},
        "curve_gates": {"on": curves_on, "smooth_iters": SMOOTH,
                        "mean_limit_pp": CURVE_MAD_PP,
                        "max_limit_pp": CURVE_MAX_PP,
                        "min_iterations": CURVE_MIN_ITERS,
                        "hard_curve_dev": curves},
        "port_iter_seconds": (
            {"median": float(np.median(secs)), "min": float(secs.min()),
             "p10": float(np.percentile(secs, 10)),
             "p90": float(np.percentile(secs, 90)), "max": float(secs.max()),
             "total": float(secs.sum())} if len(secs) else None),
        "failures": failures, "pass": not failures,
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("port")
    p.add_argument("reference")
    p.add_argument("--first", type=int, default=None)
    p.add_argument("--last", type=int, default=None)
    args = p.parse_args(argv)
    result = compare(load_metrics(args.port), load_metrics(args.reference),
                     args.first, args.last)
    result["logs"] = {"port": args.port, "reference": args.reference}
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["pass"] else 1)
