"""Compare the learning curve of a port run with a reference run.

  python -m cat_tpu_torch.parity PORT/metrics.jsonl \
      runs/solo12_flat_2000it/metrics.jsonl.gz [--first 171] [--last 200]

Both logs are ``metrics.jsonl`` files (or ``.jsonl.gz``) with the
reference's keys and a ``step`` field. The window is the iterations
[first, last] (by default the port run's last 30) of both runs. The gates
are copies of those of tools/backend_parity.py:40-65:
  * the window's mean reward per step within REL_TOL of the reference's;
  * the window's mean episode length within EP_LEN_REL_TOL of the
    reference's, or within EP_LEN_ABS_TOL steps of it;
  * every hard constraint (a term whose Curriculum max_p is 1.0) violated
    in under HARD_VIOL_PCT percent of the port's episodes in the window.
Prints one JSON object; exits 1 if a gate fails.
"""

from __future__ import annotations

import argparse
import gzip
import json
import sys
from typing import Dict, List, Optional, Sequence

REL_TOL = 0.35
EP_LEN_REL_TOL = 0.20
EP_LEN_ABS_TOL = 75.0
HARD_VIOL_PCT = 10.0
WINDOW = 30


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


def compare(port: List[dict], ref: List[dict], first: Optional[int] = None,
            last: Optional[int] = None) -> dict:
    last = last if last is not None else port[-1]["step"]
    first = first if first is not None else last - WINDOW + 1
    pw = [r for r in port if first <= r["step"] <= last]
    rw = [r for r in ref if first <= r["step"] <= last]
    if not pw or not rw:
        raise ValueError(f"no iterations in [{first}, {last}] in one of the "
                         f"logs ({len(pw)} port, {len(rw)} reference)")
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
    hard = {}
    for term in hard_terms(pw[0]):
        key = f"Episode_Constraint_violation/{term}"
        hard[term] = {"port": _mean(pw, key), "reference": _mean(rw, key)}
        if hard[term]["port"] >= HARD_VIOL_PCT:
            failures.append(f"{term} violated in {hard[term]['port']:.2f}% "
                            f"of episodes (>= {HARD_VIOL_PCT}%)")
    return {
        "window": [first, last], "iterations": [len(pw), len(rw)],
        "reward_per_step": {"port": rew_p, "reference": rew_r,
                            "rel_diff": rew_rel, "limit": REL_TOL},
        "episode_length": {"port": len_p, "reference": len_r,
                           "rel_diff": len_rel, "abs_diff": len_dev,
                           "limits": [EP_LEN_REL_TOL, EP_LEN_ABS_TOL]},
        "hard_violation_pct": hard, "hard_limit_pct": HARD_VIOL_PCT,
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
