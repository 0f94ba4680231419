"""Train a CaT policy with the port (the slice of scripts/train.py that the
flat clean_rl recipe needs).

  python -m cat_tpu_torch.train --task Solo12-CaT-Flat-v0 --num_envs 4096 \
      --max_iterations 2 [--seed 1] [--device cpu] [--override k=v ...]

(on the CPU at a few envs, shrink the minibatch to fit the batch, e.g.
--num_envs 8 --override num_steps=4 minibatch_size=16).

Runs on the first CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time
from typing import Dict, List, Optional, Sequence

import torch

from cat_tpu_torch import resolve_device
from cat_tpu_torch.tasks import registry


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--task", default="Solo12-CaT-Flat-v0")
    p.add_argument("--num_envs", type=int, default=None)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--max_iterations", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--override", nargs="*", default=[],
                   help="agent cfg overrides key=value (e.g. num_steps=4)")
    return p.parse_args(argv)


def apply_overrides(cfg, overrides: Sequence[str]):
    """key=value overrides of a flat dataclass, parsed by the field's type."""
    kw = {}
    for item in overrides:
        key, _, val = item.partition("=")
        cur = getattr(cfg, key)
        if isinstance(cur, bool):
            kw[key] = val.lower() in ("1", "true", "yes")
        else:
            kw[key] = type(cur)(val)
    return dataclasses.replace(cfg, **kw)


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, float]]:
    """Train; returns the metrics of every iteration (floats)."""
    from cat_tpu_torch.rl.ppo import PPO

    args = parse_args(argv)
    device = resolve_device(args.device)
    spec = registry.get(args.task)
    cfg = apply_overrides(spec.make_agent_cfg(), args.override)
    if args.max_iterations:
        cfg = dataclasses.replace(cfg, num_iterations=args.max_iterations)
    num_envs = args.num_envs or 4096
    env = spec.make_env(num_envs, device=device)
    print(env.cset.table(), flush=True)

    gen_env = torch.Generator(device=device).manual_seed(args.seed)
    gen_ppo = torch.Generator(device=device).manual_seed(args.seed + 0x5EED)
    gen_init = torch.Generator().manual_seed(args.seed)
    es = env.init(gen_env, num_envs)
    ppo = PPO(env, cfg, gen_init)
    ppo.start(env.observe(es, gen_env))

    print(f"training {args.task}: {num_envs} envs on {device}, "
          f"{cfg.num_iterations} iterations", flush=True)
    steps_per_iter = cfg.num_steps * num_envs
    history = []
    for it in range(1, cfg.num_iterations + 1):
        t0 = time.perf_counter()
        es, metrics = ppo.train_iteration(es, gen_ppo)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - t0
        loss = metrics["Loss/mean_surrogate_loss"]
        if not (math.isfinite(loss)
                and math.isfinite(metrics["Train/mean_reward_per_step"])):
            print(f"FATAL: non-finite loss at iteration {it} (loss={loss})",
                  flush=True)
            sys.exit(1)
        metrics["Perf/env_steps_per_sec"] = steps_per_iter / dt
        metrics["Perf/iter_seconds"] = dt
        history.append(metrics)
        print(f"iter {it:5d} | {steps_per_iter / dt:9.0f} steps/s | "
              f"rew/step {metrics['Train/mean_reward_per_step']:.4f} | "
              f"ep_len {metrics['Episode/length']:.0f} | loss {loss:.4f}",
              flush=True)
    return history


if __name__ == "__main__":
    main()
