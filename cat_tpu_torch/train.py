"""Train a CaT policy with the port (the counterpart of scripts/train.py).

  python -m cat_tpu_torch.train --task Solo12-CaT-Flat-v0 --num_envs 4096 \
      [--agent clean_rl|rl_games|skrl] [--max_iterations N] [--seed 1] \
      [--logdir logs] [--run_name NAME] [--checkpoint RUN/ckpt_K] \
      [--writer tensorboard|wandb|none] [--override k=v ...] \
      [--env_override a.b=v ...] [--device cpu]

A run logs under <logdir>/<agent>/<task>/<run_name>/: ``config.json``,
``metrics.jsonl`` (one line an iteration, the reference's keys),
``ckpt_<it>.pt`` every ``save_interval`` iterations and ``ckpt_final.pt``.
``--checkpoint`` resumes the whole state (learner, envs, generators) and
goes on to ``--max_iterations``. On the CPU at a few envs, shrink the
minibatch to fit the batch, e.g. ``--num_envs 8 --device cpu --override
num_steps=4 minibatch_size=16``.

Runs on the first CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from cat_tpu_torch import resolve_device
from cat_tpu_torch.rl import agent_cfgs, checkpoint
from cat_tpu_torch.rl.ppo import PPO, PpoCfg
from cat_tpu_torch.tasks import registry
from cat_tpu_torch.utils.logging import MetricLogger
from cat_tpu_torch.utils.overrides import apply_overrides

AGENTS = ("clean_rl", "rl_games", "skrl")


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--task", default="Solo12-CaT-Flat-v0")
    p.add_argument("--agent", default="clean_rl", choices=AGENTS,
                   help="the RL backend's recipe (rl/agent_cfgs.py)")
    p.add_argument("--num_envs", type=int, default=None)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--max_iterations", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--logdir", default="logs")
    p.add_argument("--run_name", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="resume from this checkpoint (.pt may be left out)")
    p.add_argument("--writer", default="tensorboard",
                   choices=["tensorboard", "wandb", "none"],
                   help="metric writer on top of JSONL")
    p.add_argument("--override", nargs="*", default=[],
                   help="agent cfg overrides key=value (e.g. num_steps=4)")
    p.add_argument("--env_override", nargs="*", default=[],
                   help="env cfg dotted-path overrides (e.g. "
                        "events.push_enabled=False)")
    return p.parse_args(argv)


def agent_cfg(args, spec) -> PpoCfg:
    """The agent's preset, then ``--override`` and ``--max_iterations``."""
    if args.agent == "clean_rl":
        cfg = spec.make_agent_cfg()
    else:
        kw = {"num_envs": args.num_envs or 4096} if args.agent == "skrl" else {}
        cfg = agent_cfgs.get(args.agent, **kw)
    cfg = apply_overrides(cfg, args.override)
    if args.max_iterations:
        cfg = dataclasses.replace(cfg, num_iterations=args.max_iterations)
    return cfg


class Trainer:
    """The state of a training run: the env, the learner, the envs' state
    and the run's generators ("env" draws the initial state, "ppo" every
    draw of an iteration)."""

    def __init__(self, args):
        self.device = resolve_device(args.device)
        spec = registry.get(args.task)
        self.cfg = agent_cfg(args, spec)
        self.num_envs = args.num_envs or 4096
        self.env = spec.make_env(self.num_envs,
                                 overrides=tuple(args.env_override),
                                 device=self.device)
        self.generators = {
            "env": torch.Generator(device=self.device).manual_seed(args.seed),
            "ppo": torch.Generator(device=self.device).manual_seed(
                args.seed + 0x5EED),
        }
        self.es = self.env.init(self.generators["env"], self.num_envs)
        self.ppo = PPO(self.env, self.cfg,
                       torch.Generator().manual_seed(args.seed))
        self.ppo.start(self.env.observe(self.es, self.generators["env"]))

    def train_iteration(self) -> Dict[str, float]:
        self.es, metrics = self.ppo.train_iteration(self.es,
                                                    self.generators["ppo"])
        values = torch.stack([v.float() for v in metrics.values()]).tolist()
        return dict(zip(metrics, values))

    def save(self, path: str) -> str:
        return checkpoint.save(path, self.ppo, self.es, self.generators)

    def restore(self, path: str, strict: bool = True):
        self.es = checkpoint.restore(path, self.ppo, self.es, self.generators,
                                     strict=strict)


def _json_default(o):
    """config.json: arrays (a heightfield's grid) by shape, not by value."""
    if isinstance(o, np.ndarray):
        return {"ndarray_shape": list(o.shape), "dtype": str(o.dtype)}
    if isinstance(o, (np.integer, np.floating)):
        return o.item()
    return str(o)


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, float]]:
    """Train; returns the metrics of every iteration run (floats)."""
    args = parse_args(argv)
    tr = Trainer(args)
    cfg = tr.cfg
    print(tr.env.cset.table(), flush=True)

    run_name = args.run_name or time.strftime("%Y-%m-%d_%H-%M-%S")
    run_path = os.path.join(args.logdir, args.agent, args.task, run_name)
    os.makedirs(run_path, exist_ok=True)
    with open(os.path.join(run_path, "config.json"), "w") as f:
        json.dump({"task": args.task, "agent": args.agent,
                   "num_envs": tr.num_envs, "seed": args.seed,
                   "device": str(tr.device),
                   "agent_cfg": dataclasses.asdict(cfg),
                   "env_cfg": dataclasses.asdict(tr.env.cfg)},
                  f, indent=1, default=_json_default)
    if args.checkpoint:
        tr.restore(args.checkpoint)
        print(f"resumed from {args.checkpoint} at iteration "
              f"{tr.ppo.iteration}", flush=True)

    print(f"training {args.task} ({args.agent}): {tr.num_envs} envs on "
          f"{tr.device}, to iteration {cfg.num_iterations}; logs at "
          f"{run_path}", flush=True)
    logger = MetricLogger(run_path, writer=args.writer)
    steps_per_iter = cfg.num_steps * tr.num_envs
    history = []
    last_ckpt = args.checkpoint
    try:
        for it in range(tr.ppo.iteration + 1, cfg.num_iterations + 1):
            t0 = time.perf_counter()
            metrics = tr.train_iteration()
            dt = time.perf_counter() - t0
            loss = metrics["Loss/mean_surrogate_loss"]
            if not (math.isfinite(loss)
                    and math.isfinite(metrics["Train/mean_reward_per_step"])):
                bad = tr.save(os.path.join(run_path, f"ckpt_diverged_{it}"))
                print(f"FATAL: non-finite loss at iteration {it} "
                      f"(loss={loss}); diverged state dumped to {bad}",
                      flush=True)
                if last_ckpt:
                    print(f"resume from the last good checkpoint with:\n"
                          f"  --checkpoint {last_ckpt}", flush=True)
                sys.exit(1)
            metrics["Perf/env_steps_per_sec"] = steps_per_iter / dt
            metrics["Perf/iter_seconds"] = dt
            logger.log(metrics, it)
            history.append(metrics)
            if it == 1 or it % 10 == 0 or it == cfg.num_iterations:
                print(f"iter {it:5d} | {steps_per_iter / dt:9.0f} steps/s | "
                      f"rew/step {metrics['Train/mean_reward_per_step']:.4f}"
                      f" | ep_len {metrics['Episode/length']:.0f} | loss "
                      f"{loss:.4f}", flush=True)
            if it % cfg.save_interval == 0:
                last_ckpt = tr.save(os.path.join(run_path, f"ckpt_{it}"))
                print(f"saved {last_ckpt}", flush=True)
        tr.save(os.path.join(run_path, "ckpt_final"))
    finally:
        logger.close()
    print(f"done; logs at {run_path}", flush=True)
    return history


if __name__ == "__main__":
    main()
