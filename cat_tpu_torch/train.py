"""Train a CaT policy with the port (the counterpart of scripts/train.py).

  python -m cat_tpu_torch.train --task Solo12-CaT-Flat-v0 --num_envs 4096 \
      [--agent clean_rl|rl_games|skrl] [--max_iterations N] [--seed 1] \
      [--logdir logs] [--run_name NAME] [--checkpoint RUN/ckpt_K] \
      [--writer tensorboard|wandb|none] [--override k=v ...] \
      [--env_override a.b=v ...] [--device cpu] [--single_chip] \
      [--coordinator HOST:PORT --num_processes N --process_id I]

A run logs under <logdir>/<agent>/<task>/<run_name>/: ``config.json``,
``metrics.jsonl`` (one line an iteration, the reference's keys),
``ckpt_<it>.pt`` every ``save_interval`` iterations and ``ckpt_final.pt``.
``--checkpoint`` resumes the whole state (learner, envs, generators) and
goes on to ``--max_iterations``. On the CPU at a few envs, shrink the
minibatch to fit the batch, e.g. ``--num_envs 8 --device cpu --override
num_steps=4 minibatch_size=16``.

Runs on the CUDA cards unless ``--device cpu`` is given, one process a
card, the env batch split over the processes (``rl/ppo.py``: the
reference's data-parallel iteration): under torchrun (``torchrun
--nproc_per_node N -m cat_tpu_torch.train ...``) it joins torchrun's group;
with ``--coordinator``, ``--num_processes`` and ``--process_id`` (the
reference's flags) it joins that group; started alone where more than one
card is visible it starts one process a card itself, unless
``--single_chip``. ``--num_envs`` and ``minibatch_size`` are global and
must divide by the number of processes. Rank 0 alone writes the logs, the
prints and the checkpoints; every rank takes part in a checkpoint's save.
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
from cat_tpu_torch.parallel import distributed
from cat_tpu_torch.parallel.distributed import DistContext
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
    p.add_argument("--single_chip", action="store_true",
                   help="one process on one card, even where more are "
                        "visible")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0's store (or an init_method "
                        "URL) to train over several processes")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
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
    draw of an iteration). With ``dist`` (a group), this rank's share of
    the envs: its generators are seeded from the base seed + its rank, the
    network from the base seed."""

    def __init__(self, args, dist: Optional[DistContext] = None):
        self.dist = dist or DistContext(0, 1, args.seed, True, None,
                                        resolve_device(args.device))
        self.device = self.dist.device
        spec = registry.get(args.task)
        self.cfg = agent_cfg(args, spec)
        self.num_envs = args.num_envs or 4096
        self.env = spec.make_env(self.num_envs,
                                 overrides=tuple(args.env_override),
                                 device=self.device)
        self.generators = {
            "env": torch.Generator(device=self.device).manual_seed(
                self.dist.seed),
            "ppo": torch.Generator(device=self.device).manual_seed(
                args.seed + 0x5EED + self.dist.rank),
        }
        self.es = self.env.init(
            self.generators["env"],
            distributed.local_env_count(self.num_envs, self.dist))
        self.ppo = PPO(self.env, self.cfg,
                       torch.Generator().manual_seed(args.seed),
                       dist=self.grouped)
        self.ppo.start(self.env.observe(self.es, self.generators["env"]))

    @property
    def grouped(self) -> Optional[DistContext]:
        return self.dist if self.dist.group is not None else None

    def train_iteration(self) -> Dict[str, float]:
        self.es, metrics = self.ppo.train_iteration(self.es,
                                                    self.generators["ppo"])
        values = torch.stack([v.float() for v in metrics.values()]).tolist()
        return dict(zip(metrics, values))

    def save(self, path: str) -> str:
        """Every rank calls it; rank 0 writes."""
        return checkpoint.save(path, self.ppo, self.es, self.generators,
                               self.grouped)

    def restore(self, path: str, strict: bool = True):
        self.es = checkpoint.restore_local_shard(
            path, self.ppo, self.es, self.generators, self.dist.rank,
            self.dist.world_size, strict)


def _json_default(o):
    """config.json: arrays (a heightfield's grid) by shape, not by value."""
    if isinstance(o, np.ndarray):
        return {"ndarray_shape": list(o.shape), "dtype": str(o.dtype)}
    if isinstance(o, (np.integer, np.floating)):
        return o.item()
    return str(o)


def _spawns(args) -> bool:
    """Started alone, with no group, where more than one card is visible:
    train on all of them (the reference's default uses every device)."""
    return (not args.single_chip and args.coordinator is None
            and "RANK" not in os.environ
            and torch.device(args.device).type == "cuda"
            and torch.cuda.is_available() and torch.cuda.device_count() > 1)


def spawn(argv: Sequence[str], nprocs: int, backend: Optional[str] = None,
          coordinator: Optional[str] = None,
          timeout: Optional[float] = None):
    """Train over ``nprocs`` new processes as one group: ``main(argv)``
    with the coordinator flags added, in each (one a card, or on the CPU
    with ``--device cpu``)."""
    distributed.spawn(_spawned, nprocs, (list(argv), nprocs, backend),
                      coordinator, timeout)


def _spawned(rank: int, coordinator: str, argv: List[str], nprocs: int,
             backend: Optional[str]):
    main([*argv, "--coordinator", coordinator, "--num_processes",
          str(nprocs), "--process_id", str(rank)], backend)


def main(argv: Optional[Sequence[str]] = None,
         backend: Optional[str] = None) -> List[Dict[str, float]]:
    """Train; returns the metrics of every iteration this process ran
    (floats; none where it started one process a card). ``backend``: the
    group's, where one is joined (default NCCL on cuda, gloo on cpu)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if _spawns(args):
        spawn(argv, torch.cuda.device_count(), backend)
        return []
    dist = distributed.maybe_initialize(
        args.seed, args.coordinator, args.num_processes, args.process_id,
        backend, args.device)
    try:
        return _train(args, dist)
    finally:
        distributed.close(dist)


def _train(args, dist: DistContext) -> List[Dict[str, float]]:
    tr = Trainer(args, dist)
    cfg = tr.cfg

    def say(msg: str):
        if dist.is_rank0:
            print(msg, flush=True)

    say(tr.env.cset.table())
    run_name = args.run_name or time.strftime("%Y-%m-%d_%H-%M-%S")
    run_path = os.path.join(args.logdir, args.agent, args.task, run_name)
    if dist.is_rank0:
        os.makedirs(run_path, exist_ok=True)
        with open(os.path.join(run_path, "config.json"), "w") as f:
            json.dump({"task": args.task, "agent": args.agent,
                       "num_envs": tr.num_envs, "seed": args.seed,
                       "device": str(tr.device),
                       "devices": dist.world_size,
                       "processes": dist.world_size,
                       "agent_cfg": dataclasses.asdict(cfg),
                       "env_cfg": dataclasses.asdict(tr.env.cfg)},
                      f, indent=1, default=_json_default)
    if args.checkpoint:
        tr.restore(args.checkpoint)
        say(f"resumed from {args.checkpoint} at iteration "
            f"{tr.ppo.iteration}")

    over = f" and {dist.world_size - 1} more process(es)" if dist.group else ""
    say(f"training {args.task} ({args.agent}): {tr.num_envs} envs on "
        f"{tr.device}{over}, to iteration {cfg.num_iterations}; logs at "
        f"{run_path}")
    logger = (MetricLogger(run_path, writer=args.writer) if dist.is_rank0
              else None)
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
                # every rank sees the merged metrics, and takes part in the
                # save
                bad = tr.save(os.path.join(run_path, f"ckpt_diverged_{it}"))
                say(f"FATAL: non-finite loss at iteration {it} "
                    f"(loss={loss}); diverged state dumped to {bad}")
                if last_ckpt:
                    say(f"resume from the last good checkpoint with:\n"
                        f"  --checkpoint {last_ckpt}")
                sys.exit(1)
            metrics["Perf/env_steps_per_sec"] = steps_per_iter / dt
            metrics["Perf/iter_seconds"] = dt
            if logger is not None:
                logger.log(metrics, it)
            history.append(metrics)
            if it == 1 or it % 10 == 0 or it == cfg.num_iterations:
                say(f"iter {it:5d} | {steps_per_iter / dt:9.0f} steps/s | "
                    f"rew/step {metrics['Train/mean_reward_per_step']:.4f}"
                    f" | ep_len {metrics['Episode/length']:.0f} | loss "
                    f"{loss:.4f}")
            if it % cfg.save_interval == 0:
                last_ckpt = tr.save(os.path.join(run_path, f"ckpt_{it}"))
                say(f"saved {last_ckpt}")
        tr.save(os.path.join(run_path, "ckpt_final"))
    finally:
        if logger is not None:
            logger.close()
    say(f"done; logs at {run_path}")
    return history


if __name__ == "__main__":
    main()
