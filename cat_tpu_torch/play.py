"""Play a trained policy and export it (the counterpart of scripts/play.py).

  python -m cat_tpu_torch.play --run_dir logs/<agent>/<task>/<run> \
      [--task Go2-CaT-Flat-Play-v0] [--steps 500] [--num_envs 50] \
      [--out DIR] [--device cpu]

Loads the run's newest checkpoint (``ckpt_final``, else the highest
``ckpt_<it>``) non-strict into the play task (by default the play variant
of the run's task, from its ``config.json``: 50 envs, no observation
noise), keeping only the leaves that do not depend on the env count
(network, normalisers, constraint maxima), exports the policy
(``rl/export.py``) and plays it deterministically (the mean action) for
``--steps`` control steps; writes ``play_traj.npz`` (qpos of every step,
mean reward of every step) beside the export.

Runs on the first CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from cat_tpu_torch import resolve_device
from cat_tpu_torch.rl import checkpoint
from cat_tpu_torch.rl.export import export_policy
from cat_tpu_torch.rl.normalize import rms_normalize
from cat_tpu_torch.rl.ppo import PPO, PpoCfg
from cat_tpu_torch.sim.maths import quat_rotate_inv
from cat_tpu_torch.tasks import registry


def play_task(run_dir: str, task: Optional[str]) -> tuple:
    """(task id, learner cfg): ``task`` or the play variant of the run's
    task, and the run's network layout, from its ``config.json``."""
    cfg = PpoCfg()
    path = os.path.join(run_dir, "config.json")
    run = {}
    if os.path.exists(path):
        with open(path) as f:
            run = json.load(f)
        agent = run.get("agent_cfg", {})
        cfg = PpoCfg(shared_model=agent.get("shared_model", False),
                     hidden=tuple(agent.get("hidden", cfg.hidden)))
    if task is None:
        trained = run.get("task", "Solo12-CaT-Flat-v0")
        task = trained.replace("-v0", "-Play-v0")
        if task not in registry.list_tasks():
            task = trained
    return task, cfg


def rollout(env, es, policy, steps: int, gen) -> dict:
    """``steps`` control steps of ``policy`` (observation -> action) from
    env state ``es``, without gradients. Returns, as tensors: ``qpos``
    (steps, N, nq), ``reward`` (steps,) the mean over envs, ``first_reset``
    (N,) the step of each env's first reset (a fall, or a timeout) with
    ``steps`` for none, ``vx`` (steps, N) the base's forward velocity in
    its own frame, and ``obs`` the last observation."""
    obs = env.observe(es, gen)
    n = obs.shape[0]
    first = torch.full((n,), steps, device=obs.device)
    qpos, rewards, vx = [], [], []
    with torch.no_grad():
        for t in range(steps):
            es, obs, reward, _, _ = env.step(es, policy(obs), gen)
            first = torch.where((es.episode_len == 0) & (first == steps), t,
                                first)
            qpos.append(es.sim.qpos)
            rewards.append(reward.mean())
            vx.append(quat_rotate_inv(es.sim.qpos[:, 3:7],
                                      es.sim.qvel[:, 0:3])[:, 0])
    return {"qpos": torch.stack(qpos), "reward": torch.stack(rewards),
            "first_reset": first, "vx": torch.stack(vx), "obs": obs}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run_dir", required=True,
                   help="run directory holding ckpt_*.pt")
    p.add_argument("--task", default=None)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--num_envs", type=int, default=50)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    task, cfg = play_task(args.run_dir, args.task)
    env = registry.get(task).make_env(args.num_envs, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    es = env.init(gen, args.num_envs)
    ppo = PPO(env, cfg, torch.Generator().manual_seed(1))
    ppo.start(env.observe(es, gen))
    path = checkpoint.latest(args.run_dir)
    # the env state of the training run is not wanted: a fresh play env
    checkpoint.restore(path, ppo, es, strict=False)
    print(f"loaded {path} into {task} ({args.num_envs} envs on {device})",
          flush=True)

    out_dir = args.out or args.run_dir
    export_policy(ppo.net, ppo.obs_rms.mean, ppo.obs_rms.var, out_dir)

    def policy(obs):
        return ppo.net(rms_normalize(ppo.obs_rms, obs))[0]

    run = rollout(env, es, policy, args.steps, gen)
    qpos, rewards = run["qpos"].cpu().numpy(), run["reward"].cpu().numpy()
    traj = os.path.join(out_dir, "play_traj.npz")
    np.savez_compressed(traj, qpos=qpos, reward=rewards)
    print(f"mean reward/step {float(np.mean(rewards)):.4f}; trajectory saved "
          f"to {traj}", flush=True)
    return {"task": task, "checkpoint": path, "qpos": qpos, "reward": rewards}


if __name__ == "__main__":
    main()
