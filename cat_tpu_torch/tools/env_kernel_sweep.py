"""Times the env step's three kernels (``ops/env_step.py``) at several
block geometries, envs a block x threads a block, on the card:
``env_terms`` and ``env_update`` at each of ``--geometries``, ``env_obs``
at each of ``--obs_geometries``.

  python -m cat_tpu_torch.tools.env_kernel_sweep [--geometries 16x256,32x256]
      [--obs_geometries 16x256,32x512] [--tasks solo12_flat,solo12_rough]
      [--num_envs 4096] [--steps 30] [--sass]

For each task, a state after ``--steps`` env steps of the JAX-trained
flat Solo12 policy (``runs/solo12_flat_2000it``, its first 45 inputs, with
0.3 of seeded noise, as ``chip_smoke.py``'s kernel-env phase); for each
geometry (``env_step.ENVS_PER_BLOCK`` and ``THREADS``, or
``OBS_ENVS_PER_BLOCK`` and ``OBS_THREADS``, set in turn), each kernel
held against its plain stage (``measure.compare_env``), its time as
CUDA-graph replays (the best of three times 50) and one launch of its
phase-clock build (``-DENV_PHASE_CLOCKS``: the median cycles a block of
each phase and of all, the largest block in brackets), and its bound on
that state (``measure.env_counts`` with the observed qpos: the terrain
cells the scan reads counted once, so a later ``--steps`` reads the
bound of envs spread further) and the share of it the time reaches. With ``--sass``,
the SASS instruction count of each production library (``cuobjdump`` of
the CUDA toolkit). One JSON line a task and geometry, then the card's
line. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from cat_tpu_torch import measure
from cat_tpu_torch.ops import build, env_step

RUNS = Path(__file__).resolve().parents[2] / "runs"
GEOMETRIES = ((32, 256), (16, 256), (16, 128), (8, 128), (8, 256))
OBS_GEOMETRIES = ((8, 128), (8, 256), (16, 256), (16, 512), (32, 256),
                  (32, 512))


def parse_geometries(text: str) -> tuple:
    """'16x256,32x256' -> ((16, 256), (32, 256)); each geometry must give
    env_update's per-env logic its three roles (threads >= 3 envs) in
    whole warps."""
    out = []
    for part in text.split(","):
        envs, threads = (int(x) for x in part.lower().split("x"))
        if envs < 1 or threads % 32 or threads < 3 * envs \
                or threads > env_step.THREADS_MAX:
            raise ValueError(f"geometry {part}: need envs >= 1, threads a "
                             f"multiple of 32, >= 3 envs and <= "
                             f"{env_step.THREADS_MAX}")
        out.append((envs, threads))
    return tuple(out)


def parse_obs_geometries(text: str) -> tuple:
    """'16x256,32x512' -> ((16, 256), (32, 512)); each geometry of
    ``env_obs`` in whole warps, a thread an env at least, within its
    launch bound."""
    out = []
    for part in text.split(","):
        envs, threads = (int(x) for x in part.lower().split("x"))
        if envs < 1 or threads % 32 or threads < max(envs, 32) \
                or threads > env_step.OBS_THREADS_MAX:
            raise ValueError(f"geometry {part}: need envs >= 1, threads a "
                             f"multiple of 32, >= envs and <= "
                             f"{env_step.OBS_THREADS_MAX}")
        out.append((envs, threads))
    return tuple(out)


def policy(dev):
    """The JAX-trained flat policy's mean action on an observation's first
    45 entries, plus 0.3 of seeded Gaussian noise."""
    from cat_tpu_torch.rl.convert import actor_from_bundle
    from cat_tpu_torch.rl.networks import ActorCritic

    sd, mean, var = actor_from_bundle(dict(np.load(
        RUNS / "solo12_flat_2000it" / "policy_params.npz")))
    net = ActorCritic(45, 12).to(dev)
    net.load_state_dict(sd, strict=False)
    mean, std = mean.to(dev), torch.sqrt(var.to(dev) + 1e-8)
    gen = torch.Generator(device=dev).manual_seed(7)

    def act(obs):
        a = net.actor((obs[:, :45] - mean) / std)
        return a + 0.3 * torch.randn(a.shape, generator=gen, device=dev)
    return act


def sass_instructions(path: Path) -> Optional[int]:
    """SASS instructions of a built library, or None without cuobjdump."""
    tool = Path(build.find_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    text = subprocess.run([str(tool), "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    return len(re.findall(r"^\s+/\*[0-9a-f]{4,}\*/", text, re.M))


SWEPT = {  # what each sweep sets: its kernels and their geometry's names
    "terms_update": (("env_terms", "env_update"),
                     ("ENVS_PER_BLOCK", "THREADS")),
    "obs": (("env_obs",), ("OBS_ENVS_PER_BLOCK", "OBS_THREADS"))}


def sweep(task: str, n: int, steps: int, geometries, dev,
          which: str = "terms_update") -> list:
    import importlib

    env = importlib.import_module(f"cat_tpu_torch.tasks.{task}").make_env(
        n, device=dev)
    inputs = measure.env_inputs(env, n, steps, policy(dev))
    names, knobs = SWEPT[which]
    clocked = {name: type(kernel)(clocks=True)
               for name, kernel in env_step.ENV_KERNELS if name in names}
    rows = []
    for envs, threads in geometries:
        for knob, value in zip(knobs, (envs, threads)):
            setattr(env_step, knob, value)
        for tabs in env.kernel_tables.values():   # the geometries kept there
            for key in [k for k in tabs if isinstance(k, tuple)]:
                del tabs[key]
        pairs = measure.env_stage_pairs(env, *inputs)
        row = dict(task=task, envs=envs, threads=threads)
        geo = env_step.env_geometry(n, env)
        counts = measure.env_counts(env, n, pairs["env_terms"][1],
                                    qpos=pairs["env_update"][1].sim.qpos)
        for name, kernel in clocked.items():
            out, ref, margins, call, _ = pairs[name]
            blocks = geo.obs_blocks if name == "env_obs" else geo.blocks
            cyc = kernel.phase_cycles(blocks, dev, lambda: kernel(
                *call.args, **call.keywords)).double()
            ms = min(measure.graph_ms(call, 50) for _ in range(3))
            bound, by = measure.bound(*counts[name])
            row[name] = dict(
                ok=measure.compare_env(out, ref, margins).ok, ms=ms,
                bound_ms=bound, bound_by=by, bytes=counts[name][0],
                bound_share=bound / ms,
                cycles={p: c for p, c in zip(
                    kernel.phases, cyc.median(dim=0).values.tolist())},
                cycles_total=cyc.sum(dim=1).median().item(),
                cycles_total_max=cyc.sum(dim=1).max().item())
        rows.append(row)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--geometries", type=parse_geometries,
                   default=GEOMETRIES)
    p.add_argument("--obs_geometries", type=parse_obs_geometries,
                   default=OBS_GEOMETRIES)
    p.add_argument("--tasks", default="solo12_flat,solo12_rough")
    p.add_argument("--num_envs", type=int, default=4096)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--sass", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("env_kernel_sweep needs a CUDA card")
        return 2
    dev = torch.device("cuda")
    knobs = [k for _, ks in SWEPT.values() for k in ks]
    saved = {k: getattr(env_step, k) for k in knobs}
    try:
        for task in args.tasks.split(","):
            for which, geometries in (("terms_update", args.geometries),
                                      ("obs", args.obs_geometries)):
                for row in sweep(task, args.num_envs, args.steps,
                                 geometries, dev, which):
                    print(json.dumps(row), flush=True)
                for k, v in saved.items():
                    setattr(env_step, k, v)
    finally:
        for k, v in saved.items():
            setattr(env_step, k, v)
    if args.sass:
        for name, kernel in env_step.ENV_KERNELS:
            print(json.dumps(dict(library=kernel.load().path.name,
                                  sass_instructions=sass_instructions(
                                      kernel.built.path))), flush=True)
    print(measure.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
