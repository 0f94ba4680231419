"""Where the time of one PPO iteration goes on the card.

  python -m cat_tpu_torch.trace_iteration [--num_envs 4096] [--out FILE]

After one warm-up iteration of Solo12-CaT-Flat-v0 (clean_rl preset) it
times the parts, then one iteration, then profiles one more (in that order:
the profiler's hooks slow later launches), and prints one JSON object:
  * ``iteration_s``: host wall time of one iteration, synchronised;
  * ``device_busy_s`` / ``device_idle_share``: the sum of the CUDA kernel
    times torch.profiler records over that iteration, and the share of the
    wall time the card had no kernel running (kernels do not overlap on one
    stream);
  * ``kernels_launched``: CUDA kernels launched in the iteration;
  * ``top``: the CUDA kernels with the most device time;
  * ``parts_ms``: CUDA-event times of the iteration's parts at full width:
    policy forward, env step, control step, one substep's contact problem,
    the contact kernel, one substep's integration and sensors.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import torch

from cat_tpu_torch import resolve_device


def _ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from cat_tpu_torch.ops import pgs
    from cat_tpu_torch.rl.ppo import PPO
    from cat_tpu_torch.sim import engine
    from cat_tpu_torch.tasks import registry

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num_envs", type=int, default=4096)
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    n = args.num_envs
    spec = registry.get("Solo12-CaT-Flat-v0")
    env = spec.make_env(n, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    es = env.init(gen, n)
    ppo = PPO(env, spec.make_agent_cfg(), torch.Generator().manual_seed(1))
    ppo.start(env.observe(es, gen))
    es, _ = ppo.train_iteration(es, gen)             # warm-up
    torch.cuda.synchronize()

    obs = env.observe(es, gen)
    action = torch.zeros(n, env.num_actions, device=dev)
    target = env.default_joint_pos_task[env.m2t].expand(n, env.num_actions)
    eng = env.engine
    kw = eng.pgs_kwargs
    (tau_j, v_free, W, frame), ops = eng.contact_problem(es.sim, target, es.mu)
    lam = pgs.pgs_bj(*ops, **kw)
    with torch.no_grad():
        parts = {
            "policy_forward": _ms(lambda: ppo.net(obs), 20),
            "env_step": _ms(lambda: env.step(es, action, gen), 10),
            "control_step": _ms(lambda: eng(es.sim, target, es.mu), 10),
            "substep_contact_problem": _ms(
                lambda: eng.contact_problem(es.sim, target, es.mu), 20),
            "contact_kernel": _ms(lambda: pgs.pgs_bj(*ops, **kw), 50),
            "substep_integrate_sensors": _ms(lambda: engine.substep_post(
                eng.mt, eng.params, es.sim, tau_j, v_free, W, lam, frame), 20),
        }

    t0 = time.perf_counter()
    es, _ = ppo.train_iteration(es, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        es, _ = ppo.train_iteration(es, gen)
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    busy_us = sum(us for us, _ in by_name.values())
    kernels = sum(c for _, c in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:12]

    out = {
        "device": torch.cuda.get_device_name(0), "num_envs": n,
        "iteration_s": wall,
        "env_steps_per_s": ppo.cfg.num_steps * n / wall,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": max(0.0, 1.0 - busy_us / 1e6 / wall),
        "kernels_launched": kernels,
        "top": [{"name": name[:120], "device_ms": us / 1e3, "count": count}
                for name, (us, count) in top],
        "parts_ms": parts,
    }
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return out


if __name__ == "__main__":
    main()
