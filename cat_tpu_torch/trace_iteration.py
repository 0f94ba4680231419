"""Where the time of one PPO iteration goes on the card.

  python -m cat_tpu_torch.trace_iteration [--task Solo12-CaT-Flat-v0]
      [--num_envs 4096] [--out FILE]

After two warm-up iterations of the task (clean_rl preset; the flat task
unless --task names another, e.g. Solo12-CaT-Rough-v0; the first warms up
the iteration's CUDA graphs, the second captures them) it times the parts,
then one iteration, then profiles one more (in that order: the profiler's
hooks slow later launches), and prints one JSON object:
  * ``iteration_s``: host wall time of one iteration, synchronised;
  * ``device_busy_s`` / ``device_idle_share``: the sum of the CUDA kernel
    times torch.profiler records over the profiled iteration, and the share
    of that traced iteration's own wall time (``traced_iteration_s``; the
    profiler slows the host) the card had no kernel running (kernels do
    not overlap on one stream);
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
from cat_tpu_torch.measure import cuda_ms


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from cat_tpu_torch.bench import profiled
    from cat_tpu_torch.rl.ppo import PPO
    from cat_tpu_torch.sim import engine
    from cat_tpu_torch.tasks import registry

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--task", default="Solo12-CaT-Flat-v0")
    p.add_argument("--num_envs", type=int, default=4096)
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    n = args.num_envs
    spec = registry.get(args.task)
    env = spec.make_env(n, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    es = env.init(gen, n)
    ppo = PPO(env, spec.make_agent_cfg(), torch.Generator().manual_seed(1))
    ppo.start(env.observe(es, gen))
    for _ in range(2):     # the iteration's graphs warm up, then capture
        es, _ = ppo.train_iteration(es, gen)
    torch.cuda.synchronize()

    obs = env.observe(es, gen)
    action = torch.zeros(n, env.num_actions, device=dev)
    target = env.default_joint_pos_task[env.m2t].expand(n, env.num_actions)
    eng = env.engine
    kw = eng.pgs_kwargs
    (tau_j, v_free, W, frame), ops = eng.contact_problem(es.sim, target, es.mu)
    lam = eng.solve(*ops, **kw)
    with torch.no_grad():
        parts = {
            "policy_forward": cuda_ms(lambda: ppo.net(obs), 20),
            "env_step": cuda_ms(lambda: env.step(es, action, gen), 10),
            "control_step": cuda_ms(lambda: eng(es.sim, target, es.mu), 10),
            "substep_contact_problem": cuda_ms(
                lambda: eng.contact_problem(es.sim, target, es.mu), 20),
            "contact_kernel": cuda_ms(lambda: eng.solve(*ops, **kw), 50),
            "substep_integrate_sensors": cuda_ms(lambda: engine.substep_post(
                eng.mt, eng.params, es.sim, tau_j, v_free, W, lam, frame), 20),
        }

    t0 = time.perf_counter()
    es, _ = ppo.train_iteration(es, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    # the card's events of one more iteration (bench.breakdown, no spans)
    bd = profiled(lambda: ppo.train_iteration(es, gen), ())
    out = {
        "device": torch.cuda.get_device_name(0), "task": args.task,
        "num_envs": n,
        "iteration_s": wall,
        "env_steps_per_s": ppo.cfg.num_steps * n / wall,
        "device_busy_s": bd["busy_s"],
        "device_idle_share": 1.0 - bd["busy_s"] / bd["wall_s"],
        "traced_iteration_s": bd["wall_s"],
        "kernels_launched": bd["kernels"],
        "top": [{k: row[k] for k in ("name", "device_ms", "count")}
                for row in bd["top_kernels"]],
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
