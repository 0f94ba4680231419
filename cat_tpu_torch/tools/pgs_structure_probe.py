"""Convergence probe of the PGS sweep structures on physical contact problems
(the port's counterpart of tools/pgs_structure_probe.py).

  python -m cat_tpu_torch.tools.pgs_structure_probe [--num_envs 256]
      [--seed 0] [--device cuda] [--out PATH]

Captures the flat Solo12 env's contact problems (E, W, b, bias, active, mu,
lam0) at control steps CAPTURE_STEPS of a rollout under uniform [-1, 1]
actions (standing, stumbling, fallen robots), each at the default-pose PD
targets, and scores each (n_blocks, omega, sweeps) variant of VARIANTS
against a converged serial Gauss-Seidel solve: ``sim.solver.pgs_solve``,
100 sweeps, on A = E W, fed the phi that reproduces (bias, active).
n_blocks 0 is the serial sweep: 36 blocks of one contact at omega 1.

Metrics of a variant, over all captured problems (the reference's):
  * imp_err: RMS impulse error against the converged solve, over its RMS
    (max and mean over the captures);
  * vn_viol: the worst (and mean) approach speed left on an active
    contact, max(-(A lam + b)_n - bias, 0);
  * comp: the two-sided normal complementarity residual on active
    contacts, |v_n + bias| where lam_n > 1e-6, else max(-(v_n + bias), 0);
  * serial_depth: blocks (36 for the serial sweep) x sweeps.
Each record also carries what the converged solve itself leaves
(``converged_vn_viol_max``, ``converged_comp_max``): 100 sweeps do not
bring every contact's residual to zero, so the worst residual of a
variant is partly the captured problems' own. What the variant leaves
beyond it, contact by contact, is ``vn_excess_max``: the largest
max(vn_viol - the converged solve's vn_viol on the same contact, 0).

Each variant's solve is ``ops.pgs.pgs_bj`` with ``plan_contact_blocks``:
on a CUDA device the hand-written kernel, held against its plain version
(``pgs_bj_reference``) on every capture (``measure.RTOL`` /
``ATOL_REL``); on the CPU the plain version. On the card the serial
variants also run ``pgs_gs``, which computes the same sweep: it is held
against ``pgs_bj`` at 36 single blocks and against its own plain version.

Writes the reference's records (one a variant, with its keys) and the
kernels' agreement to runs/profile/torch_pgs_structure_probe.json or
``--out``; exits 1 if a kernel disagrees with its plain version.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Sequence

import torch

from cat_tpu_torch import measure, resolve_device
from cat_tpu_torch.ops import pgs
from cat_tpu_torch.sim import solver

N = 256
CAPTURE_STEPS = (0, 3, 10, 25, 50)
REF_SWEEPS = 100
# (n_blocks, omega, sweeps); n_blocks 0 = the serial sweep
VARIANTS = (
    (0, 1.0, 5), (0, 1.0, 4), (0, 1.0, 3), (0, 1.0, 8),
    (1, 0.5, 8), (1, 0.5, 12), (1, 0.35, 12), (1, 0.7, 10),
    (2, 0.7, 6), (2, 0.7, 8), (2, 0.8, 8), (2, 0.6, 10),
    (3, 0.8, 5), (3, 0.8, 6), (3, 0.9, 6), (3, 0.7, 8),
    (4, 0.9, 5), (4, 0.8, 6), (4, 1.0, 5), (4, 0.9, 6),
    (6, 1.0, 5), (6, 0.9, 5), (6, 1.0, 4), (6, 0.9, 6),
    (9, 1.0, 4), (9, 1.0, 5),
)
OUT = os.path.join("runs", "profile", "torch_pgs_structure_probe.json")


def capture_problems(env, n: int, steps: Sequence[int] = CAPTURE_STEPS,
                     seed: int = 0) -> List[tuple]:
    """Roll ``env`` (n envs) under uniform [-1, 1] actions; the contact
    problems (E, W, b, bias, active, mu, lam0), envs leading, at ``steps``,
    each at the model's default-pose PD targets."""
    dev = env.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    actions = torch.Generator(device=dev).manual_seed(seed + 42)
    target = torch.as_tensor(env.model.default_qpos_joints,
                             dtype=torch.float32,
                             device=dev).expand(n, env.model.nj)
    es = env.init(gen, n)
    probs = []
    for t in range(max(steps) + 1):
        if t in steps:
            _, ops = env.engine.contact_problem(es.sim, target, es.mu)
            probs.append(tuple(x.contiguous() for x in ops))
        if t < max(steps):
            act = 2.0 * torch.rand(n, env.num_actions, generator=actions,
                                   device=dev) - 1.0
            es = env.step(es, act, gen)[0]
    return probs


def ref_solution(prob, h: float, sweeps: int = REF_SWEEPS):
    """The converged serial solve of a problem and its Delassus operator:
    (lam (N, 3nc), A (N, 3nc, 3nc)). ``pgs_solve`` recomputes the bias
    from phi, so it gets the phi that gives (bias, active) back: bias =
    (erp / h)(phi + slop) inverts to phi = bias h / erp - slop (an active
    contact, since bias <= 0), and phi = 1 for an inactive one."""
    E, W, b, bias, active, mu, lam0 = prob
    n, n3 = b.shape
    A = torch.matmul(E, W)
    p = solver.SolverParams(iterations=sweeps)
    phi = torch.where(active > 0, bias * h / p.erp - p.slop,
                      torch.ones_like(bias))
    lam = solver.pgs_solve(A, b, phi, mu, lam0.reshape(n, n3 // 3, 3), h, p)
    return lam.reshape(n, n3), A


def normal_speed(prob, A, lam):
    """v_n + bias (N, nc) on each contact after the impulses ``lam``."""
    _, _, b, bias, _, _, _ = prob
    w = torch.einsum("nrc,nc->nr", A, lam)
    return (w + b)[:, 2::3] + bias


def approach(prob, A, lam):
    """vn_viol (N, nc): the approach speed left on each active contact."""
    return torch.clamp(-normal_speed(prob, A, lam), min=0.0) * prob[4]


def metrics(prob, lam_ref, A, lam):
    """(imp_err, vn_viol max, vn_viol mean, comp max, comp mean) of the
    impulses ``lam`` (N, 3nc) of one problem."""
    active = prob[4]
    ref_rms = max(float(torch.sqrt(torch.mean(lam_ref ** 2))), 1e-9)
    imp_err = float(torch.sqrt(torch.mean((lam - lam_ref) ** 2))) / ref_rms
    vn = normal_speed(prob, A, lam)
    comp = torch.where(lam[:, 2::3] > 1e-6, vn.abs(),
                       torch.clamp(-vn, min=0.0)) * active
    viol = torch.clamp(-vn, min=0.0) * active
    return (imp_err, float(viol.max()), float(viol.mean()),
            float(comp.max()), float(comp.mean()))


def excess(prob, A, lam, viol_ref) -> float:
    """The largest approach speed ``lam`` leaves on a contact beyond what
    the converged solve leaves there (``viol_ref``, from ``approach``)."""
    return float(torch.clamp(approach(prob, A, lam) - viol_ref,
                             min=0.0).max())


def variant_kwargs(model, variant, cfm: float) -> dict:
    """``pgs_bj``'s keyword arguments of a variant: its plan of
    ``n_blocks`` blocks, or 36 blocks of one contact at omega 1."""
    nb, omega, sweeps = variant
    if nb == 0:
        perm = tuple(range(model.ncand))
        blocks, omega = tuple((i, 1) for i in range(model.ncand)), 1.0
    else:
        perm, blocks = pgs.plan_contact_blocks(model, nb)
    return dict(iterations=sweeps, cfm=cfm, omega=omega, contact_perm=perm,
                blocks=blocks)


def _agreement(out, plain, worst):
    """Fold ``measure.disagreement(out, plain)`` into ``worst``
    ([max abs error, entries outside the tolerance])."""
    err, _, bad = measure.disagreement(out, plain)
    worst[0], worst[1] = max(worst[0], err), worst[1] + bad


def probe(model, probs, h: float, cfm: float, variants=VARIANTS,
          say=print) -> List[dict]:
    """Score each variant on the captured problems; on a CUDA device also
    hold the kernels against their plain versions. Returns the records."""
    refs = [ref_solution(p, h) for p in probs]
    on_card = probs[0][0].device.type == "cuda"
    # what the converged solve itself leaves: the floor of vn_viol and comp
    floor = [metrics(p, lam, A, lam) for p, (lam, A) in zip(probs, refs)]
    viol_refs = [approach(p, A, lam) for p, (lam, A) in zip(probs, refs)]
    converged = {"converged_vn_viol_max": max(f[1] for f in floor),
                 "converged_comp_max": max(f[3] for f in floor)}
    say(f"converged {REF_SWEEPS}-sweep serial solve: vn_max="
        f"{converged['converged_vn_viol_max']:.4f} comp_max="
        f"{converged['converged_comp_max']:.4f}")
    out = []
    for v in variants:
        kw = variant_kwargs(model, v, cfm)
        scores, over = [], []
        bj_err, gs_bj, gs_plain = [0.0, 0], [0.0, 0], [0.0, 0]
        for p, (lam_ref, A), viol_ref in zip(probs, refs, viol_refs):
            lam = pgs.pgs_bj(*p, **kw)
            if on_card:
                _agreement(lam, pgs.pgs_bj_reference(*p, **kw), bj_err)
                if v[0] == 0:
                    gs_kw = dict(iterations=kw["iterations"], cfm=cfm)
                    lam_gs = pgs.pgs_gs(*p, **gs_kw)
                    _agreement(lam_gs, lam, gs_bj)
                    _agreement(lam_gs, pgs.pgs_gs_reference(*p, **gs_kw),
                               gs_plain)
            scores.append(metrics(p, lam_ref, A, lam))
            over.append(excess(p, A, lam, viol_ref))
        nb, om, it = v
        errs, vmaxs, vmeans, cmaxs, cmeans = zip(*scores)
        rec = {
            "n_blocks": nb, "omega": om, "iterations": it,
            "serial_depth": (model.ncand if nb == 0 else nb) * it,
            "imp_err": max(errs), "imp_err_mean": sum(errs) / len(errs),
            "vn_viol_max": max(vmaxs),
            "vn_viol_mean": sum(vmeans) / len(vmeans),
            "comp_max": max(cmaxs), "comp_mean": sum(cmeans) / len(cmeans),
            "vn_excess_max": max(over), **converged,
            "kernel_max_abs_err": bj_err[0] if on_card else None,
            "kernel_outside": bj_err[1] if on_card else None,
        }
        if nb == 0:
            rec.update(gs_vs_bj_max_abs_err=gs_bj[0] if on_card else None,
                       gs_vs_bj_outside=gs_bj[1] if on_card else None,
                       gs_max_abs_err=gs_plain[0] if on_card else None,
                       gs_outside=gs_plain[1] if on_card else None)
        out.append(rec)
        tag = "GS " if nb == 0 else f"bj{nb}"
        line = (f"{tag} om={om:<4} it={it:<2} depth={rec['serial_depth']:<4} "
                f"imp_err={rec['imp_err']:.4f} "
                f"vn_max={rec['vn_viol_max']:.4f} "
                f"vn_mean={rec['vn_viol_mean']:.5f} "
                f"vn_excess={rec['vn_excess_max']:.4f} "
                f"comp_max={rec['comp_max']:.4f} "
                f"comp_mean={rec['comp_mean']:.5f}")
        if on_card:
            line += (f" | pgs_bj vs plain: max abs err {bj_err[0]:.3g}, "
                     f"{bj_err[1]} outside")
            if nb == 0:
                line += (f" | pgs_gs vs pgs_bj {gs_bj[0]:.3g} ({gs_bj[1]} "
                         f"outside), vs plain {gs_plain[0]:.3g} "
                         f"({gs_plain[1]} outside)")
        say(line)
    return out


def disagreements(records) -> int:
    """Entries outside the tolerance, over every kernel comparison."""
    return sum(r.get(k) or 0 for r in records
               for k in ("kernel_outside", "gs_vs_bj_outside", "gs_outside"))


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num_envs", type=int, default=N)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)

    from cat_tpu_torch.tasks.solo12_flat import make_env

    dev = resolve_device(args.device)
    env = make_env(args.num_envs, device=dev)
    print(f"capturing {len(CAPTURE_STEPS)} problem batches "
          f"(N={args.num_envs}, {dev}) ...", flush=True)
    probs = capture_problems(env, args.num_envs, seed=args.seed)
    active = torch.stack([pr[4] for pr in probs]).sum(-1)
    print(f"active contacts an env: {active.float().mean():.2f} (max "
          f"{active.max():.0f}) at steps {CAPTURE_STEPS}", flush=True)
    sp = env.engine.params.solver
    records = probe(env.model, probs, env.engine.params.dt, sp.cfm,
                    say=lambda s: print(s, flush=True))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(records, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return records


if __name__ == "__main__":
    sys.exit(1 if disagreements(main()) else 0)
