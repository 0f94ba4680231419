"""Readings for the self-collision pairs that ``measure.ambiguous_contacts``
leaves out (``measure.PAIR_SIN2``, ``measure.PAIR_CLEAR_M``): on the state
after the window of the bench's cells, how far each pair's contact rows
(E, phi) from ``contact_rows`` and from the plain contact stage lie from
each other and from the same rows in float64, by how parallel the pair's
capsule axes are.

  python -m cat_tpu_torch.tools.pair_probe [--seed 0 ...] [--cell NAME ...]

Runs ``cat_tpu_torch.bench --no-trace`` for each cell and seed (every cell
at seed 0 by default) one after another in this process; before the
bench's own checks on the state after the window it prints:

- by decade of sin^2 of the angle between the pair's axes (float64 from
  the float32 orientations): the pairs, how many lie within
  ``PAIR_CLEAR_M`` of touching (float64's phi), and the max abs difference in E and phi
  of the kernel against the plain stage and of each against float64
  (``sim/collision.py`` ``detect_pair_contacts`` on the same float32
  kinematics cast to float64: the exact answer for the inputs both sides
  were given);
- each pair whose E the kernel and the plain stage put more than 1e-5
  apart: its sin^2, the float32 denominator a e - b^2 of the closest-point
  solve over a e (the plain stage's formula evaluated in float32 on the
  same card) beside float64's, the segment parameters s, t of both,
  phi of each side, and each side's distance from float64.

Needs a card.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from cat_tpu_torch import bench, measure

EDGES = (0.0, 1e-12, 1e-10, 1e-8, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1,
         1.0)
LISTED = 1e-5


def closest(mt, kin, dtype):
    """(s, t, denom / (a e)) of each pair's closest-point solve, as
    ``detect_pair_contacts`` computes them, in ``dtype``."""
    R, o = kin.R.to(dtype), kin.o.to(dtype)

    def ends(bodies, p0, p1):
        Rb, ob = R[:, bodies], o[:, bodies]
        return (ob + torch.matmul(Rb, p0.to(dtype)[..., None])[..., 0],
                ob + torch.matmul(Rb, p1.to(dtype)[..., None])[..., 0])

    p0a, p1a = ends(mt.pair_body_a, mt.pair_p0_a, mt.pair_p1_a)
    p0b, p1b = ends(mt.pair_body_b, mt.pair_p0_b, mt.pair_p1_b)
    d1, d2, r = p1a - p0a, p1b - p0b, p0a - p0b
    a, e, b = (d1 * d1).sum(-1), (d2 * d2).sum(-1), (d1 * d2).sum(-1)
    c, f = (d1 * r).sum(-1), (d2 * r).sum(-1)
    denom = a * e - b * b
    s = torch.clamp((b * f - c * e) / (denom + 1e-12), 0.0, 1.0)
    t = torch.clamp((b * s + f) / (e + 1e-12), 0.0, 1.0)
    s = torch.clamp((b * t - c) / (a + 1e-12), 0.0, 1.0)
    return s, t, denom / (a * e)


def readings(label: str, eng, sim, target, com):
    from cat_tpu_torch.ops import substep
    from cat_tpu_torch.sim import collision, dynamics, engine

    mt, params, terr = eng.mt, eng.params, eng.terrain
    m = mt.model
    if not m.npair:
        return
    nct, npair = m.ncand_terrain, m.npair
    args = (sim.qpos.contiguous(), sim.qvel.contiguous(),
            target.contiguous(), None if com is None else com.contiguous())
    with torch.no_grad():
        _, vf, Minv, kin = engine.dynamics_stage(mt, params, *args)
        E_p, _, _, phi_p, _ = engine.contact_stage(mt, terr, kin, Minv, vf)
        E_k, _, _, phi_k, _ = substep.contact_rows(mt, terr, kin, Minv, vf)
        kin64 = dynamics.ContactKin(*(t.double() for t in kin))
        phi_x, E_x, _ = collision.detect_pair_contacts(
            measure.float64_tensors(mt), kin64)
        s32, t32, den32 = closest(mt, kin, torch.float32)
        s64, t64, sin2 = closest(mt, kin, torch.float64)
    n, nv = E_p.shape[0], E_p.shape[2]

    def pair_rows(E):
        return E[:, 3 * nct:].reshape(n, npair, 3, nv).double()

    E_p, E_k, E_x = pair_rows(E_p), pair_rows(E_k), E_x.double()
    phi_p, phi_k = phi_p[:, nct:].double(), phi_k[:, nct:].double()
    kp = (E_k - E_p).abs().amax((-1, -2))
    kx = (E_k - E_x).abs().amax((-1, -2))
    px = (E_p - E_x).abs().amax((-1, -2))
    phi_kp = (phi_k - phi_p).abs()
    near = phi_x.double() <= measure.PAIR_CLEAR_M
    left = measure.ambiguous_contacts(mt, terr, kin)[:, nct:]
    print(f"  [{label}] {n} envs x {npair} pairs, {int(left.sum())} left "
          f"out by ambiguous_contacts; |o| max "
          f"{float(kin.o.abs().max()):.4g} m", flush=True)
    for lo, hi in zip(EDGES[:-1], EDGES[1:]):
        sel = (sin2 > lo) & (sin2 <= hi)
        k = int(sel.sum())
        if not k:
            continue
        print(f"  [{label}] sin^2 ({lo:g}, {hi:g}]: {k} pairs, "
              f"{int((sel & near).sum())} within {measure.PAIR_CLEAR_M:g} m "
              f"of touching; E kernel-plain max {float(kp[sel].max()):.3g} "
              f"(over 1e-5: {int((kp[sel] > 1e-5).sum())}, over 1e-4: "
              f"{int((kp[sel] > 1e-4).sum())}), kernel-f64 "
              f"{float(kx[sel].max()):.3g}, plain-f64 "
              f"{float(px[sel].max()):.3g}; phi kernel-plain max "
              f"{float(phi_kp[sel].max()):.3g}", flush=True)
    for e, p in (kp > LISTED).nonzero().tolist():
        print(f"  [{label}] env {e} pair {p} (bodies "
              f"{int(m.pair_body_a[p])}/{int(m.pair_body_b[p])}): sin^2 "
              f"{float(sin2[e, p]):.4g}, denom/(a e) f32 "
              f"{float(den32[e, p]):.4g} f64 {float(sin2[e, p]):.4g}; s, t "
              f"f32 {float(s32[e, p]):.6f}, {float(t32[e, p]):.6f} f64 "
              f"{float(s64[e, p]):.6f}, {float(t64[e, p]):.6f}; phi kernel "
              f"{float(phi_k[e, p]):.7g} plain {float(phi_p[e, p]):.7g} f64 "
              f"{float(phi_x[e, p]):.7g}; E kernel-plain {float(kp[e, p]):.3g}"
              f", kernel-f64 {float(kx[e, p]):.3g}, plain-f64 "
              f"{float(px[e, p]):.3g}; left out {bool(left[e, p])}",
              flush=True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, action="append")
    p.add_argument("--cell", choices=bench.CELLS, action="append")
    args = p.parse_args(argv)
    parts, label = bench.physics_parts, {}

    def probed(cell, eng, sim, target, mu, com, timed):
        readings(label["cell"], eng, sim, target, com)
        return parts(cell, eng, sim, target, mu, com, timed)

    bench.physics_parts = probed
    ok = True
    try:
        for seed in args.seed or [0]:
            for cell in args.cell or bench.CELLS:
                label["cell"] = f"{cell} seed {seed}"
                r = bench.main(["--cell", cell, "--no-trace", "--seed",
                                str(seed)])
                c = r["cells"][0]
                ok &= c["correct"]
                print(f"  [{label['cell']}] correct {c['correct']} checks "
                      f"{c['checks']}", flush=True)
    finally:
        bench.physics_parts = parts
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
