"""The port's PGS structure probe (cat_tpu_torch/tools/pgs_structure_probe.py)
against the reference's (tools/pgs_structure_probe.py, imported as a module,
unchanged) on the same captured problems.

The port's flat env (8 envs) is rolled under seeded uniform actions and its
contact problems captured at two control steps; each package gets them in
its own layout (the port's envs leading, the reference's envs last). Both
converge the 100-sweep serial reference (atol 2e-6 x max|lam|) and score
the variants with their own solves (the port's plain ``pgs_bj_reference``,
the reference's ``pgs_lanes_xla_bj``): the five metrics agree to rtol 1e-4
/ atol 1e-6 (the solves round in their own order; measured <= 1e-5
relative), and serial_depth exactly.

Run as a script, it scores the shipped and the serial structure with both
packages on the reference's own capture at its size (the JAX env on the
CPU, 256 envs, 5 captures: ~2 min):

  PYTHONPATH=.:tests python tests/test_torch_probe.py
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from cat_tpu.models.solo12 import solo12_model as jax_solo12
from cat_tpu_torch.tasks import solo12_flat
from cat_tpu_torch.tools import pgs_structure_probe as tp

N = 8
STEPS = (3, 10)
H, CFM = 0.005, 1e-4
# the serial sweep, the shipped bj:4:0.9:6 and damped Jacobi in one block
CHECKED = [(0, 1.0, 5), (4, 0.9, 6), (1, 0.7, 10)]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference_tool():
    """tools/pgs_structure_probe.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "reference_pgs_structure_probe",
        os.path.join(REPO, "tools", "pgs_structure_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def to_lanes(prob):
    """A port problem (envs leading) in the reference's layout (envs last):
    E (3nc, nv, N), W (nv, 3nc, N), b / lam0 (3nc, N), bias / active
    (nc, N), mu (N,)."""
    E, W, b, bias, active, mu, lam0 = (x.numpy() for x in prob)
    return (np.moveaxis(E, 0, -1), np.moveaxis(W, 0, -1), b.T, bias.T,
            active.T, mu, lam0.T)


def to_port(lanes):
    E, W, b, bias, active, mu, lam0 = lanes
    return tuple(torch.from_numpy(np.array(x, dtype=np.float32)) for x in (
        np.moveaxis(E, -1, 0), np.moveaxis(W, -1, 0), b.T, bias.T, active.T,
        mu, lam0.T))


@pytest.fixture(scope="module")
def captured():
    env = solo12_flat.make_env(N, device="cpu")
    probs = tp.capture_problems(env, N, steps=STEPS)
    rp = reference_tool()
    model = jax_solo12()
    lanes = [to_lanes(p) for p in probs]
    refs_j = [rp.ref_solution(model, *p) for p in lanes]
    refs_t = [tp.ref_solution(p, H) for p in probs]
    return dict(env=env, probs=probs, lanes=lanes, rp=rp, model=model,
                refs_j=refs_j, refs_t=refs_t)


def test_capture_has_contacts(captured):
    """The captures are physical problems: 36 candidates, 18 dofs, some
    active contacts in every capture and a warm start after the first."""
    for p in captured["probs"]:
        E, W, b, bias, active, mu, lam0 = p
        assert tuple(E.shape) == (N, 108, 18) and tuple(W.shape) == (N, 18, 108)
        assert active.sum() > 0 and (bias <= 0).all()
    assert captured["probs"][-1][6].abs().max() > 0


def test_converged_reference_matches(captured):
    for (lam_j, A_j), (lam_t, A_t) in zip(captured["refs_j"],
                                          captured["refs_t"]):
        lam_j = lam_j.T                                   # (N, 3nc)
        np.testing.assert_allclose(lam_t.numpy(), lam_j, rtol=0,
                                   atol=2e-6 * np.abs(lam_j).max())
        np.testing.assert_allclose(A_t.numpy(), np.moveaxis(A_j, -1, 0),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("variant", CHECKED, ids=str)
def test_probe_scores_match_the_reference(captured, variant):
    rp, model = captured["rp"], captured["model"]
    ref = [rp.score(model, p, lam, A, variant)
           for p, (lam, A) in zip(captured["lanes"], captured["refs_j"])]
    rec, = tp.probe(captured["env"].model, captured["probs"], H, CFM,
                    variants=[variant], say=lambda s: None)
    want = dict(
        imp_err=max(r[0] for r in ref),
        imp_err_mean=float(np.mean([r[0] for r in ref])),
        vn_viol_max=max(r[1] for r in ref),
        vn_viol_mean=float(np.mean([r[2] for r in ref])),
        comp_max=max(r[3] for r in ref),
        comp_mean=float(np.mean([r[4] for r in ref])))
    for key, value in want.items():
        np.testing.assert_allclose(rec[key], value, rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    nb, _, it = variant
    assert rec["serial_depth"] == (36 if nb == 0 else nb) * it
    # on the CPU the solves are the plain versions: no kernel to hold
    assert rec["kernel_max_abs_err"] is None
    assert tp.disagreements([rec]) == 0


def test_vn_excess_is_what_the_converged_solve_does_not_leave(captured):
    """vn_excess_max, contact by contact against the converged solve (a
    numpy re-derivation): 0 for the converged impulses themselves, the
    whole approach speed for no impulse at all, and for the shipped
    structure at most its vn_viol_max."""
    def viol(p, A, lam):
        _, _, b, bias, active, _, _ = (x.numpy() for x in p)
        vn = (np.einsum("nrc,nc->nr", A.numpy(), lam.numpy()) + b)[:, 2::3]
        return np.maximum(-(vn + bias), 0.0) * active

    zero_excess = []
    for p, (lam, A) in zip(captured["probs"], captured["refs_t"]):
        floor = tp.approach(p, A, lam)
        np.testing.assert_allclose(floor.numpy(), viol(p, A, lam),
                                   rtol=1e-5, atol=1e-6)
        assert tp.excess(p, A, lam, floor) == 0.0
        none = torch.zeros_like(lam)
        want = np.maximum(viol(p, A, none) - viol(p, A, lam), 0.0).max()
        np.testing.assert_allclose(tp.excess(p, A, none, floor), want,
                                   rtol=1e-5, atol=1e-6)
        zero_excess.append(want)
    assert max(zero_excess) > 0.1        # falling robots: contacts approach
    rec, = tp.probe(captured["env"].model, captured["probs"], H, CFM,
                    variants=[(4, 0.9, 6)], say=lambda s: None)
    assert 0.0 <= rec["vn_excess_max"] <= rec["vn_viol_max"]


def test_probe_writes_the_reference_keys(tmp_path):
    """The command line at 4 envs on the CPU: one record a variant, with
    every key of the reference's records."""
    out = tmp_path / "probe.json"
    records = tp.main(["--num_envs", "4", "--device", "cpu", "--out",
                       str(out)])
    ref_keys = {"n_blocks", "omega", "iterations", "serial_depth", "imp_err",
                "imp_err_mean", "vn_viol_max", "vn_viol_mean", "comp_max",
                "comp_mean"}
    assert [(r["n_blocks"], r["omega"], r["iterations"])
            for r in records] == list(tp.VARIANTS)
    assert len(records) == 26
    assert all(ref_keys <= set(r) for r in records)
    assert all(np.isfinite(r[k]) for r in records for k in ref_keys)
    assert out.exists()


def test_serial_variant_plan():
    """The serial sweep runs as 36 blocks of one contact at omega 1."""
    model = solo12_flat.make_env(2, device="cpu").model
    kw = tp.variant_kwargs(model, (0, 0.5, 5), CFM)
    assert kw["contact_perm"] == tuple(range(36))
    assert kw["blocks"] == tuple((i, 1) for i in range(36))
    assert kw["omega"] == 1.0 and kw["iterations"] == 5


def main():
    """Both packages' scores of the serial and the shipped structure on the
    reference's own capture (its env, its keys, N = 256), on the CPU."""
    jax.config.update("jax_platforms", "cpu")
    rp = reference_tool()
    env = rp.make_env(num_envs=rp.N)
    lanes = rp.capture_problems(env)
    probs = [to_port(p) for p in lanes]
    active = np.stack([p[4] for p in lanes]).sum(1)
    print(f"reference capture on the CPU: N={rp.N}, steps "
          f"{rp.CAPTURE_STEPS}, {active.mean():.2f} active contacts an env")
    tp.probe(env.model, probs, H, CFM, variants=[(0, 1.0, 5), (4, 0.9, 6)],
             say=lambda s: print("port      " + s))
    for v in [(0, 1.0, 5), (4, 0.9, 6)]:
        scores = [rp.score(env.model, p, *rp.ref_solution(env.model, *p), v)
                  for p in lanes]
        print(f"reference {v}: imp_err={max(s[0] for s in scores):.4f} "
              f"vn_max={max(s[1] for s in scores):.4f} "
              f"comp_max={max(s[3] for s in scores):.4f}")


if __name__ == "__main__":
    main()
