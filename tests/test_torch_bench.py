"""The port's benchmark (``cat_tpu_torch.bench``) and BENCHMARK.json.

On the CPU the bench rehearses its three cells at a few envs: every check
runs and the result is correct, each cell lists every metric
BENCHMARK.json names for it, and no time, rate or share carries a number. Without
``--device cpu`` and with no card it raises. The FLOP count of ``mfu`` is
held against the JAX package's networks: the matmul FLOPs summed in numpy
from the shapes of the parameters the JAX ``PPO`` initialises for
Solo12-CaT-Flat-v0 (exact: both are integer counts). The contact solve's
byte and operation count is held against a hand count on a 2-env problem.
The trace breakdown is held against synthetic events whose answer is
known. The substep kernels' comparison with the plain stages
(``measure.compare_stages``) passes equal outputs and fails a seeded fault
in any one output.
"""

import contextlib
import dataclasses
import io
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from cat_tpu.rl.ppo import PPO as JPPO
from cat_tpu.rl.ppo import PpoCfg as JCfg
from cat_tpu.tasks import registry as jregistry
from _substep_cases import make_case, torch_inputs
from cat_tpu_torch import bench, measure
from cat_tpu_torch.ops.substep import CONTACT_OUTPUTS, DYN_OUTPUTS
from cat_tpu_torch.rl.ppo import PPO
from cat_tpu_torch.sim import dynamics, engine
from cat_tpu_torch.tasks import registry

REPO = Path(__file__).resolve().parents[1]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
METRICS = {
    name: {m["name"] for kind in ("end_to_end", "layer")
           for m in SPEC["metrics"][kind] if name in m["workloads"]}
    for name in bench.CELLS}


REHEARSAL = {bench.FLAT: ["--iters", "1", "--warmup", "1"],
             bench.ROUGH_PPO: ["--iters", "1", "--warmup", "1"],
             bench.ENGINE: ["--iters", str(bench.WINDOW), "--warmup", "5"]}


@pytest.fixture(scope="module")
def rehearsal():
    """Each cell on the CPU at 8 envs, 1 warm-up and 1 timed iteration (the
    PPO cells), or 5 warm-up control steps and 1 timed window; by cell,
    the returned result and the printed lines."""
    runs = {}
    for name, argv in REHEARSAL.items():
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            result = bench.main(["--device", "cpu", "--num_envs", "8",
                                 "--cell", name, *argv])
        runs[name] = result, out.getvalue().strip().splitlines()
    return runs


@pytest.mark.parametrize("name", bench.CELLS)
def test_cpu_rehearsal_is_correct_and_measures_nothing(rehearsal, name):
    result, lines = rehearsal[name]
    assert json.loads(lines[-1]) == json.loads(json.dumps(result))
    assert result["correct"]
    assert result["device"]["platform"] == "cpu"
    cell, = [c for c in result["cells"] if c["workload"] == name]
    assert cell["correct"] and cell["checks"]
    assert all(cell["checks"].values())
    # the program held against the plain references, whose bfloat16
    # controls fail the same limits
    refs = ["learner", "control_step"] if name in bench.PPO_TASKS else [
        "control_step"]
    assert all(cell["checks"][r] and cell["checks"][r + "_control"]
               for r in refs)
    assert set(cell["metrics"]) == METRICS[name]
    assert all(v == bench.NOT_MEASURED for v in cell["metrics"].values())
    assert cell["samples"] == {} and cell["breakdown"] == bench.NOT_MEASURED
    # no kernel runs on the CPU: the plain versions solve and compute the
    # substep, and every kernel's count says so
    launches = {k: v for k, v in cell["counts"].items()
                if k.endswith("launches")}
    solve = "pgs_gs" if name == bench.ENGINE else "pgs_bj"
    assert set(launches) == {f"{k}_launches" for k in (
        solve, "substep_dynamics", "contact_rows", "substep_post")}
    assert all(v == 0 for v in launches.values())
    assert {"launches", "launches_substep_dynamics", "launches_contact_rows",
            "launches_substep_post", "substep_vs_plain",
            "kernel_vs_plain"} <= set(cell["checks"])
    # on a heightfield the substep check has a control, which fails it
    assert ("substep_vs_plain_control" in cell["checks"]) == (
        name != bench.FLAT)
    assert all("no card, times not measured" in line for line in lines[:-1])


@pytest.mark.parametrize("name", bench.CELLS)
def test_post_bound_comes_from_the_states_impulses(rehearsal, name):
    """Each cell counts the post kernel's bound (``measure.post_counts`` on
    the impulses of the substep after the window: W's columns and frames
    of the contacts holding one, the state read and written once), below
    the bound with every column of W, and reports
    ``substep_post_roofline_share`` beside ``substep_post_ms``, "not
    measured" on the CPU; its launch check is keyed as the other substep
    kernels'."""
    from cat_tpu_torch.models.solo12 import solo12_model

    result, _ = rehearsal[name]
    cell, = [c for c in result["cells"] if c["workload"] == name]
    counts = cell["counts"]
    n = 8
    full, _ = measure.post_counts(solo12_model(), n, frames=True,
                                  lam=torch.ones(n, 108))
    assert 0 < counts["substep_post_bytes"] <= full
    assert counts["substep_post_flops"] > 0
    assert counts["substep_post_bound_by"] == "bytes"
    assert counts["substep_post_bound_ms"] == pytest.approx(
        measure.bound(counts["substep_post_bytes"],
                      counts["substep_post_flops"])[0])
    for metric in ("substep_post_ms", "substep_post_roofline_share"):
        assert cell["metrics"][metric] == bench.NOT_MEASURED
    assert cell["checks"]["launches_substep_post"]
    assert set(bench.cell_kernels("x", None)) == {
        "x", "substep_dynamics", "contact_rows", "substep_post"}


def test_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--num_envs", "8", "--iters", "1"])


def test_mfu_flops_match_the_jax_networks():
    """The port counts from its nn.Linear widths; the JAX side from the
    (in, out) kernels of the params its PPO initialises for the task."""
    jenv = jregistry.get("Solo12-CaT-Flat-v0").make_env(num_envs=8)
    jppo = JPPO(jenv, JCfg())
    params = jppo.net.init(jax.random.PRNGKey(0), jnp.zeros((1, jenv.num_obs)))
    kernels = [np.shape(x) for path, x in
               jax.tree_util.tree_flatten_with_path(params)[0]
               if getattr(path[-1], "key", None) == "kernel"]
    assert sorted(kernels) == sorted([(45, 512), (512, 256), (256, 128),
                                      (128, 12), (45, 512), (512, 256),
                                      (256, 128), (128, 1)])
    fwd = sum(2 * i * o for i, o in kernels)
    cfg = JCfg()
    n = bench.FULL_ENVS
    rows = cfg.num_steps * n
    jax_flops = fwd * ((cfg.num_steps + 1) * n
                       + 3 * cfg.updates_epochs * rows)

    spec = registry.get("Solo12-CaT-Flat-v0")
    env = spec.make_env(8, device="cpu")
    ppo = PPO(env, spec.make_agent_cfg(), torch.Generator().manual_seed(0))
    tcfg = ppo.cfg
    assert (tcfg.num_steps, tcfg.updates_epochs) == (cfg.num_steps,
                                                     cfg.updates_epochs)
    ours = bench.model_flops(ppo.net, (tcfg.num_steps + 1) * n,
                             tcfg.updates_epochs * rows)
    assert ours == jax_flops
    assert abs(ours - 1.18e12) < 0.01e12      # ~1.18 TFLOP an iteration


def test_pgs_counts_match_a_hand_count():
    """2 envs, nc 3, nv 4; active contacts (1, 0, 1) and (0, 0, 1): 3 in
    all. Bytes: E's rows and W's columns of the active contacts, 4 x 3 x
    (2 x 3 x 4) = 288; the other operands whole, 4 x 2 x (9 x 3 + 2 x 3 +
    1) = 272; a table of 5 words, 20: 580 bytes. Operations an active
    contact: A's five entries 5 x 2 x 4 = 40, three divisions, the warm
    start 3 x 2 x 4 = 24, and per sweep 24 + 32 + 24 = 80: at 2 sweeps
    3 x (40 + 3 + 24 + 160) = 681."""
    active = torch.tensor([[1.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    byts, flops = measure.pgs_counts(active, 4, 2, 5)
    assert (byts, flops) == (580.0, 681.0)
    ms, by = measure.bound(byts, flops)
    assert by == "bytes" and ms == pytest.approx(580 / 3.35e12 * 1e3)
    ms, by = measure.bound(1.0, 1e9)
    assert by == "operations" and ms == pytest.approx(1e9 / 67e12 * 1e3)


def test_disagreement_counts_what_the_tolerance_lets_through():
    plain = torch.tensor([1.0, -2.0, 0.0, 0.5])
    assert measure.disagreement(plain.clone(), plain) == (0.0, 2.0, 0)
    # atol is 2e-5 x max|plain| = 4e-5; rtol 2e-4 x |plain|
    out = plain + torch.tensor([2e-4, 0.0, 3e-5, 1e-4])
    err, scale, outside = measure.disagreement(out, plain)
    assert scale == 2.0 and err == pytest.approx(2e-4, rel=1e-3)   # f32
    assert outside == 0
    out = plain + torch.tensor([0.0, 0.0, 5e-5, 0.0])
    assert measure.disagreement(out, plain)[2] == 1
    out = plain.clone()
    out[1] = float("nan")
    assert measure.disagreement(out, plain)[2] == 1


def test_benchmark_json_names_three_one_card_cells_and_their_metrics():
    cells = {w["name"]: w for w in SPEC["workloads"]}
    assert set(cells) == set(bench.CELLS) and len(cells) == 3
    assert all(w["chips"] == 1 for w in cells.values())
    assert all(w["config"] in SPEC["configs"] for w in cells.values())
    assert all(len(c["source"]) <= 200 for c in SPEC["configs"].values())
    rough_src = SPEC["configs"][cells[bench.ROUGH_PPO]["config"]]["source"]
    assert all(s in rough_src for s in ("cat_tpu/tasks/solo12_rough.py",
                                        "BASELINE.json config #3",
                                        "clean_rl_ppo_cfg.py:10-34"))
    for kind in ("end_to_end", "layer", "traces"):
        for m in SPEC["metrics"][kind]:
            assert m["workloads"] and set(m["workloads"]) <= set(cells), m
    e2e = {m["name"]: m for m in SPEC["metrics"]["end_to_end"]}
    assert e2e["env_steps_per_s"]["direction"] == "higher"
    assert e2e["env_steps_per_s"]["workloads"] == [bench.FLAT,
                                                   bench.ROUGH_PPO]
    assert e2e["engine_ms_per_control_step"]["direction"] == "lower"
    assert all(m["bound"] >= 0.05 for m in e2e.values())
    for name in bench.CELLS:
        assert METRICS[name] == set(bench.CELL_METRICS[name])
        assert set(bench.SUBSTEP_METRICS) <= METRICS[name]
    assert METRICS[bench.FLAT] == METRICS[bench.ROUGH_PPO]
    for name, task in bench.PPO_TASKS.items():
        traffic = cells[name]["traffic"]
        assert cells[name]["config"] == task
        assert (traffic["num_envs"], traffic["num_steps"],
                traffic["updates_epochs"], traffic["minibatch_size"],
                traffic["solver"], traffic["decimation"],
                traffic["warmup_iterations"], traffic["timed_iterations"]) == (
            bench.FULL_ENVS, 24, 5, 16384, "bj:4:0.9:6", 4,
            bench.DEFAULTS[name]["warmup"], bench.DEFAULTS[name]["iters"])
    eng = cells[bench.ENGINE]["traffic"]
    assert (eng["warmup_steps"], eng["timed_steps"]) == (
        bench.DEFAULTS[bench.ENGINE]["warmup"],
        bench.DEFAULTS[bench.ENGINE]["iters"])


@pytest.fixture(scope="module")
def rough_stages():
    """The plain stages' outputs for 6 Solo12s on a small rough heightfield
    (``tests/_substep_cases.py``), and the contacts compared there."""
    case = make_case("solo12-rough", 6)
    mt = dynamics.ModelTensors.build(case.model, "cpu")
    plain = engine.dynamics_stage(mt, case.params,
                                  *torch_inputs(case, "cpu"))
    plain_c = engine.contact_stage(mt, case.terrain, plain[3], plain[2],
                                   plain[1])
    keep = ~measure.ambiguous_contacts(mt, case.terrain, plain[3])
    return mt, case.terrain, plain, plain_c, keep


def _outputs(plain, plain_c) -> dict:
    return dict(zip(DYN_OUTPUTS + CONTACT_OUTPUTS,
                    (*plain[:3], *plain[3], *plain_c)))


def _stages(outs: dict):
    """(dynamics outputs, contact outputs) from the outputs by name."""
    kin = dynamics.ContactKin(outs["R"], outs["o"], outs["a_w"])
    return ((outs["tau_j"], outs["v_free"], outs["Minv"], kin),
            tuple(outs[k] for k in CONTACT_OUTPUTS))


def test_compare_stages_passes_equal_outputs(rough_stages):
    mt, terr, plain, plain_c, keep = rough_stages
    outs = {k: v.clone() for k, v in _outputs(plain, plain_c).items()}
    cmp = measure.compare_stages(mt, terr, *_stages(outs), plain, plain_c,
                                 plain[3])
    assert cmp.ok and cmp.worst == 0.0 and cmp.outside == {}
    assert cmp.contacts == keep.numel() and cmp.left_out == int((~keep).sum())
    # too many contacts left out fails, though no entry is outside
    assert not cmp._replace(left_out=cmp.contacts).ok


@pytest.mark.parametrize("name", ["E", "frame"])
def test_compare_stages_holds_a_heightfields_rows_at_the_tolerance_given(
        rough_stages, name):
    """E and the frames at HFIELD_ATOL unless the caller gives another
    tolerance (the bench's HFIELD_LIMIT): an entry moved by a step between
    the two fails the first and passes the second; other outputs keep
    their STAGE_TOL."""
    mt, terr, plain, plain_c, keep = rough_stages
    assert measure.HFIELD_ATOL < bench.HFIELD_LIMIT
    outs = {k: v.clone() for k, v in _outputs(plain, plain_c).items()}
    at = tuple(measure._contact_axis(name, keep, outs[name].shape)
               .nonzero()[0])
    outs[name][at] += 0.5 * (measure.HFIELD_ATOL + bench.HFIELD_LIMIT)
    got = [measure.compare_stages(mt, terr, *_stages(outs), plain, plain_c,
                                  plain[3], *tol)
           for tol in ((), (bench.HFIELD_LIMIT,))]
    assert not got[0].ok and got[0].outside == {name: 1}
    assert got[1].ok
    assert f"(E, frame at {bench.HFIELD_LIMIT:g})" in got[1].text
    outs["phi"][tuple(keep.nonzero()[0])] += 0.5 * (measure.HFIELD_ATOL
                                                    + bench.HFIELD_LIMIT)
    assert measure.compare_stages(
        mt, terr, *_stages(outs), plain, plain_c, plain[3],
        bench.HFIELD_LIMIT).outside == {"phi": 1}


@pytest.mark.parametrize("name", DYN_OUTPUTS + CONTACT_OUTPUTS)
def test_compare_stages_fails_a_fault_in_one_output(rough_stages, name):
    """One entry of one output moved by 1e-2 x (1 + its max|x|), beyond
    every tolerance of STAGE_TOL (in a contact the comparison keeps)."""
    mt, terr, plain, plain_c, keep = rough_stages
    outs = {k: v.clone() for k, v in _outputs(plain, plain_c).items()}
    x = outs[name]
    if name in CONTACT_OUTPUTS:
        at = tuple(measure._contact_axis(name, keep, x.shape).nonzero()[0])
    else:
        at = (0,) * x.dim()
    x[at] += 1e-2 * (1.0 + x.abs().max())
    cmp = measure.compare_stages(mt, terr, *_stages(outs), plain, plain_c,
                                 plain[3])
    assert not cmp.ok and cmp.outside == {name: 1}
    assert cmp.worst == pytest.approx(1e-2 * (1.0 + float(
        _outputs(plain, plain_c)[name].abs().max())), rel=1e-3)


def test_bench_spread_bounds_are_the_widest_relative_spread_with_a_floor():
    """``tools/bench_spread.py``: 1.5 x (max - min) / median, never under
    0.05; each cell of BENCHMARK.json maps to its end-to-end metric."""
    from cat_tpu_torch.tools import bench_spread

    assert bench_spread.bound([2.0, 2.01, 2.02]) == 0.05
    assert bench_spread.bound([90.0, 100.0, 120.0]) == pytest.approx(0.45)
    assert bench_spread.end_to_end(SPEC) == {
        bench.FLAT: ("env_steps_per_s", "higher"),
        bench.ROUGH_PPO: ("env_steps_per_s", "higher"),
        bench.ENGINE: ("engine_ms_per_control_step", "lower")}
    assert bench_spread.summary([1.0, 2.0, 3.0, 4.0])["median"] == 2.5


def test_bench_spread_pairs_won_read_each_metrics_direction():
    """A round's change wins where it is faster (a time) or higher (a
    rate); ties win nothing."""
    from cat_tpu_torch.tools import bench_spread

    assert bench_spread.pairs_won([1.0, 2.0, 3.0], [2.0, 2.0, 1.0],
                                  higher=False) == 1
    assert bench_spread.pairs_won([1.0, 2.0, 3.0], [2.0, 2.0, 1.0],
                                  higher=True) == 1
    assert bench_spread.pairs_won([0.012, 0.011], [0.022, 0.023],
                                  higher=False) == 2


def test_bench_spread_traced_pairs_every_metric_and_prints_no_bounds(
        monkeypatch, tmp_path, capsys):
    """``--traced``: each cell's other numbers are paired beside its
    end-to-end metric (the rounds in which the change read lower) and no
    bound is printed; without it the same readings give bounds and no
    layers."""
    from cat_tpu_torch.tools import bench_spread

    def fake(root, cell, seed, metric, traced=False, **kw):
        side = 0.0 if root == bench_spread.REPO else 1.0
        layers = {"substep_post_ms": 0.01 + 0.01 * side,
                  "device_idle_share": 0.5} if traced else {}
        return {"value": 100.0 - side, "correct": True, "failed": [],
                "layers": layers, "seconds": 0.0}

    monkeypatch.setattr(bench_spread, "run_bench", fake)
    monkeypatch.setattr(bench_spread, "parent_cells",
                        lambda root: set(bench.CELLS))
    monkeypatch.setattr(measure, "card_line", lambda: "card, 700 W")
    for traced in (True, False):
        out = tmp_path / f"{traced}.json"
        argv = ["--runs", "2", "--cell", bench.FLAT, "--parent",
                str(tmp_path), "--out", str(out)]
        assert bench_spread.main(argv + ["--traced"] * traced) == 0
        result = json.loads(out.read_text())
        row = result["cells"][bench.FLAT]
        assert row["change_won"] == 2
        if traced:
            assert "bounds" not in result and "bound" not in row
            assert row["layers"]["substep_post_ms"]["change_lower"] == 2
            assert row["layers"]["device_idle_share"]["change_lower"] == 0
        else:
            assert result["bounds"] == {"env_steps_per_s": 0.05}
            assert "layers" not in row
    capsys.readouterr()


def test_bench_spread_variants_parse():
    from cat_tpu_torch.tools import bench_spread

    assert bench_spread.parse_variant("long,iters=100") == {
        "label": "long", "iters": 100, "cpus": None}
    assert bench_spread.parse_variant("pinned,cpus=0-3") == {
        "label": "pinned", "iters": None, "cpus": {0, 1, 2, 3}}
    assert bench_spread.PPO_CELLS == {bench.FLAT, bench.ROUGH_PPO}
    with pytest.raises(ValueError):
        bench_spread.parse_variant("x,warmup=2")


def test_launch_checks_key_the_solve_by_the_name_given():
    """The contact solve's check is ``launches`` whatever its name, each
    other kernel's ``launches_<name>``; a sample off the count fails."""
    cell = bench.Cell("x", "cpu", ())
    with contextlib.redirect_stdout(io.StringIO()):
        bench.launch_checks(cell, "a_solve", {"a_solve": [4, 4],
                                              "pgs_bj": [4, 4],
                                              "contact_rows": [4, 3]},
                            4, "an iteration")
    assert cell.checks == {"launches": True, "launches_pgs_bj": True,
                           "launches_contact_rows": False}


def test_innermost_span():
    spans = [(0.0, 10.0, "it"), (1.0, 4.0, "step"), (2.0, 3.0, "solve"),
             (6.0, 9.0, "sgd")]
    assert bench._innermost(spans, [0.5, 2.5, 3.5, 5.0, 7.0, 11.0]) == [
        "it", "solve", "step", "it", "sgd", bench.OUTSIDE]


def _event(name, start, end, device, corr=0):
    kind = (torch.autograd.DeviceType.CUDA if device
            else torch.autograd.DeviceType.CPU)
    return types.SimpleNamespace(
        name=name, id=corr, device_type=kind,
        is_user_annotation=name in ("step", "solve"),
        time_range=types.SimpleNamespace(
            start=start, end=end, elapsed_us=lambda s=start, e=end: e - s))


def test_breakdown_names_kernels_and_gaps_by_span():
    """Host: span step [0, 100] holding span solve [40, 60]; the runtime's
    launch calls of k1 at 5 and of k2 at 42 (their correlation ids), an op
    that shares k3's id but is no launch call. Card: k1 [10, 20], k2 [50,
    80], k3 [90, 95], and the card's copy of the span annotation, which is
    no kernel."""
    events = [_event("step", 0, 100, False, corr=1),
              _event("solve", 40, 60, False, corr=2),
              _event("cudaLaunchKernel", 5, 6, False, corr=3),
              _event("cudaLaunchKernel", 42, 43, False, corr=7),
              _event("aten::add", 44, 45, False, corr=9),
              _event("k1", 10, 20, True, corr=3),
              _event("k2", 50, 80, True, corr=7),
              _event("k3", 90, 95, True, corr=9),
              _event("solve", 50, 70, True)]
    bd = bench.breakdown(types.SimpleNamespace(events=lambda: events),
                         ("step", "solve"))
    assert bd["kernels"] == 3 and bd["busy_s"] == pytest.approx(45e-6)
    assert bd["linked_share"] == pytest.approx(2 / 3)
    assert [(k["name"], k["span"]) for k in bd["top_kernels"]] == [
        ("k2", "solve"), ("k1", "step"), ("k3", "step")]
    # gap before k2 (30 us, launched inside solve), before k3 (10 us, its
    # own start 90 lies in step)
    assert [(g["ms"], g["span"], g["before"]) for g in bd["idle_gaps"]] == [
        (0.03, "solve", "k2"), (0.01, "step", "k3")]
    assert bd["idle_ms_by_span"] == {"solve": 0.03, "step": 0.01}


def test_flat_spans_come_on_for_one_run_and_go():
    """The spans on the CPU (host events only): each named span is
    recorded, the rollout mark comes after the 24th env step, and after
    the run every wrapper is gone."""
    from torch.profiler import ProfilerActivity, profile, record_function

    spec = registry.get(bench.FLAT_TASK)
    env = spec.make_env(4, device="cpu")
    cfg = spec.make_agent_cfg()
    cfg = dataclasses.replace(cfg, minibatch_size=16, num_steps=4)
    gen = torch.Generator().manual_seed(0)
    es = env.init(gen, 4)
    ppo = PPO(env, cfg, torch.Generator().manual_seed(0))
    ppo.start(env.observe(es, gen))
    engine, syncs = env.engine, []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with bench.PpoSpans(env, ppo, mark_after=4,
                             sync=lambda: syncs.append(1)) as spans:
            with record_function("ppo.train_iteration"):
                ppo.train_iteration(es, gen)
    names = {e.name for e in prof.events()}
    assert set(bench.PpoSpans.NAMES) <= names
    assert len(spans.marks) == 1 and syncs == [1]
    assert env.engine is engine
    assert "step" not in vars(env) and "sgd_step" not in vars(ppo)
    assert "forward" not in vars(ppo.net)


def test_graphed_spans_come_on_for_one_run_and_go(monkeypatch):
    """The graphed iteration's spans on the CPU, with ``utils/graphs.py``'s
    graphs replayed by ``_torch_steps.stand_in_graphs``: after the
    warm-up and the capture, a spanned iteration of the two replays
    records ``ppo.rollout`` and ``ppo.learn``, marks the rollout's end
    once after ``ppo.rollout``, calls no step span, and takes every
    wrapper off after the run."""
    from torch.profiler import ProfilerActivity, profile

    from _torch_steps import stand_in_graphs

    replays = stand_in_graphs(monkeypatch)
    spec = registry.get(bench.FLAT_TASK)
    env = spec.make_env(4, device="cpu")
    cfg = dataclasses.replace(spec.make_agent_cfg(), minibatch_size=16,
                              num_steps=4)
    gen = torch.Generator().manual_seed(0)
    es = env.init(gen, 4)
    ppo = PPO(env, cfg, torch.Generator().manual_seed(0))
    ppo.start(env.observe(es, gen))
    for _ in range(2):
        es, _ = ppo.learn(*ppo.rollout(es, gen), gen)
    syncs = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with bench.PpoSpans(env, ppo, mark_after=4,
                            sync=lambda: syncs.append(1)) as spans:
            ppo.learn(*ppo.rollout(es, gen), gen)
    names = {e.name for e in prof.events()}
    assert set(bench.PpoSpans.GRAPHED) <= names
    assert not {"env.step", "ppo.sgd_step"} & names
    assert len(spans.marks) == 1 and syncs == [1] and len(replays) == 2
    assert not {"rollout", "learn", "step"} & (set(vars(ppo)) | set(vars(env)))
