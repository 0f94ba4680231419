"""The learning-curve gates of cat_tpu_torch/parity.py, on the JAX package's
committed runs (no card needed).

runs/solo12_flat_r3 and runs/solo12_flat_r4 are the JAX package's own runs
of the flat recipe at seed 1, as is the reference runs/solo12_flat_2000it:
both pass, the curve gates on, with the deviations of their smoothed
hard-violation curves pinned to 1e-3 pp. The port's own 2000-iteration
run (runs/torch_solo12_flat_2000it) passes too, and its committed
parity.json is re-derived from its committed log. Copies of r3 altered
here fail the gate each alteration aims at.
"""

import copy
import json

import pytest

from cat_tpu_torch import parity

REF = "runs/solo12_flat_2000it/metrics.jsonl.gz"
TERM = "Episode_Constraint_violation/cstr_contact"


@pytest.fixture(scope="module")
def logs():
    return {name: parity.load_metrics(f"runs/{name}/metrics.jsonl.gz")
            for name in ("solo12_flat_2000it", "solo12_flat_r3",
                         "solo12_flat_r4")}


# worst term: cstr_front_hfe_position in both; (mean pp, max pp, ep_len)
JAX_RUNS = {"solo12_flat_r3": (0.15556, 0.56476, 317.334),
            "solo12_flat_r4": (0.10768, 0.35854, 337.691)}


@pytest.mark.parametrize("name", sorted(JAX_RUNS))
def test_jax_runs_pass_with_the_curve_gates_on(logs, name):
    out = parity.compare(logs[name], logs["solo12_flat_2000it"], 1, 2000)
    assert out["pass"], out["failures"]
    assert out["curve_gates"]["on"] and out["reward_rises"]["on"]
    assert out["window"] == [1971, 2000] and out["iterations"] == 2000
    devs = out["curve_gates"]["hard_curve_dev"]
    assert sorted(devs) == ["cstr_contact", "cstr_foot_contact_force",
                            "cstr_front_hfe_position", "cstr_upsidedown"]
    worst = max(devs, key=lambda t: devs[t]["mean_pp"])
    assert worst == max(devs, key=lambda t: devs[t]["max_pp"]) == \
        "cstr_front_hfe_position"
    mean_pp, max_pp, ep_len = JAX_RUNS[name]
    assert devs[worst]["mean_pp"] == pytest.approx(mean_pp, abs=1e-3)
    assert devs[worst]["max_pp"] == pytest.approx(max_pp, abs=1e-3)
    assert out["episode_length"]["port"] == pytest.approx(ep_len, abs=1e-3)
    assert out["episode_length"]["reference"] == pytest.approx(327.259,
                                                               abs=1e-3)
    assert out["reward_per_step"]["reference"] == pytest.approx(0.022520,
                                                                abs=1e-6)


def _leaves(d, path=()):
    if isinstance(d, dict):
        for k, v in d.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, d


def test_port_run_reproduces_its_parity_json(logs):
    """The port's 2000-iteration run (runs/torch_solo12_flat_2000it, on the
    H100) passes with the curve gates on, and compare() re-derives every
    number of its committed parity.json from its committed log."""
    port = parity.load_metrics("runs/torch_solo12_flat_2000it/"
                               "metrics.jsonl.gz")
    out = parity.compare(port, logs["solo12_flat_2000it"], 1, 2000)
    assert out["pass"], out["failures"]
    assert out["curve_gates"]["on"] and out["reward_rises"]["on"]
    with open("runs/torch_solo12_flat_2000it/parity.json") as f:
        committed = json.load(f)
    assert committed.pop("logs") == {
        "port": "runs/torch_solo12_flat_2000it/metrics.jsonl.gz",
        "reference": REF}
    got, want = dict(_leaves(out)), dict(_leaves(committed))
    assert sorted(got) == sorted(want)
    for path, v in want.items():
        if isinstance(v, float):
            assert got[path] == pytest.approx(v, rel=1e-9, abs=1e-12), path
        else:
            assert got[path] == v, path
    devs = out["curve_gates"]["hard_curve_dev"]["cstr_front_hfe_position"]
    assert devs["mean_pp"] == pytest.approx(0.157, abs=1e-3)
    assert devs["max_pp"] == pytest.approx(0.541, abs=1e-3)


def _raise(rows, steps, pp):
    for r in rows:
        if r["step"] in steps:
            r[TERM] += pp


def _fall(rows, steps, pp):
    n = len(rows)
    for i, r in enumerate(rows):
        r["Train/mean_reward_per_step"] = 0.03 * (n - i) / n


ALTERED = {
    # +7 pp for 200 iterations in mid-run: the smoothed curve peaks ~7 pp
    # off, its mean over the last 75% stays under 1.5 pp
    "raised_200": (_raise, range(1001, 1201), 7.0,
                   "cstr_contact curve max deviation"),
    # +2 pp over the whole last 75%: under 6 pp at every point
    "raised_tail": (_raise, range(488, 2001), 2.0,
                    "cstr_contact curve mean deviation"),
    "reward_falls": (_fall, None, None, "reward/step did not rise"),
}


@pytest.mark.parametrize("name", sorted(ALTERED))
def test_altered_runs_fail_their_gate(logs, name):
    alter, steps, pp, failure = ALTERED[name]
    rows = copy.deepcopy(logs["solo12_flat_r3"])
    alter(rows, steps, pp)
    out = parity.compare(rows, logs["solo12_flat_2000it"], 1, 2000)
    assert not out["pass"]
    assert [f for f in out["failures"] if f.startswith(failure)], \
        out["failures"]
    if name != "reward_falls":
        assert len(out["failures"]) == 1, out["failures"]


def test_repeated_step_is_refused(logs):
    rows = logs["solo12_flat_r3"]
    resumed = rows[:1000] + rows[950:]    # a resume from ckpt_950
    with pytest.raises(ValueError, match="repeats steps"):
        parity.compare(resumed, logs["solo12_flat_2000it"], 1, 2000)


def test_short_span_turns_the_curve_gates_off(logs):
    out = parity.compare(logs["solo12_flat_r3"][:999],
                         logs["solo12_flat_2000it"])
    assert out["span"] == [1, 999] and out["iterations"] == 999
    assert not out["curve_gates"]["on"]
    assert out["curve_gates"]["hard_curve_dev"] == {}
    assert out["reward_rises"]["on"]


def test_cli_prints_its_json(capsys):
    result = parity.main(["runs/solo12_flat_r4/metrics.jsonl.gz", REF,
                          "--first", "1", "--last", "2000"])
    assert result["pass"]
    assert json.loads(capsys.readouterr().out) == result
