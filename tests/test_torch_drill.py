"""The port's preemption drill (cat_tpu_torch/tools/resume_drill.py) on the
CPU at a tiny size: 8 envs, 6 iterations, a checkpoint every 2, the
trainer SIGKILLed once ckpt_4.pt lands, then resumed from it.

Each leg of the drill runs under its own time limit
(``resume_drill.LEG_TIMEOUT_S``, 300 s; ~30 s in all on an idle 8-core
CPU, one thread a process).
"""

import json

import _torch_port  # noqa: F401  (one torch thread per test worker)
from cat_tpu_torch.tools import resume_drill


def test_resume_drill_on_the_cpu(tmp_path, monkeypatch):
    # the trainers are child processes: one thread each, as this worker
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "drill.json"
    res = resume_drill.main([
        "--num_envs", "8", "--iters", "6", "--save_interval", "2",
        "--kill_after", "4", "--device", "cpu", "--logdir",
        str(tmp_path / "logs"), "--out", str(out)])
    assert res["pass"], res
    assert res["killed_by_sigkill"]
    assert res["iterations_covered"] == [1, 6] and res["no_gap_1_to_6"]
    assert res["resumed_from_iteration"] == 5 and res["resumed_leg_in_order"]
    assert res["rewards_finite"]
    assert json.loads(out.read_text()) == res
    run = (tmp_path / "logs" / "clean_rl" / "Solo12-CaT-Flat-v0"
           / "resume_drill")
    steps = [json.loads(line)["step"]
             for line in (run / "metrics.jsonl").read_text().splitlines()]
    # the resumed leg appended exactly iterations 5 and 6 after the lines
    # the killed run wrote (at least 1..4)
    k = res["lines_before_kill"]
    assert k >= 4 and steps[:4] == [1, 2, 3, 4]
    assert steps[k:] == [5, 6] and res["resumed_leg_lines"] == 2
    assert set(steps) == set(range(1, 7))
    assert (run / "ckpt_6.pt").exists() and (run / "ckpt_final.pt").exists()
