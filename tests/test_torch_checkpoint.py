"""Checkpoint, resume, play and the training CLI of the port, on the CPU at
a few envs (the counterparts of cat_tpu/rl/checkpoint.py's guarantees and
of scripts/train.py / scripts/play.py).

Everything here is exact: on the CPU the port's arithmetic is
deterministic, so a resumed run equals an uninterrupted one bit for bit
(every tensor of the learner, the envs' state and the generators, and every
logged metric but the timings).
"""

import json
import os

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from cat_tpu_torch import play, train
from cat_tpu_torch.rl import checkpoint

TINY = ["--num_envs", "8", "--device", "cpu", "--writer", "none",
        "--override", "num_steps=4", "minibatch_size=16", "save_interval=1"]


def _train(logdir, run, task, agent, *extra, overrides=()):
    history = train.main(["--task", task, "--agent", agent, "--logdir",
                          str(logdir), "--run_name", run, *extra, *TINY,
                          *overrides])
    return os.path.join(str(logdir), agent, task, run), history


def _lines(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("task,agent", [
    ("Solo12-CaT-Flat-v0", "clean_rl"), ("Go2-CaT-Flat-v0", "rl_games"),
    ("Solo12-CaT-Flat-v0", "skrl"),
])
def test_resume_equals_uninterrupted(tmp_path, task, agent):
    """ckpt_1 + one resumed iteration == two uninterrupted iterations."""
    mb = ["minibatch_size=8"] if agent == "skrl" else []
    whole, hist = _train(tmp_path, "whole", task, agent, "--max_iterations",
                         "2", overrides=mb)
    assert len(hist) == 2
    assert sorted(f for f in os.listdir(whole) if f.startswith("ckpt")) == [
        "ckpt_1.pt", "ckpt_2.pt", "ckpt_final.pt"]
    resumed, hist2 = _train(tmp_path, "resumed", task, agent,
                            "--max_iterations", "2", "--checkpoint",
                            os.path.join(whole, "ckpt_1"), overrides=mb)
    assert len(hist2) == 1
    assert checkpoint.mismatches(checkpoint.load(os.path.join(whole, "ckpt_2")),
                                 checkpoint.load(os.path.join(resumed,
                                                              "ckpt_2"))) == []
    a, b = _lines(whole)[1], _lines(resumed)[0]
    assert a["step"] == b["step"] == 2
    for k in a:
        if not k.startswith("Perf/"):
            assert a[k] == b[k], k
    with open(os.path.join(whole, "config.json")) as f:
        config = json.load(f)
    assert config["task"] == task and config["agent"] == agent
    assert config["agent_cfg"]["shared_model"] == (agent == "skrl")


def _trainer(task="Go2-CaT-Flat-v0", agent="rl_games"):
    return train.Trainer(train.parse_args(
        ["--task", task, "--agent", agent, *TINY]))


def test_restore_is_bitwise_and_generators_carry(tmp_path):
    tr = _trainer()
    tr.train_iteration()
    path = tr.save(str(tmp_path / "ckpt_1"))
    fresh = _trainer()
    fresh.restore(path)
    saved = checkpoint.load(path)
    live = checkpoint.state_dict(fresh.ppo, fresh.es, fresh.generators)
    assert checkpoint.mismatches(saved, live) == []
    assert fresh.ppo.iteration == 1
    assert fresh.ppo.opt.param_groups[0]["lr"] is fresh.ppo.lr
    assert float(fresh.ppo.lr) == float(saved["ppo"]["lr"])
    # the next iteration's draws continue the saved generator streams
    m1, m2 = tr.train_iteration(), fresh.train_iteration()
    assert m1 == m2


def test_non_strict_restore_into_a_play_env(tmp_path):
    run, _ = _train(tmp_path, "r", "Go2-CaT-Flat-v0", "rl_games",
                    "--max_iterations", "1")
    tr = _trainer("Go2-CaT-Flat-Play-v0", "clean_rl")
    env = tr.env
    es4 = env.init(torch.Generator().manual_seed(0), 4)
    ppo_state = checkpoint.load(checkpoint.latest(run))["ppo"]
    with pytest.raises(ValueError, match=r"leaf .* has shape"):
        checkpoint.restore(checkpoint.latest(run), tr.ppo, es4)
    es = checkpoint.restore(checkpoint.latest(run), tr.ppo, es4, strict=False)
    assert es.sim.qpos.shape[0] == 4 and env.cfg.noise.enabled is False
    for name, p in tr.ppo.net.state_dict().items():
        assert torch.equal(p, ppo_state["net"][name]), name
    assert torch.equal(tr.ppo.obs_rms.mean, ppo_state["obs_rms"]["mean"])


def test_latest_picks_final_then_the_highest_iteration(tmp_path):
    for name in ("ckpt_2.pt", "ckpt_10.pt", "ckpt_diverged_11.pt", "x.pt"):
        (tmp_path / name).write_bytes(b"")
    assert checkpoint.latest(str(tmp_path)).endswith("ckpt_10.pt")
    (tmp_path / "ckpt_final.pt").write_bytes(b"")
    assert checkpoint.latest(str(tmp_path)).endswith("ckpt_final.pt")
    with pytest.raises(FileNotFoundError):
        checkpoint.latest(str(tmp_path / ".."))


def test_divergence_dumps_the_state_and_exits(tmp_path, monkeypatch):
    real = train.Trainer.train_iteration

    def diverge(self):
        metrics = real(self)
        metrics["Loss/mean_surrogate_loss"] = float("nan")
        return metrics

    monkeypatch.setattr(train.Trainer, "train_iteration", diverge)
    with pytest.raises(SystemExit) as exc:
        _train(tmp_path, "d", "Solo12-CaT-Flat-v0", "clean_rl",
               "--max_iterations", "2")
    assert exc.value.code == 1
    run = tmp_path / "clean_rl" / "Solo12-CaT-Flat-v0" / "d"
    assert (run / "ckpt_diverged_1.pt").exists()
    assert not (run / "ckpt_final.pt").exists()
    assert checkpoint.load(str(run / "ckpt_diverged_1"))["ppo"]["iteration"] == 1


def test_play_exports_and_writes_the_trajectory(tmp_path):
    run, _ = _train(tmp_path, "p", "Go2-CaT-Flat-v0", "rl_games",
                    "--max_iterations", "1")
    out = play.main(["--run_dir", run, "--steps", "5", "--num_envs", "4",
                     "--device", "cpu"])
    assert out["task"] == "Go2-CaT-Flat-Play-v0"
    assert out["qpos"].shape == (5, 4, 19) and np.all(np.isfinite(out["qpos"]))
    for name in ("policy_params.npz", "policy.pt", "policy.pt2",
                 "play_traj.npz"):
        assert os.path.exists(os.path.join(run, name)), name
    traj = np.load(os.path.join(run, "play_traj.npz"))
    assert traj["reward"].shape == (5,)
