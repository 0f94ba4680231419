"""The port's dotted-path overrides, checkpoint validation, constraint table
and metric writers against the JAX package's (the counterparts of the 6
tests of tests/test_overrides.py). Overrides and the table are exact
(the same values, the same text); there is no tolerance here.
"""

import dataclasses
import json
import sys
import types

import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from cat_tpu.envs import env as jenv
from cat_tpu.rl.ppo import PpoCfg as JCfg
from cat_tpu.utils.overrides import apply_overrides as jax_apply_overrides
from cat_tpu_torch.envs import env as tenv
from cat_tpu_torch.rl import checkpoint
from cat_tpu_torch.rl.ppo import PPO, PpoCfg
from cat_tpu_torch.tasks import registry
from cat_tpu_torch.utils.logging import MetricLogger
from cat_tpu_torch.utils.overrides import apply_overrides, set_path

NESTED = ["episode_length_s=5.0", "events.push_enabled=False",
          "commands.lin_vel_x=(-0.5, 1.0)", "noise.joint_vel=0.3",
          "solver_structure='bj:2'", "solver_iterations=8"]


def test_override_scalar_and_nested():
    cfg = apply_overrides(tenv.EnvCfg(), NESTED)
    assert cfg.episode_length_s == 5.0
    assert cfg.events.push_enabled is False
    assert cfg.commands.lin_vel_x == (-0.5, 1.0)
    assert cfg.noise.joint_vel == 0.3
    assert cfg.solver_structure == "bj:2" and cfg.solver_iterations == 8
    assert cfg.events.friction_range == (0.5, 1.25)   # siblings untouched
    ref = jax_apply_overrides(jenv.EnvCfg(), NESTED)
    for ov in NESTED:
        path = ov.partition("=")[0].split(".")
        mine, theirs = cfg, ref
        for name in path:
            mine, theirs = getattr(mine, name), getattr(theirs, name)
        assert mine == theirs and type(mine) is type(theirs), ov


def test_override_type_coercion_and_errors():
    ov = ["learning_rate=1e-4", "num_steps=12", "hidden=[64, 32]",
          "lr_mode=adaptive_kl", "vf_coef=1"]
    cfg = apply_overrides(PpoCfg(), ov)
    assert cfg.learning_rate == 1e-4 and cfg.num_steps == 12
    assert cfg.hidden == (64, 32) and cfg.lr_mode == "adaptive_kl"
    assert cfg.vf_coef == 1.0 and isinstance(cfg.vf_coef, float)
    ref = dataclasses.asdict(jax_apply_overrides(JCfg(), ov))
    # the port always normalises advantages and clips the value loss
    assert ref.pop("norm_adv") and ref.pop("clip_vloss")
    assert dataclasses.asdict(cfg) == ref
    with pytest.raises(KeyError, match="no field 'nope'"):
        set_path(tenv.EnvCfg(), "nope", 1)
    with pytest.raises(KeyError, match="valid fields"):
        set_path(tenv.EnvCfg(), "events.nope", 1)
    with pytest.raises(ValueError, match="expected a bool"):
        set_path(tenv.EnvCfg(), "events.push_enabled", 3)
    with pytest.raises(ValueError, match="expected int"):
        set_path(PpoCfg(), "num_steps", 2.5)
    with pytest.raises(ValueError, match="not of the form"):
        apply_overrides(tenv.EnvCfg(), ["just_a_key"])


@pytest.mark.parametrize("task", ["Solo12-CaT-Flat-v0", "Go2-CaT-Flat-v0",
                                  "Solo12-CaT-Flat-Play-v0"])
def test_make_env_overrides_reach_env_cfg(task):
    env = registry.get(task).make_env(
        num_envs=4, overrides=("events.friction_num_buckets=7",
                               "episode_length_s=4.0"), device="cpu")
    assert env.cfg.events.friction_num_buckets == 7
    assert env.cfg.episode_length_s == 4.0
    assert env.cfg.noise.enabled is not task.endswith("Play-v0")


def _learner(n, shared=False):
    env = registry.get("Solo12-CaT-Flat-v0").make_env(n, device="cpu")
    gen = torch.Generator().manual_seed(0)
    es = env.init(gen, n)
    ppo = PPO(env, PpoCfg(shared_model=shared, hidden=(16, 8)),
              torch.Generator().manual_seed(1))
    ppo.start(env.observe(es, gen))
    return ppo, es


def test_checkpoint_restore_validates(tmp_path):
    ppo, es = _learner(8)
    path = checkpoint.save(str(tmp_path / "c1"), ppo, es)
    assert path.endswith("c1.pt")

    # matching templates: round-trips
    ppo2, es2 = _learner(8)
    with torch.no_grad():
        for p in ppo2.net.parameters():
            p.add_(1.0)
    es2 = checkpoint.restore(str(tmp_path / "c1"), ppo2, es2)
    assert not checkpoint.mismatches(checkpoint.state_dict(ppo, es),
                                     checkpoint.state_dict(ppo2, es2))

    # strict: another env count raises and names the leaf and its shapes
    ppo4, es4 = _learner(4)
    with pytest.raises(ValueError, match=r"leaf ppo\.next_obs has shape "
                                         r"\(8, 45\), expected \(4, 45\)"):
        checkpoint.restore(path, ppo4, es4)

    # non-strict: the env-sized leaves keep the live values
    es4b = checkpoint.restore(path, ppo4, es4, strict=False)
    assert es4b.sim.qpos.shape == (4, 19) and ppo4.next_obs.shape == (4, 45)
    torch.testing.assert_close(es4b.sim.qpos, es4.sim.qpos, rtol=0, atol=0)
    for (name, a), b in zip(ppo.net.state_dict().items(),
                            ppo4.net.state_dict().values()):
        assert torch.equal(a, b), name

    # another network layout raises even non-strict
    ppo_s, es_s = _learner(8, shared=True)
    with pytest.raises(ValueError, match="does not match the live state"):
        checkpoint.restore(path, ppo_s, es_s, strict=False)

    # another dtype raises even non-strict
    bad = es._replace(episode_len=es.episode_len.float())
    with pytest.raises(ValueError, match=r"leaf env\.episode_len has dtype"):
        checkpoint.restore(path, ppo, bad, strict=False)


def test_constraint_table():
    from _torch_port import deterministic_cfgs, jax_env_lanes_bj, port_env

    jc, tc = deterministic_cfgs(2)
    s = port_env(tc).cset.table()
    assert "joint_torque" in s and "upsidedown" in s
    assert "max_p" in s and "Curriculum" in s
    assert len(s.splitlines()) == len(port_env(tc).cset.terms) + 5
    assert s == jax_env_lanes_bj(jc).cset.table()


def _blocked_import(name):
    real = __import__

    def imp(mod, *a, **k):
        if mod == name or mod.startswith(name + "."):
            raise ImportError(f"{name} blocked for test")
        return real(mod, *a, **k)

    return imp


def test_wandb_writer_option(tmp_path, monkeypatch, capsys):
    """writer="wandb" drives a fake wandb module (no network here); a
    missing package leaves JSONL only, with a printed reason, for either
    writer."""
    calls = {"init": [], "log": [], "finish": 0}
    fake = types.ModuleType("wandb")
    fake.init = lambda **kw: calls["init"].append(kw)
    fake.log = lambda d, step=None: calls["log"].append((d, step))

    def _fin():
        calls["finish"] += 1

    fake.finish = _fin
    monkeypatch.setitem(sys.modules, "wandb", fake)
    lg = MetricLogger(str(tmp_path / "r1"), writer="wandb",
                      wandb_init_kwargs={"project": "cat"})
    lg.log({"Episode/reward": torch.tensor(1.5), "skip": "text"}, step=3)
    lg.close()
    assert calls["init"][0]["project"] == "cat"
    assert calls["log"] == [({"Episode/reward": 1.5}, 3)]
    assert calls["finish"] == 1
    with open(tmp_path / "r1" / "metrics.jsonl") as f:
        assert json.loads(f.readline()) == {"step": 3, "Episode/reward": 1.5}

    monkeypatch.delitem(sys.modules, "wandb")
    monkeypatch.setattr("builtins.__import__", _blocked_import("wandb"))
    lg2 = MetricLogger(str(tmp_path / "r2"), writer="wandb")
    lg2.log({"a": 1.0}, step=1)
    lg2.close()
    with open(tmp_path / "r2" / "metrics.jsonl") as f:
        assert json.loads(f.readline())["a"] == 1.0
    assert "wandb writer unavailable" in capsys.readouterr().out

    for mod in [m for m in sys.modules if m.startswith("torch.utils.tensorboard")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setattr("builtins.__import__",
                        _blocked_import("torch.utils.tensorboard"))
    lg3 = MetricLogger(str(tmp_path / "r3"), writer="tensorboard")
    lg3.log({"a": 2.0}, step=1)
    lg3.close()
    assert "tensorboard writer unavailable" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unknown writer"):
        MetricLogger(str(tmp_path / "r4"), writer="csv")
