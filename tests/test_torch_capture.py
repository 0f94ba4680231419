"""The three steps a card replays as CUDA graphs can be captured: once
warmed up, ``CatEnv.step``, the rollout's draw (``PPO.draw``) and
``PPO.sgd_step`` neither wait on the device nor make a tensor from host
data, and the env state holds no host number.

A capture records what is launched; it refuses a read of a device value on
the host (``aten._local_scalar_dense``: ``.item()``, ``bool(t)``), freezes
a tensor made from host data into the graph (``aten.lift_fresh``,
``lift_fresh_copy``: ``torch.tensor(...)``, ``torch.as_tensor`` of numpy)
and cannot size an output by the data (``aten.nonzero``, and what
leads to it: ``aten.masked_select``, ``aten.index`` by a boolean mask). A ``TorchDispatchMode`` sees every op the step dispatches; on the
CPU, where these tests run, the kernels' plain versions stand in for the
kernels the card's graphs launch (``sim/engine.py`` ``dynamics_stage``,
``contact_stage``, ``post_stage``; ``ops/pgs.py`` ``pgs_bj_reference``,
``pgs_gs_reference``), so their ops are not watched. Each step runs on
the three configurations of ``tests/_torch_steps.py`` (Solo12 flat,
Solo12 rough with the terrain curriculum, Go2 with the DR events), with
their agent presets (clean_rl; skrl's shared trunk; rl_games' per-minibatch
adaptive-KL rate). The file imports no JAX.
"""

import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils import _pytree as pytree

from _torch_steps import ENVS, minibatch
from cat_tpu_torch.ops import pgs
from cat_tpu_torch.rl.ppo import PPO
from cat_tpu_torch.sim import engine

torch.set_num_threads(1)

N = 8
REFUSED = ("_local_scalar_dense", "lift_fresh", "lift_fresh_copy", "nonzero",
           "masked_select")
PLAIN = ((engine, "dynamics_stage"), (engine, "contact_stage"),
         (engine, "post_stage"), (pgs, "pgs_bj_reference"),
         (pgs, "pgs_gs_reference"))


class Refused(TorchDispatchMode):
    """Records each refused op the watched code dispatches."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name.split("::")[-1]
        if name in REFUSED or name == "index" and any(
                i is not None and i.dtype in (torch.bool, torch.uint8)
                for i in args[1]):
            self.calls.append(name)
        return func(*args, **(kwargs or {}))


@pytest.fixture
def plain_unwatched(monkeypatch):
    """The kernels' plain versions run outside the mode."""
    for module, name in PLAIN:
        def unwatched(*a, _fn=getattr(module, name), **k):
            with _disable_current_modes():
                return _fn(*a, **k)
        monkeypatch.setattr(module, name, unwatched)


@pytest.fixture(scope="module", params=sorted(ENVS))
def setup(request):
    """(env, ppo, generator, env state after one step, obs) of a
    configuration, every step warmed up once."""
    make_env, make_cfg = ENVS[request.param]
    env = make_env(N, "cpu")
    gen = torch.Generator().manual_seed(0)
    ppo = PPO(env, dataclasses.replace(make_cfg(N), minibatch_size=N),
              torch.Generator().manual_seed(1))
    es = env.init(gen, N)
    obs = env.observe(es, gen)
    ppo.start(obs)
    es = env.step(es, ppo.draw(ppo.next_obs, gen)[3], gen)[0]
    mb, adv_mom = minibatch(env, N, gen)
    ppo.sgd_step(mb, adv_mom)
    return env, ppo, gen, es, (mb, adv_mom)


def _watched(call):
    with Refused() as mode:
        out = call()
    return mode.calls, out


def test_env_step_waits_on_nothing_and_copies_nothing(setup, plain_unwatched):
    env, ppo, gen, es, _ = setup
    action = torch.randn(N, env.num_actions, generator=gen)
    calls, out = _watched(lambda: env.step(es, action, gen))
    assert calls == []
    assert all(isinstance(t, torch.Tensor) and t.device == env.device
               for t in pytree.tree_leaves(out))


def test_env_state_holds_no_host_number(setup):
    """The step counter is a () int32 tensor, as the reference's, so a
    graph does not freeze the curriculum at its first value."""
    env, _, gen, es, _ = setup
    leaves = pytree.tree_leaves(es)
    assert all(isinstance(t, torch.Tensor) for t in leaves)
    assert es.common_step.shape == () and es.common_step.dtype == torch.int32
    fresh = env.init(torch.Generator().manual_seed(0), N)
    assert int(fresh.common_step) == 0 and int(es.common_step) >= 1


def test_draw_waits_on_nothing_and_copies_nothing(setup):
    _, ppo, gen, _, _ = setup
    calls, out = _watched(lambda: ppo.draw(ppo.next_obs, gen))
    assert calls == [] and len(out) == 5


def test_sgd_step_waits_on_nothing_and_copies_nothing(setup):
    _, ppo, _, _, (mb, adv_mom) = setup
    calls, stats = _watched(lambda: ppo.sgd_step(mb, adv_mom))
    assert calls == [] and stats.shape == (6,)
    assert bool(torch.isfinite(stats).all())


def test_the_watch_sees_what_a_capture_refuses():
    """The mode records each kind of op it watches for."""
    t = torch.arange(4.0)
    calls, _ = _watched(lambda: (t.sum().item(), torch.tensor([1.0]),
                                 t.nonzero(), t.masked_select(t > 1.0),
                                 t[t > 1.0]))
    assert calls == ["_local_scalar_dense", "lift_fresh", "nonzero",
                     "masked_select", "index"]
