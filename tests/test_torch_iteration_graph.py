"""The PPO iteration as the card replays it: two CUDA graphs, ``PPO.rollout``
and ``PPO.learn`` (cat_tpu_torch/rl/ppo.py), on the CPU.

  * A whole ``train_iteration``, once warmed up, neither waits on the
    device nor makes a tensor from host data nor sizes an output by the
    data (``tests/test_torch_capture.py``'s watch, ``Refused``), on the
    three configurations of ``tests/_torch_steps.py`` with their agent
    presets; and the bodies the graphs capture (``_rollout``, ``_learn``)
    read no host number that changes between iterations: run on two
    learners in one state whose host ``iteration`` differs, they give the
    same outputs and leave the same state, bit for bit.
  * The linear anneal reads the device counter ``device_iteration`` in
    the reference's float32 formula (cat_tpu/rl/ppo.py:242-243: frac =
    1 - it / N, lr = lr0 max(frac, 0)), held to ``jnp`` op by op bit for
    bit at iterations 0, 1, N/2, N - 1, N and N + 1. (XLA's compile of
    the reference's iteration on a CPU multiplies by float32(1 / N) in a
    fused multiply-add instead, one float32 spacing off the formula at
    some iterations.)
  * A rehearsal of ``utils/graphs.py`` ``run`` with a stand-in graph (the
    capture runs the body on static copies of the inputs; a replay copies
    the inputs in, runs the body on those copies again and copies its
    outputs into the captured ones, as a graph writes the same memory):
    the graphed iteration equals the one launched from the host bit for
    bit, every checkpoint leaf and metric, over three iterations (warm-up,
    capture, replay), and again across a ``checkpoint.save`` and a
    ``restore`` into the running learner, which re-keys ``learn`` (Adam's
    state is new) and keeps replaying ``rollout``.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import _torch_port  # noqa: F401  (one torch thread per test worker)
from _torch_steps import ENVS, stand_in_graphs
from test_torch_capture import Refused, plain_unwatched  # noqa: F401
from cat_tpu_torch.rl import checkpoint
from cat_tpu_torch.rl.ppo import PPO, PpoCfg

N = 8
STEPS = 4          # env steps an iteration
MINIBATCH = 16     # 2 minibatches an epoch


def _bits(t):
    return (t.view(torch.uint8) if t.dtype == torch.bool
            else t.view(torch.int32) if t.dtype.itemsize == 4 else t)


def _differ(a, b) -> list:
    """The paths of the leaves of two trees of tensors that differ in any
    bit."""
    fa, fb = (pytree.tree_flatten_with_path(x)[0] for x in (a, b))
    return [pytree.keystr(p) for (p, x), (_, y) in zip(fa, fb)
            if x.shape != y.shape or x.dtype != y.dtype
            or not torch.equal(_bits(x), _bits(y))] + (
        ["structure"] if len(fa) != len(fb) else [])


def _learner(name, env=None):
    """(env, ppo, generator, env state) of a configuration of
    ``_torch_steps.ENVS`` with its preset, cut to STEPS steps and
    MINIBATCH rows; the env is made unless given."""
    make_env, make_cfg = ENVS[name]
    env = env or make_env(N, "cpu")
    cfg = dataclasses.replace(make_cfg(N), num_steps=STEPS,
                              minibatch_size=MINIBATCH)
    gen = torch.Generator().manual_seed(0)
    es = env.init(gen, N)
    ppo = PPO(env, cfg, torch.Generator().manual_seed(1))
    ppo.start(env.observe(es, gen))
    return env, ppo, gen, es


def _state(ppo, es, gen) -> dict:
    return checkpoint.state_dict(ppo, es, {"ppo": gen})


# ---------------------------------------------------------------------------
# (a) nothing a capture refuses, no host number in the bodies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ENVS))
def test_iteration_waits_on_nothing_and_copies_nothing(name, plain_unwatched):
    """The second iteration (the first makes Adam's state) under the
    watch: no refused op, every metric a tensor on the env's device."""
    env, ppo, gen, es = _learner(name)
    es, _ = ppo.train_iteration(es, gen)
    with Refused() as mode:
        es, metrics = ppo.train_iteration(es, gen)
    assert mode.calls == []
    assert all(isinstance(v, torch.Tensor) and v.device == env.device
               for v in metrics.values())
    assert ppo.iteration == 2 and int(ppo.device_iteration) == 2


@pytest.mark.parametrize("name", sorted(ENVS))
def test_bodies_read_no_host_number(name):
    """Two learners in one state after an iteration, the second's host
    ``iteration`` moved by 7: the rollout body and then the learn body,
    each from the same inputs and generator state, give the same outputs
    and leave the same learner and generator state, bit for bit."""
    env, a, gen_a, es = _learner(name)
    _, b, gen_b, es_b = _learner(name, env)
    es, _ = a.train_iteration(es, gen_a)
    es_b, _ = b.train_iteration(es_b, gen_b)
    assert checkpoint.mismatches(_state(a, es, gen_a),
                                 _state(b, es_b, gen_b)) == []
    b.iteration += 7
    outs = []
    for ppo, gen in ((a, gen_a), (b, gen_b)):
        carry = ppo.next_obs, ppo.next_done, ppo.next_true_done
        r_es, r_carry, _, batch = out = ppo._rollout(
            es, carry, ppo.obs_rms, gen, ppo._draw_eager,
            ppo.env._step_eager)
        l_es, value_rms, _, metrics = ppo._learn(
            r_es, batch, r_carry[1], r_carry[2], ppo.value_rms, gen,
            ppo._sgd_step_eager)
        outs.append((out, l_es, value_rms, metrics))
    assert _differ(outs[0], outs[1]) == []
    sa, sb = _state(a, es, gen_a), _state(b, es, gen_b)
    assert checkpoint.mismatches(sa, sb) == ["ppo.iteration"]


# ---------------------------------------------------------------------------
# (b) the linear rate: the reference's float32 formula on the device counter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_iter", [2000, 2200])
@pytest.mark.parametrize("where", ["0", "1", "N/2", "N-1", "N", "N+1"])
def test_linear_rate_is_the_reference_formula(n_iter, where):
    it = {"0": 0, "1": 1, "N/2": n_iter // 2, "N-1": n_iter - 1,
          "N": n_iter, "N+1": n_iter + 1}[where]
    lr0 = 3.0e-4
    env = types.SimpleNamespace(num_obs=45, num_actions=12,
                                device=torch.device("cpu"))
    ppo = PPO(env, PpoCfg(learning_rate=lr0, num_iterations=n_iter),
              torch.Generator().manual_seed(0))
    ppo.iteration = it + 5          # the host's count is not read
    ppo.device_iteration.fill_(it)
    ppo.set_iteration_lr()
    # cat_tpu/rl/ppo.py:242-243, op by op
    frac = 1.0 - jnp.asarray(it, jnp.int32).astype(jnp.float32) / n_iter
    ref = np.asarray(lr0 * jnp.maximum(frac, 0.0))
    assert ref.dtype == np.float32 and ppo.lr.dtype == torch.float32
    assert ppo.lr.numpy().view(np.int32) == ref.view(np.int32), (
        float(ppo.lr), float(ref))


# ---------------------------------------------------------------------------
# (c) a rehearsal of the graphed iteration with a stand-in graph
# ---------------------------------------------------------------------------

@pytest.fixture
def stand_in(monkeypatch):
    return stand_in_graphs(monkeypatch)


def _graphed_iteration(ppo, es, gen):
    """``train_iteration``'s card path: the two replays."""
    es, batch = ppo.rollout(es, gen)
    return ppo.learn(es, batch, gen)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_graphed_iteration_equals_the_eager_one(name, stand_in):
    env, g, gen_g, es_g = _learner(name)
    _, e, gen_e, es_e = _learner(name, env)
    for it in range(3):
        es_g, mg = _graphed_iteration(g, es_g, gen_g)
        es_e, me = e._train_iteration_eager(es_e, gen_e)
        assert _differ(mg, me) == [], f"iteration {it + 1}"
        assert checkpoint.mismatches(_state(g, es_g, gen_g),
                                     _state(e, es_e, gen_e)) == []
    assert sorted(k[0] for k in g.graphs) == ["learn", "rollout"]
    assert len(stand_in) == 2 and env.graphs == {}


def test_graphed_iteration_across_a_restore(stand_in, tmp_path):
    """Flat (the linear rate): two iterations, a save, the checkpoint
    restored into the graphed learner and into the eager one, three more
    iterations; each equal bit for bit, the rate another at every
    iteration."""
    env, g, gen_g, es_g = _learner("flat")
    _, e, gen_e, es_e = _learner("flat", env)
    rates = []
    for it in range(5):
        if it == 2:
            path = checkpoint.save(str(tmp_path / "ckpt_2"), g, es_g,
                                   {"ppo": gen_g})
            es_g = checkpoint.restore(path, g, es_g, {"ppo": gen_g})
            es_e = checkpoint.restore(path, e, es_e, {"ppo": gen_e})
            assert int(g.device_iteration) == g.iteration == 2
        es_g, mg = _graphed_iteration(g, es_g, gen_g)
        es_e, me = e._train_iteration_eager(es_e, gen_e)
        assert _differ(mg, me) == [], f"iteration {it + 1}"
        assert checkpoint.mismatches(_state(g, es_g, gen_g),
                                     _state(e, es_e, gen_e)) == []
        rates.append(float(mg["Train/learning_rate"]))
    assert len(set(rates)) == len(rates)
    # the restore made Adam's state anew: a second learn graph, warmed up,
    # captured and replayed; the rollout's replayed throughout
    assert sorted(k[0] for k in g.graphs) == ["learn", "learn", "rollout"]
    assert [r for r in stand_in if r in g.graphs.values()] == stand_in
    assert len(stand_in) == 4
