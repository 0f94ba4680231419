"""The slice as a whole: one PPO training iteration of the port against the
JAX package's, from the same weights, on the same deterministic env.

The only random draws left are the policy's action noise and the
minibatch permutation. Both packages act with the policy mean here (the
Gaussian sample is replaced by its mean in both), and each epoch is one
minibatch of the whole batch, so its permutation only reorders a mean.
Everything else (env steps through contact, observation normalisation,
dual-done GAE, value normalisation, Adam with clipping) runs as shipped.

Tolerances: the rollout agrees to the env tests' bounds; the learner sums
in another order, so losses agree to rtol 1e-3 and parameters after two
Adam steps (each moving a weight by at most lr = 3e-4) to atol 2e-6.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_port import deterministic_cfgs, jax_env_lanes_bj, port_env
from cat_tpu.rl import networks as jn
from cat_tpu.rl.ppo import PPO as JPPO
from cat_tpu.rl.ppo import PpoCfg as JCfg
from cat_tpu_torch.rl import networks as tn
from cat_tpu_torch.rl.convert import params_from_jax
from cat_tpu_torch.rl.ppo import PPO, PpoCfg

N, STEPS = 8, 2
PPO_KW = dict(num_steps=STEPS, num_iterations=4, updates_epochs=2,
              minibatch_size=N * STEPS)


@pytest.fixture(scope="module")
def iteration():
    mp = pytest.MonkeyPatch()
    mp.setattr(jn, "sample_action",
               lambda mean, log_std, key: (mean, jn.gaussian_logp(mean, log_std, mean)))
    mp.setattr(tn, "sample_action",
               lambda mean, log_std, gen: (mean, tn.gaussian_logp(mean, log_std, mean)))
    try:
        jc, tc = deterministic_cfgs(N)
        je, te = jax_env_lanes_bj(jc), port_env(tc)
        jppo = JPPO(je, JCfg(**PPO_KW))
        js = jax.jit(je.init, static_argnums=1)(jax.random.PRNGKey(0), N)
        jts = jppo.init(jax.random.PRNGKey(1), js, jax.jit(je.observe)(js))
        tppo = PPO(te, PpoCfg(**PPO_KW), torch.Generator().manual_seed(0))
        params0 = jax.tree.map(np.asarray, jts.params)
        tppo.net.load_state_dict(params_from_jax(params0))
        gen = torch.Generator().manual_seed(1)
        ts = te.init(gen, N)
        tppo.start(te.observe(ts, gen))
        jts, js, jm = jax.jit(jppo.train_iteration)(jts, js)
        ts, tm = tppo.train_iteration(ts, gen)
    finally:
        mp.undo()
    return dict(jax=(jts, js, jax.device_get(jm)), port=(tppo, ts, tm),
                params0=params0)


@pytest.mark.parametrize("key,tol", [
    ("Train/mean_reward_per_step", dict(rtol=1e-4, atol=1e-7)),
    ("Train/mean_done", dict(rtol=1e-4, atol=1e-7)),
    ("Loss/mean_surrogate_loss", dict(rtol=1e-3, atol=1e-5)),
    ("Loss/mean_pg_loss", dict(rtol=1e-3, atol=1e-5)),
    ("Loss/mean_v_loss", dict(rtol=1e-3, atol=1e-5)),
    ("Loss/mean_entropy_loss", dict(rtol=1e-6)),
    ("Loss/approx_kl", dict(atol=1e-6)),
    ("Loss/clipfrac", dict(atol=1e-6)),
    ("Train/learning_rate", dict(rtol=1e-6)),
])
def test_iteration_metrics_match(iteration, key, tol):
    np.testing.assert_allclose(float(iteration["port"][2][key]),
                               float(iteration["jax"][2][key]), **tol)


def test_iteration_params_match(iteration):
    jts = iteration["jax"][0]
    tppo = iteration["port"][0]
    ref = params_from_jax(jax.tree.map(np.asarray, jts.params))
    start = params_from_jax(iteration["params0"])
    moved = 0.0
    for name, p in tppo.net.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), atol=2e-6,
                                   err_msg=name)
        moved = max(moved, float((p - start[name]).abs().max()))
    assert moved > 1e-4  # the step really moved the weights


def test_rollout_carry_and_normalisers_match(iteration):
    jts, js, _ = iteration["jax"]
    tppo, ts, _ = iteration["port"]
    np.testing.assert_allclose(tppo.next_obs.numpy(), np.asarray(jts.next_obs),
                               atol=1e-4)
    np.testing.assert_allclose(tppo.next_done.numpy(), np.asarray(jts.next_done),
                               atol=1e-5)
    for a, b in zip(tppo.obs_rms, jts.obs_rms):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)
    for a, b in zip(tppo.value_rms, jts.value_rms):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ts.sim.qpos.numpy(), np.asarray(js.sim.qpos),
                               atol=1e-4)
