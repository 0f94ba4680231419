"""The rough slice as a whole: one PPO training iteration of
Solo12-CaT-Rough's env in the port against the JAX package's, from the
same 232-input weights, on the same deterministic rough env (height scan,
terrain curriculum, block-Jacobi solve on a small heightfield).

As tests/test_torch_slice.py: both act with the policy mean and take one
minibatch an epoch, so no random draw is left. Tolerances are that file's:
the rollout agrees to the env tests' bounds, losses to rtol 1e-3,
parameters after two Adam steps to atol 2e-6.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_port import jax_env_lanes_bj, rough_cfgs
from cat_tpu.rl import networks as jn
from cat_tpu.rl.ppo import PPO as JPPO
from cat_tpu.rl.ppo import PpoCfg as JCfg
from cat_tpu.tasks.solo12_rough import rough_constraint_terms as jax_rough_terms
from cat_tpu_torch.rl import networks as tn
from cat_tpu_torch.rl.convert import params_from_jax
from cat_tpu_torch.rl.ppo import PPO, PpoCfg
from cat_tpu_torch.tasks import solo12_rough

N_PPO, PPO_STEPS = 8, 2
PPO_KW = dict(num_steps=PPO_STEPS, num_iterations=4, updates_epochs=2,
              minibatch_size=N_PPO * PPO_STEPS)


@pytest.fixture(scope="module")
def rough_iteration():
    """As tests/test_torch_slice.py: both act with the policy mean and
    take one minibatch an epoch, from the same 232-input weights."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jn, "sample_action",
               lambda mean, log_std, key: (mean, jn.gaussian_logp(mean, log_std, mean)))
    mp.setattr(tn, "sample_action",
               lambda mean, log_std, gen: (mean, tn.gaussian_logp(mean, log_std, mean)))
    try:
        jc, tc_ = rough_cfgs(N_PPO, noise=False)
        je = jax_env_lanes_bj(jc, jax_rough_terms)
        te = solo12_rough.make_env(N_PPO, cfg=tc_, device="cpu")
        jppo = JPPO(je, JCfg(**PPO_KW))
        js = jax.jit(je.init, static_argnums=1)(jax.random.PRNGKey(0), N_PPO)
        jts = jppo.init(jax.random.PRNGKey(1), js, jax.jit(je.observe)(js))
        tppo = PPO(te, PpoCfg(**PPO_KW), torch.Generator().manual_seed(0))
        tppo.net.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                              jts.params)))
        gen = torch.Generator().manual_seed(1)
        ts = te.init(gen, N_PPO)
        tppo.start(te.observe(ts, gen))
        jts, js, jm = jax.jit(jppo.train_iteration)(jts, js)
        ts, tm = tppo.train_iteration(ts, gen)
    finally:
        mp.undo()
    return dict(jax=(jts, js, jax.device_get(jm)), port=(tppo, ts, tm))


@pytest.mark.parametrize("key,tol", [
    ("Train/mean_reward_per_step", dict(rtol=1e-4, atol=1e-7)),
    ("Loss/mean_surrogate_loss", dict(rtol=1e-3, atol=1e-5)),
    ("Loss/mean_v_loss", dict(rtol=1e-3, atol=1e-5)),
    ("Loss/approx_kl", dict(atol=1e-6)),
    ("Curriculum/terrain_levels", dict(atol=0)),
])
def test_rough_iteration_matches(rough_iteration, key, tol):
    np.testing.assert_allclose(float(rough_iteration["port"][2][key]),
                               float(rough_iteration["jax"][2][key]), **tol)


def test_rough_iteration_params_match(rough_iteration):
    jts = rough_iteration["jax"][0]
    tppo = rough_iteration["port"][0]
    assert tppo.net.actor.layers[0].weight.shape[1] == 232
    ref = params_from_jax(jax.tree.map(np.asarray, jts.params))
    for name, p in tppo.net.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), atol=2e-6,
                                   err_msg=name)
    np.testing.assert_allclose(tppo.next_obs.numpy(), np.asarray(jts.next_obs),
                               atol=1e-4)
