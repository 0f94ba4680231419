"""The rl_games and skrl recipes in the port against the JAX package's: the
presets field for field, the adaptive-KL learning-rate rule, its cadence
(every minibatch for rl_games, every epoch for skrl), the shared-trunk
network's SGD step, and one training iteration of each backend variant
(the counterparts of tests/test_ppo.py::test_backend_agent_cfgs,
::test_adaptive_kl_lr_pinned_trajectory,
::test_skrl_epoch_lr_vs_rl_games_minibatch_lr and
::test_train_iteration_backend_variants).

Tolerances: the learning-rate rule is float32 arithmetic of one operation
a step (rtol 1e-6); after an iteration of 2 x 1.5-fold steps, rtol 1e-5.
The SGD step and the iteration are tests/test_torch_ppo.py's and
tests/test_torch_slice.py's: loss statistics rtol 1e-4 (atol 1e-6), losses
after a rollout rtol 1e-3 (atol 1e-5). Parameters: Adam moves a weight by
about the learning rate whatever the size of its gradient, so where a
gradient is near zero the two packages' rounding can move it differently
by a share of the rate. After two steps the parameters agree to 1% of the
sum of the two steps' largest rates (at rl_games' and clean_rl's 3e-4 that
is 6e-6; the skrl recipe's 1e-3, grown to 1.5e-3 after the first epoch,
gives 3e-5); the SGD step of the shared model at 3e-4 to
tests/test_torch_ppo.py's 2e-6.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import deterministic_cfgs, jax_env_lanes_bj, port_env
from cat_tpu.rl import agent_cfgs as jagents
from cat_tpu.rl import networks as jn
from cat_tpu.rl.normalize import RmsState as JRms
from cat_tpu.rl.ppo import PPO as JPPO
from cat_tpu.rl.ppo import PpoCfg as JCfg
from cat_tpu.rl.ppo import adaptive_kl_lr as jax_adaptive_kl_lr
from cat_tpu_torch.rl import agent_cfgs
from cat_tpu_torch.rl import networks as tn
from cat_tpu_torch.rl.convert import params_from_jax
from cat_tpu_torch.rl.normalize import RmsState
from cat_tpu_torch.rl.ppo import PPO, PpoCfg, adaptive_kl_lr
from test_torch_ppo import _jax_sgd_step


@pytest.mark.parametrize("backend,kw", [
    ("clean_rl", {}), ("rl_games", {}), ("skrl", {"num_envs": 4096}),
    ("skrl", {"num_envs": 8}),
])
def test_presets_match_jax_field_for_field(backend, kw):
    port, ref = agent_cfgs.get(backend, **kw), jagents.get(backend, **kw)
    ref_fields = dataclasses.asdict(ref)
    # the port always normalises advantages and clips the value loss: the
    # reference's switches for them are on in every preset
    assert ref_fields.pop("norm_adv") and ref_fields.pop("clip_vloss")
    assert dataclasses.asdict(port) == ref_fields
    assert port.resolved_lr_mode == ref.resolved_lr_mode


def test_backend_agent_cfgs():
    rg = agent_cfgs.get("rl_games")
    assert rg.resolved_lr_mode == "adaptive_kl"
    assert rg.kl_target == 0.008 and rg.value_bootstrap and not rg.shared_model
    sk = agent_cfgs.get("skrl", num_envs=4096)
    assert sk.shared_model and sk.kl_target == 0.01
    assert sk.resolved_lr_mode == "adaptive_kl_epoch"
    assert sk.minibatch_size == 4096 * 24 // 4
    assert sk.learning_rate == 1e-3 and sk.ent_coef == 0.005
    cl = agent_cfgs.get("clean_rl")
    assert cl.resolved_lr_mode == "linear" and cl.minibatch_size == 16384
    with pytest.raises(KeyError, match="unknown RL backend"):
        agent_cfgs.get("sb3")


def test_adaptive_kl_lr_pinned_trajectory():
    """rl_games' AdaptiveScheduler (kl_threshold 0.008, min 1e-6, max 1e-2,
    factor 1.5) on a hand-computed sequence, and the JAX rule step by step."""
    tgt, lo, hi = 0.008, 1e-6, 1e-2
    kls = [0.02, 0.02, 0.001, 0.005, 0.03, 0.0001]
    expect = [3e-4 / 1.5, 3e-4 / 1.5 / 1.5, 3e-4 / 1.5, 3e-4 / 1.5,
              3e-4 / 1.5 / 1.5, 3e-4 / 1.5]
    lr, jlr = torch.tensor(3e-4), jnp.float32(3e-4)
    for kl, want in zip(kls, expect):
        lr = adaptive_kl_lr(lr, torch.tensor(kl), tgt, lo, hi)
        jlr = jax_adaptive_kl_lr(jlr, jnp.float32(kl), tgt, lo, hi)
        assert lr.dtype == torch.float32
        np.testing.assert_allclose(float(lr), want, rtol=1e-6)
        np.testing.assert_allclose(float(lr), float(jlr), rtol=1e-6)
    assert float(adaptive_kl_lr(torch.tensor(8e-3), torch.tensor(1e-4),
                                tgt, lo, hi)) == np.float32(hi)
    assert float(adaptive_kl_lr(torch.tensor(1.2e-6), torch.tensor(0.5),
                                tgt, lo, hi)) == np.float32(lo)


def test_skrl_epoch_lr_vs_rl_games_minibatch_lr():
    """With kl_target huge every step is a 1.5-fold growth: after one
    iteration of 2 epochs x 2 minibatches the rate is lr0 1.5^2 under the
    per-epoch rule and lr0 1.5^4 under the per-minibatch rule."""
    n = 8
    base = PpoCfg(num_steps=2, num_iterations=4, updates_epochs=2,
                  minibatch_size=8, kl_target=1e3, lr_max=1e6)
    lrs = {}
    for mode in ("adaptive_kl", "adaptive_kl_epoch"):
        env = port_env(deterministic_cfgs(n)[1])
        gen = torch.Generator().manual_seed(0)
        es = env.init(gen, n)
        ppo = PPO(env, dataclasses.replace(base, lr_mode=mode),
                  torch.Generator().manual_seed(1))
        ppo.start(env.observe(es, gen))
        _, metrics = ppo.train_iteration(es, gen)
        lrs[mode] = float(ppo.lr)
        assert float(metrics["Train/learning_rate"]) == lrs[mode]
    lr0 = base.learning_rate
    np.testing.assert_allclose(lrs["adaptive_kl"], lr0 * 1.5 ** 4, rtol=1e-5)
    np.testing.assert_allclose(lrs["adaptive_kl_epoch"], lr0 * 1.5 ** 2,
                               rtol=1e-5)


def test_shared_model_init_gains():
    net = tn.SharedActorCritic(45, 12, generator=torch.Generator().manual_seed(0))
    layers = [*net.trunk, net.policy_head, net.value_head]
    gains = [np.sqrt(2.0)] * 3 + [0.01, 1.0]
    for layer, gain in zip(layers, gains):
        w = layer.weight.detach().double()
        small = min(w.shape)
        gram = w @ w.T if w.shape[0] == small else w.T @ w
        torch.testing.assert_close(gram, gain ** 2 * torch.eye(
            small, dtype=torch.float64), atol=1e-5, rtol=0)
        assert not layer.bias.detach().any()
    assert not net.log_std.detach().any()


def test_shared_model_sgd_steps_match_jax():
    """Two minibatch steps of the shared trunk under rl_games' per-minibatch
    rate rule, from carried weights: statistics, parameters, the rate."""
    cfg_kw = dict(shared_model=True, lr_mode="adaptive_kl", kl_target=0.008)
    env = types.SimpleNamespace(num_actions=12, num_obs=45,
                                device=torch.device("cpu"))
    jppo = JPPO(env, JCfg(**cfg_kw))
    params = jppo.net.init(jax.random.PRNGKey(3), jnp.zeros((1, 45)))
    params = jax.tree.map(lambda x: x + 0.0, params)
    params["params"]["log_std"] = jnp.full((12,), -0.3)
    tppo = PPO(env, PpoCfg(**cfg_kw), torch.Generator().manual_seed(0))
    assert isinstance(tppo.net, tn.SharedActorCritic)
    tppo.net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    value_rms = (np.float32(0.3), np.float32(2.0), np.float32(500.0))
    jrms = JRms(*map(jnp.asarray, value_rms))
    tppo.value_rms = RmsState(*map(torch.tensor, value_rms))
    opt_state = jppo.tx.init(params)
    lr = jnp.float32(3e-4)
    rng = np.random.default_rng(4)
    n = 256
    for _ in range(2):
        mb = [rng.normal(size=(n, 45)), rng.normal(size=(n, 12)), np.zeros(n),
              rng.normal(size=n), rng.normal(size=n), rng.normal(size=n)]
        mb = [np.asarray(x, np.float32) for x in mb]
        with torch.no_grad():
            mean, log_std, _ = tppo.net(torch.from_numpy(mb[0]))
            mb[2] = (tn.gaussian_logp(mean, log_std, torch.from_numpy(mb[1]))
                     .numpy() + rng.normal(0, 0.1, n).astype(np.float32))
        adv_mom = np.array([mb[3].mean(), np.square(mb[3]).mean()], np.float32)
        params, opt_state, jstats = _jax_sgd_step(
            jppo, params, opt_state, jrms, [jnp.asarray(x) for x in mb],
            jnp.asarray(adv_mom), lr)
        lr = jax_adaptive_kl_lr(lr, jstats[4], 0.008, 1e-6, 1e-2)
        tstats = tppo.sgd_step([torch.from_numpy(x) for x in mb],
                               torch.from_numpy(adv_mom))
        np.testing.assert_allclose(tstats.numpy(), np.asarray(jstats),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(float(tppo.lr), float(lr), rtol=1e-6)
    ported = params_from_jax(jax.tree.map(np.asarray, params))
    for name, p in tppo.net.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ported[name].numpy(), atol=2e-6,
                                   err_msg=name)


N, STEPS = 8, 2
# every env times out at its second step (episode_length_s 2 x 0.02 s), so
# the timeout bootstrap changes the rewards of the rollout's last step
VARIANTS = {
    "rl_games": dict(lr_mode="adaptive_kl", kl_target=0.008,
                     value_bootstrap=True),
    "skrl": dict(shared_model=True, lr_mode="adaptive_kl_epoch",
                 kl_target=0.01, learning_rate=1e-3, ent_coef=0.005,
                 vf_coef=1.0),
}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant_iteration(request):
    """One iteration of the variant in both packages from the same weights,
    acting with the policy mean, one minibatch an epoch (as
    tests/test_torch_slice.py), on the deterministic env."""
    kw = dict(VARIANTS[request.param], num_steps=STEPS, num_iterations=4,
              updates_epochs=2, minibatch_size=N * STEPS)
    mp = pytest.MonkeyPatch()
    mp.setattr(jn, "sample_action", lambda mean, log_std, key: (
        mean, jn.gaussian_logp(mean, log_std, mean)))
    mp.setattr(tn, "sample_action", lambda mean, log_std, gen: (
        mean, tn.gaussian_logp(mean, log_std, mean)))
    try:
        jc, tc = (dataclasses.replace(c, episode_length_s=0.04)
                  for c in deterministic_cfgs(N))
        je, te = jax_env_lanes_bj(jc), port_env(tc)
        jppo = JPPO(je, JCfg(**kw))
        js = jax.jit(je.init, static_argnums=1)(jax.random.PRNGKey(0), N)
        jts = jppo.init(jax.random.PRNGKey(1), js, jax.jit(je.observe)(js))
        tppo = PPO(te, PpoCfg(**kw), torch.Generator().manual_seed(0))
        tppo.net.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                              jts.params)))
        gen = torch.Generator().manual_seed(1)
        ts = te.init(gen, N)
        tppo.start(te.observe(ts, gen))
        jts, js, jm = jax.jit(jppo.train_iteration)(jts, js)
        ts, tm = tppo.train_iteration(ts, gen)
    finally:
        mp.undo()
    return jts, jax.device_get(jm), tppo, tm


@pytest.mark.parametrize("key,tol", [
    ("Train/mean_reward_per_step", dict(rtol=1e-4, atol=1e-7)),
    ("Loss/mean_surrogate_loss", dict(rtol=1e-3, atol=1e-5)),
    ("Loss/mean_v_loss", dict(rtol=1e-3, atol=1e-5)),
    ("Loss/approx_kl", dict(atol=1e-6)),
    ("Train/learning_rate", dict(rtol=1e-5)),
])
def test_variant_iteration_matches_jax(variant_iteration, key, tol):
    _, jm, _, tm = variant_iteration
    np.testing.assert_allclose(float(tm[key]), float(jm[key]), **tol)


def test_variant_iteration_params_match_jax(variant_iteration):
    jts, _, tppo, _ = variant_iteration
    cfg = tppo.cfg
    assert cfg.lr_min <= float(tppo.lr) <= cfg.lr_max
    np.testing.assert_allclose(float(tppo.lr), float(jts.lr), rtol=1e-5)
    atol = 0.01 * 2 * max(cfg.learning_rate, float(jts.lr))
    ref = params_from_jax(jax.tree.map(np.asarray, jts.params))
    for name, p in tppo.net.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), atol=atol,
                                   err_msg=name)
