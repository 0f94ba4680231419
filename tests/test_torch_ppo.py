"""The port's learner pieces against the JAX package's: dual-done GAE,
Welford normalisers, the actor-critic with weights carried across, and
one SGD minibatch step from the same parameters and the same batch.

Tolerances: GAE and Welford are short float32 recurrences (rtol 1e-5);
the networks are float32 matmuls of width 512 summed in other orders
(atol 1e-5 on outputs of order 1); one Adam step moves each parameter by
at most lr = 3e-4, so parameters after the step agree to atol 1e-6.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from cat_tpu.rl import networks as jn
from cat_tpu.rl.normalize import RmsState as JRms
from cat_tpu.rl.normalize import rms_init as jrms_init
from cat_tpu.rl.normalize import rms_normalize as jrms_normalize
from cat_tpu.rl.normalize import rms_update as jrms_update
from cat_tpu.rl.ppo import PPO as JPPO
from cat_tpu.rl.ppo import PpoCfg as JCfg
from cat_tpu_torch.rl import networks as tn
from cat_tpu_torch.rl.convert import actor_from_bundle, params_from_jax
from cat_tpu_torch.rl.normalize import RmsState, rms_init, rms_update
from cat_tpu_torch.rl.ppo import PPO, PpoCfg, gae

BUNDLE = "runs/solo12_flat_2000it/policy_params.npz"


def _numpy_gae(rewards, values, dones, tdones, next_value, next_done,
               next_tdone, gamma, lam):
    """The reference recurrence (cleanrl/ppo.py:250-277), as
    tests/test_ppo.py::test_gae_dual_done_reference_impl writes it."""
    T = rewards.shape[0]
    adv = np.zeros_like(rewards)
    lastgaelam = 0
    for t in reversed(range(T)):
        if t == T - 1:
            nnt = (1.0 - next_done) * (1.0 - next_tdone)
            nv = next_value
        else:
            nnt = (1.0 - dones[t + 1]) * (1.0 - tdones[t + 1])
            nv = values[t + 1]
        delta = rewards[t] + gamma * nv * nnt - values[t]
        adv[t] = lastgaelam = delta + gamma * lam * nnt * lastgaelam
    return adv


@pytest.mark.parametrize("T,N", [(6, 3), (24, 8)])
def test_gae_dual_done_reference_impl(T, N):
    rng = np.random.default_rng(T)
    f = np.float32
    args = (rng.normal(size=(T, N)).astype(f), rng.normal(size=(T, N)).astype(f),
            rng.uniform(0, 1, size=(T, N)).astype(f),
            (rng.uniform(size=(T, N)) < 0.2).astype(f),
            rng.normal(size=N).astype(f), rng.uniform(0, 1, size=N).astype(f),
            (rng.uniform(size=N) < 0.2).astype(f))
    ref = _numpy_gae(*args, 0.99, 0.95)
    out = gae(*map(torch.from_numpy, args), 0.99, 0.95)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_rms_welford_matches_jax_and_numpy():
    rng = np.random.default_rng(0)
    xs = [(rng.normal(size=(32, 5)) * 3 + 1).astype(np.float32) for _ in range(4)]
    js, ts = jrms_init((5,)), rms_init((5,))
    for x in xs:
        js = jrms_update(js, jnp.asarray(x))
        ts = rms_update(ts, torch.from_numpy(x))
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    allx = np.concatenate(xs)
    np.testing.assert_allclose(ts.mean.numpy(), allx.mean(0), atol=0.1)
    np.testing.assert_allclose(ts.var.numpy(), allx.var(0), rtol=0.15)


@pytest.fixture(scope="module")
def nets():
    """A JAX ActorCritic with random weights and the port's copy of it."""
    jnet = jn.ActorCritic(12)
    params = jnet.init(jax.random.PRNGKey(3), jnp.zeros((1, 45)))
    params = jax.tree.map(lambda x: x + 0.0, params)
    params["params"]["log_std"] = jnp.full((12,), -0.3)
    tnet = tn.ActorCritic(45, 12)
    tnet.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jnet, params, tnet


def test_networks_match_with_carried_params(nets):
    jnet, params, tnet = nets
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(64, 45)).astype(np.float32)
    act = rng.normal(size=(64, 12)).astype(np.float32)
    jm, jls, jv = jnet.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        tm, tls, tv = tnet(torch.from_numpy(obs))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(tls.detach().numpy(), np.asarray(jls))
    np.testing.assert_allclose(
        tn.gaussian_logp(tm, tls, torch.from_numpy(act)).detach().numpy(),
        np.asarray(jn.gaussian_logp(jm, jls, jnp.asarray(act))), atol=1e-4)
    np.testing.assert_allclose(
        tn.gaussian_entropy(tls, tm).detach().numpy(),
        np.asarray(jn.gaussian_entropy(jls, jm)), rtol=1e-6)


def test_init_is_orthogonal_with_the_reference_gains():
    net = tn.ActorCritic(45, 12, generator=torch.Generator().manual_seed(0))
    for mlp, head_gain in ((net.actor, 0.01), (net.critic, 1.0)):
        for i, layer in enumerate(mlp.layers):
            w = layer.weight.detach().double()
            gain = head_gain if i == len(mlp.layers) - 1 else np.sqrt(2.0)
            small = min(w.shape)
            gram = w @ w.T if w.shape[0] == small else w.T @ w
            torch.testing.assert_close(gram, gain ** 2 * torch.eye(small,
                                       dtype=torch.float64), atol=1e-5, rtol=0)
            assert not layer.bias.detach().any()
    assert not net.log_std.detach().any()


def test_exported_bundle_loads_into_the_actor():
    """runs/solo12_flat_2000it/policy_params.npz through actor_from_bundle
    gives the bundle's own numpy actor (tests/test_export.py)."""
    bundle = dict(np.load(BUNDLE))
    sd, mean, var = actor_from_bundle(bundle)
    net = tn.ActorCritic(45, 12)
    res = net.load_state_dict(sd, strict=False)
    assert not res.unexpected_keys
    assert all(k.startswith("critic.") for k in res.missing_keys)
    obs = np.random.default_rng(2).normal(size=(32, 45)).astype(np.float32)
    x = (obs - bundle["obs_mean"]) / np.sqrt(bundle["obs_var"] + 1e-8)
    for i in range(4):
        x = x @ bundle[f"actor_w{i}"] + bundle[f"actor_b{i}"]
        if i < 3:
            x = np.where(x > 0, x, np.expm1(np.minimum(x, 0.0)))
    with torch.no_grad():
        out = net.actor((torch.from_numpy(obs) - mean) / torch.sqrt(var + 1e-8))
    np.testing.assert_allclose(out.numpy(), x, atol=1e-5)


def _jax_sgd_step(jppo, params, opt_state, value_rms, mb, adv_mom, lr):
    """One minibatch step of cat_tpu/rl/ppo.py (its loss_fn, :393-428, and
    its optax chain), for the clean_rl preset."""
    cfg = jppo.cfg

    def loss_fn(params):
        obs, act, old_logp, adv, ret, old_val = mb
        mean, log_std, newvalue = jppo.net.apply(params, obs)
        newlogp = jn.gaussian_logp(mean, log_std, act)
        entropy = jn.gaussian_entropy(log_std, act)
        logratio = newlogp - old_logp
        ratio = jnp.exp(logratio)
        m = adv_mom[0]
        s = jnp.sqrt(jnp.maximum(adv_mom[1] - jnp.square(m), 0.0))
        adv = (adv - m) / (s + 1e-8)
        pg_loss = jnp.mean(jnp.maximum(
            -adv * ratio,
            -adv * jnp.clip(ratio, 1 - cfg.clip_coef, 1 + cfg.clip_coef)))
        newvalue_n = jrms_normalize(value_rms, newvalue)
        v_clipped = old_val + jnp.clip(newvalue_n - old_val, -cfg.clip_coef,
                                       cfg.clip_coef)
        v_loss = 0.5 * jnp.mean(jnp.maximum(jnp.square(newvalue_n - ret),
                                            jnp.square(v_clipped - ret)))
        ent_loss = jnp.mean(entropy)
        total = pg_loss - cfg.ent_coef * ent_loss + v_loss * cfg.vf_coef
        approx_kl = jnp.mean((ratio - 1.0) - logratio)
        clipfrac = jnp.mean((jnp.abs(ratio - 1.0) > cfg.clip_coef)
                            .astype(jnp.float32))
        return total, (pg_loss, v_loss, ent_loss, approx_kl, clipfrac)

    (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    updates, opt_state = jppo.tx.update(grads, opt_state, params)
    params = optax.apply_updates(
        params, jax.tree.map(lambda u: -lr * u, updates))
    return params, opt_state, jnp.stack((loss,) + aux)


def test_sgd_minibatch_step_matches(nets):
    """Two consecutive minibatch steps (the second sees Adam's moments)."""
    jnet, params, _ = nets
    env = types.SimpleNamespace(num_actions=12, num_obs=45,
                                device=torch.device("cpu"))
    jppo = JPPO(env, JCfg())
    tppo = PPO(env, PpoCfg(), torch.Generator().manual_seed(0))
    tppo.net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    rng = np.random.default_rng(4)
    n = 256
    value_rms = (np.float32(0.3), np.float32(2.0), np.float32(500.0))
    jrms = JRms(*map(jnp.asarray, value_rms))
    tppo.value_rms = RmsState(*map(torch.tensor, value_rms))
    opt_state = jppo.tx.init(params)
    lr = 3e-4
    for k in range(2):
        mb = [rng.normal(size=(n, 45)), rng.normal(size=(n, 12)),
              rng.normal(-12.0, 1.0, size=n), rng.normal(size=n),
              rng.normal(size=n), rng.normal(size=n)]
        mb = [np.asarray(x, np.float32) for x in mb]
        # old log-probs near the current policy's, so ratios stay near 1
        with torch.no_grad():
            mean, log_std, _ = tppo.net(torch.from_numpy(mb[0]))
            mb[2] = (tn.gaussian_logp(mean, log_std, torch.from_numpy(mb[1]))
                     .numpy() + rng.normal(0, 0.1, n).astype(np.float32))
        adv_mom = np.array([mb[3].mean(), np.square(mb[3]).mean()], np.float32)
        params, opt_state, jstats = _jax_sgd_step(
            jppo, params, opt_state, jrms, [jnp.asarray(x) for x in mb],
            jnp.asarray(adv_mom), lr)
        tstats = tppo.sgd_step([torch.from_numpy(x) for x in mb],
                               torch.from_numpy(adv_mom), lr)
        np.testing.assert_allclose(tstats.numpy(), np.asarray(jstats),
                                   rtol=1e-4, atol=1e-6)
    ported = params_from_jax(jax.tree.map(np.asarray, params))
    for name, p in tppo.net.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ported[name].numpy(), atol=1e-6,
                                   err_msg=name)
