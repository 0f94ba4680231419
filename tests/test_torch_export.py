"""Policy export of the port against the JAX package's (the counterparts of
tests/test_export.py): for the same weights (carried from the JAX learner's
parameters) and the same observation normaliser, the port's
``policy_params.npz`` holds the same arrays as the JAX ``export_policy``
bundle, bit for bit, for the separate and the shared network; a bundle
written by either package loads into the port's actor; the TorchScript and
``torch.export`` artifacts reproduce the actor's mean action.

Tolerances: the bundle is a copy (exact); the artifacts run the same
float32 layers as the actor (atol 1e-6) and as the bundle's numpy actor,
which sums in another order (rtol 1e-4, atol 1e-5, tests/test_export.py's).
"""

import os
import warnings

import jax
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)
from cat_tpu.rl.export import export_policy as jax_export_policy
from cat_tpu.rl.ppo import PPO as JPPO
from cat_tpu.rl.ppo import PpoCfg as JCfg
from cat_tpu.tasks.solo12_flat import make_env as jax_make_env
from cat_tpu_torch.rl import networks as tn
from cat_tpu_torch.rl.convert import actor_from_bundle, params_from_jax
from cat_tpu_torch.rl.export import Policy, export_policy


def _numpy_actor(bundle, obs):
    x = (obs - bundle["obs_mean"]) / np.sqrt(bundle["obs_var"] + 1e-8)
    i = 0
    while f"actor_w{i}" in bundle:
        x = x @ bundle[f"actor_w{i}"] + bundle[f"actor_b{i}"]
        if f"actor_w{i + 1}" in bundle:
            x = np.where(x > 0, x, np.expm1(np.minimum(x, 0.0)))
        i += 1
    return x


@pytest.fixture(scope="module", params=[False, True], ids=["separate", "shared"])
def exported(request, tmp_path_factory):
    """The JAX learner's initial state exported by the JAX package, and the
    same weights and normaliser exported by the port."""
    shared = request.param
    env = jax_make_env(num_envs=4)
    ppo = JPPO(env, JCfg(num_steps=4, num_iterations=1, minibatch_size=8,
                         shared_model=shared))
    es = env.init(jax.random.PRNGKey(0), 4)
    obs = jax.jit(env.observe)(es)
    ts = ppo.init(jax.random.PRNGKey(1), es, obs)
    jdir = str(tmp_path_factory.mktemp("jax"))
    jax_export_policy(ppo, ts, jdir)
    net_cls = tn.SharedActorCritic if shared else tn.ActorCritic
    net = net_cls(45, 12)
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, ts.params)))
    tdir = str(tmp_path_factory.mktemp("port"))
    bundle = export_policy(net, torch.tensor(np.asarray(ts.obs_rms.mean)),
                           torch.tensor(np.asarray(ts.obs_rms.var)), tdir)
    return dict(shared=shared, net=net, bundle=bundle, port_dir=tdir,
                jax=dict(np.load(os.path.join(jdir, "policy_params.npz"))),
                obs=np.random.default_rng(0).normal(size=(32, 45)).astype(
                    np.float32) * 2.0)


def test_bundle_equals_the_jax_bundle(exported):
    port = dict(np.load(os.path.join(exported["port_dir"],
                                     "policy_params.npz")))
    assert sorted(port) == sorted(exported["jax"])
    for k, v in exported["jax"].items():
        assert port[k].dtype == v.dtype == np.float32, k
        np.testing.assert_array_equal(port[k], v, err_msg=k)
    assert all(np.array_equal(port[k], exported["bundle"][k]) for k in port)


def _actor(exported, obs):
    b = exported["bundle"]
    x = (torch.from_numpy(obs) - torch.tensor(b["obs_mean"])) / torch.sqrt(
        torch.tensor(b["obs_var"]) + 1e-8)
    with torch.no_grad():
        return exported["net"](x)[0].numpy()


def test_jax_bundle_loads_into_the_port_actor(exported):
    sd, mean, var = actor_from_bundle(exported["jax"],
                                      shared=exported["shared"])
    net = type(exported["net"])(45, 12)
    res = net.load_state_dict(sd, strict=False)
    assert not res.unexpected_keys
    assert all(k.startswith(("critic.", "value_head.")) for k in res.missing_keys)
    obs = exported["obs"]
    with torch.no_grad():
        out = net(((torch.from_numpy(obs) - mean) / torch.sqrt(var + 1e-8)))[0]
    np.testing.assert_allclose(out.numpy(), _actor(exported, obs), atol=1e-6)
    np.testing.assert_allclose(out.numpy(), _numpy_actor(exported["jax"], obs),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("artifact", ["policy.pt", "policy.pt2", "module"])
def test_artifacts_reproduce_the_actor(exported, artifact):
    obs = exported["obs"]
    path = os.path.join(exported["port_dir"], artifact)
    if artifact == "policy.pt":
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            model = torch.jit.load(path)
    elif artifact == "policy.pt2":
        model = torch.export.load(path).module()
    else:
        model = Policy(exported["bundle"])
    with torch.no_grad():
        out = model(torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(out, _actor(exported, obs), atol=1e-6)
    np.testing.assert_allclose(out, _numpy_actor(exported["jax"], obs),
                               rtol=1e-4, atol=1e-5)
