"""The env step's three kernels (ops/env_step.py: env_terms, env_update,
env_obs) on a card, against their plain stages (envs/env.py CatEnv
terms_stage, update_stage, obs_stage).

On states of Solo12 flat, Solo12 rough (the production 800 x 640 terrain,
the height scan and the curriculum) and Go2 at 4096 envs, taken after 30
env steps of a policy the JAX package trained (Solo12's drives the rough
robot from its first 45 inputs): each kernel's outputs from the plain
side's inputs within ``measure.compare_env`` (8 float32 spacings of an
output column's largest magnitude; the accumulators at (N - 1) unit
roundoffs; a decision flipped only within 4 spacings of its limit); two
launches from one input equal bit for bit; the env step's CUDA graph
replayed against ``_step_eager`` (the kernels) bit for bit; and the Go2
configuration with a reset and an interval event term (tests/_torch_steps.py
go2-dr, where the reset term splits env_update in two), the kernel path
against the plain path over one step; and a task with a term of its own
function (the given columns) beside the kinds the kernels compute. Then
env_terms and env_update at ragged N (1, 33, 4095: a last block of 1, 1
and 31 envs) against their plain stages; env_update's accumulators
against ``env_step.fold_shares`` of its envs' shares (the order it sums
them in) bit for bit, and the shares against the plain stage's; and its
ticket back at 0 after a launch and after each of three CUDA-graph
replays, the replays equal bit for bit. Then env_obs: with the step's
noise and with null draws (no noise) on each state, at ragged N (1, 9,
4097: a block's group not filled, a last block of one env) on flat and
rough, each within compare_env and a second launch bit for bit, and its
launch refusing a shared-memory count that is not its layout's. These
tests need a card and skip without one; the file imports no JAX:

  python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_env_gpu.py
"""

from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from _torch_steps import ENVS
from cat_tpu_torch import measure
from cat_tpu_torch.envs import constraints as C
from cat_tpu_torch.envs.cat import ConstraintTerm
from cat_tpu_torch.envs.env import CatEnv
from cat_tpu_torch.models.solo12 import SOLO12_ACTUATED_JOINT_ORDER
from cat_tpu_torch.ops import env_step
from cat_tpu_torch.rl.convert import actor_from_bundle
from cat_tpu_torch.rl.networks import ActorCritic
from cat_tpu_torch.tasks import go2_flat, solo12_flat, solo12_rough

N, STEPS = 4096, 30
RUNS = Path(__file__).resolve().parents[1] / "runs"
CASES = {
    "flat": (lambda dev: solo12_flat.make_env(N, device=dev),
             "solo12_flat_2000it"),
    "rough": (lambda dev: solo12_rough.make_env(N, device=dev),
              "solo12_flat_2000it"),
    "go2": (lambda dev: go2_flat.make_env(N, device=dev), "go2_r4"),
}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def policy(run, dev):
    """The mean action of a JAX-trained policy bundle, on the first 45
    inputs, with a little noise so that the envs differ."""
    sd, mean, var = actor_from_bundle(dict(np.load(
        RUNS / run / "policy_params.npz")))
    net = ActorCritic(45, 12).to(dev)
    net.load_state_dict(sd, strict=False)
    mean, std = mean.to(dev), torch.sqrt(var.to(dev) + 1e-8)
    gen = torch.Generator(device=dev).manual_seed(7)

    def act(obs):
        a = net.actor((obs[:, :45] - mean) / std)
        return a + 0.3 * torch.randn(a.shape, generator=gen, device=dev)
    return act


@pytest.fixture(scope="module")
def cases(cuda):
    out = {}
    for name, (make, run) in CASES.items():
        env = make(cuda)
        inputs = measure.env_inputs(env, N, STEPS, policy(run, cuda))
        out[name] = (env, inputs)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["env_terms", "env_update", "env_obs"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_its_plain_stage(cases, case, kernel):
    env, (state, action, gen) = cases[case]
    gen_state = gen.get_state()
    pairs = measure.env_stage_pairs(env, state, action, gen)
    gen.set_state(gen_state)
    out, ref, margins, call, _ = pairs[kernel]
    torch.cuda.synchronize()
    cmp = measure.compare_env(out, ref, margins)
    assert cmp.ok, cmp.text
    # two launches from the same inputs: the same bits
    again = pytree.tree_leaves(call())
    assert all(torch.equal(a, b) for a, b in zip(pytree.tree_leaves(out),
                                                 again))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_env_step_graph_equals_eager_with_the_kernels(cases, case):
    """Warm-up, capture and two replays of the env step against
    ``_step_eager`` from the same state and generator state, bit for bit;
    each env kernel launches once a step, replayed or not."""
    env, (state, action, gen) = cases[case]
    g_graph = torch.Generator(device=action.device)
    g_eager = torch.Generator(device=action.device)
    g_graph.set_state(gen.get_state())
    g_eager.set_state(gen.get_state())
    kernels = [k for _, k in env_step.ENV_KERNELS]
    a = b = state
    for k in range(4):
        before = [kern.launches for kern in kernels]
        out = env.step(a, action, g_graph)
        torch.cuda.synchronize()
        assert [kern.launches - n for kern, n in zip(kernels, before)] == [
            1, 1, 1], k
        ref = env._step_eager(b, action, g_eager)
        for x, y in zip(pytree.tree_leaves(out), pytree.tree_leaves(ref)):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        assert torch.equal(g_graph.get_state(), g_eager.get_state())
        a, b = out[0], ref[0]


@pytest.mark.gpu
def test_event_terms_kernel_path_against_plain_path(cuda):
    """Go2 with a reset and an interval event term: one step through the
    kernels (env_update in its two parts around the reset term) against
    the same step through the plain stages, from one state and generator
    state: the same draws, outputs within compare_env."""
    env = ENVS["go2-dr"][0](N, cuda)
    state, action, gen = measure.env_inputs(env, N, STEPS,
                                            policy("go2_r4", cuda))
    g_kernel = torch.Generator(device=cuda)
    g_plain = torch.Generator(device=cuda)
    g_kernel.set_state(gen.get_state())
    g_plain.set_state(gen.get_state())
    before = env_step.ENV_UPDATE.launches
    out = env._step_eager(state, action, g_kernel)
    assert env_step.ENV_UPDATE.launches - before == 2   # the two parts
    calls = []
    with measure.plain_stages(calls):
        ref = env._step_eager(state, action, g_plain)
    assert [c[0] for c in calls] == ["env_terms", "env_update",
                                     "env_update", "env_obs"]
    sim = calls[0][1][1]      # env_terms' SimState: the control step's
    assert torch.equal(g_kernel.get_state(), g_plain.get_state())
    margins = torch.minimum(
        measure.env_margins(env, state, sim, action, state.action),
        measure.env_margins(env, state, sim, action, state.action,
                            command=ref[0].command))
    cmp = measure.compare_env(_Step(*out), _Step(*ref), margins)
    assert cmp.ok, cmp.text


def _tilt(data, *, gain):
    """A term outside the kernels' kinds: two columns of scaled tilt."""
    return gain * data.projected_gravity[:, :2]


@pytest.mark.gpu
def test_a_term_outside_the_kinds_through_the_given_block(cuda):
    """Solo12 flat with a term of its own function (computed in PyTorch
    and handed to env_terms as given columns) and two more kinds: each
    kernel against its plain stage, as above."""
    base = solo12_flat.make_env(N, device=cuda)
    joints = base.cset.terms[0].params["joint_ids"].cpu().numpy()
    terms = [t._replace(params={k: (v.cpu().numpy() if isinstance(
        v, torch.Tensor) else v) for k, v in t.params.items()})
        for t in base.cset.terms] + [
        ConstraintTerm("tilt", _tilt, dict(gain=3.0), 0.25, True),
        ConstraintTerm("joint_range", C.joint_range,
                       dict(limit=0.3, joint_ids=joints), 0.25, True),
        ConstraintTerm("min_base_height", C.min_base_height,
                       dict(limit=0.2), 1.0, False)]
    env = CatEnv(base.model, base.cfg, terms, SOLO12_ACTUATED_JOINT_ORDER,
                 device=cuda)
    assert env.cset.descriptors.given == (13,)
    inputs = measure.env_inputs(env, N, STEPS,
                                policy("solo12_flat_2000it", cuda))
    pairs = measure.env_stage_pairs(env, *inputs)
    assert sorted(pairs) == ["env_obs", "env_terms", "env_update"]
    for name, (out, ref, margins, *_) in pairs.items():
        cmp = measure.compare_env(out, ref, margins)
        assert cmp.ok, f"{name}: {cmp.text}"


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 33, 4095])
def test_kernels_at_ragged_n(cuda, n):
    """env_terms and env_update on Solo12 rough (the curriculum, the
    spawn height) at n envs after 30 steps, within compare_env, and a
    second launch bit for bit."""
    env = solo12_rough.make_env(n, device=cuda)
    inputs = measure.env_inputs(env, n, STEPS,
                                policy("solo12_flat_2000it", cuda))
    pairs = measure.env_stage_pairs(env, *inputs)
    for name in ("env_terms", "env_update"):
        out, ref, margins, call, _ = pairs[name]
        cmp = measure.compare_env(out, ref, margins)
        assert cmp.ok, f"{name} at {n}: {cmp.text}"
        assert all(torch.equal(a, b) for a, b in zip(
            pytree.tree_leaves(out), pytree.tree_leaves(call())))


def plain_shares(env, state, terms, up):
    """Each env's shares of the accumulators (N, 2 n_terms + 6) as the
    plain stage (``CatEnv._update_reset``) forms them before its sums."""
    cset = env.cset
    max_p = cset.curriculum_max_p(terms.common_step, env.cfg.curriculum_steps)
    _, _, term_probs, viol = cset.transform(terms.raw, terms.col_max,
                                            state.running_max, max_p)
    ill, upside, to = terms.illegal, terms.upside, terms.time_out
    rf = (ill | upside | to).float()
    ep = torch.clamp(terms.episode_len.float(), min=1.0)[:, None]
    er = state.episode_rew + up.reward
    return torch.cat([
        rf[:, None] * (state.episode_viol + viol.float()) / ep * 100.0,
        rf[:, None] * (state.episode_prob + term_probs) / ep,
        torch.stack([rf * er, rf * terms.episode_len, rf, ill.float(),
                     (upside & ~ill).float(),
                     (to & ~(ill | upside)).float()], dim=1)], dim=1)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_accumulators_fold_the_shares_in_the_kernel_order(cases, case):
    """The kernel's six accumulators are the incoming ones plus
    ``fold_shares`` of its envs' shares, bit for bit; its shares are the
    plain stage's within 8 float32 spacings of a column's largest, and
    where a column's shares are equal bit for bit so is its accumulator
    to the fold of the plain shares."""
    env, (state, action, gen) = cases[case]
    pairs = measure.env_stage_pairs(env, state, action, gen)
    _, ref, _, call, _ = pairs["env_update"]
    args = call.args[1:]                  # (state, sim, ..., terms, draws)
    st, terms = args[0], args[4]
    nt = env.cset.n_terms
    shares = torch.full((N, 2 * nt + env_step.SHARE_EXTRA), float("nan"),
                        device=action.device)
    up = env_step.ENV_UPDATE(env, *args, **call.keywords, shares=shares)
    envs = env_step.env_geometry(N, env).envs
    acc_in = (st.acc_viol, st.acc_prob, st.acc_rew, st.acc_len,
              st.acc_count, st.acc_term)
    acc_out = (up.acc_viol, up.acc_prob, up.acc_rew, up.acc_len,
               up.acc_count, up.acc_term)
    edges = np.cumsum([0, nt, nt, 1, 1, 1, 3])

    def accumulate(sh):
        tot = env_step.fold_shares(sh, envs)
        return [(a.cpu() + tot[lo:hi].reshape(a.shape))
                for a, lo, hi in zip(acc_in, edges[:-1], edges[1:])]

    for got, want in zip(acc_out, accumulate(shares)):
        assert torch.equal(got.cpu(), want)
    plain = plain_shares(env, st, terms, ref)
    tol = 8 * 2.0 ** -24 * plain.abs().amax(0)
    assert bool(((shares - plain).abs() <= tol).all())
    same = (shares == plain).all(0).cpu()
    for got, want, lo, hi in zip(acc_out, accumulate(plain), edges[:-1],
                                 edges[1:]):
        if bool(same[lo:hi].all()):
            assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_ticket_is_back_at_zero_after_launches_and_replays(cases):
    """env_update's ticket (its last block's) reads 0 after an eager
    launch and after each of three replays of a CUDA graph of it; the
    replays give the eager launch's outputs bit for bit."""
    env, (state, action, gen) = cases["flat"]
    _, _, _, call, _ = measure.env_stage_pairs(env, state, action,
                                               gen)["env_update"]
    ticket = env_step.env_tables(env, action.device)["ticket"]
    eager = pytree.tree_leaves(call())
    torch.cuda.synchronize()
    assert int(ticket.item()) == 0
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert int(ticket.item()) == 0
        assert all(torch.equal(a, b) for a, b in zip(
            pytree.tree_leaves(out), eager))


class _Obs(NamedTuple):
    obs: torch.Tensor


def _obs_against_plain(env, sim, command, action, draws):
    """env_obs against obs_stage on one input: the comparison and whether
    a second launch gave the same bits."""
    out = env_step.ENV_OBS(env, sim, command, action, draws)
    ref = env.obs_stage(sim, command, action, draws)
    again = env_step.ENV_OBS(env, sim, command, action, draws)
    n = action.shape[0]
    cmp = measure.compare_env(_Obs(out), _Obs(ref), torch.full(
        (n,), float("inf"), device=action.device))
    return cmp, torch.equal(out, again), out


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_env_obs_with_and_without_noise(cases, case):
    """env_obs on the case's state with the step's noise and with null
    draws, each against obs_stage; the two differ only in the noisy
    parts' columns (the command and the action have none)."""
    env, (state, action, gen) = cases[case]
    g = torch.Generator(device=action.device)
    g.set_state(gen.get_state())
    args = (env, state.sim, state.command, state.action)
    noisy = env._obs_draws(g, N)
    assert all(d is not None for d in noisy.draws[:4])
    outs = []
    for draws in (noisy, env_step.ObsDraws(None, None, None, None, None)):
        cmp, same, out = _obs_against_plain(*args, draws)
        assert cmp.ok and same, cmp.text
        outs.append(out)
    nj = env.model.nj
    quiet = torch.zeros(env.num_obs, dtype=torch.bool)
    quiet[3:6] = True
    quiet[9 + 2 * nj:9 + 3 * nj] = True
    differ = (outs[0] != outs[1]).any(0).cpu()
    assert not differ[quiet].any() and differ[~quiet].all()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 9, 4097])
@pytest.mark.parametrize("task", ["flat", "rough"])
def test_env_obs_at_ragged_n(cuda, task, n):
    """env_obs at n envs after 30 steps against obs_stage on the step's
    own inputs, and a second launch bit for bit."""
    env = {"flat": solo12_flat, "rough": solo12_rough}[task].make_env(
        n, device=cuda)
    inputs = measure.env_inputs(env, n, STEPS,
                                policy("solo12_flat_2000it", cuda))
    geo = env_step.env_geometry(n, env)
    assert n % geo.obs_envs and geo.obs_blocks == -(-n // geo.obs_envs)
    out, ref, margins, call, _ = measure.env_stage_pairs(
        env, *inputs)["env_obs"]
    cmp = measure.compare_env(out, ref, margins)
    assert cmp.ok, f"env_obs at {n}: {cmp.text}"
    assert all(torch.equal(a, b) for a, b in zip(
        pytree.tree_leaves(out), pytree.tree_leaves(call())))


@pytest.mark.gpu
def test_env_obs_launch_refuses_a_shared_memory_mismatch(cases):
    """A geometry whose shared bytes are not the kernel's layout's: the
    launch raises and counts nothing."""
    env, (state, action, gen) = cases["rough"]
    tabs = env_step.env_tables(env, action.device)
    geo = env_step.geometry(tabs, N, env)
    g = torch.Generator(device=action.device)
    g.set_state(gen.get_state())
    draws = env._obs_draws(g, N)
    launches = env_step.ENV_OBS.launches
    try:
        tabs[("geometry", N)] = geo._replace(obs_bytes=geo.obs_bytes + 16)
        with pytest.raises(RuntimeError, match="launch failed"):
            env_step.ENV_OBS(env, state.sim, state.command, state.action,
                             draws)
    finally:
        tabs[("geometry", N)] = geo
    assert env_step.ENV_OBS.launches == launches


class _Step(tuple):
    """A step's (state, obs, reward, dones, time_out) as compare_env reads
    a NamedTuple."""

    def __new__(cls, *xs):
        return super().__new__(cls, xs)

    def _asdict(self):
        return dict(zip(("state", "obs", "reward", "dones", "time_out"),
                        self))
