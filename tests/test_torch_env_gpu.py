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
function (the given columns) beside the kinds the kernels compute. These
tests need a card and skip without one; the file imports no JAX:

  python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_env_gpu.py
"""

from pathlib import Path

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


class _Step(tuple):
    """A step's (state, obs, reward, dones, time_out) as compare_env reads
    a NamedTuple."""

    def __new__(cls, *xs):
        return super().__new__(cls, xs)

    def _asdict(self):
        return dict(zip(("state", "obs", "reward", "dones", "time_out"),
                        self))
