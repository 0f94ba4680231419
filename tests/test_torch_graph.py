"""The CUDA graphs of the port's steps (cat_tpu_torch/utils/graphs.py):
the control step's (cat_tpu_torch/sim/engine.py), and the env step's, the
rollout draw's and the Adam step's.

On the CPU ``Engine.__call__`` is the eager substep loop, makes no graph,
and survives the bench's positional rebuild of the engine; the graph's key
separates every input signature and captured object a capture bakes in.
On a card (the ``gpu`` marker; skipped without one) the graphed control
step equals the eager loop bit for bit (no tolerance: the replay runs the
same kernels in the same order) over 3 control steps, in each engine
configuration the port runs: the flat block-Jacobi solve, the serial solve
on a heightfield, Go2, the joint-less box (Cholesky M^-1) and CoM offsets;
the states it returns share no memory with the graph, and each contact
kernel counts one launch a substep, replayed or not. The same holds for
the env step on the three configurations of tests/_torch_steps.py (Solo12
flat, rough with the terrain curriculum, Go2 with the DR events; every
EnvState field and output, and the generator's state), with the bench's
spanned engine too, for the rollout's draw, and for the Adam step under
the linear and adaptive-KL rates (parameters, gradients, Adam's moments
and step counts, the rate). And for the whole PPO iteration, the replays
of its two graphs (``PPO.rollout``, ``PPO.learn``) against the iteration
launched from the host with the three steps op by op (as chip_smoke.py's
``eager_trainer`` runs it), on the three configurations with their
presets (the linear rate, skrl's per-epoch and rl_games' per-minibatch
adaptive rates): every leaf of the checkpoint's tree and every metric,
bit for bit, over 4 iterations, and across a save and a restore in
mid-run. The file imports no JAX, so on a machine with a card:

  python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_graph.py
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from _torch_steps import ENVS, minibatch
from cat_tpu_torch import bench
from cat_tpu_torch.models.box import box_model, on_slope_qpos, slope_terrain
from cat_tpu_torch.models.go2 import GO2_KD, GO2_KP, go2_model
from cat_tpu_torch.models.solo12 import SOLO12_KD, SOLO12_KP, solo12_model
from cat_tpu_torch.ops import pgs, substep
from cat_tpu_torch.rl import agent_cfgs, checkpoint
from cat_tpu_torch.rl.normalize import RmsState
from cat_tpu_torch.rl.ppo import PPO, PpoCfg
from cat_tpu_torch.sim import engine, terrain
from cat_tpu_torch.sim.solver import SolverParams

torch.set_num_threads(1)

BJ = dict(structure="bj", bj_blocks=4, omega=0.9, iterations=6)
CONFIGS = ("flat-bj", "rough-gs", "go2", "box", "com")
STEPS = 3


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control step's CUDA graph")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _setup(name, dev, n, steps=STEPS, seed=0):
    """An engine of configuration ``name`` on ``dev``, n envs in contact
    (at the default pose; the box on a 25 degree slope), PD targets of
    ``steps`` control steps about the default pose, friction and CoM
    offsets (None unless ``name`` is "com"). Returns (engine, state,
    targets, mu, com_offset)."""
    rng = np.random.default_rng(seed)
    terr, com = None, None
    if name == "go2":
        model = go2_model()
        params = engine.EngineParams(kp=GO2_KP, kd=GO2_KD)
    elif name == "box":
        model, terr = box_model(), slope_terrain(25.0)
        params = engine.EngineParams()
    else:
        model = solo12_model()
        gs = name == "rough-gs"
        params = engine.EngineParams(
            kp=SOLO12_KP, kd=SOLO12_KD,
            solver=SolverParams() if gs else SolverParams(**BJ))
        if gs:
            terr = terrain.generate_rough(rows=3, cols=2, patch_m=4.0, seed=3)
    eng = engine.make_batched_step(model, params, terrain=terr, device=dev)
    s = engine.make_batched_init(model, n, dev)
    if name == "box":
        qpos = on_slope_qpos(25.0, n).astype(np.float32)
    else:
        qpos = np.tile(model.default_qpos(), (n, 1)).astype(np.float32)
        if terr is not None:
            xy = np.stack([terr.patch_origin(i % 3, i // 3 % 2)
                           for i in range(n)]).astype(np.float32)
            qpos[:, 0:2] = xy + rng.uniform(-0.5, 0.5, (n, 2))
            qpos[:, 2] += terrain.height_at(
                terr, torch.from_numpy(qpos[:, 0:2])).numpy()
    s = s._replace(qpos=torch.from_numpy(qpos).to(dev))
    targets = torch.from_numpy(
        np.tile(model.default_qpos_joints, (steps, n, 1))
        + rng.uniform(-0.3, 0.3, (steps, n, model.nj))).float().to(dev)
    mu = torch.from_numpy(rng.uniform(0.5, 1.2, n)).float().to(dev)
    if name == "com":
        com = torch.zeros(n, model.nbody, 3)
        com[:, 0] = torch.from_numpy(rng.uniform(-0.05, 0.05, (n, 3)))
        com = com.to(dev)
    return eng, s, targets, mu, com


def _equal(a: engine.SimState, b: engine.SimState) -> list:
    """The fields of two states that differ in any bit."""
    return [f for f, x, y in zip(engine.SimState._fields, a, b)
            if x.shape != y.shape or x.dtype != y.dtype
            or not torch.equal(x.view(torch.uint8) if x.dtype == torch.bool
                               else x.view(torch.int32),
                               y.view(torch.uint8) if y.dtype == torch.bool
                               else y.view(torch.int32))]


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_call_on_the_cpu_is_the_eager_substep_loop(name):
    """``eng(...)`` on CPU tensors equals the loop of ``decimation``
    substeps bit for bit, step after step, and makes no graph."""
    eng, s0, targets, mu, com = _setup(name, "cpu", 4, steps=2)
    s = loop = s0
    for k in range(2):
        s = eng(s, targets[k], mu, com)
        loop = loop._replace(touchdown=torch.zeros_like(loop.touchdown))
        for _ in range(eng.params.decimation):
            loop = eng.substep(loop, targets[k], mu, com)
        assert _equal(s, loop) == []
    assert all(bool(torch.isfinite(t.float()).all()) for t in s)
    assert eng.graphs == {}


def test_the_bench_rebuild_constructs_and_steps():
    """The bench's spanned copy, ``type(eng)(*eng._replace(solve=f))``,
    constructs, shares the engine's graphs and steps as the engine."""
    eng, s, targets, mu, _ = _setup("flat-bj", "cpu", 4, steps=1)
    calls = []

    def spanned(*a, **k):
        calls.append(1)
        return eng.solve(*a, **k)

    copy = type(eng)(*eng._replace(solve=spanned))
    assert copy.graphs is eng.graphs
    assert copy._graph_key(s, targets[0], mu) == eng._graph_key(
        s, targets[0], mu)
    assert _equal(copy(s, targets[0], mu), eng(s, targets[0], mu)) == []
    assert len(calls) == eng.params.decimation


def _key_variants():
    """(what changes, a function of (engine, state, target, mu) returning
    the changed call's engine and arguments)."""
    def other_n(eng, s, t, mu):
        return eng, (engine.SimState(*(x[:2] for x in s)), t[:2], mu[:2],
                     None)

    def with_com(eng, s, t, mu):
        return eng, (s, t, mu, torch.zeros(s.qpos.shape[0],
                                           eng.mt.model.nbody, 3))

    def other_terrain(eng, s, t, mu):
        return eng._replace(terrain=terrain.plane()), (s, t, mu, None)

    def other_params(eng, s, t, mu):
        return eng._replace(params=eng.params._replace(kp=5.0)), (
            s, t, mu, None)

    def other_kwargs(eng, s, t, mu):
        return eng._replace(pgs_kwargs=dict(eng.pgs_kwargs)), (
            s, t, mu, None)

    def other_dtype(eng, s, t, mu):
        return eng, (s, t.double(), mu, None)

    return {f.__name__: f for f in (other_n, with_com, other_terrain,
                                    other_params, other_kwargs, other_dtype)}


@pytest.mark.parametrize("change", sorted(_key_variants()))
def test_graph_key_separates(change):
    """A call that differs in what a capture bakes in gets another key:
    the batch size, a CoM offset given or not, another terrain, other
    parameters or solve arguments, another dtype."""
    eng, s, targets, mu, _ = _setup("flat-bj", "cpu", 4, steps=1)
    key = eng._graph_key(s, targets[0], mu)
    other, args = _key_variants()[change](eng, s, targets[0], mu)
    assert other._graph_key(*args) != key


def test_graph_key_ignores_values_and_layouts():
    """The same signature keys the same graph whatever the values, and a
    stride-0 target (the bench's ``expand``) keys as a dense one."""
    eng, s, targets, mu, _ = _setup("flat-bj", "cpu", 4, steps=1)
    key = eng._graph_key(s, targets[0], mu)
    moved = s._replace(qpos=s.qpos + 1.0)
    wide = targets[0, :1].expand(4, -1)
    assert wide.stride(0) == 0
    assert eng._graph_key(moved, wide, 2.0 * mu) == key


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

N_CARD = 512


def _kernel(eng):
    return pgs.KERNEL if eng.solve is pgs.pgs_bj else pgs.GS_KERNEL


@pytest.mark.gpu
@pytest.mark.parametrize("name", CONFIGS)
def test_graph_equals_eager_bit_for_bit(cuda, name):
    """After the warm-up call, STEPS graphed control steps (the capture,
    then replays) equal STEPS eager loops from the same state bit for bit;
    the kernel counts decimation launches for every control step."""
    eng, s0, targets, mu, com = _setup(name, cuda, N_CARD)
    kernel = _kernel(eng)
    before = kernel.launches
    eng(s0, targets[0], mu, com)                   # the warm-up, eager
    eager, graphed = [], []
    s = g = s0
    for k in range(STEPS):
        s = eng._eager(s, targets[k], mu, com)
        g = eng(g, targets[k], mu, com)
        eager.append(s)
        graphed.append(g)
    torch.cuda.synchronize()
    assert len(eng.graphs) == 1
    for k, (a, b) in enumerate(zip(eager, graphed)):
        assert _equal(a, b) == [], f"control step {k}"
    assert all(bool(torch.isfinite(t.float()).all()) for t in graphed[-1])
    assert kernel.launches - before == (1 + 2 * STEPS) * eng.params.decimation


@pytest.mark.gpu
def test_returned_states_do_not_alias_the_graph(cuda):
    """A state the graphed step returned keeps its values through later
    replays, and no field shares storage with the graph's buffers or with
    another returned state."""
    eng, s0, targets, mu, _ = _setup("rough-gs", cuda, N_CARD)
    states = [eng(s0, targets[0], mu)]
    for k in range(1, STEPS):
        states.append(eng(states[-1], targets[k], mu))
    kept = [engine.SimState(*(t.clone() for t in s)) for s in states]
    for _ in range(2):
        states.append(eng(states[-1], targets[-1], mu))
    torch.cuda.synchronize()
    for s, k in zip(states, kept):
        assert _equal(s, k) == []
    g, = eng.graphs.values()
    graph_mem = {t.untyped_storage().data_ptr()
                 for t in g.inputs + tuple(g.out) if t is not None}
    returned = [t.untyped_storage().data_ptr() for s in states for t in s]
    assert not graph_mem & set(returned)
    assert len(set(returned)) == len(returned)


@pytest.mark.gpu
def test_a_spanned_copy_replays_the_engines_graph(cuda):
    """The bench's rebuild of the engine with a wrapped solve replays the
    engine's capture: no new graph, the wrapper is not called, the
    launches still count."""
    eng, s, targets, mu, _ = _setup("flat-bj", cuda, N_CARD)
    s = eng(eng(s, targets[0], mu), targets[1], mu)          # captured
    calls = []

    def spanned(*a, **k):
        calls.append(1)
        return eng.solve(*a, **k)

    copy = type(eng)(*eng._replace(solve=spanned))
    before = pgs.KERNEL.launches
    out = copy(s, targets[2], mu)
    torch.cuda.synchronize()
    assert len(eng.graphs) == 1 and calls == []
    assert pgs.KERNEL.launches - before == eng.params.decimation
    assert _equal(out, eng._eager(s, targets[2], mu)) == []


@pytest.mark.gpu
def test_graphed_step_refuses_inputs_that_need_gradients(cuda):
    eng, s, targets, mu, _ = _setup("flat-bj", cuda, 8)
    with pytest.raises(RuntimeError, match="gradients"):
        eng(s, targets[0].requires_grad_(), mu)


# ---------------------------------------------------------------------------
# the env step, the rollout's draw and the Adam step on the card
# ---------------------------------------------------------------------------

N_STEP = 256
SGD_STEPS = 6


def _bits(t):
    return (t.view(torch.uint8) if t.dtype == torch.bool
            else t.view(torch.int32) if t.dtype.itemsize == 4 else t)


def _differ(a, b) -> list:
    """The paths of the leaves of two results that differ in any bit."""
    fa, fb = (pytree.tree_flatten_with_path(x)[0] for x in (a, b))
    return [pytree.keystr(p) for (p, x), (_, y) in zip(fa, fb)
            if x.shape != y.shape or x.dtype != y.dtype
            or not torch.equal(_bits(x), _bits(y))] + (
        ["structure"] if len(fa) != len(fb) else [])


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(ENVS))
def test_env_step_graph_equals_eager_bit_for_bit(cuda, name):
    """The warm-up, the capture and STEPS - 1 replays of the env step equal
    ``_step_eager`` from the same state and generator state bit for bit
    (every EnvState field and output, and the generator's state after),
    each launching every kernel of the path once a substep; what they
    return shares no memory with the graph. Then the bench's spanned copy
    of the engine replays the same graph: no second capture, no span."""
    env = ENVS[name][0](N_STEP, cuda)
    es = env.init(torch.Generator(device=cuda).manual_seed(0), N_STEP)
    actions = 0.5 * torch.randn(STEPS + 2, N_STEP, env.num_actions,
                                generator=torch.Generator(
                                    device=cuda).manual_seed(1), device=cuda)
    g_graph = torch.Generator(device=cuda).manual_seed(2)
    g_eager = torch.Generator(device=cuda).manual_seed(2)
    path = [k for name_, k in substep.KERNELS if name_ != "pgs_gs"]
    a = b = es
    for k in range(STEPS + 1):
        before = [kernel.launches for kernel in path]
        out = env.step(a, actions[k], g_graph)
        torch.cuda.synchronize()
        assert [kernel.launches - n for kernel, n in zip(path, before)] == [
            env.cfg.decimation] * len(path), f"env step {k}"
        ref = env._step_eager(b, actions[k], g_eager)
        assert _differ(out, ref) == [], f"env step {k}"
        assert torch.equal(g_graph.get_state(), g_eager.get_state())
        a, b = out[0], ref[0]
    g, = env.graphs.values()
    graph_mem = {t.untyped_storage().data_ptr()
                 for t in g.inputs + tuple(g.out)}
    assert not graph_mem & {t.untyped_storage().data_ptr()
                            for t in pytree.tree_leaves(out)}

    eng, calls = env.engine, []

    def counted(*x, **kw):
        calls.append(1)
        return eng.solve(*x, **kw)

    env.engine = bench.spanned_engine(eng._replace(solve=counted))
    try:
        out = env.step(a, actions[-1], g_graph)
    finally:
        env.engine = eng
    ref = env._step_eager(b, actions[-1], g_eager)
    assert calls == [] and len(env.graphs) == 1
    assert _differ(out, ref) == []


@pytest.mark.gpu
def test_draw_graph_equals_eager_bit_for_bit(cuda):
    env = ENVS["flat"][0](N_STEP, cuda)
    ppo = PPO(env, agent_cfgs.clean_rl(), torch.Generator().manual_seed(0))
    obs = torch.randn(STEPS + 1, N_STEP, env.num_obs, device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(3))
    g_graph = torch.Generator(device=cuda).manual_seed(4)
    g_eager = torch.Generator(device=cuda).manual_seed(4)
    for k in range(STEPS + 1):
        out = ppo.draw(obs[k], g_graph)
        assert _differ(out, ppo._draw_eager(obs[k], g_eager)) == [], k
        assert torch.equal(g_graph.get_state(), g_eager.get_state())
    assert len(ppo.graphs) == 1


def _learner_state(ppo) -> dict:
    out = {"lr": ppo.lr}
    for name, p in ppo.net.named_parameters():
        st = ppo.opt.state[p]
        out.update({name: p, name + ".grad": p.grad,
                    name + ".exp_avg": st["exp_avg"],
                    name + ".exp_avg_sq": st["exp_avg_sq"],
                    name + ".step": st["step"]})
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["linear", "adaptive_kl"])
def test_sgd_step_graph_equals_eager_bit_for_bit(cuda, mode):
    """SGD_STEPS Adam steps through ``sgd_step`` (the warm-up, the capture,
    replays) equal ``_sgd_step_eager``'s from the same learner bit for bit:
    the statistics, parameters, gradients, Adam's moments and step counts
    and the learning rate, with a new minibatch, value normaliser and (the
    linear mode) rate at every step."""
    env = ENVS["flat"][0](64, cuda)
    cfg = PpoCfg(lr_mode=mode, minibatch_size=512)
    graphed, eager = (PPO(env, cfg, torch.Generator().manual_seed(0))
                      for _ in range(2))
    gen = torch.Generator(device=cuda).manual_seed(5)
    for k in range(SGD_STEPS):
        mb, adv_mom = minibatch(env, 512, gen)
        graphed.value_rms = eager.value_rms = RmsState(
            mean=torch.randn((), generator=gen, device=cuda),
            var=1.0 + torch.rand((), generator=gen, device=cuda),
            count=torch.tensor(100.0 * (k + 1), device=cuda))
        lr = 1e-4 * (k + 1) if mode == "linear" else None
        stats = graphed.sgd_step(mb, adv_mom, lr=lr)
        if lr is not None:
            eager.lr.fill_(lr)
        ref = eager._sgd_step_eager(mb, adv_mom)
        assert _differ(stats, ref) == [], f"Adam step {k}"
        assert _differ(_learner_state(graphed),
                       _learner_state(eager)) == [], f"Adam step {k}"
    assert len(graphed.graphs) == 1


# ---------------------------------------------------------------------------
# the whole PPO iteration on the card: two graphs against op by op
# ---------------------------------------------------------------------------

ITERS = 4


def _trainers(name, dev):
    """The env of configuration ``name`` at N_STEP envs and two learners
    on it from one seed, each (ppo, generator, env state): the first runs
    its iteration as it does, the second launched from the host with the
    draw, env step and Adam step op by op (chip_smoke.py
    ``eager_trainer``). 4 minibatches of 1,536 rows an epoch."""
    make_env, make_cfg = ENVS[name]
    env = make_env(N_STEP, dev)
    cfg = dataclasses.replace(make_cfg(N_STEP), minibatch_size=N_STEP * 6)
    out = []
    for _ in range(2):
        gen = torch.Generator(device=dev).manual_seed(0)
        es = env.init(gen, N_STEP)
        ppo = PPO(env, cfg, torch.Generator().manual_seed(1))
        ppo.start(env.observe(es, gen))
        out.append([ppo, gen, es])
    e = out[1][0]
    e.train_iteration = e._train_iteration_eager
    e.draw, e.sgd_step = e._draw_eager, e._sgd_step_eager
    env.step = env._step_eager     # the graphed bodies call it by name
    return env, out


def _iterate(env, sides, k):
    """Iteration ``k`` on both sides; each kernel of the path launches
    once a substep on each. Returns the two metrics dicts."""
    path = [kernel for name_, kernel in substep.KERNELS if name_ != "pgs_gs"]
    metrics = []
    for side in sides:
        before = [kernel.launches for kernel in path]
        side[2], m = side[0].train_iteration(side[2], side[1])
        torch.cuda.synchronize()
        assert [kernel.launches - n for kernel, n in zip(path, before)] == [
            env.cfg.decimation * side[0].cfg.num_steps] * len(path), k
        metrics.append(m)
    return metrics


def _trainer_differ(sides, metrics) -> list:
    (g, gen_g, es_g), (e, gen_e, es_e) = sides
    return checkpoint.mismatches(
        checkpoint.state_dict(g, es_g, {"ppo": gen_g}),
        checkpoint.state_dict(e, es_e, {"ppo": gen_e})) + _differ(*metrics)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(ENVS))
def test_iteration_graphs_equal_eager_bit_for_bit(cuda, name):
    """ITERS iterations (the warm-up, the capture, replays): after each,
    every checkpoint leaf (env state, learner, Adam, generator) and every
    metric equal bit for bit; the graphed learner holds the iteration's
    two graphs and the env none."""
    env, sides = _trainers(name, cuda)
    rates = []
    for k in range(ITERS):
        metrics = _iterate(env, sides, k)
        assert _trainer_differ(sides, metrics) == [], f"iteration {k + 1}"
        rates.append(float(metrics[0]["Train/learning_rate"]))
    g, e = sides[0][0], sides[1][0]
    assert sorted(key[0] for key in g.graphs) == ["learn", "rollout"]
    assert env.graphs == {} and e.graphs == {}
    if g.cfg.resolved_lr_mode == "linear":
        assert len(set(rates)) == ITERS


@pytest.mark.gpu
def test_iteration_graphs_across_a_restore(cuda, tmp_path):
    """Flat: 2 iterations, the graphed learner's checkpoint restored into
    both learners, ITERS - 1 more (the graphed one re-keys ``learn``:
    Adam's state is new), each equal bit for bit."""
    env, sides = _trainers("flat", cuda)
    for k in range(ITERS + 1):
        if k == 2:
            g, gen_g, es_g = sides[0]
            path = checkpoint.save(str(tmp_path / "ckpt_2"), g, es_g,
                                   {"ppo": gen_g})
            for side in sides:
                side[2] = checkpoint.restore(path, side[0], side[2],
                                             {"ppo": side[1]})
            assert int(g.device_iteration) == 2
        metrics = _iterate(env, sides, k)
        assert _trainer_differ(sides, metrics) == [], f"iteration {k + 1}"
    assert sorted(key[0] for key in sides[0][0].graphs) == [
        "learn", "learn", "rollout"]
