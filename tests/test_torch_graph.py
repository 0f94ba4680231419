"""The control step's CUDA graph (cat_tpu_torch/sim/engine.py).

On the CPU ``Engine.__call__`` is the eager substep loop, makes no graph,
and survives the bench's positional rebuild of the engine; the graph's key
separates every input signature and captured object a capture bakes in.
On a card (the ``gpu`` marker; skipped without one) the graphed control
step equals the eager loop bit for bit (no tolerance: the replay runs the
same kernels in the same order) over 3 control steps, in each engine
configuration the port runs: the flat block-Jacobi solve, the serial solve
on a heightfield, Go2, the joint-less box (Cholesky M^-1) and CoM offsets;
the states it returns share no memory with the graph, and each contact
kernel counts one launch a substep, replayed or not. The file imports no
JAX, so on a machine with a card:

  python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_graph.py
"""

import numpy as np
import pytest
import torch

from cat_tpu_torch.models.box import box_model, on_slope_qpos, slope_terrain
from cat_tpu_torch.models.go2 import GO2_KD, GO2_KP, go2_model
from cat_tpu_torch.models.solo12 import SOLO12_KD, SOLO12_KP, solo12_model
from cat_tpu_torch.ops import pgs
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
