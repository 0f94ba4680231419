"""CUDA graphs of the port's steps: the physics control step
(``sim/engine.py``), the env step (``envs/env.py``), the rollout's draw,
the Adam step and the PPO iteration's two graphs, its rollout and its
learning (``rl/ppo.py``), share this one helper.

A step is replayed from a graph captured for one input signature, its key
(the caller's: the inputs' shapes, dtypes and devices, ``signature``, and
the identity of every object the capture bakes in). ``run``:

  * the first call of a key runs the step eagerly: the warm-up, which makes
    outside a capture what a capture may not make (cuBLAS handles, Adam's
    state, the kernels' device tables, the terrain's tables);
  * the second captures it on contiguous static copies of its inputs and
    replays the graph once;
  * every later call copies its inputs into those buffers (one
    ``torch._foreach_copy_`` a dtype) and replays the graph.

A replay runs the kernels the capture recorded in the same order, so its
result equals the eager step's bit for bit. Each call returns copies of
the graph's outputs (again one ``torch._foreach_copy_`` a dtype), which
share no memory with the graph. The generators registered with a graph
advance at each replay as the eager step advances them. The launches each
kernel of ``ops/substep.py`` ``KERNELS`` counted while the step was
captured are added to its count at every replay. A failed capture raises:
nothing falls back to the eager step.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable, Sequence

import torch
from torch.utils import _pytree as pytree

from cat_tpu_torch.ops import substep


@contextlib.contextmanager
def no_collection():
    """Around a capture: a dead reference cycle that holds another CUDA
    graph must not be collected while it runs (its graph's destructor
    frees memory, which invalidates the capture; PyTorch no longer
    collects when a capture begins). So collect first, and keep the
    collector off until the capture ends."""
    gc.collect()
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()


def signature(tensors: Sequence) -> tuple:
    """Each tensor's shape, dtype and device (None stays None): what a
    capture bakes in of its inputs."""
    out = []
    for t in tensors:
        if t is not None and not isinstance(t, torch.Tensor):
            raise TypeError(f"a graphed step takes tensors or None, not "
                            f"{type(t).__name__}")
        out.append(None if t is None else (tuple(t.shape), t.dtype, t.device))
    return tuple(out)


@torch.no_grad()
def _copy(dsts, srcs):
    """dsts[i] <- srcs[i], one ``torch._foreach_copy_`` for each dtype of
    the sources (a list of mixed dtypes would copy tensor by tensor); no
    gradient flows (an output may be a parameter, the draw's log_std)."""
    groups: dict = {}
    for d, s in zip(dsts, srcs):
        ds, ss = groups.setdefault(s.dtype, ([], []))
        ds.append(d)
        ss.append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


class Graph:
    """One step captured for one key: the static copies of its inputs
    (``inputs``), the flattened outputs the graph writes (``out``), the
    launches each kernel counted while it was captured, and ``owners``, the
    objects whose ids are in the key, kept alive so that no other object
    takes those ids."""

    def __init__(self, owners, generators):
        self.owners, self.generators = owners, generators
        self.graph = None

    def capture(self, fn: Callable, inputs):
        """Capture ``fn`` on static copies of ``inputs`` and replay the
        graph once. Launches counted during the capture stand for this
        first replay."""
        self.inputs = tuple(None if t is None else
                            t.clone(memory_format=torch.contiguous_format)
                            for t in inputs)
        before = [k.launches for _, k in substep.KERNELS]
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        # thread_local: another thread's CUDA calls (NCCL's watchdog) do
        # not invalidate the capture
        with no_collection(), torch.cuda.graph(
                graph, capture_error_mode="thread_local"):
            out = fn(*self.inputs)
        self.out, self.spec = pytree.tree_flatten(out)
        self.launches = tuple((k, k.launches - b)
                              for (_, k), b in zip(substep.KERNELS, before)
                              if k.launches != b)
        self.graph = graph
        graph.replay()

    def replay(self, inputs):
        _copy(*zip(*((buf, t) for buf, t in zip(self.inputs, inputs)
                     if buf is not None)))
        self.graph.replay()
        for kernel, n in self.launches:
            kernel.launches += n

    def outputs(self):
        """Copies of the graph's outputs, in the structure ``fn`` returned."""
        tensors = [t for t in self.out if isinstance(t, torch.Tensor)]
        copies = [torch.empty_like(t) for t in tensors]
        _copy(copies, tensors)
        it = iter(copies)
        return pytree.tree_unflatten(
            [next(it) if isinstance(t, torch.Tensor) else t for t in self.out],
            self.spec)


def run(graphs: dict, key, fn: Callable, inputs: Sequence, owners=(),
        generators=()):
    """``fn(*inputs)``, the step of ``graphs[key]`` (module docstring):
    eager at the key's first call, captured at its second, replayed
    after. ``inputs`` are tensors or None, all on one CUDA device;
    ``owners`` the objects whose ids are in ``key``; ``generators``
    the ``torch.Generator`` objects ``fn`` draws from."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        raise RuntimeError("a step's CUDA graph records no gradients of "
                           "its inputs: call its eager version to "
                           "differentiate through it")
    g = graphs.get(key)
    if g is None:
        graphs[key] = Graph(tuple(owners), tuple(generators))
        return fn(*inputs)
    device = next(t.device for t in inputs if t is not None)
    with torch.cuda.device(device):
        if g.graph is None:
            g.capture(fn, inputs)
        else:
            g.replay(inputs)
        return g.outputs()
