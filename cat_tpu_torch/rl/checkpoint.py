"""Checkpoint and resume: the whole training state, for an exact resume
(port of cat_tpu/rl/checkpoint.py).

A checkpoint holds the learner (network, Adam's state, both normalisers,
the iteration, the learning rate, the rollout carry; the device's
iteration counter is restored from the iteration), every EnvState tensor
and the states of the run's torch.Generators, as plain dicts of tensors
(``torch.load(weights_only=True)`` reads no NamedTuple), written with
``torch.save`` to a temporary name and moved into place. ``restore``
checks the saved tree against the live one and names the first leaf whose
shape or dtype differs; with ``strict=False`` a leaf of another shape (an
env-sized leaf of a run with another env count) keeps the live value, so a
training checkpoint loads into a 50-env play env.

Data parallel (a ``DistContext`` with a group): every rank takes part in
``save``, which gathers every rank's rows of the env-batched leaves (by
name, ``parallel/mesh.py``) and every rank's generator states (a leading
rank axis) to rank 0, and only rank 0 writes (cat_tpu/rl/checkpoint.py:
20-52). ``restore_local_shard`` gives each rank its own rows back
(:110-154); a checkpoint of the same world size resumes bit for bit.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional

import torch

from cat_tpu_torch.envs.types import EnvState
from cat_tpu_torch.parallel import mesh
from cat_tpu_torch.rl.normalize import RmsState
from cat_tpu_torch.sim.engine import SimState

SUFFIX = ".pt"
# leaves added after checkpoints were first written, and the value a
# checkpoint without one restores with (the reference's _fill_defaults,
# cat_tpu/rl/checkpoint.py:156-166): no CoM shift
ADDED_LEAVES = {"env.com_offset": torch.zeros_like}
# leaves once saved as a Python int, now a () tensor: the step counter,
# on the device since the env step became a CUDA graph
INT_LEAVES = ("env.common_step",)


def _env_dict(es: EnvState) -> dict:
    d = es._asdict()
    d["sim"] = es.sim._asdict()
    return d


def _ppo_dict(ppo, opt_state: Optional[dict] = None) -> dict:
    return {
        "net": ppo.net.state_dict(),
        "opt": ppo.opt.state_dict() if opt_state is None else opt_state,
        "obs_rms": ppo.obs_rms._asdict(), "value_rms": ppo.value_rms._asdict(),
        "iteration": ppo.iteration, "lr": ppo.lr,
        "next_obs": ppo.next_obs, "next_done": ppo.next_done,
        "next_true_done": ppo.next_true_done,
    }


def state_dict(ppo, es: EnvState,
               generators: Mapping[str, torch.Generator] = None,
               dist=None) -> dict:
    """The checkpoint's tree: {"ppo": ..., "env": ..., "generators": ...}.
    With a group (every rank calls it): every rank's rows of the
    env-batched leaves, in rank order, and every rank's generator states
    stacked on a leading rank axis."""
    tree = {"ppo": _ppo_dict(ppo), "env": _env_dict(es),
            "generators": {k: g.get_state()
                           for k, g in (generators or {}).items()}}
    if dist is None or dist.group is None:
        return tree
    flat = flatten(tree)
    for name, x in flat.items():
        if mesh.is_batched(name):
            flat[name] = mesh.gather_rows(x, dist)
        elif name.startswith("generators."):
            flat[name] = mesh.gather_rows(x[None], dist)
    return _unflatten_into(tree, flat)


def save(path: str, ppo, es: EnvState,
         generators: Mapping[str, torch.Generator] = None,
         dist=None) -> str:
    """Write the checkpoint to ``path`` (``.pt`` appended if missing);
    returns the file's path. With a group every rank must call it, and
    rank 0 alone writes."""
    out = path if path.endswith(SUFFIX) else path + SUFFIX
    tree = state_dict(ppo, es, generators, dist)
    if dist is not None and not dist.is_rank0:
        return out
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    tmp = out + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, out)
    return out


def load(path: str) -> dict:
    """The checkpoint's tree, on the CPU."""
    if not path.endswith(SUFFIX):
        path = path + SUFFIX
    return torch.load(path, map_location="cpu", weights_only=True)


def flatten(tree, prefix: str = "") -> Dict[str, object]:
    """Dotted leaf name -> leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def mismatches(a, b) -> List[str]:
    """Names of the leaves of two trees that are not bit for bit equal (or
    exist in only one of them)."""
    fa, fb = flatten(a), flatten(b)
    out = sorted(set(fa) ^ set(fb))
    for k in sorted(set(fa) & set(fb)):
        x, y = fa[k], fb[k]
        if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
            same = (x.dtype == y.dtype and x.shape == y.shape
                    and torch.equal(x.cpu(), y.cpu()))
        else:
            same = type(x) is type(y) and x == y
        if not same:
            out.append(k)
    return out


def _adam_template(ppo, stepped: bool) -> dict:
    """Adam's state_dict as it is before the first step (``state`` empty)
    or after it (a state for every parameter)."""
    sd = ppo.opt.state_dict()
    if not stepped:
        sd["state"] = {}
    elif not sd["state"]:
        sd["state"] = {i: {"step": torch.zeros(()),
                           "exp_avg": torch.zeros_like(p),
                           "exp_avg_sq": torch.zeros_like(p)}
                       for i, p in enumerate(ppo.net.parameters())}
    return sd


def _unflatten_into(tree, flat: Dict[str, object], prefix: str = ""):
    if isinstance(tree, Mapping):
        return {k: _unflatten_into(v, flat, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten_into(v, flat, f"{prefix}.{i}")
                          for i, v in enumerate(tree))
    return flat[prefix]


def restore(path: str, ppo, es: EnvState,
            generators: Mapping[str, torch.Generator] = None,
            strict: bool = True) -> EnvState:
    """Load the checkpoint at ``path`` into ``ppo`` (in place), the given
    generators (their states, if given) and a new EnvState, returned. The
    live ``ppo`` and ``es`` are the template: the saved tree must have
    their structure and each leaf their dtype and shape (``strict``), or
    keeps the live leaf where only the shape differs (not ``strict``)."""
    return restore_local_shard(path, ppo, es, generators, 0, 1, strict)


def restore_local_shard(path: str, ppo, es: EnvState,
                        generators: Mapping[str, torch.Generator],
                        rank: int, world_size: int,
                        strict: bool = True) -> EnvState:
    """``restore`` for rank ``rank`` of ``world_size``: an env-batched leaf
    saved with ``world_size`` times the live rows gives this rank rows
    [rank n, (rank + 1) n); the other leaves load as they are. The
    generators take this rank's saved states when the checkpoint was
    written by ``world_size`` processes; else they keep their live states,
    as in a fresh run, and rank 0 prints so."""
    saved = load(path)
    stepped = bool(saved.get("ppo", {}).get("opt", {}).get("state"))
    want = {"ppo": _ppo_dict(ppo, _adam_template(ppo, stepped)),
            "env": _env_dict(es)}
    got = {k: saved.get(k) for k in want}
    fw, fg = flatten(want), flatten(got)
    for name, fill in ADDED_LEAVES.items():
        if name in fw and name not in fg:
            fg[name] = fill(fw[name])
    for name in INT_LEAVES:
        if isinstance(fg.get(name), int) and isinstance(fw.get(name),
                                                        torch.Tensor):
            fg[name] = torch.tensor(fg[name], dtype=fw[name].dtype)
    if set(fw) != set(fg):
        raise ValueError(
            f"checkpoint {path}: its tree does not match the live state: "
            f"missing {sorted(set(fw) - set(fg))[:5]}, unexpected "
            f"{sorted(set(fg) - set(fw))[:5]}")
    kept = []
    for name, w in fw.items():
        g = fg[name]
        if isinstance(w, torch.Tensor) != isinstance(g, torch.Tensor):
            raise ValueError(f"checkpoint {path}: leaf {name} is a "
                             f"{type(g).__name__}, expected {type(w).__name__}")
        if not isinstance(w, torch.Tensor):
            continue
        if g.dtype != w.dtype:
            raise ValueError(f"checkpoint {path}: leaf {name} has dtype "
                             f"{g.dtype}, expected {w.dtype}")
        if (g.shape != w.shape and mesh.is_batched(name) and g.dim() >= 1
                and g.shape[0] == world_size * w.shape[0]
                and g.shape[1:] == w.shape[1:]):
            g = g[rank * w.shape[0]:(rank + 1) * w.shape[0]]
        if g.shape != w.shape:
            if strict:
                raise ValueError(
                    f"checkpoint {path}: leaf {name} has shape "
                    f"{tuple(g.shape)}, expected {tuple(w.shape)} (another "
                    "num_envs or model?)")
            kept.append(name)
            fg[name] = w
        else:
            fg[name] = g.to(w.device)
    if kept:
        print(f"restore(strict=False): kept the live values of {len(kept)} "
              f"leaves of another shape (e.g. {kept[0]})")
    tree = _unflatten_into(want, fg)

    p = tree["ppo"]
    ppo.net.load_state_dict(p["net"])
    # Adam keeps the live rate tensor and the live device's implementation
    # (a card's checkpoint may resume on the CPU, and the other way round;
    # only the card's Adam is capturable), its step counts on the
    # parameters' device, as the fused Adam keeps them
    live = [(g["fused"], g["capturable"]) for g in ppo.opt.param_groups]
    ppo.opt.load_state_dict(p["opt"])
    ppo.lr.copy_(p["lr"])
    for group, (fused, capturable) in zip(ppo.opt.param_groups, live):
        group.update(lr=ppo.lr, fused=fused, capturable=capturable)
        for q in group["params"]:
            if q in ppo.opt.state:
                st = ppo.opt.state[q]
                st["step"] = st["step"].to(q.device)
    ppo.obs_rms = RmsState(**p["obs_rms"])
    ppo.value_rms = RmsState(**p["value_rms"])
    ppo.iteration = p["iteration"]
    # the device's count is not a leaf: set in place from the host's (an
    # iteration's graph reads it where it is)
    ppo.device_iteration.fill_(ppo.iteration)
    ppo.next_obs, ppo.next_done, ppo.next_true_done = (
        p["next_obs"], p["next_done"], p["next_true_done"])
    e = tree["env"]
    es = EnvState(**dict(e, sim=SimState(**e["sim"])))
    fresh = []
    for name, g in (generators or {}).items():
        if name not in saved.get("generators", {}):
            raise ValueError(f"checkpoint {path}: no state of generator "
                             f"{name!r}")
        state = saved["generators"][name]
        if state.dim() == 1 and world_size == 1:
            g.set_state(state)
        elif state.dim() == 2 and state.shape[0] == world_size:
            g.set_state(state[rank].clone())
        else:
            fresh.append(name)
    if fresh and rank == 0:
        print(f"restore: {path} was written by another number of processes "
              f"than {world_size}; the generators {fresh} start as in a "
              "fresh run", flush=True)
    return es


def latest(run_dir: str) -> str:
    """The newest checkpoint of a run: ``ckpt_final`` if there is one, else
    the highest ``ckpt_<iteration>`` (the reference's resolution,
    clean_rl/play.py:84); a diverged state's dump is never picked."""
    def rank(f):
        stem = f[len("ckpt_"):-len(SUFFIX)]
        if stem == "final":
            return (2, 0)
        return (1, int(stem)) if stem.isdigit() else None

    cands = [(rank(f), f) for f in os.listdir(run_dir)
             if f.startswith("ckpt_") and f.endswith(SUFFIX)]
    cands = [c for c in cands if c[0] is not None]
    if not cands:
        raise FileNotFoundError(f"no checkpoints in {run_dir}")
    return os.path.join(run_dir, max(cands)[1])
