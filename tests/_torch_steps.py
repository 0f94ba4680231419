"""The env configurations the port's graphed steps are tested on, without
JAX (tests/test_torch_capture.py on the CPU, tests/test_torch_graph.py on
a card): Solo12 flat; Solo12 rough with the terrain curriculum, on a small
grid; Go2 with the domain-randomization events (the CoM event on the base,
a reset term and an interval term that draw from the env's generator).
Each comes with the agent preset that exercises another learner variant.
``stand_in_graphs`` replays ``utils/graphs.py``'s graphs on the CPU."""

import contextlib
import dataclasses

import torch
from torch.utils import _pytree as pytree

from cat_tpu_torch.envs.env import CatEnv, EventTerm
from cat_tpu_torch.models.go2 import GO2_ACTUATED_JOINT_ORDER
from cat_tpu_torch.rl import agent_cfgs
from cat_tpu_torch.tasks import go2_flat, solo12_flat, solo12_rough
from cat_tpu_torch.utils import graphs

DR = ("events.com_displacement=0.05", "events.com_bodies=('base',)")


def _reset_kick(gen, sim, reset, model, scale):
    """Reset term: a random base velocity on the envs that reset."""
    kick = scale * torch.rand(sim.qvel.shape[0], 6, generator=gen,
                              device=sim.qvel.device)
    qvel = torch.cat([torch.where(reset[:, None], kick, sim.qvel[:, :6]),
                      sim.qvel[:, 6:]], dim=1)
    return sim._replace(qvel=qvel)


def _interval_shove(gen, sim, state, cfg, p):
    """Interval term: each env's base sideways at 0.2 m/s with chance p."""
    hit = torch.rand(sim.qvel.shape[0], generator=gen,
                     device=sim.qvel.device) < p
    qvel = sim.qvel.clone()
    qvel[:, 1] = torch.where(hit, 0.2, sim.qvel[:, 1])
    return sim._replace(qvel=qvel)


DR_TERMS = (EventTerm("kick", "reset", _reset_kick, dict(scale=0.1)),
            EventTerm("shove", "interval", _interval_shove, dict(p=0.05)))


def go2_dr(n, device):
    """Go2 flat with the CoM event and DR_TERMS."""
    env = go2_flat.make_env(n, overrides=DR, device=device)
    cfg = dataclasses.replace(env.cfg, events=dataclasses.replace(
        env.cfg.events, extra_terms=DR_TERMS))
    return CatEnv(env.model, cfg, go2_flat.go2_constraint_terms(env.model),
                  GO2_ACTUATED_JOINT_ORDER, go2_flat.ILLEGAL_CONTACT_BODIES,
                  device=device)


# name -> (env factory (n, device), agent preset (n))
ENVS = {
    "flat": (lambda n, dev: solo12_flat.make_env(n, device=dev),
             lambda n: agent_cfgs.clean_rl()),
    "rough": (lambda n, dev: solo12_rough.make_env(n, rows=3, cols=2,
                                                   device=dev),
              agent_cfgs.skrl),
    "go2-dr": (go2_dr, lambda n: agent_cfgs.rl_games()),
}


def minibatch(env, rows, gen):
    """A random minibatch (obs, act, logp, adv, ret, val) and advantage
    moments on the env's device."""
    dev = env.device

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    mb = [r(rows, env.num_obs), r(rows, env.num_actions), r(rows) - 17.0,
          r(rows), r(rows), r(rows)]
    return mb, torch.stack([mb[3].mean(), (mb[3] ** 2).mean()])


def stand_in_graphs(monkeypatch) -> list:
    """``graphs.Graph`` captured and replayed on the CPU: the capture runs
    the body on static copies of the inputs; a replay copies the inputs
    in, runs the body on those copies again and copies its outputs into
    the captured ones, as a graph writes the same memory. Returns the list
    each replay appends its graph to."""
    replays = []

    def capture(self, fn, inputs):
        self.inputs = tuple(None if t is None else
                            t.clone(memory_format=torch.contiguous_format)
                            for t in inputs)
        self.fn = fn
        self.out, self.spec = pytree.tree_flatten(fn(*self.inputs))
        self.launches = ()
        self.graph = "stand-in"

    def replay(self, inputs):
        graphs._copy(*zip(*((buf, t) for buf, t in zip(self.inputs, inputs)
                            if buf is not None)))
        graphs._copy(self.out, pytree.tree_leaves(self.fn(*self.inputs)))
        replays.append(self)

    monkeypatch.setattr(graphs.Graph, "capture", capture)
    monkeypatch.setattr(graphs.Graph, "replay", replay)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    return replays
