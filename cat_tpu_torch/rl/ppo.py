"""PPO with CaT float-done GAE, single device (port of
cat_tpu/rl/ppo.py:225-512), with the three backends' variants: the
clean_rl recipe (the PpoCfg defaults), rl_games' (adaptive-KL learning rate
stepped every minibatch, timeout bootstrap) and skrl's (shared trunk,
adaptive-KL learning rate stepped every epoch); ``rl/agent_cfgs.py`` has
the presets.

One ``train_iteration`` is:
  * rollout: ``num_steps`` policy steps; obs normalised by a running
    mean/std updated every step;
  * dual-done GAE: the float constraint probability ``dones`` and the binary
    truncation ``true_dones`` both multiply the bootstrap and the trace;
  * value / return normalisation updated in sequence;
  * ``updates_epochs`` x (batch / minibatch) Adam steps on the clipped
    surrogate, with global grad-norm clipping; the learning rate is a
    linear anneal over iterations, a constant, or the adaptive-KL rule.

The learning rate lives in one device tensor that Adam reads: the
linear anneal computes it on the device from the iteration counter
``device_iteration`` (a () int32 tensor, the reference's
``TrainState.iteration``), the adaptive-KL rule updates it from a
minibatch's (or an epoch's) KL, so the host never waits for the KL and
no host number enters an iteration.

On a CUDA device with no process group an iteration is the replays of two
CUDA graphs (``utils/graphs.py``), the counterpart of the reference's one
compiled ``train_iteration``: ``rollout`` (the draws, env steps, obs
normaliser updates and the bootstrap value) and ``learn`` (GAE through
the last Adam step, the normalisers, the permutations and the metrics).
Their bodies (``_rollout``, ``_learn``) run the steps' eager versions; two
graphs, so that a caller can time the rollout apart from the learner.
The draw (``draw``: the policy's forward, the Gaussian sample and its
log-probability), the env step and, in one process, the Adam step
(``sgd_step``: forward, backward, the global-norm clip, the fused Adam
step and rl_games' per-minibatch rate step) also replay graphs of their
own when called alone, as the eager iteration (``_train_iteration_eager``,
the CPU's and a group's) calls them. ``_draw_eager`` and
``_sgd_step_eager`` are what those graphs capture.

Data parallel (``dist``, a ``parallel.distributed.DistContext`` with a
group): each rank steps its own envs, and an iteration crosses ranks with
``1 + updates_epochs x (1 + n_minibatches)`` all_reduces, as the
reference's shard_map'd iteration (cat_tpu/rl/ppo.py:21-43) does:
  * the rollout crosses none: each rank updates its obs normaliser and its
    CaT running maxes on its own envs;
  * one boundary table an iteration (``_boundary_merge``): the obs
    normaliser's moment deltas, the value and return moments, the episode
    metrics and the running maxes;
  * one an epoch: the (n_minibatches, 2) advantage moments;
  * one a minibatch: the gradients and the 5 loss statistics, averaged
    before the clip, as the reference clips the averaged gradient.
Each rank takes ``minibatch_size // world_size`` rows a minibatch. The
network starts from the base seed on every rank and rank 0's parameters
are broadcast once; the state every rank must agree on (parameters, Adam,
normalisers, running maxes, metrics) comes out bit for bit equal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch.utils import _pytree as pytree

from cat_tpu_torch.envs.env import CatEnv
from cat_tpu_torch.envs.types import EnvState
from cat_tpu_torch.parallel import mesh
from cat_tpu_torch.utils import graphs

from . import networks
from .normalize import (RmsState, rms_init, rms_merge_moments, rms_moments,
                        rms_normalize, rms_stats, rms_update)


LR_MODES = ("linear", "constant", "adaptive_kl", "adaptive_kl_epoch")


@dataclasses.dataclass(frozen=True)
class PpoCfg:
    """Hyperparameters (reference clean_rl_ppo_cfg.py:10-34) and the
    backend-variant knobs of cat_tpu/rl/ppo.py:64-110: ``lr_mode``
    "adaptive_kl" steps the learning rate after every minibatch (rl_games'
    AdaptiveScheduler), "adaptive_kl_epoch" once an epoch on the epoch's
    mean KL (skrl's KLAdaptiveLR), "auto" is "linear" with ``anneal_lr``
    and "constant" without; ``value_bootstrap`` adds gamma V(s) to the
    reward of a step that timed out (rl_games); ``shared_model`` takes the
    shared trunk (skrl)."""
    learning_rate: float = 3.0e-4
    num_steps: int = 24
    num_iterations: int = 2000
    gamma: float = 0.99
    gae_lambda: float = 0.95
    updates_epochs: int = 5
    minibatch_size: int = 16384
    clip_coef: float = 0.2
    ent_coef: float = 0.001
    vf_coef: float = 2.0
    max_grad_norm: float = 1.0
    anneal_lr: bool = True        # read when lr_mode="auto"
    save_interval: int = 50
    hidden: Tuple[int, ...] = (512, 256, 128)
    lr_mode: str = "auto"
    kl_target: float = 0.008
    lr_min: float = 1.0e-6
    lr_max: float = 1.0e-2
    value_bootstrap: bool = False
    shared_model: bool = False

    @property
    def resolved_lr_mode(self) -> str:
        if self.lr_mode == "auto":
            return "linear" if self.anneal_lr else "constant"
        return self.lr_mode


def adaptive_kl_lr(lr, kl, kl_target: float, lr_min: float, lr_max: float):
    """rl_games' AdaptiveScheduler step (skrl's KLAdaptiveLR is the same
    rule): divide by 1.5, floored at lr_min, when kl > 2 kl_target;
    multiply by 1.5, capped at lr_max, when kl < kl_target / 2; else keep.
    Tensors in, a tensor out, on their device."""
    lr, kl = torch.as_tensor(lr), torch.as_tensor(kl)
    return torch.where(
        kl > 2.0 * kl_target, torch.clamp(lr / 1.5, min=lr_min),
        torch.where(kl < 0.5 * kl_target, torch.clamp(lr * 1.5, max=lr_max),
                    lr))


def gae(rewards, values, dones, tdones, next_value, next_done, next_tdone,
        gamma: float, lam: float) -> torch.Tensor:
    """Dual-done GAE over (T, N) rollouts (cleanrl/ppo.py:250-277): step t
    bootstraps through (1 - done[t+1]) (1 - tdone[t+1])."""
    adv = torch.empty_like(rewards)
    lastgaelam = torch.zeros_like(next_value)
    nextvalue = next_value
    nextnonterm = (1.0 - next_done) * (1.0 - next_tdone)
    for t in reversed(range(rewards.shape[0])):
        delta = rewards[t] + gamma * nextvalue * nextnonterm - values[t]
        lastgaelam = delta + gamma * lam * nextnonterm * lastgaelam
        adv[t] = lastgaelam
        nextvalue = values[t]
        nextnonterm = (1.0 - dones[t]) * (1.0 - tdones[t])
    return adv


def clip_grad_global_norm_(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients by max_norm / |g| where |g| >= max_norm (optax
    clip_by_global_norm), each pass over them one multi-tensor op. Returns
    |g|."""
    grads = [p.grad for p in params]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class PPO:
    """Learner state (network, Adam, normalisers, rollout carry) and the
    training iteration."""

    def __init__(self, env: CatEnv, cfg: PpoCfg, generator: torch.Generator,
                 dist=None):
        if cfg.resolved_lr_mode not in LR_MODES:
            raise ValueError(f"lr_mode {cfg.lr_mode!r}: one of auto, "
                             f"{', '.join(LR_MODES)}")
        if dist is not None and cfg.minibatch_size % dist.world_size:
            raise ValueError(f"minibatch_size {cfg.minibatch_size} does not "
                             f"divide over {dist.world_size} processes")
        self.env, self.cfg, self.dist = env, cfg, dist
        dev = env.device
        net_cls = (networks.SharedActorCritic if cfg.shared_model
                   else networks.ActorCritic)
        self.net = net_cls(env.num_obs, env.num_actions, cfg.hidden,
                           generator).to(dev)
        # Adam reads the learning rate from this tensor; the anneal sets it
        # once an iteration, the adaptive rule steps it on the device. The
        # fused Adam takes it as a tensor in one multi-tensor kernel a
        # step, its step counts on the parameters' device, so it reads
        # nothing on the host (on the CPU too). On the card it must be
        # capturable, or step() refuses the Adam step's graph; with fused,
        # capturable changes no kernel
        self.lr = torch.tensor(cfg.learning_rate, device=dev)
        self.opt = torch.optim.Adam(self.net.parameters(), lr=self.lr,
                                    eps=1e-5, fused=True,
                                    capturable=dev.type == "cuda")
        self.obs_rms = rms_init((env.num_obs,), dev)
        self.value_rms = rms_init((), dev)
        # the host's count (logs, checkpoints) and the device's, which the
        # linear anneal reads; a restore sets the second from the first
        self.iteration = 0
        self.device_iteration = torch.zeros((), dtype=torch.int32,
                                            device=dev)
        self._num_iterations = torch.tensor(float(cfg.num_iterations),
                                            device=dev)
        self.next_obs = self.next_done = self.next_true_done = None
        self.graphs = {}   # the iteration's and the steps' keys -> Graph
        if dist is not None:
            mesh.broadcast_(list(self.net.parameters()), 0, dist)

    def start(self, first_obs_raw: torch.Tensor):
        """Warm the obs normaliser on the reset observation (of every
        rank's envs, pooled) and set the rollout carry."""
        moments = rms_moments(first_obs_raw)
        if self.dist is not None:
            k = moments[0].shape[0]
            flat = mesh.all_sum_(torch.cat([moments[0], moments[1],
                                            moments[2][None]]), self.dist)
            moments = flat[:k], flat[k:2 * k], flat[2 * k]
        self.obs_rms = rms_merge_moments(self.obs_rms, *moments)
        self.next_obs = rms_normalize(self.obs_rms, first_obs_raw)
        n = first_obs_raw.shape[0]
        self.next_done = torch.zeros(n, device=first_obs_raw.device)
        self.next_true_done = torch.zeros(n, device=first_obs_raw.device)

    def set_iteration_lr(self):
        """The linear anneal to 0 over num_iterations, from
        ``device_iteration`` on the device in the reference's float32
        formula (cat_tpu/rl/ppo.py:242-243: frac = 1 - it / N, lr = lr0
        max(frac, 0); N a device tensor, so the card divides and does not
        multiply by a reciprocal), or the constant; the adaptive modes
        carry the rate over from the last iteration."""
        cfg = self.cfg
        mode = cfg.resolved_lr_mode
        if mode == "linear":
            frac = 1.0 - self.device_iteration.float() / self._num_iterations
            self.lr.copy_(cfg.learning_rate * torch.clamp(frac, min=0.0))
        elif mode == "constant":
            self.lr.fill_(cfg.learning_rate)

    def step_lr(self, kl: torch.Tensor):
        """The adaptive-KL step of the learning rate, on the device."""
        cfg = self.cfg
        self.lr.copy_(adaptive_kl_lr(self.lr, kl, cfg.kl_target, cfg.lr_min,
                                     cfg.lr_max))

    def loss(self, mb, adv_mom, value_rms: RmsState = None):
        """Clipped surrogate (normalised advantages) + clipped value loss -
        entropy bonus, the value normalised by ``value_rms`` (default: the
        learner's); returns (total, (pg_loss, v_loss, entropy, approx_kl,
        clipfrac))."""
        cfg = self.cfg
        value_rms = self.value_rms if value_rms is None else value_rms
        obs, act, old_logp, adv, ret, old_val = mb
        mean, log_std, newvalue = self.net(obs)
        newlogp = networks.gaussian_logp(mean, log_std, act)
        entropy = networks.gaussian_entropy(log_std, act)
        logratio = newlogp - old_logp
        ratio = torch.exp(logratio)
        m = adv_mom[0]
        s = torch.sqrt(torch.clamp(adv_mom[1] - torch.square(m), min=0.0))
        adv = (adv - m) / (s + 1e-8)
        pg_loss = torch.mean(torch.maximum(
            -adv * ratio,
            -adv * torch.clamp(ratio, 1 - cfg.clip_coef, 1 + cfg.clip_coef)))
        newvalue_n = rms_normalize(value_rms, newvalue)
        v_clipped = old_val + torch.clamp(newvalue_n - old_val,
                                          -cfg.clip_coef, cfg.clip_coef)
        v_loss = 0.5 * torch.mean(torch.maximum(
            torch.square(newvalue_n - ret), torch.square(v_clipped - ret)))
        ent_loss = torch.mean(entropy)
        total = pg_loss - cfg.ent_coef * ent_loss + v_loss * cfg.vf_coef
        with torch.no_grad():
            approx_kl = torch.mean((ratio - 1.0) - logratio)
            clipfrac = torch.mean(
                (torch.abs(ratio - 1.0) > cfg.clip_coef).float())
        return total, (pg_loss, v_loss, ent_loss, approx_kl, clipfrac)

    def draw(self, obs: torch.Tensor, gen: torch.Generator):
        """The rollout's draw at ``obs``: (mean, log_std, value, action,
        logp), the action drawn from the policy with ``gen``. On a CUDA
        device a replay of its CUDA graph (``utils/graphs.py`` ``run``),
        which registers ``gen``."""
        if obs.device.type != "cuda":
            return self._draw_eager(obs, gen)
        return graphs.run(
            self.graphs, ("draw", graphs.signature((obs,)), id(gen),
                          id(self.net)),
            lambda o: self._draw_eager(o, gen), (obs,),
            owners=(gen, self.net), generators=(gen,))

    def _draw_eager(self, obs, gen):
        """The draw launched op by op: what its CUDA graph captures."""
        with torch.no_grad():
            mean, log_std, value = self.net(obs)
            action, logp = networks.sample_action(mean, log_std, gen)
        return mean, log_std, value, action, logp

    def sgd_step(self, mb, adv_mom, lr=None, value_rms: RmsState = None):
        """One Adam step on one minibatch at the current learning rate (or
        at ``lr``, which then becomes the current one), the value
        normalised by ``value_rms`` (default: the learner's), then
        rl_games' per-minibatch rate step; returns the loss statistics
        (total, pg, value, entropy, approx KL, clip fraction). On a CUDA
        device and with no process group, a replay of its CUDA graph
        (``utils/graphs.py`` ``run``), whose inputs are the minibatch,
        ``adv_mom`` and the value normaliser; the gradients and Adam's
        state are the parameters' own, written in place. With a group it
        runs op by op around its all_reduce."""
        if lr is not None:
            self.lr.fill_(lr)
        value_rms = self.value_rms if value_rms is None else value_rms
        if self.dist is not None or adv_mom.device.type != "cuda":
            return self._sgd_step_eager(mb, adv_mom, value_rms)
        inputs = (*mb, adv_mom, *value_rms)
        # Adam's state dict is another after a restore (load_state_dict)
        key = ("sgd", graphs.signature(inputs), id(self.net), id(self.opt),
               id(self.opt.state))
        return graphs.run(
            self.graphs, key,
            lambda *x: self._sgd_step_eager(x[:6], x[6], RmsState(*x[7:])),
            inputs, owners=(self.net, self.opt, self.opt.state))

    def _sgd_step_eager(self, mb, adv_mom, value_rms: RmsState = None):
        """The Adam step launched op by op: what its CUDA graph captures."""
        cfg = self.cfg
        self.opt.zero_grad(set_to_none=False)
        total, aux = self.loss(mb, adv_mom, value_rms)
        total.backward()
        params = list(self.net.parameters())
        aux = torch.stack([a.detach() for a in aux])
        if self.dist is not None:
            # the gradients and the loss statistics, averaged in one
            # all_reduce; the clip below reads the averaged gradient
            flat = mesh.all_mean_(torch.cat(
                [p.grad.reshape(-1) for p in params] + [aux]), self.dist)
            offset = 0
            for p in params:
                p.grad.copy_(flat[offset:offset + p.numel()].view_as(p))
                offset += p.numel()
            aux = flat[offset:]
            total = aux[0] - cfg.ent_coef * aux[2] + aux[1] * cfg.vf_coef
        clip_grad_global_norm_(params, cfg.max_grad_norm)
        self.opt.step()
        if cfg.resolved_lr_mode == "adaptive_kl":
            self.step_lr(aux[3])
        return torch.cat([total.detach()[None], aux])

    def _boundary_merge(self, obs_rms0: RmsState, obs_rms_l: RmsState, moms,
                        rmax_l, scal, sum_scaled):
        """The iteration's one cross-rank collective (port of
        cat_tpu/rl/ppo.py:150-196): the sums (the obs normaliser's moment
        deltas since ``obs_rms0``, the value and return moments ``moms``,
        the scalars ``scal``) and the running maxes ``rmax_l`` go into
        this rank's row of a (world_size, D) table, zero elsewhere, and
        one all_reduce(SUM) gives every rank every row; the sums finish
        with ``.sum(0)``, the maxes with ``.max(0)``. Returns the merged
        (obs_rms, moms, running maxes, scal x sum_scaled)."""
        s1_0, s2_0, n_0 = rms_stats(obs_rms0)
        s1_l, s2_l, n_l = rms_stats(obs_rms_l)
        (vs1, vs2, vn), (rs1, rs2, rn) = moms
        sums = torch.cat([s1_l - s1_0, s2_l - s2_0, (n_l - n_0)[None],
                          torch.stack([vs1, vs2, vn, rs1, rs2, rn]), scal])
        row = torch.cat([sums, rmax_l])
        table = torch.zeros(self.dist.world_size, row.shape[0],
                            dtype=row.dtype, device=row.device)
        table[self.dist.rank] = row
        mesh.all_sum_(table, self.dist)
        m = sums.shape[0]
        gsums = table[:, :m].sum(0)
        rmax_g = table[:, m:].amax(0)
        k = s1_0.shape[0]
        n_g = n_0 + gsums[2 * k]
        mean_g = (s1_0 + gsums[:k]) / n_g
        ex2_g = (s2_0 + gsums[k:2 * k]) / n_g
        obs_rms_g = RmsState(
            mean=mean_g, var=torch.clamp(ex2_g - torch.square(mean_g),
                                         min=0.0), count=n_g)
        vm = gsums[2 * k + 1:2 * k + 7]
        return (obs_rms_g, ((vm[0], vm[1], vm[2]), (vm[3], vm[4], vm[5])),
                rmax_g, gsums[2 * k + 7:] * sum_scaled)

    def train_iteration(self, es: EnvState, gen: torch.Generator
                        ) -> Tuple[EnvState, Dict[str, torch.Tensor]]:
        """One iteration: (es', metrics). On a CUDA device with no process
        group, the replays of its two CUDA graphs, ``rollout`` then
        ``learn``; else launched op by op from the host
        (``_train_iteration_eager``)."""
        if self.dist is not None or self.env.device.type != "cuda":
            return self._train_iteration_eager(es, gen)
        es, batch = self.rollout(es, gen)
        return self.learn(es, batch, gen)

    def _train_iteration_eager(self, es: EnvState, gen: torch.Generator):
        """The iteration launched from the host, its draws, env steps and
        Adam steps through ``draw``, ``env.step`` and ``sgd_step`` (on a
        card each of those a replay of its own graph): the path of a
        process group and of the CPU."""
        carry = self.next_obs, self.next_done, self.next_true_done
        es, carry, obs_rms, batch = self._rollout(
            es, carry, self.obs_rms, gen, self.draw, self.env.step)
        self.next_obs, self.next_done, self.next_true_done = carry
        es, self.value_rms, self.obs_rms, metrics = self._learn(
            es, batch, carry[1], carry[2], self.value_rms, gen,
            self.sgd_step, obs_rms)
        self.iteration += 1
        return es, metrics

    def rollout(self, es: EnvState, gen: torch.Generator):
        """The rollout (``_rollout``) as a replay of its CUDA graph
        (``utils/graphs.py`` ``run``), whose inputs are the env state's
        leaves, the carry and the obs normaliser; the captured body runs
        the draw and the env step op by op. Sets the carry and the obs
        normaliser; returns (es, batch)."""
        leaves, spec = pytree.tree_flatten(es)
        k = len(leaves)
        inputs = (*leaves, self.next_obs, self.next_done,
                  self.next_true_done, *self.obs_rms)

        def body(*x):
            return self._rollout(
                pytree.tree_unflatten(x[:k], spec), x[k:k + 3],
                RmsState(*x[k + 3:]), gen, self._draw_eager,
                self.env._step_eager)

        es, carry, self.obs_rms, batch = graphs.run(
            self.graphs, ("rollout", *self.env._graph_key(inputs, gen),
                          id(self.net), self.cfg),
            body, inputs, owners=(gen, self.net, self.env.cfg,
                                  *self.env.engine.captured()),
            generators=(gen,))
        self.next_obs, self.next_done, self.next_true_done = carry
        return es, batch

    def learn(self, es: EnvState, batch, gen: torch.Generator):
        """GAE through the last Adam step (``_learn``) as a replay of its
        CUDA graph, whose inputs are the env state's leaves, the rollout's
        batch, the carry's dones and the value normaliser; the captured
        body runs the Adam steps op by op. The parameters, Adam's state,
        the learning rate and ``device_iteration`` are the learner's own,
        written in place. Sets the value normaliser; returns (es,
        metrics)."""
        leaves, spec = pytree.tree_flatten(es)
        k, m = len(leaves), len(batch)
        inputs = (*leaves, *batch, self.next_done, self.next_true_done,
                  *self.value_rms)

        def body(*x):
            es, value_rms, _, metrics = self._learn(
                pytree.tree_unflatten(x[:k], spec), x[k:k + m], x[k + m],
                x[k + m + 1], RmsState(*x[k + m + 2:]), gen,
                self._sgd_step_eager)
            return es, value_rms, metrics

        # Adam's state dict is another after a restore (load_state_dict)
        key = ("learn", *self.env._graph_key(inputs, gen), id(self.net),
               id(self.opt), id(self.opt.state), self.cfg)
        es, self.value_rms, metrics = graphs.run(
            self.graphs, key, body, inputs,
            owners=(gen, self.net, self.opt, self.opt.state, self.env.cfg,
                    *self.env.engine.captured()),
            generators=(gen,))
        self.iteration += 1
        return es, metrics

    def _rollout(self, es: EnvState, carry, obs_rms: RmsState, gen, draw,
                 step):
        """``num_steps`` draws (``draw``) and env steps (``step``) from the
        carry (obs, done, tdone), the obs normaliser updated every step,
        then the bootstrap value. Returns (es, carry, obs_rms, batch):
        batch the (T, N, ...) stacks of obs, action, logp, value, reward,
        done and tdone, then the bootstrap value."""
        cfg = self.cfg
        obs, done, tdone = carry
        traj = []
        for _ in range(cfg.num_steps):
            _, _, value, action, logp = draw(obs, gen)
            es, next_obs_raw, reward, next_done, time_out = step(
                es, action, gen)
            if cfg.value_bootstrap:
                # a step cut off by the time limit keeps gamma V(s) of the
                # return it would have had (rl_games, cat_common.py:62-67)
                reward = reward + cfg.gamma * value * time_out.float()
            traj.append((obs, action, logp, value, reward, done, tdone))
            obs_rms = rms_update(obs_rms, next_obs_raw)
            obs = rms_normalize(obs_rms, next_obs_raw)
            done, tdone = next_done, time_out.float()
        with torch.no_grad():
            next_value = self.net(obs)[2]
        batch = (*(torch.stack(x) for x in zip(*traj)), next_value)
        return es, (obs, done, tdone), obs_rms, batch

    def _learn(self, es: EnvState, batch, done, tdone, value_rms: RmsState,
               gen, sgd_step, obs_rms: RmsState = None):
        """The iteration's learning rate, dual-done GAE on the rollout's
        ``batch`` (``done`` and ``tdone`` the carry's), ``drain_metrics``,
        the value and return normalisation, ``updates_epochs`` epochs of
        minibatch Adam steps (``sgd_step``) and the metrics; then
        ``device_iteration`` + 1. With a group, the boundary merge
        (``obs_rms`` this rank's obs normaliser after the rollout, merged
        with the others'). Returns (es, value_rms, obs_rms, metrics)."""
        cfg, env = self.cfg, self.env
        self.set_iteration_lr()
        b_obs, b_act, b_logp, b_val, b_rew, b_done, b_tdone, next_value = (
            batch)

        # ---- dual-done GAE ----
        adv = gae(b_rew, b_val, b_done, b_tdone, next_value, done, tdone,
                  cfg.gamma, cfg.gae_lambda)
        returns = adv + b_val

        nb = b_obs.shape[0] * b_obs.shape[1]
        b_obs = b_obs.reshape(nb, -1)
        b_act = b_act.reshape(nb, -1)
        b_logp, b_adv = b_logp.reshape(nb), adv.reshape(nb)
        b_ret, b_vals = returns.reshape(nb), b_val.reshape(nb)

        es, ep_metrics = env.drain_metrics(es)
        mean_reward, mean_done = torch.mean(b_rew), torch.mean(b_done)
        v_mom, r_mom = rms_moments(b_vals), rms_moments(b_ret)
        if self.dist is not None:
            # the iteration's boundary: episode metrics as the plain mean
            # of the ranks' means (Episode/count summed), as the reference
            keys = sorted(ep_metrics)
            inv = 1.0 / self.dist.world_size
            obs_rms, (v_mom, r_mom), rmax, scal = self._boundary_merge(
                self.obs_rms, obs_rms, (v_mom, r_mom), es.running_max,
                torch.stack([ep_metrics[k].float() for k in keys]
                            + [mean_reward, mean_done]),
                torch.tensor([1.0 if k == "Episode/count" else inv
                              for k in keys] + [inv, inv],
                             device=mean_reward.device))
            es = es._replace(running_max=rmax)
            ep_metrics = dict(zip(keys, scal[:len(keys)].unbind()))
            mean_reward, mean_done = scal[len(keys)], scal[len(keys) + 1]

        # ---- value / return normalisation, in sequence ----
        value_rms = rms_merge_moments(value_rms, *v_mom)
        b_vals = rms_normalize(value_rms, b_vals)
        value_rms = rms_merge_moments(value_rms, *r_mom)
        b_ret = rms_normalize(value_rms, b_ret)

        # ---- minibatch SGD: each rank takes its share of a minibatch ----
        mb_size = cfg.minibatch_size // (self.dist.world_size if self.dist
                                         else 1)
        n_mb = nb // mb_size
        if n_mb == 0:
            raise ValueError(f"minibatch_size {cfg.minibatch_size} exceeds "
                             f"the batch of {nb} samples")
        data = (b_obs, b_act, b_logp, b_adv, b_ret, b_vals)
        stats = []
        for _ in range(cfg.updates_epochs):
            perm = torch.randperm(nb, generator=gen, device=b_obs.device)
            pdata = [x[perm] for x in data]
            adv_mb = pdata[3][:n_mb * mb_size].reshape(n_mb, mb_size)
            adv_moms = torch.stack([torch.mean(adv_mb, dim=1),
                                    torch.mean(torch.square(adv_mb), dim=1)],
                                   dim=1)
            if self.dist is not None:
                mesh.all_mean_(adv_moms, self.dist)
            epoch = torch.stack([
                sgd_step([x[i * mb_size:(i + 1) * mb_size] for x in pdata],
                         adv_moms[i], value_rms=value_rms)
                for i in range(n_mb)])
            if cfg.resolved_lr_mode == "adaptive_kl_epoch":
                self.step_lr(torch.mean(epoch[:, 4]))   # the epoch's mean KL
            stats.append(epoch)
        stats = torch.mean(torch.cat(stats), dim=0)
        self.device_iteration.add_(1)
        names = ("Loss/mean_surrogate_loss", "Loss/mean_pg_loss",
                 "Loss/mean_v_loss", "Loss/mean_entropy_loss",
                 "Loss/approx_kl", "Loss/clipfrac")
        metrics = dict(zip(names, stats.unbind()))
        metrics.update({
            "Train/mean_reward_per_step": mean_reward,
            "Train/mean_done": mean_done,
            "Train/learning_rate": self.lr.clone(),
            **ep_metrics,
        })
        return es, value_rms, obs_rms, metrics
