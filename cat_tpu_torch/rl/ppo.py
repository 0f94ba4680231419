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
adaptive-KL rule updates it on the device from a minibatch's (or an
epoch's) KL, so the host never waits for the KL.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from cat_tpu_torch.envs.env import CatEnv
from cat_tpu_torch.envs.types import EnvState

from . import networks
from .normalize import (rms_init, rms_merge_moments, rms_moments,
                        rms_normalize, rms_update)


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
    clip_by_global_norm). Returns |g|."""
    grads = [p.grad for p in params]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


class PPO:
    """Learner state (network, Adam, normalisers, rollout carry) and the
    training iteration."""

    def __init__(self, env: CatEnv, cfg: PpoCfg, generator: torch.Generator):
        if cfg.resolved_lr_mode not in LR_MODES:
            raise ValueError(f"lr_mode {cfg.lr_mode!r}: one of auto, "
                             f"{', '.join(LR_MODES)}")
        self.env, self.cfg = env, cfg
        dev = env.device
        net_cls = (networks.SharedActorCritic if cfg.shared_model
                   else networks.ActorCritic)
        self.net = net_cls(env.num_obs, env.num_actions, cfg.hidden,
                           generator).to(dev)
        # Adam reads the learning rate from this tensor; the anneal sets it
        # once an iteration, the adaptive rule steps it on the device. On
        # the card the fused Adam takes it as a device tensor in one
        # multi-tensor kernel a step (a capturable Adam, the other way to
        # take one, adds ~40 small kernels a step)
        self.lr = torch.tensor(cfg.learning_rate, device=dev)
        self.opt = torch.optim.Adam(self.net.parameters(), lr=self.lr,
                                    eps=1e-5, fused=dev.type == "cuda")
        self.obs_rms = rms_init((env.num_obs,), dev)
        self.value_rms = rms_init((), dev)
        self.iteration = 0
        self.next_obs = self.next_done = self.next_true_done = None

    def start(self, first_obs_raw: torch.Tensor):
        """Warm the obs normaliser on the reset observation and set the
        rollout carry."""
        self.obs_rms = rms_update(self.obs_rms, first_obs_raw)
        self.next_obs = rms_normalize(self.obs_rms, first_obs_raw)
        n = first_obs_raw.shape[0]
        self.next_done = torch.zeros(n, device=first_obs_raw.device)
        self.next_true_done = torch.zeros(n, device=first_obs_raw.device)

    def set_iteration_lr(self):
        """The linear anneal to 0 over num_iterations, or the constant; the
        adaptive modes carry the rate over from the last iteration."""
        cfg = self.cfg
        mode = cfg.resolved_lr_mode
        if mode == "linear":
            self.lr.fill_(cfg.learning_rate
                          * max(1.0 - self.iteration / cfg.num_iterations, 0.0))
        elif mode == "constant":
            self.lr.fill_(cfg.learning_rate)

    def step_lr(self, kl: torch.Tensor):
        """The adaptive-KL step of the learning rate, on the device."""
        cfg = self.cfg
        self.lr.copy_(adaptive_kl_lr(self.lr, kl, cfg.kl_target, cfg.lr_min,
                                     cfg.lr_max))

    def loss(self, mb, adv_mom):
        """Clipped surrogate (normalised advantages) + clipped value loss -
        entropy bonus; returns (total, (pg_loss, v_loss, entropy, approx_kl,
        clipfrac))."""
        cfg = self.cfg
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
        newvalue_n = rms_normalize(self.value_rms, newvalue)
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

    def sgd_step(self, mb, adv_mom, lr=None):
        """One Adam step on one minibatch at the current learning rate (or
        at ``lr``, which then becomes the current one), then rl_games'
        per-minibatch rate step; returns the loss statistics (total, pg,
        value, entropy, approx KL, clip fraction)."""
        if lr is not None:
            self.lr.fill_(lr)
        self.opt.zero_grad(set_to_none=False)
        total, aux = self.loss(mb, adv_mom)
        total.backward()
        clip_grad_global_norm_(list(self.net.parameters()),
                               self.cfg.max_grad_norm)
        self.opt.step()
        if self.cfg.resolved_lr_mode == "adaptive_kl":
            self.step_lr(aux[3])
        return torch.stack([total.detach()] + [a.detach() for a in aux])

    def train_iteration(self, es: EnvState, gen: torch.Generator
                        ) -> Tuple[EnvState, Dict[str, torch.Tensor]]:
        cfg, env = self.cfg, self.env
        self.set_iteration_lr()

        # ---- rollout ----
        traj = []
        obs, done, tdone = self.next_obs, self.next_done, self.next_true_done
        obs_rms = self.obs_rms
        for _ in range(cfg.num_steps):
            with torch.no_grad():
                mean, log_std, value = self.net(obs)
                action, logp = networks.sample_action(mean, log_std, gen)
            es, next_obs_raw, reward, next_done, time_out = env.step(
                es, action, gen)
            if cfg.value_bootstrap:
                # a step cut off by the time limit keeps gamma V(s) of the
                # return it would have had (rl_games, cat_common.py:62-67)
                reward = reward + cfg.gamma * value * time_out.float()
            traj.append((obs, action, logp, value, reward, done, tdone))
            obs_rms = rms_update(obs_rms, next_obs_raw)
            obs = rms_normalize(obs_rms, next_obs_raw)
            done, tdone = next_done, time_out.float()
        self.obs_rms = obs_rms
        self.next_obs, self.next_done, self.next_true_done = obs, done, tdone
        b_obs, b_act, b_logp, b_val, b_rew, b_done, b_tdone = (
            torch.stack(x) for x in zip(*traj))

        # ---- dual-done GAE ----
        with torch.no_grad():
            next_value = self.net(obs)[2]
        adv = gae(b_rew, b_val, b_done, b_tdone, next_value, done, tdone,
                  cfg.gamma, cfg.gae_lambda)
        returns = adv + b_val

        nb = cfg.num_steps * obs.shape[0]
        b_obs = b_obs.reshape(nb, -1)
        b_act = b_act.reshape(nb, -1)
        b_logp, b_adv = b_logp.reshape(nb), adv.reshape(nb)
        b_ret, b_vals = returns.reshape(nb), b_val.reshape(nb)

        es, ep_metrics = env.drain_metrics(es)
        mean_reward, mean_done = torch.mean(b_rew), torch.mean(b_done)

        # ---- value / return normalisation, in sequence ----
        self.value_rms = rms_merge_moments(self.value_rms, *rms_moments(b_vals))
        b_vals = rms_normalize(self.value_rms, b_vals)
        self.value_rms = rms_merge_moments(self.value_rms, *rms_moments(b_ret))
        b_ret = rms_normalize(self.value_rms, b_ret)

        # ---- minibatch SGD ----
        n_mb = nb // cfg.minibatch_size
        if n_mb == 0:
            raise ValueError(f"minibatch_size {cfg.minibatch_size} exceeds "
                             f"the batch of {nb} samples")
        data = (b_obs, b_act, b_logp, b_adv, b_ret, b_vals)
        stats = []
        for _ in range(cfg.updates_epochs):
            perm = torch.randperm(nb, generator=gen, device=b_obs.device)
            pdata = [x[perm] for x in data]
            adv_mb = pdata[3][:n_mb * cfg.minibatch_size].reshape(
                n_mb, cfg.minibatch_size)
            adv_moms = torch.stack([torch.mean(adv_mb, dim=1),
                                    torch.mean(torch.square(adv_mb), dim=1)],
                                   dim=1)
            epoch = torch.stack([
                self.sgd_step([x[i * cfg.minibatch_size:
                                 (i + 1) * cfg.minibatch_size] for x in pdata],
                              adv_moms[i])
                for i in range(n_mb)])
            if cfg.resolved_lr_mode == "adaptive_kl_epoch":
                self.step_lr(torch.mean(epoch[:, 4]))   # the epoch's mean KL
            stats.append(epoch)
        stats = torch.mean(torch.cat(stats), dim=0)
        self.iteration += 1
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
        return es, metrics
