"""Actor-critic networks (port of cat_tpu/rl/networks.py): separate actor
and critic MLPs 512-256-128 with ELU, orthogonal init (sqrt(2) hidden,
0.01 action head, 1.0 value head), zero biases, a state-independent
log-std initialised to 0."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn


class MLP(nn.Module):
    def __init__(self, in_dim: int, hidden: Sequence[int], out_dim: int,
                 out_gain: float, generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [in_dim, *hidden, out_dim]
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        for i, layer in enumerate(self.layers):
            gain = out_gain if i == len(self.layers) - 1 else math.sqrt(2.0)
            nn.init.orthogonal_(layer.weight, gain=gain, generator=generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = nn.functional.elu(layer(x))
        return self.layers[-1](x)


class ActorCritic(nn.Module):
    def __init__(self, num_obs: int, num_actions: int,
                 hidden: Sequence[int] = (512, 256, 128),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.actor = MLP(num_obs, hidden, num_actions, 0.01, generator)
        self.critic = MLP(num_obs, hidden, 1, 1.0, generator)
        self.log_std = nn.Parameter(torch.zeros(num_actions))

    def forward(self, obs) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(mean, log_std, value)."""
        return self.actor(obs), self.log_std, self.critic(obs)[..., 0]


def gaussian_logp(mean, log_std, action) -> torch.Tensor:
    logp = (-0.5 * torch.square((action - mean) / torch.exp(log_std))
            - log_std - 0.5 * math.log(2.0 * math.pi))
    return torch.sum(logp, dim=-1)


def gaussian_entropy(log_std, like: torch.Tensor) -> torch.Tensor:
    ent = torch.sum(log_std + 0.5 * math.log(2.0 * math.pi * math.e))
    return ent.expand(like.shape[:-1])


def sample_action(mean, log_std, generator: torch.Generator):
    """Sample the diagonal Gaussian; returns (action, log_prob)."""
    eps = torch.randn(mean.shape, generator=generator, device=mean.device)
    action = mean + torch.exp(log_std) * eps
    return action, gaussian_logp(mean, log_std, action)
