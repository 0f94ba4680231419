"""Running mean / variance (port of cat_tpu/rl/normalize.py): Welford
pooling of batch moments, count starting at 1 with unit variance."""

from __future__ import annotations

from typing import NamedTuple

import torch


class RmsState(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor


def rms_init(shape=(), device="cpu") -> RmsState:
    return RmsState(mean=torch.zeros(shape, device=device),
                    var=torch.ones(shape, device=device),
                    count=torch.ones((), device=device))


def rms_moments(x: torch.Tensor):
    """(sum x, sum x^2, count) over the leading axis."""
    n = torch.full((), float(x.shape[0]), device=x.device)
    return torch.sum(x, dim=0), torch.sum(torch.square(x), dim=0), n


def rms_merge_moments(state: RmsState, s1, s2, n) -> RmsState:
    """Welford merge of a batch given its raw moments."""
    batch_mean = s1 / n
    batch_var = s2 / n - torch.square(batch_mean)
    delta = batch_mean - state.mean
    tot = state.count + n
    m2 = (state.var * state.count + batch_var * n
          + torch.square(delta) * state.count * n / tot)
    return RmsState(mean=state.mean + delta * n / tot, var=m2 / tot, count=tot)


def rms_update(state: RmsState, x: torch.Tensor) -> RmsState:
    return rms_merge_moments(state, *rms_moments(x))


def rms_stats(state: RmsState):
    """The raw moments (sum x, sum x^2, count) a state has pooled: the
    inverse of ``rms_merge_moments``, from which moment deltas since an
    earlier state are formed."""
    s1 = state.mean * state.count
    s2 = (state.var + torch.square(state.mean)) * state.count
    return s1, s2, state.count


def rms_normalize(state: RmsState, x: torch.Tensor, eps: float = 1e-8):
    return (x - state.mean) / torch.sqrt(state.var + eps)
