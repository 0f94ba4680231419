"""The env axis's collectives and the split of the training state (port of
cat_tpu/parallel/mesh.py).

Torch has no mesh: the env batch is split over the processes of a
``DistContext``'s group, and every collective here is one
``all_reduce(SUM)`` or ``broadcast`` on that group. Those two alone carry
the reference's whole iteration (its psum / pmean; the max-reductions
finish locally on a summed one-hot table), so the same code runs under NCCL
across cards and under gloo on the CPU or with several processes sharing
one card.

The state splits BY NAME into env-batched leaves (a row an env; each rank
holds its own rows) and replicated ones (equal on every rank), as the
reference's ``_BATCHED_TS_FIELDS``: a parameter whose width happens to
equal the env count is never taken for a batch of envs.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as tdist

from cat_tpu_torch.envs.types import EnvState

# the learner's rollout carry has a row an env; its network, Adam state,
# normalisers and counters are replicated
BATCHED_PPO_FIELDS = frozenset(["next_obs", "next_done", "next_true_done"])
# EnvState: ``sim`` and these fields have a row an env; the CaT running
# maxes and caps, the step counter and the drained accumulators do not
BATCHED_ENV_FIELDS = frozenset([
    "sim", "action", "prev_action", "episode_len", "command",
    "command_time_left", "mu", "com_offset", "episode_viol", "episode_prob",
    "episode_rew", "origin", "terrain_row", "terrain_col"])
REPLICATED_ENV_FIELDS = frozenset([
    "running_max", "max_p", "common_step", "acc_viol", "acc_prob", "acc_rew",
    "acc_len", "acc_count", "acc_term"])
assert BATCHED_ENV_FIELDS | REPLICATED_ENV_FIELDS == set(EnvState._fields)
assert not BATCHED_ENV_FIELDS & REPLICATED_ENV_FIELDS


def is_batched(name: str) -> bool:
    """Whether the checkpoint leaf ``name`` ("ppo.<field>...",
    "env.<field>...", as ``rl/checkpoint.flatten`` names them) has a row
    an env."""
    part, _, rest = name.partition(".")
    field = rest.split(".")[0]
    if part == "ppo":
        return field in BATCHED_PPO_FIELDS
    return part == "env" and field in BATCHED_ENV_FIELDS


def _comm(t: torch.Tensor, dist) -> torch.Tensor:
    """``t`` where the group's backend takes it: NCCL only reduces tensors
    on the card, gloo takes both."""
    if t.device.type == "cpu" and tdist.get_backend(dist.group) == "nccl":
        return t.to(dist.device)
    return t


def all_sum_(flat: torch.Tensor, dist) -> torch.Tensor:
    """Sum ``flat`` over the ranks, in place (one ``all_reduce``)."""
    tdist.all_reduce(flat, op=tdist.ReduceOp.SUM, group=dist.group)
    return flat


def all_mean_(flat: torch.Tensor, dist) -> torch.Tensor:
    """Average ``flat`` over the ranks, in place (one ``all_reduce``)."""
    return all_sum_(flat, dist).div_(dist.world_size)


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], src: int, dist):
    """Overwrite ``tensors`` (one dtype, one device) with rank ``src``'s,
    in one ``broadcast``."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    tdist.broadcast(flat, src, group=dist.group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def gather_rows(t: torch.Tensor, dist) -> torch.Tensor:
    """Every rank's rows of ``t`` in rank order (rank r's rows at [r n,
    (r + 1) n)), on every rank, bit for bit: each rank broadcasts its rows
    in turn (a zero-padded sum would turn -0.0 into +0.0)."""
    if t.dtype == torch.bool:
        return gather_rows(t.view(torch.uint8), dist).view(torch.bool)
    parts = []
    for r in range(dist.world_size):
        buf = _comm(t.contiguous() if r == dist.rank else torch.empty_like(t),
                    dist)
        tdist.broadcast(buf, r, group=dist.group)
        parts.append(buf.to(t.device))
    return torch.cat(parts)
