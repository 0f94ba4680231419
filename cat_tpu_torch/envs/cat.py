"""The CaT transform: constraint violations -> termination probabilities
(port of cat_tpu/envs/cat.py).

  per column k:  m_k     = max over envs of c_k, clamped >= 1e-6
                 rmax_k <- tau rmax_k + (1 - tau) m_k,  tau = 0.95
                 p_k     = min_p + clip(c_k / rmax_k, 0, 1) (max_p - min_p)
                           where c_k > 0, else 0
  cstr_prob    = max over all columns of p
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .types import StepData

TAU = 0.95
MIN_P = 0.0


class ConstraintTerm(NamedTuple):
    name: str
    func: Callable[..., torch.Tensor]
    params: Dict[str, Any]
    max_p: float
    curriculum: bool  # whether the curriculum anneals this term


def _as_2d(x: torch.Tensor) -> torch.Tensor:
    return x[:, None] if x.dim() == 1 else x


class ConstraintSet:
    """Resolved constraint manager: index arrays moved to the device once,
    the column layout found by evaluating each term on a probe batch."""

    def __init__(self, terms: Sequence[ConstraintTerm], probe: StepData,
                 device):
        self.device = torch.device(device)
        self.terms = tuple(
            t._replace(params={
                k: (torch.as_tensor(v, dtype=torch.long, device=self.device)
                    if isinstance(v, np.ndarray) else v)
                for k, v in t.params.items()
            })
            for t in terms
        )
        self.slices: list[Tuple[int, int]] = []
        start = 0
        for t in self.terms:
            k = _as_2d(t.func(probe, **t.params)).shape[1]
            self.slices.append((start, start + k))
            start += k
        self.total_cols = start
        self._col_term = torch.tensor(
            [i for i, (a, b) in enumerate(self.slices) for _ in range(b - a)],
            device=self.device)
        self._init_max_p = torch.tensor([t.max_p for t in self.terms],
                                        dtype=torch.float32, device=self.device)
        self._is_cur = torch.tensor([t.curriculum for t in self.terms],
                                    device=self.device)

    @property
    def n_terms(self) -> int:
        return len(self.terms)

    def init_max_p(self) -> torch.Tensor:
        return self._init_max_p.clone()

    def init_running_max(self) -> torch.Tensor:
        # -1 marks a column not yet seeded: the first observed cross-env max
        # seeds it instead of a polyak blend from scratch
        return torch.full((self.total_cols,), -1.0, device=self.device)

    def curriculum_max_p(self, common_step, num_steps: int) -> torch.Tensor:
        """Anneal of the soft terms' max_p: 1 / (20 + progress (1/max_p0 -
        20)); other terms keep their configured max_p. ``common_step`` is
        the () int32 step counter (an int works too); the progress is
        computed on its device in float32, as the reference does
        (cat_tpu/envs/cat.py:160), so a CUDA graph does not freeze it."""
        progress = torch.clamp(torch.as_tensor(
            common_step, device=self.device).float() / num_steps, max=1.0)
        t_end = 1.0 / torch.clamp(self._init_max_p, min=1e-6)
        annealed = 1.0 / (20.0 + progress * (t_end - 20.0))
        return torch.where(self._is_cur, annealed, self._init_max_p)

    def compute(self, data: StepData, running_max: torch.Tensor,
                max_p: torch.Tensor):
        """Returns (cstr_prob (N,), new_running_max, term_max_probs
        (N, n_terms), violating (N, n_terms) bool)."""
        raw = torch.cat([_as_2d(t.func(data, **t.params)) for t in self.terms],
                        dim=1)
        cmax = torch.clamp(torch.amax(raw, dim=0), min=1e-6)
        new_rmax = torch.where(running_max < 0.0, cmax,
                               TAU * running_max + (1.0 - TAU) * cmax)
        col_max_p = max_p[self._col_term]
        probs = torch.where(
            raw > 0.0,
            MIN_P + torch.clamp(raw / new_rmax, 0.0, 1.0) * (col_max_p - MIN_P),
            0.0,
        )
        term_max = torch.stack(
            [torch.amax(probs[:, a:b], dim=1) for a, b in self.slices], dim=1)
        return torch.amax(probs, dim=1), new_rmax, term_max, term_max > 0.0

    def table(self) -> str:
        """Startup dump of the resolved terms."""
        rows = [("Index", "Name", "max_p", "Curriculum", "Columns")]
        for i, (t, (a, b)) in enumerate(zip(self.terms, self.slices)):
            rows.append((str(i), t.name, f"{t.max_p:g}",
                         "yes" if t.curriculum else "no", str(b - a)))
        widths = [max(len(r[c]) for r in rows) for c in range(5)]
        sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        out = ["Active Constraint Terms (shown in order of calculation):", sep]
        for j, r in enumerate(rows):
            out.append("| " + " | ".join(v.ljust(w) for v, w in zip(r, widths))
                       + " |")
            if j == 0:
                out.append(sep)
        out.append(sep)
        return "\n".join(out)
