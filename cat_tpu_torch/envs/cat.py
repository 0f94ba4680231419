"""The CaT transform: constraint violations -> termination probabilities
(port of cat_tpu/envs/cat.py).

  per column k:  m_k     = max over envs of c_k, clamped >= 1e-6
                 rmax_k <- tau rmax_k + (1 - tau) m_k,  tau = 0.95
                 p_k     = min_p + clip(c_k / rmax_k, 0, 1) (max_p - min_p)
                           where c_k > 0, else 0
  cstr_prob    = max over all columns of p

The env step computes the raw columns and their maxima first (``raw``,
``column_max``), then the transform (``transform``); ``compute`` is the
two. ``term_table`` describes each term to the env kernels
(``ops/env_step.py``): one of ``KERNEL_TERMS``, which they compute
themselves, or a column block its own function computes and hands them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import constraints as C
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


# The term functions of ``envs/constraints.py`` the env kernels compute
# themselves (csrc/env_model.cuh ``TermKind``, in this order): for each,
# its float parameters, in the order the kernels read them, and the name of
# its index parameter (None: it has none)
KERNEL_TERMS = (
    (C.joint_position, ("limit",), "joint_ids"),
    (C.joint_position_when_moving_forward, ("limit", "velocity_deadzone"),
     "joint_ids"),
    (C.joint_torque, ("limit",), "joint_ids"),
    (C.joint_velocity, ("limit",), "joint_ids"),
    (C.joint_acceleration, ("limit",), "joint_ids"),
    (C.upsidedown, ("limit",), None),
    (C.contact, (), "body_ids"),
    (C.base_orientation, ("limit",), None),
    (C.air_time, ("limit", "velocity_deadzone"), "body_ids"),
    (C.n_foot_contact, ("number_of_desired_feet", "min_command_value"),
     "body_ids"),
    (C.joint_range, ("limit",), "joint_ids"),
    (C.action_rate, ("limit",), "joint_ids"),
    (C.foot_contact_force, ("limit",), "body_ids"),
    (C.min_base_height, ("limit",), None),
    (C.no_move, ("joint_vel_limit", "velocity_deadzone"), "joint_ids"),
)
GIVEN = -1       # a term whose own function computes its columns
TERM_INTS = 5    # kind, first column, columns, first id or given column, ids
# the kinds with one column whatever their ids (the others: a column an id)
_ONE_COLUMN = (C.contact, C.n_foot_contact)


class TermTable(NamedTuple):
    """The terms as the env kernels read them: ``ints`` (n_terms, 5) int32
    (kind, first column, columns, the offset of its ids in ``ids`` or,
    for a given term, of its first column in the given block, and how many
    ids), ``floats`` (n_terms, 2) float32, ``ids`` int32, and ``given``,
    the terms computed by their own function, in order: their columns, in
    that order, are the given block."""
    ints: np.ndarray
    floats: np.ndarray
    ids: np.ndarray
    given: Tuple[int, ...]


def _is_number(v) -> bool:
    return isinstance(v, (int, float, np.integer, np.floating)) and not \
        isinstance(v, bool)


def term_table(terms: Sequence[ConstraintTerm], slices) -> TermTable:
    """Each term's kind (its place in ``KERNEL_TERMS``, or ``GIVEN`` for a
    function not there, or one whose parameters are not the kind's numbers
    and ids), column span, float parameters and ids."""
    kinds = {f: (k, names, idx) for k, (f, names, idx) in
             enumerate(KERNEL_TERMS)}
    ints, floats, ids, given = [], [], [], []
    n_given = 0
    for i, (t, (a, b)) in enumerate(zip(terms, slices)):
        kind, names, idx = kinds.get(t.func, (GIVEN, (), None))
        term_ids = (np.asarray(t.params.get(idx, ())).reshape(-1)
                    if idx is not None else np.zeros(0, np.int64))
        if kind != GIVEN and (
                set(t.params) != set(names) | ({idx} - {None})
                or not all(_is_number(t.params[p]) for p in names)
                or not np.issubdtype(term_ids.dtype, np.integer)
                or b - a != (1 if idx is None or t.func in _ONE_COLUMN
                             else len(term_ids))):
            kind = GIVEN
        vals = [0.0, 0.0]
        if kind == GIVEN:
            given.append(i)
            ints.append([kind, a, b - a, n_given, 0])
            n_given += b - a
        else:
            vals[:len(names)] = [float(t.params[p]) for p in names]
            ints.append([kind, a, b - a, len(ids), len(term_ids)])
            ids.extend(int(j) for j in term_ids)
        floats.append(vals)
    return TermTable(np.asarray(ints, np.int32).reshape(-1, TERM_INTS),
                     np.asarray(floats, np.float32).reshape(-1, 2),
                     np.asarray(ids, np.int32), tuple(given))


class ConstraintSet:
    """Resolved constraint manager: index arrays moved to the device once,
    the column layout found by evaluating each term on a probe batch."""

    def __init__(self, terms: Sequence[ConstraintTerm], probe: StepData,
                 device):
        self.device = torch.device(device)
        host_terms = tuple(terms)
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
        self.descriptors = term_table(host_terms, self.slices)
        self._device_table = {}

    def device_table(self):
        """(ints, floats, ids, is_cur as uint8) of ``descriptors`` on the set's
        device, made once: a CUDA graph's capture may copy nothing from the
        host."""
        if not self._device_table:
            t = self.descriptors
            self._device_table.update(
                ints=torch.as_tensor(t.ints, device=self.device),
                floats=torch.as_tensor(t.floats, device=self.device),
                ids=torch.as_tensor(np.append(t.ids, 0).astype(np.int32),
                                    device=self.device),
                is_cur=self._is_cur.to(torch.uint8))
        return self._device_table

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

    def raw(self, data: StepData, terms=None) -> torch.Tensor:
        """(N, columns) raw violations of ``terms`` (default: every term),
        in column order."""
        return torch.cat([_as_2d(t.func(data, **t.params)) for t in (
            self.terms if terms is None else terms)], dim=1)

    @staticmethod
    def column_max(raw: torch.Tensor) -> torch.Tensor:
        """Each column's maximum over envs, at least 1e-6."""
        return torch.clamp(torch.amax(raw, dim=0), min=1e-6)

    def compute(self, data: StepData, running_max: torch.Tensor,
                max_p: torch.Tensor):
        """Returns (cstr_prob (N,), new_running_max, term_max_probs
        (N, n_terms), violating (N, n_terms) bool)."""
        raw = self.raw(data)
        return self.transform(raw, self.column_max(raw), running_max, max_p)

    def transform(self, raw: torch.Tensor, cmax: torch.Tensor,
                  running_max: torch.Tensor, max_p: torch.Tensor):
        """``compute`` from the raw columns and their maxima ``cmax``."""
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
