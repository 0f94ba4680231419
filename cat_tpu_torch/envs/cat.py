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
themselves, or a column block its own function computes and hands them;
``column_table`` describes each column of those terms, as ``env_terms``
reads it.
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
# the kinds that read report slots' force-history norms
_HIST = (C.contact, C.n_foot_contact, C.foot_contact_force)
MAX_SLOTS = 64   # report slots env_terms stages: a 64-bit mask of them


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
                             else len(term_ids))
                # a count over repeated slots: not a mask of them
                or (t.func is C.n_foot_contact
                    and len(set(term_ids.tolist())) != len(term_ids))):
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


class ColumnTable(NamedTuple):
    """The raw columns as ``env_terms`` computes them, one row a column
    (the terms' spans in order): ``ints`` (K, 3) int32 (kind, a, b),
    ``floats`` (K, 2) float32 (its term's two floats), ``slots`` the
    report slots whose force-history norms the kernel computes once an
    env, ascending, and ``illegal`` the illegal-contact slots as places in
    ``slots``. a and b by kind: a joint position (``joint_position``,
    ``..._when_moving_forward``, ``joint_range``): 7 + its model joint
    (its place in qpos) and its task joint (the default position's);
    torque and acceleration: the model joint; velocity and ``no_move``: 6
    + the model joint (qvel); ``action_rate``: the task joint;
    ``air_time``: the foot; ``foot_contact_force``: the slot's place in
    ``slots``; ``contact`` and ``n_foot_contact``: the places of their
    slots as a 64-bit mask, low word in a, high word in b; a given
    column: its column in the given block; the rest: 0."""
    ints: np.ndarray
    floats: np.ndarray
    slots: np.ndarray
    illegal: np.ndarray


def column_table(descriptors: TermTable, t2m, illegal=()) -> ColumnTable:
    """``ColumnTable`` of the terms ``descriptors`` describes, for the
    task-to-model joint map ``t2m`` and the illegal-contact report slots
    ``illegal``."""
    t2m = np.asarray(t2m, np.int64).reshape(-1)
    rows = [(r, f) for r, f in zip(descriptors.ints, descriptors.floats)]
    hist = {k for k, (f, _, _) in enumerate(KERNEL_TERMS) if f in _HIST}
    slots = sorted({int(i) for i in np.asarray(illegal).reshape(-1)}
                   | {int(i) for (kind, _, _, first, nids), _ in rows
                      if kind in hist
                      for i in descriptors.ids[first:first + nids]})
    if len(slots) > MAX_SLOTS:
        raise ValueError(f"{len(slots)} report slots read: env_terms "
                         f"stages at most {MAX_SLOTS}")
    place = {s: k for k, s in enumerate(slots)}
    kinds = {f: k for k, (f, _, _) in enumerate(KERNEL_TERMS)}
    joint_q = {kinds[f] for f in (C.joint_position, C.joint_range,
                                  C.joint_position_when_moving_forward)}
    joint_v = {kinds[f] for f in (C.joint_velocity, C.no_move)}
    joint = {kinds[f] for f in (C.joint_torque, C.joint_acceleration)}
    one = {kinds[f] for f in _ONE_COLUMN}
    ints, floats = [], []
    for (kind, _, nc, first, nids), vals in rows:
        ids = [int(i) for i in descriptors.ids[first:first + nids]]
        for c in range(nc):
            if kind == GIVEN:
                a, b = first + c, 0
            elif kind in one:
                mask = sum(1 << place[i] for i in set(ids))
                a, b = np.array([mask & 0xffffffff, mask >> 32],
                                np.uint32).view(np.int32)
            elif not ids:
                a = b = 0
            elif kind in joint_q:
                a, b = 7 + int(t2m[ids[c]]), ids[c]
            elif kind in joint_v:
                a, b = 6 + int(t2m[ids[c]]), 0
            elif kind in joint:
                a, b = int(t2m[ids[c]]), 0
            elif kind == kinds[C.foot_contact_force]:
                a, b = place[ids[c]], 0
            else:       # action_rate's task joint, air_time's foot
                a, b = ids[c], 0
            ints.append([kind, int(a), int(b)])
            floats.append(vals)
    return ColumnTable(np.asarray(ints, np.int32).reshape(-1, 3),
                       np.asarray(floats, np.float32).reshape(-1, 2),
                       np.asarray(slots, np.int32),
                       np.asarray([place[int(i)] for i in np.asarray(
                           illegal).reshape(-1)], np.int32))


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
        """(ints of ``descriptors``, is_cur as uint8) on the set's device,
        made once: a CUDA graph's capture may copy nothing from the host.
        The kernels read each column's ids from ``column_table``."""
        if not self._device_table:
            self._device_table.update(
                ints=torch.as_tensor(self.descriptors.ints,
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
