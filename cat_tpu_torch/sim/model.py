"""Static robot model: a frozen container of numpy arrays (the port's copy of
cat_tpu/sim/model.py, reduced to what the training path reads).

Bodies 0..nbody-1 in topological order, body 0 = free-floating base; each
moving body i>=1 has one revolute joint (dof i-1). Generalized coordinates:

  qpos = [base_pos(3), base_quat wxyz(4), q_joints(nj)]      -> nq = 7 + nj
  qvel = [base_linvel_world(3), base_angvel_body(3), qd(nj)] -> nv = 6 + nj

Contact rows: terrain candidates first, then self-collision capsule pairs.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

import numpy as np


def _empty(shape, dtype=np.float64):
    return dataclasses.field(default_factory=lambda: np.zeros(shape, dtype))


@dataclasses.dataclass(frozen=True)
class RobotModel:
    body_names: Tuple[str, ...]
    parent: np.ndarray                   # (nbody,) parent[0] = -1
    joint_pos: np.ndarray                # (nbody, 3) joint origin, parent frame
    joint_rot: np.ndarray                # (nbody, 3, 3)
    joint_axis: np.ndarray               # (nbody, 3) hinge axis, joint frame
    joint_names: Tuple[str, ...]
    mass: np.ndarray                     # (nbody,)
    com: np.ndarray                      # (nbody, 3) body frame
    inertia: np.ndarray                  # (nbody, 3, 3) about com, body frame
    armature: np.ndarray                 # (nj,)
    joint_limit_lower: np.ndarray
    joint_limit_upper: np.ndarray
    effort_limit: np.ndarray
    velocity_limit: np.ndarray
    default_base_pos: np.ndarray         # (3,)
    default_qpos_joints: np.ndarray      # (nj,)
    cand_body: np.ndarray                # (ncand,) body owning the point
    cand_offset: np.ndarray              # (ncand, 3) body frame
    cand_radius: np.ndarray              # (ncand,)
    cand_report: np.ndarray              # (ncand,) index into report_names
    report_names: Tuple[str, ...]
    site_names: Tuple[str, ...]
    site_body: np.ndarray
    site_offset: np.ndarray
    foot_report_ids: np.ndarray          # (nfeet,)
    # self-collision capsule pairs (forces: +f to report_a, -f to report_b)
    pair_body_a: np.ndarray = _empty(0, np.int32)
    pair_p0_a: np.ndarray = _empty((0, 3))
    pair_p1_a: np.ndarray = _empty((0, 3))
    pair_radius_a: np.ndarray = _empty(0)
    pair_body_b: np.ndarray = _empty(0, np.int32)
    pair_p0_b: np.ndarray = _empty((0, 3))
    pair_p1_b: np.ndarray = _empty((0, 3))
    pair_radius_b: np.ndarray = _empty(0)
    pair_report_a: np.ndarray = _empty(0, np.int32)
    pair_report_b: np.ndarray = _empty(0, np.int32)

    @property
    def nbody(self) -> int:
        return len(self.body_names)

    @property
    def nj(self) -> int:
        return self.nbody - 1

    @property
    def nq(self) -> int:
        return 7 + self.nj

    @property
    def nv(self) -> int:
        return 6 + self.nj

    @property
    def ncand(self) -> int:
        """Total contact rows: terrain candidates + self-collision pairs."""
        return len(self.cand_body) + len(self.pair_body_a)

    @property
    def ncand_terrain(self) -> int:
        return len(self.cand_body)

    @property
    def npair(self) -> int:
        return len(self.pair_body_a)

    @property
    def nreport(self) -> int:
        return len(self.report_names)

    def ancestor_mask(self) -> np.ndarray:
        """(nbody, nj) bool: mask[b, d] = joint d is on the chain base->b."""
        nb = self.nbody
        mask = np.zeros((nb, nb - 1), dtype=bool)
        for b in range(1, nb):
            i = b
            while i > 0:
                mask[b, i - 1] = True
                i = int(self.parent[i])
        return mask

    def branches(self):
        """Joint indices grouped by independent branch off the base."""
        body_branch = {0: -1}
        branches: list[list[int]] = []
        for b in range(1, self.nbody):
            p = int(self.parent[b])
            if p == 0:
                body_branch[b] = len(branches)
                branches.append([b - 1])
            else:
                body_branch[b] = body_branch[p]
                branches[body_branch[b]].append(b - 1)
        return branches

    def uniform_3dof_branches(self) -> bool:
        """True if every branch is a contiguous 3-dof chain (quadruped
        legs): the structured mass-matrix inverse applies."""
        br = self.branches()
        return bool(br) and all(
            len(x) == 3 and x == list(range(x[0], x[0] + 3)) for x in br
        )

    def default_qpos(self) -> np.ndarray:
        q = np.zeros(self.nq, dtype=np.float64)
        q[0:3] = self.default_base_pos
        q[3] = 1.0
        q[7:] = self.default_qpos_joints
        return q

    @staticmethod
    def from_json(s: str) -> "RobotModel":
        raw = json.loads(s)
        kw = {}
        for f in dataclasses.fields(RobotModel):
            if f.name not in raw:
                continue
            v = raw[f.name]
            if isinstance(v, dict) and "__nd__" in v:
                kw[f.name] = np.array(v["__nd__"], dtype=v["dtype"])
            else:
                kw[f.name] = tuple(v)
        return RobotModel(**kw)

    def with_self_collision_pairs(self, specs) -> "RobotModel":
        """Copy with capsule pairs attached; bodies referenced by NAME,
        endpoints in body frame, report slots default to the body's own."""
        names = list(self.body_names)
        rnames = list(self.report_names)
        specs = list(specs)

        def rep(spec, side):
            return rnames.index(spec.get(f"report_{side}", spec[f"body_{side}"]))

        def pts(key):
            return np.array([s[key] for s in specs], dtype=np.float64
                            ).reshape(-1, 3)

        return dataclasses.replace(
            self,
            pair_body_a=np.array([names.index(s["body_a"]) for s in specs],
                                 dtype=np.int32),
            pair_p0_a=pts("p0_a"), pair_p1_a=pts("p1_a"),
            pair_radius_a=np.array([s["radius_a"] for s in specs]),
            pair_body_b=np.array([names.index(s["body_b"]) for s in specs],
                                 dtype=np.int32),
            pair_p0_b=pts("p0_b"), pair_p1_b=pts("p1_b"),
            pair_radius_b=np.array([s["radius_b"] for s in specs]),
            pair_report_a=np.array([rep(s, "a") for s in specs],
                                   dtype=np.int32),
            pair_report_b=np.array([rep(s, "b") for s in specs],
                                   dtype=np.int32),
        )
