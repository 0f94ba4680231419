"""URDF -> RobotModel compiler, the offline asset pipeline (the port's copy of
cat_tpu/sim/urdf.py).

Fixed-joint children are merged into their parent for dynamics (inertia by
the parallel-axis rule), but kept as named sites at the child frame, and
their collision geoms become contact candidates that report under the
ORIGINAL link name (so e.g. FL_FOOT contact forces stay separately
observable, as the reference's contact sensor reports them). Spheres are
one candidate, cylinders two end spheres, boxes eight zero-radius corners;
meshes are visual only and skipped.

It runs once, on the host, in numpy: no tensor is involved. It keeps the
reference's numpy calls in the reference's order (``X + R @ link.com``,
``R @ I @ R.T``, ``axis / np.linalg.norm(axis)``, ``math.cos`` /
``math.sin`` for the rpy matrices, the parallel-axis sum of
``combine_inertia``), so the floats are bit-equal and ``to_json`` is byte
for byte the reference's. A rewrite in torch, or any reordered sum, breaks
that.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cat_tpu_torch.sim.model import RobotModel, combine_inertia


def _rpy_to_mat(rpy: Sequence[float]) -> np.ndarray:
    r, p, y = rpy
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _parse_origin(elem) -> Tuple[np.ndarray, np.ndarray]:
    """(xyz, R) of ``elem``'s ``<origin>`` child; zeros and I without one."""
    xyz = np.zeros(3)
    rpy = np.zeros(3)
    o = elem.find("origin")
    if o is not None:
        if o.get("xyz"):
            xyz = np.array([float(x) for x in o.get("xyz").split()])
        if o.get("rpy"):
            rpy = np.array([float(x) for x in o.get("rpy").split()])
    return xyz, _rpy_to_mat(rpy)


class _Link:
    def __init__(self, elem):
        self.name = elem.get("name")
        self.mass = 0.0
        self.com = np.zeros(3)
        self.inertia = np.zeros((3, 3))
        inertial = elem.find("inertial")
        if inertial is not None:
            self.com, _ = _parse_origin(inertial)
            m = inertial.find("mass")
            self.mass = float(m.get("value")) if m is not None else 0.0
            it = inertial.find("inertia")
            if it is not None:
                ixx, iyy, izz, ixy, ixz, iyz = (
                    float(it.get(k, 0))
                    for k in ("ixx", "iyy", "izz", "ixy", "ixz", "iyz"))
                self.inertia = np.array(
                    [[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
        # collision geoms: (kind, origin xyz, origin R, params)
        self.geoms: List[Tuple[str, np.ndarray, np.ndarray,
                               Tuple[float, ...]]] = []
        for col in elem.findall("collision"):
            xyz, R = _parse_origin(col)
            geo = col.find("geometry")
            if geo is None:
                continue
            if geo.find("sphere") is not None:
                r = float(geo.find("sphere").get("radius"))
                self.geoms.append(("sphere", xyz, R, (r,)))
            elif geo.find("cylinder") is not None:
                c = geo.find("cylinder")
                self.geoms.append(
                    ("cylinder", xyz, R,
                     (float(c.get("radius")), float(c.get("length")))))
            elif geo.find("box") is not None:
                size = [float(x) for x in geo.find("box").get("size").split()]
                self.geoms.append(("box", xyz, R, tuple(size)))


class _Joint:
    def __init__(self, elem):
        self.name = elem.get("name")
        self.type = elem.get("type")
        self.parent = elem.find("parent").get("link")
        self.child = elem.find("child").get("link")
        self.xyz, self.R = _parse_origin(elem)
        ax = elem.find("axis")
        self.axis = (np.array([float(x) for x in ax.get("xyz").split()])
                     if ax is not None else np.array([1.0, 0.0, 0.0]))
        lim = elem.find("limit")

        def limit(key, default):
            return float(lim.get(key, default)) if lim is not None else default

        self.lower, self.upper = limit("lower", -1e9), limit("upper", 1e9)
        self.effort = limit("effort", 1e9)
        self.velocity = limit("velocity", 1e9)


def compile_urdf(
    urdf_path: str,
    *,
    root_link: Optional[str] = None,
    armature: float = 0.0,
    effort_limit: Optional[float] = None,
    velocity_limit: Optional[float] = None,
    default_joint_pos: Optional[Dict[str, float]] = None,
    default_base_pos: Sequence[float] = (0.0, 0.0, 0.0),
) -> RobotModel:
    """Compile a URDF file into a RobotModel.

    The armature, effort and velocity overrides take precedence over the
    URDF's limits, as an actuator config does (Solo12: armature 3.6207e-4,
    effort 10, velocity 100 against the URDF's effort 3, velocity 20).
    """
    robot = ET.parse(urdf_path).getroot()
    links = {l.get("name"): _Link(l) for l in robot.findall("link")}
    joints = [_Joint(j) for j in robot.findall("joint")]

    children: Dict[str, List[_Joint]] = {}
    child_set = set()
    for j in joints:
        children.setdefault(j.parent, []).append(j)
        child_set.add(j.child)
    if root_link is None:
        roots = [n for n in links if n not in child_set]
        if len(roots) != 1:   # the reference's assertion, kept under -O
            raise AssertionError(f"ambiguous root links: {roots}")
        root_link = roots[0]

    # Depth first over the revolute joints; a fixed joint merges its child
    # subtree into the current dynamic body.
    body_names: List[str] = [root_link]
    parent_idx: List[int] = [-1]
    joint_pos: List[np.ndarray] = [np.zeros(3)]
    joint_rot: List[np.ndarray] = [np.eye(3)]
    joint_axis: List[np.ndarray] = [np.zeros(3)]
    joint_names: List[str] = []
    limits: List[Tuple[float, float, float, float]] = []
    mass: List[float] = []
    com: List[np.ndarray] = []
    inertia: List[np.ndarray] = []
    site_names: List[str] = []
    site_body: List[int] = []
    site_offset: List[np.ndarray] = []
    # (body, kind, xyz, R, params, report link name)
    geom_entries: List[Tuple[int, str, np.ndarray, np.ndarray,
                             Tuple[float, ...], str]] = []

    def add_link_content(body_i: int, link: _Link, X: np.ndarray,
                         R: np.ndarray):
        """Fold the link's inertia and geoms, posed at (X, R) in the body's
        frame, into the body."""
        m2 = link.mass
        com2 = X + R @ link.com
        I2 = R @ link.inertia @ R.T
        m1, c1, I1 = mass[body_i], com[body_i], inertia[body_i]
        if m1 + m2 > 0:
            mass[body_i], com[body_i], inertia[body_i] = combine_inertia(
                m1, c1, I1, m2, com2, I2)
        for kind, gxyz, gR, params in link.geoms:
            geom_entries.append(
                (body_i, kind, X + R @ gxyz, R @ gR, params, link.name))

    def new_body():
        mass.append(0.0)
        com.append(np.zeros(3))
        inertia.append(np.zeros((3, 3)))

    def visit(link_name: str, body_i: int):
        for j in children.get(link_name, []):
            if j.type in ("revolute", "continuous"):
                bi = len(body_names)
                body_names.append(j.child)
                parent_idx.append(body_i)
                joint_pos.append(j.xyz)
                joint_rot.append(j.R)
                joint_axis.append(j.axis / np.linalg.norm(j.axis))
                joint_names.append(j.name)
                limits.append((j.lower, j.upper, j.effort, j.velocity))
                new_body()
                add_link_content(bi, links[j.child], np.zeros(3), np.eye(3))
                visit(j.child, bi)
            elif j.type == "fixed":
                # merge the subtree into body_i; a site at each child frame
                def merge(jj: _Joint, X: np.ndarray, R: np.ndarray):
                    X2 = X + R @ jj.xyz
                    R2 = R @ jj.R
                    site_names.append(jj.child)
                    site_body.append(body_i)
                    site_offset.append(X2)
                    add_link_content(body_i, links[jj.child], X2, R2)
                    for j3 in children.get(jj.child, []):
                        if j3.type != "fixed":
                            raise AssertionError(
                                "revolute below fixed joint unsupported")
                        merge(j3, X2, R2)
                merge(j, np.zeros(3), np.eye(3))
            else:
                raise ValueError(f"unsupported joint type {j.type}")

    new_body()
    add_link_content(0, links[root_link], np.zeros(3), np.eye(3))
    visit(root_link, 0)

    # contact candidates from the geoms
    report_names: List[str] = []
    cand_body: List[int] = []
    cand_offset: List[np.ndarray] = []
    cand_radius: List[float] = []
    cand_report: List[int] = []

    def add_cand(body_i, offset, radius, rid):
        cand_body.append(body_i)
        cand_offset.append(offset)
        cand_radius.append(radius)
        cand_report.append(rid)

    for body_i, kind, X, R, params, link_name in geom_entries:
        if link_name not in report_names:
            report_names.append(link_name)
        rid = report_names.index(link_name)
        if kind == "sphere":
            add_cand(body_i, X, params[0], rid)
        elif kind == "cylinder":
            r, L = params
            for s in (-0.5, 0.5):
                add_cand(body_i, X + R @ np.array([0.0, 0.0, s * L]), r, rid)
        elif kind == "box":
            sx, sy, sz = params
            for cx in (-0.5, 0.5):
                for cy in (-0.5, 0.5):
                    for cz in (-0.5, 0.5):
                        add_cand(body_i, X + R @ np.array(
                            [cx * sx, cy * sy, cz * sz]), 0.0, rid)

    nj = len(joint_names)
    lim = np.array(limits) if limits else np.zeros((0, 4))
    djp = default_joint_pos or {}
    foot_ids = [i for i, n in enumerate(report_names) if "FOOT" in n.upper()]

    def rows(xs):
        return np.stack(xs) if xs else np.zeros((0, 3))

    return RobotModel(
        body_names=tuple(body_names),
        parent=np.array(parent_idx, dtype=np.int32),
        joint_pos=np.stack(joint_pos),
        joint_rot=np.stack(joint_rot),
        joint_axis=np.stack(joint_axis),
        joint_names=tuple(joint_names),
        mass=np.array(mass),
        com=np.stack(com),
        inertia=np.stack(inertia),
        armature=np.full(nj, armature),
        joint_limit_lower=lim[:, 0].copy(),
        joint_limit_upper=lim[:, 1].copy(),
        effort_limit=(np.full(nj, effort_limit) if effort_limit is not None
                      else lim[:, 2].copy()),
        velocity_limit=(np.full(nj, velocity_limit)
                        if velocity_limit is not None else lim[:, 3].copy()),
        default_base_pos=np.array(default_base_pos, dtype=np.float64),
        default_qpos_joints=np.array(
            [djp.get(n, 0.0) for n in joint_names], dtype=np.float64),
        cand_body=np.array(cand_body, dtype=np.int32),
        cand_offset=rows(cand_offset),
        cand_radius=np.array(cand_radius),
        cand_report=np.array(cand_report, dtype=np.int32),
        report_names=tuple(report_names),
        site_names=tuple(site_names),
        site_body=np.array(site_body, dtype=np.int32),
        site_offset=rows(site_offset),
        foot_report_ids=np.array(foot_ids, dtype=np.int32),
    )
