"""The physics substep around the contact solve as three CUDA kernels,
their wrappers, the dispatch to their plain PyTorch versions, and the one
list of the port's kernels (``KERNELS``: the two contact solves, these
three and the env step's three, ``ops/env_step.py`` ``ENV_KERNELS``).

  * ``substep_dynamics`` (``csrc/substep_dyn.cu``): PD torque, forward
    kinematics, M, C, M^-1 and v_free, one warp an env;
  * ``contact_rows`` (``csrc/contact_rows.cu``): contact candidates and
    self-collision pairs, phi, the frames and the rows E, W = M^-1 E^T,
    b = E v_free, in the layout ``ops/pgs.py``'s kernels read;
  * ``substep_post`` (``csrc/substep_post.cu``), after the solve: v_free +
    W lam, integration with the joint-limit clamp, the contact forces a
    report slot, their history and the feet's air times.

None replaces a Pallas kernel: together they are the counterpart of the
JAX package's lanes substep (cat_tpu/sim/engine_lanes.py:38
``_substep_pre_lanes`` over sim/dynamics_lanes.py, and :131
``_substep_post_lanes``), which XLA fused into a few full-width passes on
the TPU. Their plain versions are ``sim/engine.py``'s ``dynamics_stage``,
``contact_stage`` and ``post_stage``.

The wrappers dispatch on the tensors' device: on a CUDA tensor they launch
the kernel (built by plain nvcc, bound with ctypes) or raise; on a CPU
tensor they run the plain version. There is no fallback from the card to
the plain version. The model's tables (``model_tables``, ``pack_post``)
go to the card once a ``ModelTensors`` and wrapper, the heightfield's
packed corners once a terrain.

``SubstepDynKernel(clocks=True)``, ``ContactRowsKernel(clocks=True)`` and
``SubstepPostKernel(clocks=True)`` bind each kernel's phase-clock build
(``-DSUBSTEP_PHASE_CLOCKS``, a library of its own): ``phase_cycles``
returns each env's clock cycles in each of the kernel's ``phases`` over
one launch. ``chip_smoke.py``'s kernel-dyn and kernel-post phases print
their medians; no path of the program uses them.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from cat_tpu_torch.sim.dynamics import ContactKin
from cat_tpu_torch.sim.terrain import _packed_corners

from . import build, pgs
from .env_step import ENV_KERNELS
from .pgs import _device_and_stream

CSRC = Path(__file__).resolve().parent / "csrc"
DYN_SOURCE = CSRC / "substep_dyn.cu"
CONTACT_SOURCE = CSRC / "contact_rows.cu"
POST_SOURCE = CSRC / "substep_post.cu"
MAX_DOFS = 32            # a lane of the warp owns each dof
MAX_CONTACTS = 64
MAX_FEET = 32            # a lane owns each foot
# the phase-clock build of a kernel (``_SubstepKernel(clocks=True)``): a
# library of its own; the production library is never built with it
PHASE_CLOCK_FLAGS = ("-DSUBSTEP_PHASE_CLOCKS",)
PHASE_SLOTS = 8          # csrc/substep_model.cuh kPhaseSlots
ENVS_PER_BLOCK = 4       # csrc/substep_model.cuh kWarps: one warp an env
# the two stages' outputs, in order (``substep_dynamics``'s kin flattened)
DYN_OUTPUTS = ("tau_j", "v_free", "Minv", "R", "o", "a_w")
CONTACT_OUTPUTS = ("E", "W", "b", "phi", "frame")
# the post stage's outputs (the SimState fields it computes; lam and
# applied_torque pass through)
POST_OUTPUTS = ("qpos", "qvel", "joint_acc", "forces", "force_hist",
                "current_air_time", "last_air_time", "current_contact_time",
                "last_contact_time", "touchdown")


class ModelTables(NamedTuple):
    """The model as the kernels read it (``csrc/substep_model.cuh``)."""
    floats: torch.Tensor     # float32, the parts in the header's order
    ints: torch.Tensor       # int32
    max_depth: int           # levels of the kinematic tree
    schur: bool              # the structured M^-1 applies


def pack_model(model):
    """(floats, ints, max_depth) of ``model`` as numpy arrays, in the order
    of ``csrc/substep_model.cuh``."""
    nb = model.nbody
    depth = [0] * nb
    for b in range(1, nb):
        depth[b] = depth[int(model.parent[b])] + 1
    anc = model.ancestor_mask()
    anc_bits = [sum(1 << j for j in range(anc.shape[1]) if anc[b, j])
                for b in range(nb)]
    parts = (
        [0.0, 0.0, 9.81],                 # -g: gravity as a base acceleration
        model.joint_pos, model.joint_rot, model.joint_axis, model.mass,
        model.com, model.inertia,
        np.concatenate([np.zeros(6), np.asarray(model.armature)]),
        model.effort_limit, model.cand_offset, model.cand_radius,
        model.pair_p0_a, model.pair_p1_a, model.pair_p0_b, model.pair_p1_b,
        np.asarray(model.pair_radius_a) + np.asarray(model.pair_radius_b),
    )
    floats = np.concatenate([np.asarray(p, dtype=np.float32).reshape(-1)
                             for p in parts])
    ints = np.concatenate([np.asarray(p, dtype=np.int64).reshape(-1) for p in (
        [max(int(p), 0) for p in model.parent], depth, anc_bits,
        model.cand_body, model.pair_body_a, model.pair_body_b)])
    return floats, ints.astype(np.int32), max(depth)


def model_tables(mt, device) -> ModelTables:
    """The tables of ``mt``'s model on ``device``."""
    floats, ints, max_depth = pack_model(mt.model)
    return ModelTables(torch.as_tensor(floats, device=device),
                       torch.as_tensor(ints, device=device), max_depth,
                       bool(mt.model.uniform_3dof_branches()))


class PostTables(NamedTuple):
    """The post stage's tables as its kernel reads them
    (``csrc/substep_post.cu``)."""
    floats: torch.Tensor     # float32: joint_lower, joint_upper
    ints: torch.Tensor       # int32: slots' contact masks, foot slots


def report_masks(model):
    """(nreport, 2) uint64: each report slot's contacts as two bit masks,
    those whose +f it sums (the terrain candidates and the pairs' A side)
    and the self-collision pairs' contacts whose -f it sums (their B side).
    A slot sums the first in ascending order, then the second: the plain
    version's column order (terrain candidates, the pairs' A, the pairs'
    B; cat_tpu/sim/engine_lanes.py:164-174)."""
    nct = model.ncand_terrain
    masks = np.zeros((model.nreport, 2), np.uint64)
    plus = np.concatenate([model.cand_report, model.pair_report_a])
    for c, r in enumerate(plus):
        masks[int(r), 0] |= np.uint64(1) << np.uint64(c)
    for p, r in enumerate(model.pair_report_b):
        masks[int(r), 1] |= np.uint64(1) << np.uint64(nct + p)
    return masks


def pack_post(model):
    """(floats, ints) of the post stage's tables as numpy arrays, in the
    order of ``csrc/substep_post.cu``: the joint limits; each slot's two
    contact masks (``report_masks``, four int32 words, low word first),
    then each foot's slot."""
    floats = np.concatenate([model.joint_limit_lower,
                             model.joint_limit_upper]).astype(np.float32)
    ints = np.concatenate([report_masks(model).view(np.int32).reshape(-1),
                           np.asarray(model.foot_report_ids, np.int32)])
    return floats, ints.astype(np.int32)


def _check(device, **tensors):
    """float32 contiguous tensors of the given shapes, on ``device``, a
    CUDA device: name=(tensor, shape)."""
    for name, (t, shape) in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}, not float32")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    for name, (t, _) in tensors.items():
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}: the kernel needs "
                             f"every operand on one CUDA device ({device})")


def _check_model(model):
    if not model.nv <= MAX_DOFS:
        raise ValueError(f"nv={model.nv} dofs: need at most {MAX_DOFS} (a "
                         "lane of the warp owns each dof)")
    if not 0 < model.ncand <= MAX_CONTACTS:
        raise ValueError(f"{model.ncand} contacts: need 1..{MAX_CONTACTS}")


def _check_post_model(model):
    _check_model(model)
    if not len(model.foot_report_ids) <= MAX_FEET:
        raise ValueError(f"{len(model.foot_report_ids)} feet: need at most "
                         f"{MAX_FEET} (a lane owns each foot)")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class _SubstepKernel:
    """ctypes binding of ``csrc/<prefix>.cu``. ``launches`` counts the
    kernel launches this wrapper made; nothing else changes it. The
    library is built at the first launch (or by ``load``); once a device,
    the kernel is allowed all the shared memory a block may opt into; once
    a ``ModelTensors`` and device, its tables go to the device (cached by
    the identity of ``mt``: a CUDA graph's capture may copy nothing from
    the host, and the first, eager call of a control step builds them).
    ``clocks=True`` binds the phase-clock build instead (``phase_cycles``);
    the module's own wrappers never do."""

    prefix = ""
    source: Path
    launch_argtypes: list = []
    bytes_argtypes: list = []
    phases: tuple = ()       # the kernel's phases, as its phase clocks count

    def __init__(self, clocks: bool = False):
        self.clocks = clocks
        self.launches = 0
        self.built: Optional[build.Built] = None
        self._lib = None
        self._devices = set()
        self._tables = {}     # (id(mt), device) -> (mt, ModelTables)

    def tables(self, mt, device):
        key = (id(mt), str(device))
        hit = self._tables.get(key)
        if hit is None or hit[0] is not mt:
            hit = self._tables[key] = (mt, self.make_tables(mt, device))
        return hit[1]

    @staticmethod
    def make_tables(mt, device):
        return model_tables(mt, device)

    def _fn(self, name):
        return getattr(self._lib, f"{self.prefix}_{name}")

    def load(self) -> build.Built:
        if self._lib is None:
            self.built = build.build_shared_library(
                self.source, PHASE_CLOCK_FLAGS if self.clocks else ())
            self._lib = ctypes.CDLL(str(self.built.path))
            for name, args, res in (
                    ("launch", self.launch_argtypes, _I),
                    ("block_bytes", self.bytes_argtypes, ctypes.c_size_t),
                    ("blocks_per_sm", self.bytes_argtypes, _I),
                    ("error_string", [_I], ctypes.c_char_p),
                    ("setup", [_I], _I)) + (
                        (("set_phase_cycles", [_P], _I),) if self.clocks
                        else ()):
                self._fn(name).argtypes = args
                self._fn(name).restype = res
        return self.built

    def _raise_on(self, err: int, what: str):
        if err != 0:
            raise RuntimeError(f"{self.prefix} {what} failed: "
                               + self._fn("error_string")(err).decode())

    def block_bytes(self, *shape) -> int:
        """Shared memory a block takes at this shape."""
        self.load()
        return self._fn("block_bytes")(*shape)

    def blocks_per_sm(self, device, *shape) -> int:
        """Blocks of the kernel an SM of ``device`` holds at this shape
        (the CUDA occupancy calculator)."""
        self.load()
        index = torch.device(device).index
        if index is None:
            index = torch.cuda.current_device()
        self._setup(index)
        with torch.cuda.device(index):
            n = self._fn("blocks_per_sm")(*shape)
        if n < 0:
            raise RuntimeError(f"{self.prefix} occupancy query failed")
        return n

    def phase_cycles(self, n: int, device, call) -> torch.Tensor:
        """int64 (n, len(phases)): each env's clock64() cycles in each
        phase of the one launch ``call()`` makes (the phase-clock build)."""
        if not self.clocks:
            raise RuntimeError("phase clocks need _SubstepKernel(clocks=True)")
        self.load()
        buf = torch.zeros(n, PHASE_SLOTS, dtype=torch.int64, device=device)
        with torch.cuda.device(device):
            self._raise_on(self._fn("set_phase_cycles")(buf.data_ptr()),
                           "setting the phase clocks")
            try:
                call()
                torch.cuda.synchronize(device)
            finally:
                self._raise_on(self._fn("set_phase_cycles")(None),
                               "clearing the phase clocks")
        return buf[:, :len(self.phases)]

    def _setup(self, index: int):
        """Once a device (its index), before the first launch there."""
        if index not in self._devices:
            self._raise_on(self._fn("setup")(index), "setup")
            self._devices.add(index)

    def _launch(self, like: torch.Tensor, args):
        """Launch over ``args`` on ``like``'s device and current stream;
        count it."""
        self.load()
        device, stream = _device_and_stream(like)
        self._setup(device)
        launch = self._fn("launch")
        if device == torch.cuda.current_device():
            err = launch(*args, stream)
        else:
            with torch.cuda.device(device):
                err = launch(*args, stream)
        self._raise_on(err, "kernel launch")
        self.launches += 1


class SubstepDynKernel(_SubstepKernel):
    """``csrc/substep_dyn.cu``: the dynamics stage."""

    prefix = "substep_dyn"
    source = DYN_SOURCE
    phases = ("PD", "tree walk", "body forces", "M/C", "M^-1", "v_free",
              "writes")
    # qpos qvel target com_offset ftab itab, out tau_j v_free minv R o a_w,
    # n nb nv max_depth, kp kd h, schur, stream
    launch_argtypes = [_P] * 12 + [_I] * 4 + [_F] * 3 + [_I, _P]
    bytes_argtypes = [_I, _I]

    def __call__(self, mt, params, qpos, qvel, target_q, com_offset=None):
        m = mt.model
        n = qpos.shape[0]
        _check_model(m)
        checks = dict(qpos=(qpos, (n, m.nq)), qvel=(qvel, (n, m.nv)),
                      target_q=(target_q, (n, m.nj)))
        if com_offset is not None:
            checks["com_offset"] = (com_offset, (n, m.nbody, 3))
        _check(qpos.device, **checks)
        tab = self.tables(mt, qpos.device)

        def out(*shape):
            return torch.empty((n,) + shape, device=qpos.device)

        tau_j, v_free, Minv = out(m.nj), out(m.nv), out(m.nv, m.nv)
        R, o, a_w = out(m.nbody, 3, 3), out(m.nbody, 3), out(m.nj, 3)
        self._launch(qpos, (
            qpos.data_ptr(), qvel.data_ptr(), target_q.data_ptr(),
            None if com_offset is None else com_offset.data_ptr(),
            tab.floats.data_ptr(), tab.ints.data_ptr(), tau_j.data_ptr(),
            v_free.data_ptr(), Minv.data_ptr(), R.data_ptr(), o.data_ptr(),
            a_w.data_ptr(), n, m.nbody, m.nv, tab.max_depth,
            params.kp, params.kd, params.dt, int(tab.schur)))
        return tau_j, v_free, Minv, ContactKin(R, o, a_w)


class ContactRowsKernel(_SubstepKernel):
    """``csrc/contact_rows.cu``: the contact stage."""

    prefix = "contact_rows"
    source = CONTACT_SOURCE
    phases = ("detection", "rows", "W", "writes")
    # R o a_w minv v_free ftab itab hfield, out E W b phi frame,
    # n nb nv nct npair hrows hcols, cell, stream
    launch_argtypes = [_P] * 13 + [_I] * 7 + [_F, _P]
    bytes_argtypes = [_I, _I, _I]

    def __call__(self, mt, terrain, kin, Minv, v_free):
        m = mt.model
        n = v_free.shape[0]
        _check_model(m)
        _check(v_free.device, R=(kin.R, (n, m.nbody, 3, 3)),
               o=(kin.o, (n, m.nbody, 3)), a_w=(kin.a_w, (n, m.nj, 3)),
               Minv=(Minv, (n, m.nv, m.nv)), v_free=(v_free, (n, m.nv)))
        tab = self.tables(mt, v_free.device)
        dev, nc = v_free.device, m.ncand
        E = torch.empty(n, 3 * nc, m.nv, device=dev)
        W = torch.empty(n, m.nv, 3 * nc, device=dev)
        b = torch.empty(n, 3 * nc, device=dev)
        phi = torch.empty(n, nc, device=dev)
        # the plane without pairs: the world frame, as the plain version
        frame = (None if terrain.kind == "plane" and not m.npair
                 else torch.empty(n, nc, 3, 3, device=dev))
        if terrain.kind == "plane":
            hfield, (hrows, hcols) = None, (0, 0)
        else:
            hfield = _packed_corners(terrain, dev).data_ptr()
            hrows, hcols = terrain.height.shape
        self._launch(v_free, (
            kin.R.data_ptr(), kin.o.data_ptr(), kin.a_w.data_ptr(),
            Minv.data_ptr(), v_free.data_ptr(), tab.floats.data_ptr(),
            tab.ints.data_ptr(), hfield, E.data_ptr(), W.data_ptr(),
            b.data_ptr(), phi.data_ptr(),
            None if frame is None else frame.data_ptr(),
            n, m.nbody, m.nv, m.ncand_terrain, m.npair, hrows, hcols,
            float(terrain.cell)))
        return E, W, b, phi, frame


class SubstepPostKernel(_SubstepKernel):
    """``csrc/substep_post.cu``: the post stage."""

    prefix = "substep_post"
    source = POST_SOURCE
    phases = ("prologue loads", "active list", "W lam", "integration",
              "contact forces", "report/history", "feet")
    # qpos qvel v_free W lam frame force_hist, the four air fields,
    # touchdown, ftab itab, out qpos qvel joint_acc forces force_hist, the
    # four air fields, touchdown; n nv nct npair nreport nfeet, h threshold,
    # stream
    launch_argtypes = [_P] * 24 + [_I] * 6 + [_F, _F, _P]
    bytes_argtypes = [_I, _I, _I]

    @staticmethod
    def make_tables(mt, device) -> PostTables:
        return PostTables(*(torch.as_tensor(t, device=device)
                            for t in pack_post(mt.model)))

    def __call__(self, mt, params, s, tau_j, v_free, W, lam, frame):
        m = mt.model
        n = v_free.shape[0]
        nf = len(m.foot_report_ids)
        _check_post_model(m)
        # the state as its holder keeps it (the bench's, the env's): made
        # contiguous here, a no-op where it is
        s = type(s)(*(t.contiguous() for t in s))
        v_free, W, lam = v_free.contiguous(), W.contiguous(), lam.contiguous()
        nc, nr = m.ncand, m.nreport
        checks = dict(qpos=(s.qpos, (n, m.nq)), qvel=(s.qvel, (n, m.nv)),
                      tau_j=(tau_j, (n, m.nj)), v_free=(v_free, (n, m.nv)),
                      W=(W, (n, m.nv, 3 * nc)), lam=(lam, (n, 3 * nc)),
                      force_hist=(s.force_hist, (n, 9 * nr)))
        for name in POST_OUTPUTS[5:9]:
            checks[name] = (getattr(s, name), (n, nf))
        if frame is not None:
            frame = frame.contiguous()
            checks["frame"] = (frame, (n, nc, 3, 3))
        if s.touchdown.dtype != torch.bool:
            raise TypeError(f"touchdown is {s.touchdown.dtype}, not bool")
        if tuple(s.touchdown.shape) != (n, nf):
            raise ValueError(f"touchdown has shape {tuple(s.touchdown.shape)},"
                             f" expected {(n, nf)}")
        _check(v_free.device, **checks)
        if s.touchdown.device != v_free.device:
            raise ValueError(f"touchdown is on {s.touchdown.device}, not "
                             f"{v_free.device}")
        dev = v_free.device
        tab = self.tables(mt, dev)

        def out(*shape, dtype=torch.float32):
            return torch.empty((n,) + shape, dtype=dtype, device=dev)

        res = dict(qpos=out(m.nq), qvel=out(m.nv), joint_acc=out(m.nj),
                   forces=out(3 * nr), force_hist=out(9 * nr),
                   **{name: out(nf) for name in POST_OUTPUTS[5:9]},
                   touchdown=out(nf, dtype=torch.bool))
        ins = [s.qpos, s.qvel, v_free, W, lam, frame, s.force_hist,
               *(getattr(s, name) for name in POST_OUTPUTS[5:9]),
               s.touchdown, tab.floats, tab.ints]
        self._launch(v_free, tuple(
            None if t is None or t.numel() == 0 else t.data_ptr()
            for t in ins + [res[name] for name in POST_OUTPUTS]) + (
            n, m.nv, m.ncand_terrain, m.npair, nr, nf, params.dt,
            params.contact_force_threshold))
        return type(s)(lam=lam, applied_torque=tau_j, **res)


DYN_KERNEL = SubstepDynKernel()
CONTACT_KERNEL = ContactRowsKernel()
POST_KERNEL = SubstepPostKernel()
# the one list of the port's kernels: (name, wrapper), the substep's three
# in the order a substep launches them, then the env step's three
# (ops/env_step.py)
SUBSTEP_KERNELS = (("substep_dynamics", DYN_KERNEL),
                   ("contact_rows", CONTACT_KERNEL),
                   ("substep_post", POST_KERNEL))
KERNELS = ((("pgs_bj", pgs.KERNEL), ("pgs_gs", pgs.GS_KERNEL))
           + SUBSTEP_KERNELS + ENV_KERNELS)


def substep_dynamics(mt, params, qpos, qvel, target_q, com_offset=None):
    """(tau_j, v_free, Minv, kin) of one substep on the state's device: the
    CUDA kernel for CUDA tensors, ``sim.engine.dynamics_stage`` for CPU
    tensors."""
    if qpos.device.type == "cpu":
        # sim.engine imports this module: import its plain stage here
        from cat_tpu_torch.sim.engine import dynamics_stage

        return dynamics_stage(mt, params, qpos, qvel, target_q, com_offset)
    return DYN_KERNEL(mt, params, qpos, qvel, target_q, com_offset)


def contact_rows(mt, terrain, kin, Minv, v_free):
    """(E, W, b, phi, frame) of one substep on the operands' device: the
    CUDA kernel for CUDA tensors, ``sim.engine.contact_stage`` for CPU
    tensors."""
    if v_free.device.type == "cpu":
        from cat_tpu_torch.sim.engine import contact_stage

        return contact_stage(mt, terrain, kin, Minv, v_free)
    return CONTACT_KERNEL(mt, terrain, kin, Minv, v_free)


def substep_post(mt, params, s, tau_j, v_free, W, lam, frame):
    """The SimState after one substep's impulses lam: the CUDA kernel for
    CUDA tensors, ``sim.engine.post_stage`` for CPU tensors."""
    if v_free.device.type == "cpu":
        from cat_tpu_torch.sim.engine import post_stage

        return post_stage(mt, params, s, tau_j, v_free, W, lam, frame)
    return POST_KERNEL(mt, params, s, tau_j, v_free, W, lam, frame)
