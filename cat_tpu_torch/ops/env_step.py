"""The CaT env step around the physics as three CUDA kernels, their
wrappers and the dispatch to their plain PyTorch versions.

  * ``env_terms`` (``csrc/env_terms.cu``), after the control step: the
    counters, the terminations and the raw constraint columns with their
    maxima over envs (plain: ``envs/env.py`` ``CatEnv.terms_stage``);
  * ``env_update`` (``csrc/env_update.cu``): the CaT transform, the reward
    and dones, the accumulators' shares, the terrain curriculum, the masked
    reset, the commands and the push (plain: ``CatEnv.update_stage``);
  * ``env_obs`` (``csrc/env_obs.cu``): the observation, with the height
    scan on rough terrain (plain: ``CatEnv.obs_stage``).

None replaces a Pallas kernel: together they are the counterpart of what
XLA fuses of the JAX package's ``CatEnv.step`` (cat_tpu/envs/env.py:492-683)
into a few full-width passes on the TPU.

The wrappers dispatch on the tensors' device: on a CUDA tensor they launch
the kernel (built by plain nvcc with ``-fmad=false``, bound with ctypes) or
raise; on a CPU tensor they run the plain version. There is no fallback
from the card to the plain version. The random draws stay in PyTorch: the
env draws them before the kernel that reads them (``UpdateDraws``,
``ObsDraws``: the observation noise as raw U(0, 1) draws, whose affine to
U(-mag, mag) the kernel applies). The env's device tables (the term and
column tables, int32 index tables, the heightfield's packed corners,
``env_update``'s ticket) are made at its first launch on a device,
outside any capture.

Each kernel gives a block of threads a group of consecutive envs
(``env_geometry``) and stages its rows through shared memory;
``env_update`` sums the finished-episode accumulators itself, in the order
``fold_shares`` repeats. ``EnvTermsKernel(clocks=True)``,
``EnvUpdateKernel(clocks=True)`` and ``EnvObsKernel(clocks=True)`` bind
each kernel's phase-clock build
(``-DENV_PHASE_CLOCKS``, a library of its own): ``phase_cycles`` returns
each block's clock cycles in each of the kernel's ``phases`` over one
launch. ``chip_smoke.py``'s kernel-env phase prints their medians; no
path of the program uses them.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from cat_tpu_torch.sim.terrain import _packed_corners

from . import build

CSRC = Path(__file__).resolve().parent / "csrc"
# one rounding an operation, as the plain stages' PyTorch operations round
NVCC_FLAGS = ("-fmad=false",)
PARTS = {"reset": 1, "commands": 2, "all": 3}   # env_update's parts
# the phase-clock build of a kernel (``_EnvKernel(clocks=True)``): a
# library of its own; the production library is never built with it
PHASE_CLOCK_FLAGS = ("-DENV_PHASE_CLOCKS",)
PHASE_SLOTS = 8          # csrc/env_model.cuh kPhaseSlots
SHARE_EXTRA = 6   # shares beyond the terms': reward, length, count, causes
# env_terms and env_update: envs a block (at most; fewer where a block's
# shared memory would not fit), threads a block (csrc/env_model.cuh
# kBlockThreads; env_update's per-env logic takes three roles' worth of
# envs) and the shared memory a block may have (227 KB on the H100). 16
# envs on 256 threads: 256 blocks for 4096 envs, two an SM, one wave (the
# geometries timed are in PERF.md)
ENVS_PER_BLOCK = 16
THREADS = 256
THREADS_MAX = 256        # csrc/env_model.cuh kBlockThreads
SMEM_LIMIT = 232448
# env_obs: envs a block (at most, as above) and threads a block
# (csrc/env_model.cuh kObsThreads at most). 8 envs on 128 threads: 512
# blocks for 4096 envs, four an SM, one wave (the geometries timed are in
# PERF.md)
OBS_ENVS_PER_BLOCK = 8
OBS_THREADS = 128
OBS_THREADS_MAX = 512
OBS_ENV_VALS = 8         # csrc/env_obs.cu kEnvVals: an env's shared values


class Terms(NamedTuple):
    """What ``env_terms`` gives ``env_update``: the step's counters, the
    terminations and the raw constraint columns."""
    episode_len: torch.Tensor   # (N,) int32, counting this step
    common_step: torch.Tensor   # () int32
    time_out: torch.Tensor      # (N,) bool
    illegal: torch.Tensor       # (N,) bool, an illegal contact
    upside: torch.Tensor        # (N,) bool, upside down
    raw: torch.Tensor           # (N, columns) raw violations
    col_max: torch.Tensor       # (columns,) max over envs, >= 1e-6


class UpdateDraws(NamedTuple):
    """``env_update``'s draws, in the order the step makes them: the
    reset's uniforms (N, 3 + nj); the reset envs' commands', the
    scheduled and the stochastic resample's (N, 4) and its chance (N,),
    the flip's (N,); the push's chance (N,) and its velocity U(-v, v)
    (N, 2), None with the push off. The "reset" part reads only
    ``reset``."""
    reset: torch.Tensor
    reset_command: Optional[torch.Tensor] = None
    expired_command: Optional[torch.Tensor] = None
    resample: Optional[torch.Tensor] = None
    resample_command: Optional[torch.Tensor] = None
    flip: Optional[torch.Tensor] = None
    push: Optional[torch.Tensor] = None
    push_vel: Optional[torch.Tensor] = None


class ObsDraws(NamedTuple):
    """The observation noise: each part's raw U(0, 1) draw u (N, width), or
    None (no noise on that part), and each part's ``lo`` and ``span`` (hi
    - lo), float32 numbers: the part's noise is lo + span * u, one rounding
    an operation (``noise``), which the kernel computes itself."""
    ang_vel: Optional[torch.Tensor]
    gravity: Optional[torch.Tensor]
    joint_pos: Optional[torch.Tensor]
    joint_vel: Optional[torch.Tensor]
    scan: Optional[torch.Tensor]
    lo: tuple = (0.0,) * 5
    span: tuple = (0.0,) * 5

    @classmethod
    def uniform(cls, draws, mags) -> "ObsDraws":
        """The five parts' draws (each a raw U(0, 1) draw or None) with
        U(-mag, mag) of each part's ``mags`` entry (None: no noise): lo =
        -mag and span = mag - (-mag), each rounded to float32 as PyTorch
        rounds a Python number in a float32 operation."""
        return cls(*draws, tuple(0.0 if m is None else f32(-m) for m in mags),
                   tuple(0.0 if m is None else f32(m - (-m)) for m in mags))

    @property
    def draws(self) -> tuple:
        """The five parts' raw draws, in the columns' order."""
        return tuple(self[:5])

    def noise(self, k: int) -> Optional[torch.Tensor]:
        """Part k's noise, lo + span * u, or None."""
        u = self[k]
        return None if u is None else self.lo[k] + self.span[k] * u


class Updated(NamedTuple):
    """What ``env_update`` gives the step: the new SimState and EnvState
    fields, the reward and dones. The "reset" part leaves ``command`` and
    ``command_time_left`` None; the "commands" part fills only ``sim``,
    ``command`` and ``command_time_left``."""
    sim: object
    reward: torch.Tensor
    dones: torch.Tensor
    running_max: torch.Tensor
    max_p: torch.Tensor
    episode_len: torch.Tensor
    episode_viol: torch.Tensor
    episode_prob: torch.Tensor
    episode_rew: torch.Tensor
    action: torch.Tensor
    prev_action: torch.Tensor
    origin: torch.Tensor
    terrain_row: torch.Tensor
    acc_viol: torch.Tensor
    acc_prob: torch.Tensor
    acc_rew: torch.Tensor
    acc_len: torch.Tensor
    acc_count: torch.Tensor
    acc_term: torch.Tensor
    command: Optional[torch.Tensor]
    command_time_left: Optional[torch.Tensor]


def f32(x) -> float:
    """x rounded to float32, as PyTorch casts a Python number in a float32
    operation."""
    return float(np.float32(x))


def recip(x) -> float:
    """1 / x as PyTorch's CUDA division of a float32 tensor by the Python
    number x computes it: the float32 reciprocal of float32(x), then a
    multiplication."""
    return float(np.float32(1.0) / np.float32(x))


def hfield_args(terrain, device):
    """(corner table or None, [rows, cols], [1/cell, R/2, C/2, R - 1.001,
    C - 1.001]) of ``csrc/env_model.cuh`` ``Hfield``; the plane: a null
    table."""
    if terrain.kind != "hfield":
        return None, [0, 0], [0.0] * 5
    R, C = terrain.height.shape
    return (_packed_corners(terrain, device), [R, C],
            [recip(terrain.cell), f32(R / 2.0), f32(C / 2.0),
             f32(R - 1.001), f32(C - 1.001)])


def columns(env):
    """``envs/cat.py`` ``column_table`` of the env's terms (its
    ``ColumnTable``)."""
    from cat_tpu_torch.envs.cat import column_table

    return column_table(env.cset.descriptors, env.t2m.cpu().numpy(),
                        env.illegal_ids.cpu().numpy())


def env_tables(env, device) -> dict:
    """The env's device tables, made once a device (``env.kernel_tables``):
    a CUDA graph's capture may copy nothing from the host, and the step's
    first, eager call makes them."""
    key = str(device)
    tabs = env.kernel_tables.get(key)
    if tabs is None:
        cset = env.cset.device_table()
        cols = columns(env)
        tabs = env.kernel_tables[key] = dict(
            t2m=env.t2m.to(device=device, dtype=torch.int32),
            hfield=hfield_args(env.cfg.terrain, device),
            update_floats=update_floats(env),
            col_term=env.cset._col_term.to(device=device,
                                           dtype=torch.int32),
            # env_update's ticket: its last block sets it back to 0
            ticket=torch.zeros(1, dtype=torch.int32, device=device),
            **{f"col_{k}": torch.as_tensor(np.append(v, 0).astype(np.int32) if k in (
                "slots", "illegal") else v, device=device)
               for k, v in cols._asdict().items()},
            n_slots=len(cols.slots), n_illegal=len(cols.illegal),
            **{f"term_{k}": v for k, v in cset.items()})
    return tabs


class Geometry(NamedTuple):
    """How the kernels cut n envs: ``env_terms`` and ``env_update``'s envs
    a block, threads a block, blocks and each one's shared memory a block
    in bytes; then ``env_obs``'s."""
    envs: int
    threads: int
    blocks: int
    terms_bytes: int
    update_bytes: int
    obs_envs: int
    obs_threads: int
    obs_blocks: int
    obs_bytes: int


def _words(regions) -> int:
    """4-byte words of shared memory regions of these word counts, each
    rounded up to 16 bytes (``csrc/env_model.cuh`` ``Layout``)."""
    return sum(-(-w // 4) * 4 for w in regions)


def terms_smem(env, envs: int) -> int:
    """Bytes of ``csrc/env_terms.cu``'s ``TermsLayout`` for blocks of
    ``envs`` envs, region by region."""
    m, K, E = env.model, env.cset.total_cols, envs
    nj, nr, nf = m.nj, m.nreport, len(m.foot_report_ids)
    tab = columns(env)
    ns, n_given = len(tab.slots), given_width(env)
    return 4 * _words([
        5 * env.cset.n_terms, 3 * K, 2 * K, nj, ns, len(tab.illegal),
        E * m.nq, E * m.nv,
        E * nj, E * nj, E * 9 * nr, E * nf, E * 3, E * nj, E * nj,
        E * n_given, E, -(-E * nf // 4), E * ns, E * 4, E * 2, E * K])


def update_smem(env, envs: int) -> int:
    """Bytes of ``csrc/env_update.cu``'s ``UpdateLayout`` for blocks of
    ``envs`` envs, region by region."""
    m, E = env.model, envs
    K, nt, nj = env.cset.total_cols, env.cset.n_terms, m.nj
    widths = [s[1] for s in sim_shapes(m, 1)]
    return 4 * _words([
        K, K, K, nt, -(-nt // 4), nt, 5 * nt, K, nj, nj, nj, 1, 1,
        2 * nt + SHARE_EXTRA,
        E * K, E, -(-E // 4), -(-E // 4), -(-E // 4), E * nt, E * nt, E,
        E * 3, E, E * 2, E, E, E * nj, E * nj,
        *(E * w for w in widths[:-1]), -(-E * widths[-1] // 4),
        E * (3 + nj), E * 4, E * 4, E, E * 4, E, E, E * 2,
        E * nt, E * (2 * nt + SHARE_EXTRA), E, E, E, E * m.nq, E * m.nv,
        E * 3, E, E * m.nv])


def obs_smem(env, envs: int) -> int:
    """Bytes of ``csrc/env_obs.cu``'s ``ObsLayout`` for blocks of ``envs``
    envs, region by region."""
    m, E = env.model, envs
    hs = env.cfg.height_scan
    pts = hs.num_points if hs is not None else 0
    return 4 * _words([
        2 * pts, m.nj, E * m.nq, E * m.nv, E * 3, E * m.nj,
        E * 3, E * 3, E * m.nj, E * m.nj, E * OBS_ENV_VALS,
        E * env.num_obs])


def _fit(envs: int, smem) -> int:
    """``envs`` halved while ``smem(envs)`` passes ``SMEM_LIMIT``."""
    while envs > 1 and smem(envs) > SMEM_LIMIT:
        envs //= 2
    if smem(envs) > SMEM_LIMIT:
        raise ValueError(f"one env's rows take {smem(envs)} B of shared "
                         f"memory, more than {SMEM_LIMIT}")
    return envs


def env_geometry(n: int, env) -> Geometry:
    """``Geometry`` of the three kernels for n envs of ``env``:
    ``ENVS_PER_BLOCK`` envs a block of ``env_terms`` and ``env_update``
    (4096 envs: 256 blocks, one wave on the H100's 132 SMs) and
    ``OBS_ENVS_PER_BLOCK`` of ``env_obs``, each halved while a block's
    shared memory would pass ``SMEM_LIMIT``."""
    envs = _fit(ENVS_PER_BLOCK, lambda e: max(terms_smem(env, e),
                                              update_smem(env, e)))
    obs_envs = _fit(OBS_ENVS_PER_BLOCK, lambda e: obs_smem(env, e))
    return Geometry(envs, THREADS, -(-n // envs), terms_smem(env, envs),
                    update_smem(env, envs), obs_envs, OBS_THREADS,
                    -(-n // obs_envs), obs_smem(env, obs_envs))


def given_width(env) -> int:
    """Columns of the given block (the terms of their own functions)."""
    tab = env.cset.descriptors
    return int(sum(tab.ints[i][2] for i in tab.given))


def fold_shares(shares: torch.Tensor, envs: int) -> torch.Tensor:
    """The finished-episode accumulators' increments from every env's
    shares (N, 2 n_terms + 6) as ``csrc/env_update.cu`` sums them, in
    float32, one addition at a time: each block of ``envs`` consecutive
    envs from 0 in env order, then the blocks' sums from 0 in block order.
    (A ragged last block is padded with zeros: adding +0 to a sum that
    starts at +0 changes no bit.) Returns (2 n_terms + 6,) float32 on the
    CPU."""
    x = shares.detach().to("cpu", torch.float32).numpy()
    n, width = x.shape
    blocks = -(-n // envs)
    padded = np.zeros((blocks * envs, width), np.float32)
    padded[:n] = x
    padded = padded.reshape(blocks, envs, width)
    part = np.zeros((blocks, width), np.float32)
    for e in range(envs):
        part = part + padded[:, e]
    total = np.zeros(width, np.float32)
    for b in range(blocks):
        total = total + part[b]
    return torch.from_numpy(total)


def geometry(tabs: dict, n: int, env) -> Geometry:
    """``env_geometry(n, env)``, kept in the env's device tables."""
    key = ("geometry", n)
    if key not in tabs:
        tabs[key] = env_geometry(n, env)
    return tabs[key]


def update_floats(env) -> list:
    """``csrc/env_update.cu`` ``UpdateArgs``' floats after the
    heightfield's, from the env's config and model, each rounded as the
    plain stage's PyTorch operation rounds its Python number."""
    cfg, m = env.cfg, env.model
    ev, c = cfg.events, cfg.commands
    H, W = cfg.terrain.size_m
    lo, hi = ev.reset_joint_scale
    cmd_lo = np.float32([c.lin_vel_x[0], c.lin_vel_y[0], c.ang_vel_z[0]])
    cmd_hi = np.float32([c.lin_vel_x[1], c.lin_vel_y[1], c.ang_vel_z[1]])
    return [
        recip(cfg.curriculum_steps), f32(0.95), f32(1.0 - 0.95),
        f32(cfg.rewards.lin_weight), f32(cfg.rewards.ang_weight),
        recip(cfg.rewards.std2), f32(cfg.step_dt), f32(cfg.episode_length_s),
        f32(c.velocity_deadzone), f32(cfg.terrain.patch_m), f32(H / 2.0),
        f32(W / 2.0), f32(ev.reset_pose_xy), f32(ev.reset_yaw), f32(lo),
        f32(hi - lo), f32(float(m.default_base_pos[2])),
        f32(c.rel_standing_envs), f32(c.resampling_time), f32(0.01),
        f32(cfg.sim_dt / cfg.episode_length_s),
        f32(cfg.sim_dt / cfg.episode_length_s),
        f32(cfg.sim_dt / (cfg.episode_length_s * 2.0)),
        *map(float, cmd_lo), *map(float, cmd_hi - cmd_lo)]


_P, _I = ctypes.c_void_p, ctypes.c_int


def _ptr(t: Optional[torch.Tensor], dtype, device) -> Optional[int]:
    """The data pointer of a contiguous ``dtype`` tensor on ``device``
    (None: a null pointer)."""
    if t is None:
        return None
    if t.dtype != dtype:
        raise TypeError(f"an operand is {t.dtype}, not {dtype}")
    if t.device != device:
        raise ValueError(f"an operand is on {t.device}: the kernel needs "
                         f"every operand on one CUDA device ({device})")
    if not t.is_contiguous():
        raise ValueError("an operand is not contiguous")
    return t.data_ptr()


def sim_shapes(m, n) -> tuple:
    """Each SimState field's shape for n envs of model ``m``."""
    nf = len(m.foot_report_ids)
    return ((n, m.nq), (n, m.nv), (n, 3 * m.ncand), (n, m.nj), (n, m.nj),
            (n, 3 * m.nreport), (n, 9 * m.nreport)) + ((n, nf),) * 5


def check_shapes(**tensors):
    """Raises unless each tensor has its shape: name=(tensor or None,
    shape); a NamedTuple of tensors with a tuple of shapes checks each
    field."""
    for name, (t, shape) in tensors.items():
        if t is None:
            continue
        if isinstance(t, tuple):
            check_shapes(**{f"{name}.{k}": (x, sh) for (k, x), sh in zip(
                t._asdict().items(), shape)})
        elif tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")


class _EnvKernel:
    """ctypes binding of ``csrc/<prefix>.cu``. ``launches`` counts the
    kernel launches this wrapper made; nothing else changes it. The
    library is built at the first launch (or by ``load``).
    ``clocks=True`` binds the phase-clock build instead
    (``phase_cycles``); the module's own wrappers never do."""

    prefix = ""
    phases: tuple = ()       # the kernel's phases, as its phase clocks count

    def __init__(self, clocks: bool = False):
        self.clocks = clocks
        self.launches = 0
        self.built: Optional[build.Built] = None
        self._lib = None

    @property
    def source(self) -> Path:
        return CSRC / f"{self.prefix}.cu"

    def load(self) -> build.Built:
        if self._lib is None:
            self.built = build.build_shared_library(
                self.source,
                NVCC_FLAGS + (PHASE_CLOCK_FLAGS if self.clocks else ()))
            self._lib = ctypes.CDLL(str(self.built.path))
            for name, args, res in (
                    ("launch", [_P, _P, _P, _I, _I, _I, _P], _I),
                    ("error_string", [_I], ctypes.c_char_p)) + (
                        (("blocks_per_sm", [_I, _I], _I),) if self.phases
                        else ()) + (
                        (("set_phase_cycles", [_P], _I),) if self.clocks
                        else ()):
                fn = getattr(self._lib, f"{self.prefix}_{name}")
                fn.argtypes = args
                fn.restype = res
        return self.built

    def blocks_per_sm(self, device, threads: int, smem: int) -> int:
        """Blocks of the kernel an SM of ``device`` holds at ``threads``
        threads and ``smem`` bytes of shared memory a block (the CUDA
        occupancy calculator)."""
        self.load()
        with torch.cuda.device(device):
            n = getattr(self._lib, f"{self.prefix}_blocks_per_sm")(threads,
                                                                   smem)
        if n < 0:
            raise RuntimeError(f"{self.prefix} occupancy query failed")
        return n

    def phase_cycles(self, blocks: int, device, call) -> torch.Tensor:
        """int64 (blocks, len(phases)): each block's clock64() cycles in
        each phase of the one launch ``call()`` makes (the phase-clock
        build), for a launch of at most ``blocks`` blocks."""
        if not self.clocks:
            raise RuntimeError("phase clocks need the kernel's clocks=True "
                               "wrapper")
        self.load()
        buf = torch.zeros(blocks, PHASE_SLOTS, dtype=torch.int64,
                          device=device)
        set_cycles = getattr(self._lib, f"{self.prefix}_set_phase_cycles")
        with torch.cuda.device(device):
            if set_cycles(buf.data_ptr()) != 0:
                raise RuntimeError("setting the phase clocks failed")
            try:
                call()
                torch.cuda.synchronize(device)
            finally:
                if set_cycles(None) != 0:
                    raise RuntimeError("clearing the phase clocks failed")
        return buf[:, :len(self.phases)]

    def _launch(self, device: torch.device, ptrs, ints, floats):
        """Launch over ``ptrs`` ((tensor or None, dtype) pairs), ``ints``
        and ``floats``, in the order of the kernel's argument struct, on
        ``device``'s current stream; count it."""
        if device.type != "cuda":
            raise ValueError(f"{self.prefix} runs on a CUDA device, not "
                             f"{device}")
        self.load()
        p = (ctypes.c_void_p * len(ptrs))(
            *(_ptr(t, dtype, device) for t, dtype in ptrs))
        i = (ctypes.c_int * len(ints))(*(int(x) for x in ints))
        f = (ctypes.c_float * len(floats))(*(float(x) for x in floats))
        index = torch.cuda.current_device() if device.index is None \
            else device.index
        stream = torch.cuda.current_stream(index).cuda_stream
        launch = getattr(self._lib, f"{self.prefix}_launch")
        with torch.cuda.device(index):
            err = launch(p, i, f, len(ptrs), len(ints), len(floats), stream)
        if err != 0:
            msg = getattr(self._lib, f"{self.prefix}_error_string")(err)
            raise RuntimeError(f"{self.prefix} kernel launch failed: "
                               + msg.decode())
        self.launches += 1


F, I32, B = torch.float32, torch.int32, torch.bool


def c(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` contiguous (a no-op where it is), None as None."""
    return None if t is None else t.contiguous()


class EnvTermsKernel(_EnvKernel):
    """``csrc/env_terms.cu``: ``CatEnv.terms_stage``."""

    prefix = "env_terms"
    phases = ("staging", "per-env logic", "columns", "maxima", "write-back")

    def __call__(self, env, state, sim, action, prev_action) -> Terms:
        m, cset, cfg = env.model, env.cset, env.cfg
        n, dev = action.shape[0], action.device
        check_shapes(sim=(sim, sim_shapes(m, n)),
                     command=(state.command, (n, 3)),
                     action=(action, (n, m.nj)),
                     prev_action=(prev_action, (n, m.nj)),
                     episode_len=(state.episode_len, (n,)),
                     common_step=(state.common_step, ()))
        tabs = env_tables(env, dev)
        geo = geometry(tabs, n, env)
        given = None
        if cset.descriptors.given:
            # the terms outside the kernel's kinds, by their own functions
            data = env.step_data(sim, state.command, action, prev_action)
            given = cset.raw(data, [cset.terms[i] for i in
                                    cset.descriptors.given]).contiguous()
        K = cset.total_cols

        def out(*shape, dtype=F):
            return torch.empty(shape, dtype=dtype, device=dev)

        res = Terms(out(n, dtype=I32), out(dtype=I32), out(n, dtype=B),
                    out(n, dtype=B), out(n, dtype=B), out(n, K),
                    torch.zeros(K, dtype=I32, device=dev))
        self._launch(dev, [
            (c(sim.qpos), F), (c(sim.qvel), F), (c(sim.joint_acc), F),
            (c(sim.applied_torque), F), (c(sim.force_hist), F),
            (c(sim.touchdown), B), (c(sim.last_air_time), F),
            (c(state.command), F), (c(action), F), (c(prev_action), F),
            (c(state.episode_len), I32), (c(state.common_step), I32),
            (c(env.default_joint_pos_task), F), (tabs["term_ints"], I32),
            (tabs["col_ints"], I32),
            (tabs["col_floats"], F), (tabs["col_slots"], I32),
            (tabs["col_illegal"], I32), (given, F),
            *((t, t.dtype) for t in res[:6]), (res.col_max, I32)], [
            n, geo.envs, geo.threads, geo.terms_bytes, m.nq, m.nv, m.nj,
            m.nreport, len(m.foot_report_ids), tabs["n_slots"],
            tabs["n_illegal"], cset.n_terms, K,
            0 if given is None else given.shape[1],
            cfg.max_episode_length], [
            f32(cfg.terminations.contact_threshold),
            f32(cfg.terminations.upside_down_limit), recip(cfg.step_dt)])
        return res._replace(col_max=res.col_max.view(F))


class EnvUpdateKernel(_EnvKernel):
    """``csrc/env_update.cu``: ``CatEnv.update_stage``."""

    prefix = "env_update"
    phases = ("staging", "columns", "per-env logic", "fold", "copy",
              "write-back")

    def __call__(self, env, state, sim, action, prev_action, terms: Terms,
                 draws: UpdateDraws, part: str = "all",
                 shares: Optional[torch.Tensor] = None) -> Updated:
        """``shares``: where given, an (N, 2 n_terms + 6) float32 tensor
        the kernel writes every env's shares of the accumulators into (a
        check of ``fold_shares``)."""
        m, cset, cfg = env.model, env.cset, env.cfg
        ev = cfg.events
        bits = PARTS[part]
        n, dev = action.shape[0], action.device
        nt, K = cset.n_terms, cset.total_cols
        P = 2 * nt + SHARE_EXTRA
        check_shapes(
            sim=(sim, sim_shapes(m, n)), action=(action, (n, m.nj)),
            prev_action=(prev_action, (n, m.nj)),
            terms=(terms, ((n,), (), (n,), (n,), (n,), (n, K), (K,))),
            running_max=(state.running_max, (K,)),
            episode_viol=(state.episode_viol, (n, nt)),
            episode_prob=(state.episode_prob, (n, nt)),
            episode_rew=(state.episode_rew, (n,)),
            command=(state.command, (n, 3)),
            command_time_left=(state.command_time_left, (n,)),
            origin=(state.origin, (n, 2)),
            terrain_row=(state.terrain_row, (n,)),
            terrain_col=(state.terrain_col, (n,)),
            acc_viol=(state.acc_viol, (nt,)),
            acc_prob=(state.acc_prob, (nt,)), acc_rew=(state.acc_rew, ()),
            acc_len=(state.acc_len, ()), acc_count=(state.acc_count, ()),
            acc_term=(state.acc_term, (3,)), shares=(shares, (n, P)),
            draws=(draws, ((n, 3 + m.nj), (n, 4), (n, 4), (n,), (n, 4),
                           (n,), (n,), (n, 2))))
        tabs = env_tables(env, dev)
        geo = geometry(tabs, n, env)
        tmpl = env._reset_template(n)
        sim = type(sim)(*(t.contiguous() for t in sim))

        def out(*shape, dtype=F):
            return torch.empty(shape, dtype=dtype, device=dev)

        if bits & PARTS["reset"]:
            sim_out = type(sim)(*(torch.empty_like(t) for t in sim))
            o = dict(running_max=out(K), max_p=out(nt), reward=out(n),
                     dones=out(n), episode_viol=out(n, nt),
                     episode_prob=out(n, nt), episode_rew=out(n),
                     episode_len=out(n, dtype=I32), action=out(n, m.nj),
                     prev_action=out(n, m.nj), origin=out(n, 2),
                     terrain_row=out(n, dtype=I32))
            acc = dict(acc_viol=out(nt), acc_prob=out(nt), acc_rew=out(),
                       acc_len=out(), acc_count=out(), acc_term=out(3))
            partials = out(geo.blocks, P)
        else:
            sim_out = sim._replace(qvel=torch.empty_like(sim.qvel))
            o, acc, partials = {}, {}, None
        if bits & PARTS["commands"]:
            o.update(command=out(n, 3), command_time_left=out(n))
        table, (rows, cols), hf = tabs["hfield"]
        ptrs = [
            (terms.raw, F), (terms.col_max, F), (terms.episode_len, I32),
            (terms.common_step, I32), (terms.time_out, B),
            (terms.illegal, B), (terms.upside, B),
            (c(state.running_max), F), (cset._init_max_p, F),
            (tabs["term_is_cur"], torch.uint8), (tabs["term_ints"], I32),
            (tabs["col_term"], I32),
            (c(state.episode_viol), F), (c(state.episode_prob), F),
            (c(state.episode_rew), F), (c(state.command), F),
            (c(state.command_time_left), F), (c(state.origin), F),
            (c(state.terrain_row), I32), (c(state.terrain_col), I32),
            (c(action), F), (c(prev_action), F),
            *((t, t.dtype) for t in sim), *((t, t.dtype) for t in tmpl),
            (env._qj_default, F), (env._qj_lo, F), (env._qj_hi, F),
            (table, F), *((c(d), F) for d in draws),
            *((c(t), F) for t in (state.acc_viol, state.acc_prob,
                                  state.acc_rew, state.acc_len,
                                  state.acc_count, state.acc_term))]
        ptrs += [(o.get(k), I32 if k in ("episode_len", "terrain_row") else F)
                 for k in ("running_max", "max_p", "reward", "dones",
                           "episode_viol", "episode_prob", "episode_rew",
                           "episode_len", "action", "prev_action",
                           "command", "command_time_left", "origin",
                           "terrain_row")]
        if bits & PARTS["reset"]:
            ptrs += [(t, t.dtype) for t in sim_out]
        else:
            ptrs += [(sim_out.qvel if k == "qvel" else None, F)
                     for k in type(sim)._fields]
        ptrs += [(acc.get(k), F) for k in ("acc_viol", "acc_prob", "acc_rew",
                                           "acc_len", "acc_count",
                                           "acc_term")]
        ptrs += [(partials, F), (tabs["ticket"] if partials is not None
                                 else None, I32), (shares, F)]
        terr = cfg.terrain
        self._launch(dev, ptrs, [
            n, geo.envs, geo.threads, geo.update_bytes, bits, nt, K, m.nj,
            int(cfg.terrain_curriculum and terr.kind == "hfield"),
            terr.rows, int(ev.push_enabled), *(t.shape[1] for t in sim),
            rows, cols], [*hf, *tabs["update_floats"]])
        if not bits & PARTS["reset"]:
            return Updated(**dict.fromkeys(Updated._fields, None))._replace(
                sim=sim_out, command=o["command"],
                command_time_left=o["command_time_left"])
        o.setdefault("command", None)
        o.setdefault("command_time_left", None)
        return Updated(sim=sim_out, **o, **acc)


class EnvObsKernel(_EnvKernel):
    """``csrc/env_obs.cu``: ``CatEnv.obs_stage``."""

    prefix = "env_obs"
    phases = ("staging", "per-env and proprioceptive", "scan",
              "write-back")

    def __call__(self, env, sim, command, action, draws: ObsDraws):
        m, hs = env.model, env.cfg.height_scan
        n, dev = action.shape[0], action.device
        pts = hs.num_points if hs is not None else 0
        check_shapes(
            qpos=(sim.qpos, (n, m.nq)), qvel=(sim.qvel, (n, m.nv)),
            command=(command, (n, 3)), action=(action, (n, m.nj)),
            draws=(draws, ((n, 3), (n, 3), (n, m.nj), (n, m.nj), (n, pts))))
        tabs = env_tables(env, dev)
        geo = geometry(tabs, n, env)
        table, (rows, cols), hf = tabs["hfield"]
        obs = torch.empty(n, env.num_obs, device=dev)
        self._launch(dev, [
            (c(sim.qpos), F), (c(sim.qvel), F), (c(command), F),
            (c(action), F), (tabs["t2m"], I32),
            (env._scan_grid if hs is not None else None, F), (table, F),
            *((c(d), F) for d in draws.draws), (obs, F)], [
            n, geo.obs_envs, geo.obs_threads, geo.obs_bytes, m.nq, m.nv,
            m.nj, env.num_obs, pts, rows, cols], [
            *hf, *map(f32, (env.ang_vel_scale, *env.command_scale,
                            env.gravity_scale, env.joint_vel_scale)),
            f32(hs.offset_z if hs is not None else 0.0),
            f32(hs.clip if hs is not None else 0.0),
            *map(f32, draws.lo), *map(f32, draws.span)])
        return obs


ENV_TERMS = EnvTermsKernel()
ENV_UPDATE = EnvUpdateKernel()
ENV_OBS = EnvObsKernel()
# the env step's three kernels: (name, wrapper), in the order a step
# launches them
ENV_KERNELS = (("env_terms", ENV_TERMS), ("env_update", ENV_UPDATE),
               ("env_obs", ENV_OBS))


def env_terms(env, state, sim, action, prev_action) -> Terms:
    """``Terms`` of one step on the tensors' device: the CUDA kernel for
    CUDA tensors, ``env.terms_stage`` for CPU tensors."""
    if action.device.type == "cpu":
        return env.terms_stage(state, sim, action, prev_action)
    return ENV_TERMS(env, state, sim, action, prev_action)


def env_update(env, state, sim, action, prev_action, terms, draws,
               part: str = "all") -> Updated:
    """``Updated`` of one step (its ``part``): the CUDA kernel for CUDA
    tensors, ``env.update_stage`` for CPU tensors."""
    if action.device.type == "cpu":
        return env.update_stage(state, sim, action, prev_action, terms,
                                draws, part)
    return ENV_UPDATE(env, state, sim, action, prev_action, terms, draws,
                      part)


def env_obs(env, sim, command, action, draws) -> torch.Tensor:
    """The observation: the CUDA kernel for CUDA tensors, ``env.obs_stage``
    for CPU tensors."""
    if action.device.type == "cpu":
        return env.obs_stage(sim, command, action, draws)
    return ENV_OBS(env, sim, command, action, draws)
