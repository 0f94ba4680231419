"""Build a CUDA source into a shared library with plain nvcc, for ctypes.

The library is built at first use into ``build/cat_tpu_torch/`` beside the
package and named by a hash of the source, every header (``*.cuh``) beside
it and the flags (``NVCC_FLAGS`` and a caller's extra ones, such as
``-DSUBSTEP_PHASE_CLOCKS``), so a changed source, header or flag builds
anew and an unchanged one is reused. nvcc writes to a
temporary name that ``os.replace`` moves into place: there is no lock file
to wait on, and a build cut off half way leaves nothing that looks done.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cat_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 300


@dataclasses.dataclass(frozen=True)
class Built:
    path: Path          # the shared library
    log: str            # nvcc's output (ptxas registers, shared memory, spills)
    seconds: float      # time spent in nvcc now (0 when reused)


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return nvcc


def build_shared_library(source: Path, flags: tuple = ()) -> Built:
    """Compile ``source`` (a .cu file with an extern "C" interface; its
    headers sit beside it) with ``NVCC_FLAGS`` and ``flags``."""
    source = Path(source)
    flags = NVCC_FLAGS + tuple(flags)
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(flags).encode())
    key = digest.hexdigest()[:16]
    out = BUILD_DIR / f"lib{source.stem}-{key}.so"
    log_path = out.with_suffix(".log")
    if out.exists() and log_path.exists():
        return Built(out, log_path.read_text(), 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{out.name}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *flags, "-I", str(source.parent), "-o", str(tmp),
           str(source)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        log = proc.stdout + proc.stderr
        tmp_log = tmp.with_suffix(".log")
        tmp_log.write_text(log)
        os.replace(tmp_log, log_path)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return Built(out, log, time.perf_counter() - t0)


def ptxas_resources(log: str) -> dict:
    """{entry function: dict(registers, stack, spill_stores, spill_loads)}
    from the ``-Xptxas -v`` lines of an nvcc log (``Built.log``); a
    template's instantiation is named ``kernel<arg>``."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            short = re.search(r"\d([a-z][a-z_]*_kernel)(?:ILi(\d+)EE)?",
                              name)
            fn = (name if short is None else short.group(1)
                  + (f"<{short.group(2)}>" if short.group(2) else ""))
            out[fn] = dict(registers=None, stack=0, spill_stores=0,
                           spill_loads=0)
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[fn].update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
    return out
