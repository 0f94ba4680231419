"""Build a CUDA source into a shared library with plain nvcc, for ctypes.

The library is built at first use into ``build/cat_tpu_torch/`` beside the
package and named by a hash of the source and the flags, so a changed
source builds anew and an unchanged one is reused. nvcc writes to a
temporary name that ``os.replace`` moves into place: there is no lock file
to wait on, and a build cut off half way leaves nothing that looks done.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
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


def build_shared_library(source: Path) -> Built:
    """Compile ``source`` (a .cu file with an extern "C" interface)."""
    source = Path(source)
    key = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{source.stem}-{key}.so"
    log_path = out.with_suffix(".log")
    if out.exists() and log_path.exists():
        return Built(out, log_path.read_text(), 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{out.name}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
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
