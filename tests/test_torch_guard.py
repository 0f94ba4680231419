"""The port stands alone: every module of cat_tpu_torch, and chip_smoke.py,
imports with jax, flax, optax and cat_tpu blocked; chip_smoke.py refuses
to run without a card or without the port beside it."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_GUARD = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "cat_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import cat_tpu_torch
names = ["chip_smoke"] + [m.name for m in pkgutil.walk_packages(
    cat_tpu_torch.__path__, "cat_tpu_torch.")]
for name in names:
    importlib.import_module(name)
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not loaded, loaded
print(len(names), "modules")
"""


def _run(args, cwd, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(cwd))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_nothing_of_jax_or_the_jax_package():
    proc = _run(["-c", _GUARD], REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 20


def _no_result(proc):
    lines = proc.stdout.strip().splitlines()
    return proc.returncode != 0 and not (lines and '"ok": true' in lines[-1])


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repo, the script exits non-zero and prints no result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    assert _no_result(_run(["chip_smoke.py"], tmp_path))


def test_chip_smoke_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    proc = _run(["chip_smoke.py"], REPO)
    assert _no_result(proc)
    assert "is_available() is false" in proc.stdout
