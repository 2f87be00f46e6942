r"""Build-at-first-use of the port's CUDA sources (``kaptive_tpu_torch/csrc/*.cu``).

Each source is compiled on its own by ``nvcc -gencode arch=compute_90a,code=sm_90a``
into a shared library with a plain C interface under :data:`BUILD_DIR`,
through a temporary file and ``os.replace`` (two processes building at once
never load a half-written library), and loaded with ctypes.  Nothing is
compiled at import: the CPU tests import every module.  The ``-Xptxas -v``
report (registers, shared memory, spills) is kept beside the library.

The sources ship inside the package (:data:`CSRC`, package data of the
wheel).  :data:`BUILD_DIR` is ``build/kaptive_tpu_torch/`` at the root of a
checkout (the package's parent holds the repository's ``pyproject.toml`` and
the JAX package beside it); an installed package builds into a per-user
cache, ``$XDG_CACHE_HOME/kaptive_tpu_torch``, else
``~/.cache/kaptive_tpu_torch``.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
from collections.abc import Callable
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"


def build_dir() -> Path:
    r"""Where the port's libraries are built: the checkout's ``build/kaptive_tpu_torch/``,
    else the per-user cache (``$XDG_CACHE_HOME``, else ``~/.cache``)."""
    root = PACKAGE.parent
    if (root / "pyproject.toml").is_file() and (root / "kaptive_tpu").is_dir():
        return root / "build" / "kaptive_tpu_torch"
    xdg = os.environ.get("XDG_CACHE_HOME", "")
    cache = Path(xdg) if os.path.isabs(xdg) else Path.home() / ".cache"
    return cache / "kaptive_tpu_torch"


BUILD_DIR = build_dir()
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the port's kernels")


class CudaLibrary:
    r"""One ``csrc/<name>.cu`` source, built into ``libkaptive_<name>.so`` when it is
    missing or older than the source, and loaded once per process.

    ``declare(lib)`` sets the ``argtypes``/``restype`` of every C function.
    """

    def __init__(self, source: str, declare: Callable[[ctypes.CDLL], None]) -> None:
        self.source = CSRC / source
        stem = Path(source).stem
        self.library = BUILD_DIR / f"libkaptive_{stem}.so"
        self.log = BUILD_DIR / f"libkaptive_{stem}.nvcc.txt"  # nvcc's -Xptxas -v report
        self._declare = declare
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None

    def _compile(self) -> None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_name(f"{self.library.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        self.log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, self.library)

    def load(self) -> ctypes.CDLL:
        r"""Compile when stale, then load and declare the library (once per process)."""
        with self._lock:
            if self._lib is None:
                if not self.library.exists() or self.library.stat().st_mtime < self.source.stat().st_mtime:
                    self._compile()
                lib = ctypes.CDLL(str(self.library))
                self._declare(lib)
                self._lib = lib
        return self._lib

    def ptxas_report(self) -> str:
        r"""The last build's ``-Xptxas -v`` report, one entry per kernel: its name (with its
        template argument), registers, shared memory and, where there are any, its stack
        frame (local arrays) and spilled bytes."""
        out, name, spill = [], "?", ""
        for ln in self.log.read_text().splitlines():
            if m := re.search(r"Compiling entry function '\w*?\d([a-z_]+_kernel)(?:IL[ib](\d+)E)?", ln):
                name = m[1] + (f"<{m[2]}>" if m[2] else "")
            elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln):
                spill = f", stack {m[1]} B" if int(m[1]) else ""
                spill += f", spills {m[2]}/{m[3]} B" if int(m[2]) or int(m[3]) else ""
            elif m := re.search(r"Used (\d+ registers)(?:.*?(\d+ bytes smem))?", ln):
                out.append(f"{name}: {m[1]}" + (f", {m[2]}" if m[2] else "") + spill)
        return " | ".join(out)


def check_tensor(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple, device: torch.device) -> None:
    r"""Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on ``device``."""
    if x.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
