"""Build the JAX package's native host library once, whole, before any test loads it.

``kaptive_tpu/native/hostio.py`` compiles ``native/hostio.cpp`` with g++
straight into ``kaptive_tpu/native/_hostio.so`` the first time it is imported,
and takes any such file that is newer than its source as built.  Under
pytest-xdist several workers start on a fresh checkout at once: while one
worker's g++ is still writing the file, another worker finds it, loads it and
fails with ``OSError: ... _hostio.so: file too short``.  The JAX package stays
as it is, so the port's tests build the library here instead: under a file
lock, into a temporary name, renamed into place when it is whole.  The JAX
module then finds a whole, fresh library and never runs g++ itself.

Every xdist worker imports each test module while it collects, before it runs
a test, so a call at the top of one test module covers every worker's tests.
"""

from __future__ import annotations

import fcntl
import importlib.util
import os
import subprocess
import sys
from pathlib import Path


def jax_package_root() -> Path:
    """The directory that holds the ``kaptive_tpu`` package that ``import kaptive_tpu`` would load
    (found without importing it)."""
    return Path(importlib.util.find_spec("kaptive_tpu").origin).resolve().parent.parent


def _loads(so: Path) -> bool:
    """Whether ``so`` loads, tried in a child process: a truncated library can kill the loader."""
    probe = subprocess.run([sys.executable, "-c", "import ctypes, sys; ctypes.CDLL(sys.argv[1])", str(so)],
                           capture_output=True, timeout=60)
    return probe.returncode == 0


def ensure_jax_hostio(root: Path | None = None) -> Path:
    """Make ``<root>/kaptive_tpu/native/_hostio.so`` a whole library no older than its source;
    returns its path.  ``root`` defaults to :func:`jax_package_root`."""
    root = root or jax_package_root()
    src = root / "native" / "hostio.cpp"
    so = root / "kaptive_tpu" / "native" / "_hostio.so"
    lock = root / "build" / "jax_hostio.lock"
    lock.parent.mkdir(parents=True, exist_ok=True)
    with open(lock, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        if so.exists() and so.stat().st_mtime >= src.stat().st_mtime and _loads(so):
            return so
        tmp = so.with_name(f".{so.name}.{os.getpid()}")
        # The JAX package's own command (kaptive_tpu/native/hostio.py::_build).
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC", str(src), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
    return so
