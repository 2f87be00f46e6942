"""What the ``measure_*.py`` scripts share: CUDA sources built beside the port's own libraries,
two versions timed in the order parent, change, change, parent, and the check that neither JAX
nor the JAX package was imported.  Imported by those scripts; it runs nothing itself.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from collections.abc import Callable
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


def build_sources(sources: dict[str, str], out: Path) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Each CUDA source (``name -> text``) written to ``out/name.cu`` and built, all at once, with
    the port's nvcc flags into ``out/libname.so``: ``name -> (library, nvcc's output)``."""
    from kaptive_tpu_torch.utils.nvcc import NVCC_FLAGS, _nvcc

    out.mkdir(parents=True, exist_ok=True)

    def build(name: str) -> tuple[ctypes.CDLL, str]:
        cu, lib = out / f"{name}.cu", out / f"lib{name}.so"
        cu.write_text(sources[name])
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(cu)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stderr}")
        return ctypes.CDLL(str(lib)), proc.stdout + proc.stderr

    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return dict(zip(sources, pool.map(build, sources)))


def parent_change(parent: Callable[[], object], change: Callable[[], object],
                  timed: Callable[[Callable[[], object]], float]) -> tuple[list[float], list[float]]:
    """``timed`` of each in the order parent, change, change, parent: ``([parent, parent], [change, change])``."""
    times: dict[str, list[float]] = {"parent": [], "change": []}
    for who in ("parent", "change", "change", "parent"):
        times[who].append(timed(parent if who == "parent" else change))
    return times["parent"], times["change"]


def assert_no_jax() -> None:
    """Raise if a module of jax, jaxlib or the JAX package was imported."""
    for roots in (("jax", "jaxlib"), ("kaptive_tpu",)):
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in roots)
        if loaded:
            raise AssertionError(f"modules of {roots} were imported: {loaded}")
