r"""Jax-free access to the JAX package's backend-neutral modules.

The port reuses ``kaptive_tpu``'s numpy-only modules (``core``, ``db``,
``utils``, ``native`` and ``serotyping/{analysis,models,io}.py``), but two
package ``__init__`` files on the way import ``jax``:

- ``kaptive_tpu/__init__.py`` configures JAX's compilation cache;
- ``kaptive_tpu/serotyping/__init__.py`` imports ``serotyping/core.py`` and
  through it ``ops/mapper.py``.

Unless ``jax`` is already loaded in this process, both packages are
registered here as bare package modules (``__path__`` only, plus
``__version__`` on the top one), so their submodules load without those
``__init__`` files and ``jax`` is never imported, even where it is installed.
A name that only those ``__init__`` files define (``Serotyper``, say) then
raises an ImportError that says so.  Where ``jax`` is already loaded (the
parity tests import it first), the normal packages are used, so the tests'
JAX objects and the port's are the same classes.  This module must be
imported before anything of ``kaptive_tpu``; ``kaptive_tpu_torch/__init__.py``
imports it first.
"""

from __future__ import annotations

import importlib
import importlib.util
import sys
import types
from pathlib import Path


def _bare_package(name: str, path: Path) -> types.ModuleType:
    pkg = types.ModuleType(name)
    pkg.__path__ = [str(path)]
    pkg.__package__ = name

    def __getattr__(attr: str):
        # Dunders and submodules stay plain misses, so hasattr() and the
        # import system go on as usual; any other name is one the skipped
        # __init__ would have defined.
        if attr.startswith("__") or (path / f"{attr}.py").exists() or (path / attr).is_dir():
            raise AttributeError(f"module {name!r} has no attribute {attr!r}")
        raise ImportError(
            f"{name}.{attr} is not available: kaptive_tpu_torch loaded {name!r} as a bare "
            f"package without its __init__ (which imports jax), because jax was not loaded "
            f"yet. Import jax or the JAX package before kaptive_tpu_torch to use both in one process.",
            name=name,
        )

    pkg.__getattr__ = __getattr__
    sys.modules[name] = pkg
    return pkg


def _install_bare_packages() -> None:
    if "jax" in sys.modules:
        return
    spec = importlib.util.find_spec("kaptive_tpu")
    if spec is None or not spec.submodule_search_locations:
        raise ImportError("kaptive_tpu_torch needs the kaptive_tpu package beside it")
    root = Path(next(iter(spec.submodule_search_locations)))
    if "kaptive_tpu" not in sys.modules:
        top = _bare_package("kaptive_tpu", root)
        top.__version__ = importlib.import_module("kaptive_tpu._version").__version__
    if "kaptive_tpu.serotyping" not in sys.modules:
        sys.modules["kaptive_tpu"].serotyping = _bare_package("kaptive_tpu.serotyping", root / "serotyping")


_install_bare_packages()

from kaptive_tpu._version import __version__  # noqa: E402
from kaptive_tpu.serotyping.analysis import (  # noqa: E402
    HitTable,
    call_typeability,
    edge_partial_mask,
    pick_best_loci,
    reconstruct_loci,
    resolve_phenotypes,
)
from kaptive_tpu.serotyping.io import KaptiveRow, Pha4geRow  # noqa: E402
from kaptive_tpu.serotyping.models import (  # noqa: E402
    GeneHits,
    GeneState,
    LocusPieces,
    SerotypingProblem,
    SerotypingResult,
)

__all__ = [
    "GeneHits",
    "GeneState",
    "HitTable",
    "KaptiveRow",
    "LocusPieces",
    "Pha4geRow",
    "SerotypingProblem",
    "SerotypingResult",
    "__version__",
    "call_typeability",
    "edge_partial_mask",
    "pick_best_loci",
    "reconstruct_loci",
    "resolve_phenotypes",
]
