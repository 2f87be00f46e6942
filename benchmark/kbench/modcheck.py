r"""The run-wide check that neither JAX nor the JAX package was loaded.

Names are compared by their top-level part, before the first dot, whole:
``kaptive_tpu_torch`` is the port and passes; ``kaptive_tpu`` is the JAX
package and fails.
"""

from __future__ import annotations

import sys
from collections.abc import Iterable

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "kaptive_tpu"})


def forbidden_loaded(names: Iterable[str] | None = None) -> list[str]:
    r"""The forbidden top-level names among ``names`` (default: ``sys.modules``)."""
    names = list(sys.modules) if names is None else list(names)
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
