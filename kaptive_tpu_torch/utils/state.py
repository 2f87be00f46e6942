r"""Carry state pickled by the JAX package (:mod:`kaptive_tpu`) into the port without importing it.

The two packages keep classes of the same names under the same relative
module paths (``Database``, ``Sequences``, ``Intervals``, ``Alignments``, ...:
dataclasses of numpy arrays, strings and tuples).  :func:`loads_reference`
reads what ``pickle.dumps`` of such an object gives and returns the port's
object of the same name: its ``Unpickler`` resolves a class of module
``kaptive_tpu.x`` as the one of ``kaptive_tpu_torch.x``.  Anything that only a
device runtime can rebuild (an object of ``jax``/``jaxlib``, or of the JAX
package's device modules ``kaptive_tpu.ops``/``kaptive_tpu.parallel``) becomes
an inert placeholder, and a ``Database``'s pickled ``_gene_index_cache`` is
emptied so the port rebuilds its own
:class:`~kaptive_tpu_torch.ops.mapper.GeneIndex` at first use.  The port's own
pickles pass through unchanged (their cached gene index is dropped too: it may
hold device tensors).

A ``GenomeAssembly`` holds a lock, so neither package can pickle it whole:
carry its ``id`` and its ``contigs`` (a ``Sequences``) and rebuild it.

As with any pickle, load only bytes that this program or the JAX package wrote.
"""

from __future__ import annotations

import io
import pickle

_REFERENCE = "kaptive_tpu"
_PORT = "kaptive_tpu_torch"
_DEVICE_ROOTS = ("jax", "jaxlib")
_DEVICE_MODULES = (f"{_REFERENCE}.ops", f"{_REFERENCE}.parallel")


class _Dropped:
    r"""Stands in for an object the port cannot (and need not) rebuild: takes any
    constructor arguments and any pickled state and keeps none."""

    def __init__(self, *args, **kwargs) -> None:
        pass

    def __setstate__(self, state) -> None:
        pass


class ReferenceUnpickler(pickle.Unpickler):
    r"""Resolves ``kaptive_tpu.x`` classes as ``kaptive_tpu_torch.x`` and never imports ``kaptive_tpu`` or ``jax``."""

    def find_class(self, module: str, name: str):
        if module.partition(".")[0] in _DEVICE_ROOTS or module.startswith(_DEVICE_MODULES):
            return _Dropped
        if module == _REFERENCE or module.startswith(_REFERENCE + "."):
            module = _PORT + module[len(_REFERENCE):]
        return super().find_class(module, name)


def loads_reference(data: bytes):
    r"""The port's object for ``data``, the pickle of an object of either package."""
    obj = ReferenceUnpickler(io.BytesIO(data)).load()
    cache = getattr(obj, "_gene_index_cache", None)
    if isinstance(cache, list):
        cache.clear()
    return obj
