r"""kaptive-tpu on PyTorch and CUDA: the locus-typing main path for one NVIDIA H100.

A second package beside :mod:`kaptive_tpu` (the JAX reference, left as it is).
It imports ``torch`` and never ``jax``.  Sub-layout and names follow the JAX
package so each counterpart is easy to find:

- :mod:`kaptive_tpu_torch.ops.swg` — banded Smith-Waterman-Gotoh front door
  and its plain PyTorch version; :mod:`kaptive_tpu_torch.ops.swg_cuda` binds
  the hand-written Hopper kernels in ``csrc/swg.cu``.
- :mod:`kaptive_tpu_torch.ops.minimizer` / :mod:`kaptive_tpu_torch.ops.mapper`
  — the host-seeded mapper (native C seeding and numpy chaining on the CPU,
  extension DP on the card).
- :mod:`kaptive_tpu_torch.core.pairwise` — the batched protein aligner.
- :mod:`kaptive_tpu_torch.serotyping` — the ``Serotyper`` twin.
- :mod:`kaptive_tpu_torch.parallel.pipeline` — ``stream_type``.

The backend-neutral layers (``core``, ``db``, the serotyping decision,
result and report modules, ``utils.metrics``/``utils.profiling``) are reused
from :mod:`kaptive_tpu` by import.  :mod:`kaptive_tpu_torch._reuse` is
imported first so that doing so never imports ``jax``.
"""

from kaptive_tpu_torch._reuse import __version__

__all__ = ["__version__"]
