r"""kaptive-tpu on PyTorch and CUDA: the locus-typing path for one NVIDIA H100.

A second package beside :mod:`kaptive_tpu` (the JAX reference, left as it is).
It imports ``torch`` and never ``jax``.  Sub-layout and names follow the JAX
package so each counterpart is easy to find:

- :mod:`kaptive_tpu_torch.cli` — the ``kaptive-tpu-torch`` command line
  (``db``, ``type`` with ``--screen-only``, ``convert``); ``type`` lives in
  :mod:`kaptive_tpu_torch.serotyping.cli`.
- :mod:`kaptive_tpu_torch.ops.swg` — banded Smith-Waterman-Gotoh front doors
  (with and without BAM CIGARs) and their plain PyTorch versions;
  :mod:`kaptive_tpu_torch.ops.swg_cuda` binds the hand-written Hopper kernels
  in ``csrc/swg.cu``.
- :mod:`kaptive_tpu_torch.ops.scan` — the row-compact minimizer scan's front
  door and plain version; :mod:`kaptive_tpu_torch.ops.scan_cuda` binds its
  Hopper kernel in ``csrc/scan.cu``.
- :mod:`kaptive_tpu_torch.ops.minimizer` / :mod:`kaptive_tpu_torch.ops.mapper`
  — the mapper, host-seeded (native C seeding and numpy chaining on the CPU,
  extension DP on the card) or device-seeded (``KAPTIVE_SEED_MODE=device``:
  scan, match and chain on the card too).
- :mod:`kaptive_tpu_torch.utils.nvcc` — builds ``csrc/*.cu`` at first use.
- :mod:`kaptive_tpu_torch.core.pairwise` — the batched protein aligner.
- :mod:`kaptive_tpu_torch.serotyping` — the ``Serotyper`` twin.
- :mod:`kaptive_tpu_torch.parallel.pipeline` — ``stream_type``;
  :mod:`kaptive_tpu_torch.parallel.screen` — screen mode's tallies and scores.

The backend-neutral layers (``core``, ``db``, the serotyping decision,
result and report modules, ``utils.metrics``/``utils.profiling``) are reused
from :mod:`kaptive_tpu` by import.  :mod:`kaptive_tpu_torch._reuse` is
imported first so that doing so never imports ``jax``.
"""

from kaptive_tpu_torch._reuse import __version__

__all__ = ["__version__"]
