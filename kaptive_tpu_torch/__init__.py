r"""kaptive-tpu on PyTorch and CUDA: the locus-typing path for one NVIDIA H100.

A second package beside :mod:`kaptive_tpu` (the JAX reference, left as it is).
It imports ``torch``, never ``jax`` and nothing of :mod:`kaptive_tpu`.  Sub-layout and names follow the JAX
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
- :mod:`kaptive_tpu_torch.bgc` — the BGC toolkit (annotator, gene HMM,
  architectural predictor and trainer); :mod:`kaptive_tpu_torch.ops.viterbi`
  holds its two Viterbi decodes' front doors and plain versions, and
  :mod:`kaptive_tpu_torch.ops.viterbi_cuda` binds their Hopper kernels in
  ``csrc/viterbi.cu``.

- :mod:`kaptive_tpu_torch.core`, :mod:`kaptive_tpu_torch.db`,
  :mod:`kaptive_tpu_torch.compare`, the serotyping decision, result and
  report modules, :mod:`kaptive_tpu_torch.native.hostio` (``csrc/hostio.cpp``)
  and ``utils.metrics``/``utils.profiling`` — the port's own copies of the
  backend-neutral layers, under the same relative paths and names.
- :mod:`kaptive_tpu_torch.utils.state` — loads state pickled by the JAX package.

The port imports nothing of :mod:`kaptive_tpu`: both packages can be loaded
in one process in any order, and the port runs where the other is absent.
"""

from kaptive_tpu_torch._version import __version__

__all__ = ["__version__"]
