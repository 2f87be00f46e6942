r"""Device compute of the port: the banded SWG kernel family, the row-compact scan, the mapper
and the BGC toolkit's Viterbi decodes.

- :mod:`kaptive_tpu_torch.ops.swg` — ``banded_swg`` front door, shape lattice
  and bucket planner, and the plain PyTorch fill + traceback.
- :mod:`kaptive_tpu_torch.ops.swg_cuda` — ctypes binding of the Hopper fill and
  traceback kernels (``csrc/swg.cu``).
- :mod:`kaptive_tpu_torch.ops.scan` — ``rowcompact_scan`` front door, the plain
  PyTorch row-compact minimizer scan, lane compaction and stream unpacking.
- :mod:`kaptive_tpu_torch.ops.scan_cuda` — ctypes binding of the Hopper
  row-compact scan kernel (``csrc/scan.cu``).
- :mod:`kaptive_tpu_torch.ops.minimizer` — host minimizer scan, contig index
  and upload packing.
- :mod:`kaptive_tpu_torch.ops.mapper` — host- and device-seeded seeding,
  chaining and the batched extension DP.
- :mod:`kaptive_tpu_torch.ops.viterbi` — the gene-HMM and architectural
  Viterbi front doors and plain PyTorch versions;
  :mod:`kaptive_tpu_torch.ops.viterbi_cuda` binds their Hopper kernels
  (``csrc/viterbi.cu``).
"""
