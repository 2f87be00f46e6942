r"""Device compute of the port: the banded SWG kernel family and the host-seeded mapper.

- :mod:`kaptive_tpu_torch.ops.swg` — ``banded_swg`` front door, shape lattice
  and bucket planner, and the plain PyTorch fill + traceback.
- :mod:`kaptive_tpu_torch.ops.swg_cuda` — ctypes binding of the Hopper fill and
  traceback kernels (``csrc/swg.cu``).
- :mod:`kaptive_tpu_torch.ops.minimizer` — host minimizer scan and contig index.
- :mod:`kaptive_tpu_torch.ops.mapper` — host seeding, chaining and the batched
  extension DP.
"""
