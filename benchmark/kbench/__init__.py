r"""The benchmark harness of ``kaptive_tpu_torch``: generators, window, trace reading."""
