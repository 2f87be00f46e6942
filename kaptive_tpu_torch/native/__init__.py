r"""Native (C++) host-side components, loaded via ctypes.

:mod:`kaptive_tpu_torch.native.hostio` builds ``csrc/hostio.cpp`` at first use.
"""
