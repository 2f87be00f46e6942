r"""Streaming typing of the port (one card; multi-GPU is later work)."""

from kaptive_tpu_torch.parallel.pipeline import stream_batches, stream_type

__all__ = ["stream_batches", "stream_type"]
