r"""Streaming typing of the port (one card; multi-GPU is later work)."""

from kaptive_tpu_torch.parallel.pipeline import auto_batch_size, stream_batches, stream_type

__all__ = ["auto_batch_size", "stream_batches", "stream_type"]
