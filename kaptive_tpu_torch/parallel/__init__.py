r"""Parallel typing of the port: device meshes, sharded typing steps, streaming, multi-host.

A :class:`~kaptive_tpu_torch.parallel.mesh.Mesh` is a ``(data, model)`` grid
of devices that one process drives: assemblies shard over ``data``, the gene
minimizer table over ``model`` (its per-shard anchors and screen tallies
merged by device-to-device copies), and the DP pairs over every slot
(:mod:`kaptive_tpu_torch.parallel.typing`, :mod:`kaptive_tpu_torch.parallel.screen`);
a grid may repeat a card.  Runs over several processes or machines share
their inputs through :mod:`kaptive_tpu_torch.parallel.multihost` (gloo).
"""

from kaptive_tpu_torch.parallel.mesh import Mesh, make_mesh
from kaptive_tpu_torch.parallel.pipeline import auto_batch_size, stream_batches, stream_type
from kaptive_tpu_torch.parallel.screen import locus_screen_batch, sharded_locus_screen

__all__ = [
    "Mesh",
    "auto_batch_size",
    "locus_screen_batch",
    "make_mesh",
    "sharded_locus_screen",
    "stream_batches",
    "stream_type",
]
