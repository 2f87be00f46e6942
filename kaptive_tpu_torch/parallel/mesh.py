r"""Device mesh of the port (counterpart of :mod:`kaptive_tpu.parallel.mesh`).

A :class:`Mesh` is a ``(data, model)`` grid of ``torch.device`` slots that one
process drives: assemblies shard over the ``data`` axis, the gene minimizer
table over the ``model`` axis, and each shard's kernels launch on its own
slot's device.  The merges are device-to-device copies, not collectives, so a
grid may name one device several times (``[cuda:0] * 4`` on a one-card
machine, ``[cpu] * 8`` in the tests): shards placed on one device run one
after another and give the same result.  Multi-host runs are the business of
:mod:`kaptive_tpu_torch.parallel.multihost`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kaptive_tpu_torch.utils.device import require_cuda, resolve_device


@dataclass(frozen=True, eq=False)
class Mesh:
    r"""A ``(data, model)`` grid of devices: ``devices`` is a numpy object array of ``torch.device``."""

    devices: np.ndarray

    @property
    def shape(self) -> dict[str, int]:
        r"""Axis sizes by name, as ``jax.sharding.Mesh.shape`` gives them."""
        data, model = self.devices.shape
        return {"data": data, "model": model}

    @property
    def flat(self) -> list[torch.device]:
        r"""Every slot's device in flattened ``(data, model)`` order."""
        return list(self.devices.flat)

    def slots_on(self, device: torch.device) -> int:
        r"""How many slots of the grid name ``device``."""
        return sum(d == device for d in self.devices.flat)


def make_mesh(
    n_devices: int | None = None,
    model_parallel: int = 1,
    devices: list | None = None,
) -> Mesh:
    r"""Create a (data, model) mesh over the available devices.

    Args:
        n_devices: slots to use (default: all of ``devices``).
        model_parallel: size of the ``model`` axis (gene-table shards);
            must divide ``n_devices``.
        devices: explicit device list, which may repeat a device (default:
            every visible CUDA card; raises when there is none).
    """
    if devices is None:
        require_cuda()
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    n = n_devices or len(devs)
    if not 0 < n <= len(devs):
        raise ValueError(f"n_devices={n} outside 1..{len(devs)}")
    if model_parallel < 1 or n % model_parallel != 0:
        raise ValueError(f"model_parallel={model_parallel} must divide device count {n}")
    grid = np.empty(n, dtype=object)
    grid[:] = devs[:n]
    return Mesh(grid.reshape(n // model_parallel, model_parallel))

