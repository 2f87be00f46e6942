r"""Device selection and card identity (counterpart of ``default_device_is_tpu``).

The JAX package asks ``ops/scan_pallas.py::default_device_is_tpu`` whether the
default device is an accelerator.  The port names its device explicitly on
every public entry point; these helpers turn that name into a
``torch.device``, refuse a CUDA device when no card is present (there is no
silent CPU fallback), say when a device mesh shards the work, and report the card's name and power limit so every
number the port measures can stand beside them.
"""

from __future__ import annotations

import shutil
import subprocess

import torch


def require_cuda() -> torch.device:
    r"""Return the first CUDA device, or raise when no card is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's kernels need an NVIDIA GPU "
            "(pass device='cpu' to run the plain PyTorch versions instead)"
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device: str | torch.device) -> torch.device:
    r"""``torch.device`` for ``device``; a CUDA request raises without a card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_count(mesh) -> int:
    r"""Slots of a device mesh (:class:`~kaptive_tpu_torch.parallel.mesh.Mesh`), 1 without one."""
    return 1 if mesh is None else int(mesh.devices.size)


def sharded(mesh) -> bool:
    r"""Whether work is cut over ``mesh``: only a mesh of more than one slot shards it."""
    return device_count(mesh) > 1


def card_info() -> str:
    r"""The card's ``name, power.limit`` as ``nvidia-smi`` reports them.

    One line per card, exactly as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints it; raises when ``nvidia-smi`` is missing
    or fails.
    """
    smi = shutil.which("nvidia-smi")
    if smi is None:
        raise RuntimeError("nvidia-smi not found")
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()
