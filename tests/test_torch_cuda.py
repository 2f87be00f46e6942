"""Hopper banded-SWG kernels vs their plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file imports
only torch, numpy and the port; ``tests/conftest.py`` imports jax and sets it
up for the JAX package's CPU tests, so run this file on the card's machine
with ``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``.

Tolerance: exact.  The DP is integer arithmetic; every SwgResult field and
every traceback byte on rows the query reaches must be equal.
"""

import numpy as np
import pytest
import torch

from swg_panels import AA, NT, blosum_matrix, nt_matrix, random_swg_batch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from kaptive_tpu_torch.ops import swg_cuda

    swg_cuda.build()
    return torch.device("cuda", 0)


CASES = [
    # name, alphabet, matrix, gap_open, gap_extend, B, rows_max, w_pad, seeded, tie_heavy
    ("protein-unseeded", AA, blosum_matrix, 11, 1, 13, 384, 640, False, False),
    ("protein-seeded", AA, blosum_matrix, 11, 1, 8, 128, 128, True, False),
    ("nt-extension", NT, nt_matrix, 4, 2, 37, 1024, 512, True, False),
    ("nt-unseeded", NT, nt_matrix, 4, 2, 16, 256, 384, False, False),
    ("nt-repeats", NT, nt_matrix, 4, 2, 24, 256, 128, False, True),
    ("protein-repeats", AA, blosum_matrix, 11, 1, 9, 192, 256, True, True),
    ("wide-2048", NT, nt_matrix, 4, 2, 5, 320, 2048, False, False),
    ("wide-8192", AA, blosum_matrix, 11, 1, 3, 128, 8192, False, False),
    ("lanes-per-thread-4", AA, blosum_matrix, 11, 1, 4, 200, 1152, False, False),
    ("lanes-per-thread-8", NT, nt_matrix, 4, 2, 3, 96, 3072, True, False),
    ("idle-threads-4224", AA, blosum_matrix, 11, 1, 2, 96, 4224, False, True),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_equals_plain(device, case):
    from kaptive_tpu_torch.ops.swg import fill_band_plain, traceback_plain
    from kaptive_tpu_torch.ops.swg_cuda import as_kernel_matrix, swg_fill_cuda, swg_traceback_cuda

    name, alphabet, matrix_fn, go, ge, B, rows_max, w_pad, seeded, ties = case
    rng = np.random.default_rng(sum(map(ord, name)))
    arrays = random_swg_batch(rng, alphabet, B, rows_max, w_pad, seeded=seeded, tie_heavy=ties)
    q, ql, t, tl, off, kl = (torch.from_numpy(a).to(device) for a in arrays)
    mat = as_kernel_matrix(torch.from_numpy(matrix_fn()), device)
    kw = dict(gap_open=go, gap_extend=ge, rows_max=rows_max, w_pad=w_pad)

    tb_k, *best_k = swg_fill_cuda(q, ql, t, tl, off, kl, mat, **kw)
    tb_p, *best_p = fill_band_plain(q, ql, t, tl, off, kl, mat, **kw)
    for got, want in zip(best_k, best_p):
        assert torch.equal(got, want)
    rows = torch.arange(rows_max, device=device)[None, :, None] < ql.to(torch.int64)[:, None, None]
    assert torch.equal(torch.where(rows, tb_k, 0), torch.where(rows, tb_p, 0))

    tr = dict(rows_max=rows_max, w_pad=w_pad, t_pad=w_pad + 2)
    res_k = swg_traceback_cuda(tb_k, q, t, *best_k, off, **tr)
    res_p = traceback_plain(tb_p, q, t, *best_p, off, **tr)
    torch.cuda.synchronize()
    for f, got, want in zip(res_p._fields, res_k.unbind(0), res_p):
        assert torch.equal(got, want), f


def test_front_door_routes_cuda_to_kernels(device):
    from kaptive_tpu.utils.metrics import reset_metrics, snapshot

    from kaptive_tpu_torch.ops.swg import banded_swg

    rng = np.random.default_rng(3)
    arrays = random_swg_batch(rng, NT, 7, 128, 128, seeded=True)
    args = [torch.from_numpy(a).to(device) for a in arrays]
    reset_metrics()
    banded_swg(*args, torch.from_numpy(nt_matrix()).to(device),
               gap_open=4, gap_extend=2, rows_max=128, w_pad=128, t_pad=130)
    counts = snapshot()
    assert counts.get("swg.cuda.fill") == 1 and counts.get("swg.cuda.traceback") == 1
    assert "swg.plain.fill" not in counts and "swg.plain.traceback" not in counts


def test_fill_rejects_too_wide_band(device):
    from kaptive_tpu_torch.ops.swg_cuda import as_kernel_matrix, swg_fill_cuda

    rng = np.random.default_rng(4)
    arrays = random_swg_batch(rng, NT, 2, 64, 16384, seeded=True)
    args = [torch.from_numpy(a).to(device) for a in arrays]
    with pytest.raises(ValueError, match="w_pad"):
        swg_fill_cuda(*args, as_kernel_matrix(nt_matrix(), device),
                      gap_open=4, gap_extend=2, rows_max=64, w_pad=16384)
