"""The port's banded SWG (plain PyTorch, CPU) vs the JAX package's lax and Pallas paths.

Inputs are seeded numpy panels fed unchanged to both packages (DNA and
BLOSUM62, seeded and unseeded, plus tie-heavy repeats).  Tolerance: exact —
the DP is integer arithmetic, so every SwgResult field must be equal.
"""

import numpy as np
import pytest
import torch
from swg_panels import AA, NT, blosum_matrix, nt_matrix, random_swg_batch

from kaptive_tpu.ops import swg as jax_swg

from kaptive_tpu_torch.ops import swg as port_swg

# One intra-op thread: the plain DP issues many tiny ops, and idle OpenMP
# workers spinning in several test processes at once starve the JAX side.
torch.set_num_threads(1)

PANELS = [
    # name, alphabet, matrix, gap_open, gap_extend, B, rows_max, w_pad, seeded, tie_heavy
    ("protein-unseeded", AA, blosum_matrix, 11, 1, 16, 128, 128, False, False),
    ("protein-seeded", AA, blosum_matrix, 11, 1, 16, 128, 128, True, False),
    ("protein-wide", AA, blosum_matrix, 11, 1, 12, 192, 384, False, False),
    ("nt-unseeded", NT, nt_matrix, 4, 2, 16, 128, 128, False, False),
    ("nt-seeded", NT, nt_matrix, 4, 2, 16, 256, 256, True, False),
    ("nt-repeats", NT, nt_matrix, 4, 2, 16, 128, 128, False, True),
    ("protein-repeats", AA, blosum_matrix, 11, 1, 16, 128, 128, True, True),
]


def _run_both(arrays, matrix, go, ge, rows_max, w_pad, **jax_kw):
    kw = dict(gap_open=go, gap_extend=ge, rows_max=rows_max, w_pad=w_pad, t_pad=w_pad + 2)
    if jax_kw:
        want = jax_swg.banded_swg(*arrays, matrix, **kw, **jax_kw)
    else:
        want = jax_swg.banded_swg_lax(*arrays, matrix, **kw)
    got = port_swg.banded_swg(*(torch.from_numpy(a) for a in arrays), torch.from_numpy(matrix), **kw)
    return got, want


@pytest.mark.parametrize("panel", PANELS, ids=[p[0] for p in PANELS])
def test_plain_equals_lax(panel):
    name, alphabet, matrix_fn, go, ge, B, rows_max, w_pad, seeded, ties = panel
    rng = np.random.default_rng(sum(map(ord, name)))
    arrays = random_swg_batch(rng, alphabet, B, rows_max, w_pad, seeded=seeded, tie_heavy=ties)
    got, want = _run_both(arrays, matrix_fn(), go, ge, rows_max, w_pad)
    for field in want._fields:
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field
        )


def test_all_equal_scores():
    """A matrix scoring every pair alike: every lane of a row ties."""
    rng = np.random.default_rng(11)
    arrays = random_swg_batch(rng, NT, 16, 128, 128, seeded=False)
    got, want = _run_both(arrays, np.full((256, 256), 1, np.int32), 4, 2, 128, 128)
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))


def test_plain_equals_pallas_interpret():
    """One 8-pair 128x128 bucket against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(8)
    arrays = random_swg_batch(rng, AA, 8, 128, 128, seeded=True)
    got, want = _run_both(arrays, blosum_matrix(), 11, 1, 128, 128, impl="pallas")
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))


@pytest.mark.parametrize("kwargs", [
    dict(max_len=300),
    dict(max_len=917, len_slack=229, batch=384, tail_batch=96),
    dict(max_len=780, len_slack=768, widths=(128, 512), batch=128, row_tiers=(1024, 1600)),
])
def test_lattice_matches_jax(kwargs):
    max_len = kwargs.pop("max_len")
    port = port_swg.SwgLattice.for_max_len(max_len, **kwargs)
    ref = jax_swg.SwgLattice.for_max_len(max_len, **kwargs)
    assert (port.rows, port.widths, port.batch, port.row_tiers, port.tail_batch, port.tiers) == (
        ref.rows, ref.widths, ref.batch, ref.row_tiers, ref.tail_batch, ref.tiers
    )


@pytest.mark.parametrize("lattice_kw", [
    None,
    dict(max_len=300, batch=128),
    dict(max_len=400, len_slack=100, batch=384, tail_batch=96),
])
def test_plan_matches_jax(lattice_kw):
    rng = np.random.default_rng(21)
    joint = rng.integers(1, 2000, 700)
    w_needed = 2 * rng.integers(1, 900, 700) + 3
    lattices = (None, None) if lattice_kw is None else (
        port_swg.SwgLattice.for_max_len(**lattice_kw), jax_swg.SwgLattice.for_max_len(**lattice_kw)
    )
    got = port_swg.plan_swg_buckets(joint, w_needed, lattices[0])
    want = jax_swg.plan_swg_buckets(joint, w_needed, lattices[1])
    assert len(got) == len(want)
    for (gs, *g_shape), (ws, *w_shape) in zip(got, want):
        np.testing.assert_array_equal(gs, ws)
        assert g_shape == w_shape


def test_cuda_paths_raise_without_a_card():
    """No fallback: the kernel wrapper refuses CPU tensors, and asking for CUDA raises."""
    from kaptive_tpu_torch.ops.swg_cuda import banded_swg_cuda
    from kaptive_tpu_torch.utils.device import require_cuda, resolve_device

    rng = np.random.default_rng(1)
    arrays = [torch.from_numpy(a) for a in random_swg_batch(rng, NT, 4, 64, 128, seeded=True)]
    with pytest.raises(ValueError, match="CUDA"):
        banded_swg_cuda(*arrays, torch.from_numpy(nt_matrix()),
                        gap_open=4, gap_extend=2, rows_max=64, w_pad=128, t_pad=130)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        require_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
