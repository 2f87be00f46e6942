"""Hopper kernels (banded SWG, CIGAR traceback, row-compact and flat scan, gene and architectural
Viterbi) vs their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file imports
only torch, numpy and the port; ``tests/conftest.py`` imports jax and sets it
up for the JAX package's CPU tests, so run this file on the card's machine
with ``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``.

Tolerance: exact.  The DP is integer arithmetic; every SwgResult field and
every traceback byte on rows the query reaches must be equal; the CIGAR
traceback's whole ``ops`` buffers, ``n_ops`` and ``overflow`` too.  The scan's
``hashes``, ``aux`` and ``counts`` must be equal, and the flat scan's
``selected``, ``hashes`` and ``strands``.  The screen's ``best`` and
tallies on the card equal the CPU's exactly, its float32 ``weighted`` scores
to ``rtol=1e-6``; the CLI on the card writes the in-process rows' bytes.
The Viterbi kernels' states, paths and scores equal the plain forms' (run on
the CPU); the BGC toolkit on the card equals its CPU path except for the
predictions' scores, held to ``rtol=1e-5`` (the emissions' matrix product
sums in another order).  Device seeding in chunks: its peak memory at stream
batches 8 and 32 differs by less than one chunk's worth, and a batch of 64
maps to the same alignments in chunks of 5.  The mesh on four slots of the
card (``cuda:0`` four times on a one-card machine): typing rows, streamed rows
and screen equal one card's exactly, ``sharded_banded_swg`` equals
``banded_swg`` exactly, and sharded seeding's peak memory stays within the
budget of one slot.
"""

import io
from unittest import mock

import numpy as np
import pytest
import torch

from scan_panels import EDGE_PANELS, KW_CASES, PANELS, any_max_w, any_plan, random_stream
from swg_panels import (
    AA, CIGAR_PANELS, GAP_RUNS, NT, best_cell_panel, blosum_matrix, cigar_panel, gap_run_panel, nt_matrix,
    random_swg_batch,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from kaptive_tpu_torch.ops import swg_cuda

    swg_cuda.build()
    print(f"swg.cu ptxas: {swg_cuda.LIBRARY.ptxas_report()}")
    return torch.device("cuda", 0)


# The fill's warp form takes every multiple of 128 up to 1024; every other width goes to the wide form.
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
    ("warp-128-many-pairs", NT, nt_matrix, 4, 2, 75, 160, 128, True, True),
    ("warp-256", AA, blosum_matrix, 11, 1, 19, 200, 256, False, False),
    ("warp-384-repeats", NT, nt_matrix, 4, 2, 9, 130, 384, False, True),
    ("warp-512-repeats", AA, blosum_matrix, 11, 1, 10, 97, 512, False, True),
    ("warp-640-repeats", NT, nt_matrix, 4, 2, 9, 130, 640, False, True),
    ("warp-896", AA, blosum_matrix, 11, 1, 5, 150, 896, False, False),
    ("warp-1024-repeats", NT, nt_matrix, 4, 2, 6, 100, 1024, True, True),
    ("wide-200-odd-width", AA, blosum_matrix, 11, 1, 6, 70, 200, True, True),
]
WARP_WIDTHS = tuple(range(128, 1025, 128))
CLUSTER_MAX_W_PAD = 131072  # the widest band the fill's cluster form takes (16 CTAs of 8,192 lanes)


def _assert_kernels_equal_plain(device, arrays, matrix, go, ge, rows_max, w_pad):
    """Fill then traceback, kernel vs plain, on one bucket; returns the kernel's (8, B) results."""
    from kaptive_tpu_torch.ops.swg import fill_band_plain, traceback_plain
    from kaptive_tpu_torch.ops.swg_cuda import as_kernel_matrix, fill_form, swg_fill_cuda, swg_traceback_cuda

    q, ql, t, tl, off, kl = (torch.from_numpy(a).to(device) for a in arrays)
    mat = as_kernel_matrix(torch.from_numpy(matrix), device)
    if mat.dtype == torch.int32 or w_pad > 8192:
        assert fill_form(w_pad, mat.dtype) == ("cluster" if w_pad <= CLUSTER_MAX_W_PAD else "segmented")
    else:
        assert fill_form(w_pad) == ("warp" if w_pad in WARP_WIDTHS else "wide")
    kw = dict(gap_open=go, gap_extend=ge, rows_max=rows_max, w_pad=w_pad)

    tb_k, *best_k = swg_fill_cuda(q, ql, t, tl, off, kl, mat, **kw)
    tb_p, *best_p = fill_band_plain(q, ql, t, tl, off, kl, mat, **kw)
    for name, got, want in zip(("best", "best_i", "best_j"), best_k, best_p):
        assert torch.equal(got, want), name
    rows = torch.arange(rows_max, device=device)[None, :, None] < ql.to(torch.int64)[:, None, None]
    assert torch.equal(torch.where(rows, tb_k, 0), torch.where(rows, tb_p, 0))

    tr = dict(rows_max=rows_max, w_pad=w_pad, t_pad=w_pad + 2)
    res_k = swg_traceback_cuda(tb_k, q, t, *best_k, off, **tr)
    res_p = traceback_plain(tb_p, q, t, *best_p, off, **tr)
    torch.cuda.synchronize()
    for f, got, want in zip(res_p._fields, res_k.unbind(0), res_p):
        assert torch.equal(got, want), f
    return res_k


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_equals_plain(device, case):
    name, alphabet, matrix_fn, go, ge, B, rows_max, w_pad, seeded, ties = case
    rng = np.random.default_rng(sum(map(ord, name)))
    arrays = random_swg_batch(rng, alphabet, B, rows_max, w_pad, seeded=seeded, tie_heavy=ties)
    _assert_kernels_equal_plain(device, arrays, matrix_fn(), go, ge, rows_max, w_pad)


@pytest.mark.parametrize("w_pad", [128, 256, 512, 640, 1024, 1152, 200])
def test_best_cell_rule_on_ties(device, w_pad):
    """Equal maxima in two rows and in one row, the best in the last row, a stated query
    length past the bucket's rows: both forms of the fill keep the first row's lowest lane."""
    arrays, expected = best_cell_panel(64, w_pad)
    res = _assert_kernels_equal_plain(device, arrays, nt_matrix(), 4, 2, 64, w_pad)
    assert list(zip(res[5].tolist(), res[7].tolist())) == expected
    assert res[0].tolist() == [24, 24, 24, 80, 128, 128, 0]


@pytest.mark.parametrize("w_pad", [256, 768, 1152])
def test_long_gap_runs(device, w_pad):
    """Walks with one vertical or horizontal run of 31 to 70 steps (across the warp's
    32-cell stretch) and walks that end at the matrix edge, after both forms of the fill."""
    arrays = gap_run_panel(np.random.default_rng(41), 320, w_pad)
    res = _assert_kernels_equal_plain(device, arrays, nt_matrix(), 4, 2, 320, w_pad)
    assert res[3].tolist()[: 2 * len(GAP_RUNS)] == [n for n in GAP_RUNS for _ in range(2)]
    assert res[4].tolist()[-3:] == [0, 0, 0] and res[6].tolist()[-3:] == [0, 0, 5]


def test_traceback_walks_planted_cigar_bucket(device):
    """The CIGAR panels' indel-dense bucket (short D and I runs in turn): the count-only
    kernel's counts equal the CIGAR kernel's on the same bits."""
    from kaptive_tpu_torch.ops.swg_cuda import swg_fill_cuda, swg_traceback_cigar_cuda, swg_traceback_cuda
    from kaptive_tpu_torch.ops.swg_cuda import as_kernel_matrix
    from swg_panels import cigar_bucket

    arrays, matrix, go, ge, rows_max, w_pad = cigar_bucket(np.random.default_rng(5), 64, 512, 128)
    res = _assert_kernels_equal_plain(device, arrays, matrix, go, ge, rows_max, w_pad)
    q, ql, t, tl, off, kl = (torch.from_numpy(a).to(device) for a in arrays)
    tb, *best = swg_fill_cuda(q, ql, t, tl, off, kl, as_kernel_matrix(torch.from_numpy(matrix), device),
                              gap_open=go, gap_extend=ge, rows_max=rows_max, w_pad=w_pad)
    tr = dict(rows_max=rows_max, w_pad=w_pad, t_pad=w_pad + 2)
    recorded, *_ = swg_traceback_cigar_cuda(tb, q, t, *best, off, **tr)
    assert torch.equal(swg_traceback_cuda(tb, q, t, *best, off, **tr), recorded) and torch.equal(res, recorded)
    assert int(res[3].sum()) > 500  # gaps


def test_front_door_routes_cuda_to_kernels(device):
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

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


def _assert_cigar_walk_equals_plain(device, arrays, matrix, go, ge, rows_max, w_pad):
    """The kernel fill's bits through the CIGAR kernel and through the plain CIGAR walk: equal."""
    from kaptive_tpu_torch.ops.swg import traceback_cigar_plain
    from kaptive_tpu_torch.ops.swg_cuda import as_kernel_matrix, swg_fill_cuda, swg_traceback_cigar_cuda

    q, ql, t, tl, off, kl = (torch.from_numpy(a).to(device) for a in arrays)
    tb, *best = swg_fill_cuda(q, ql, t, tl, off, kl, as_kernel_matrix(torch.from_numpy(matrix), device),
                              gap_open=go, gap_extend=ge, rows_max=rows_max, w_pad=w_pad)
    tr = dict(rows_max=rows_max, w_pad=w_pad, t_pad=w_pad + 2)
    got = swg_traceback_cigar_cuda(tb, q, t, *best, off, **tr)
    res_p, *rest_p = traceback_cigar_plain(tb, q, t, *best, off, **tr)
    torch.cuda.synchronize()
    assert torch.equal(got[0], torch.stack(tuple(res_p)))
    for g, x in zip(got[1:], rest_p):
        assert torch.equal(g, x)
    return got


@pytest.mark.parametrize("w_pad", [16384, 32768])
def test_fill_rejects_too_wide_band(device, w_pad):
    """No band is too wide any more: past 8,192 the fill takes its cluster form, equal to the
    plain fill with both walks; unseeded pairs whose bands span most of the width, and the
    sharded front door on four slots."""
    from kaptive_tpu_torch.ops.swg import banded_swg
    from kaptive_tpu_torch.ops.swg_cuda import as_kernel_matrix, fill_form
    from kaptive_tpu_torch.parallel.typing import sharded_banded_swg
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    assert fill_form(w_pad) == "cluster"
    rng = np.random.default_rng(4)
    arrays = random_swg_batch(rng, NT, 4, 96, w_pad, seeded=False, max_len=96)
    arrays[5][:] = np.minimum(arrays[5] + (w_pad - 3) // 2 - 200, (w_pad - 3) // 2)  # bands across slices
    reset_metrics()
    res = _assert_kernels_equal_plain(device, arrays, nt_matrix(), 4, 2, 96, w_pad)
    assert snapshot().get("swg.cuda.fill_cluster") == 1 and "swg.cuda.fill" not in snapshot()
    assert int(res[0].max()) > 0
    _assert_cigar_walk_equals_plain(device, arrays, nt_matrix(), 4, 2, 96, w_pad)
    args = [torch.from_numpy(a).to(device) for a in arrays]
    matrix = as_kernel_matrix(torch.from_numpy(nt_matrix()), device)
    statics = dict(gap_open=4, gap_extend=2, rows_max=96, w_pad=w_pad, t_pad=w_pad + 2)
    want = banded_swg(*args, matrix, **statics)
    got = sharded_banded_swg(_card_mesh((2, 2)), *args, matrix, **statics)
    for field, g, w in zip(want._fields, got, want, strict=True):
        assert torch.equal(g, w), field


def test_f7_pair_on_card_equals_plain_and_jax_values(device):
    """The unseeded 150-versus-4,300 protein pair through the default PairwiseAligner on the card
    (its bucket: 16 pairs, 16,384 rows, w_pad 32,768): the JAX package's values, the plain
    form's, with the count-only and the CIGAR walk."""
    from range_panels import F7_EXPECTED, F7_W_PAD, f7_bucket, f7_pair

    from kaptive_tpu_torch.core.pairwise import PairwiseAligner, batched_swg_align_cigars, blosum62_matrix
    from kaptive_tpu_torch.core.seq import Sequences
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    query, target = f7_pair()
    reset_metrics()
    res = PairwiseAligner()(Sequences.from_bytes([query]), Sequences.from_bytes([target]))
    counts = snapshot()
    assert counts.get("swg.cuda.fill_cluster") == 1 and counts.get("swg.cuda.traceback") == 1
    assert not any(".plain." in name for name in counts)
    for field, value in F7_EXPECTED.items():
        assert int(getattr(res, field)[0]) == value, field
    seqs = [np.frombuffer(x, np.uint8) for x in (query, target)]
    _, cigars = batched_swg_align_cigars(seqs[0], np.zeros(1, np.int64), np.array([150], np.int32),
                                         seqs[1], np.zeros(1, np.int64), np.array([4300], np.int32),
                                         np.zeros(1, np.int32), np.array([4151], np.int32),
                                         blosum62_matrix().astype(np.int32), 11, 1)
    assert cigars.data.tolist() == [150 << 4]
    arrays = f7_bucket(rows_max=256, n_pairs=3)
    matrix = blosum62_matrix().astype(np.int32)
    out = _assert_kernels_equal_plain(device, arrays, matrix, 11, 1, 256, F7_W_PAD)
    assert int(out[0, 0]) == F7_EXPECTED["scores"]
    _assert_cigar_walk_equals_plain(device, arrays, matrix, 11, 1, 256, F7_W_PAD)


@pytest.mark.parametrize("name", ["blosum62-x20", "nt-100000"])
@pytest.mark.parametrize("w_pad", [128, 1152, 32768])
def test_int32_matrix_fill_equals_plain(device, name, w_pad):
    """Scores outside int8 take the cluster form at every width, equal to the plain fill with
    both walks; the front doors keep the int32 matrix."""
    from range_panels import WIDE_MATRICES

    from kaptive_tpu_torch.ops.swg import banded_swg, banded_swg_cigars, device_matrix
    from kaptive_tpu_torch.ops.swg_cuda import fill_form

    alphabet, matrix_fn, go, ge = WIDE_MATRICES[name]
    matrix = matrix_fn()
    assert device_matrix(matrix, device).dtype == torch.int32 and fill_form(w_pad, torch.int32) == "cluster"
    arrays = random_swg_batch(np.random.default_rng(8), alphabet, 6, 64, w_pad, seeded=False)
    _assert_kernels_equal_plain(device, arrays, matrix, go, ge, 64, w_pad)
    _assert_cigar_walk_equals_plain(device, arrays, matrix, go, ge, 64, w_pad)
    args = [torch.from_numpy(a) for a in (*arrays, matrix)]
    kw = dict(gap_open=go, gap_extend=ge, rows_max=64, w_pad=w_pad, t_pad=w_pad + 2)
    for got, want in ((banded_swg(*(a.to(device) for a in args), **kw), banded_swg(*args, **kw)),
                      (banded_swg_cigars(*(a.to(device) for a in args), **kw)[0], banded_swg_cigars(*args, **kw)[0])):
        for field, g, w in zip(want._fields, got, want):
            assert torch.equal(g.cpu(), w), field


@pytest.mark.parametrize("cluster", list(range(1, 17)))
def test_cluster_fill_equals_plain_at_every_cluster_size(device, cluster):
    """The fill's cluster form at 1 .. 16 CTAs a cluster, each reached through swg_fill_cuda at the
    band the cluster's own plan gives (~2,048 lanes a CTA, w_pad = 2048 C - 5) with two int32
    matrices (BLOSUM62 x 20, the 100,000-scaled nucleotide one): every SwgResult field and
    traceback byte equal the plain fill's."""
    from range_panels import WIDE_MATRICES, wide_band_panel

    from kaptive_tpu_torch.ops.swg_cuda import cluster_plan

    w_pad = 2048 * cluster - 5
    assert cluster_plan(w_pad)[0] == cluster
    alphabet, matrix_fn, go, ge = WIDE_MATRICES["blosum62-x20"]
    arrays = wide_band_panel(cluster, alphabet, 4, 48, w_pad)
    res = _assert_kernels_equal_plain(device, arrays, matrix_fn(), go, ge, 48, w_pad)
    assert int(res[0].max()) > 0
    alphabet, matrix_fn, go, ge = WIDE_MATRICES["nt-100000"]
    arrays = wide_band_panel(100 + cluster, alphabet, 3, 40, w_pad)
    _assert_kernels_equal_plain(device, arrays, matrix_fn(), go, ge, 40, w_pad)


@pytest.mark.parametrize("w_pad", [8193, 8195, 12001, 32768, 65536, 131072])
def test_cluster_fill_just_past_the_int8_forms(device, w_pad):
    """Bands just past the int8 forms' 8,192 lanes up to the cluster form's largest (16 CTAs of
    8,192 lanes): the cluster form's own choice of cluster, equal to the plain fill, counted."""
    from range_panels import wide_band_panel

    from kaptive_tpu_torch.ops.swg_cuda import cluster_plan
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    ctas, slice_, lpt, threads = cluster_plan(w_pad)
    print(f"w_pad {w_pad}: {ctas} CTAs of {slice_} lanes, {lpt} a thread, {threads} threads")
    assert ctas >= 2 and (ctas - 1) * slice_ < w_pad <= ctas * slice_
    arrays = wide_band_panel(w_pad, NT, 3, 40, w_pad)
    reset_metrics()
    _assert_kernels_equal_plain(device, arrays, nt_matrix(), 4, 2, 40, w_pad)
    assert snapshot().get("swg.cuda.fill_cluster") == 1 and "swg.cuda.fill_segmented" not in snapshot()


@pytest.mark.parametrize("name", ["blosum62-x20", "nt-100000"])
@pytest.mark.parametrize("w_pad", [3, 100, 128, 129, 256, 300, 512, 513, 640, 2047])
def test_cluster_fill_narrow_int32_bands(device, name, w_pad):
    """int32 scores at the narrow widths: one warp a pair up to 512 lanes (4, 8 and 16 lanes a
    thread), one CTA above; tie-heavy seeded and unseeded pairs, equal to the plain fill."""
    from range_panels import WIDE_MATRICES

    from kaptive_tpu_torch.ops.swg_cuda import cluster_plan

    assert (cluster_plan(w_pad)[0] == 0) == (w_pad <= 512)
    alphabet, matrix_fn, go, ge = WIDE_MATRICES[name]
    rng = np.random.default_rng(w_pad)
    for seeded in (True, False):
        arrays = random_swg_batch(rng, alphabet, 9, 64, w_pad, seeded=seeded, tie_heavy=True)
        _assert_kernels_equal_plain(device, arrays, matrix_fn(), go, ge, 64, w_pad)


def test_segmented_fill_past_the_largest_cluster(device):
    """A band past the cluster form's 131,072 lanes takes the segmented form through banded_swg,
    equal to the plain fill, counted as such."""
    from range_panels import wide_band_panel

    from kaptive_tpu_torch.ops.swg import banded_swg
    from kaptive_tpu_torch.ops.swg_cuda import as_kernel_matrix, fill_form
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    w_pad = CLUSTER_MAX_W_PAD + 3
    assert fill_form(w_pad) == "segmented"
    arrays = wide_band_panel(7, NT, 2, 24, w_pad)
    _assert_kernels_equal_plain(device, arrays, nt_matrix(), 4, 2, 24, w_pad)
    args = [torch.from_numpy(a).to(device) for a in arrays]
    reset_metrics()
    res = banded_swg(*args, as_kernel_matrix(torch.from_numpy(nt_matrix()), device),
                     gap_open=4, gap_extend=2, rows_max=24, w_pad=w_pad, t_pad=w_pad + 2)
    assert snapshot().get("swg.cuda.fill_segmented") == 1 and int(res.scores.max()) > 0


def test_bounds_that_stay_name_themselves(device, scan_device, viterbi_device):
    """What no kernel form takes raises with a message that names the bound: a band of fewer
    than 3 lanes, a k-mer of no base, a window of no k-mer."""
    from kaptive_tpu_torch.ops.scan_cuda import minimizer_scan_cuda, rowcompact_scan_cuda
    from kaptive_tpu_torch.ops.swg_cuda import as_kernel_matrix, swg_fill_cuda

    arrays = random_swg_batch(np.random.default_rng(4), NT, 2, 16, 3, seeded=True)
    args = [torch.from_numpy(a).to(device) for a in arrays]
    with pytest.raises(ValueError, match="w_pad=2"):
        swg_fill_cuda(*args, as_kernel_matrix(nt_matrix(), device), gap_open=4, gap_extend=2, rows_max=16, w_pad=2)
    codes = torch.full((1, 40, 128), 4, dtype=torch.uint8, device=scan_device)
    for k, w in ((0, 10), (15, 0)):
        with pytest.raises(ValueError, match=f"k={k}, w={w}"):
            rowcompact_scan_cuda(codes, k, w)
        with pytest.raises(ValueError, match=f"k={k}, w={w}"):
            minimizer_scan_cuda(codes[0, 0], k, w)


@pytest.fixture(scope="module")
def scan_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from kaptive_tpu_torch.ops import scan_cuda

    scan_cuda.build()
    print(f"scan.cu ptxas: {scan_cuda.LIBRARY.ptxas_report()}")
    return torch.device("cuda", 0)


SCAN_PANELS = {**PANELS, **EDGE_PANELS, "bench-rows-45056": lambda r: random_stream(r, 45056)}
SCAN_CASES = ([(name, B, 15, 10) for name in PANELS for B in (1, 3)]
              + [("bench-rows-45056", 1, 15, 10), ("bench-rows-45056", 3, 15, 10)]
              + [(name, B, 15, 10) for name in EDGE_PANELS for B in (1, 2)]
              + [(name, 2, k, w) for k, w in KW_CASES
                 for name in ("odd-rows-1000", "period-2-across-edges", "poly-a-across-edges", "three-rows")])


def _assert_scan_kernel_equals_plain(device, codes, k, w):
    from kaptive_tpu_torch.ops.scan import rowcompact_scan_plain
    from kaptive_tpu_torch.ops.scan_cuda import rowcompact_scan_cuda

    got = rowcompact_scan_cuda(codes, k, w)
    want = rowcompact_scan_plain(codes, k, w)
    torch.cuda.synchronize()
    for field, g, x in zip(("hashes", "aux", "counts"), got, want):
        assert g.dtype == x.dtype and g.shape == x.shape, field
        assert torch.equal(g, x), (field, k, w)
    return got


@pytest.mark.parametrize("case", SCAN_CASES, ids=[f"{n}-B{b}-k{k}-w{w}" for n, b, k, w in SCAN_CASES])
def test_scan_kernel_equals_plain(scan_device, case):
    from kaptive_tpu_torch.ops.scan import pad_codes_for_scan_any

    name, B, k, w = case
    rng = np.random.default_rng(sum(map(ord, name)) + B)
    codes = torch.from_numpy(np.stack([pad_codes_for_scan_any(SCAN_PANELS[name](rng)) for _ in range(B)]))
    got = _assert_scan_kernel_equals_plain(scan_device, codes.to(scan_device), k, w)
    if name in ("poly-a-overflow", "poly-a-across-edges"):
        assert int(got[2].max()) > 64
    if name == "all-sentinel":
        assert int(got[2].sum()) == 0


def test_scan_kernel_equals_plain_at_every_window_width(scan_device):
    """Every instance of the tiled kernel (w = 1 .. 32), at the largest and at a small k, on ties
    and sentinels laid across the tile, row and word edges; past them, the run-time form."""
    from kaptive_tpu_torch.ops.scan import pad_codes_for_scan_any

    rng = np.random.default_rng(77)
    codes = torch.from_numpy(np.stack([
        pad_codes_for_scan_any(EDGE_PANELS[name](rng))
        for name in ("sentinels-across-edges", "period-2-across-edges", "poly-a-across-edges")
    ])).to(scan_device)
    for w in range(1, 33):
        for k in (16, 15, 5, 1):
            _assert_scan_kernel_equals_plain(scan_device, codes, k, w)
    _assert_scan_kernel_equals_plain(scan_device, codes, 15, 33)  # the run-time form
    _assert_scan_kernel_equals_plain(scan_device, codes, 17, 10)


# (k, w) past the tiled kernels' 16 and 32: the run-time form of both scans, and past its widest
# window (any_max_w(k), ~8,400) the sparse-table form.  (19, 19) and (21, 11) are minimap2's asm5 /
# asm10 and sr presets.
WIDE_KW = ([(15, w) for w in (33, 64, 200, 1000, 1100)] + [(k, w) for k in (17, 19, 20, 21, 31, 32, 33)
                                                          for w in (10, 40)]
           + [(32, 5), (19, 19), (21, 11), (33, 1100)]
           + [(k, any_max_w(k) + d) for k in (15, 33) for d in (0, 1)])


def _wide_form(k: int, w: int) -> str:
    """The run-time form inside its widest window, the sparse-table form past it."""
    return "any" if any_plan(k, w) else "sparse"


@pytest.mark.parametrize("kw", WIDE_KW, ids=[f"k{k}-w{w}" for k, w in WIDE_KW])
def test_scan_kernel_equals_plain_past_the_tiled_range(scan_device, kw):
    """The run-time form of the row-compact scan (one launch, the counter
    ``scan.cuda.rowcompact_any``; past its widest window the sparse-table form,
    ``scan.cuda.rowcompact_sparse``) on sentinels, ties two apart and poly-A across tile edges,
    a 24-row panel with a sentinel run, poly-A and a period-2 repeat, and an all-sentinel
    genome, as one batch."""
    from range_panels import rowcompact_panel

    from kaptive_tpu_torch.ops.scan import pad_codes_for_scan_any
    from kaptive_tpu_torch.ops.scan_cuda import build, scan_form
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    k, w = kw
    form = _wide_form(k, w)
    assert scan_form(k, w) == form and build().kts_scan_any_max_w(k) == any_max_w(k)
    assert build().kts_scan_any_smem(k, w) == (any_plan(k, w) or {"smem": 0})["smem"]
    rng = np.random.default_rng(31 * k + w)
    streams = [EDGE_PANELS[name](rng) for name in ("sentinels-across-edges", "period-2-across-edges",
                                                   "poly-a-across-edges")]
    streams.append(np.full(72 * 128, 4, np.uint8))
    streams += [s[8:-8].reshape(-1) for s in rowcompact_panel(rows=72)]
    codes = torch.from_numpy(np.stack([pad_codes_for_scan_any(s[: 72 * 128]) for s in streams]))
    reset_metrics()
    got = _assert_scan_kernel_equals_plain(scan_device, codes.to(scan_device), k, w)
    assert snapshot() == {f"scan.cuda.rowcompact_{form}": 1, "scan.plain.rowcompact": 1}
    assert int(got[2].sum()) > 0 and int(got[2][3].sum()) == 0


def test_scan_front_door_routes_by_device(scan_device):
    """A CUDA tensor reaches only the kernel, a CPU tensor only the plain version."""
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    from kaptive_tpu_torch.ops.scan import pad_codes_for_scan_any, rowcompact_scan
    from kaptive_tpu_torch.ops.scan_cuda import rowcompact_scan_cuda

    codes = torch.from_numpy(pad_codes_for_scan_any(random_stream(np.random.default_rng(8), 96)))[None]
    reset_metrics()
    on_card = rowcompact_scan(codes.to(scan_device), 15, 10)
    assert snapshot() == {"scan.cuda.rowcompact": 1}
    reset_metrics()
    on_cpu = rowcompact_scan(codes, 15, 10)
    assert snapshot() == {"scan.plain.rowcompact": 1}
    for g, w in zip(on_card, on_cpu):
        assert torch.equal(g.cpu(), w)
    with pytest.raises(ValueError, match="CUDA"):
        rowcompact_scan_cuda(codes, 15, 10)


def test_device_seeded_serotyper_on_card_equals_host(scan_device, monkeypatch, tmp_path):
    """The typing panel on the card, device-seeded: KaptiveRow bytes equal host mode's,
    and the scan ran on the kernel only."""
    import io

    import kaptive_tpu_torch  # noqa: F401  (first: keeps the JAX package's jax imports out)
    from typing_panel import TRUTH, make_port_typing_panel

    from kaptive_tpu_torch.serotyping.io import KaptiveRow
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot
    from kaptive_tpu_torch.parallel import stream_type
    from kaptive_tpu_torch.serotyping import Serotyper

    db, genomes = make_port_typing_panel(tmp_path)
    serotyper = Serotyper(db, device="cuda")

    def rows(mode):
        monkeypatch.setenv("KAPTIVE_SEED_MODE", mode)
        batch = serotyper.batch([io.BytesIO(f) for _, f in genomes])
        streamed = list(stream_type(serotyper, [io.BytesIO(f) for _, f in genomes], batch_size=2))
        assert [r.best_locus_name for r in batch] == TRUTH
        return [bytes(KaptiveRow.from_result(r)) for r in batch + streamed]

    host = rows("host")
    reset_metrics()
    device = rows("device")
    counts = snapshot()
    assert device == host
    assert counts.get("scan.cuda.rowcompact", 0) > 0 and "scan.plain.rowcompact" not in counts
    assert counts.get("swg.cuda.fill", 0) > 0 and "swg.plain.fill" not in counts
    assert counts.get("map.device_chained") == 2 * len(genomes)


@pytest.mark.parametrize("config, traffic, n_contigs", [("ab_k", "drafts_single", 200), ("kpsc_k", "complete_batch64", 1)])
def test_auto_seeds_a_request_of_a_real_database_shape_on_the_card(scan_device, monkeypatch, tmp_path,
                                                                    config, traffic, n_contigs):
    """With no seed mode set, one request on the card is seeded there: a 4.0 Mb draft of 200 contigs
    against the 241 loci of ``ab_k`` (the most chains a request of the benchmark brings) and a complete
    5.3 Mb genome against ``kpsc_k``.  Each is chained on the card with no host fallback, and its row
    equals host seeding's."""
    import json
    import sys
    from pathlib import Path

    import kaptive_tpu_torch  # noqa: F401  (first: keeps the JAX package's jax imports out)
    from kaptive_tpu_torch.core.genome import GenomeAssembly
    from kaptive_tpu_torch.db import Database
    from kaptive_tpu_torch.ops import mapper as tm
    from kaptive_tpu_torch.ops.minimizer import ContigIndex
    from kaptive_tpu_torch.serotyping import Serotyper
    from kaptive_tpu_torch.serotyping.io import KaptiveRow
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    bench = Path(__file__).resolve().parent.parent / "benchmark"
    if str(bench) not in sys.path:
        sys.path.insert(0, str(bench))
    from kbench import gen

    cfg = json.loads((bench / "configs" / f"{config}.json").read_text())
    kind = json.loads((bench / "traffic" / f"{traffic}.json").read_text())["classes"][-1]
    rng_db, rng_asm = gen.seed_streams(2**31 + 24, 2)
    synthetic = gen.make_database(cfg, rng_db)
    gbk = tmp_path / f"{config}.gbk"
    gbk.write_text(synthetic.genbank)
    gbk.with_suffix(".toml").write_text(synthetic.toml)
    db = Database.from_genbank(gbk)
    asm = gen.make_assembly(rng_asm, "g0", kind, n_contigs, synthetic.loci[0], cfg["genome_nt"])
    monkeypatch.delenv("KAPTIVE_SEED_MODE", raising=False)
    serotyper = Serotyper(db, device="cuda")

    ci = ContigIndex.build(GenomeAssembly.from_stream(io.BytesIO(asm.fasta), asm.name).contigs)
    codes, starts = tm._batch_codes([ci], len(ci.codes), scan_device)
    _, counts = tm.seed_chunk(codes, starts, [(scan_device, serotyper.gene_index.seed_table(scan_device))],
                              serotyper.gene_index, serotyper.mapper_params)
    minimizers, candidates, anchors, overflow, raw, kept = counts[:, 0].tolist()
    print(f"{config}, {n_contigs} contigs: {minimizers} minimizers, {candidates} candidates (cap "
          f"{tm.CANDIDATE_CAP}), {anchors} anchors (cap {tm.ANCHOR_CAP}), {raw} chains (cap {tm.CHAIN_CAP}), "
          f"{kept} kept (prefix {tm.CHAIN_PREFIX})")

    serotyper.batch([io.BytesIO(asm.fasta)])  # captures the shape's seeding graph
    reset_metrics()
    [auto] = serotyper.batch([io.BytesIO(asm.fasta)])
    seen = snapshot()
    assert seen.get("map.device_chained") == 1 and seen.get("scan.cuda.rowcompact") == 1, seen
    assert seen.get("map.seed_graph") == 1 and "map.seed_graph.capture" not in seen, seen
    assert not any(key.startswith(("map.host_", "map.chain_prefix_miss")) for key in seen), seen
    monkeypatch.setenv("KAPTIVE_SEED_MODE", "host")
    [host] = serotyper.batch([io.BytesIO(asm.fasta)])
    assert auto.best_locus_name == host.best_locus_name == synthetic.loci[0].name
    assert bytes(KaptiveRow.from_result(auto)) == bytes(KaptiveRow.from_result(host))


@pytest.mark.parametrize("kind", CIGAR_PANELS)
def test_cigar_kernel_equals_plain(device, kind):
    from kaptive_tpu_torch.ops.swg import fill_band_plain, traceback_cigar_plain
    from kaptive_tpu_torch.ops.swg_cuda import as_kernel_matrix, swg_fill_cuda, swg_traceback_cigar_cuda

    arrays, matrix, go, ge, rows_max, w_pad = cigar_panel(np.random.default_rng(sum(map(ord, kind))), kind)
    q, ql, t, tl, off, kl = (torch.from_numpy(a).to(device) for a in arrays)
    mat = as_kernel_matrix(torch.from_numpy(matrix), device)
    tb, *best = swg_fill_cuda(q, ql, t, tl, off, kl, mat, gap_open=go, gap_extend=ge, rows_max=rows_max, w_pad=w_pad)
    # Both walks read the kernel's traceback bits (the fill is held to its plain version above).
    tr = dict(rows_max=rows_max, w_pad=w_pad, t_pad=w_pad + 2)
    out, ops, n_ops, overflow = swg_traceback_cigar_cuda(tb, q, t, *best, off, **tr)
    res_p, ops_p, n_p, over_p = traceback_cigar_plain(tb, q, t, *best, off, **tr)
    torch.cuda.synchronize()
    for f, got, want in zip(res_p._fields, out.unbind(0), res_p):
        assert torch.equal(got, want), f
    assert ops.dtype == ops_p.dtype and torch.equal(ops, ops_p)
    assert torch.equal(n_ops, n_p) and torch.equal(overflow, over_p)
    if kind == "overflow":
        assert bool(overflow[0]) and not overflow[1:].any()


def test_cigar_front_door_routes_cuda_to_kernels(device):
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    from kaptive_tpu_torch.ops.swg import banded_swg_cigars

    arrays, matrix, go, ge, rows_max, w_pad = cigar_panel(np.random.default_rng(9), "nt-indels")
    kw = dict(gap_open=go, gap_extend=ge, rows_max=rows_max, w_pad=w_pad, t_pad=w_pad + 2)
    reset_metrics()
    on_card = banded_swg_cigars(*(torch.from_numpy(a).to(device) for a in arrays),
                                torch.from_numpy(matrix).to(device), **kw)
    assert snapshot() == {"swg.cuda.fill": 1, "swg.cuda.traceback_cigar": 1}
    reset_metrics()
    on_cpu = banded_swg_cigars(*(torch.from_numpy(a) for a in arrays), torch.from_numpy(matrix), **kw)
    assert snapshot() == {"swg.plain.fill": 1, "swg.plain.traceback_cigar": 1}
    for got, want in zip([*on_card[0], *on_card[1:]], [*on_cpu[0], *on_cpu[1:]]):
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("seed_mode", ["host", "device"])
def test_mapper_cigars_on_card_equal_cpu(scan_device, seed_mode, tmp_path):
    import io

    import kaptive_tpu_torch  # noqa: F401  (first: keeps the JAX package's jax imports out)
    from typing_panel import assert_same, make_port_typing_panel

    from kaptive_tpu_torch.core.genome import GenomeAssembly
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot
    from kaptive_tpu_torch.ops.mapper import MapperParams, map_genes_batch

    db, genomes = make_port_typing_panel(tmp_path)
    assemblies = [GenomeAssembly.from_stream(io.BytesIO(f), n) for n, f in genomes]
    gi = db.gene_index
    names = tuple(str(i) for i in range(len(db.genes)))
    params = MapperParams(emit_cigars=True)
    reset_metrics()
    got = map_genes_batch(gi, assemblies, names, params, seed_mode=seed_mode, device="cuda")
    counts = snapshot()
    assert counts.get("swg.cuda.traceback_cigar", 0) > 0 and "swg.plain.traceback_cigar" not in counts
    want = map_genes_batch(gi, assemblies, names, params, seed_mode=seed_mode, device="cpu")
    assert_same(got, want)
    assert sum(int(a.cigars.lengths.sum()) for a in got) > 0


def test_screen_on_card_equals_cpu(scan_device, tmp_path):
    import kaptive_tpu_torch  # noqa: F401  (first: keeps the JAX package's jax imports out)
    from typing_panel import TRUTH, make_port_typing_panel

    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot
    from kaptive_tpu_torch.parallel.screen import ScreenTables, encode_assemblies_to_batch, locus_screen_batch
    from kaptive_tpu_torch.serotyping import Serotyper

    db, genomes = make_port_typing_panel(tmp_path)
    # A 400-base poly-A run before the KL3 locus: its scan rows hold more than
    # 64 minimizers, so the card re-tallies that genome from the flat plain scan.
    revcomp = dict(genomes)["revcomp"]
    genomes.append(("poly_a", revcomp[:4] + b"A" * 400 + revcomp[4:]))
    paths = []
    for name, fasta in genomes:
        (path := tmp_path / f"{name}.fasta").write_bytes(fasta)
        paths.append(path)
    reset_metrics()
    assemblies, best, weighted = Serotyper(db, device="cuda").screen(paths)
    counts = snapshot()
    assert counts.get("scan.cuda.rowcompact") == 1 and "scan.plain.rowcompact" not in counts
    assert counts.get("screen.overflow") == 1
    reset_metrics()
    _, best_cpu, weighted_cpu = Serotyper(db, device="cpu").screen(paths)
    assert snapshot().get("screen.overflow") == 1
    np.testing.assert_array_equal(best, best_cpu)
    np.testing.assert_allclose(weighted, weighted_cpu, rtol=1e-6)
    assert [db.loci.ids[b] for b in best[:2]] == TRUTH[:2]
    codes = torch.from_numpy(encode_assemblies_to_batch(assemblies))
    tables = ScreenTables.build(db, db.gene_index)
    best_card, _, tallies_card = locus_screen_batch(codes.to(scan_device), tables, len(db.genes))
    best_plain, _, tallies_cpu = locus_screen_batch(codes, tables, len(db.genes))
    assert torch.equal(tallies_card.cpu(), tallies_cpu)
    assert torch.equal(best_card.cpu(), best_plain)


def test_cli_on_card_equals_in_process_rows(scan_device, tmp_path):
    import os
    import subprocess
    import sys
    from pathlib import Path

    import kaptive_tpu_torch  # noqa: F401  (first: keeps the JAX package's jax imports out)
    from typing_panel import make_port_typing_panel

    from kaptive_tpu_torch.serotyping.io import KaptiveRow
    from kaptive_tpu_torch.serotyping import Serotyper

    db, genomes = make_port_typing_panel(tmp_path)
    paths = []
    for name, fasta in genomes:
        (path := tmp_path / f"{name}.fasta").write_bytes(fasta)
        paths.append(str(path))
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root))
    want = KaptiveRow.header() + b"".join(bytes(KaptiveRow.from_result(r))
                                          for r in Serotyper(db, device="cuda").batch(paths))
    for mode in ("host", "device"):
        out = tmp_path / f"{mode}.tsv"
        proc = subprocess.run(
            [sys.executable, "-m", "kaptive_tpu_torch.cli", "type", str(tmp_path / "TestDB.gbk"), *paths,
             "-o", str(out), "--device", "cuda", "--seed-mode", mode, "--batch-size", "2",
             *(["--precompile"] if mode == "device" else [])],
            cwd=tmp_path, env=env, capture_output=True, timeout=600,
        )
        assert proc.returncode == 0, proc.stderr.decode()[-3000:]
        assert out.read_bytes() == want, mode


# --- BGC: the gene-HMM and architectural Viterbi kernels ---------------------


@pytest.fixture(scope="module")
def viterbi_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from kaptive_tpu_torch.ops import viterbi_cuda

    viterbi_cuda.build()
    print(f"viterbi.cu ptxas: {viterbi_cuda.LIBRARY.ptxas_report()}")
    return torch.device("cuda", 0)


def _gene_kernel_equals_plain(device, chains, params):
    """Gene decode of ``gene_chains``' output on the card and with the plain form on the CPU: equal states."""
    from kaptive_tpu_torch.ops.viterbi import gene_viterbi_plain
    from kaptive_tpu_torch.ops.viterbi_cuda import gene_viterbi_cuda

    strands, *arrays = chains
    got = gene_viterbi_cuda(*(torch.from_numpy(a).to(device) for a in arrays),
                            indel=params.indel, ins_extend=params.ins_extend)
    want = gene_viterbi_plain(*(torch.from_numpy(a) for a in arrays), indel=params.indel,
                              ins_extend=params.ins_extend)
    torch.cuda.synchronize()
    assert got.dtype == torch.int8 and torch.equal(got.cpu(), want)
    return want.numpy(), strands


@pytest.mark.parametrize("length", [3000, 12000, 60000])
def test_gene_kernel_equals_plain_at_padded_lengths(viterbi_device, length):
    """Random contigs padded to 4 Ki, 16 Ki and 64 Ki positions, both strands, uniform emissions
    (random DNA is all stop-free runs to the uniform model, so the decode is dense with genes)."""
    from synthetic import random_dna
    from viterbi_panels import gene_chains

    from kaptive_tpu_torch.bgc.genefinder import GeneHmmParams

    params = GeneHmmParams.uniform()
    states, strands = _gene_kernel_equals_plain(viterbi_device, gene_chains(
        [random_dna(np.random.default_rng(length), length)], params), params)
    assert len(states) == 2 * {3000: 4096, 12000: 16384, 60000: 65536}[length]
    assert (states != 0).any()


def test_gene_kernel_equals_plain_on_a_mixed_batch(viterbi_device):
    """Every gene-finder panel, the truncation panels padded and unpadded, and odd lengths, in one launch."""
    from unittest import mock

    from synthetic import random_dna
    from viterbi_panels import gene_chains, gene_panels, truncation_panels

    from kaptive_tpu_torch.bgc.genefinder import GeneHmmParams
    from kaptive_tpu_torch.ops import minimizer

    params = GeneHmmParams.uniform(coding_bonus=0.40)
    rng = np.random.default_rng(7)
    contigs = [*gene_panels().values(), *truncation_panels().values(), random_dna(rng, 20000)]
    with mock.patch.object(minimizer, "bucket_length", lambda n, minimum=0: n):
        odd = gene_chains([*truncation_panels().values(), random_dna(rng, 129), random_dna(rng, 3)], params)
    padded = gene_chains(contigs, params)
    strands = padded[0] + odd[0]
    arrays = [np.concatenate([a, b]) for a, b in zip(padded[1:4], odd[1:4])]
    offsets = np.concatenate([padded[4], odd[4][1:] + padded[4][-1]])
    states, _ = _gene_kernel_equals_plain(viterbi_device, (strands, *arrays, offsets), params)
    assert len({int(b - a) for a, b in zip(offsets[:-1], offsets[1:])}) > 8


def test_gene_kernel_ends_in_a_coding_state_in_the_pad_tail(viterbi_device):
    """A gene cut by the contig end: the best path runs coding through the pad to the last position."""
    from viterbi_panels import gene_chains, truncation_panels

    from kaptive_tpu_torch.bgc.genefinder import GeneHmmParams

    params = GeneHmmParams.uniform(coding_bonus=0.40)
    chains = gene_chains([truncation_panels()["cut0"]], params)
    states, strands = _gene_kernel_equals_plain(viterbi_device, chains, params)
    fwd = states[: len(chains[1]) // 2]
    assert fwd[-1] != 0 and (fwd[len(strands[0].codes):] != 0).all()


def test_gene_front_door_and_find_genes_on_card(viterbi_device):
    from viterbi_panels import gene_panels, gene_training_set

    from kaptive_tpu_torch.bgc.genefinder import GeneHmmParams, find_genes_hmm_batch
    from kaptive_tpu_torch.core.seq import Sequences
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    params = GeneHmmParams.from_sequences(Sequences.from_bytes(gene_training_set()))
    contigs = list(gene_panels().values())
    reset_metrics()
    got = find_genes_hmm_batch(contigs, params, 50, device="cuda")
    counts = snapshot()
    assert counts.get("viterbi.cuda.gene") == 1 and "viterbi.plain.gene" not in counts
    assert got == find_genes_hmm_batch(contigs, params, 50, device="cpu")
    assert all(got)


@pytest.mark.parametrize("n_states", [3, 8, 28])
def test_arch_kernel_equals_plain(viterbi_device, n_states):
    """Ragged contigs of 1 to 2,000 ORF rows in one launch: paths and scores equal."""
    from viterbi_panels import arch_panel

    from kaptive_tpu_torch.ops.viterbi import arch_viterbi_plain
    from kaptive_tpu_torch.ops.viterbi_cuda import arch_viterbi_cuda

    em, trans, offsets = arch_panel(np.random.default_rng(n_states), [1, 2, 17, 300, 2000], n_states)
    args = [torch.from_numpy(a) for a in (em, trans, offsets)]
    paths, scores = arch_viterbi_cuda(*(a.to(viterbi_device) for a in args))
    want_paths, want_scores = arch_viterbi_plain(*args)
    torch.cuda.synchronize()
    assert paths.dtype == torch.int32 and torch.equal(paths.cpu(), want_paths)
    assert torch.equal(scores.cpu(), want_scores)
    assert int(paths.max()) == n_states - 1 and int(paths.min()) >= 0


def _strand_pieces(params, lengths, seed):
    """Strands of ``lengths`` steps cut from one unpadded 200 kb random strand, and a 1 kb
    contig's strand padded to 4 Ki positions (a pad tail of one repeated input): flat
    inputs and offsets."""
    from unittest import mock

    from synthetic import random_dna
    from viterbi_panels import gene_chains

    from kaptive_tpu_torch.ops import minimizer

    rng = np.random.default_rng(seed)
    with mock.patch.object(minimizer, "bucket_length", lambda n, minimum=0: n):
        _, *source, _ = gene_chains([random_dna(rng, 200_000)], params)
    _, *padded, _ = gene_chains([random_dna(rng, 1000)], params)  # 1 kb padded to 4 Ki positions
    pieces = []
    for n in lengths:
        lo = int(rng.integers(0, len(source[0]) - n))
        pieces.append([a[lo: lo + n] for a in source])
    pieces.append(padded)
    arrays = [np.concatenate([p[k] for p in pieces]) for k in range(3)]
    return arrays, np.cumsum([0] + [len(p[0]) for p in pieces]).astype(np.int64)


def test_gene_kernel_equals_plain_with_fixups_forced(viterbi_device):
    """No warm-up (the wrapper's private entry): every chunk but a strand's first starts from
    the start vector, so fix-up rounds re-run chunks; the states still equal the plain form's,
    and those of the default warm-up, which re-runs fewer chunks."""
    from synthetic import random_dna
    from viterbi_panels import gene_chains, gene_panels, gene_training_set

    from kaptive_tpu_torch.bgc.genefinder import GeneHmmParams
    from kaptive_tpu_torch.core.seq import Sequences
    from kaptive_tpu_torch.ops.viterbi import gene_viterbi_plain
    from kaptive_tpu_torch.ops.viterbi_cuda import _gene_viterbi_forced_fixups, gene_viterbi_cuda_with_stats

    params = GeneHmmParams.from_sequences(Sequences.from_bytes(gene_training_set()))
    rng = np.random.default_rng(21)
    _, *arrays = gene_chains([*gene_panels().values(), random_dna(rng, 3000), random_dna(rng, 60000)], params)
    kw = dict(indel=params.indel, ins_extend=params.ins_extend)
    on_card = [torch.from_numpy(a).to(viterbi_device) for a in arrays]
    want = gene_viterbi_plain(*(torch.from_numpy(a) for a in arrays), **kw)
    forced, stats = _gene_viterbi_forced_fixups(*on_card, **kw)
    default, default_stats = gene_viterbi_cuda_with_stats(*on_card, **kw)
    torch.cuda.synchronize()
    print(f"forced fix-ups: {stats}; default warm-up: {default_stats}")
    assert torch.equal(forced.cpu(), want) and torch.equal(default.cpu(), want)
    assert stats.rounds > 0 and stats.reruns > 0 and stats.filled > 0
    assert stats.chunks == default_stats.chunks and default_stats.reruns < stats.reruns


@pytest.mark.parametrize("layout", ["chunk_edges", "short_beside_long"])
def test_gene_kernel_equals_plain_on_ragged_chunks(viterbi_device, layout):
    """One launch of strands whose lengths put chunk edges on strand edges (multiples of the
    chunk, one more, one fewer), or of 300 strands of 1 to 40 steps beside two long ones; a
    padded strand in each.  Default warm-up and forced fix-ups."""
    from kaptive_tpu_torch.bgc.genefinder import GeneHmmParams
    from kaptive_tpu_torch.ops.viterbi import gene_viterbi_plain
    from kaptive_tpu_torch.ops.viterbi_cuda import (
        _gene_viterbi_forced_fixups, build, gene_chunk_table, gene_viterbi_cuda_with_stats,
    )

    C = build().kts_gene_chunk()
    rng = np.random.default_rng(5)
    lengths = ([C, 2 * C, C + 1, C - 1, 3 * C + 2, 1, 2, 3] if layout == "chunk_edges"
               else [40_000, *rng.integers(1, 41, 300).tolist(), 33_000])
    params = GeneHmmParams.uniform()
    arrays, offsets = _strand_pieces(params, lengths, 8)
    kw = dict(indel=params.indel, ins_extend=params.ins_extend)
    want = gene_viterbi_plain(*(torch.from_numpy(a) for a in arrays), torch.from_numpy(offsets), **kw)
    on_card = [torch.from_numpy(a).to(viterbi_device) for a in (*arrays, offsets)]
    for decode in (gene_viterbi_cuda_with_stats, _gene_viterbi_forced_fixups):
        got, stats = decode(*on_card, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (decode.__name__, stats)
        assert stats.chunks == len(gene_chunk_table(offsets, C)[0]) and stats.filled > 0
    if layout == "chunk_edges":
        ends = set(gene_chunk_table(offsets, C)[0][:, 1].tolist())
        assert set(offsets[1:].tolist()) <= ends and offsets[1] == C


@pytest.mark.parametrize("n_states", [1, 2, 28, 32, 33, 64, 256, 257, 300, 1027])
def test_arch_kernel_equals_plain_with_ties(viterbi_device, n_states):
    """One launch of 200 contigs of 1 to 3 rows beside one of 24,000 rows (2,000 past 256
    states, the block-a-contig form with 16-bit backpointers, whose plain form on the CPU takes
    S x S a row): ties, -inf transitions and -inf emissions; paths and scores equal."""
    from viterbi_panels import arch_tie_panel

    from kaptive_tpu_torch.ops.viterbi import arch_viterbi_plain
    from kaptive_tpu_torch.ops.viterbi_cuda import arch_viterbi_cuda

    rng = np.random.default_rng(n_states)
    n_rows = rng.integers(1, 4, 200).tolist()
    n_rows.insert(100, 24_000 if n_states <= 256 else 2_000)
    em, trans, offsets = arch_tie_panel(rng, n_rows, n_states)
    args = [torch.from_numpy(a) for a in (em, trans, offsets)]
    paths, scores = arch_viterbi_cuda(*(a.to(viterbi_device) for a in args))
    want_paths, want_scores = arch_viterbi_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(paths.cpu(), want_paths)
    assert torch.equal(scores.cpu(), want_scores)
    assert np.isneginf(trans).any() or n_states == 1


@pytest.mark.parametrize("n_states", [257, 300, 1027])
def test_arch_wide_kernel_keeps_a_first_nan(viterbi_device, n_states):
    """NaN candidates: the block-a-contig form keeps a NaN only when it is a state's first
    candidate (predecessor 0), as one strict chain over the predecessors does, and skips it
    elsewhere; held to that chain in numpy (the plain form's max propagates NaN)."""
    from viterbi_panels import arch_chain_reference, arch_tie_panel

    from kaptive_tpu_torch.ops.viterbi_cuda import arch_viterbi_cuda

    rng = np.random.default_rng(n_states)
    em, trans, offsets = arch_tie_panel(rng, [1, 6, 40], n_states)
    em[3, :5] = np.nan  # contig 1's row 2: state 0 is every state's first predecessor a row later
    em[20, rng.integers(1, n_states, 30)] = np.nan
    args = [torch.from_numpy(a).to(viterbi_device) for a in (em, trans, offsets)]
    paths, scores = arch_viterbi_cuda(*args)
    want_paths, want_scores = arch_chain_reference(em, trans, offsets)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(paths.cpu().numpy(), want_paths)
    np.testing.assert_array_equal(scores.cpu().numpy(), want_scores)


def test_arch_wide_kernel_with_rows_in_device_memory(viterbi_device):
    """7,200 states: the score rows are too wide for shared memory and live in device memory;
    paths and scores equal the plain form's."""
    from viterbi_panels import arch_tie_panel

    from kaptive_tpu_torch.ops.viterbi import arch_viterbi_plain
    from kaptive_tpu_torch.ops.viterbi_cuda import arch_viterbi_cuda, build

    S = 7200
    assert build().kts_arch_wide_work_floats(S) > 0
    em, trans, offsets = arch_tie_panel(np.random.default_rng(S), [1, 3, 9], S)
    args = [torch.from_numpy(a) for a in (em, trans, offsets)]
    paths, scores = arch_viterbi_cuda(*(a.to(viterbi_device) for a in args))
    want_paths, want_scores = arch_viterbi_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(paths.cpu(), want_paths) and torch.equal(scores.cpu(), want_scores)


def test_arch_wide_kernel_at_every_cluster_size_it_takes(viterbi_device):
    """300 states at the fewest contigs for each cluster size the decode takes on this card (up to
    8 CTAs a contig while every contig's cluster runs at once; one CTA once the contigs fill the
    card): ties, -inf transitions and -inf emissions; paths and scores equal the plain form's."""
    from viterbi_panels import arch_tie_panel

    from kaptive_tpu_torch.ops.viterbi import arch_viterbi_plain
    from kaptive_tpu_torch.ops.viterbi_cuda import arch_viterbi_cuda, build

    S, lib = 300, build()
    first: dict[int, int] = {}  # CTAs a contig -> the fewest contigs that take it
    for n in range(1, 1025):
        first.setdefault(lib.kts_arch_wide_cluster(S, n), n)
    print(f"cluster sizes at {S} states (CTAs: fewest contigs): {first}")
    assert max(first) == 8 and min(first) == 1 and 4 in first
    for ctas, n_contigs in first.items():
        rng = np.random.default_rng(ctas)
        em, trans, offsets = arch_tie_panel(rng, rng.integers(1, 12, n_contigs).tolist(), S)
        args = [torch.from_numpy(a) for a in (em, trans, offsets)]
        paths, scores = arch_viterbi_cuda(*(a.to(viterbi_device) for a in args))
        want_paths, want_scores = arch_viterbi_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(paths.cpu(), want_paths) and torch.equal(scores.cpu(), want_scores), ctas


@pytest.mark.parametrize("bad", ["short", "past_end", "decreasing", "not_from_zero"])
def test_viterbi_kernels_refuse_bad_offsets(viterbi_device, bad):
    """Offsets that do not run from 0 to the inputs' rows without decreasing raise, as the
    plain forms raise, instead of leaving outputs unwritten; so does an empty contig."""
    from viterbi_panels import arch_panel

    from kaptive_tpu_torch.ops.viterbi_cuda import arch_viterbi_cuda, gene_viterbi_cuda

    offsets = {"short": [0, 40, 90], "past_end": [0, 40, 120], "decreasing": [0, 60, 40, 100],
               "not_from_zero": [10, 40, 100]}[bad]
    x = torch.zeros(100, dtype=torch.float32, device=viterbi_device)
    off = torch.tensor(offsets, dtype=torch.int64, device=viterbi_device)
    with pytest.raises(ValueError, match="offsets"):
        gene_viterbi_cuda(x, x, x, off, indel=-8.0, ins_extend=-2.0)
    em, trans, _ = arch_panel(np.random.default_rng(3), [40, 60], 8)
    em, trans = torch.from_numpy(em).to(viterbi_device), torch.from_numpy(trans).to(viterbi_device)
    with pytest.raises(ValueError, match="offsets"):
        arch_viterbi_cuda(em, trans, off)
    with pytest.raises(ValueError, match="at least one emission row"):
        arch_viterbi_cuda(em, trans, torch.tensor([0, 0, 100], dtype=torch.int64, device=viterbi_device))


def test_predictor_with_254_archetypes_on_card_equals_cpu(viterbi_device, tmp_path):
    """``ArchitecturalPredictor`` from a 254-archetype model (257 states: the architectural
    decode's block-a-contig form) on the card equals the CPU path."""
    import io

    from torch_synthetic import make_synthetic_db, random_dna

    from kaptive_tpu_torch.bgc import Annotator, ArchitecturalPredictor, ArchitecturalTrainer
    from kaptive_tpu_torch.core.genome import GenomeAssembly
    from kaptive_tpu_torch.db import Database
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    rng = np.random.default_rng(254)
    gbk, truth = make_synthetic_db(tmp_path, rng, n_loci=20, genes_per_locus=16)  # 320 proteins to cluster
    db = Database.from_genbank(gbk)
    fasta = b">c1\n%s\n" % (random_dna(rng, 3000) + truth["loci"]["KL2"]["seq"] + random_dna(rng, 3000))
    model = ArchitecturalTrainer(num_archetypes=254, feature_dim=64).train(
        [db.get_locus_data(n) for n in db.loci.ids])
    annotation = Annotator(db, align=False, device="cpu")(GenomeAssembly.from_stream(io.BytesIO(fasta), "g"))
    reset_metrics()
    on_card = ArchitecturalPredictor(model, device="cuda").predict(annotation)
    counts = snapshot()
    assert counts.get("viterbi.cuda.arch_wide", 0) > 0 and "viterbi.cuda.arch" not in counts
    on_cpu = ArchitecturalPredictor(model, device="cpu").predict(annotation)
    for name in ("contig_names", "offsets", "lengths", "member_orfs", "member_states"):
        np.testing.assert_array_equal(getattr(on_card, name), getattr(on_cpu, name))
    np.testing.assert_allclose(on_card.scores, on_cpu.scores, rtol=1e-5)


def test_bgc_annotate_and_predict_on_card_equal_cpu(viterbi_device, tmp_path):
    """The BGC toolkit on the card (gene decode, aligned hits, emissions, architectural decode)
    equals its CPU path: Genes, BED bytes, alignments, and predictions (scores to rtol 1e-5:
    the emissions' matrix product sums in another order on the card)."""
    import io

    from torch_synthetic import make_synthetic_db, random_dna

    from kaptive_tpu_torch.bgc import Annotator, ArchitecturalPredictor, ArchitecturalTrainer
    from kaptive_tpu_torch.core.genome import GenomeAssembly
    from kaptive_tpu_torch.db import Database
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    rng = np.random.default_rng(17)
    gbk, truth = make_synthetic_db(tmp_path, rng, n_loci=3, genes_per_locus=6)
    db = Database.from_genbank(gbk)
    fasta = b">c1\n%s\n>c2\n%s\n" % (random_dna(rng, 3000) + truth["loci"]["KL2"]["seq"] + random_dna(rng, 3000),
                                     random_dna(rng, 5000))
    model = ArchitecturalTrainer(num_archetypes=5, feature_dim=256).train(
        [db.get_locus_data(n) for n in ("KL1", "KL2", "KL3")])
    out = {}
    for dev in ("cpu", "cuda"):
        reset_metrics()
        annotation = Annotator(db, align=True, device=dev)(GenomeAssembly.from_stream(io.BytesIO(fasta), "g"))
        predicted = ArchitecturalPredictor(model, device=dev).predict(annotation)
        annotation.write_bed(tmp_path / f"{dev}.bed", hits_only=False)
        out[dev] = (annotation, predicted, (tmp_path / f"{dev}.bed").read_bytes(), snapshot())
    (a_cpu, p_cpu, bed_cpu, _), (a_gpu, p_gpu, bed_gpu, counts) = out["cpu"], out["cuda"]
    assert bed_gpu == bed_cpu and len(a_gpu.genes) > 0
    np.testing.assert_array_equal(a_gpu.alignments.scores, a_cpu.alignments.scores)
    assert any("KL2" in str(n) for n in a_gpu.top_hit_names[a_gpu.hits_mask])
    for name in ("contig_names", "offsets", "lengths", "member_orfs", "member_states"):
        np.testing.assert_array_equal(getattr(p_gpu, name), getattr(p_cpu, name))
    np.testing.assert_allclose(p_gpu.scores, p_cpu.scores, rtol=1e-5)
    for name in ("viterbi.cuda.gene", "viterbi.cuda.arch", "swg.cuda.fill", "swg.cuda.traceback"):
        assert counts.get(name, 0) > 0, name
    assert not any(".plain." in name for name in counts)


# --- F1: device seeding in chunks of the batch -------------------------------


@pytest.fixture(scope="module")
def seeding_batch(scan_device, tmp_path_factory):
    """A typing database and 64 assemblies of ~0.5 Mb, each with a planted locus;
    one assembly is seeded first so that the database's tables are resident."""
    import io

    from torch_synthetic import make_genome_from_locus, make_synthetic_db

    from kaptive_tpu_torch.core.genome import GenomeAssembly
    from kaptive_tpu_torch.db import Database
    from kaptive_tpu_torch.ops.minimizer import ContigIndex

    rng = np.random.default_rng(64)
    gbk, truth = make_synthetic_db(tmp_path_factory.mktemp("seeding"), rng, n_loci=4)
    db = Database.from_genbank(gbk)
    loci = list(truth["loci"])
    genomes = [GenomeAssembly.from_stream(io.BytesIO(make_genome_from_locus(rng, truth, loci[i % len(loci)],
                                                                             flank=250_000)), f"g{i}")
               for i in range(64)]
    indexes = [ContigIndex.build(g.contigs) for g in genomes]
    _seed_peak(db, genomes[:1], indexes[:1], None)
    return db, genomes, indexes


def _seed_peak(db, genomes, indexes, chunk):
    from kaptive_tpu_torch.ops.mapper import MapperParams, _map_genes_device_seeded

    names = tuple(str(i) for i in range(len(db.genes)))
    gi = db.gene_index
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = _map_genes_device_seeded(gi, genomes, indexes, names, MapperParams(), torch.device("cuda", 0),
                                   chunk=chunk)
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def test_one_genome_seeding_replays_a_graph_equal_to_seed_chunk(seeding_batch):
    """At batch 1 on the card the scan, match and chain replay a captured CUDA graph: on one genome cut
    into 1 to 300 contigs (two widths of padded contig starts) every output buffer equals
    ``seed_chunk``'s launched eagerly, each shape is captured once, and each replay counts one scan."""
    from kaptive_tpu_torch.core.genome import GenomeAssembly
    from kaptive_tpu_torch.ops import mapper as tm
    from kaptive_tpu_torch.ops.minimizer import ContigIndex
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    db, genomes, _ = seeding_batch
    gi, params, dev = db.gene_index, tm.MapperParams(), torch.device("cuda", 0)
    shards = [(dev, gi.seed_table(dev))]
    seq = genomes[0].contigs.seqs.tobytes()
    indexes = []
    for n in (1, 7, 200, 300, 3):
        cuts = np.linspace(0, len(seq), n + 1).astype(int)
        fasta = b"".join(b">c%d\n%s\n" % (j, seq[cuts[j] : cuts[j + 1]]) for j in range(n))
        indexes.append(ContigIndex.build(GenomeAssembly.from_stream(io.BytesIO(fasta), f"cut{n}").contigs))
    shapes = {(len(ci.codes), max(256, 1 << (len(ci.starts) - 1).bit_length())) for ci in indexes}
    gi._cache.pop("seed_graphs", None)
    reset_metrics()
    for ci in indexes:
        codes, starts = tm._batch_codes([ci], len(ci.codes), dev)
        want = tm.seed_chunk(codes, starts, shards, gi, params)
        got = tm._seed_one_graphed(codes, starts, shards, gi, params)
        assert int(want[1][5, 0]) > 0, len(ci.starts)
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w), len(ci.starts)
    seen = snapshot()
    assert seen["map.seed_graph"] == len(indexes) and seen["map.seed_graph.capture"] == len(shapes) >= 2
    assert seen["scan.cuda.rowcompact"] == 2 * len(indexes) + len(shapes)  # eager, replays, capture warm-ups


@pytest.mark.parametrize("chunk", ["sized", 4])
def test_seeding_peak_memory_does_not_grow_past_one_chunk(seeding_batch, chunk):
    """Peak memory at stream batches 8 and 32 differs by less than one chunk's worth, with
    chunks forced to 4 genomes or sized by ``seeding_chunk`` from a card that reports room
    for 6 (an 80 GB card holds the whole batch in one chunk, which would test nothing)."""
    from unittest import mock

    from kaptive_tpu_torch.ops.mapper import genome_footprint, seeding_chunk

    db, genomes, indexes = seeding_batch
    L = max(len(ci.codes) for ci in indexes)
    device = torch.device("cuda", 0)
    free, total = torch.cuda.mem_get_info(device)
    room = 2 * 6 * genome_footprint(L) + genome_footprint(L) // 2
    with mock.patch.object(torch.cuda, "mem_get_info", lambda *_: (min(free, room), total)):
        size = seeding_chunk(L, 32, device) if chunk == "sized" else chunk
        assert size < 8
        _, peak8 = _seed_peak(db, genomes[:8], indexes[:8], None if chunk == "sized" else chunk)
        _, peak32 = _seed_peak(db, genomes[:32], indexes[:32], None if chunk == "sized" else chunk)
    per_chunk = size * genome_footprint(L)
    print(f"chunk {chunk} ({size} genomes): peak {peak8 / 1e6:.1f} MB at batch 8, {peak32 / 1e6:.1f} MB at "
          f"batch 32, one chunk's worth {per_chunk / 1e6:.1f} MB")
    assert peak32 - peak8 < per_chunk


def test_seeding_batch_of_64_completes_and_chunks_agree(seeding_batch):
    from typing_panel import assert_same

    db, genomes, indexes = seeding_batch
    whole, _ = _seed_peak(db, genomes, indexes, None)
    chunked, _ = _seed_peak(db, genomes, indexes, 5)
    assert len(whole) == 64 and all(len(a) > 0 for a in whole)
    for got, want in zip(chunked, whole, strict=True):
        assert_same(got, want)


def test_seeding_in_chunks_of_one_genome_keeps_each_genomes_alignments(seeding_batch):
    """Four different genomes seeded one a chunk on the card each keep their own alignments: equal to
    the unchunked batch's and to host seeding's.  No chunk of a larger batch replays the one-genome
    graph, whose outputs its next replay would overwrite."""
    from typing_panel import assert_same

    from kaptive_tpu_torch.ops.mapper import MapperParams, _map_genes_host_seeded
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    db, genomes, indexes = seeding_batch
    genomes, indexes = genomes[:4], indexes[:4]
    names = tuple(str(i) for i in range(len(db.genes)))
    host = _map_genes_host_seeded(db.gene_index, genomes, indexes, names, MapperParams(), torch.device("cuda", 0))
    whole, _ = _seed_peak(db, genomes, indexes, None)
    reset_metrics()
    single, _ = _seed_peak(db, genomes, indexes, 1)
    seen = snapshot()
    assert len({(a.q_name_ids.tobytes(), a.scores.tobytes()) for a in host}) == 4  # the genomes differ
    for got, want, ref in zip(single, whole, host, strict=True):
        assert len(ref) > 0
        assert_same(got, want)
        assert_same(got, ref)
    assert seen.get("map.device_chained") == 4 and "map.seed_graph" not in seen, seen


# --- the mesh: four slots of one card -----------------------------------------


def _card_mesh(shape):
    from kaptive_tpu_torch.parallel import make_mesh

    data, model = shape
    slots = [torch.device("cuda", i % torch.cuda.device_count()) for i in range(data * model)]
    return make_mesh(devices=slots, model_parallel=model)


def test_mesh_serotyper_on_card_equals_single_device(scan_device, tmp_path):
    """The typing panel on a (2, 2) mesh of four card slots: batch, stream and screen equal one card's,
    and the scan, fill and traceback ran on the kernels only."""
    import io

    import kaptive_tpu_torch  # noqa: F401  (first: keeps the JAX package's jax imports out)
    from typing_panel import TRUTH, make_port_typing_panel

    from kaptive_tpu_torch.parallel import stream_type
    from kaptive_tpu_torch.serotyping import Serotyper
    from kaptive_tpu_torch.serotyping.io import KaptiveRow
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    db, genomes = make_port_typing_panel(tmp_path)
    single = Serotyper(db, device="cuda")
    want = [bytes(KaptiveRow.from_result(r)) for r in single.batch([io.BytesIO(f) for _, f in genomes])]
    mesh = Serotyper(db, mesh=_card_mesh((2, 2)))
    reset_metrics()
    batch = mesh.batch([io.BytesIO(f) for _, f in genomes])
    streamed = list(stream_type(mesh, [io.BytesIO(f) for _, f in genomes], batch_size=3))
    counts = snapshot()
    assert [r.best_locus_name for r in batch] == TRUTH
    assert [bytes(KaptiveRow.from_result(r)) for r in batch + streamed] == want + want
    for name in ("scan.cuda.rowcompact", "swg.cuda.fill", "swg.cuda.traceback"):
        assert counts.get(name, 0) > 0, (name, counts)
    assert not any(".plain." in name for name in counts), counts
    assert counts["swg.cuda.fill"] % 4 == 0  # every bucket cut over the four slots
    _, best, weighted = mesh.screen([io.BytesIO(f) for _, f in genomes])
    _, best_one, weighted_one = single.screen([io.BytesIO(f) for _, f in genomes])
    np.testing.assert_array_equal(best, best_one)
    np.testing.assert_array_equal(weighted, weighted_one)


def test_sharded_banded_swg_on_card_equals_banded_swg(device):
    from kaptive_tpu_torch.ops.swg import banded_swg
    from kaptive_tpu_torch.ops.swg_cuda import as_kernel_matrix
    from kaptive_tpu_torch.parallel.typing import sharded_banded_swg

    rows_max, w_pad = 1024, 128
    arrays = random_swg_batch(np.random.default_rng(11), NT, 384, rows_max, w_pad, seeded=True)
    args = [torch.from_numpy(a).to(device) for a in arrays]
    matrix = as_kernel_matrix(torch.from_numpy(nt_matrix()), device)
    statics = dict(gap_open=4, gap_extend=2, rows_max=rows_max, w_pad=w_pad, t_pad=w_pad + 2)
    want = banded_swg(*args, matrix, **statics)
    for shape in ((2, 2), (1, 4)):
        got = sharded_banded_swg(_card_mesh(shape), *args, matrix, **statics)
        for field, g, w in zip(want._fields, got, want, strict=True):
            assert torch.equal(g, w), (shape, field)


def test_sharded_seeding_on_four_slots_stays_within_one_slot_budget(seeding_batch):
    """Four slots of one card share its free memory: each row's chunk is sized from a quarter of
    the budget. Free memory is mocked to room for 2 genomes a slot, so a chunk sized from the
    whole budget (a row's 4 genomes at once) would pass the quarter that the peak is held to."""
    from unittest import mock

    from kaptive_tpu_torch.ops.mapper import MapperParams, genome_footprint, seeding_chunk
    from kaptive_tpu_torch.parallel.typing import ShardedGeneTable, sharded_scan_match_chain

    db, genomes, indexes = seeding_batch
    gi, p = db.gene_index, MapperParams()
    L = max(len(ci.codes) for ci in indexes)
    device = torch.device("cuda", 0)
    mesh = _card_mesh((2, 2))
    table = ShardedGeneTable.of(gi, 2)
    want = sharded_scan_match_chain(mesh, indexes[:2], table, gi, p, length=L)  # tables resident first
    free, total = torch.cuda.mem_get_info(device)
    budget = 4 * 2 * genome_footprint(L) + genome_footprint(L) // 2  # half the mocked free memory
    with mock.patch.object(torch.cuda, "mem_get_info", lambda *_: (min(free, 2 * budget), total)):
        assert seeding_chunk(L, 4, device, 4) == 2 and seeding_chunk(L, 4, device, 1) == 4
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        chains, counts = sharded_scan_match_chain(mesh, indexes[:8], table, gi, p, length=L)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    print(f"sharded seeding of 8 genomes on 4 slots: peak {peak / 1e6:.1f} MB; the budget "
          f"{budget / 1e6:.1f} MB, a slot's quarter of it {budget // 4 / 1e6:.1f} MB")
    assert peak < budget // 4
    np.testing.assert_array_equal(chains[:2], want[0])
    assert (counts[5] > 0).all()


# The flat scan (``minimizer_scan_kernel``): every panel whole, as one stream a row.
FLAT_CASES = ([(name, B, 15, 10) for name in SCAN_PANELS for B in (1, 3)]
              + [(name, 2, k, w) for k, w in KW_CASES for name in ("odd-rows-1000", "poly-a-across-edges")])


def _assert_flat_kernel_equals_plain(codes, k, w):
    from kaptive_tpu_torch.ops.scan import minimizer_scan_plain
    from kaptive_tpu_torch.ops.scan_cuda import minimizer_scan_cuda

    got = minimizer_scan_cuda(codes, k, w)
    want = minimizer_scan_plain(codes, k, w)  # the plain form on the same card tensor
    torch.cuda.synchronize()
    for field, g, x in zip(("selected", "hashes", "strands"), got, want):
        assert g.shape == x.shape and g.dtype == x.dtype, field
        assert torch.equal(g, x), (field, k, w)
    return want


@pytest.mark.parametrize("case", FLAT_CASES, ids=[f"{n}-B{b}-k{k}-w{w}" for n, b, k, w in FLAT_CASES])
def test_flat_scan_kernel_equals_plain(scan_device, case):
    name, B, k, w = case
    rng = np.random.default_rng(sum(map(ord, name)) + 7 * B)
    codes = torch.from_numpy(np.stack([SCAN_PANELS[name](rng) for _ in range(B)]))
    sel, _, _ = _assert_flat_kernel_equals_plain(codes.to(scan_device), k, w)
    if name == "poly-a-overflow" and (k, w) == (15, 10):
        assert bool(sel[:, 5000:5386].all())


@pytest.mark.parametrize("L", [15, 16, 24, 25, 1023, 1025, 4097, 200_003])
def test_flat_scan_kernel_equals_plain_on_odd_lengths(scan_device, L):
    """Random (3, L) streams with sprinkled sentinels, sentinel runs and a poly-A run,
    ends that are valid bases (the k-mers near L roll over to the stream's start),
    and every window width and k at the edges of the kernel's range."""
    from kaptive_tpu_torch.ops.scan_cuda import minimizer_scan_cuda

    rng = np.random.default_rng(L)
    codes = rng.integers(0, 4, (3, L)).astype(np.uint8)
    codes[rng.random((3, L)) < 0.002] = 4
    codes[1, L // 3: L // 3 + min(40, L // 4)] = 4
    codes[2, L // 2: L // 2 + min(400, L // 4)] = 0
    codes[:, -3:] = rng.integers(0, 4, (3, 3))
    cuda = torch.from_numpy(codes).to(scan_device)
    for k, w in ((15, 10), (16, 32), (1, 1), (5, 3)):
        _assert_flat_kernel_equals_plain(cuda, k, w)
    for row in range(3):  # a (L,) stream is one row
        got = minimizer_scan_cuda(cuda[row], 15, 10)
        batched = minimizer_scan_cuda(cuda, 15, 10)
        for g, x in zip(got, batched):
            assert torch.equal(g, x[row])
    _assert_flat_kernel_equals_plain(cuda, 17, 10)  # the run-time form
    _assert_flat_kernel_equals_plain(cuda, 15, 33)


@pytest.mark.parametrize("kw", WIDE_KW, ids=[f"k{k}-w{w}" for k, w in WIDE_KW])
def test_flat_scan_kernel_equals_plain_past_the_tiled_range(scan_device, kw):
    """The run-time form of the flat scan (counter ``scan.cuda.flat_any``; past its widest window
    the sparse-table form, ``scan.cuda.flat_sparse``): random rows with sentinel runs, poly-A and
    valid bases to the end, codes 5 and 255, an all-sentinel row; an odd length, and a (L,)
    stream equal to its row of the batch."""
    from range_panels import scan_stream

    from kaptive_tpu_torch.ops.scan_cuda import minimizer_scan_cuda
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    k, w = kw
    rng = np.random.default_rng(97 * k + w)
    L = 9_001
    codes = np.stack([scan_stream(rng, L) for _ in range(3)] + [np.full(L, 4, np.uint8)])
    codes[0, -3:] = (1, 2, 3)  # k-mers that roll over the end
    codes[1, rng.random(L) < 0.01] = 5
    codes[1, -1] = 255
    cuda = torch.from_numpy(codes).to(scan_device)
    reset_metrics()
    sel, _, _ = _assert_flat_kernel_equals_plain(cuda, k, w)
    assert snapshot() == {f"scan.cuda.flat_{_wide_form(k, w)}": 1, "scan.plain.flat": 1}
    assert bool(sel[0].any()) and not bool(sel[3].any())
    for g, x in zip(minimizer_scan_cuda(cuda[2], k, w), minimizer_scan_cuda(cuda, k, w)):
        assert torch.equal(g, x[2])


MAPPED_FIELDS = ("q_starts", "q_ends", "t_starts", "t_ends", "scores", "matches", "mismatches", "strands",
                 "q_name_ids", "t_name_ids", "qualities", "is_primary", "divergence")


def test_device_seeded_mapping_with_a_wide_index_on_card_equals_cpu(scan_device, tmp_path):
    """``map_genes_batch`` device-seeded on the card with a k = 17, w = 40 ``GeneIndex`` (the
    row-compact scan's run-time form) equals the same call on the CPU, every field."""
    import kaptive_tpu_torch  # noqa: F401  (first: keeps the JAX package's jax imports out)
    from typing_panel import make_port_typing_panel

    from kaptive_tpu_torch.core.genome import GenomeAssembly
    from kaptive_tpu_torch.ops.mapper import GeneIndex, map_genes_batch
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    db, genomes = make_port_typing_panel(tmp_path)
    index = GeneIndex.build(db.genes, k=17, w=40)
    names = tuple(str(i) for i in range(len(db.genes)))
    assemblies = [GenomeAssembly.from_stream(io.BytesIO(f), n) for n, f in genomes]
    reset_metrics()
    on_card = map_genes_batch(index, assemblies, names, seed_mode="device", device="cuda")
    counts = snapshot()
    assert counts.get("scan.cuda.rowcompact_any", 0) > 0 and "scan.cuda.rowcompact" not in counts
    assert not any(name.startswith("scan.plain") for name in counts)
    on_cpu = map_genes_batch(index, assemblies, names, seed_mode="device", device="cpu")
    assert len(on_card) == len(on_cpu) and sum(len(a) for a in on_cpu) > 0
    for got, want in zip(on_card, on_cpu):
        for field in MAPPED_FIELDS:
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)


@pytest.mark.parametrize("w", range(1, 33))
def test_flat_scan_kernel_equals_plain_at_every_window_width(scan_device, w):
    """Every template instance of the kernel (k = 15), on a random stream and a poly-A run laid
    across the tile's edges, as two rows of one batch."""
    rng = np.random.default_rng(600 + w)
    codes = np.stack([random_stream(rng, 72), EDGE_PANELS["poly-a-across-edges"](rng)])
    _assert_flat_kernel_equals_plain(torch.from_numpy(codes).to(scan_device), 15, w)


@pytest.mark.parametrize("L", [1023, 4100, 8192, 200_003])
def test_flat_scan_kernel_equals_plain_on_raw_codes(scan_device, L):
    """Codes 5 and 255 (a word whose k-mers reach one takes its strands from the raw codes), an
    all-sentinel row and a row of valid bases beside them; B = 3, and L % 16 != 0 but for 8192
    (rows that start at unaligned bytes); the tiled kernel and, at (19, 19) and (21, 11), the
    run-time form."""
    rng = np.random.default_rng(L + 1)
    codes = rng.integers(0, 4, (3, L)).astype(np.uint8)
    codes[0, rng.random(L) < 0.01] = 5
    codes[0, rng.random(L) < 0.01] = 255
    codes[0, rng.random(L) < 0.01] = 4
    codes[0, -1] = 255  # read by the k-mers that roll over the end
    codes[1] = 4
    for k, w in ((15, 10), (16, 32), (11, 5), (1, 1), (19, 19), (21, 11)):
        _assert_flat_kernel_equals_plain(torch.from_numpy(codes).to(scan_device), k, w)


def test_flat_scan_front_door_routes_by_device(scan_device):
    """``minimizer_scan``: a CUDA tensor reaches only the kernel, a CPU tensor only the plain form."""
    from kaptive_tpu_torch.core.seq import Sequences
    from kaptive_tpu_torch.ops.minimizer import build_minimizer_set, minimizer_scan
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    codes = torch.from_numpy(random_stream(np.random.default_rng(9), 300))
    from kaptive_tpu_torch.ops import scan_cuda

    launched = []

    def spy(*args):
        launched.append(kernel(*args))
        return launched[-1]

    kernel = scan_cuda.minimizer_scan_cuda
    reset_metrics()
    with mock.patch.object(scan_cuda, "minimizer_scan_cuda", spy):
        on_card = minimizer_scan(codes.to(scan_device))
    assert snapshot() == {"scan.cuda.flat": 1}
    # The kernel's int64 hashes are what the caller gets: no conversion after the launch.
    assert all(g is x for g, x in zip(on_card, launched[0])) and on_card[1].dtype == torch.int64
    reset_metrics()
    on_cpu = minimizer_scan(codes)
    assert snapshot() == {"scan.plain.flat": 1}
    for g, x in zip(on_card, on_cpu):
        assert g.is_cuda and g.dtype == x.dtype and torch.equal(g.cpu(), x)
    rng = np.random.default_rng(10)
    seqs = Sequences.from_bytes([bytes(rng.choice(list(b"ACGTN"), n, p=[.249, .249, .249, .249, .004]))
                                 for n in (900, 14, 2500, 3000)])
    reset_metrics()
    on_card_set = build_minimizer_set(seqs, device=True, sort=False)
    assert snapshot() == {"scan.cuda.flat": 1}
    for field in ("hashes", "seq_indices", "positions", "strands"):
        for other in (build_minimizer_set(seqs, sort=False), build_minimizer_set(seqs, device="cpu", sort=False)):
            np.testing.assert_array_equal(getattr(on_card_set, field), getattr(other, field), err_msg=field)


def test_screen_overflow_runs_the_flat_kernel(scan_device, tmp_path):
    """A genome with an overflowing scan row is re-tallied by the flat-scan kernel on the card:
    no plain form runs there, and ``best`` and the tallies equal the CPU's."""
    import kaptive_tpu_torch  # noqa: F401  (first: keeps the JAX package's jax imports out)
    from typing_panel import make_port_typing_panel

    from kaptive_tpu_torch.parallel.screen import ScreenTables, encode_assemblies_to_batch, locus_screen_batch
    from kaptive_tpu_torch.serotyping import Serotyper
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    db, genomes = make_port_typing_panel(tmp_path)
    revcomp = dict(genomes)["revcomp"]
    genomes.append(("poly_a", revcomp[:4] + b"A" * 400 + revcomp[4:]))
    paths = []
    for name, fasta in genomes:
        (path := tmp_path / f"{name}.fasta").write_bytes(fasta)
        paths.append(path)
    reset_metrics()
    assemblies, best, weighted = Serotyper(db, device="cuda").screen(paths)
    counts = snapshot()
    assert counts.get("screen.overflow") == 1 and counts.get("scan.cuda.flat") == 1
    assert not any(name.startswith("scan.plain") for name in counts)
    _, best_cpu, weighted_cpu = Serotyper(db, device="cpu").screen(paths)
    np.testing.assert_array_equal(best, best_cpu)
    np.testing.assert_allclose(weighted, weighted_cpu, rtol=1e-6)
    codes = torch.from_numpy(encode_assemblies_to_batch(assemblies))
    tables = ScreenTables.from_database(db)
    _, _, tallies_card = locus_screen_batch(codes.to(scan_device), tables, len(db.genes))
    _, _, tallies_cpu = locus_screen_batch(codes, tables, len(db.genes))
    assert torch.equal(tallies_card.cpu(), tallies_cpu)


@pytest.mark.parametrize("n_states", [3, 28])
def test_architectural_viterbi_on_card_equals_cpu(viterbi_device, n_states):
    """The one-contig front door: one launch of the architectural kernel, equal to the CPU's."""
    from viterbi_panels import arch_panel

    from kaptive_tpu_torch.bgc.kernels import architectural_viterbi
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    em, trans, _ = arch_panel(np.random.default_rng(40 + n_states), [2500], n_states)
    reset_metrics()
    path, score = architectural_viterbi(em, trans)
    torch.cuda.synchronize()
    assert snapshot() == {"viterbi.cuda.arch": 1}
    assert path.is_cuda and score.is_cuda and score.dim() == 0
    want_path, want_score = architectural_viterbi(em, trans, device="cpu")
    assert torch.equal(path.cpu(), want_path) and torch.equal(score.cpu(), want_score)
