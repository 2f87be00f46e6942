"""The port's plain forms against the JAX package at the edges of the kernels' input range.

Each input here is one the card kernels took only from a later widening:
band widths past 8,192, substitution scores outside int8, window widths past
32 (and past the row-compact scan's 1,024-position halo), k-mers longer than
16 bases, and more than 256 architectural states.  The plain forms are what
the card kernels are held to (``tests/test_torch_cuda.py``), so each is held
here to the JAX package on the same numpy inputs (``tests/range_panels.py``).

The flat JAX ``minimizer_scan`` unrolls its window loop at trace time, so at
w = 200 and more it is not compiled (minutes on this CPU); there the port is
held to the JAX package's numpy mirror ``minimizer_scan_host``, which
``test_host_mirror_equals_jitted_scan`` holds to ``minimizer_scan`` at w = 64.
The F7 pair runs in a one-pair bucket of 256 rows at ``w_pad`` 32,768: the
aligner plans 16,384 rows for it (8 GB of traceback bits in the JAX package's
lax path); rows past the query's 150 are never filled.

Tolerance: exact on every output (integer DP and hashing; the Viterbi paths
and float32 scores bit for bit).
"""

import numpy as np
import pytest
import torch
from range_panels import (
    F7_EXPECTED, F7_W_PAD, LONG_KMERS, WIDE_MATRICES, WIDE_WINDOWS, f7_bucket, f7_pair, flat_panel,
    rowcompact_panel,
)
from swg_panels import random_swg_batch
from viterbi_panels import arch_tie_panel

from kaptive_tpu.bgc import kernels as jax_kernels
from kaptive_tpu.core import pairwise as jax_pairwise
from kaptive_tpu.ops import minimizer as jax_minimizer
from kaptive_tpu.ops import scan_pallas as jax_scan
from kaptive_tpu.ops import swg as jax_swg

from kaptive_tpu_torch.core import pairwise as port_pairwise
from kaptive_tpu_torch.ops import swg as port_swg
from kaptive_tpu_torch.ops.scan import minimizer_scan_plain, rowcompact_scan_plain
from kaptive_tpu_torch.ops.viterbi import arch_viterbi_plain

torch.set_num_threads(1)  # the plain DP runs many tiny ops; see tests/test_torch_swg.py


def _assert_flat(codes, k, w, want):
    got = minimizer_scan_plain(torch.from_numpy(codes), k, w)
    for name, g, x in zip(("selected", "hashes", "strands"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x).astype(g.numpy().dtype), err_msg=f"{name} k={k} w={w}")


def _assert_rowcompact(codes, k, w):
    want = [np.asarray(x) for x in jax_scan.rowcompact_scan_xla(codes, k, w)]
    got = rowcompact_scan_plain(torch.from_numpy(codes), k, w)
    for name, g, x in zip(("hashes", "aux", "counts"), got, want):
        np.testing.assert_array_equal(g.numpy(), x.view(np.int32), err_msg=f"{name} k={k} w={w}")
    return got


@pytest.mark.parametrize("w", [33, 64])
def test_flat_scan_plain_equals_jax_at_wide_windows(w):
    codes = flat_panel()
    _assert_flat(codes, 15, w, jax_minimizer.minimizer_scan(codes, 15, w))


@pytest.mark.parametrize("w", [200, 1000, 1100])
def test_flat_scan_plain_equals_jax_host_mirror_at_wide_windows(w):
    codes = flat_panel()
    selected, _, _ = want = jax_minimizer.minimizer_scan_host(codes, 15, w)
    assert selected.any()  # a window of 1,100 fits the 3,000 positions
    _assert_flat(codes, 15, w, want)


def test_host_mirror_equals_jitted_scan():
    codes = flat_panel()
    for got, want in zip(jax_minimizer.minimizer_scan_host(codes, 15, 64), jax_minimizer.minimizer_scan(codes, 15, 64)):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("k", LONG_KMERS)
def test_flat_scan_plain_equals_jax_at_long_kmers(k):
    codes = flat_panel()
    codes[-3:] = (0, 1, 4)  # k-mers that roll over the stream's end hold a sentinel and valid bases
    _assert_flat(codes, k, 10, jax_minimizer.minimizer_scan(codes, k, 10))
    _assert_flat(codes, k, 40, jax_minimizer.minimizer_scan_host(codes, k, 40))


@pytest.mark.parametrize("L", [15, 16, 40])
def test_flat_scan_plain_equals_jax_with_kmers_longer_than_the_stream(L):
    """A k-mer longer than its stream rolls over the stream's start more than once, as the JAX
    scan's rolls do (the plain form once read past the wrapped copy and raised)."""
    codes = np.random.default_rng(L).integers(0, 5, L).astype(np.uint8)
    for k in (17, 31):
        _assert_flat(codes, k, 10, jax_minimizer.minimizer_scan(codes, k, 10))


@pytest.mark.parametrize("w", WIDE_WINDOWS)
def test_rowcompact_scan_plain_equals_jax_at_wide_windows(w):
    got = _assert_rowcompact(rowcompact_panel(), 15, w)
    assert int(got[2].sum()) > 0


@pytest.mark.parametrize("k,w", zip(LONG_KMERS, (10, 33, 40)))
def test_rowcompact_scan_plain_equals_jax_at_long_kmers(k, w):
    _assert_rowcompact(rowcompact_panel(), k, w)


def test_f7_pair_at_w_pad_32768_equals_jax():
    """The unseeded F7 pair in its w_pad 32,768 bucket: banded SWG with the count-only walk and
    with the CIGAR walk, every field, and the recorded JAX values."""
    arrays = f7_bucket()
    matrix = port_pairwise.blosum62_matrix().astype(np.int32)
    kw = dict(gap_open=11, gap_extend=1, rows_max=arrays[0].shape[1], w_pad=F7_W_PAD, t_pad=F7_W_PAD + 2)
    want = jax_swg.banded_swg_lax(*arrays, matrix, **kw)
    got = port_swg.banded_swg(*(torch.from_numpy(a) for a in arrays), torch.from_numpy(matrix), **kw)
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field)
    for field, value in F7_EXPECTED.items():
        assert int(getattr(got, field)[0]) == value, field

    want_c = jax_swg.banded_swg_lax_cigars(*arrays, matrix, **kw)
    got_c = port_swg.banded_swg_cigars(*(torch.from_numpy(a) for a in arrays), torch.from_numpy(matrix), **kw)
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got_c[0], field).numpy(), np.asarray(getattr(want_c[0], field)))
    for name, g, x in zip(("ops", "n_ops", "overflow"), got_c[1:], want_c[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x).astype(g.numpy().dtype), err_msg=name)
    assert int(got_c[2][0]) == 1 and int(got_c[1][0, 0]) == (150 << 4)  # one run: 150M


def test_f7_pair_plans_the_32768_bucket():
    """Both packages' aligners plan w_pad 32,768 for the F7 pair."""
    from kaptive_tpu_torch.ops.swg import plan_swg_buckets

    query, target = f7_pair()
    w_needed = np.array([2 * (abs(len(query) - len(target)) + 1) + 3])
    joint = np.array([max(len(query), len(target))])
    for plan in (plan_swg_buckets, jax_swg.plan_swg_buckets):
        [(_, rows_max, w_pad, _)] = plan(joint, w_needed, None)
        assert (rows_max, w_pad) == (16384, F7_W_PAD)


@pytest.mark.parametrize("name", WIDE_MATRICES)
def test_int32_matrix_banded_swg_equals_jax(name):
    alphabet, matrix_fn, go, ge = WIDE_MATRICES[name]
    matrix = matrix_fn()
    assert matrix.min() < -128 or matrix.max() > 127
    arrays = random_swg_batch(np.random.default_rng(8), alphabet, 6, 64, 128, seeded=False)
    kw = dict(gap_open=go, gap_extend=ge, rows_max=64, w_pad=128, t_pad=130)
    want = jax_swg.banded_swg(*arrays, matrix, impl="lax", **kw)
    got = port_swg.banded_swg(*(torch.from_numpy(a) for a in arrays), torch.from_numpy(matrix), **kw)
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field)
    assert int(got.scores.max()) > 127 * 20


@pytest.mark.parametrize("name", WIDE_MATRICES)
def test_int32_matrix_batched_cigars_equal_jax(name):
    """``batched_swg_align_cigars(matrix=...)`` with scores outside int8, through each package's bucketing."""
    alphabet, matrix_fn, go, ge = WIDE_MATRICES[name]
    rng = np.random.default_rng(12)
    alpha = np.frombuffer(alphabet, np.uint8)
    qs = [alpha[rng.integers(0, len(alpha), int(rng.integers(30, 90)))] for _ in range(7)]
    ts = [np.concatenate([alpha[rng.integers(0, len(alpha), 5)], q[::-1] if i % 3 == 0 else q]) for i, q in enumerate(qs)]

    def ragged(xs):
        lengths = np.array([len(x) for x in xs], np.int32)
        return np.concatenate(xs), np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64), lengths

    args = (*ragged(qs), *ragged(ts), np.zeros(7, np.int32), np.full(7, 20, np.int32))
    want_a, want_c = jax_pairwise.batched_swg_align_cigars(*args, matrix_fn(), go, ge)
    got_a, got_c = port_pairwise.batched_swg_align_cigars(*args, matrix_fn(), go, ge, device="cpu")
    for field in ("scores", "matches", "mismatches", "gaps", "q_starts", "q_ends", "t_starts", "t_ends"):
        np.testing.assert_array_equal(getattr(got_a, field), np.asarray(getattr(want_a, field)), err_msg=field)
    for field in ("data", "offsets", "lengths"):
        np.testing.assert_array_equal(getattr(got_c, field), np.asarray(getattr(want_c, field)), err_msg=field)


@pytest.mark.parametrize("n_states", [257, 300])
def test_arch_viterbi_plain_equals_jax_past_256_states(n_states):
    em, trans, offsets = arch_tie_panel(np.random.default_rng(n_states), [50], n_states)
    want_path, want_score = jax_kernels.architectural_viterbi(em, trans)
    path, score = arch_viterbi_plain(torch.from_numpy(em), torch.from_numpy(trans), torch.from_numpy(offsets))
    np.testing.assert_array_equal(path.numpy(), np.asarray(want_path))
    assert score.numpy()[0].tobytes() == np.asarray(want_score, np.float32).tobytes()
