"""The port's row-compact scan, lane compaction and stream unpacking vs the JAX package's.

Inputs are made with numpy from fixed seeds and go through the JAX package's
``rowcompact_scan_xla`` (the XLA mirror of the Pallas kernel) and the port's
``rowcompact_scan_plain`` (CPU tensors).  Tolerance: exact on ``hashes``
(compared as uint32), ``aux`` and ``counts``; the decoded minimizer set also
equals the host scan's wherever no row overflows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scan_panels import PANELS, random_stream

from kaptive_tpu.ops import scan_pallas as SP
from kaptive_tpu.ops.minimizer import DEFAULT_K, DEFAULT_W, minimizer_scan_host

torch.set_num_threads(1)  # the test runs beside other test processes


def _host_set(codes):
    sel, hashes, strands = minimizer_scan_host(codes, DEFAULT_K, DEFAULT_W)
    return {(int(p), int(hashes[p]), bool(strands[p])) for p in np.flatnonzero(sel)}


def _decode_rows(h, a):
    got = set()
    for r, s in zip(*np.nonzero(h != 0xFFFFFFFF)):
        got.add((int(r) * SP.ROW + (int(a[r, s]) & (SP.ROW - 1)), int(h[r, s]), bool((a[r, s] >> 7) & 1)))
    return got


def _port_scan(padded):
    from kaptive_tpu_torch.ops.scan import rowcompact_scan

    h, a, c = rowcompact_scan(torch.from_numpy(padded), DEFAULT_K, DEFAULT_W)
    return h.numpy().view(np.uint32), a.numpy(), c.numpy()


def _jax_scan(padded):
    outs = SP.rowcompact_scan_xla(jnp.asarray(padded), DEFAULT_K, DEFAULT_W)
    return tuple(np.asarray(x) for x in outs)


@pytest.mark.parametrize("panel", list(PANELS))
def test_rowcompact_plain_equals_jax(panel):
    rng = np.random.default_rng(sum(map(ord, panel)))
    from kaptive_tpu_torch.ops.scan import pad_codes_for_scan_any

    codes = PANELS[panel](rng)
    padded = pad_codes_for_scan_any(codes)[None]
    np.testing.assert_array_equal(padded[0], SP.pad_codes_for_scan_any(codes))
    got, want = _port_scan(padded), _jax_scan(padded)
    for name, g, w in zip(("hashes", "aux", "counts"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    h, a, c = got
    if panel == "poly-a-overflow":
        assert int(c.max()) > SP.SLOTS
    else:
        assert int(c.max()) <= SP.SLOTS
        assert _decode_rows(h[0], a[0]) == _host_set(codes)


def test_rowcompact_plain_batch_equals_jax():
    """Three genomes in one batch: each row of the batch equals its single-genome scan."""
    rng = np.random.default_rng(41)
    padded = np.stack([SP.pad_codes_for_scan_any(random_stream(rng, 384)) for _ in range(3)])
    got, want = _port_scan(padded), _jax_scan(padded)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_front_door_counts_plain_on_cpu():
    from kaptive_tpu.utils.metrics import reset_metrics, snapshot

    rng = np.random.default_rng(2)
    reset_metrics()
    _port_scan(SP.pad_codes_for_scan_any(random_stream(rng, 64))[None])
    counts = snapshot()
    assert counts.get("scan.plain.rowcompact") == 1
    assert "scan.cuda.rowcompact" not in counts


@pytest.mark.parametrize("density", [0.2, 0.5, 0.9])
def test_compact_lanes_equals_jax(density):
    from kaptive_tpu_torch.ops.scan import compact_lanes

    rng = np.random.default_rng(int(density * 100))
    R, C, out = 48, 128, 64
    sel = rng.uniform(size=(R, C)) < density
    vals = rng.integers(-(1 << 30), 1 << 30, (R, C)).astype(np.int32)
    live_j, (out_j,), counts_j = SP.compact_lanes(jnp.asarray(sel), (jnp.asarray(vals),), C, out)
    live, (got,), counts = compact_lanes(torch.from_numpy(sel), (torch.from_numpy(vals),), out)
    live_j, out_j = np.asarray(live_j), np.asarray(out_j)
    np.testing.assert_array_equal(live.numpy(), live_j)
    np.testing.assert_array_equal(got.numpy()[live_j], out_j[live_j])
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))
    assert got.dtype == torch.int32 and counts.dtype == torch.int32


def test_unpack_forms_equal_jax():
    """Dense and sparse upload forms unpack to the JAX package's padded streams."""
    from kaptive_tpu.ops.minimizer import pack_2bit as jax_pack_2bit
    from kaptive_tpu.ops.minimizer import pack_valid_bits as jax_pack_valid_bits

    from kaptive_tpu_torch.ops.minimizer import pack_2bit, pack_valid_bits
    from kaptive_tpu_torch.ops.scan import unpack_sparse_to_padded, unpack_to_padded

    rng = np.random.default_rng(9)
    L = 64 * SP.ROW
    codes = random_stream(rng, 64)
    real = L - 300
    codes[real:] = 4
    np.testing.assert_array_equal(pack_2bit(codes), jax_pack_2bit(codes))
    np.testing.assert_array_equal(pack_valid_bits(codes), jax_pack_valid_bits(codes))
    want = np.asarray(SP.unpack_to_padded(jnp.asarray(pack_2bit(codes)), jnp.asarray(pack_valid_bits(codes)), L))
    got = unpack_to_padded(torch.from_numpy(pack_2bit(codes))[None],
                           torch.from_numpy(pack_valid_bits(codes))[None], L)
    np.testing.assert_array_equal(got.numpy()[0], want)
    np.testing.assert_array_equal(want.reshape(-1)[SP.PAD_POS : SP.PAD_POS + L], codes)

    n4 = (real + 3) // 4 * 4
    packed = pack_2bit(codes[:n4])
    exc = np.flatnonzero(codes[:n4] >= 4).astype(np.int32)
    for width, length in ((len(packed), L), (len(packed) + 100, L), (L // 4 + 64, L)):
        p = np.zeros(width, np.uint8)
        p[: len(packed)] = packed
        e = np.concatenate([exc, np.full(7, 0x40000000, np.int32)])  # padding the unpack drops
        want = np.asarray(SP.unpack_sparse_to_padded(jnp.asarray(p), jnp.asarray(e), jnp.int32(real), length))
        got = unpack_sparse_to_padded(torch.from_numpy(p)[None], torch.from_numpy(e).long()[None],
                                      torch.tensor([real]), length)
        np.testing.assert_array_equal(got.numpy()[0], want)
