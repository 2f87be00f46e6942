"""The port's gene-finding HMM vs the JAX package's, on the CPU.

Both sides learn their emissions from the same gene bytes and read the same
contig bytes (``viterbi_panels``: the panels of ``tests/test_genefinder.py``
built from one seed).  The port's plain gene decode
(``kaptive_tpu_torch.ops.viterbi.gene_viterbi_plain``) is held to the JAX
``_viterbi_states`` on every strand, in one batch of mixed padded lengths,
and ``find_genes_hmm`` to the JAX ``find_genes_hmm``.  Tolerance: exact —
the states, and every ``Orf``'s start, end, strand and translation bytes.
"""

from unittest import mock

import numpy as np
import pytest
import torch
from viterbi_panels import gene_chains, gene_panels, gene_training_set, truncation_panels

torch.set_num_threads(1)  # the plain decode issues many tiny ops

PANELS = gene_panels()
TRUNCATED = truncation_panels()


@pytest.fixture(scope="module")
def params():
    """``(port params, JAX params)`` learned from the same genes."""
    from kaptive_tpu.bgc.genefinder import GeneHmmParams as JaxParams
    from kaptive_tpu.core.seq import Sequences as JaxSequences

    from kaptive_tpu_torch.bgc.genefinder import GeneHmmParams
    from kaptive_tpu_torch.core.seq import Sequences

    genes = gene_training_set()
    return (GeneHmmParams.from_sequences(Sequences.from_bytes(genes)),
            JaxParams.from_sequences(JaxSequences.from_bytes(genes)))


def _uniform():
    from kaptive_tpu.bgc.genefinder import GeneHmmParams as JaxParams

    from kaptive_tpu_torch.bgc.genefinder import GeneHmmParams

    return GeneHmmParams.uniform(coding_bonus=0.40), JaxParams.uniform(coding_bonus=0.40)


def test_params_from_sequences_equal_jax(params):
    port, ref = params
    np.testing.assert_array_equal(port.codon_logodds, ref.codon_logodds)
    assert port.codon_logodds.dtype == ref.codon_logodds.dtype
    assert (port.indel, port.ins_extend, port.entry) == (ref.indel, ref.ins_extend, ref.entry)
    np.testing.assert_array_equal(_uniform()[0].codon_logodds, _uniform()[1].codon_logodds)


@pytest.fixture(scope="module")
def decoded(params):
    """Every strand of every panel, plus unpadded truncation strands, in ONE plain decode:
    ``{case: [(port states, JAX states) per strand]}``."""
    from kaptive_tpu.bgc.genefinder import _viterbi_states

    from kaptive_tpu_torch.ops import minimizer
    from kaptive_tpu_torch.ops.viterbi import gene_viterbi_plain

    uniform = _uniform()[0]
    cases = [(name, [seq], params[0]) for name, seq in PANELS.items()]
    cases += [(name, [seq], uniform) for name, seq in TRUNCATED.items()]
    long_contig = b"".join(PANELS.values())[:9000]  # padded to 16 Ki positions
    cases.append(("long", [long_contig], params[0]))
    groups = []
    for name, contigs, p in cases:
        groups.append((name, p, gene_chains(contigs, p)))
    with mock.patch.object(minimizer, "bucket_length", lambda n, minimum=0: n):
        groups += [(f"{name}_unpadded", uniform, gene_chains([seq], uniform))
                   for name, seq in TRUNCATED.items()]

    # One batch of every chain: Lp 4 Ki, 16 Ki and the unpadded lengths. The
    # decode has one indel cost, so each parameter set gets its own batch.
    out = {}
    for p in (params[0], uniform):
        mine = [g for g in groups if g[1] is p]
        chains = [(name, s, ce, eb, xb, off) for name, _, (s, ce, eb, xb, off) in mine]
        flat = [np.concatenate([c[k] for c in chains]) for k in (2, 3, 4)]
        sizes = np.concatenate([np.diff(c[5]) for c in chains])
        bounds = torch.from_numpy(np.cumsum(np.concatenate([[0], sizes])).astype(np.int64))
        states = gene_viterbi_plain(*(torch.from_numpy(a) for a in flat), bounds,
                                    indel=p.indel, ins_extend=p.ins_extend).numpy()
        j = 0
        for name, strands, ce, eb, xb, off in chains:
            pairs = []
            for lo, hi in zip(off[:-1], off[1:]):
                want = np.asarray(_viterbi_states(ce[lo:hi], eb[lo:hi], xb[lo:hi],
                                                  indel=p.indel, ins_extend=p.ins_extend))
                pairs.append((states[bounds[j]: bounds[j + 1]], want))
                j += 1
            out[name] = pairs
    return out


CASES = [*PANELS, *TRUNCATED, "long", *(f"{name}_unpadded" for name in TRUNCATED)]


@pytest.mark.parametrize("case", CASES)
def test_viterbi_states_equal_jax(decoded, case):
    for got, want in decoded[case]:
        assert got.dtype == np.int8 and want.dtype == np.int8
        np.testing.assert_array_equal(got, want)
    assert any((got != 0).any() for got, _ in decoded[case])  # some strand decodes a gene


def test_mixed_batch_holds_several_padded_lengths(decoded):
    lengths = {len(got) for pairs in decoded.values() for got, _ in pairs}
    assert {4096, 16384} <= lengths and len(lengths) > 4


def _as_tuples(orfs):
    return [(int(o.start), int(o.end), int(o.strand), bytes(o.translation)) for o in orfs]


@pytest.fixture(scope="module")
def port_calls(params):
    """``find_genes_hmm_batch`` on every panel contig at once (both strands of all in one decode)."""
    from kaptive_tpu_torch.bgc.genefinder import find_genes_hmm_batch

    return dict(zip(PANELS, find_genes_hmm_batch(list(PANELS.values()), params[0], 50, device="cpu")))


@pytest.mark.parametrize("case", list(PANELS))
def test_find_genes_hmm_equals_jax(params, port_calls, case):
    from kaptive_tpu.bgc.genefinder import find_genes_hmm as jax_find

    want = _as_tuples(jax_find(PANELS[case], params[1], min_codons=50))
    assert want
    assert _as_tuples(port_calls[case]) == want


def test_find_genes_hmm_one_contig_and_uniform_params(params):
    from kaptive_tpu.bgc.genefinder import find_genes_hmm as jax_find

    from kaptive_tpu_torch.bgc.genefinder import GeneHmmParams, find_genes_hmm

    seq = PANELS["clean+1"]
    assert _as_tuples(find_genes_hmm(seq, params[0], min_codons=50, device="cpu")) == \
        _as_tuples(jax_find(seq, params[1], min_codons=50))
    got = find_genes_hmm(seq, GeneHmmParams.uniform(), min_codons=50, device="cpu")
    assert got and _as_tuples(got) == _as_tuples(jax_find(seq, None, min_codons=50))


@pytest.mark.parametrize("case", list(TRUNCATED))
def test_strand_genes_keep_truncated_genes_and_equal_jax(case):
    """The pad's free continuation: padded == unpadded on the port's side, == the JAX side."""
    from kaptive_tpu.bgc import genefinder as jax_gf

    from kaptive_tpu_torch.bgc import genefinder as gf
    from kaptive_tpu_torch.ops import minimizer

    port_p, jax_p = _uniform()
    codes = gf._DNA_LUT[np.frombuffer(TRUNCATED[case], np.uint8)]
    padded = gf._strand_genes(codes, port_p, min_codons=20, device="cpu")
    with mock.patch.object(minimizer, "bucket_length", lambda n, minimum=0: n):
        unpadded = gf._strand_genes(codes, port_p, min_codons=20, device="cpu")
    assert padded and padded == unpadded
    assert padded == jax_gf._strand_genes(codes, jax_p, min_codons=20)


def test_empty_and_short():
    from kaptive_tpu_torch.bgc.genefinder import find_genes_hmm, find_genes_hmm_batch

    assert find_genes_hmm(b"", device="cpu") == []
    assert find_genes_hmm(b"ATGAAATAA", device="cpu") == []
    assert find_genes_hmm_batch([b"", b"AT", b"ATGAAATAA"], device="cpu") == [[], [], []]


def test_find_genes_hmm_defaults_to_cuda():
    """The default device is CUDA: without a card the call raises, never falls back."""
    from kaptive_tpu_torch.bgc.genefinder import find_genes_hmm

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        find_genes_hmm(PANELS["clean+1"])


@pytest.mark.parametrize("offsets", [[0, 40, 90], [0, 40, 120], [0, 60, 40, 100], [10, 40, 100]],
                         ids=["short", "past_end", "decreasing", "not_from_zero"])
def test_plain_viterbi_forms_refuse_bad_offsets(offsets):
    """Offsets must run from 0 to the inputs' rows without decreasing, as the kernels' wrappers check."""
    from kaptive_tpu_torch.ops.viterbi import arch_viterbi_plain, gene_viterbi_plain

    x = torch.zeros(100, dtype=torch.float32)
    off = torch.tensor(offsets, dtype=torch.int64)
    with pytest.raises(ValueError, match="offsets"):
        gene_viterbi_plain(x, x, x, off, indel=-8.0, ins_extend=-2.0)
    with pytest.raises(ValueError, match="offsets"):
        arch_viterbi_plain(torch.zeros((100, 8)), torch.zeros((8, 8)), off)
