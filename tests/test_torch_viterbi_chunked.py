"""Numpy models of the Hopper Viterbi kernels' algorithms (``csrc/viterbi.cu``), on the CPU.

The card runs what the models here run, in the same order of float32
operations; a CUDA kernel cannot run here, so its algorithm is held to the
references in numpy:

- the gene decode in chunks (``gene_forward_kernel`` and the kernels after
  it): every strand cut into chunks of ``C`` positions; a chunk other than a
  strand's first starts from a guess, the forward run over the ``W``
  positions before it from the HMM's start vector, without backpointers; all
  chunks run at once; a check compares, bit for bit, each chunk's start
  vector with the end vector of the chunk before it, and fix-up rounds re-run
  every chunk that differs from that end vector until none differs; a run of
  one repeated input (a pad tail) is filled from a three-step pattern.  The
  backtrace composes maps: each chunk walks its backpointers from all seven
  end states (a map from its end state to the state before it), one pass
  over a strand's chunks from the last gives every chunk its end state, and
  each chunk walks once more from it.  Held to the JAX package's
  ``_viterbi_states`` and to ``gene_viterbi_plain`` on the gene panels at
  C = 64 and W = 0, 16, 256 (W = 0 forces fix-ups), with strand lengths that
  are not a multiple of C, down to 1 step;
- the architectural decode's pick (``arch_viterbi_kernel``): the candidates
  ``prev[p] + T[p, s]`` reduced by a tree over (value, index) blocks of 32
  that keeps the lower index on a tie, the blocks taken in order with a strict
  ``>``.  Held to ``arch_viterbi_plain`` (and the JAX
  ``architectural_viterbi``) with ties, ``-inf`` transitions and ``-inf``
  emissions, at S = 1 to 256.

Tolerance: exact (states, paths and scores equal).
"""

from unittest import mock

import numpy as np
import pytest
import torch
from viterbi_panels import (
    arch_panel, arch_tie_panel, gene_chains, gene_panels, gene_training_set, truncation_panels,
)

torch.set_num_threads(1)  # the plain decodes issue many tiny ops

NEG = np.float32(-1.0e9)
N_STATES = 7
CHUNK = 64  # the model's chunk length: tiny, so every panel strand has many chunks


def _gene_step(v, ce, eb, xb, indel, ins_extend):
    """One forward step of the gene HMM for a batch of vectors ``v`` (n, 7): the new
    vectors and the packed backpointer words (seven 3-bit sources), as the kernel packs them."""
    vN, vC0, vC1, vC2, vI0, vI1, vI2 = v.T

    def pick(cands, srcs):
        stacked = np.stack(cands)
        arg = np.argmax(stacked, axis=0)  # the first of equal candidates
        return np.take_along_axis(stacked, arg[None], 0)[0], np.asarray(srcs, np.uint32)[arg]

    nN, bN = pick([vN, vC2 + xb], (0, 3))
    n0, b0 = pick([vN + eb, vC2, vC1 + indel, vI2], (0, 3, 2, 6))
    n1, b1 = pick([vC0, vC2 + indel, vI0], (1, 3, 4))
    n2, b2 = pick([vC1, vC0 + indel, vI1], (2, 1, 5))
    n2 = n2 + ce
    n4, b4 = pick([vC0 + indel, vI0 + ins_extend], (1, 4))
    n5, b5 = pick([vC1 + indel, vI1 + ins_extend], (2, 5))
    n6, b6 = pick([vC2 + indel, vI2 + ins_extend], (3, 6))
    new = np.maximum(np.stack([nN, n0, n1, n2, n4, n5, n6], axis=1), NEG)
    new = new - new.max(axis=1, keepdims=True)
    words = bN | b0 << 3 | b1 << 6 | b2 << 9 | b4 << 12 | b5 << 15 | b6 << 18
    return new.astype(np.float32), words


def _v0(n):
    v = np.full((n, N_STATES), NEG, np.float32)
    v[:, 0] = 0.0
    return v


def chunked_gene_decode(codemit, entry_b, exit_b, offsets, *, indel, ins_extend, chunk, warmup):
    """The kernels' chunked decode of chains laid end to end; returns ``(states, stats)`` with
    ``stats = {"chunks", "rounds", "reruns", "filled"}``."""
    indel, ins_extend = np.float32(indel), np.float32(ins_extend)
    total = len(codemit)
    starts, ends, bases, chain_chunks = [], [], [], [0]
    for lo, hi in zip(offsets[:-1], offsets[1:]):
        for s in range(lo, hi, chunk):
            starts.append(s)
            ends.append(min(s + chunk, hi))
            bases.append(lo)
        chain_chunks.append(len(starts))
    starts, ends, bases = (np.asarray(a, np.int64) for a in (starts, ends, bases))
    n = len(starts)
    back = np.zeros(total, np.uint32)
    vin, vout = _v0(n), _v0(n)

    def forward(ids, v, w):
        """Chunks ``ids`` in lockstep from relative step -w (warm-up, no backpointers) to the
        chunk's end; a chunk holds its vector where it has no position (before its strand,
        past its end).  Returns the vectors at step 0 and at the end."""
        s, e, lo = starts[ids], ends[ids], np.maximum(bases[ids], starts[ids] - w)
        start = v.copy()
        for r in range(-w, chunk):
            if r == 0:
                start = v.copy()
            p = s + r
            live = (p >= lo) & (p < e)
            if not live.any():
                continue
            q = np.clip(p, 0, max(total - 1, 0))
            new, words = _gene_step(v, codemit[q], entry_b[q], exit_b[q], indel, ins_extend)
            v = np.where(live[:, None], new, v)
            body = live & (r >= 0)
            back[p[body]] = words[body]
        return start, v

    vin[:], vout[:] = forward(np.arange(n), _v0(n), warmup)
    # A chunk of one repeated input (a strand's pad tail): its value, bit for bit.
    inputs = np.stack([codemit, entry_b, exit_b], axis=1).view(np.uint32)
    cval = inputs[starts] if n else np.zeros((0, 3), np.uint32)
    constant = np.array([(inputs[s:e] == inputs[s]).all() for s, e in zip(starts, ends)], dtype=bool)
    rounds = reruns = filled = 0
    has_pred = starts != bases
    while True:
        pred = np.flatnonzero(has_pred)
        differs = (vin[pred].view(np.uint32) != vout[pred - 1].view(np.uint32)).any(axis=1)
        dirty = pred[differs]
        if len(dirty) == 0:
            break
        vin[dirty] = vout[dirty - 1]  # every start read before any chunk re-runs
        _, vout[dirty] = forward(dirty, vin[dirty], 0)
        rounds += 1
        reruns += len(dirty)
        assert rounds <= n  # the first chunk of a strand is exact, so each round fixes one more
        # The first differing chunk k0 of each strand started exactly, so it ends exactly now.  A
        # chunk k (k0, else k0 + 1) of one repeated input whose start is thus exact: if three
        # steps bring that start back, the steps repeat for as long as the input does.
        for c in range(len(chain_chunks) - 1):
            k0 = dirty[(dirty >= chain_chunks[c]) & (dirty < chain_chunks[c + 1])].min(initial=n)
            k = n
            for cand in (k0, k0 + 1):
                if k < n or cand >= chain_chunks[c + 1] or not constant[cand]:
                    continue
                x, pattern, words = vout[cand - 1: cand], [], []
                for _ in range(3):
                    x, w = _gene_step(x, *cval[cand].view(np.float32)[:, None], indel, ins_extend)
                    pattern.append(x[0])
                    words.append(w[0])
                if (pattern[2].view(np.uint32) == vout[cand - 1].view(np.uint32)).all():
                    k = cand
            if k == n:
                continue
            m = k
            while m + 1 < chain_chunks[c + 1] and constant[m + 1] and (cval[m + 1] == cval[k]).all():
                m += 1
            pos = np.arange(starts[k], ends[m])
            back[pos] = np.asarray(words)[(pos - starts[k]) % 3]
            for j in range(k, m + 1):
                vout[j] = pattern[(ends[j] - 1 - starts[k]) % 3]
                vin[j] = pattern[(starts[j] - 1 - starts[k]) % 3]
            filled += int(m - k + 1)

    def field(words, x):
        return ((words >> (3 * x).astype(np.uint32)) & 7).astype(np.int64)

    # Maps: each chunk walked back from all seven end states at once.
    traj = np.tile(np.arange(N_STATES), (n, 1))
    for r in range(chunk - 1, -1, -1):
        p = starts + r
        live = p < ends
        traj = np.where(live[:, None], field(back[np.minimum(p, total - 1)][:, None], traj), traj)
    # The serial pass over each strand's chunks, from the last (the first argmax of its end vector).
    x_end = np.zeros(n, np.int64)
    for c in range(len(chain_chunks) - 1):
        first, last = chain_chunks[c], chain_chunks[c + 1] - 1
        if last < first:
            continue
        x = int(np.argmax(vout[last]))
        for k in range(last, first - 1, -1):
            x_end[k] = x
            x = int(traj[k, x])
    # The final walk of every chunk from its end state.
    states = np.zeros(total, np.int8)
    x = x_end.copy()
    for r in range(chunk - 1, -1, -1):
        p = starts + r
        live = p < ends
        states[p[live]] = x[live]
        x = np.where(live, field(back[np.minimum(p, total - 1)], x), x)
    return states, {"chunks": n, "rounds": rounds, "reruns": reruns, "filled": filled}


@pytest.fixture(scope="module")
def gene_batches():
    """Two batches (learned and uniform emissions), each ``(arrays, params, JAX states)``:
    every panel contig's strands padded as the gene finder pads them, plus unpadded
    truncation strands, odd lengths and 1- to 3-step strands."""
    from kaptive_tpu.bgc.genefinder import _viterbi_states

    from kaptive_tpu_torch.bgc.genefinder import GeneHmmParams
    from kaptive_tpu_torch.core.seq import Sequences
    from kaptive_tpu_torch.ops import minimizer
    from synthetic import random_dna

    learned = GeneHmmParams.from_sequences(Sequences.from_bytes(gene_training_set()))
    uniform = GeneHmmParams.uniform(coding_bonus=0.40)
    rng = np.random.default_rng(11)
    batches = []
    panels = list(gene_panels().values())
    long_contig = b"".join(panels)[:9000]  # padded to 16 Ki positions
    for params, padded in ((learned, [*panels, long_contig]), (uniform, list(truncation_panels().values()))):
        chains = [gene_chains(padded, params)]
        with mock.patch.object(minimizer, "bucket_length", lambda n, minimum=0: n):
            chains.append(gene_chains([*truncation_panels().values(), random_dna(rng, 129), random_dna(rng, 1000)],
                                      params))
        # Strands of 1, 2 and 3 steps: the gene finder decodes none so short, the kernels take them.
        spans = [(700, 701), (1500, 1502), (4100, 4103), (0, 1)]
        chains.append((None, *(np.concatenate([chains[0][k][lo:hi] for lo, hi in spans]) for k in (1, 2, 3)),
                       np.cumsum([0] + [hi - lo for lo, hi in spans])))
        flat = [np.concatenate([c[k] for c in chains]) for k in (1, 2, 3)]
        sizes = np.concatenate([np.diff(c[4]) for c in chains])
        offsets = np.cumsum(np.concatenate([[0], sizes])).astype(np.int64)
        want = np.concatenate([np.asarray(_viterbi_states(*(a[lo:hi] for a in flat), indel=params.indel,
                                                          ins_extend=params.ins_extend))
                               for lo, hi in zip(offsets[:-1], offsets[1:])])
        batches.append((flat, offsets, params, want))
    return batches


def test_gene_batches_cover_ragged_chunks(gene_batches):
    sizes = np.concatenate([np.diff(off) for _, off, _, _ in gene_batches])
    assert {1, 2, 3} <= set(sizes.tolist()) and (sizes % CHUNK != 0).sum() > 5 and sizes.max() >= 16384


@pytest.mark.parametrize("warmup", [0, 16, 256])
def test_chunked_gene_decode_equals_jax_and_plain(gene_batches, warmup):
    from kaptive_tpu_torch.ops.viterbi import gene_viterbi_plain

    reruns = 0
    for flat, offsets, params, want in gene_batches:
        got, stats = chunked_gene_decode(*flat, offsets, indel=params.indel, ins_extend=params.ins_extend,
                                         chunk=CHUNK, warmup=warmup)
        plain = gene_viterbi_plain(*(torch.from_numpy(a) for a in flat), torch.from_numpy(offsets),
                                   indel=params.indel, ins_extend=params.ins_extend).numpy()
        np.testing.assert_array_equal(plain, want)
        np.testing.assert_array_equal(got, want)
        assert stats["chunks"] == int(sum(-(-int(n) // CHUNK) for n in np.diff(offsets)))
        assert stats["filled"] > 0  # the pad tails
        reruns += stats["reruns"]
        if warmup == 0:
            assert stats["rounds"] > 0 and stats["reruns"] > 0
    if warmup == 256:  # a warm-up of four chunks' length leaves few chunks to re-run
        assert reruns < sum(-(-int(n) // CHUNK) for _, off, _, _ in gene_batches for n in np.diff(off)) // 10


def test_chunked_gene_decode_converges_on_random_dna():
    """A 20 kb random contig, both strands (padded to 32 Ki), uniform emissions (dense with
    stop-free runs): warm-ups of 256 positions guess most chunk starts bit for bit; W = 0 needs
    fix-ups; the pad tails are filled from their three-step pattern."""
    from synthetic import random_dna

    from kaptive_tpu_torch.bgc.genefinder import GeneHmmParams
    from kaptive_tpu_torch.ops.viterbi import gene_viterbi_plain

    params = GeneHmmParams.uniform()
    _, *flat, offsets = gene_chains([random_dna(np.random.default_rng(5), 20000)], params)
    plain = gene_viterbi_plain(*(torch.from_numpy(a) for a in flat), torch.from_numpy(offsets),
                               indel=params.indel, ins_extend=params.ins_extend).numpy()
    for warmup in (0, 256):
        got, stats = chunked_gene_decode(*flat, offsets, indel=params.indel, ins_extend=params.ins_extend,
                                         chunk=256, warmup=warmup)
        np.testing.assert_array_equal(got, plain)
        # The pad tails (~50 chunks a strand) take one fill, not a round a chunk.
        assert stats["filled"] > 0 and stats["rounds"] < 10
        if warmup == 0:
            assert stats["reruns"] > 0
        else:
            assert stats["reruns"] < stats["chunks"] // 2


# --- the architectural decode's pick ------------------------------------------------------------


def tree_pick(cands):
    """``(best, arg)`` over the last axis of ``cands`` (..., S) as the kernel picks: blocks of 32
    candidates (the last padded with -inf), each reduced by a tree over (value, index) pairs of
    neighbours that keeps the left (lower index) unless the right is strictly greater; the
    blocks taken in order, a later one only when strictly greater."""
    S = cands.shape[-1]
    best = arg = None
    for b0 in range(0, S, 32):
        vals = np.full((*cands.shape[:-1], 32), -np.inf, np.float32)
        vals[..., : min(32, S - b0)] = cands[..., b0: b0 + 32]
        idx = np.broadcast_to(np.arange(b0, b0 + 32), vals.shape)
        while vals.shape[-1] > 1:
            left, right = vals[..., 0::2], vals[..., 1::2]
            take = right > left
            vals, idx = np.where(take, right, left), np.where(take, idx[..., 1::2], idx[..., 0::2])
        vals, idx = vals[..., 0], idx[..., 0]
        if best is None:
            best, arg = vals, idx
        else:
            take = vals > best
            best, arg = np.where(take, vals, best), np.where(take, idx, arg)
    return best, arg


def tree_arch_decode(emissions, transitions, offsets):
    """The architectural decode with :func:`tree_pick`: ``(paths, scores)``."""
    S = transitions.shape[0]
    paths = np.empty(int(offsets[-1]), np.int32)
    scores = np.empty(len(offsets) - 1, np.float32)
    for c, (lo, hi) in enumerate(zip(offsets[:-1], offsets[1:])):
        rows = emissions[lo:hi]
        cur = transitions[0] + rows[0]
        back = np.zeros((len(rows), S), np.int64)
        for i in range(1, len(rows)):
            best, back[i] = tree_pick((cur[:, None] + transitions).T)
            cur = best + rows[i]
        scores[c] = cur[S - 1]
        state = S - 1
        paths[hi - 1] = state
        for i in range(len(rows) - 1, 0, -1):
            state = back[i, state]
            paths[lo + i - 1] = state
    return paths, scores


@pytest.mark.parametrize("S", [1, 2, 28, 32, 33, 64, 256])
def test_tree_pick_equals_plain_arch_decode(S):
    from kaptive_tpu_torch.ops.viterbi import arch_viterbi_plain

    rng = np.random.default_rng(S)
    n_rows = [1, 2, 3, 40] if S > 64 else [1, 2, 3, 17, 150]
    for make in (arch_panel, arch_tie_panel):
        em, trans, offsets = make(rng, n_rows, S)
        got_p, got_s = tree_arch_decode(em, trans, offsets)
        want_p, want_s = arch_viterbi_plain(*(torch.from_numpy(a) for a in (em, trans, offsets)))
        np.testing.assert_array_equal(got_p, want_p.numpy())
        np.testing.assert_array_equal(got_s, want_s.numpy())
        assert np.isneginf(trans).any() or S == 1


def test_tree_pick_equals_jax_arch_decode_with_ties():
    from kaptive_tpu.bgc.kernels import architectural_viterbi

    for S in (28, 33):
        em, trans, offsets = arch_tie_panel(np.random.default_rng(100 + S), [60, 5], S)
        got_p, got_s = tree_arch_decode(em, trans, offsets)
        for c, (lo, hi) in enumerate(zip(offsets[:-1], offsets[1:])):
            want_p, want_s = architectural_viterbi(em[lo:hi], trans)
            np.testing.assert_array_equal(got_p[lo:hi], np.asarray(want_p))
            assert got_s[c] == np.float32(want_s)


def test_tree_pick_keeps_the_lower_index_on_a_tie():
    cands = np.array([[1, 3, 3, 2], [-np.inf] * 4, [5, 5, 5, 5]], np.float32)
    best, arg = tree_pick(cands)
    assert arg.tolist() == [1, 0, 0] and best[0] == 3
    wide = np.full((1, 70), -np.inf, np.float32)
    wide[0, [33, 40, 65]] = 7.0
    assert tree_pick(wide)[1].tolist() == [33]
