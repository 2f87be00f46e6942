"""Inputs for the two Viterbi decodes, built with the port alone (no JAX).

``gene_panels`` builds the contigs of ``tests/test_genefinder.py``'s panels
from one seed: clean biased-codon genes on both strands, genes with 1 and 2
single-base indels on both strands, adjacent genes, and the five
end-truncation cases and the interior case of its padding test.
``gene_chains`` turns contigs into the gene decode's flat inputs, both
strands each, padded as the gene finder pads them; ``arch_panel`` draws
seeded emission and transition matrices for the architectural decode, and
``arch_tie_panel`` the same with many ties and ``-inf`` entries.
"""

import numpy as np
from synthetic import make_biased_orf, make_orf, random_dna, revcomp

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _indels(rng, orf: bytes, n: int) -> bytes:
    seq = bytearray(orf)
    for _ in range(n):
        pos = int(rng.integers(60, len(seq) - 60))
        if rng.random() < 0.5:
            seq.insert(pos, ord("ACGT"[rng.integers(0, 4)]))
        else:
            del seq[pos]
    return bytes(seq)


def _plant(rng, gene: bytes, strand: int, flank: int = 400) -> bytes:
    return random_dna(rng, flank) + (gene if strand == 1 else revcomp(gene)) + random_dna(rng, flank)


def gene_training_set(seed: int = 42) -> list[bytes]:
    """The biased-codon genes the panels' emissions are learned from."""
    rng = np.random.default_rng(seed)
    return [make_biased_orf(rng, 200) for _ in range(30)]


def gene_panels(seed: int = 42) -> dict[str, bytes]:
    """``{case name: contig}`` for the gene finder's panels (biased-codon emissions)."""
    rng = np.random.default_rng(seed + 1)
    panels = {}
    for strand in (1, -1):
        panels[f"clean{strand:+d}"] = _plant(rng, make_biased_orf(rng, 200), strand)
        for n in (1, 2):
            for t in range(2):
                panels[f"indel{n}{strand:+d}_{t}"] = _plant(rng, _indels(rng, make_biased_orf(rng, 220), n), strand)
    gene = bytearray(make_biased_orf(rng, 220))
    del gene[330]
    panels["deletion_mid_gene"] = _plant(rng, bytes(gene), 1)
    panels["adjacent"] = (random_dna(rng, 300) + make_biased_orf(rng, 150) + random_dna(rng, 120)
                          + make_biased_orf(rng, 150) + random_dna(rng, 300))
    return panels


def truncation_panels(seed: int = 0) -> dict[str, bytes]:
    """The padding test's contigs: genes cut by the contig end at 0, 1, 2, 10 and 40
    bases before their stop, and an interior gene (uniform emissions, coding bonus 0.40)."""
    rng = np.random.default_rng(seed)
    panels = {}
    for cut in (0, 1, 2, 10, 40):
        orf = make_orf(rng, 40)
        panels[f"cut{cut}"] = BASES[rng.integers(0, 4, 200)].tobytes() + orf[: len(orf) - 3 - cut]
    panels["interior"] = (BASES[rng.integers(0, 4, 150)].tobytes() + make_orf(rng, 50)
                          + BASES[rng.integers(0, 4, 150)].tobytes())
    return panels


def gene_chains(contigs: list[bytes], params):
    """Both strands of each contig as the gene decode's inputs: ``(strands, codemit,
    entry_b, exit_b, offsets)`` numpy arrays, each strand padded as the gene finder pads it."""
    from kaptive_tpu_torch.bgc.genefinder import _both_strands, _strand_inputs

    strands = [_strand_inputs(codes, params) for seq in contigs for codes in _both_strands(seq)]
    offsets = np.cumsum([0] + [len(s.codemit) for s in strands]).astype(np.int64)
    flat = [np.concatenate([getattr(s, f) for s in strands]) for f in ("codemit", "entry_b", "exit_b")]
    return strands, *flat, offsets


def arch_panel(rng, n_rows: list[int], n_states: int):
    """Seeded emissions of contigs of ``n_rows`` rows, laid end to end, and a
    transition matrix with an absorbing last state, as the trainer makes them:
    ``(emissions (sum N, S), transitions (S, S), offsets)`` float32 / int64."""
    em = rng.normal(0.0, 2.0, (sum(n_rows), n_states)).astype(np.float32)
    em[rng.random(em.shape) < 0.05] = 0.0  # ties, as the edge neutralisation makes
    counts = rng.random((n_states, n_states)) + 0.1
    trans = np.log(counts / counts.sum(axis=1, keepdims=True)).astype(np.float32)
    trans[-1, :], trans[-1, -1] = -np.inf, 0.0
    return em, trans, np.cumsum([0] + list(n_rows)).astype(np.int64)


def arch_tie_panel(rng, n_rows: list[int], n_states: int):
    """``arch_panel`` with heavier ties: rounded emissions, repeated and ``-inf`` transitions,
    ``-inf`` emissions."""
    em, trans, offsets = arch_panel(rng, n_rows, n_states)
    em = np.round(em).astype(np.float32)
    em[rng.random(em.shape) < 0.03] = -np.inf
    trans = np.where(rng.random(trans.shape) < 0.5, np.float32(-1.0), np.round(trans)).astype(np.float32)
    trans[rng.random(trans.shape) < 0.2] = -np.inf
    trans[-1, :], trans[-1, -1] = -np.inf, 0.0
    return em, trans, offsets


def arch_chain_reference(emissions, transitions, offsets):
    """The architectural decode with each state's pick as one strict chain over its predecessors
    p = 0 .. S-1 (the first candidate taken whatever it is, a later one only when strictly
    greater): ``(paths, scores)``.  It equals the plain form wherever no candidate is NaN, and
    says what a NaN does: kept when it is the first candidate, skipped elsewhere."""
    S = transitions.shape[0]
    paths = np.empty(int(offsets[-1]), np.int32)
    scores = np.empty(len(offsets) - 1, np.float32)
    for c, (lo, hi) in enumerate(zip(offsets[:-1], offsets[1:])):
        rows = emissions[lo:hi]
        cur = transitions[0] + rows[0]
        back = np.zeros((len(rows), S), np.int64)
        for i in range(1, len(rows)):
            cand = cur[:, None] + transitions  # (p, s)
            best, arg = cand[0].copy(), np.zeros(S, np.int64)
            for p in range(1, S):
                take = cand[p] > best
                best[take], arg[take] = cand[p][take], p
            back[i] = arg
            cur = best + rows[i]
        scores[c] = cur[S - 1]
        state = S - 1
        paths[hi - 1] = state
        for i in range(len(rows) - 1, 0, -1):
            state = back[i, state]
            paths[lo + i - 1] = state
    return paths, scores
