r"""The generator: the same seed gives the same inputs; the families keep their identities and ORFs."""

from __future__ import annotations

import numpy as np
from conftest import TINY_CONFIG, TINY_TRAFFIC

from kbench import gen


def _make(seed: int):
    rng_db, rng_pool, _ = gen.seed_streams(seed, 3)
    db = gen.make_database(TINY_CONFIG, rng_db)
    pool = gen.make_pool(TINY_TRAFFIC["tiny_stream"], db, TINY_CONFIG["genome_nt"], rng_pool)
    return db, pool


def test_same_seed_same_inputs_and_other_seed_other_inputs():
    a_db, a_pool = _make(2**31 + 5)
    b_db, b_pool = _make(2**31 + 5)
    c_db, c_pool = _make(2**31 + 6)
    assert a_db.genbank == b_db.genbank and a_db.toml == b_db.toml
    assert [x.fasta for x in a_pool] == [x.fasta for x in b_pool]
    assert a_db.genbank != c_db.genbank
    assert [x.fasta for x in a_pool] != [x.fasta for x in c_pool]


def test_every_seed_types_the_same_sizes():
    sizes = [sorted((x.kind, len(x.contig_starts) - 1, len(x.genome)) for x in _make(s)[1]) for s in (1, 2)]
    assert sizes[0] == sizes[1]


def _codons(orf: bytes) -> list[bytes]:
    return [orf[i : i + 3] for i in range(0, len(orf), 3)]


def test_family_members_keep_their_identity_and_stay_open_reading_frames():
    db, _ = _make(11)
    lo, hi = TINY_CONFIG["family_identity"]
    fams = TINY_CONFIG["families_5p"] + TINY_CONFIG["families_3p"]
    for locus in db.loci:
        assert [g.cluster for g in locus.genes[: 2]] == TINY_CONFIG["families_5p"]
        assert locus.genes[-1].cluster == TINY_CONFIG["families_3p"][0]
        for g in locus.genes:
            codons = _codons(g.orf)
            assert codons[0] == b"ATG" and codons[-1] == b"TAA" and len(g.orf) % 3 == 0
            assert not {b"TAA", b"TAG", b"TGA"} & set(codons[1:-1])
            assert TINY_CONFIG["gene_nt"][0] - 2 <= len(g.orf) <= TINY_CONFIG["gene_nt"][1]
            if g.cluster in fams:
                root = db.roots[g.cluster]
                same = np.mean(np.frombuffer(root, np.uint8) == np.frombuffer(g.orf, np.uint8))
                # Codons put back after a stop only raise the identity, by a few bases at most.
                assert lo - 1e-9 <= same <= hi + 10 / len(root)


def test_genbank_locus_placement_matches_the_truth():
    db, pool = _make(3)
    asm = pool[0]
    text = gen.BASES[asm.genome].tobytes()
    planted = text[asm.locus_start : asm.locus_start + len(asm.locus.seq)]
    diff = np.frombuffer(planted, np.uint8) != gen.BASES[asm.locus.seq]
    rate = {"clean": 0, "fragmented": 0, "diverged": 0.01, "draft": 0.005}[asm.kind]
    assert diff.mean() <= 3 * rate + 1e-9
    fasta_seq = b"".join(line for line in asm.fasta.split(b"\n") if line and not line.startswith(b">"))
    assert fasta_seq == text
