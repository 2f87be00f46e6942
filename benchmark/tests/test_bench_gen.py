r"""The generator: the same seed gives the same inputs; the families keep their identities and ORFs; the
committed cells' inputs are as pinned; a roster, extra genes, rules and knockouts are made as stated."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest
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


# sha256 of each configuration's database texts, of its pool's FASTA (the digest of each
# assembly's, in pool order) and its checked sample, at one seed, as the generator made them
# before configurations could state a roster, extra genes or rules.
PINNED_SEED = 2**31 + 20
PINNED = {
    ("kpsc_k", "mix4_single"): (
        "4c19b494db7aa229a7a2907362f31c897d2c85b4174f78343c29e598cfe45d8f",
        "54bd1c575b467d243a7ce543fce202101c804d33cea641ee2fa086b0ec473957",
        "acee043106e205d959daa9599eb5f280d0369a311578042473dabfab8f87e8db",
        [0, 2, 7, 10, 17, 26, 43, 44],
    ),
    ("ab_k", "drafts_single"): (
        "e188d0fc86cddf192bb3777fcd63e768de1dd0b95a376411f18edbdd32577503",
        "68fe722aecfc489d1ca3f6ce4b3534b6a6829f3f3a0586760dc8154f0b5fd890",
        "3ee2dcff3149ed709aba0216a3dc8147ff19b7a83e59e6385142789c62ffabf0",
        [0, 7, 9, 10, 26, 43, 44],
    ),
}


@pytest.mark.parametrize("config, traffic", list(PINNED), ids=[c for c, _ in PINNED])
def test_the_committed_cells_inputs_are_as_pinned(config, traffic):
    from conftest import BENCH

    from kbench.harness import _sample
    from reference.phenotype import expected_phenotypes

    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    mix = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    rng_db, rng_pool, rng_sample = gen.seed_streams(PINNED_SEED, 3)
    db = gen.make_database(cfg, rng_db)
    pool = gen.make_pool(mix, db, cfg["genome_nt"], rng_pool)
    digest = hashlib.sha256(b"".join(hashlib.sha256(a.fasta).digest() for a in pool)).hexdigest()
    sample = sorted(_sample(pool, mix, rng_sample, expected_phenotypes(pool, db, cfg)))
    got = (hashlib.sha256(db.genbank.encode()).hexdigest(), hashlib.sha256(db.toml.encode()).hexdigest(), digest, sample)
    assert got == PINNED[config, traffic]
    assert not db.extra and all(not a.extras and a.knocked is None for a in pool)


def _make_o(seed: int):
    from conftest import TINY_O_CONFIG, TINY_O_TRAFFIC

    rng_db, rng_pool, _ = gen.seed_streams(seed, 3)
    db = gen.make_database(TINY_O_CONFIG, rng_db)
    return db, gen.make_pool(TINY_O_TRAFFIC, db, TINY_O_CONFIG["genome_nt"], rng_pool)


def test_a_roster_draws_its_families_from_one_root_each():
    from conftest import TINY_O_CONFIG

    db, _ = _make_o(5)
    roster = TINY_O_CONFIG["loci"]
    assert [(x.name, x.serotype, [g.cluster for g in x.genes]) for x in db.loci] == [
        (e["name"], e["type"], e["genes"]) for e in roster
    ]
    shared = {c for c in ("wzm", "wzt", "wbbM", "glf", "wbbN", "wbbO")}
    assert set(db.roots) == shared  # a cluster of one locus is that locus's own ORF
    for locus in db.loci:
        assert [g.gene_id for g in locus.genes] == [f"{locus.name}_{i + 1:02}_{g.cluster}" for i, g in enumerate(locus.genes)]
        assert [g.strand for g in locus.genes] == [1 if i % 2 == 0 else -1 for i in range(len(locus.genes))]
        for g in locus.genes:
            if g.cluster in db.roots:
                root = db.roots[g.cluster]
                lo, hi = TINY_O_CONFIG["cluster_identity"].get(g.cluster, TINY_O_CONFIG["family_identity"])
                same = np.mean(np.frombuffer(root, np.uint8) == np.frombuffer(g.orf, np.uint8))
                assert lo - 1e-9 <= same <= hi + 10 / len(root)


def test_extra_genes_rules_and_strings_are_written_for_the_program():
    import tomllib

    from conftest import TINY_O_CONFIG

    db, _ = _make_o(5)
    meta = tomllib.loads(db.toml)
    assert meta["phenotype_logic"] == TINY_O_CONFIG["phenotype_logic"]
    assert list(meta["phenotype_logic"]) == list(TINY_O_CONFIG["phenotype_logic"])  # the order decides ties
    assert (meta["antigen"], meta["pathway"]) == (TINY_O_CONFIG["antigen"], TINY_O_CONFIG["pathway"])
    assert [(g.gene_id, len(g.orf)) for g in db.extra] == [(e["cluster"], e["nt"]) for e in TINY_O_CONFIG["extra_genes"]]
    assert [g.gene_id for g in db.extra] == [g.gene_id for g in gen.gene_table(db).values()][-len(db.extra):]
    for g in db.extra:
        assert f'/note="Extra genes: {g.cluster}"' in db.genbank
    # Without the keys the TOML is a capsule's, with no rules.
    k = tomllib.loads(gen.make_database(TINY_CONFIG, gen.seed_streams(5, 1)[0]).toml)
    assert k["antigen"] == "Capsular polysaccharide" and "phenotype_logic" not in k


def test_extra_sets_and_knockouts_are_planted_as_the_mix_says():
    from conftest import O_MIX, TINY_O_CONFIG

    db, pool = _make_o(9)
    for kind in O_MIX:
        mine = [a for a in pool if a.kind == kind["name"]]
        assert sum(bool(a.extras) for a in mine) == round(kind["extra_sets"][0]["share"] * len(mine))
        assert sum(a.knocked is not None for a in mine) == round(kind["knockout"]["share"] * len(mine))
    for asm in pool:
        text = gen.BASES[asm.genome].tobytes()
        lo, hi = asm.locus_start, asm.locus_start + len(asm.locus.seq)
        flank = (lo + len(asm.genome) - hi) // 4
        spans = sorted((g.start, g.end) for g in asm.extras)
        assert all(b + gen.EXTRA_GAP <= c for (_, b), (c, _) in zip(spans, spans[1:]))
        for g in asm.extras:
            assert g.end <= lo - flank + 1 or g.start >= hi + flank - 1  # in a flank's outer half
            seq = text[g.start : g.end]
            seq = seq if g.strand > 0 else seq[::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))
            diff = np.frombuffer(seq, np.uint8) != np.frombuffer(g.orf, np.uint8)
            assert diff.mean() <= 3 * {"clean": 0, "draft": 0.005}[asm.kind] + 1e-9
        if asm.knocked:
            g = next(g for g in asm.locus.genes if g.gene_id == asm.knocked)
            assert g.cluster == TINY_O_CONFIG["phenotype_logic"]["O-null"]["inactive_genes"][0]
            seq = text[lo + g.start : lo + g.end]
            seq = seq if g.strand > 0 else seq[::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))
            c = int(gen.KNOCK_AT * (len(g.orf) // 3))
            assert seq[3 * c : 3 * c + 3] == b"TAA"


def test_the_program_reads_the_extra_genes_and_rules(tmp_path):
    from kaptive_tpu_torch.db import Database

    db, _ = _make_o(5)
    gbk = tmp_path / "Tiny_O_locus_synthetic.gbk"
    gbk.write_text(db.genbank)
    gbk.with_suffix(".toml").write_text(db.toml)
    compiled = Database.from_genbank(gbk)
    extra = [compiled.genes.ids[i] for i in np.flatnonzero(compiled.extra_genes)]
    assert extra == [g.gene_id for g in db.extra]
    assert [i.decode() for i in compiled.phenotypes.ids] == ["O1v2", "O-null"]
