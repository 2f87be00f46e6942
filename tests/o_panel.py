"""An O-shaped panel of assemblies on which each phenotype rule fires, written without the JAX package.

The benchmark's generator (``benchmark/kbench/gen.py``) makes the database
from a seed: near-identical variant loci (``OL2α.1`` and ``OL2α.2`` share four
genes at 99-99.9%), one ``Extra genes`` record holding ``wbbY`` and ``wbbZ``,
and four rules of the forms the KpSC O database uses, with ``α``/``β`` in
their names: three replacements by sets of extra genes at rising priority and
a null rule on ``wzm``/``wzt`` inactive.  The assemblies carry the extra genes
in their flanks, on either strand, one of them cut by a contig break, and a
``wzm`` with a stop codon at half its length (``PLAN``); ``WANT`` is each one's
phenotype.
"""

import sys
from dataclasses import replace
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from kbench import gen  # noqa: E402

SHARED = ["wzm", "wzt", "glf", "wbbM"]
CONFIG = {
    "name": "o_panel", "db_name": "O_panel_synthetic", "organism": "Testus syntheticus", "taxon": 12345,
    "antigen": "Lipopolysaccharide O antigen", "pathway": "ABC transporter-dependent",
    "gene_nt": [300, 600], "spacer_nt": [80, 200], "tail_nt": 150,
    "family_identity": [0.80, 0.99], "cluster_identity": {"glf": [0.99, 0.999], "wbbM": [0.99, 0.999]},
    "loci": [
        {"name": "OL2α.1", "type": "O2α", "genes": SHARED + ["o2a1_orf1"]},
        {"name": "OL2α.2", "type": "O2α", "genes": SHARED + ["o2a2_orf1"]},
        {"name": "OL3β", "type": "O3β", "genes": ["wzm", "wzt", "wbdA", "wbdB"]},
        {"name": "OL4", "type": "O4", "genes": ["wzm", "wzt", "o4_orf1", "o4_orf2"]},
    ],
    "extra_genes": [{"cluster": "wbbY", "nt": 600}, {"cluster": "wbbZ", "nt": 450}],
    "phenotype_logic": {
        "O1αβ,2α": {"loci": ["OL2α*"], "extra_genes": ["wbbY"], "priority": 60},
        "O2β": {"loci": ["OL2α*"], "extra_genes": ["wbbZ"], "priority": 50},
        "O1αβ,2β": {"loci": ["OL2α*"], "extra_genes": ["wbbY", "wbbZ"], "priority": 70},
        "O-antigen null": {"loci": ["OL*"], "inactive_genes": ["wzm", "wzt"], "priority": 100},
    },
    "genome_nt": 12000, "id_threshold": 82.5,
}
FLANK = 4000  # bases each side of the locus
# (locus, extra genes as (cluster, offset, strand), wzm knocked out, contig cuts): offsets are
# into the genome, in the flanks; a cut at ``None`` falls inside the first extra gene.
PLAN = [
    ("OL2α.1", [("wbbY", 500, 1)], False, []),
    ("OL2α.2", [("wbbZ", 1200, -1)], False, []),
    ("OL2α.1", [("wbbY", 300, -1), ("wbbZ", -1500, 1)], False, [None]),
    ("OL3β", [], True, []),
    ("OL2α.2", [("wbbY", 800, 1), ("wbbZ", -900, -1)], True, []),
    ("OL4", [("wbbZ", 2000, 1)], False, [2500]),
]
WANT = ["O1αβ,2α", "O2β", "O1αβ,2β", "O-antigen null", "O-antigen null", "O4"]


def _one_extra_record(db):
    r"""The generator's GenBank with its two ``Extra genes`` records merged into one record of two genes."""
    locus_text = db.genbank.split("LOCUS       wbbY")[0]
    spacer = gen.random_codes(np.random.default_rng(1), 120)
    parts, genes, pos = [], [], 0
    for g in db.extra:
        parts += [spacer, gen.to_codes(g.orf)]
        genes.append(replace(g, start=pos + len(spacer), end=pos + len(spacer) + len(g.orf)))
        pos += len(spacer) + len(g.orf)
    out: list[str] = []
    gen._record(out, "Extra_genes", np.concatenate(parts + [spacer]), ["Extra genes: Extra_genes"], genes)
    return locus_text + "\n".join(out) + "\n"


def _assembly(rng, i, db, locus_name, extras, knocked, cuts):
    locus = next(loc for loc in db.loci if loc.name == locus_name)
    planted = locus.seq.copy()
    target = next(g for g in locus.genes if g.cluster == "wzm") if knocked else None
    if target is not None:
        gen._knock_out(planted, target)
    genome = np.concatenate([gen.random_codes(rng, FLANK), planted, gen.random_codes(rng, FLANK)])
    by_cluster = {g.cluster: g for g in db.extra}
    placed = []
    for cluster, offset, strand in extras:
        g = by_cluster[cluster]
        pos = offset % len(genome)
        codes = gen.to_codes(g.orf)
        genome[pos : pos + len(codes)] = codes if strand > 0 else gen.revcomp_codes(codes)
        placed.append(replace(g, start=pos, end=pos + len(codes), strand=strand))
    cuts = [placed[0].start + 200 if c is None else c for c in cuts]
    starts = np.array([0, *cuts, len(genome)])
    text = gen.BASES[genome].tobytes()
    fasta = b"".join(b">c%d\n%s\n" % (j + 1, text[starts[j] : starts[j + 1]]) for j in range(len(starts) - 1))
    return gen.Assembly(f"o{i}", "panel", locus, fasta, genome, FLANK, starts, tuple(placed),
                        target.gene_id if target is not None else None)



def make_o_panel(tmp_path):
    r"""``(synthetic database, assemblies, GenBank path)``: the database written as GenBank and
    TOML into ``tmp_path``, the assemblies as ``gen.Assembly`` with their planting truth."""
    rng_db, rng_asm = gen.seed_streams(2**31 + 21, 2)
    db = gen.make_database(CONFIG, rng_db)
    gbk = tmp_path / f"{CONFIG['db_name']}.gbk"
    gbk.write_text(_one_extra_record(db), encoding="utf-8")
    gbk.with_suffix(".toml").write_text(db.toml, encoding="utf-8")
    return db, [_assembly(rng_asm, i, db, *plan) for i, plan in enumerate(PLAN)], gbk
