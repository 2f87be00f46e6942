"""The synthetic locus database, written by the port alone.

``make_synthetic_db`` is ``synthetic.make_synthetic_db`` written with the
port's GenBank writer (``kaptive_tpu_torch.db.genbank``), so a process that
must not load the JAX package can still make a database; from the same seed
both write the same files byte for byte (``tests/test_torch_core.py`` checks it).
"""

from synthetic import make_genome_from_locus, make_orf, random_dna, revcomp  # noqa: F401


def make_synthetic_db(tmp_path, rng, n_loci: int = 4, genes_per_locus: int = 5,
                      with_extra: bool = True, with_phenotypes: bool = True,
                      name: str = "TestDB", keyword: str = "test_db",
                      cluster_prefix: str = "wz"):
    """Write a synthetic GenBank+TOML locus database; return (gbk_path, truth dict).

    Each locus is spacer + alternating-strand ORF genes + spacer. Gene clusters
    are named 'wzA'..; locus KL1..KLn with serotype K1..Kn.
    """
    from kaptive_tpu_torch.db.genbank import Feature, Location, Qualifier, Record, write_genbank

    records = []
    truth = {"loci": {}, "gene_seqs": {}}
    for li in range(n_loci):
        locus_name = f"KL{li + 1}"
        serotype = f"K{li + 1}"
        pos = 0
        seq_parts = []
        feats = [
            Feature("source", Location(0, 0, 1),
                    [Qualifier("note", f"locus: {locus_name}"), Qualifier("note", f"type: {serotype}")])
        ]
        gene_info = []
        for gi in range(genes_per_locus):
            spacer = random_dna(rng, int(rng.integers(80, 200)))
            seq_parts.append(spacer)
            pos += len(spacer)
            orf = make_orf(rng, int(rng.integers(100, 260)))
            strand = 1 if gi % 2 == 0 else -1
            cluster = f"{cluster_prefix}{chr(ord('A') + gi)}"
            gene_seq = orf if strand == 1 else revcomp(orf)
            seq_parts.append(gene_seq)
            feats.append(Feature("CDS", Location(pos, pos + len(orf), strand),
                                 [Qualifier("gene", cluster),
                                  Qualifier("product", f"protein {cluster}")]))
            gene_info.append((cluster, pos, pos + len(orf), strand, orf))
            pos += len(orf)
        tail = random_dna(rng, 150)
        seq_parts.append(tail)
        full = b"".join(seq_parts)
        feats[0].location = Location(0, len(full), 1)
        records.append(Record(locus_name, full, feats))
        truth["loci"][locus_name] = {"seq": full, "serotype": serotype, "genes": gene_info}

    if with_extra:
        # Extra genes record: IS elements / modifier genes without synteny
        extra_orf = make_orf(rng, 120)
        rec = Record("Extra_genes", extra_orf,
                     [Feature("source", Location(0, len(extra_orf), 1),
                              [Qualifier("note", "Extra genes: Extra_genes")]),
                      Feature("CDS", Location(0, len(extra_orf), 1),
                              [Qualifier("gene", "wcaJ"), Qualifier("product", "extra modifier")])])
        records.append(rec)
        truth["extra"] = {"wcaJ": extra_orf}

    gbk = tmp_path / f"{name}.gbk"
    gbk.write_bytes(write_genbank(records))

    logic = ""
    if with_phenotypes:
        logic = (
            '[phenotype_logic."K1-like"]\n'
            'loci = ["KL1"]\n'
            'extra_genes = ["wcaJ"]\n'
            "priority = 60\n"
            '[phenotype_logic."K2-deficient"]\n'
            'loci = ["KL2"]\n'
            'inactive_genes = ["wz*"]\n'
            "priority = 55\n"
        )
    toml = f'''name = "{name}"
keyword = "{keyword}"
genbank = "{name}.gbk"
organism = "Testus syntheticus"
taxon = 12345
antigen = "Capsular polysaccharide"
pathway = "Wzx/Wzy-dependent"
version = "1.0.0"
id_threshold = 82.5
doi = ["TBD"]
owner = "example"
repo = "example-db"
branch = "main"
[contact]
"Test Curator" = "test@example.org"
{logic}'''
    (tmp_path / f"{name}.toml").write_text(toml)
    return gbk, truth
