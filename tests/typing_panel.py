"""The host-seeding typing panel shared by the port's mapper and serotyping tests.

Same construction as ``tests/test_host_seed.py``'s ``panel`` fixture: a
4-locus synthetic database and five assemblies (clean, 1%-diverged,
reverse-complemented, split over two contigs, N-heavy) whose true locus is
known by construction.
"""

import numpy as np

from synthetic import make_genome_from_locus, make_synthetic_db, random_dna, revcomp

TRUTH = ["KL1", "KL2", "KL3", "KL4", "KL1"]


def make_typing_panel(tmp_path):
    """Return (Database, [(name, fasta_bytes), ...]) built from seed 5."""
    from kaptive_tpu.db import Database

    rng = np.random.default_rng(5)
    gbk, truth = make_synthetic_db(tmp_path, rng, n_loci=4)
    db = Database.from_genbank(gbk)
    loc3 = truth["loci"]["KL3"]["seq"]
    loc4 = truth["loci"]["KL4"]["seq"]
    loc1 = truth["loci"]["KL1"]["seq"]
    half = len(loc4) // 2
    genomes = [
        ("clean", make_genome_from_locus(rng, truth, "KL1")),
        ("diverged", make_genome_from_locus(rng, truth, "KL2", sub_rate=0.01)),
        ("revcomp", b">c1\n" + random_dna(rng, 2500) + revcomp(loc3) + random_dna(rng, 2500) + b"\n"),
        ("split", b">c1\n" + random_dna(rng, 2000) + loc4[:half] + b"\n>c2\n"
         + loc4[half:] + random_dna(rng, 2000) + b"\n"),
        ("n_heavy", b">c1\n" + random_dna(rng, 3000) + b"N" * 500 + loc1[: len(loc1) // 2]
         + b"NNNN" + loc1[len(loc1) // 2 :] + random_dna(rng, 3000) + b"\n"),
    ]
    return db, genomes


def assert_same(got, want, path="value"):
    """Exact structural equality of dicts, dataclasses, sequences and arrays;
    NaN equals NaN, and arrays must agree in dtype too."""
    import dataclasses
    import math

    if dataclasses.is_dataclass(want):
        names = [f.name for f in dataclasses.fields(want)]
        assert [f.name for f in dataclasses.fields(got)] == names, path
        for f in dataclasses.fields(want):
            assert_same(getattr(got, f.name), getattr(want, f.name), f"{path}.{f.name}")
    elif isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for key in want:
            assert_same(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got), path
    else:
        assert got == want, f"{path}: {got!r} != {want!r}"
