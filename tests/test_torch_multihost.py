"""The port's multi-host scaffolding: input sharding, shard paths, resume, and a real two-process run.

The unit cases are ``tests/test_multihost.py``'s.  The two-process case is
``tests/test_multihost_e2e.py``'s: two subprocesses meet through
``initialize_distributed`` (gloo, 127.0.0.1, a free port), each types its
``shard_inputs`` slice of four FASTA files on the CPU with the port and
writes its ``ShardedJsonlWriter`` shard, with ``jax``, ``jaxlib`` and
``kaptive_tpu`` blocked from import.  Tolerance: exact — the merged shards'
records equal, byte for byte, the JAX package's single-process
``result_to_jsonl_bytes`` records of the same files.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

from kaptive_tpu_torch.parallel.multihost import (
    ShardedJsonlWriter,
    initialize_distributed,
    process_rank_and_count,
    shard_inputs,
    shard_path,
)

ROOT = Path(__file__).resolve().parent.parent


def test_shard_inputs_partition_and_balance():
    inputs = [f"g{i}.fa" for i in range(10)]
    shards = [shard_inputs(inputs, rank=r, world=3) for r in range(3)]
    flat = [x for s in shards for x in s]
    assert sorted(flat) == sorted(inputs) and len(set(flat)) == len(inputs)
    sizes = [len(s) for s in shards]
    assert max(sizes) - min(sizes) <= 1
    assert shard_inputs(inputs, rank=0, world=1) == inputs
    assert shard_inputs(inputs) == inputs  # not distributed: rank 0 of 1


def test_shard_path_naming(tmp_path):
    p = tmp_path / "results.jsonl"
    assert shard_path(p, rank=0, world=1) == p
    assert shard_path(p, rank=3, world=8).name == "results.part-00003.jsonl"


def test_initialize_without_coordinator_is_single_process(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed() is False
    assert process_rank_and_count() == (0, 1)


def test_sharded_writer_resume(tmp_path):
    """Interrupted runs resume: previously written genomes are skipped, a torn tail line is re-typed."""

    class FakeResult:
        def __init__(self, genome):
            self.genome = genome

        def to_dict(self):
            return {"genome": self.genome, "x": 1}

    path = tmp_path / "out.jsonl"
    with ShardedJsonlWriter(path, rank=0, world=1) as w:
        w.write_result(FakeResult("a"))
        w.write_result(FakeResult("b"))
    with path.open("ab") as fh:
        fh.write(b'{"genome": "c"')  # a torn tail line from a crash

    with ShardedJsonlWriter(path, rank=0, world=1) as w2:
        assert w2.should_skip("a") and w2.should_skip("b")
        assert not w2.should_skip("c")
        w2.write_result(FakeResult("b"))  # duplicate: ignored
        w2.write_result(FakeResult("d"))

    genomes = []
    for line in path.read_bytes().splitlines():
        try:
            genomes.append(json.loads(line)["genome"])
        except ValueError:
            pass
    assert genomes == ["a", "b", "d"]


WORKER = r"""
import glob, importlib.abc, os, sys

FOREIGN = ("jax", "jaxlib", "kaptive_tpu")


class BlockForeign(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FOREIGN:
            raise ModuleNotFoundError(f"blocked: {name}", name=name)
        return None


sys.meta_path.insert(0, BlockForeign())
rank, port, fixdir, outdir, repo = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5]
sys.path.insert(0, repo)
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from kaptive_tpu_torch.db import Database
from kaptive_tpu_torch.parallel.multihost import ShardedJsonlWriter, initialize_distributed, shard_inputs
from kaptive_tpu_torch.serotyping import Serotyper

assert initialize_distributed("127.0.0.1:%s" % port, 2, rank)
assert (dist.get_rank(), dist.get_world_size()) == (rank, 2)
db = Database.from_genbank(os.path.join(fixdir, "TestDB.gbk"))
genomes = sorted(glob.glob(os.path.join(fixdir, "genomes", "*.fasta")))
mine = shard_inputs(genomes)
with ShardedJsonlWriter(os.path.join(outdir, "results.jsonl")) as w:
    for result in Serotyper(db, device="cpu").batch(mine):
        w.write_result(result)
dist.barrier()
dist.destroy_process_group()
loaded = sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)
assert loaded == [], loaded
print("WORKER_OK", rank, len(mine), flush=True)
"""


def test_two_process_gloo_typing_equals_jax_single_process(tmp_path):
    from synthetic import make_genome_from_locus, make_synthetic_db

    from kaptive_tpu.db import Database
    from kaptive_tpu.serotyping import Serotyper
    from kaptive_tpu.serotyping.cli import result_to_jsonl_bytes

    rng = np.random.default_rng(77)
    gbk, truth = make_synthetic_db(tmp_path, rng, n_loci=3, genes_per_locus=4)
    assert gbk.name == "TestDB.gbk"
    gdir = tmp_path / "genomes"
    gdir.mkdir()
    for i, locus in enumerate(["KL1", "KL2", "KL3", "KL1"]):
        (gdir / f"g{i}.fasta").write_bytes(make_genome_from_locus(rng, truth, locus, contig_name=f"g{i}", flank=2000))
    genomes = sorted(str(p) for p in gdir.glob("*.fasta"))
    expected = {r.genome: result_to_jsonl_bytes(r) for r in Serotyper(Database.from_genbank(gbk)).batch(genomes)}

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    outdir = tmp_path / "out"
    outdir.mkdir()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_", "MASTER_", "WORLD_", "RANK"))}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(rank), str(port), str(tmp_path), str(outdir), str(ROOT)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True, cwd=tmp_path,
        )
        for rank in range(2)
    ]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{out[-3000:]}"
        assert f"WORKER_OK {rank} 2" in out, out  # 4 genomes round-robin over 2 ranks

    shards = sorted(outdir.glob("results.part-*.jsonl"))
    assert [p.name for p in shards] == ["results.part-00000.jsonl", "results.part-00001.jsonl"]
    merged = {}
    for shard in shards:
        for line in shard.read_bytes().splitlines(keepends=True):
            merged[json.loads(line)["genome"]] = line
    assert set(merged) == set(expected) == {f"g{i}" for i in range(4)}
    for genome, line in expected.items():
        assert merged[genome] == line, f"record mismatch for {genome}"
