#!/usr/bin/env python3
"""Time the port's two Viterbi decodes on one NVIDIA GPU, beside another checkout's kernels.

Run from the root of a checkout on a machine with a CUDA card::

    python3 measure_viterbi.py [--parent DIR]

It imports the port alone (no jax, no ``kaptive_tpu``) and measures on the
inputs of ``chip_smoke.py``'s BGC phase: bench.py's database and its clean
and draft 5.3 Mb assemblies (seed 2026), annotated (``align=False``) and
predicted on the card with a model of the default width (K = 25, D = 1024)
trained on the database's loci; the gene decode's two main-path launches and
the architectural decode's largest are recorded and timed again.

1. The gene decode of this checkout at its own chunk length and warm-up, and
   at every pair of ``CHUNKS`` x ``WARMUPS``: CUDA-event time of a whole call,
   chunks, fix-up rounds, re-run chunks and chunks filled; every pair's states
   must equal the default's (which ``chip_smoke.py`` holds to the plain form).
2. One clean-launch call under ``torch.profiler``: device time by kernel.
3. With ``--parent DIR``: DIR's ``kaptive_tpu_torch/csrc/viterbi.cu`` (the
   design before the chunked one: one warp a strand, C entry points
   ``kts_gene_viterbi(codemit, entry_b, exit_b, offsets, n_chains, total,
   indel, ins_extend, back, states, stream)`` and ``kts_arch_viterbi`` as
   now) is built as it is and with its gene kernel's reverse pass cut, into
   ``build/measure_viterbi/``.  Both decodes of both checkouts are timed in the
   order parent, change, change, parent; the parent's states, paths and
   scores must equal this checkout's.  The parent's gene time a step is split
   into its forward pass (the cut build) and the rest (reverse pass).

Every line names the card (``nvidia-smi`` name and power limit).
"""

from __future__ import annotations

import argparse
import ctypes
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from measure_common import assert_no_jax, build_sources, parent_change  # noqa: E402
CHUNKS = (256, 512, 1024, 2048, 4096)  # gene chunk lengths swept
WARMUPS = (0, 256, 512, 1024, 2048)  # gene warm-ups swept
REPS = 5  # calls a time is the mean of
PARENT_REVERSE_LOOP = "for (long long t = n_tiles - 1; t >= 0; --t) {"  # the parent kernel's reverse pass


def _timed(fn, reps: int = REPS) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls queued back to back (CUDA events, after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _build_parent(parent: Path, out: Path) -> dict[str, ctypes.CDLL]:
    """DIR's viterbi.cu as it is ("full") and with the gene kernel's reverse pass cut ("forward"),
    built in parallel with the port's nvcc flags."""
    src = (parent / "kaptive_tpu_torch" / "csrc" / "viterbi.cu").read_text()
    if src.count(PARENT_REVERSE_LOOP) != 1:
        raise RuntimeError(f"{parent}: not the one-warp-a-strand design (no single reverse loop to cut)")
    variants = {"full": src, "forward": src.replace(PARENT_REVERSE_LOOP, "for (long long t = -1; t >= 0; --t) {")}
    built = build_sources({f"parent_{name}": text for name, text in variants.items()}, out)
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    libs = {}
    for name in variants:
        lib = libs[name] = built[f"parent_{name}"][0]
        lib.kts_gene_viterbi.restype = i32
        lib.kts_gene_viterbi.argtypes = [ptr] * 4 + [i32, i64, f32, f32] + [ptr] * 3
        lib.kts_arch_viterbi.restype = i32
        lib.kts_arch_viterbi.argtypes = [ptr] * 3 + [i32, i64, i32] + [ptr] * 4
    return libs


def _parent_gene(lib, args, kw):
    import torch

    codemit, entry_b, exit_b, offsets = args
    total = codemit.shape[0]
    states = torch.empty(total, dtype=torch.int8, device=codemit.device)
    back = torch.empty(total, dtype=torch.int32, device=codemit.device)
    rc = lib.kts_gene_viterbi(codemit.data_ptr(), entry_b.data_ptr(), exit_b.data_ptr(), offsets.data_ptr(),
                              offsets.shape[0] - 1, total, float(kw["indel"]), float(kw["ins_extend"]),
                              back.data_ptr(), states.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"parent gene kernel: CUDA error {rc}")
    return states


def _parent_arch(lib, args):
    import torch

    emissions, transitions, offsets = args
    rows, S = emissions.shape
    paths = torch.empty(rows, dtype=torch.int32, device=emissions.device)
    scores = torch.empty(offsets.shape[0] - 1, dtype=torch.float32, device=emissions.device)
    back = torch.empty((rows, S), dtype=torch.uint8, device=emissions.device)
    rc = lib.kts_arch_viterbi(emissions.data_ptr(), transitions.data_ptr(), offsets.data_ptr(), offsets.shape[0] - 1,
                              rows, S, back.data_ptr(), paths.data_ptr(), scores.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"parent architectural kernel: CUDA error {rc}")
    return paths, scores


def _main_path_launches(card: str):
    """The gene decode's clean and draft launches and the architectural decode's largest launch
    of ``chip_smoke.py``'s BGC phase, recorded from the port's own annotate and predict."""
    import torch
    from chip_smoke import _CallRecorder, _named_stream, build_workload

    from kaptive_tpu_torch.bgc import Annotator, ArchitecturalPredictor, ArchitecturalTrainer
    from kaptive_tpu_torch.bgc import genefinder
    from kaptive_tpu_torch.bgc import kernels as bgc_kernels
    from kaptive_tpu_torch.core.genome import GenomeAssembly

    t0 = time.perf_counter()
    db, assemblies, _ = build_workload(4)
    picked = {kind: next(a for a in assemblies if a[2] == kind) for kind in ("clean", "draft")}
    model = ArchitecturalTrainer().train([db.get_locus_data(n) for n in db.loci.ids if n.startswith("KL")])
    annotator = Annotator(db, align=False, device="cuda")
    predictor = ArchitecturalPredictor(model, device="cuda")
    genes_rec, arch_rec = _CallRecorder(genefinder.gene_viterbi), _CallRecorder(bgc_kernels.arch_viterbi)
    genefinder.gene_viterbi, bgc_kernels.arch_viterbi = genes_rec, arch_rec
    try:
        for name, _, kind, fasta in picked.values():
            predictor.predict(annotator(GenomeAssembly.from_stream(_named_stream(name, fasta), name)))
    finally:
        genefinder.gene_viterbi, bgc_kernels.arch_viterbi = genes_rec.inner, arch_rec.inner
    torch.cuda.synchronize()
    gene = dict(zip(picked, genes_rec.calls))
    arch = {"largest": max(arch_rec.calls, key=lambda c: c[0][0].shape[0]),
            "draft": arch_rec.calls[-1]}
    print(f"# main-path launches recorded in {time.perf_counter() - t0:.1f} s: gene {len(genes_rec.calls)}, "
          f"architectural {len(arch_rec.calls)} [{card}]", flush=True)
    return gene, arch


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kaptive_tpu_torch.ops import viterbi_cuda
    from kaptive_tpu_torch.ops.viterbi_cuda import _gene_launch, arch_viterbi_cuda
    from kaptive_tpu_torch.utils.device import card_info, require_cuda

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, help="a checkout of the design to compare with")
    opts = parser.parse_args()
    require_cuda()
    card = card_info()
    print(f"# card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    lib = viterbi_cuda.build()
    print(f"# ptxas {viterbi_cuda.LIBRARY.source.name}: {viterbi_cuda.LIBRARY.ptxas_report()}", flush=True)
    parent = _build_parent(opts.parent.resolve(), ROOT / "build" / "measure_viterbi") if opts.parent else None
    gene, arch = _main_path_launches(card)
    chunk0, warmup0 = lib.kts_gene_chunk(), lib.kts_gene_warmup()

    # 1. The sweep of chunk lengths and warm-ups.
    for kind, (args, kw) in gene.items():
        steps = int(args[3][-1])
        want, _ = _gene_launch(*args, kw["indel"], kw["ins_extend"])
        for chunk in CHUNKS:
            for warmup in WARMUPS:
                got, stats = _gene_launch(*args, kw["indel"], kw["ins_extend"], warmup=warmup, chunk=chunk)
                if not torch.equal(got, want):
                    raise AssertionError(f"gene decode at chunk {chunk}, warm-up {warmup} differs on {kind}")
                ms = _timed(lambda: _gene_launch(*args, kw["indel"], kw["ins_extend"], warmup=warmup, chunk=chunk))
                print(f"# gene {kind} ({steps} steps): chunk {chunk}, warm-up {warmup}: {ms:.4f} ms; "
                      f"{stats.chunks} chunks, {stats.rounds} rounds, {stats.reruns} re-run, {stats.filled} filled"
                      f"{'  <- the source' if (chunk, warmup) == (chunk0, warmup0) else ''} [{card}]", flush=True)

    # 2. Device time by kernel of one clean-launch call.
    args, kw = gene["clean"]
    _gene_launch(*args, kw["indel"], kw["ins_extend"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _gene_launch(*args, kw["indel"], kw["ins_extend"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel: dict[str, list[float]] = {}
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            per_kernel.setdefault(event.name, []).append(event.device_time_total / 1e3)
    busy = sum(sum(v) for v in per_kernel.values())
    print(f"# gene clean launch under torch.profiler: call {wall * 1e3:.4f} ms wall, device busy {busy:.4f} ms "
          f"[{card}]; by kernel:", flush=True)
    for name, times in sorted(per_kernel.items(), key=lambda kv: -sum(kv[1])):
        print(f"#   {sum(times):9.4f} ms  {len(times):3d} x  {name[:90]}", flush=True)

    # 3. The parent's kernels on the same inputs: parent, change, change, parent.
    if parent:
        for kind, (args, kw) in gene.items():
            steps = int((args[3][1:] - args[3][:-1]).max())
            want, _ = _gene_launch(*args, kw["indel"], kw["ins_extend"])
            if not torch.equal(_parent_gene(parent["full"], args, kw), want):
                raise AssertionError(f"the parent's gene kernel and this one differ on the {kind} launch")
            p_ms, c_ms = parent_change(lambda: _parent_gene(parent["full"], args, kw),
                                       lambda: _gene_launch(*args, kw["indel"], kw["ins_extend"]),
                                       lambda fn: _timed(fn, 3))
            forward = _timed(lambda: _parent_gene(parent["forward"], args, kw), 3)
            full = sum(p_ms) / 2
            print(f"# gene {kind}: parent {p_ms[0]:.4f} / {p_ms[1]:.4f} ms, change "
                  f"{c_ms[0]:.4f} / {c_ms[1]:.4f} ms; the parent's forward pass alone "
                  f"{forward:.4f} ms: {forward / steps * 1e6:.2f} ns a step forward, "
                  f"{(full - forward) / steps * 1e6:.2f} ns a step reverse, over its longest strand of {steps} "
                  f"[{card}]", flush=True)
        for kind, (args, _) in arch.items():
            paths, scores = arch_viterbi_cuda(*args)
            p_paths, p_scores = _parent_arch(parent["full"], args)
            if not (torch.equal(paths, p_paths) and torch.equal(scores, p_scores)):
                raise AssertionError(f"the parent's architectural kernel and this one differ on {kind}")
            p_ms, c_ms = parent_change(lambda: _parent_arch(parent["full"], args), lambda: arch_viterbi_cuda(*args),
                                       lambda fn: _timed(fn, 20))
            rows, S = args[0].shape
            print(f"# architectural {kind} launch ({rows} rows x {S} states, {args[2].shape[0] - 1} contigs): "
                  f"parent {p_ms[0]:.4f} / {p_ms[1]:.4f} ms, change {c_ms[0]:.4f} / {c_ms[1]:.4f} ms [{card}]",
                  flush=True)
    else:
        for kind, (args, _) in arch.items():
            rows, S = args[0].shape
            ms = _timed(lambda: arch_viterbi_cuda(*args), 20)
            print(f"# architectural {kind} launch ({rows} rows x {S} states, {args[2].shape[0] - 1} contigs): "
                  f"{ms:.4f} ms [{card}]", flush=True)

    assert_no_jax()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
