#!/usr/bin/env python3
"""Time the fill's cluster form and the architectural decode past 256 states on one NVIDIA GPU,
beside another checkout's kernels on the same inputs.

Run from the root of a checkout on a machine with a CUDA card::

    python3 measure_input_range.py [--parent DIR]

It imports the port alone (no jax, no ``kaptive_tpu``) and measures on the
inputs of ``chip_smoke.py`` step 12(f): the F7 bucket (the unseeded
150-versus-4,300 protein pair through the default ``PairwiseAligner``:
16 pairs, 16,384 rows, w_pad 32,768), the largest bucket of the 48 BLOSUM62 x 20
pairs through ``batched_swg_align``, and the 257-state decode of the draft
5.3 Mb assembly's annotation (bench.py's database and assemblies, seed 2026,
annotated on the card as step 10 annotates it; a 254-archetype model trained
on the database's KL loci).  Besides, the fill's wide form on the smoke's
synthetic (24, 512, 1152) bucket.

1. This checkout's forms: the cluster form's geometry, CUDA-event time beside
   the bound ``chip_smoke.py`` computes, and the decode's longest contig.
2. With ``--parent DIR``: DIR's ``kaptive_tpu_torch/csrc/swg.cu`` and
   ``viterbi.cu`` (the design before this one: C entry points
   ``kts_swg_fill_segmented(q, t, q_lens, t_lens, offsets, k_locals, matrix,
   n_pairs, rows_max, w_pad, t_cols, gap_open, gap_extend, scratch, tb, best,
   best_i, best_j, stream)`` and ``kts_arch_viterbi_wide(emissions,
   transitions, offsets, n_contigs, rows, S, back, paths, scores, work,
   stream)``) are built as they are, with the port's nvcc flags, into
   ``build/measure_input_range/``; each input is timed in the order parent,
   change, change, parent, and the parent's outputs must equal this
   checkout's.  DIR may hold only those two files, e.g. ``git archive <parent>
   kaptive_tpu_torch/csrc/swg.cu kaptive_tpu_torch/csrc/viterbi.cu | tar -x -C
   DIR``.
3. The decode's cluster cap: this checkout's ``viterbi.cu`` is built again
   with ``ARCH_WIDE_MAX_CLUSTER`` lowered from 8 to 4 CTAs, and the draft
   launch's first 8, 12, 16 and 24 contigs are timed at both caps (cap 4, cap
   8, cap 8, cap 4), beside the CTAs a contig each build chose
   (``kts_arch_wide_cluster``); their outputs must be equal.

Every line names the card (``nvidia-smi`` name and power limit).
"""

from __future__ import annotations

import argparse
import ctypes
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from measure_common import assert_no_jax, build_sources, parent_change  # noqa: E402
FILL_REPS = 20  # calls a fill time is the mean of
ARCH_REPS = 5  # calls a decode time is the mean of


CLUSTER_CAP = "constexpr int ARCH_WIDE_MAX_CLUSTER = 8;"  # this checkout's cap on a decode cluster's CTAs
CAP_CONTIGS = (8, 12, 16, 24)  # the draft launch's first n contigs, timed at both caps


def _build_others(parent: Path | None, out: Path) -> dict[str, ctypes.CDLL]:
    """This checkout's viterbi.cu with its decode cluster's cap lowered to 4 CTAs ("cap4") and, with
    ``parent``, DIR's swg.cu and viterbi.cu as they are; built in parallel with the port's nvcc flags."""
    from kaptive_tpu_torch.ops.viterbi_cuda import _declare

    src = (ROOT / "kaptive_tpu_torch" / "csrc" / "viterbi.cu").read_text()
    if src.count(CLUSTER_CAP) != 1:
        raise RuntimeError(f"viterbi.cu: no single `{CLUSTER_CAP}` to lower")
    sources = {"cap4_viterbi": src.replace(CLUSTER_CAP, CLUSTER_CAP.replace("= 8;", "= 4;"))}
    if parent:
        for stem in ("swg", "viterbi"):
            sources[f"parent_{stem}"] = (parent / "kaptive_tpu_torch" / "csrc" / f"{stem}.cu").read_text()
    libs = {name: lib for name, (lib, _) in build_sources(sources, out).items()}
    _declare(libs["cap4_viterbi"])
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if parent:
        libs["parent_swg"].kts_swg_fill_segmented.restype = i32
        libs["parent_swg"].kts_swg_fill_segmented.argtypes = [ptr] * 7 + [i32] * 6 + [ptr] * 6
        libs["parent_viterbi"].kts_arch_viterbi_wide.restype = i32
        libs["parent_viterbi"].kts_arch_viterbi_wide.argtypes = [ptr] * 3 + [i32, i64, i32] + [ptr] * 5
    return libs


def _wide_arch(lib, args):
    """``arch_viterbi_cuda``'s launch of the decode past 256 states, through ``lib``: ``(paths, scores)``."""
    import torch

    emissions, transitions, offsets = args
    rows, S = emissions.shape
    n = offsets.shape[0] - 1
    dev = emissions.device
    tt = torch.full((S, lib.kts_arch_wide_pitch(S)), float("-inf"), dtype=torch.float32, device=dev)
    tt[:, :S] = transitions.t()
    bp = torch.int16 if lib.kts_arch_wide_bp_bytes(S) == 2 else torch.int32
    back = torch.empty((rows, lib.kts_arch_wide_bp_pitch(S)), dtype=bp, device=dev)
    work = torch.empty((n, lib.kts_arch_wide_work_floats(S)), dtype=torch.float32, device=dev)
    paths = torch.empty(rows, dtype=torch.int32, device=dev)
    scores = torch.empty(n, dtype=torch.float32, device=dev)
    rc = lib.kts_arch_viterbi_wide(emissions.data_ptr(), transitions.data_ptr(), tt.data_ptr(), offsets.data_ptr(), n,
                                   rows, S, back.data_ptr(), paths.data_ptr(), scores.data_ptr(), work.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode past 256 states: CUDA error {rc}")
    return paths, scores


def _parent_fill(lib, args, kw):
    """The parent's segmented fill: ``(tb, best, best_i, best_j)``."""
    import torch

    q, q_lens, t, t_lens, offsets, k_locals, matrix = args
    B, T, rows_max, w_pad = q.shape[0], t.shape[1], kw["rows_max"], kw["w_pad"]
    dev = q.device
    scores = matrix.to(torch.int32).contiguous()
    scratch = torch.empty((B, 2, w_pad), dtype=torch.int32, device=dev)
    tb = torch.empty((B, rows_max, w_pad), dtype=torch.uint8, device=dev)
    best, best_i, best_j = (torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3))
    rc = lib.kts_swg_fill_segmented(
        q.data_ptr(), t.data_ptr(), q_lens.data_ptr(), t_lens.data_ptr(), offsets.data_ptr(), k_locals.data_ptr(),
        scores.data_ptr(), B, rows_max, w_pad, T, int(kw["gap_open"]), int(kw["gap_extend"]), scratch.data_ptr(),
        tb.data_ptr(), best.data_ptr(), best_i.data_ptr(), best_j.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"parent segmented fill: CUDA error {rc}")
    return tb, best, best_i, best_j


def _parent_arch(lib, args):
    """The parent's block-a-contig decode (a thread a state): ``(paths, scores)``."""
    import torch

    emissions, transitions, offsets = args
    rows, S = emissions.shape
    n = offsets.shape[0] - 1
    dev = emissions.device
    paths = torch.empty(rows, dtype=torch.int32, device=dev)
    scores = torch.empty(n, dtype=torch.float32, device=dev)
    back = torch.empty((rows, S), dtype=torch.int16 if S <= 65536 else torch.int32, device=dev)
    work = torch.empty((n, 2, S), dtype=torch.float32, device=dev)
    rc = lib.kts_arch_viterbi_wide(emissions.data_ptr(), transitions.data_ptr(), offsets.data_ptr(), n, rows, S,
                                   back.data_ptr(), paths.data_ptr(), scores.data_ptr(), work.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"parent block-a-contig decode: CUDA error {rc}")
    return paths, scores


def _same_fill(a, b, q_lens) -> bool:
    """Two fills agree: best, best_i, best_j, and the traceback bytes of the rows each query reaches."""
    import torch

    rows = int(q_lens.max())
    reached = torch.arange(rows, device=q_lens.device)[None, :, None] < q_lens.long()[:, None, None]
    return all(torch.equal(x, y) for x, y in zip(a[1:], b[1:])) and torch.equal(
        torch.where(reached, a[0][:, :rows], 0), torch.where(reached, b[0][:, :rows], 0))


def _inputs(card: str):
    """``({label: (args, kw)} of the fill buckets, args of the 257-state decode's largest launch)``."""
    import torch
    from chip_smoke import (
        _CallRecorder, _named_stream, blosum_x20_align_args, build_workload, record_arch_predict, record_f7_bucket,
        train_arch_257,
    )

    from kaptive_tpu_torch.bgc import Annotator
    from kaptive_tpu_torch.core import pairwise
    from kaptive_tpu_torch.core.genome import GenomeAssembly
    from kaptive_tpu_torch.core.pairwise import batched_swg_align

    t0 = time.perf_counter()
    _, f7_call = record_f7_bucket()
    recorder = _CallRecorder(pairwise.banded_swg)
    pairwise.banded_swg = recorder
    try:
        batched_swg_align(*blosum_x20_align_args())
    finally:
        pairwise.banded_swg = recorder.inner
    buckets = {"F7": f7_call, "BLOSUM62 x 20": recorder.largest_bucket()}
    db, assemblies, _ = build_workload(4)
    name, _, _, fasta = next(a for a in assemblies if a[2] == "draft")
    annotation = Annotator(db, align=True, device="cuda")(GenomeAssembly.from_stream(_named_stream(name, fasta), name))
    model, _ = train_arch_257(db)
    _, calls = record_arch_predict(model, annotation)
    args = max((a for a, _ in calls), key=lambda a: a[0].shape[0])
    torch.cuda.synchronize()
    print(f"# inputs recorded in {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return buckets, args


def main() -> int:
    import numpy as np
    import torch
    from chip_smoke import SEED, WIDE_FORM_BUCKET, _arch_bound, _fill_bound, _synthetic_bucket, _timed
    from swg_panels import AA, blosum_matrix

    from kaptive_tpu_torch.ops import swg_cuda, viterbi_cuda
    from kaptive_tpu_torch.ops.swg_cuda import as_kernel_matrix, cluster_plan, fill_form, swg_fill_cuda
    from kaptive_tpu_torch.ops.viterbi_cuda import arch_viterbi_cuda
    from kaptive_tpu_torch.utils.device import card_info, require_cuda

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, help="a checkout of the design to compare with")
    opts = parser.parse_args()
    require_cuda()
    card = card_info()
    print(f"# card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    with ThreadPoolExecutor(max_workers=3) as pool:
        own = [pool.submit(m.build) for m in (swg_cuda, viterbi_cuda)]
        others = pool.submit(_build_others, opts.parent.resolve() if opts.parent else None,
                             ROOT / "build" / "measure_input_range")
        for f in own:
            f.result()
        others = others.result()
    parent = {stem: others[f"parent_{stem}"] for stem in ("swg", "viterbi")} if opts.parent else None
    buckets, arch_args = _inputs(card)

    def share(ms: float, bound: dict) -> str:
        return f"bound {bound['bound_ms']:.5f} ms by {bound['bound_by']}: {100 * bound['bound_ms'] / ms:.2f}% of it"

    for label, (args, kw) in buckets.items():
        fill_kw = {k: kw[k] for k in ("gap_open", "gap_extend", "rows_max", "w_pad")}
        q_lens = args[1]
        shape = (int(args[0].shape[0]), kw["rows_max"], kw["w_pad"])
        bound = _fill_bound(q_lens, int(args[2].shape[1]), kw["rows_max"], kw["w_pad"])
        form = fill_form(kw["w_pad"], args[6].dtype)
        line = (f"# {label} bucket {shape}, {int((q_lens > 0).sum())} live pairs, {int(q_lens.max())} rows at most, "
                f"the {form} form {cluster_plan(kw['w_pad'])} (CTAs a cluster, 0 for a warp a pair; lanes a CTA; "
                f"lanes a thread; threads)")
        want = swg_fill_cuda(*args, **fill_kw)
        if parent:
            if not _same_fill(_parent_fill(parent["swg"], args, kw), want, q_lens):
                raise AssertionError(f"the parent's fill and this one differ on the {label} bucket")
            p_ms, c_ms = parent_change(lambda: _parent_fill(parent["swg"], args, kw),
                                       lambda: swg_fill_cuda(*args, **fill_kw), lambda fn: _timed(fn, FILL_REPS))
            ms = sum(c_ms) / 2
            print(f"{line}: parent {p_ms[0]:.4f} / {p_ms[1]:.4f} ms, change {c_ms[0]:.4f} / {c_ms[1]:.4f} ms; "
                  f"{share(ms, bound)} [{card}]", flush=True)
        else:
            ms = _timed(lambda: swg_fill_cuda(*args, **fill_kw), FILL_REPS)
            print(f"{line}: {ms:.4f} ms; {share(ms, bound)} [{card}]", flush=True)
        del want
        torch.cuda.empty_cache()

    rows, S = arch_args[0].shape
    longest = int(torch.diff(arch_args[2]).max())
    bound = _arch_bound(arch_args[0], arch_args[2])
    line = (f"# architectural decode at {S} states, {rows} rows in {arch_args[2].shape[0] - 1} contigs, the longest "
            f"{longest} rows")
    want = arch_viterbi_cuda(*arch_args)
    if parent:
        got = _parent_arch(parent["viterbi"], arch_args)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError("the parent's block-a-contig decode and this one differ")
        p_ms, c_ms = parent_change(lambda: _parent_arch(parent["viterbi"], arch_args),
                                   lambda: arch_viterbi_cuda(*arch_args), lambda fn: _timed(fn, ARCH_REPS))
        ms = sum(c_ms) / 2
        print(f"{line}: parent {p_ms[0]:.4f} / {p_ms[1]:.4f} ms, change {c_ms[0]:.4f} / {c_ms[1]:.4f} ms "
              f"({ms * 1e3 / longest:.3f} us a row of the longest); {share(ms, bound)} [{card}]", flush=True)
    else:
        ms = _timed(lambda: arch_viterbi_cuda(*arch_args), ARCH_REPS)
        print(f"{line}: {ms:.4f} ms ({ms * 1e3 / longest:.3f} us a row of the longest); {share(ms, bound)} "
              f"[{card}]", flush=True)

    # The decode's cluster cap: this checkout's 8 CTAs against 4 on the draft launch's first n contigs,
    # in the order cap 4, cap 8, cap 8, cap 4.
    lib, cap4 = viterbi_cuda.build(), others["cap4_viterbi"]
    for n in CAP_CONTIGS:
        end = int(arch_args[2][n])
        sub = (arch_args[0][:end].contiguous(), arch_args[1], arch_args[2][: n + 1].contiguous())
        got, want = _wide_arch(cap4, sub), arch_viterbi_cuda(*sub)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"the decode at cap 4 and at cap 8 differ on {n} contigs")
        p_ms, c_ms = parent_change(lambda: _wide_arch(cap4, sub), lambda: arch_viterbi_cuda(*sub),
                                   lambda fn: _timed(fn, ARCH_REPS))
        print(f"# architectural decode at {S} states, the draft launch's first {n} contigs ({end} rows, the longest "
              f"{int(torch.diff(sub[2]).max())}): cap 4 ({cap4.kts_arch_wide_cluster(S, n)} CTAs a contig) "
              f"{p_ms[0]:.4f} / {p_ms[1]:.4f} ms, cap 8 ({lib.kts_arch_wide_cluster(S, n)} CTAs) {c_ms[0]:.4f} / "
              f"{c_ms[1]:.4f} ms [{card}]", flush=True)

    B, rows_max, w_pad = WIDE_FORM_BUCKET
    arrays = [torch.from_numpy(a).cuda() for a in _synthetic_bucket(np.random.default_rng(SEED), AA, B, rows_max,
                                                                       w_pad)]
    matrix = as_kernel_matrix(blosum_matrix(), torch.device("cuda"))
    fill_kw = dict(gap_open=11, gap_extend=1, rows_max=rows_max, w_pad=w_pad)
    ms = _timed(lambda: swg_fill_cuda(*arrays, matrix, **fill_kw), FILL_REPS)
    bound = _fill_bound(arrays[1], int(arrays[2].shape[1]), rows_max, w_pad)
    print(f"# the fill's {fill_form(w_pad)} form on the synthetic bucket {WIDE_FORM_BUCKET}: {ms:.4f} ms; "
          f"{share(ms, bound)} [{card}]", flush=True)

    assert_no_jax()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
