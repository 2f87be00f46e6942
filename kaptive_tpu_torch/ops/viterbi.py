r"""Viterbi decodes of the BGC toolkit: plain PyTorch forms and front doors.

Two decodes, each with a hand-written Hopper kernel (``csrc/viterbi.cu``,
bound by :mod:`kaptive_tpu_torch.ops.viterbi_cuda`) and a plain PyTorch form
here:

- :func:`gene_viterbi` — the 7-state codon-phase HMM of the gene finder
  (``kaptive_tpu/bgc/genefinder.py::_viterbi_states``, an XLA ``lax.scan``)
  over a ragged batch of strands, each decoded on its own;
- :func:`arch_viterbi` — the max-plus decode of the architectural predictor
  with a forced end in POST (``kaptive_tpu/bgc/kernels.py::architectural_viterbi``)
  over a ragged batch of contigs' emission matrices.

Both are float32 additions, maxima and first-index argmaxes in the JAX
package's order, so the kernels and the plain forms give its states, paths
and scores exactly.  The plain forms loop over positions and vectorise over
the chains of the batch.  A front door takes the kernel for a CUDA tensor and
the plain form for a CPU tensor; there is no fallback.  Launches are counted
as ``viterbi.{cuda,plain}.{gene,arch}`` in :mod:`kaptive_tpu_torch.utils.metrics`.
"""

from __future__ import annotations

import numpy as np
import torch

from kaptive_tpu_torch.utils.metrics import count

NEG = -1.0e9  # the gene HMM's clamp, the JAX package's ``-BIG``

# State indices of the gene HMM.
N, C0, C1, C2, I0, I1, I2 = range(7)

# Each state's candidate predecessors in the JAX package's pick order (the
# first candidate wins a tie), with the transition added to each: "" none,
# "entry" entry_b[i], "exit" exit_b[i], "indel" the indel cost, "extend" the
# insertion extension.
GENE_CANDIDATES = (
    ((N, ""), (C2, "exit")),
    ((N, "entry"), (C2, ""), (C1, "indel"), (I2, "")),
    ((C0, ""), (C2, "indel"), (I0, "")),
    ((C1, ""), (C0, "indel"), (I1, "")),
    ((C0, "indel"), (I0, "extend")),
    ((C1, "indel"), (I1, "extend")),
    ((C2, "indel"), (I2, "extend")),
)
_WIDTH = max(len(c) for c in GENE_CANDIDATES)


def chain_bounds(offsets: torch.Tensor, total: int) -> np.ndarray:
    r"""``offsets`` as int64 numpy bounds, checked: 1-D, non-decreasing, from 0 to ``total`` rows."""
    bounds = offsets.cpu().numpy().astype(np.int64)
    if bounds.ndim != 1 or len(bounds) < 1 or bounds[0] != 0 or (np.diff(bounds) < 0).any() or bounds[-1] != total:
        raise ValueError(f"offsets must be a non-decreasing 1-D tensor from 0 to the inputs' {total} rows")
    return bounds


def gene_viterbi_plain(
    codemit: torch.Tensor, entry_b: torch.Tensor, exit_b: torch.Tensor, offsets: torch.Tensor,
    *, indel: float, ins_extend: float,
) -> torch.Tensor:
    r"""Plain PyTorch gene-HMM Viterbi: (sum Lp,) int8 states.

    Chain ``c`` is ``[offsets[c], offsets[c + 1])`` of the three float32
    inputs.  A step picks each state's best predecessor among its
    :data:`GENE_CANDIDATES` (first wins a tie), adds ``codemit`` to C2, clamps
    at ``NEG`` and subtracts the row maximum; the last state is the first
    argmax and the backpointers are walked back from it.
    """
    count("viterbi.plain.gene")
    total = codemit.shape[0]
    bounds = chain_bounds(offsets, total)
    lengths = np.diff(bounds)
    states = torch.zeros(total, dtype=torch.int8)
    live = np.flatnonzero(lengths > 0)
    if len(live) == 0:
        return states.to(codemit.device)
    steps = int(lengths.max())
    f32 = torch.float32

    def per_chain(x):  # (chains, steps), zero past each chain's end
        out = torch.zeros((len(live), steps), dtype=f32)
        for r, c in enumerate(live):
            out[r, : lengths[c]] = x[bounds[c]: bounds[c + 1]].to("cpu", f32)
        return out

    ce, eb, xb = per_chain(codemit), per_chain(entry_b), per_chain(exit_b)
    C = len(live)
    src = torch.zeros((7, _WIDTH), dtype=torch.int64)
    add = torch.full((7, _WIDTH), float("-inf"), dtype=f32)  # absent candidates never win
    cost = {"": 0.0, "indel": indel, "extend": ins_extend, "entry": 0.0, "exit": 0.0}
    for s, cands in enumerate(GENE_CANDIDATES):
        for j, (p, kind) in enumerate(cands):
            src[s, j] = p
            add[s, j] = cost[kind]
    # Per step: what each candidate adds (entry and exit vary by position) and
    # what each state adds after its pick (the codon emission, to C2 only).
    adds = add.expand(steps, C, 7, _WIDTH).clone()
    adds[:, :, C0, 0] = eb.T
    adds[:, :, N, 1] = xb.T
    after = torch.zeros((steps, C, 7), dtype=f32)
    after[:, :, C2] = ce.T
    ends: dict[int, list[int]] = {}
    for r, c in enumerate(live):
        ends.setdefault(int(lengths[c]) - 1, []).append(r)

    v = torch.full((C, 7), NEG, dtype=f32)
    v[:, N] = 0.0
    v_last = torch.empty_like(v)
    flat_src = src.reshape(-1)
    picks = []
    for i in range(steps):
        vals, arg = (v.index_select(1, flat_src).view(C, 7, _WIDTH) + adds[i]).max(dim=2)
        vals = (vals + after[i]).clamp_(min=NEG)
        v = vals - vals.amax(dim=1, keepdim=True)
        picks.append(arg)
        if i in ends:
            v_last[ends[i]] = v[ends[i]]

    # Backtrace: each (step, chain, state)'s predecessor, walked from the
    # first argmax of each chain's last scores.
    prev = src.numpy()[np.arange(7), torch.stack(picks).numpy()]  # (steps, chains, 7)
    last = v_last.argmax(dim=1).numpy()
    end_step = lengths[live] - 1
    rows = np.arange(C)
    cur = last.copy()
    out = np.zeros((C, steps), dtype=np.int8)
    for i in range(steps - 1, -1, -1):
        cur = np.where(end_step == i, last, cur)
        out[:, i] = cur
        cur = prev[i, rows, cur]
    out = torch.from_numpy(out)
    for r, c in enumerate(live):
        states[bounds[c]: bounds[c + 1]] = out[r, : lengths[c]]
    return states.to(codemit.device)


def gene_viterbi(
    codemit: torch.Tensor, entry_b: torch.Tensor, exit_b: torch.Tensor, offsets: torch.Tensor,
    *, indel: float, ins_extend: float,
) -> torch.Tensor:
    r"""Gene-HMM Viterbi front door: the Hopper kernel for CUDA tensors, the plain form on the CPU.

    ``codemit``, ``entry_b`` and ``exit_b`` are flat float32 tensors of the
    chains laid end to end; ``offsets`` (chains + 1,) int64 bounds them.
    Returns (sum Lp,) int8 states on the inputs' device.
    """
    if codemit.is_cuda:
        from kaptive_tpu_torch.ops import viterbi_cuda

        return viterbi_cuda.gene_viterbi_cuda(codemit, entry_b, exit_b, offsets,
                                              indel=indel, ins_extend=ins_extend)
    if codemit.device.type != "cpu":
        raise ValueError(f"gene_viterbi: unsupported device {codemit.device}")
    return gene_viterbi_plain(codemit, entry_b, exit_b, offsets, indel=indel, ins_extend=ins_extend)


def arch_viterbi_plain(
    emissions: torch.Tensor, transitions: torch.Tensor, offsets: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    r"""Plain PyTorch architectural Viterbi: ``(paths (sum N,) int32, scores (contigs,) float32)``.

    Contig ``c`` owns rows ``[offsets[c], offsets[c + 1])`` of the (sum N, S)
    float32 ``emissions``; every contig has at least one row.  A step takes,
    for each state, the best of ``prev[p] + transitions[p, s]`` over p = 0 ..
    S-1 (the first p wins a tie) and adds the emission row; the score is the
    last row's POST entry and the path is walked back from POST.
    """
    count("viterbi.plain.arch")
    bounds = chain_bounds(offsets, emissions.shape[0])
    lengths = np.diff(bounds)
    if (lengths < 1).any():
        raise ValueError("arch_viterbi: every contig needs at least one emission row")
    em = emissions.to("cpu", torch.float32)
    trans = transitions.to("cpu", torch.float32)
    S = trans.shape[0]
    paths = np.empty(int(bounds[-1]), dtype=np.int32)
    scores = torch.empty(len(lengths), dtype=torch.float32)
    for c in range(len(lengths)):
        rows = em[bounds[c]: bounds[c + 1]]
        cur = trans[0] + rows[0]
        back = torch.empty((len(rows), S), dtype=torch.int64)
        for i in range(1, len(rows)):
            best, back[i] = (cur[:, None] + trans).max(dim=0)
            cur = best + rows[i]
        scores[c] = cur[S - 1]
        back_np = back.numpy()
        state = S - 1
        path = paths[bounds[c]: bounds[c + 1]]
        path[-1] = state
        for i in range(len(rows) - 1, 0, -1):
            state = back_np[i, state]
            path[i - 1] = state
    return torch.from_numpy(paths).to(emissions.device), scores.to(emissions.device)


def arch_viterbi(
    emissions: torch.Tensor, transitions: torch.Tensor, offsets: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    r"""Architectural Viterbi front door: the Hopper kernel for CUDA tensors, the plain form on the CPU.

    Returns ``(paths (sum N,) int32, scores (contigs,) float32)`` on the inputs' device.
    """
    if emissions.is_cuda:
        from kaptive_tpu_torch.ops import viterbi_cuda

        return viterbi_cuda.arch_viterbi_cuda(emissions, transitions, offsets)
    if emissions.device.type != "cpu":
        raise ValueError(f"arch_viterbi: unsupported device {emissions.device}")
    return arch_viterbi_plain(emissions, transitions, offsets)
