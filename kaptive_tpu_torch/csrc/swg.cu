// Banded Smith-Waterman-Gotoh fill and tracebacks for NVIDIA Hopper (sm_90a).
//
// Replaces kaptive_tpu/ops/swg_pallas.py::_swg_fill_kernel (the Pallas band
// fill), kaptive_tpu/ops/swg.py::_traceback (the XLA while_loop walk) and
// kaptive_tpu/ops/swg.py::_traceback_cigar (the same walk recording BAM CIGAR
// runs).  All compute exactly what the JAX package computes, bit for bit: the
// same band geometry, masks, local reset, tie rules and packed traceback
// bits, so every SwgResult field equals banded_swg_lax's and every CIGAR
// output banded_swg_lax_cigars's.  The plain PyTorch versions live in
// kaptive_tpu_torch/ops/swg.py.
//
// Built by kaptive_tpu_torch/ops/swg_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with a plain C interface, loaded with ctypes.
//
// What bounds the fill on this card, and what the design does about it:
// - The DP is a sequential recurrence over rows: row i needs row i-1's M and
//   D bands.  Nothing of it crosses pairs, so one thread block owns one pair
//   and walks its rows in a loop (the Pallas kernel's sequential row-tile
//   grid axis).  The M and D bands stay in shared memory for the whole walk;
//   only the packed traceback bits (one byte per cell) go to device memory.
// - Inside a row, the horizontal gap state I is a max-plus prefix scan along
//   the band (lazy-F).  Threads own contiguous runs of band lanes; each scans
//   its run, a warp __shfl_up_sync scan combines the run totals, and one
//   shared-memory pass combines the warps.  With the per-row best (a block
//   reduction, lowest lane winning ties) that costs two barriers per row, and
//   those barriers, not arithmetic or bytes, bound the kernel: the cells of
//   one row are a few hundred integer operations.  Pairs run in parallel, one
//   block each, across the SMs.
// - Substitution scores are gathers from the full 256x256 matrix kept as
//   int8 in shared memory (64 KB).  The Pallas kernel factored the matrix
//   into class tables because the TPU has no vector gathers; here the gather
//   is one shared-memory load.
// - Rows past the query's length hold no filled cell and the traceback never
//   reads them: the walk stops at min(q_len, rows_max), and those rows of the
//   traceback output are left unwritten.
//
// Scores stay in int32: NEG_INF = -1e9 plus the unmasked drift of the D
// carry over a few thousand rows stays far inside the int32 range.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG_INF = -1000000000;
constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MATRIX_BYTES = 256 * 256;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MAX_CIGAR_OPS = 256;  // runs kept per pair (ops/swg.py's MAX_CIGAR_OPS)

__host__ __device__ inline size_t fill_smem_bytes(int w_pad) {
    // int8 matrix | M, D, I bands (int32) | warp scan, warp best value, warp
    // best lane (int32) | partial traceback byte per lane
    return MATRIX_BYTES + 3 * sizeof(int32_t) * (size_t)w_pad
           + 3 * sizeof(int32_t) * MAX_WARPS + (size_t)w_pad;
}

// LPT = band lanes per thread (compile time, so the per-lane values carried
// from the scan's first pass to its second stay in registers).
template <int LPT>
__global__ void __launch_bounds__(MAX_THREADS) swg_fill_kernel(
    const uint8_t* __restrict__ q,         // (B, rows_max)
    const uint8_t* __restrict__ t,         // (B, t_cols), left-padded by w_pad + 2
    const int32_t* __restrict__ q_lens,    // (B,)
    const int32_t* __restrict__ t_lens,    // (B,)
    const int32_t* __restrict__ offsets,   // (B,) diagonal offsets q_pos - t_pos
    const int32_t* __restrict__ k_locals,  // (B,) half band widths
    const int8_t* __restrict__ matrix,     // (256, 256)
    int rows_max, int w_pad, int t_cols, int gap_open, int gap_extend,
    uint8_t* __restrict__ tb,              // out (B, rows_max, w_pad)
    int32_t* __restrict__ best_out,        // out (B,)
    int32_t* __restrict__ best_i_out,      // out (B,)
    int32_t* __restrict__ best_j_out) {    // out (B,)
    extern __shared__ __align__(16) unsigned char smem[];
    int8_t* mat = reinterpret_cast<int8_t*>(smem);
    int32_t* M = reinterpret_cast<int32_t*>(smem + MATRIX_BYTES);
    int32_t* D = M + w_pad;
    int32_t* I = D + w_pad;
    int32_t* warp_scan = I + w_pad;
    int32_t* warp_best = warp_scan + MAX_WARPS;
    int32_t* warp_lane = warp_best + MAX_WARPS;
    uint8_t* tb_part = reinterpret_cast<uint8_t*>(warp_lane + MAX_WARPS);

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int lane_id = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = nthreads >> 5;

    {
        const int4* src = reinterpret_cast<const int4*>(matrix);
        int4* dst = reinterpret_cast<int4*>(mat);
        for (int x = tid; x < MATRIX_BYTES / 16; x += nthreads) dst[x] = src[x];
    }

    const int l1 = q_lens[b];
    const int cols = t_lens[b] + 1;
    const int off = offsets[b];
    const int kl = k_locals[b];
    const int k_pad = (w_pad - 3) / 2;
    const int goe = gap_open + gap_extend;
    const int ge = gap_extend;
    const int lo = tid * LPT;  // this thread's lanes: [lo, lo + LPT) within w_pad
    const uint8_t* qb = q + (size_t)b * rows_max;
    const uint8_t* tt = t + (size_t)b * t_cols;
    uint8_t* tbb = tb + (size_t)b * rows_max * w_pad;

    // Row 0: padded-band border cells get M=0, everything else -INF.
    for (int dm = tid; dm < w_pad; dm += nthreads) {
        const int j0 = dm - off - k_pad - 1;
        const bool in_pad0 = abs(dm - (k_pad + 1)) <= kl + 1 && j0 >= 0 && j0 < cols;
        M[dm] = in_pad0 ? 0 : NEG_INF;
        D[dm] = NEG_INF;
    }
    __syncthreads();

    int best = 0, best_i = 0, best_j = 0;
    const int n_rows = min(l1, rows_max);
    for (int i = 1; i <= n_rows; ++i) {
        const int8_t* mrow = mat + 256 * (int)qb[i - 1];
        const int j_base = i - off - k_pad - 1;  // + dm: 1-based DP column of lane dm
        const int t_base = i - off + w_pad - k_pad;  // + dm: target window index

        // Pass 1: D, diagonal, H; this thread's share of the prefix max.
        int h_ng[LPT], d_cur[LPT], flags[LPT];
        int run_total = NEG_INF;
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
            const int dm = lo + k;
            if (dm < w_pad) {
                const int j = j_base + dm;
                const int band = abs(dm - (k_pad + 1));
                const bool in_cols = j >= 0 && j < cols;
                const bool filled = band <= kl && j >= 1 && in_cols;
                const bool in_pad = band <= kl + 1 && in_cols;
                // Vertical gap from the previous row's dm+1 lane (unmasked carry).
                const int m_up = dm + 1 < w_pad ? M[dm + 1] : NEG_INF;
                const int d_up = dm + 1 < w_pad ? D[dm + 1] : NEG_INF;
                const int d_open = m_up - goe;
                const int d_ext = d_up - ge;
                d_cur[k] = max(d_open, d_ext);
                const int ti = min(max(t_base + dm, 0), t_cols - 1);
                const int diag = M[dm] + mrow[tt[ti]];
                h_ng[k] = max(diag, d_cur[k]);
                const int h_c = filled ? max(h_ng[k], 0) : (in_pad ? 0 : NEG_INF);
                flags[k] = (d_cur[k] > diag ? 1 : 0)      // tb_m candidate: D beats diagonal
                           | (d_open < d_ext ? 4 : 0)      // open wins ties
                           | (filled ? 16 : 0) | (in_pad ? 32 : 0);
                run_total = max(run_total, h_c + dm * ge);
            }
        }

        // Block-wide exclusive max-scan of the run totals.
        int incl = run_total;
#pragma unroll
        for (int s = 1; s < 32; s <<= 1) {
            const int other = __shfl_up_sync(FULL_MASK, incl, s);
            if (lane_id >= s) incl = max(incl, other);
        }
        int prefix = __shfl_up_sync(FULL_MASK, incl, 1);
        if (lane_id == 0) prefix = NEG_INF;
        if (lane_id == 31) warp_scan[warp] = incl;
        __syncthreads();
        for (int w = 0; w < warp; ++w) prefix = max(prefix, warp_scan[w]);

        // Pass 2: I, M, the traceback's M-state bits, this thread's row best.
        int row_best = INT32_MIN, row_lane = w_pad;
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
            const int dm = lo + k;
            if (dm < w_pad) {
                const bool filled = flags[k] & 16;
                const bool in_pad = flags[k] & 32;
                const int h_c = filled ? max(h_ng[k], 0) : (in_pad ? 0 : NEG_INF);
                const int i_cur = filled ? prefix - gap_open - dm * ge : NEG_INF;
                prefix = max(prefix, h_c + dm * ge);
                const int m_cur = filled ? max(max(h_c, i_cur), 0) : (in_pad ? 0 : NEG_INF);
                int tb_m = flags[k] & 1;
                if (i_cur > h_ng[k]) tb_m = 2;
                if (max(h_ng[k], i_cur) <= 0 || !filled) tb_m = 3;
                M[dm] = m_cur;
                D[dm] = d_cur[k];
                I[dm] = i_cur;
                tb_part[dm] = (uint8_t)(tb_m | (flags[k] & 4));
                if (filled && m_cur > row_best) {
                    row_best = m_cur;
                    row_lane = dm;
                }
            }
        }
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) {
            const int v = __shfl_down_sync(FULL_MASK, row_best, s);
            const int l = __shfl_down_sync(FULL_MASK, row_lane, s);
            if (v > row_best || (v == row_best && l < row_lane)) {
                row_best = v;
                row_lane = l;
            }
        }
        if (lane_id == 0) {
            warp_best[warp] = row_best;
            warp_lane[warp] = row_lane;
        }
        __syncthreads();

        // Strictly-greater best update; the first lane of the row wins ties.
        row_best = warp_best[0];
        row_lane = warp_lane[0];
        for (int w = 1; w < nwarps; ++w) {
            if (warp_best[w] > row_best) {
                row_best = warp_best[w];
                row_lane = warp_lane[w];
            }
        }
        if (row_best > best) {
            best = row_best;
            best_i = i;
            best_j = j_base + row_lane;
        }

        // Pass 3: the I-state bit needs the left neighbour's final M and I.
        uint8_t* tb_row = tbb + (size_t)(i - 1) * w_pad;
        for (int dm = tid; dm < w_pad; dm += nthreads) {
            const int m_left = dm > 0 ? M[dm - 1] : NEG_INF;
            const int i_left = dm > 0 ? I[dm - 1] : NEG_INF;
            tb_row[dm] = tb_part[dm] | (m_left - goe < i_left - ge ? 8 : 0);
        }
        // The next row writes M, D, I and tb_part only after its first
        // barrier, which every thread reaches after finishing this pass.
    }
    if (tid == 0) {
        best_out[b] = best;
        best_i_out[b] = best_i;
        best_j_out[b] = best_j;
    }
}

// One thread per pair replays the traceback state machine (0 = in M,
// 1 = in D, 2 = in I) over the packed bits, from the best cell back to a
// local-alignment start.
__global__ void swg_traceback_kernel(
    const uint8_t* __restrict__ tb, const uint8_t* __restrict__ q,
    const uint8_t* __restrict__ t, const int32_t* __restrict__ best,
    const int32_t* __restrict__ best_i, const int32_t* __restrict__ best_j,
    const int32_t* __restrict__ offsets, int n_pairs, int rows_max, int w_pad,
    int t_cols, int t_pad,
    int32_t* __restrict__ out) {  // (8, B): score, matches, mismatches, gaps, q/t starts+ends
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= n_pairs) return;
    const int k_pad = (w_pad - 3) / 2;
    const uint8_t* tbb = tb + (size_t)b * rows_max * w_pad;
    const uint8_t* qb = q + (size_t)b * rows_max;
    const uint8_t* tt = t + (size_t)b * t_cols;
    const int off = offsets[b];
    int i = best_i[b], j = best_j[b];
    int state = 0, matches = 0, mismatches = 0, gaps = 0;
    while (i > 0 && j > 0) {
        const int r = min(max(i - 1, 0), rows_max - 1);
        const int dm = min(max(j - (i - off) + k_pad + 1, 0), w_pad - 1);
        const int cell = tbb[(size_t)r * w_pad + dm];
        if (state == 0) {
            const int tb_m = cell & 3;
            if (tb_m == 3) break;
            if (tb_m == 0) {
                const int tc = tt[min(max(j - 1 + t_pad, 0), t_cols - 1)];
                if (qb[r] == tc) ++matches; else ++mismatches;
                --i;
                --j;
            } else {
                state = tb_m;  // 1: into D, 2: into I (no move on the transition)
            }
        } else if (state == 1) {
            ++gaps;
            --i;
            if (!((cell >> 2) & 1)) state = 0;
        } else {
            ++gaps;
            --j;
            if (!((cell >> 3) & 1)) state = 0;
        }
    }
    out[0 * n_pairs + b] = best[b];
    out[1 * n_pairs + b] = matches;
    out[2 * n_pairs + b] = mismatches;
    out[3 * n_pairs + b] = gaps;
    out[4 * n_pairs + b] = i;
    out[5 * n_pairs + b] = best_i[b];
    out[6 * n_pairs + b] = j;
    out[7 * n_pairs + b] = best_j[b];
}

// swg_traceback_kernel's walk, also recording BAM CIGAR runs (M=0 on the
// diagonal, I=1 in the vertical D state, D=2 in the horizontal I state; a
// transition step emits none).  The walk goes end to start, so each pair's
// runs are written in that order into its own row of `ops` in device memory
// and the valid prefix is reversed in place at the end; the rest of the row
// is zeroed.  A run past `MAX_CIGAR_OPS` overwrites the last slot, as the JAX
// package's buffer does, and sets the pair's overflow flag.  Like the plain
// traceback this is a serial walk per pair: a thread's rows of `ops` are
// 1 KB apart, so its writes do not coalesce, but there is one write per run,
// not per step, and the walk's dependent loads of the traceback bits bound it.
__global__ void swg_traceback_cigar_kernel(
    const uint8_t* __restrict__ tb, const uint8_t* __restrict__ q,
    const uint8_t* __restrict__ t, const int32_t* __restrict__ best,
    const int32_t* __restrict__ best_i, const int32_t* __restrict__ best_j,
    const int32_t* __restrict__ offsets, int n_pairs, int rows_max, int w_pad,
    int t_cols, int t_pad,
    int32_t* __restrict__ out,        // (8, B) as swg_traceback_kernel's
    int32_t* __restrict__ ops,        // (B, MAX_CIGAR_OPS) BAM runs, len << 4 | op
    int32_t* __restrict__ n_ops_out,  // (B,) runs kept, min(runs, MAX_CIGAR_OPS)
    uint8_t* __restrict__ overflow) { // (B,) more than MAX_CIGAR_OPS runs
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= n_pairs) return;
    const int k_pad = (w_pad - 3) / 2;
    const uint8_t* tbb = tb + (size_t)b * rows_max * w_pad;
    const uint8_t* qb = q + (size_t)b * rows_max;
    const uint8_t* tt = t + (size_t)b * t_cols;
    int32_t* ob = ops + (size_t)b * MAX_CIGAR_OPS;
    const int off = offsets[b];
    int i = best_i[b], j = best_j[b];
    int state = 0, matches = 0, mismatches = 0, gaps = 0;
    int cur_op = -1, run = 0, ptr = 0;  // the open run; runs emitted so far
    while (i > 0 && j > 0) {
        const int r = min(max(i - 1, 0), rows_max - 1);
        const int dm = min(max(j - (i - off) + k_pad + 1, 0), w_pad - 1);
        const int cell = tbb[(size_t)r * w_pad + dm];
        int step_op = -1;
        if (state == 0) {
            const int tb_m = cell & 3;
            if (tb_m == 3) break;
            if (tb_m == 0) {
                const int tc = tt[min(max(j - 1 + t_pad, 0), t_cols - 1)];
                if (qb[r] == tc) ++matches; else ++mismatches;
                --i;
                --j;
                step_op = 0;
            } else {
                state = tb_m;  // 1: into D, 2: into I (no move on the transition)
            }
        } else if (state == 1) {
            ++gaps;
            --i;
            step_op = 1;
            if (!((cell >> 2) & 1)) state = 0;
        } else {
            ++gaps;
            --j;
            step_op = 2;
            if (!((cell >> 3) & 1)) state = 0;
        }
        if (step_op >= 0) {
            if (step_op != cur_op) {
                if (cur_op >= 0) ob[min(ptr++, MAX_CIGAR_OPS - 1)] = (run << 4) | cur_op;
                run = 1;
                cur_op = step_op;
            } else {
                ++run;
            }
        }
    }
    if (cur_op >= 0) ob[min(ptr++, MAX_CIGAR_OPS - 1)] = (run << 4) | cur_op;  // the final run
    const int n = min(ptr, MAX_CIGAR_OPS);
    for (int lo = 0, hi = n - 1; lo < hi; ++lo, --hi) {
        const int32_t x = ob[lo];
        ob[lo] = ob[hi];
        ob[hi] = x;
    }
    for (int k = n; k < MAX_CIGAR_OPS; ++k) ob[k] = 0;
    out[0 * n_pairs + b] = best[b];
    out[1 * n_pairs + b] = matches;
    out[2 * n_pairs + b] = mismatches;
    out[3 * n_pairs + b] = gaps;
    out[4 * n_pairs + b] = i;
    out[5 * n_pairs + b] = best_i[b];
    out[6 * n_pairs + b] = j;
    out[7 * n_pairs + b] = best_j[b];
    n_ops_out[b] = n;
    overflow[b] = ptr > MAX_CIGAR_OPS ? 1 : 0;
}

template <int LPT>
cudaError_t launch_fill(int n_pairs, int w_pad, cudaStream_t stream, const uint8_t* q,
                        const uint8_t* t, const int32_t* q_lens, const int32_t* t_lens,
                        const int32_t* offsets, const int32_t* k_locals,
                        const int8_t* matrix, int rows_max, int t_cols, int gap_open,
                        int gap_extend, uint8_t* tb, int32_t* best, int32_t* best_i,
                        int32_t* best_j) {
    const size_t smem = fill_smem_bytes(w_pad);
    cudaError_t err = cudaFuncSetAttribute(
        swg_fill_kernel<LPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int threads = (((w_pad + LPT - 1) / LPT) + 31) / 32 * 32;
    swg_fill_kernel<LPT><<<n_pairs, threads, smem, stream>>>(
        q, t, q_lens, t_lens, offsets, k_locals, matrix, rows_max, w_pad, t_cols, gap_open,
        gap_extend, tb, best, best_i, best_j);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest band the fill takes (16 lanes for each of 512 threads).
int kts_swg_max_w_pad() { return 16 * MAX_THREADS; }

int kts_swg_fill(const void* q, const void* t, const void* q_lens, const void* t_lens,
                 const void* offsets, const void* k_locals, const void* matrix,
                 int n_pairs, int rows_max, int w_pad, int t_cols, int gap_open,
                 int gap_extend, void* tb, void* best, void* best_i, void* best_j,
                 void* stream) {
    if (n_pairs == 0) return (int)cudaSuccess;
    if (w_pad < 3 || w_pad > kts_swg_max_w_pad() || rows_max < 1 || t_cols < 1)
        return (int)cudaErrorInvalidValue;
    const auto s = static_cast<cudaStream_t>(stream);
#define KTS_FILL(LPT)                                                                      \
    launch_fill<LPT>(n_pairs, w_pad, s, static_cast<const uint8_t*>(q),                   \
                     static_cast<const uint8_t*>(t), static_cast<const int32_t*>(q_lens), \
                     static_cast<const int32_t*>(t_lens),                                 \
                     static_cast<const int32_t*>(offsets),                                \
                     static_cast<const int32_t*>(k_locals),                               \
                     static_cast<const int8_t*>(matrix), rows_max, t_cols, gap_open,      \
                     gap_extend, static_cast<uint8_t*>(tb), static_cast<int32_t*>(best),  \
                     static_cast<int32_t*>(best_i), static_cast<int32_t*>(best_j))
    cudaError_t err;
    if (w_pad <= MAX_THREADS) err = KTS_FILL(1);
    else if (w_pad <= 2 * MAX_THREADS) err = KTS_FILL(2);
    else if (w_pad <= 4 * MAX_THREADS) err = KTS_FILL(4);
    else if (w_pad <= 8 * MAX_THREADS) err = KTS_FILL(8);
    else err = KTS_FILL(16);
#undef KTS_FILL
    return (int)err;
}

int kts_swg_traceback(const void* tb, const void* q, const void* t, const void* best,
                      const void* best_i, const void* best_j, const void* offsets,
                      int n_pairs, int rows_max, int w_pad, int t_cols, int t_pad, void* out,
                      void* stream) {
    if (n_pairs == 0) return (int)cudaSuccess;
    const int threads = 128;
    swg_traceback_kernel<<<(n_pairs + threads - 1) / threads, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(tb), static_cast<const uint8_t*>(q),
        static_cast<const uint8_t*>(t), static_cast<const int32_t*>(best),
        static_cast<const int32_t*>(best_i), static_cast<const int32_t*>(best_j),
        static_cast<const int32_t*>(offsets), n_pairs, rows_max, w_pad, t_cols, t_pad,
        static_cast<int32_t*>(out));
    return (int)cudaGetLastError();
}

int kts_swg_traceback_cigar(const void* tb, const void* q, const void* t, const void* best,
                            const void* best_i, const void* best_j, const void* offsets,
                            int n_pairs, int rows_max, int w_pad, int t_cols, int t_pad,
                            void* out, void* ops, void* n_ops, void* overflow,
                            void* stream) {
    if (n_pairs == 0) return (int)cudaSuccess;
    const int threads = 128;
    swg_traceback_cigar_kernel<<<(n_pairs + threads - 1) / threads, threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(tb), static_cast<const uint8_t*>(q),
        static_cast<const uint8_t*>(t), static_cast<const int32_t*>(best),
        static_cast<const int32_t*>(best_i), static_cast<const int32_t*>(best_j),
        static_cast<const int32_t*>(offsets), n_pairs, rows_max, w_pad, t_cols, t_pad,
        static_cast<int32_t*>(out), static_cast<int32_t*>(ops), static_cast<int32_t*>(n_ops),
        static_cast<uint8_t*>(overflow));
    return (int)cudaGetLastError();
}

}  // extern "C"
