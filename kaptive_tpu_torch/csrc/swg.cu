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
// What bounds each kernel on this card, and what the design does about it:
//
// The fill.  The DP is a sequential recurrence over rows (row i needs row
// i-1's M and D bands) and a row is only a few hundred integer operations, so
// neither bytes nor arithmetic bound it: the chain of latencies inside one row
// does, times the number of rows.  Four forms, chosen from w_pad and the
// matrix's type (int8 when every score fits, as BLOSUM62's and the mapper's do):
// - Warp form (w_pad a multiple of 128 up to 1024, the widths the lattices
//   produce): ONE WARP owns one pair and each thread owns w_pad / 32
//   contiguous band lanes.  M and D stay in registers from row to row; the
//   lane dm+1 of the row above, the left neighbour's I-extension bit and the
//   next target byte of the thread's sliding window each come by one
//   __shfl.  The lazy-F max-plus scan is the thread's serial run plus a
//   five-step warp shuffle scan.  The row loop has no __syncthreads(), no
//   shared-memory band and no dependent global load: the next 32 query bytes
//   and the next 32 bytes entering the target window are fetched with one
//   coalesced load each, a whole stage (32 rows) ahead of use, and handed out
//   by __shfl.  The best cell leaves the loop: each lane keeps its own best
//   (strictly greater, so its earliest row and lowest lane win) and the warp
//   reduces once at the end by (highest value, lowest row, lowest lane), which
//   is the cell the per-row rule picks.  With the latencies gone a row is
//   bound by instruction issue (a few hundred instructions a warp), so the
//   arithmetic per cell is cut to what each value is used for (see the
//   kernel) and four pairs share a block, one warp for each of the SM's four
//   schedulers, and one 64 KB int8 copy of the substitution matrix; up to
//   three blocks fit an SM.  A block whose pairs are all empty exits before it
//   loads the matrix.  Traceback bits leave as 4-32 bytes a thread, whole
//   128-byte lines a row.
// - Wide form (any other w_pad up to 8192): one block owns one pair, the
//   bands live in shared memory, threads own runs of lanes, and each row pays
//   two block barriers (scan and per-row best).  Kept for bands a warp cannot
//   hold in registers.
// - Cluster form (w_pad past 8192, which the planner emits as 32,768 and
//   131,072, and any matrix with a score outside int8, up to 131,072 lanes):
//   the band stays in registers, one warp a pair up to 512 lanes, else a
//   thread-block cluster of up to 16 CTAs a pair that exchange the scan's
//   totals and their edge lanes through distributed shared memory, one block
//   barrier and one cluster barrier a row (see swg_fill_cluster_kernel).
// - Segmented form (past the largest cluster: the planner's 524,288): the
//   wide form's arithmetic over a band kept in device scratch between rows
//   and walked in segments of 8,192 lanes staged in shared memory (see
//   swg_fill_segmented_kernel).
// - Substitution scores are gathers from the full 256x256 matrix, kept as
//   int8 in shared memory (64 KB) by the warp and wide forms and read as
//   int32 through L1 by the cluster and segmented forms.  The Pallas kernel
//   factored the matrix into class tables because the TPU has no vector
//   gathers; here the gather is one load.
// - Rows past the query's length hold no filled cell and the traceback never
//   reads them: the walk stops at min(q_len, rows_max), and those rows of the
//   traceback output are left unwritten.
//
// The traceback.  A walk is a chain of dependent loads of one traceback byte
// per step, each a round trip to L2: latency bounds it, not bytes.  ONE WARP
// walks one pair and reads a stretch of the walk at once: in state M the next
// 32 cells lie on one diagonal, in D on one column, in I on one row, so the
// lanes load their bytes together, __ballot_sync finds the first lane whose
// cell leaves the run, matches are a __popc of the q == t ballot below that
// lane, and the walk jumps the whole run.  A transition re-reads the same cell
// in the new state.  The clamps of the row, the band lane and the target
// index are those of a walk taken one step at a time.  There is one walk in
// this file (walk_pair): the count-only kernel and the CIGAR kernel are its
// two instances, so they cannot drift apart.  The CIGAR instance adds a run
// recorder that is the same in every lane: a stretch lengthens the open run
// or closes it, closed runs are staged in shared memory, and the warp writes
// the pair's 1 KB row of `ops` once, reversed and zero-filled, as whole
// 128-byte lines.  Its bound (a few hundred KB moved) is below a launch's own
// few microseconds; what it costs above the count-only walk is that row.
//
// Scores stay in int32: NEG_INF = -1e9 plus the unmasked drift of the D
// carry over a few thousand rows stays far inside the int32 range.

#include <algorithm>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG_INF = -1000000000;
constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MATRIX_BYTES = 256 * 256;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MAX_CIGAR_OPS = 256;  // runs kept per pair (ops/swg.py's MAX_CIGAR_OPS)
constexpr int WARP_FORM_MAX_W_PAD = 1024;  // 32 band lanes a thread: M and D fit in registers without spills
constexpr int FILL_WARPS = 4;       // pairs per block in the fill's warp form: one warp per scheduler
constexpr int TRACEBACK_WARPS = 4;  // pairs per block in the traceback

__host__ __device__ inline size_t fill_smem_bytes(int w_pad) {
    // int8 matrix | M, D, I bands (int32) | warp scan, warp best value, warp
    // best lane (int32) | partial traceback byte per lane
    return MATRIX_BYTES + 3 * sizeof(int32_t) * (size_t)w_pad
           + 3 * sizeof(int32_t) * MAX_WARPS + (size_t)w_pad;
}

// The low n bits set, for n clamped into [0, 32].
__device__ __forceinline__ uint32_t low_bits(int n) {
    return n <= 0 ? 0u : (n >= 32 ? FULL_MASK : (1u << n) - 1u);
}

// Warp form of the fill: one warp per pair, LPT = w_pad / 32 band lanes per
// thread in registers (see the note at the head of the file).  The row's
// arithmetic is the wide form's, reduced to what each value is used for:
// - filled and in_pad are bit masks over the thread's lanes, computed once a
//   row from the lane range whose column lies in [1, cols) or [0, cols);
// - the lazy-F scan runs in the band lane's own frame: P(dm) is the best
//   H(dm') - (dm - dm') * gap_extend over dm' < dm, so one lane further
//   P <- max(P, H) - gap_extend and I = P - gap_open, with no per-lane offset;
//   across threads the carry decays by LPT * gap_extend a thread;
// - H >= 0 in filled cells, so M = max(H, I); an unfilled cell keeps its
//   border value (0 or -INF) as M, is never above the running best, and its
//   traceback code is 3 because M <= 0; in a cell that does not stop,
//   I > H decides the code exactly as I > max(diag, D) does.
template <int LPT>
__global__ void __launch_bounds__(FILL_WARPS * 32) swg_fill_warp_kernel(
    const uint8_t* __restrict__ q,         // (B, rows_max)
    const uint8_t* __restrict__ t,         // (B, t_cols), left-padded by w_pad + 2
    const int32_t* __restrict__ q_lens,    // (B,)
    const int32_t* __restrict__ t_lens,    // (B,)
    const int32_t* __restrict__ offsets,   // (B,) diagonal offsets q_pos - t_pos
    const int32_t* __restrict__ k_locals,  // (B,) half band widths
    const int8_t* __restrict__ matrix,     // (256, 256)
    int n_pairs, int rows_max, int t_cols, int gap_open, int gap_extend,
    uint8_t* __restrict__ tb,              // out (B, rows_max, w_pad)
    int32_t* __restrict__ best_out,        // out (B,)
    int32_t* __restrict__ best_i_out,      // out (B,)
    int32_t* __restrict__ best_j_out) {    // out (B,)
    static_assert(LPT % 4 == 0 && LPT >= 4 && LPT <= 32, "LPT is a multiple of 4 up to 32");
    constexpr int W_PAD = 32 * LPT;
    constexpr int K_PAD = (W_PAD - 3) / 2;
    constexpr int WORDS = LPT / 4;
    extern __shared__ __align__(16) unsigned char smem[];
    int8_t* mat = reinterpret_cast<int8_t*>(smem);

    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * FILL_WARPS + (threadIdx.x >> 5);
    const bool has_pair = b < n_pairs;
    const int n_rows = has_pair ? min(q_lens[b], rows_max) : 0;
    const bool block_live = __syncthreads_or(n_rows > 0);
    if (block_live) {
        const int4* src = reinterpret_cast<const int4*>(matrix);
        int4* dst = reinterpret_cast<int4*>(mat);
        for (int x = threadIdx.x; x < MATRIX_BYTES / 16; x += FILL_WARPS * 32) dst[x] = src[x];
        __syncthreads();
    }
    if (n_rows <= 0) {  // an empty pair, or no pair: no row, best stays (0, 0, 0)
        if (has_pair && lane == 0) {
            best_out[b] = 0;
            best_i_out[b] = 0;
            best_j_out[b] = 0;
        }
        return;
    }

    const int cols = t_lens[b] + 1;
    const int off = offsets[b];
    const int kl = k_locals[b];
    const int ge = gap_extend;
    const int lo = lane * LPT;  // this thread's lanes: [lo, lo + LPT)
    const uint8_t* qb = q + (size_t)b * rows_max;
    const uint8_t* tt = t + (size_t)b * t_cols;
    uint8_t* tbb = tb + (size_t)b * rows_max * W_PAD + lo;

    // Row 0: padded-band border cells get M=0, everything else -INF.  The band
    // masks are per lane and do not change with the row.  The target window
    // starts one position before row 1's: every row begins by sliding it.
    int M[LPT], D[LPT];
    uint32_t in_kl = 0, in_kl1 = 0;  // bit k: |dm - (k_pad + 1)| <= kl, <= kl + 1
    uint32_t tcw[WORDS];             // the thread's LPT target bytes, lane k in byte k
#pragma unroll
    for (int w = 0; w < WORDS; ++w) tcw[w] = 0;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
        const int dm = lo + k;
        const int band = abs(dm - (K_PAD + 1));
        in_kl |= (band <= kl ? 1u : 0u) << k;
        in_kl1 |= (band <= kl + 1 ? 1u : 0u) << k;
        const int j0 = dm - off - K_PAD - 1;
        M[k] = (band <= kl + 1 && j0 >= 0 && j0 < cols) ? 0 : NEG_INF;
        D[k] = NEG_INF;
        const int p0 = min(max(W_PAD - K_PAD - off + dm, 0), t_cols - 1);  // row 0's window index
        tcw[k >> 2] |= (uint32_t)tt[p0] << (8 * (k & 3));
    }

    // Stage s serves rows 32 s + 1 .. 32 s + 32: lane l holds row 32 s + 1 + l's
    // query byte and the target byte that enters the window's last lane there.
    const int t_in_base = 2 * W_PAD - K_PAD - off;  // + (i - 1): index of lane w_pad-1 in row i
    int q_next = qb[min(lane, rows_max - 1)];
    int t_next = tt[min(max(t_in_base + lane, 0), t_cols - 1)];
    int q_cur = 0, t_cur = 0;

    // The next thread's lane 0 of the row above (-INF past the band's end),
    // fetched as soon as a row has its own: the first thing the next row needs.
    int m_nb = __shfl_down_sync(FULL_MASK, M[0], 1);
    int d_nb = NEG_INF;
    if (lane == 31) m_nb = NEG_INF;
    const int thread_step = LPT * ge;            // what the scan's carry loses from one thread to the next
    const int lane_frame = (lane + 1) * thread_step;

    int best = 0, best_pos = 0;  // best_pos = i * W_PAD + dm: lowest row, then lowest lane
    for (int i = 1; i <= n_rows; ++i) {
        const int sl = (i - 1) & 31;
        if (sl == 0) {  // a new stage: take what was fetched 32 rows ago, fetch the next
            q_cur = q_next;
            t_cur = t_next;
            q_next = qb[min(i + 31 + lane, rows_max - 1)];
            t_next = tt[min(max(t_in_base + i + 31 + lane, 0), t_cols - 1)];
        }
        const int qc = __shfl_sync(FULL_MASK, q_cur, sl);
        const int t_in = __shfl_sync(FULL_MASK, t_cur, sl);
        const uint32_t t_nb = __shfl_down_sync(FULL_MASK, tcw[0], 1);
        // Slide the target window one position: byte k <- byte k + 1.
#pragma unroll
        for (int w = 0; w + 1 < WORDS; ++w) tcw[w] = __funnelshift_r(tcw[w], tcw[w + 1], 8);
        tcw[WORDS - 1] = (tcw[WORDS - 1] >> 8) | ((lane == 31 ? (uint32_t)t_in : (t_nb & 0xffu)) << 24);

        const int8_t* mrow = mat + 256 * qc;
        const int j_lo = i - off - K_PAD - 1 + lo;  // 1-based DP column of this thread's lane 0
        const uint32_t in_cols = low_bits(cols - j_lo);
        const uint32_t f_filled = in_kl & in_cols & ~low_bits(1 - j_lo);
        const uint32_t f_pad = in_kl1 & in_cols & ~low_bits(-j_lo);

        // Pass 1: D, diagonal, H (kept in M[k]: the row above's M[k] is dead
        // once lane k - 1 and lane k have read it); the thread's own scan.
        uint32_t f_dgt = 0, f_ext = 0;
        int carry = NEG_INF;  // P after the thread's last lane, had nothing come in from the left
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
            // Vertical gap from the previous row's dm+1 lane (unmasked carry).
            const int d_open = (k + 1 < LPT ? M[k + 1] : m_nb) - gap_open;  // both less gap_extend, below
            const int d_ext = k + 1 < LPT ? D[k + 1] : d_nb;
            const int d_cur = max(d_open, d_ext) - ge;
            const int tc = (tcw[k >> 2] >> (8 * (k & 3))) & 0xffu;
            const int diag = M[k] + mrow[tc];
            D[k] = d_cur;  // D[k] of the row above was read at k - 1
            f_dgt |= (d_cur > diag ? 1u : 0u) << k;   // tb_m candidate: D beats diagonal
            f_ext |= (d_open < d_ext ? 1u : 0u) << k;  // open wins ties
            const int border = (f_pad >> k) & 1u ? 0 : NEG_INF;
            const int h_c = (f_filled >> k) & 1u ? max(max(diag, d_cur), 0) : border;
            M[k] = h_c;
            carry = max(carry, h_c) - ge;
        }

        const int d_nb_next = __shfl_down_sync(FULL_MASK, D[0], 1);  // for the next row, off its critical path

        // Warp-wide exclusive max-plus scan of the carries.  One thread further
        // costs LPT * gap_extend: in the frame of thread 0 that is a plain
        // max-scan (a lane below the shuffle distance gets its own value back).
        int incl = carry + lane_frame;
#pragma unroll
        for (int s = 1; s < 32; s <<= 1) incl = max(incl, __shfl_up_sync(FULL_MASK, incl, s));
        int P = __shfl_up_sync(FULL_MASK, incl, 1) - lane_frame + thread_step;
        if (lane == 0) P = NEG_INF;

        // Pass 2: I, M, the traceback bits, this thread's running best.
        uint32_t tbw[WORDS];
#pragma unroll
        for (int w = 0; w < WORDS; ++w) tbw[w] = 0;
        uint32_t i_ext_left = 0;  // the I-state bit of lane k: its left neighbour's final M and I
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
            const int h_c = M[k];
            const int i_cur = (f_filled >> k) & 1u ? P - gap_open : NEG_INF;
            P = max(P, h_c) - ge;
            const int m_cur = max(h_c, i_cur);
            const uint32_t tb_m = m_cur <= 0 ? 3u : (i_cur > h_c ? 2u : (f_dgt >> k) & 1u);
            M[k] = m_cur;
            tbw[k >> 2] |= (tb_m | (((f_ext >> k) & 1u) << 2) | (i_ext_left << 3)) << (8 * (k & 3));
            i_ext_left = m_cur - i_cur < gap_open ? 1u : 0u;  // M - open - extend < I - extend
            if (m_cur > best) {  // strictly greater: earliest row, then lowest lane
                best = m_cur;
                best_pos = i * W_PAD + lo + k;
            }
        }
        m_nb = __shfl_down_sync(FULL_MASK, M[0], 1);
        d_nb = d_nb_next;
        if (lane == 31) {
            m_nb = NEG_INF;
            d_nb = NEG_INF;
        }
        uint32_t i_ext_nb = __shfl_up_sync(FULL_MASK, i_ext_left, 1);  // the previous thread's last lane
        if (lane == 0) i_ext_nb = gap_open > 0 ? 1u : 0u;  // lane 0's left neighbour: M = I = -INF
        tbw[0] |= i_ext_nb << 3;

        uint8_t* tb_row = tbb + (size_t)(i - 1) * W_PAD;
        if constexpr (LPT % 16 == 0) {
#pragma unroll
            for (int w = 0; w < WORDS; w += 4)
                *reinterpret_cast<uint4*>(tb_row + 4 * w) = make_uint4(tbw[w], tbw[w + 1], tbw[w + 2], tbw[w + 3]);
        } else if constexpr (LPT % 8 == 0) {
#pragma unroll
            for (int w = 0; w < WORDS; w += 2)
                *reinterpret_cast<uint2*>(tb_row + 4 * w) = make_uint2(tbw[w], tbw[w + 1]);
        } else {
#pragma unroll
            for (int w = 0; w < WORDS; ++w) *reinterpret_cast<uint32_t*>(tb_row + 4 * w) = tbw[w];
        }
    }

    // One reduction after the last row: highest value, then lowest row, then
    // lowest lane (best_pos orders by row first).
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
        const int v = __shfl_down_sync(FULL_MASK, best, s);
        const int pos = __shfl_down_sync(FULL_MASK, best_pos, s);
        if (v > best || (v == best && pos < best_pos)) {
            best = v;
            best_pos = pos;
        }
    }
    if (lane == 0) {
        const int bi = best_pos / W_PAD;
        best_out[b] = best;
        best_i_out[b] = bi;
        best_j_out[b] = best > 0 ? bi - off - K_PAD - 1 + best_pos % W_PAD : 0;
    }
}

// Wide form of the fill: one block per pair, bands in shared memory.
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

// Segmented form of the fill: any band width and any int32 substitution score (taken past the
// cluster form's largest band).
// One block per pair, SEG_THREADS threads of SEG_LPT lanes each: the block walks
// each row's band in segments of SEG_THREADS * SEG_LPT = 8,192 lanes (fewer
// threads when the band is narrower).  Between rows the M and D bands live in
// device memory, w_pad int32 each a pair (`scratch`; 256 KB a pair at w_pad
// 32,768, which stays in L2), because the three bands pass the 227 KB a block
// has from w_pad 16,384 on.  A segment is staged into shared memory with
// coalesced loads (the row above's M and D at its lanes and at the lane after
// its last, which the next segment has not yet written), filled there exactly
// as the wide form fills its band, and written back with coalesced stores
// while its traceback bytes leave.  What crosses segments (the same value in
// every thread): the exclusive max-plus scan's carry (-INF at a row's lane 0,
// then the running maximum of H(dm) + dm * gap_extend), the final M and I of
// the segment's last lane (the left neighbour of the next segment's first),
// and the row's best so far (strictly greater, so the lowest lane wins a tie
// between segments).  Staged words sit at x + x / 16, so a thread's 16 lanes
// fall in 16 banks and a warp's threads spread over all 32.  The scores are
// read as int32 from device memory (the 1 KB row of the query byte stays in
// L1), so one instance takes any matrix; every cell is the wide form's
// arithmetic, in int32 as the JAX package's.
constexpr int SEG_THREADS = 512;
constexpr int SEG_LPT = 16;

__host__ __device__ inline int seg_words(int seg) { return seg + 2 + (seg + 1) / 16; }
__device__ __forceinline__ int seg_slot(int x) { return x + (x >> 4); }

__global__ void __launch_bounds__(SEG_THREADS) swg_fill_segmented_kernel(
    const uint8_t* __restrict__ q,         // (B, rows_max)
    const uint8_t* __restrict__ t,         // (B, t_cols), left-padded by w_pad + 2
    const int32_t* __restrict__ q_lens,    // (B,)
    const int32_t* __restrict__ t_lens,    // (B,)
    const int32_t* __restrict__ offsets,   // (B,) diagonal offsets q_pos - t_pos
    const int32_t* __restrict__ k_locals,  // (B,) half band widths
    const int32_t* __restrict__ matrix,    // (256, 256)
    int rows_max, int w_pad, int t_cols, int gap_open, int gap_extend,
    int32_t* scratch,                      // (B, 2, w_pad): the M and D bands between rows
    uint8_t* __restrict__ tb,              // out (B, rows_max, w_pad)
    int32_t* __restrict__ best_out,        // out (B,)
    int32_t* __restrict__ best_i_out,      // out (B,)
    int32_t* __restrict__ best_j_out) {    // out (B,)
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int32_t warp_scan[SEG_THREADS / 32];
    __shared__ int32_t warp_best[SEG_THREADS / 32];
    __shared__ int32_t warp_lane[SEG_THREADS / 32];

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int lane_id = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = nthreads >> 5;
    const int seg = nthreads * SEG_LPT;  // lanes a segment
    int32_t* sM = reinterpret_cast<int32_t*>(smem);  // the segment's M, D and I, staged
    int32_t* sD = sM + seg_words(seg);
    int32_t* sI = sD + seg_words(seg);
    uint8_t* tb_part = reinterpret_cast<uint8_t*>(sI + seg_words(seg));

    const int l1 = q_lens[b];
    const int cols = t_lens[b] + 1;
    const int off = offsets[b];
    const int kl = k_locals[b];
    const int k_pad = (w_pad - 3) / 2;
    const int goe = gap_open + gap_extend;
    const int ge = gap_extend;
    const uint8_t* qb = q + (size_t)b * rows_max;
    const uint8_t* tt = t + (size_t)b * t_cols;
    uint8_t* tbb = tb + (size_t)b * rows_max * w_pad;
    int32_t* M = scratch + (size_t)b * 2 * w_pad;
    int32_t* D = M + w_pad;
    // dm * gap_extend wraps as the JAX package's int32 product does (unsigned: defined in C++).
    auto lane_ge = [&](int dm) { return (int)((unsigned)dm * (unsigned)ge); };

    // Row 0: padded-band border cells get M=0, everything else -INF.
    for (int dm = tid; dm < w_pad; dm += nthreads) {
        const int j0 = dm - off - k_pad - 1;
        const bool in_pad0 = abs(dm - (k_pad + 1)) <= kl + 1 && j0 >= 0 && j0 < cols;
        M[dm] = in_pad0 ? 0 : NEG_INF;
        D[dm] = NEG_INF;
    }

    int best = 0, best_i = 0, best_j = 0;
    const int n_rows = min(l1, rows_max);
    for (int i = 1; i <= n_rows; ++i) {
        const int32_t* mrow = matrix + 256 * (int)qb[i - 1];
        const int j_base = i - off - k_pad - 1;  // + dm: 1-based DP column of lane dm
        const int t_base = i - off + w_pad - k_pad;  // + dm: target window index
        int carry = NEG_INF;                     // the scan's prefix before the segment's lane 0
        int left_m = NEG_INF, left_i = NEG_INF;  // final M and I of the lane before the segment
        int seg_best = INT32_MIN, seg_lane = w_pad;  // the row's best so far
        for (int s0 = 0; s0 < w_pad; s0 += seg) {
            const int n = min(seg, w_pad - s0);  // lanes of this segment
            __syncthreads();  // the row above is in device memory; the segment before is done with sM
            for (int x = tid; x <= n; x += nthreads) {
                const int dm = s0 + x;
                sM[seg_slot(x)] = dm < w_pad ? M[dm] : NEG_INF;
                sD[seg_slot(x)] = dm < w_pad ? D[dm] : NEG_INF;
            }
            __syncthreads();
            const int lo = tid * SEG_LPT;  // this thread's lanes of the segment: [lo, lo + SEG_LPT)

            // Pass 1: D, diagonal, H; this thread's share of the prefix max.
            int h_ng[SEG_LPT], d_cur[SEG_LPT], flags[SEG_LPT];
            int run_total = NEG_INF;
#pragma unroll
            for (int k = 0; k < SEG_LPT; ++k) {
                const int x = lo + k;
                if (x < n) {
                    const int dm = s0 + x;
                    const int j = j_base + dm;
                    const int band = abs(dm - (k_pad + 1));
                    const bool in_cols = j >= 0 && j < cols;
                    const bool filled = band <= kl && j >= 1 && in_cols;
                    const bool in_pad = band <= kl + 1 && in_cols;
                    const int d_open = sM[seg_slot(x + 1)] - goe;  // -INF staged past the band's end
                    const int d_ext = sD[seg_slot(x + 1)] - ge;
                    d_cur[k] = max(d_open, d_ext);
                    const int ti = min(max(t_base + dm, 0), t_cols - 1);
                    const int diag = sM[seg_slot(x)] + __ldg(mrow + tt[ti]);
                    h_ng[k] = max(diag, d_cur[k]);
                    const int h_c = filled ? max(h_ng[k], 0) : (in_pad ? 0 : NEG_INF);
                    flags[k] = (d_cur[k] > diag ? 1 : 0) | (d_open < d_ext ? 4 : 0)
                               | (filled ? 16 : 0) | (in_pad ? 32 : 0);
                    run_total = max(run_total, h_c + lane_ge(dm));
                }
            }

            // Block-wide exclusive max-scan of the run totals, after the carry.
            int incl = run_total;
#pragma unroll
            for (int s = 1; s < 32; s <<= 1) {
                const int other = __shfl_up_sync(FULL_MASK, incl, s);
                if (lane_id >= s) incl = max(incl, other);
            }
            int prefix = __shfl_up_sync(FULL_MASK, incl, 1);
            if (lane_id == 0) prefix = NEG_INF;
            if (lane_id == 31) warp_scan[warp] = incl;
            __syncthreads();  // also: every thread's pass 1 has read the staged band
            prefix = max(prefix, carry);
            for (int w = 0; w < nwarps; ++w) {
                if (w < warp) prefix = max(prefix, warp_scan[w]);
                carry = max(carry, warp_scan[w]);
            }

            // Pass 2: I, M, the traceback's M-state bits, this thread's best in the segment.
            int row_best = INT32_MIN, row_lane = w_pad;
#pragma unroll
            for (int k = 0; k < SEG_LPT; ++k) {
                const int x = lo + k;
                if (x < n) {
                    const int dm = s0 + x;
                    const bool filled = flags[k] & 16;
                    const bool in_pad = flags[k] & 32;
                    const int h_c = filled ? max(h_ng[k], 0) : (in_pad ? 0 : NEG_INF);
                    const int i_cur = filled ? prefix - gap_open - lane_ge(dm) : NEG_INF;
                    prefix = max(prefix, h_c + lane_ge(dm));
                    const int m_cur = filled ? max(max(h_c, i_cur), 0) : (in_pad ? 0 : NEG_INF);
                    int tb_m = flags[k] & 1;
                    if (i_cur > h_ng[k]) tb_m = 2;
                    if (max(h_ng[k], i_cur) <= 0 || !filled) tb_m = 3;
                    sM[seg_slot(x)] = m_cur;
                    sD[seg_slot(x)] = d_cur[k];
                    sI[seg_slot(x)] = i_cur;
                    tb_part[x] = (uint8_t)(tb_m | (flags[k] & 4));
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
            __syncthreads();  // also: the segment's M, D and I are final
            for (int w = 0; w < nwarps; ++w) {  // strictly greater: the lowest lane keeps a tie
                if (warp_best[w] > seg_best) {
                    seg_best = warp_best[w];
                    seg_lane = warp_lane[w];
                }
            }

            // Pass 3: the I-state bit needs the left neighbour's final M and I; M and D go back.
            uint8_t* tb_row = tbb + (size_t)(i - 1) * w_pad + s0;
            for (int x = tid; x < n; x += nthreads) {
                const int m_left = x > 0 ? sM[seg_slot(x - 1)] : left_m;
                const int i_left = x > 0 ? sI[seg_slot(x - 1)] : left_i;
                tb_row[x] = tb_part[x] | (m_left - goe < i_left - ge ? 8 : 0);
                M[s0 + x] = sM[seg_slot(x)];
                D[s0 + x] = sD[seg_slot(x)];
            }
            left_m = sM[seg_slot(n - 1)];
            left_i = sI[seg_slot(n - 1)];
            // The next segment (or row) stages after its first barrier, which every thread
            // reaches after this pass.
        }
        if (seg_best > best) {
            best = seg_best;
            best_i = i;
            best_j = j_base + seg_lane;
        }
    }
    if (tid == 0) {
        best_out[b] = best;
        best_i_out[b] = best_i;
        best_j_out[b] = best_j;
    }
}

// Cluster form of the fill: every band up to CL_MAX_W_PAD lanes, int32 scores (the int8 forms'
// refusals: past 8,192 lanes, or a score outside int8), the band never leaving the SMs.  A pair
// is owned by one warp (bands up to CL_WARP_MAX_W_PAD lanes, CL_PAIRS pairs a CTA, no barrier at
// all), or by a cluster of C CTAs (C = 1 .. 16) that cut the band into slices of `slice` lanes,
// CTA `rank` holding lanes [rank * slice, ...).  A thread owns LPT contiguous lanes and keeps their
// M and D in registers from row to row, as the warp form does.  What a lane needs of a lane it
// does not own comes by a shuffle inside a warp; across warps and CTAs it is rebuilt from what
// the owner published for the row: a warp's total of the max-plus scan, its first lane's (H before
// the local reset, D, flags) and its last lane's (exclusive prefix inside the CTA, H, flags).
// From those and the scan's carry a lane's final M and I follow (cl_final), so a row needs one
// block barrier (the warps' publications) and, with C > 1, one cluster barrier: before it each
// CTA pushes, through distributed shared memory, its total to every CTA on its right, its first
// lane to its left neighbour and its last lane to its right neighbour (the arrive is split from
// the wait, and the CTA's own part of the prefix is taken in between).  Publications are
// double-buffered by row parity: a slot written for row i is read after row i's barriers and
// written again for row i + 2 only after row i + 1's barriers, which every reader reaches after
// its reads.  The best cell: each thread keeps its own (strictly greater over its rows and lanes
// in order, so its earliest row and lowest lane win), and the pair's threads reduce once at the
// end by (highest value, lowest row, lowest lane), CTAs through rank 0's shared memory: the cell
// the per-row rule picks.  Every cell is the wide form's arithmetic in int32, the scores read from
// the (256, 256) int32 matrix through L1 (a query byte's 1 KB row), dm * gap_extend wrapping as
// the JAX package's int32 product does.
constexpr int CL_THREADS = 512;          // threads a CTA of a cluster at most
constexpr int CL_WARPS = CL_THREADS / 32;
constexpr int CL_PAIRS = 4;              // pairs a CTA in the warp-a-pair mode, one warp each
constexpr int CL_MAX_CLUSTER = 16;       // CTAs a cluster at most (a non-portable size)
constexpr int CL_SLICE = 2048;           // lanes a CTA takes while the cluster can grow
constexpr int CL_MAX_LPT = 16;
constexpr int CL_WARP_MAX_W_PAD = 32 * CL_MAX_LPT;                      // 512
constexpr int CL_MAX_W_PAD = CL_MAX_CLUSTER * CL_THREADS * CL_MAX_LPT;  // 131,072

__device__ __forceinline__ int cl_lane_ge(int dm, int ge) { return (int)((unsigned)dm * (unsigned)ge); }

// A lane's H after the local reset, from its H before it and its flags (16 filled, 32 in_pad).
__device__ __forceinline__ int cl_h_c(int h_ng, int flags) {
    return (flags & 16) ? max(h_ng, 0) : ((flags & 32) ? 0 : NEG_INF);
}

// A lane's final M and I of the row, from its H, flags and the scan's exclusive prefix before it.
__device__ __forceinline__ void cl_final(int h_ng, int flags, int prefix, int dm, int gap_open, int ge, int& m,
                                         int& i_cur) {
    i_cur = (flags & 16) ? prefix - gap_open - cl_lane_ge(dm, ge) : NEG_INF;
    m = (flags & 16) ? max(max(cl_h_c(h_ng, flags), i_cur), 0) : ((flags & 32) ? 0 : NEG_INF);
}

// Row 0's M of band lane dm: 0 on the padded band's border cells, else -INF (also past the band).
__device__ __forceinline__ int cl_row0_m(int dm, int w_pad, int off, int k_pad, int kl, int cols) {
    const int j0 = dm - off - k_pad - 1;
    return dm < w_pad && abs(dm - (k_pad + 1)) <= kl + 1 && j0 >= 0 && j0 < cols ? 0 : NEG_INF;
}

__device__ __forceinline__ bool cl_better(int v, int r, int l, int best, int row, int lane) {
    return v > best || (v == best && (r < row || (r == row && l < lane)));
}

__device__ __forceinline__ void cl_cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cl_cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }

template <int LPT, bool WARP>
__global__ void __launch_bounds__(WARP ? CL_PAIRS * 32 : CL_THREADS) swg_fill_cluster_kernel(
    const uint8_t* __restrict__ q,         // (B, rows_max)
    const uint8_t* __restrict__ t,         // (B, t_cols), left-padded by w_pad + 2
    const int32_t* __restrict__ q_lens,    // (B,)
    const int32_t* __restrict__ t_lens,    // (B,)
    const int32_t* __restrict__ offsets,   // (B,) diagonal offsets q_pos - t_pos
    const int32_t* __restrict__ k_locals,  // (B,) half band widths
    const int32_t* __restrict__ matrix,    // (256, 256)
    int n_pairs, int rows_max, int w_pad, int t_cols, int gap_open, int gap_extend, int slice,
    uint8_t* __restrict__ tb,              // out (B, rows_max, w_pad)
    int32_t* __restrict__ best_out,        // out (B,)
    int32_t* __restrict__ best_i_out,      // out (B,)
    int32_t* __restrict__ best_j_out) {    // out (B,)
    static_assert(LPT == 4 || LPT == 8 || LPT == 16, "LPT is 4, 8 or 16");
    namespace cg = cooperative_groups;
    __shared__ int s_wtot[2][CL_WARPS];          // each warp's inclusive scan total
    __shared__ int s_wfirst[2][CL_WARPS][3];     // each warp's first lane: H before the reset, D, flags
    __shared__ int s_wlast[2][CL_WARPS][3];      // each warp's last lane: exclusive prefix in the CTA, H, flags
    __shared__ int s_tot_in[2][CL_MAX_CLUSTER];  // pushed: the totals of the CTAs on the left
    __shared__ int s_right[2][3];                // pushed: the right neighbour CTA's first lane
    __shared__ int s_left[2][3];                 // pushed: the left neighbour CTA's last lane
    __shared__ int s_best[CL_WARPS][3];          // the warps' bests
    __shared__ int s_cbest[CL_MAX_CLUSTER][3];   // rank 0: the CTAs' bests

    const int tid = threadIdx.x;
    const int lane_id = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
    int b, rank = 0, C = 1, s0 = 0, n = w_pad, lo;
    if constexpr (WARP) {
        b = blockIdx.x * CL_PAIRS + warp;
        if (b >= n_pairs) return;
        lo = lane_id * LPT;
    } else {
        C = (int)cg::this_cluster().num_blocks();
        rank = (int)cg::this_cluster().block_rank();
        b = blockIdx.x / C;
        s0 = rank * slice;
        n = min(slice, w_pad - s0);
        lo = tid * LPT;
    }
    const int l1 = q_lens[b];
    const int cols = t_lens[b] + 1;
    const int off = offsets[b];
    const int kl = k_locals[b];
    const int k_pad = (w_pad - 3) / 2;
    const int goe = gap_open + gap_extend;
    const int ge = gap_extend;
    const int n_rows = min(l1, rows_max);
    if (n_rows <= 0) {
        if (rank == 0 && (WARP ? lane_id : tid) == 0) best_out[b] = best_i_out[b] = best_j_out[b] = 0;
        return;  // every CTA of the cluster leaves here, before any barrier
    }
    const uint8_t* qb = q + (size_t)b * rows_max;
    const uint8_t* tt = t + (size_t)b * t_cols;
    uint8_t* tbb = tb + (size_t)b * rows_max * w_pad + s0;
    const int xr = lo + LPT;               // the lane after this thread's last, in the slice
    const int wl = (n - 1) / (32 * LPT);  // the warp that holds the slice's last lane

    int M[LPT], D[LPT];
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
        M[k] = lo + k < n ? cl_row0_m(s0 + lo + k, w_pad, off, k_pad, kl, cols) : NEG_INF;
        D[k] = NEG_INF;
    }
    int right_m = xr <= n ? cl_row0_m(s0 + xr, w_pad, off, k_pad, kl, cols) : NEG_INF;  // lane xr, the row above
    int right_d = NEG_INF;
    int best = 0, best_row = 0, best_lane = 0;
    int q_next = qb[0];

    for (int i = 1; i <= n_rows; ++i) {
        const int32_t* mrow = matrix + 256 * q_next;
        if (i < n_rows) q_next = qb[i];
        const int j_base = i - off - k_pad - 1;      // + dm: 1-based DP column of lane dm
        const int t_base = i - off + w_pad - k_pad;  // + dm: target window index
        const int par = i & 1;

        // Pass 1: D, the diagonal, H; this thread's share of the prefix max.
        int h_ng[LPT], flags[LPT];
        int run_total = NEG_INF;
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
            const int dm = s0 + lo + k;
            h_ng[k] = 0;
            flags[k] = 0;
            if (lo + k < n) {
                const int j = j_base + dm;
                const int band = abs(dm - (k_pad + 1));
                const bool in_cols = j >= 0 && j < cols;
                const bool filled = band <= kl && j >= 1 && in_cols;
                const bool in_pad = band <= kl + 1 && in_cols;
                const int m_up = k + 1 < LPT ? M[k + 1] : right_m;  // the row above at lane dm + 1
                const int d_up = k + 1 < LPT ? D[k + 1] : right_d;
                const int d_open = m_up - goe;
                const int d_ext = d_up - ge;
                const int d = max(d_open, d_ext);
                const int ti = min(max(t_base + dm, 0), t_cols - 1);
                const int diag = M[k] + __ldg(mrow + tt[ti]);
                h_ng[k] = max(diag, d);
                flags[k] = (d > diag ? 1 : 0) | (d_open < d_ext ? 4 : 0) | (filled ? 16 : 0) | (in_pad ? 32 : 0);
                D[k] = d;  // lane k - 1 has read the row above's D[k] already
                run_total = max(run_total, cl_h_c(h_ng[k], flags[k]) + cl_lane_ge(dm, ge));
            }
        }

        // The max-plus scan: the warp's inclusive scan, then the warps and CTAs before it.
        int incl = run_total;
#pragma unroll
        for (int s = 1; s < 32; s <<= 1) {
            const int other = __shfl_up_sync(FULL_MASK, incl, s);
            if (lane_id >= s) incl = max(incl, other);
        }
        int prefix = __shfl_up_sync(FULL_MASK, incl, 1);  // before this thread's first lane
        if (lane_id == 0) prefix = NEG_INF;
        int carry = NEG_INF, carry_left = NEG_INF;  // the totals of the CTAs before this one / before the left one
        int wpre = NEG_INF, wpre_left = NEG_INF, wpre_incl = NEG_INF, cta_tot = NEG_INF;
        if constexpr (!WARP) {
            if (lane_id == 31) s_wtot[par][warp] = incl;
            if (lane_id == 0) {  // the warp's first lane (a dead one publishes M = D = -INF)
                s_wfirst[par][warp][0] = h_ng[0];
                s_wfirst[par][warp][1] = lo < n ? D[0] : NEG_INF;
                s_wfirst[par][warp][2] = flags[0];
            }
            const int x_last = min(n, (warp + 1) * 32 * LPT) - 1;  // the warp's last live lane
            if (x_last >= lo && x_last < xr) {
                int pre = prefix;
#pragma unroll
                for (int k = 0; k < LPT; ++k) {
                    if (lo + k == x_last) {
                        s_wlast[par][warp][0] = pre;
                        s_wlast[par][warp][1] = h_ng[k];
                        s_wlast[par][warp][2] = flags[k];
                    }
                    pre = max(pre, cl_h_c(h_ng[k], flags[k]) + cl_lane_ge(s0 + lo + k, ge));
                }
            }
            __syncthreads();
            for (int w = 0; w < nwarps; ++w) {
                const int x = s_wtot[par][w];
                if (w < warp - 1) wpre_left = max(wpre_left, x);
                if (w < warp) wpre = max(wpre, x);
                if (w <= warp) wpre_incl = max(wpre_incl, x);
                cta_tot = max(cta_tot, x);
            }
            if (C > 1) {
                cg::cluster_group cluster = cg::this_cluster();
                if (warp == 0) {
                    if (lane_id > rank && lane_id < C) *cluster.map_shared_rank(&s_tot_in[par][rank], lane_id) = cta_tot;
                    if (lane_id == 0 && rank > 0) {
                        int* dst = cluster.map_shared_rank(&s_right[par][0], rank - 1);
                        dst[0] = s_wfirst[par][0][0];
                        dst[1] = s_wfirst[par][0][1];
                        dst[2] = s_wfirst[par][0][2];
                    }
                    if (lane_id == 1 && rank + 1 < C) {
                        int pre = s_wlast[par][wl][0];
                        for (int w = 0; w < wl; ++w) pre = max(pre, s_wtot[par][w]);
                        int* dst = cluster.map_shared_rank(&s_left[par][0], rank + 1);
                        dst[0] = pre;
                        dst[1] = s_wlast[par][wl][1];
                        dst[2] = s_wlast[par][wl][2];
                    }
                }
                cl_cluster_arrive();
                prefix = max(prefix, wpre);
                cl_cluster_wait();
                for (int r = 0; r < rank; ++r) {
                    const int x = s_tot_in[par][r];
                    carry = max(carry, x);
                    if (r < rank - 1) carry_left = max(carry_left, x);
                }
            } else {
                prefix = max(prefix, wpre);
            }
            prefix = max(prefix, carry);
        }

        // Pass 2: I, M, the traceback byte (its I-state bit from the lane before's final M and I),
        // this thread's best.
        uint32_t bytes[LPT];
        int i_prev = NEG_INF;
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
            const int dm = s0 + lo + k;
            bytes[k] = 0;
            if (lo + k < n) {
                const int f = flags[k];
                const bool filled = f & 16;
                const int h_c = cl_h_c(h_ng[k], f);
                const int i_cur = filled ? prefix - gap_open - cl_lane_ge(dm, ge) : NEG_INF;
                prefix = max(prefix, h_c + cl_lane_ge(dm, ge));
                const int m_cur = filled ? max(max(h_c, i_cur), 0) : ((f & 32) ? 0 : NEG_INF);
                int tb_m = f & 1;
                if (i_cur > h_ng[k]) tb_m = 2;
                if (max(h_ng[k], i_cur) <= 0 || !filled) tb_m = 3;
                bytes[k] = (uint32_t)(tb_m | (f & 4));
                if (k > 0 && M[k - 1] - goe < i_prev - ge) bytes[k] |= 8u;
                M[k] = m_cur;
                i_prev = i_cur;
                if (filled && m_cur > best) {
                    best = m_cur;
                    best_row = i;
                    best_lane = dm;
                }
            }
        }

        // The lane before this thread's first: the thread before in the warp, else rebuilt.
        int m_left = __shfl_up_sync(FULL_MASK, M[LPT - 1], 1);
        int i_left = __shfl_up_sync(FULL_MASK, i_prev, 1);
        if (lane_id == 0) {
            m_left = i_left = NEG_INF;
            if constexpr (!WARP) {
                if (warp > 0) {
                    const int* e = s_wlast[par][warp - 1];
                    cl_final(e[1], e[2], max(max(carry, wpre_left), e[0]), s0 + lo - 1, gap_open, ge, m_left, i_left);
                } else if (rank > 0) {
                    const int* e = s_left[par];
                    cl_final(e[1], e[2], max(carry_left, e[0]), s0 - 1, gap_open, ge, m_left, i_left);
                }
            }
        }
        if (lo < n && m_left - goe < i_left - ge) bytes[0] |= 8u;

        // The lane after this thread's last, for the next row: the thread after in the warp, else rebuilt.
        right_m = __shfl_down_sync(FULL_MASK, M[0], 1);
        right_d = __shfl_down_sync(FULL_MASK, D[0], 1);
        if (xr >= n || lane_id == 31) {
            right_m = right_d = NEG_INF;
            if constexpr (!WARP) {
                int i_unused;
                if (xr == n && rank + 1 < C) {
                    const int* e = s_right[par];
                    cl_final(e[0], e[2], max(carry, cta_tot), s0 + n, gap_open, ge, right_m, i_unused);
                    right_d = e[1];
                } else if (xr < n) {
                    const int* e = s_wfirst[par][warp + 1];
                    cl_final(e[0], e[2], max(carry, wpre_incl), s0 + xr, gap_open, ge, right_m, i_unused);
                    right_d = e[1];
                }
            }
        }

        // This thread's traceback bytes of the row: whole words when its lanes are live and aligned.
        uint8_t* tb_row = tbb + (size_t)(i - 1) * w_pad + lo;
        if (xr <= n && ((size_t)tb_row & 3) == 0) {
#pragma unroll
            for (int w = 0; w < LPT / 4; ++w)
                reinterpret_cast<uint32_t*>(tb_row)[w] =
                    bytes[4 * w] | bytes[4 * w + 1] << 8 | bytes[4 * w + 2] << 16 | bytes[4 * w + 3] << 24;
        } else {
#pragma unroll
            for (int k = 0; k < LPT; ++k)
                if (lo + k < n) tb_row[k] = (uint8_t)bytes[k];
        }
    }

    // One reduction after the last row: highest value, then lowest row, then lowest lane.
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
        const int v = __shfl_down_sync(FULL_MASK, best, s);
        const int r = __shfl_down_sync(FULL_MASK, best_row, s);
        const int l = __shfl_down_sync(FULL_MASK, best_lane, s);
        if (cl_better(v, r, l, best, best_row, best_lane)) {
            best = v;
            best_row = r;
            best_lane = l;
        }
    }
    if constexpr (!WARP) {
        if (lane_id == 0) {
            s_best[warp][0] = best;
            s_best[warp][1] = best_row;
            s_best[warp][2] = best_lane;
        }
        __syncthreads();
        if (tid == 0) {
            for (int w = 1; w < nwarps; ++w) {
                if (cl_better(s_best[w][0], s_best[w][1], s_best[w][2], best, best_row, best_lane)) {
                    best = s_best[w][0];
                    best_row = s_best[w][1];
                    best_lane = s_best[w][2];
                }
            }
        }
        if (C > 1) {
            cg::cluster_group cluster = cg::this_cluster();
            if (tid == 0 && rank > 0) {
                int* dst = cluster.map_shared_rank(&s_cbest[rank][0], 0);
                dst[0] = best;
                dst[1] = best_row;
                dst[2] = best_lane;
            }
            cluster.sync();  // also: no CTA leaves while a neighbour may still read what it pushed
            if (rank != 0) return;
            if (tid == 0) {
                for (int r = 1; r < C; ++r) {
                    if (cl_better(s_cbest[r][0], s_cbest[r][1], s_cbest[r][2], best, best_row, best_lane)) {
                        best = s_cbest[r][0];
                        best_row = s_cbest[r][1];
                        best_lane = s_cbest[r][2];
                    }
                }
            }
        }
    }
    if ((WARP ? lane_id : tid) == 0) {
        best_out[b] = best;
        best_i_out[b] = best > 0 ? best_row : 0;
        best_j_out[b] = best > 0 ? best_row - off - k_pad - 1 + best_lane : 0;
    }
}

// One warp per pair replays the traceback state machine (0 = in M, 1 = in D,
// 2 = in I) over the packed bits, from the best cell back to a
// local-alignment start, a stretch of up to 32 steps at a time: lane l reads
// the cell the walk would reach after l more steps in the current state.
// i, j, the state and the run recorder are the same in every lane (they
// change only by ballots and broadcasts).
//
// With CIGAR set the walk also records BAM runs (M=0 on the diagonal, I=1 in
// the vertical D state, D=2 in the horizontal I state; a transition emits
// none, and the step that closes a gap belongs to the gap's run).  A stretch
// of n steps adds n to the open run when the op is the same, else closes it
// and opens one, so an M run longer than 32 comes out as one run.  Closed
// runs go, end to start, into the warp's MAX_CIGAR_OPS words of shared
// memory (`runs`); a run past that capacity overwrites the last slot, as the
// JAX package's buffer does, and sets the pair's overflow flag.  The warp then
// writes the pair's whole row of `ops` once: reversed on the way out (slot s
// takes run n-1-s), zeros past n, eight coalesced 128-byte stores.  Without
// CIGAR the recorder compiles away.
template <bool CIGAR>
__device__ __forceinline__ void walk_pair(
    const uint8_t* __restrict__ tb, const uint8_t* __restrict__ q,
    const uint8_t* __restrict__ t, const int32_t* __restrict__ best,
    const int32_t* __restrict__ best_i, const int32_t* __restrict__ best_j,
    const int32_t* __restrict__ offsets, int n_pairs, int rows_max, int w_pad,
    int t_cols, int t_pad, int b, int lane,
    int32_t* __restrict__ out,        // (8, B): score, matches, mismatches, gaps, q/t starts+ends
    int32_t* runs,                    // CIGAR: the warp's MAX_CIGAR_OPS words of shared memory
    int32_t* __restrict__ ops,        // CIGAR: (B, MAX_CIGAR_OPS) BAM runs, len << 4 | op
    int32_t* __restrict__ n_ops_out,  // CIGAR: (B,) runs kept, min(runs, MAX_CIGAR_OPS)
    uint8_t* __restrict__ overflow) { // CIGAR: (B,) more than MAX_CIGAR_OPS runs
    const int k_pad = (w_pad - 3) / 2;
    const uint8_t* tbb = tb + (size_t)b * rows_max * w_pad;
    const uint8_t* qb = q + (size_t)b * rows_max;
    const uint8_t* tt = t + (size_t)b * t_cols;
    const int off = offsets[b];
    const int end_i = best_i[b], end_j = best_j[b];
    int i = end_i, j = end_j;
    int state = 0, matches = 0, mismatches = 0, gaps = 0;
    int cur_op = -1, run = 0, n_runs = 0;  // the open run; runs closed so far
    // n steps of `op`: lengthen the open run, or close it and open one.
    auto record = [&](int op, int n) {
        if (!CIGAR || n == 0) return;
        if (op == cur_op) {
            run += n;
            return;
        }
        if (cur_op >= 0) {
            if (lane == 0) runs[min(n_runs, MAX_CIGAR_OPS - 1)] = (run << 4) | cur_op;
            ++n_runs;
        }
        cur_op = op;
        run = n;
    };
    while (i > 0 && j > 0) {
        const int dm0 = j - (i - off) + k_pad + 1;  // the band lane of (i, j)
        if (state == 0) {
            // Diagonal run: lane l looks at (i - l, j - l), all on band lane dm0.
            const int il = i - lane, jl = j - lane;
            const bool valid = il > 0 && jl > 0;
            const int r = min(max(il - 1, 0), rows_max - 1);
            const int dm = min(max(dm0, 0), w_pad - 1);
            const int tb_m = tbb[(size_t)r * w_pad + dm] & 3;
            const int tc = tt[min(max(jl - 1 + t_pad, 0), t_cols - 1)];
            const bool same = qb[r] == tc;
            const unsigned stop = ~__ballot_sync(FULL_MASK, valid && tb_m == 0);
            const int n = stop ? __ffs(stop) - 1 : 32;  // diagonal steps taken
            const int m = __popc(__ballot_sync(FULL_MASK, same) & (n == 32 ? FULL_MASK : (1u << n) - 1u));
            matches += m;
            mismatches += n - m;
            i -= n;
            j -= n;
            record(0, n);
            if (n < 32) {  // lane n's cell ends the run, unless the walk left the matrix there
                const int how = __shfl_sync(FULL_MASK, valid ? tb_m : -1, n);
                if (how == 3) break;
                if (how > 0) state = how;  // 1: into D, 2: into I (no move on the transition)
            }
        } else if (state == 1) {
            // Column run: lane l looks at (i - l, j); each step is one gap.
            const int il = i - lane;
            const bool valid = il > 0;
            const int r = min(max(il - 1, 0), rows_max - 1);
            const int dm = min(max(dm0 + lane, 0), w_pad - 1);
            const bool extend = (tbb[(size_t)r * w_pad + dm] >> 2) & 1;
            const unsigned stop = ~__ballot_sync(FULL_MASK, valid && extend);
            int n = stop ? __ffs(stop) - 1 : 32;
            if (n < 32 && __shfl_sync(FULL_MASK, (int)valid, n)) {  // lane n's cell closes the gap
                ++n;
                state = 0;
            }
            gaps += n;
            i -= n;
            record(1, n);
        } else {
            // Row run: lane l looks at (i, j - l).
            const int jl = j - lane;
            const bool valid = jl > 0;
            const int r = min(max(i - 1, 0), rows_max - 1);
            const int dm = min(max(dm0 - lane, 0), w_pad - 1);
            const bool extend = (tbb[(size_t)r * w_pad + dm] >> 3) & 1;
            const unsigned stop = ~__ballot_sync(FULL_MASK, valid && extend);
            int n = stop ? __ffs(stop) - 1 : 32;
            if (n < 32 && __shfl_sync(FULL_MASK, (int)valid, n)) {
                ++n;
                state = 0;
            }
            gaps += n;
            j -= n;
            record(2, n);
        }
    }
    if (lane == 0) {
        out[0 * n_pairs + b] = best[b];
        out[1 * n_pairs + b] = matches;
        out[2 * n_pairs + b] = mismatches;
        out[3 * n_pairs + b] = gaps;
        out[4 * n_pairs + b] = i;
        out[5 * n_pairs + b] = end_i;
        out[6 * n_pairs + b] = j;
        out[7 * n_pairs + b] = end_j;
    }
    if (CIGAR) {
        record(-1, 1);  // close the final run
        const int n = min(n_runs, MAX_CIGAR_OPS);
        __syncwarp();   // lane 0's runs are visible to the warp
        int32_t* row = ops + (size_t)b * MAX_CIGAR_OPS;
#pragma unroll
        for (int s = lane; s < MAX_CIGAR_OPS; s += 32) row[s] = s < n ? runs[n - 1 - s] : 0;
        if (lane == 0) {
            n_ops_out[b] = n;
            overflow[b] = n_runs > MAX_CIGAR_OPS ? 1 : 0;
        }
    }
}

__global__ void __launch_bounds__(TRACEBACK_WARPS * 32) swg_traceback_kernel(
    const uint8_t* __restrict__ tb, const uint8_t* __restrict__ q,
    const uint8_t* __restrict__ t, const int32_t* __restrict__ best,
    const int32_t* __restrict__ best_i, const int32_t* __restrict__ best_j,
    const int32_t* __restrict__ offsets, int n_pairs, int rows_max, int w_pad,
    int t_cols, int t_pad, int32_t* __restrict__ out) {
    const int b = blockIdx.x * TRACEBACK_WARPS + (threadIdx.x >> 5);
    if (b >= n_pairs) return;
    walk_pair<false>(tb, q, t, best, best_i, best_j, offsets, n_pairs, rows_max, w_pad, t_cols, t_pad,
                     b, threadIdx.x & 31, out, nullptr, nullptr, nullptr, nullptr);
}

__global__ void __launch_bounds__(TRACEBACK_WARPS * 32) swg_traceback_cigar_kernel(
    const uint8_t* __restrict__ tb, const uint8_t* __restrict__ q,
    const uint8_t* __restrict__ t, const int32_t* __restrict__ best,
    const int32_t* __restrict__ best_i, const int32_t* __restrict__ best_j,
    const int32_t* __restrict__ offsets, int n_pairs, int rows_max, int w_pad,
    int t_cols, int t_pad, int32_t* __restrict__ out, int32_t* __restrict__ ops,
    int32_t* __restrict__ n_ops, uint8_t* __restrict__ overflow) {
    __shared__ int32_t runs[TRACEBACK_WARPS][MAX_CIGAR_OPS];
    const int warp = threadIdx.x >> 5;
    const int b = blockIdx.x * TRACEBACK_WARPS + warp;
    if (b >= n_pairs) return;
    walk_pair<true>(tb, q, t, best, best_i, best_j, offsets, n_pairs, rows_max, w_pad, t_cols, t_pad,
                    b, threadIdx.x & 31, out, runs[warp], ops, n_ops, overflow);
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

template <int LPT>
cudaError_t launch_fill_warp(int n_pairs, cudaStream_t stream, const uint8_t* q,
                             const uint8_t* t, const int32_t* q_lens, const int32_t* t_lens,
                             const int32_t* offsets, const int32_t* k_locals,
                             const int8_t* matrix, int rows_max, int t_cols, int gap_open,
                             int gap_extend, uint8_t* tb, int32_t* best, int32_t* best_i,
                             int32_t* best_j) {
    cudaError_t err = cudaFuncSetAttribute(
        swg_fill_warp_kernel<LPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, MATRIX_BYTES);
    if (err != cudaSuccess) return err;
    swg_fill_warp_kernel<LPT><<<(n_pairs + FILL_WARPS - 1) / FILL_WARPS, FILL_WARPS * 32,
                                MATRIX_BYTES, stream>>>(
        q, t, q_lens, t_lens, offsets, k_locals, matrix, n_pairs, rows_max, t_cols, gap_open,
        gap_extend, tb, best, best_i, best_j);
    return cudaGetLastError();
}

bool warp_form(int w_pad) { return w_pad % 128 == 0 && w_pad <= WARP_FORM_MAX_W_PAD; }

int segmented_threads(int w_pad) {
    const int lanes = (w_pad + SEG_LPT - 1) / SEG_LPT;
    return lanes >= SEG_THREADS ? SEG_THREADS : (lanes + 31) / 32 * 32;
}

size_t segmented_smem_bytes(int threads) {  // the staged M, D and I words and the traceback bytes
    const int seg = threads * SEG_LPT;
    return 3 * sizeof(int32_t) * (size_t)seg_words(seg) + (size_t)seg;
}

// The largest cluster the current device runs the cluster form's heaviest CTA in: 16 where a
// 16-CTA cluster fits (a non-portable size), else 8.  Asked once a device.
int cluster_max_size() {
    static int cached[64] = {0};
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= 64) return 8;
    if (cached[device] == 0) {
        int size = 8, active = 0;
        cudaLaunchAttribute attr;
        attr.id = cudaLaunchAttributeClusterDimension;
        attr.val.clusterDim.x = CL_MAX_CLUSTER;
        attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(CL_MAX_CLUSTER);
        cfg.blockDim = dim3(CL_THREADS);
        cfg.attrs = &attr;
        cfg.numAttrs = 1;
        if (cudaFuncSetAttribute(swg_fill_cluster_kernel<CL_MAX_LPT, false>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1) == cudaSuccess &&
            cudaOccupancyMaxActiveClusters(&active, swg_fill_cluster_kernel<CL_MAX_LPT, false>, &cfg) == cudaSuccess &&
            active >= 1)
            size = CL_MAX_CLUSTER;
        cudaGetLastError();  // a refused size is an answer, not an error of the next launch
        cached[device] = size;
    }
    return cached[device];
}

// The cluster form's geometry for w_pad: CTAs a cluster (0: the warp-a-pair mode), lanes a slice,
// lanes a thread and threads a CTA.  Returns false when the form does not take the band (past the
// largest cluster's).
struct ClusterPlan {
    int ctas, slice, lpt, threads;
};

bool cluster_plan(int w_pad, ClusterPlan& plan) {
    if (w_pad < 3) return false;
    if (w_pad <= CL_WARP_MAX_W_PAD) {
        plan = {0, w_pad, w_pad <= 128 ? 4 : (w_pad <= 256 ? 8 : 16), CL_PAIRS * 32};
        return true;
    }
    const int c = std::min((w_pad + CL_SLICE - 1) / CL_SLICE, cluster_max_size());
    int slice = (w_pad + c - 1) / c;
    const int lpt = slice <= 4 * CL_THREADS ? 4 : (slice <= 8 * CL_THREADS ? 8 : (slice <= 16 * CL_THREADS ? 16 : 0));
    if (lpt == 0) return false;
    slice = (slice + lpt - 1) / lpt * lpt;
    plan = {c, slice, lpt, (slice + 32 * lpt - 1) / (32 * lpt) * 32};
    return true;
}

template <int LPT>
cudaError_t launch_fill_cluster(const ClusterPlan& plan, int n_pairs, cudaStream_t stream, const uint8_t* q,
                                const uint8_t* t, const int32_t* q_lens, const int32_t* t_lens,
                                const int32_t* offsets, const int32_t* k_locals, const int32_t* matrix,
                                int rows_max, int w_pad, int t_cols, int gap_open, int gap_extend, uint8_t* tb,
                                int32_t* best, int32_t* best_i, int32_t* best_j) {
    if (plan.ctas == 0) {
        swg_fill_cluster_kernel<LPT, true><<<(n_pairs + CL_PAIRS - 1) / CL_PAIRS, CL_PAIRS * 32, 0, stream>>>(
            q, t, q_lens, t_lens, offsets, k_locals, matrix, n_pairs, rows_max, w_pad, t_cols, gap_open,
            gap_extend, plan.slice, tb, best, best_i, best_j);
        return cudaGetLastError();
    }
    if (plan.ctas > 8) {
        const cudaError_t err = cudaFuncSetAttribute(swg_fill_cluster_kernel<LPT, false>,
                                                     cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return err;
    }
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = plan.ctas;
    attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)n_pairs * plan.ctas);
    cfg.blockDim = dim3(plan.threads);
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, swg_fill_cluster_kernel<LPT, false>, q, t, q_lens, t_lens,
                                               offsets, k_locals, matrix, n_pairs, rows_max, w_pad, t_cols,
                                               gap_open, gap_extend, plan.slice, tb, best, best_i, best_j);
    return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest band the fill's int8 forms take (16 lanes for each of 512 threads); the cluster form
// takes every width up to 131,072 and the segmented form every width.
int kts_swg_max_w_pad() { return 16 * MAX_THREADS; }

// 1 when the fill takes this band width in its warp form, 0 in its wide form (int8 scores).
int kts_swg_fill_warp_form(int w_pad) { return warp_form(w_pad) ? 1 : 0; }

// The cluster form's geometry for w_pad on the current device into out[4]: CTAs a cluster (0: a
// warp a pair), lanes a slice, lanes a thread, threads a CTA.  Returns 1 when the cluster form
// takes the band, else 0 (the segmented form takes it).
int kts_swg_fill_cluster_plan(int w_pad, int* out) {
    ClusterPlan plan;
    if (!cluster_plan(w_pad, plan)) return 0;
    out[0] = plan.ctas;
    out[1] = plan.slice;
    out[2] = plan.lpt;
    out[3] = plan.threads;
    return 1;
}

// The fill's cluster form (w_pad >= 3 up to the largest cluster's band, int32 scores) on
// `stream`, in the geometry kts_swg_fill_cluster_plan gives.  Returns the launch's CUDA error
// (cudaErrorInvalidValue for a band the form does not take).
int kts_swg_fill_cluster(const void* q, const void* t, const void* q_lens, const void* t_lens, const void* offsets,
                         const void* k_locals, const void* matrix, int n_pairs, int rows_max, int w_pad, int t_cols,
                         int gap_open, int gap_extend, void* tb, void* best, void* best_i, void* best_j,
                         void* stream) {
    if (n_pairs == 0) return (int)cudaSuccess;
    ClusterPlan plan;
    if (rows_max < 1 || t_cols < 1 || !cluster_plan(w_pad, plan)) return (int)cudaErrorInvalidValue;
#define KTS_FILL_CLUSTER(LPT)                                                                                     \
    launch_fill_cluster<LPT>(plan, n_pairs, static_cast<cudaStream_t>(stream), static_cast<const uint8_t*>(q),   \
                             static_cast<const uint8_t*>(t), static_cast<const int32_t*>(q_lens),                \
                             static_cast<const int32_t*>(t_lens), static_cast<const int32_t*>(offsets),          \
                             static_cast<const int32_t*>(k_locals), static_cast<const int32_t*>(matrix),         \
                             rows_max, w_pad, t_cols, gap_open, gap_extend, static_cast<uint8_t*>(tb),           \
                             static_cast<int32_t*>(best), static_cast<int32_t*>(best_i),                         \
                             static_cast<int32_t*>(best_j))
    const cudaError_t err = plan.lpt == 4 ? KTS_FILL_CLUSTER(4) : (plan.lpt == 8 ? KTS_FILL_CLUSTER(8) : KTS_FILL_CLUSTER(16));
#undef KTS_FILL_CLUSTER
    return (int)err;
}

// The fill's segmented form (any w_pad >= 3, int32 scores) on `stream`; `scratch` holds
// n_pairs * 2 * w_pad int32.  Returns the launch's CUDA error.
int kts_swg_fill_segmented(const void* q, const void* t, const void* q_lens, const void* t_lens,
                           const void* offsets, const void* k_locals, const void* matrix,
                           int n_pairs, int rows_max, int w_pad, int t_cols, int gap_open,
                           int gap_extend, void* scratch, void* tb, void* best, void* best_i,
                           void* best_j, void* stream) {
    if (n_pairs == 0) return (int)cudaSuccess;
    if (w_pad < 3 || rows_max < 1 || t_cols < 1) return (int)cudaErrorInvalidValue;
    const int threads = segmented_threads(w_pad);
    const size_t smem = segmented_smem_bytes(threads);
    const cudaError_t err = cudaFuncSetAttribute(swg_fill_segmented_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    swg_fill_segmented_kernel<<<n_pairs, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(t),
        static_cast<const int32_t*>(q_lens), static_cast<const int32_t*>(t_lens),
        static_cast<const int32_t*>(offsets), static_cast<const int32_t*>(k_locals),
        static_cast<const int32_t*>(matrix), rows_max, w_pad, t_cols, gap_open, gap_extend,
        static_cast<int32_t*>(scratch), static_cast<uint8_t*>(tb), static_cast<int32_t*>(best),
        static_cast<int32_t*>(best_i), static_cast<int32_t*>(best_j));
    return (int)cudaGetLastError();
}

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
#define KTS_FILL_WARP(LPT)                                                                 \
    launch_fill_warp<LPT>(n_pairs, s, static_cast<const uint8_t*>(q),                     \
                          static_cast<const uint8_t*>(t),                                 \
                          static_cast<const int32_t*>(q_lens),                            \
                          static_cast<const int32_t*>(t_lens),                            \
                          static_cast<const int32_t*>(offsets),                           \
                          static_cast<const int32_t*>(k_locals),                          \
                          static_cast<const int8_t*>(matrix), rows_max, t_cols, gap_open, \
                          gap_extend, static_cast<uint8_t*>(tb),                          \
                          static_cast<int32_t*>(best), static_cast<int32_t*>(best_i),     \
                          static_cast<int32_t*>(best_j))
    cudaError_t err;
    if (warp_form(w_pad)) {
        switch (w_pad / 32) {
            case 4: err = KTS_FILL_WARP(4); break;
            case 8: err = KTS_FILL_WARP(8); break;
            case 12: err = KTS_FILL_WARP(12); break;
            case 16: err = KTS_FILL_WARP(16); break;
            case 20: err = KTS_FILL_WARP(20); break;
            case 24: err = KTS_FILL_WARP(24); break;
            case 28: err = KTS_FILL_WARP(28); break;
            default: err = KTS_FILL_WARP(32); break;
        }
    } else if (w_pad <= MAX_THREADS) err = KTS_FILL(1);
    else if (w_pad <= 2 * MAX_THREADS) err = KTS_FILL(2);
    else if (w_pad <= 4 * MAX_THREADS) err = KTS_FILL(4);
    else if (w_pad <= 8 * MAX_THREADS) err = KTS_FILL(8);
    else err = KTS_FILL(16);
#undef KTS_FILL
#undef KTS_FILL_WARP
    return (int)err;
}

int kts_swg_traceback(const void* tb, const void* q, const void* t, const void* best,
                      const void* best_i, const void* best_j, const void* offsets,
                      int n_pairs, int rows_max, int w_pad, int t_cols, int t_pad, void* out,
                      void* stream) {
    if (n_pairs == 0) return (int)cudaSuccess;
    swg_traceback_kernel<<<(n_pairs + TRACEBACK_WARPS - 1) / TRACEBACK_WARPS,
                           TRACEBACK_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
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
    swg_traceback_cigar_kernel<<<(n_pairs + TRACEBACK_WARPS - 1) / TRACEBACK_WARPS,
                                 TRACEBACK_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(tb), static_cast<const uint8_t*>(q),
        static_cast<const uint8_t*>(t), static_cast<const int32_t*>(best),
        static_cast<const int32_t*>(best_i), static_cast<const int32_t*>(best_j),
        static_cast<const int32_t*>(offsets), n_pairs, rows_max, w_pad, t_cols, t_pad,
        static_cast<int32_t*>(out), static_cast<int32_t*>(ops), static_cast<int32_t*>(n_ops),
        static_cast<uint8_t*>(overflow));
    return (int)cudaGetLastError();
}

}  // extern "C"
