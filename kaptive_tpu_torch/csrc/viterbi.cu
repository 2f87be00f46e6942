// Viterbi decodes of the BGC toolkit for NVIDIA Hopper (sm_90a).
//
// Each decode is the counterpart of an XLA program of the JAX package (neither
// has a Pallas source):
//
//   the gene decode (gene_forward_kernel and the five kernels after it) replaces
//     kaptive_tpu/bgc/genefinder.py::_viterbi_states: the forward lax.scan of
//     the 7-state codon-phase HMM (N, C0, C1, C2, I0, I1, I2) over every
//     position of a contig strand, and the reverse lax.scan that walks the
//     backpointers from the best last state;
//   arch_viterbi_kernel replaces kaptive_tpu/bgc/kernels.py::architectural_viterbi:
//     the max-plus decode over a contig's ORF emission rows with a forced end
//     in POST (the last state), up to MAX_ARCH_STATES states; above that,
//     arch_viterbi_wide_kernel (a block a contig and a warp a state over the
//     transitions transposed, 16- or 32-bit backpointers).
//
// Both compute what the XLA programs compute, bit for bit: every operation is
// a float32 add, max or subtract in the JAX package's order, and each pick
// takes the first candidate among equals.  Build without --use_fast_math: nvcc
// then neither reorders nor contracts float32 adds.  The plain PyTorch forms
// are kaptive_tpu_torch/ops/viterbi.py::gene_viterbi_plain and
// ::arch_viterbi_plain; tests/test_torch_viterbi_chunked.py holds numpy models
// of both algorithms to them and to the JAX package.
//
// Built by kaptive_tpu_torch/ops/viterbi_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with a plain C interface, loaded with ctypes.
//
// What bounds the gene decode.  A step reads 12 bytes (codon emission, entry
// and exit scores) and writes one state byte: 13 bytes, ~0.045 ms for the two
// 5.77 M-step strands of a 5.3 Mb contig at 3.35 TB/s.  But step i needs the
// seven scores of step i-1, and one strand is a chain of 5.77 M such steps.
// The step renormalises (the best state is exactly 0 after it), so two runs
// that reach a position with the same seven scores, bit for bit, go on
// identically; the design uses that to cut the chain:
//   * Every strand is cut into chunks of GENE_CHUNK positions, and every chunk
//     of every strand of the launch runs at once, one chunk a lane
//     (gene_forward_kernel).  A strand's first chunk starts from the exact
//     start vector (N = 0, the rest -BIG); any other chunk from a guess, the
//     forward run over the GENE_WARMUP positions before it from that vector,
//     without backpointers.  A warp stages its 32 chunks' inputs 32 positions
//     at a time into shared memory with cp.async, one tile ahead, and stores
//     backpointers (seven 3-bit sources packed in a word) a tile at a time.
//   * gene_check_kernel compares, bit for bit, each chunk's start vector with
//     the end vector of the chunk before it, and lists the chunks that differ;
//     gene_forward_kernel re-runs those from that end vector, in rounds, until
//     no start differs.  The first chunk of a strand is exact, so after round
//     r the first r + 1 chunks are: the worst case is the serial chain's time,
//     never another answer.
//   * A strand's pad tail (and any run of one repeated input) never forgets
//     its start: a guess there is always wrong, and the rounds would walk the
//     tail one chunk a round.  With one input repeated, the seven scores come
//     back bit for bit after three steps once they have done so once (the
//     coding states rotate, nothing else moves).  After a round's re-runs,
//     gene_fill_test_kernel tries that on the first differing chunk of each
//     strand, or the chunk after it, whose start is then exact: three steps
//     from it; if the vector is back, gene_fill_kernel writes the three-step
//     pattern over that chunk and every following chunk of the same repeated
//     input, exactly what the steps would give.
//   * The backtrace composes maps: gene_walk_kernel<true> walks each chunk's
//     words back from all seven end states at once (a map from the chunk's end
//     state to the state before it), gene_link_kernel takes a strand's maps 32
//     at a time from its last chunk (the first argmax of its exact end vector)
//     and gives each its end state by a warp's suffix scan of the maps, and
//     gene_walk_kernel<false> walks each chunk once more from its end state
//     and writes the state bytes a tile at a time.
//
// What bounds the architectural decode.  N rows of S = K + 3 states (28 at
// the default K = 25), N a few hundred to tens of thousands of ORFs a contig:
// N x S x S adds and compares and ~4 N S bytes, microseconds of work at the
// card's rates.  The scores are not renormalised, so a contig stays one chain
// of N dependent rows.  One warp a contig, one lane a state (ceil(S / 32)
// states a lane up to MAX_ARCH_STATES): a lane keeps its column of the
// transitions in registers (S <= 32) or reads it from shared memory (S <= 128)
// or the cache; a row broadcasts the previous scores through shared memory
// (a store a lane, a warp barrier, then loads of one address in every lane,
// in place of 32 __shfl_sync a row), adds the S candidates independently and
// reduces them by a tree over (value, index) that keeps the lower index on a
// tie, with no block barrier.  Emission rows
// are staged a tile ahead with cp.async; backpointer bytes are stored a tile
// at a time, and read back a tile ahead while lane 0 walks the tile before.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <map>
#include <math_constants.h>
#include <mutex>
#include <utility>

namespace {

constexpr float NEG = -1.0e9f;  // the JAX package's -BIG clamp
constexpr int N_GENE_STATES = 7;
constexpr int VEC = 8;           // floats kept a chunk for a vector of seven scores
constexpr int GT = 32;           // positions a lane stages at once (a tile)
constexpr int GENE_CHUNK = 1024;   // positions a chunk
constexpr int GENE_WARMUP = 1024;  // positions a chunk's guess runs over before its start
constexpr int FWD_STAGES = 3;    // input tiles gene_forward_kernel keeps in flight or in use
constexpr int WALK_STAGES = 4;   // backpointer tiles gene_walk_kernel keeps in flight or in use
constexpr uint32_t IDENTITY_MAP = 0u | 1u << 3 | 2u << 6 | 3u << 9 | 4u << 12 | 5u << 15 | 6u << 18;
constexpr int NO_CHUNK = 0x7f7f7f7f;  // first_dirty of a strand with none (a memset of 0x7f bytes)
constexpr int MAX_ARCH_STATES = 256;  // backpointers are bytes
constexpr int ARCH_ROWS = 16;         // emission rows a warp stages at once
constexpr int ARCH_BACK_ROWS = 64;    // backpointer rows staged at once for the walk
constexpr int ARCH_SMEM_TRANSITIONS = 128;  // the largest S whose transitions are kept in shared memory
constexpr unsigned FULL = 0xffffffffu;

enum : uint32_t { SN = 0, SC0 = 1, SC1 = 2, SC2 = 3, SI0 = 4, SI1 = 5, SI2 = 6 };

// One candidate of a pick: it replaces the running best only when strictly
// greater, so the first of equal candidates wins (jnp.argmax's rule).
__device__ __forceinline__ void take(float cand, uint32_t src, float& best, uint32_t& arg) {
    if (cand > best) {
        best = cand;
        arg = src;
    }
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ bool same_bits(float a, float b) { return __float_as_uint(a) == __float_as_uint(b); }

// ---- the gene decode ---------------------------------------------------------------------------

// One step of the gene HMM: v (N, C0, C1, C2, I0, I1, I2) becomes the step's
// scores; returns the seven sources packed 3 bits each.
__device__ __forceinline__ uint32_t gene_step(float (&v)[N_GENE_STATES], float ce, float eb, float xb, float indel,
                                              float ins_extend) {
    const float vN = v[0], vC0 = v[1], vC1 = v[2], vC2 = v[3], vI0 = v[4], vI1 = v[5], vI2 = v[6];
    float nN = vN;
    uint32_t bN = SN;
    take(vC2 + xb, SC2, nN, bN);
    float n0 = vN + eb;
    uint32_t b0 = SN;
    take(vC2, SC2, n0, b0);
    take(vC1 + indel, SC1, n0, b0);
    take(vI2, SI2, n0, b0);
    float n1 = vC0;
    uint32_t b1 = SC0;
    take(vC2 + indel, SC2, n1, b1);
    take(vI0, SI0, n1, b1);
    float n2 = vC1;
    uint32_t b2 = SC1;
    take(vC0 + indel, SC0, n2, b2);
    take(vI1, SI1, n2, b2);
    n2 = n2 + ce;
    float n4 = vC0 + indel;
    uint32_t b4 = SC0;
    take(vI0 + ins_extend, SI0, n4, b4);
    float n5 = vC1 + indel;
    uint32_t b5 = SC1;
    take(vI1 + ins_extend, SI1, n5, b5);
    float n6 = vC2 + indel;
    uint32_t b6 = SC2;
    take(vI2 + ins_extend, SI2, n6, b6);
    nN = fmaxf(nN, NEG);
    n0 = fmaxf(n0, NEG);
    n1 = fmaxf(n1, NEG);
    n2 = fmaxf(n2, NEG);
    n4 = fmaxf(n4, NEG);
    n5 = fmaxf(n5, NEG);
    n6 = fmaxf(n6, NEG);
    const float m = fmaxf(fmaxf(fmaxf(nN, n0), fmaxf(n1, n2)), fmaxf(fmaxf(n4, n5), n6));
    v[0] = nN - m;
    v[1] = n0 - m;
    v[2] = n1 - m;
    v[3] = n2 - m;
    v[4] = n4 - m;
    v[5] = n5 - m;
    v[6] = n6 - m;
    return bN | b0 << 3 | b1 << 6 | b2 << 9 | b4 << 12 | b5 << 15 | b6 << 18;
}

__device__ __forceinline__ void start_vector(float (&v)[N_GENE_STATES]) {
#pragma unroll
    for (int k = 0; k < N_GENE_STATES; ++k) v[k] = k == 0 ? 0.f : NEG;
}

// The chunk table: four int64 a chunk, [start, end) of its positions, the
// start of its strand, and its strand's index.
struct Chunk {
    long long start, end, base;
    int chain;
};

__device__ __forceinline__ Chunk load_chunk(const long long* chunks, int c) {
    return {chunks[4 * c], chunks[4 * c + 1], chunks[4 * c + 2], (int)chunks[4 * c + 3]};
}

// The forward pass of 32 chunks a warp, one a lane.  The first pass (RERUN
// false) takes chunk `item` and starts it from its guess: `warmup` positions
// (fewer at its strand's start) from the start vector, then the chunk; it
// writes the start vector it guessed (vin), the end vector (vout) and whether
// the chunk's inputs are one repeated value (cflag, cval).  A re-run takes
// chunk `items[item]` and starts it from vin.  Both write the chunk's packed
// backpointers.
template <bool RERUN>
__global__ void __launch_bounds__(32) gene_forward_kernel(
    const float* __restrict__ ce_g, const float* __restrict__ eb_g, const float* __restrict__ xb_g,
    const long long* __restrict__ chunks, const int* __restrict__ items, int n_items, int chunk, int warmup,
    float indel, float ins_extend, uint32_t* __restrict__ back, float* __restrict__ vin,
    float* __restrict__ vout, float* __restrict__ cval, int* __restrict__ cflag) {
    __shared__ float s_in[FWD_STAGES][3][32][GT + 1];
    __shared__ uint32_t s_bk[32][GT + 1];
    __shared__ long long s_start[32];
    __shared__ int s_lo[32], s_len[32];  // live positions [start + lo, start + len)

    const int lane = threadIdx.x;
    const int item = blockIdx.x * 32 + lane;
    const bool has = item < n_items;
    const int n_lanes = n_items - blockIdx.x * 32 < 32 ? n_items - blockIdx.x * 32 : 32;  // chunks of this warp
    const int c = has ? (RERUN ? items[item] : item) : 0;
    const Chunk ch = has ? load_chunk(chunks, c) : Chunk{0, 0, 0, 0};
    const int len = (int)(ch.end - ch.start);
    const int lo = RERUN ? 0 : -(int)(ch.start - ch.base < warmup ? ch.start - ch.base : warmup);
    s_start[lane] = ch.start;
    s_lo[lane] = lo;
    s_len[lane] = len;
    const int pre = RERUN ? 0 : (warmup + GT - 1) / GT;  // warm-up tiles
    const int n_tiles = pre + (chunk + GT - 1) / GT;

    float v[N_GENE_STATES];
    if (RERUN) {
#pragma unroll
        for (int k = 0; k < N_GENE_STATES; ++k) v[k] = vin[VEC * c + k];
    } else {
        start_vector(v);
    }
    float c_ce = 0.f, c_eb = 0.f, c_xb = 0.f;
    if (!RERUN && len > 0) {
        c_ce = ce_g[ch.start];
        c_eb = eb_g[ch.start];
        c_xb = xb_g[ch.start];
    }
    bool constant = true;
    __syncwarp();

    // Tile t holds, for each chunk j of the warp, its positions start_j + (t - pre) * GT + [0, GT).
    auto stage = [&](int t, int buf) {
        const int r = (t - pre) * GT + lane;
#pragma unroll 4
        for (int j = 0; j < n_lanes; ++j) {
            const bool live = r >= s_lo[j] && r < s_len[j];
            const long long p = live ? s_start[j] + r : 0;
            cp_async4(&s_in[buf][0][j][lane], ce_g + p, live);
            cp_async4(&s_in[buf][1][j][lane], eb_g + p, live);
            cp_async4(&s_in[buf][2][j][lane], xb_g + p, live);
        }
        cp_async_commit();
    };

    float v_start[N_GENE_STATES];
#pragma unroll
    for (int k = 0; k < N_GENE_STATES; ++k) v_start[k] = v[k];
    // Step position r0 + i of tile `buf` for this lane's chunk.
    auto step_at = [&](int buf, int i, bool body) {
        const float ce = s_in[buf][0][lane][i], eb = s_in[buf][1][lane][i], xb = s_in[buf][2][lane][i];
        const uint32_t word = gene_step(v, ce, eb, xb, indel, ins_extend);
        if (body) {
            s_bk[lane][i] = word;
            if (!RERUN) constant = constant && same_bits(ce, c_ce) && same_bits(eb, c_eb) && same_bits(xb, c_xb);
        }
    };
    for (int t = 0; t < FWD_STAGES - 1; ++t) {
        if (t < n_tiles) {
            stage(t, t);
        } else {
            cp_async_commit();
        }
    }
    for (int t = 0; t < n_tiles; ++t) {
        const int ahead = t + FWD_STAGES - 1;
        if (ahead < n_tiles) {
            stage(ahead, ahead % FWD_STAGES);  // the buffer of tile t - 1, which every lane is done with
        } else {
            cp_async_commit();  // an empty group keeps the count of pending groups fixed
        }
        cp_async_wait<FWD_STAGES - 1>();
        __syncwarp();
        const int buf = t % FWD_STAGES;
        if (!RERUN && t == pre) {
#pragma unroll
            for (int k = 0; k < N_GENE_STATES; ++k) v_start[k] = v[k];
        }
        const int r0 = (t - pre) * GT;
        const bool body = t >= pre;
        if (r0 >= lo && r0 + GT <= len) {  // the whole tile is live
#pragma unroll 4
            for (int i = 0; i < GT; ++i) step_at(buf, i, body);
        } else {
#pragma unroll 4
            for (int i = 0; i < GT; ++i) {
                if (r0 + i >= lo && r0 + i < len) step_at(buf, i, body);
            }
        }
        __syncwarp();
        if (body) {
            const int r = r0 + lane;
#pragma unroll 4
            for (int j = 0; j < n_lanes; ++j) {
                if (r < s_len[j]) back[s_start[j] + r] = s_bk[j][lane];
            }
        }
        __syncwarp();
    }
    cp_async_wait<0>();
    if (!has) return;
#pragma unroll
    for (int k = 0; k < N_GENE_STATES; ++k) vout[VEC * c + k] = v[k];
    if (!RERUN) {
#pragma unroll
        for (int k = 0; k < N_GENE_STATES; ++k) vin[VEC * c + k] = v_start[k];
        cval[4 * c] = c_ce;
        cval[4 * c + 1] = c_eb;
        cval[4 * c + 2] = c_xb;
        cflag[c] = constant ? 1 : 0;
    }
}

// Compares each chunk's start vector with the end vector of the chunk before
// it (a strand's first chunk starts from the exact vector); a chunk that
// differs takes that end vector as its start and is listed for a re-run, and
// its strand's first such chunk is kept.
__global__ void gene_check_kernel(const long long* __restrict__ chunks, int n_chunks, float* __restrict__ vin,
                                  const float* __restrict__ vout, int* __restrict__ dirty, int* __restrict__ counters,
                                  int* __restrict__ first_dirty) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= n_chunks) return;
    const Chunk ch = load_chunk(chunks, c);
    if (ch.start == ch.base) return;
    bool same = true;
#pragma unroll
    for (int k = 0; k < N_GENE_STATES; ++k) same = same && same_bits(vin[VEC * c + k], vout[VEC * (c - 1) + k]);
    if (same) return;
#pragma unroll
    for (int k = 0; k < N_GENE_STATES; ++k) vin[VEC * c + k] = vout[VEC * (c - 1) + k];
    dirty[atomicAdd(&counters[0], 1)] = c;
    atomicMin(&first_dirty[ch.chain], c);
}

// Per strand, one warp, after the round's re-runs.  The strand's first
// differing chunk k0 started exactly, so it now ends exactly too.  A chunk k,
// k0 or else k0 + 1, whose start (the end of chunk k - 1) is thus exact and
// whose input is one repeated value: if three steps of that input bring its
// start vector back bit for bit, the vector and the backpointer word repeat
// every three positions from there for as long as the input repeats.  Keeps k
// and the last chunk m of that run (runs[2 chain], runs[2 chain + 1]; m = -1
// for none) and the three steps' vectors and words (pattern[chain]).
__global__ void __launch_bounds__(32) gene_fill_test_kernel(
    const long long* __restrict__ chain_chunks, const int* __restrict__ first_dirty, const int* __restrict__ cflag,
    const float* __restrict__ cval, const float* __restrict__ vout, float indel, float ins_extend,
    int* __restrict__ runs, float* __restrict__ pattern) {
    const int chain = blockIdx.x, lane = threadIdx.x;
    const int end = (int)chain_chunks[chain + 1];
    const int k0 = first_dirty[chain];
    int k = NO_CHUNK;
    float u[3][N_GENE_STATES];
    uint32_t w[3];
    for (int cand = k0; k == NO_CHUNK && k0 != NO_CHUNK && cand <= k0 + 1 && cand < end; ++cand) {
        if (!cflag[cand]) continue;
        float x[N_GENE_STATES];
#pragma unroll
        for (int q = 0; q < N_GENE_STATES; ++q) x[q] = vout[VEC * (cand - 1) + q];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            w[j] = gene_step(x, cval[4 * cand], cval[4 * cand + 1], cval[4 * cand + 2], indel, ins_extend);
#pragma unroll
            for (int q = 0; q < N_GENE_STATES; ++q) u[j][q] = x[q];
        }
        bool periodic = true;
#pragma unroll
        for (int q = 0; q < N_GENE_STATES; ++q) periodic = periodic && same_bits(u[2][q], vout[VEC * (cand - 1) + q]);
        if (periodic) k = cand;
    }
    if (k == NO_CHUNK) {
        if (lane == 0) runs[2 * chain + 1] = -1;
        return;
    }
    const float ce = cval[4 * k], eb = cval[4 * k + 1], xb = cval[4 * k + 2];
    // The run: chunk k and every following chunk of the strand with the same repeated input.
    int m = k;
    for (int base = k + 1; base < end; base += 32) {
        const int j = base + lane;
        const bool same = j < end && cflag[j] && same_bits(cval[4 * j], ce) && same_bits(cval[4 * j + 1], eb) &&
                          same_bits(cval[4 * j + 2], xb);
        const unsigned differ = __ballot_sync(FULL, !same);
        if (differ) {
            m = base + __ffs(differ) - 2;
            break;
        }
        m = base + 31;
    }
    if (lane == 0) {
        runs[2 * chain] = k;
        runs[2 * chain + 1] = m;
        float* pat = pattern + 32 * chain;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
#pragma unroll
            for (int q = 0; q < N_GENE_STATES; ++q) pat[VEC * j + q] = u[j][q];
            pat[24 + j] = __uint_as_float(w[j]);
        }
    }
}

// One block a chunk: a chunk inside its strand's run (gene_fill_test_kernel)
// takes the three-step pattern: position p's word is the pattern's word
// (p - start_k) mod 3, its end vector likewise, and its start vector the end
// vector of the chunk before it (for chunk k, the start it was tested from).
__global__ void gene_fill_kernel(const long long* __restrict__ chunks, const int* __restrict__ runs,
                                 const float* __restrict__ pattern, uint32_t* __restrict__ back,
                                 float* __restrict__ vin, float* __restrict__ vout, int* __restrict__ counters) {
    const int c = blockIdx.x;
    const Chunk ch = load_chunk(chunks, c);
    const int k = runs[2 * ch.chain], m = runs[2 * ch.chain + 1];
    if (m < 0 || c < k || c > m) return;
    const long long s_k = chunks[4 * k];
    const float* pat = pattern + 32 * ch.chain;
    const uint32_t w[3] = {__float_as_uint(pat[24]), __float_as_uint(pat[25]), __float_as_uint(pat[26])};
    for (long long p = ch.start + threadIdx.x; p < ch.end; p += blockDim.x) back[p] = w[(p - s_k) % 3];
    if (threadIdx.x == 0) {
        const int last = (int)((ch.end - 1 - s_k) % 3);
#pragma unroll
        for (int q = 0; q < N_GENE_STATES; ++q) vout[VEC * c + q] = pat[VEC * last + q];
        const int before = (int)((ch.start - 1 - s_k + 3) % 3);  // 2 for chunk k: its start, u2
#pragma unroll
        for (int q = 0; q < N_GENE_STATES; ++q) vin[VEC * c + q] = pat[VEC * before + q];
        atomicAdd(&counters[1], 1);
    }
}

// Walks 32 chunks a warp back from their ends, one a lane, a tile of
// backpointer words at a time (staged one tile ahead with cp.async).  MAP:
// from all seven end states at once; writes the chunk's map (the state before
// the chunk for each end state, 3 bits each).  Otherwise from the chunk's end
// state (xend); writes the state bytes.
template <bool MAP>
__global__ void __launch_bounds__(32) gene_walk_kernel(const long long* __restrict__ chunks, int n_chunks, int chunk,
                                                       const uint32_t* __restrict__ back,
                                                       uint32_t* __restrict__ maps, const int* __restrict__ xend,
                                                       int8_t* __restrict__ states) {
    __shared__ uint32_t s_bk[WALK_STAGES][32][GT + 1];
    __shared__ int8_t s_st[32][GT + 4];
    __shared__ long long s_end[32];
    __shared__ int s_len[32];

    const int lane = threadIdx.x;
    const int c = blockIdx.x * 32 + lane;
    const bool has = c < n_chunks;
    const int n_lanes = n_chunks - blockIdx.x * 32 < 32 ? n_chunks - blockIdx.x * 32 : 32;  // chunks of this warp
    const Chunk ch = has ? load_chunk(chunks, c) : Chunk{0, 0, 0, 0};
    const int len = (int)(ch.end - ch.start);
    s_end[lane] = ch.end;
    s_len[lane] = len;
    const int n_tiles = (chunk + GT - 1) / GT;
    __syncwarp();

    // Tile t holds, for each chunk j, its positions end_j - GT * (t + 1) + [0, GT).
    auto stage = [&](int t, int buf) {
        const int r = -GT * (t + 1) + lane;  // from the chunk's end
#pragma unroll 4
        for (int j = 0; j < n_lanes; ++j) {
            const bool live = r >= -s_len[j];
            cp_async4(&s_bk[buf][j][lane], back + (live ? s_end[j] + r : 0), live);
        }
        cp_async_commit();
    };

    uint32_t x[MAP ? N_GENE_STATES : 1];
    if constexpr (MAP) {
#pragma unroll
        for (int q = 0; q < N_GENE_STATES; ++q) x[q] = q;
    } else {
        x[0] = has ? (uint32_t)xend[c] : 0u;
    }
    for (int t = 0; t < WALK_STAGES - 1; ++t) {
        if (t < n_tiles) {
            stage(t, t);
        } else {
            cp_async_commit();
        }
    }
    for (int t = 0; t < n_tiles; ++t) {
        const int ahead = t + WALK_STAGES - 1;
        if (ahead < n_tiles) {
            stage(ahead, ahead % WALK_STAGES);
        } else {
            cp_async_commit();
        }
        cp_async_wait<WALK_STAGES - 1>();
        __syncwarp();
        const int buf = t % WALK_STAGES;
        const int r0 = -GT * (t + 1);
#pragma unroll 4
        for (int i = GT - 1; i >= 0; --i) {
            if (r0 + i >= -len) {
                const uint32_t word = s_bk[buf][lane][i];
                if constexpr (MAP) {
#pragma unroll
                    for (int q = 0; q < N_GENE_STATES; ++q) x[q] = (word >> (3 * x[q])) & 7u;
                } else {
                    s_st[lane][i] = (int8_t)x[0];
                    x[0] = (word >> (3 * x[0])) & 7u;
                }
            }
        }
        __syncwarp();
        if (!MAP) {
            const int r = r0 + lane;
#pragma unroll 4
            for (int j = 0; j < n_lanes; ++j) {
                if (r >= -s_len[j]) states[s_end[j] + r] = s_st[j][lane];
            }
        }
        __syncwarp();
    }
    cp_async_wait<0>();
    if (MAP && has) {
        uint32_t packed = 0;
#pragma unroll
        for (int q = 0; q < N_GENE_STATES; ++q) packed |= x[q] << (3 * q);
        maps[c] = packed;
    }
}

// (f o g)(x) = f(g(x)) for maps of the seven states, 3 bits an entry.
__device__ __forceinline__ uint32_t compose(uint32_t f, uint32_t g) {
    uint32_t r = 0;
#pragma unroll
    for (int x = 0; x < N_GENE_STATES; ++x) {
        const uint32_t gx = (g >> (3 * x)) & 7u;
        r |= ((f >> (3 * gx)) & 7u) << (3 * x);
    }
    return r;
}

// One step of the warp's suffix scan of maps: lane i composes its map with lane i + D's.
template <int D>
__device__ __forceinline__ uint32_t suffix_step(uint32_t m, int lane) {
    const uint32_t later = __shfl_down_sync(FULL, m, D);
    return lane + D < 32 ? compose(m, later) : m;
}

// One warp a strand: its last state is the first argmax of its last chunk's
// end vector.  The chunk before chunk k ends in map_k(end state of k); the warp
// takes the strand's chunks 32 at a time from the last, lane i holding chunk
// hi - 31 + i, and a suffix scan of the 32 maps gives every chunk of the group
// its end state at once, and the state the group before ends in.
__global__ void __launch_bounds__(32) gene_link_kernel(const long long* __restrict__ chain_chunks,
                                                       const float* __restrict__ vout,
                                                       const uint32_t* __restrict__ maps, int* __restrict__ xend) {
    const int chain = blockIdx.x, lane = threadIdx.x;
    const int first = (int)chain_chunks[chain], last = (int)chain_chunks[chain + 1] - 1;
    if (last < first) return;
    uint32_t x = SN;
    {
        float best = vout[VEC * last];
#pragma unroll
        for (int q = 1; q < N_GENE_STATES; ++q) take(vout[VEC * last + q], (uint32_t)q, best, x);
    }
    uint32_t next = last - 31 + lane >= first ? maps[last - 31 + lane] : IDENTITY_MAP;
    for (int hi = last; hi >= first; hi -= 32) {
        const int k = hi - 31 + lane;
        uint32_t m = next;
        next = k - 32 >= first ? maps[k - 32] : IDENTITY_MAP;  // the group before, loaded ahead
        m = suffix_step<1>(m, lane);  // now lane i holds map_i o ... o map_31 of the group
        m = suffix_step<2>(m, lane);
        m = suffix_step<4>(m, lane);
        m = suffix_step<8>(m, lane);
        m = suffix_step<16>(m, lane);
        const uint32_t after = __shfl_down_sync(FULL, m, 1);  // lane i + 1's: the end state of chunk k
        if (k >= first) xend[k] = (int)(lane == 31 ? x : (after >> (3 * x)) & 7u);
        x = (__shfl_sync(FULL, m, 0) >> (3 * x)) & 7u;
    }
}

// ---- the architectural decode ------------------------------------------------------------------

// One level of tree_pick: the pair (q, q + D) keeps q unless q + D is strictly greater.
template <int D>
__device__ __forceinline__ void tree_level(float (&val)[32], int (&idx)[32]) {
#pragma unroll
    for (int q = 0; q < 32; q += 2 * D) {
        if (val[q + D] > val[q]) {
            val[q] = val[q + D];
            idx[q] = idx[q + D];
        }
    }
}

// The first maximum of 32 candidates: a tree over (value, index) pairs of
// neighbours that keeps the left, lower, index unless the right is strictly
// greater.  Leaves at index base + q.  Every level is written out, so every
// index is a constant and the candidates stay in registers.
__device__ __forceinline__ void tree_pick(float (&val)[32], int base, float& best, int& arg) {
    int idx[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) idx[q] = base + q;
    tree_level<1>(val, idx);
    tree_level<2>(val, idx);
    tree_level<4>(val, idx);
    tree_level<8>(val, idx);
    tree_level<16>(val, idx);
    best = val[0];
    arg = idx[0];
}

// One warp a contig; lane l holds the states l + 32 r, r < R.  The
// transitions' columns are in registers (R == 1) or read through `tsrc`, in
// shared memory or device memory (R > 1).  Dynamic shared memory: the
// emission tiles (2 x ARCH_ROWS x S floats), the backpointer tile
// (ARCH_ROWS x pitch bytes), the walk's two backpointer tiles
// (ARCH_BACK_ROWS x pitch bytes each, in the emission tiles' room when it is
// free) and path tile, then the transitions when they are kept there.
template <int R>
__global__ void __launch_bounds__(32) arch_viterbi_kernel(
    const float* __restrict__ emissions, const float* __restrict__ transitions, const long long* __restrict__ offsets,
    long long rows, int S, int pitch, int trans_smem, uint8_t* __restrict__ back, int* __restrict__ paths,
    float* __restrict__ scores) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ __align__(16) float s_prev[MAX_ARCH_STATES];  // the previous row's scores
    const int lane = threadIdx.x;
    const long long row0 = offsets[blockIdx.x];
    const long long n = offsets[blockIdx.x + 1] - row0;
    if (n <= 0 || row0 < 0 || row0 + n > rows) return;  // empty, or bounds outside the emissions

    const int em_tile = ARCH_ROWS * S;
    const int fwd_bytes = 2 * em_tile * 4 + ARCH_ROWS * pitch;
    const int bwd_bytes = 2 * ARCH_BACK_ROWS * pitch + ARCH_BACK_ROWS * 4;
    const int room = ((fwd_bytes > bwd_bytes ? fwd_bytes : bwd_bytes) + 15) / 16 * 16;
    float* s_em = reinterpret_cast<float*>(smem);
    uint8_t* s_bk = smem + 2 * em_tile * 4;
    float* s_trans = reinterpret_cast<float*>(smem + room);
    const float* em = emissions + row0 * S;
    uint8_t* bk = back + row0 * pitch;

    const float* tsrc = transitions;
    if (R > 1 && trans_smem) {
        for (int f = lane; f < S * S; f += 32) s_trans[f] = transitions[f];
        __syncwarp();
        tsrc = s_trans;
    }
    float tcol[R == 1 ? 32 : 1];
    if constexpr (R == 1) {
#pragma unroll
        for (int q = 0; q < 32; ++q) tcol[q] = (q < S && lane < S) ? transitions[q * S + lane] : -CUDART_INF_F;
    }

    float cur[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int s = lane + 32 * r;
        cur[r] = s < S ? transitions[s] + em[s] : -CUDART_INF_F;  // transitions[0] + emissions[0]
    }

    // Emission tile t: rows t * ARCH_ROWS + [0, ARCH_ROWS) of the contig, S floats a row.
    auto stage = [&](long long t, int buf) {
        const long long first = t * ARCH_ROWS;
        const long long live_f = (n - first < ARCH_ROWS ? n - first : ARCH_ROWS) * S;
        for (int f = lane; f < em_tile; f += 32) {
            const bool live = f < live_f;
            cp_async4(&s_em[buf * em_tile + f], em + (live ? first * S + f : 0), live);
        }
        cp_async_commit();
    };

    const long long n_tiles = (n + ARCH_ROWS - 1) / ARCH_ROWS;
    stage(0, 0);
    for (long long t = 0; t < n_tiles; ++t) {
        const int buf = (int)(t & 1);
        if (t + 1 < n_tiles) {
            stage(t + 1, buf ^ 1);
        } else {
            cp_async_commit();
        }
        cp_async_wait<1>();
        __syncwarp();
        const int n_rows = (int)(n - t * ARCH_ROWS < ARCH_ROWS ? n - t * ARCH_ROWS : ARCH_ROWS);
        const float* tile = s_em + buf * em_tile;
        for (int i = (t == 0 ? 1 : 0); i < n_rows; ++i) {
            float best[R];
            int arg[R];
#pragma unroll
            for (int r = 0; r < R; ++r) s_prev[lane + 32 * r] = cur[r];
            __syncwarp();
#pragma unroll
            for (int rb = 0; rb < R; ++rb) {  // predecessors 32 rb + [0, 32)
                float pv[32];
#pragma unroll
                for (int q = 0; q < 32; ++q) pv[q] = s_prev[32 * rb + q];  // the same address in every lane
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const int s = lane + 32 * r;
                    float cand[32];
                    if constexpr (R == 1) {
#pragma unroll
                        for (int q = 0; q < 32; ++q) cand[q] = pv[q] + tcol[q];
                    } else {
#pragma unroll
                        for (int q = 0; q < 32; ++q) {
                            const int p = 32 * rb + q;
                            cand[q] = (p < S && s < S) ? pv[q] + tsrc[p * S + s] : -CUDART_INF_F;
                        }
                    }
                    float b;
                    int a;
                    tree_pick(cand, 32 * rb, b, a);
                    if (rb == 0 || b > best[r]) {
                        best[r] = b;
                        arg[r] = a;
                    }
                }
            }
            __syncwarp();  // every lane has read s_prev before it is written again
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int s = lane + 32 * r;
                if (s < S) {
                    cur[r] = best[r] + tile[i * S + s];
                    s_bk[i * pitch + s] = (uint8_t)arg[r];
                }
            }
        }
        __syncwarp();
        // Store the tile's backpointer rows (pitch bytes each, 16-byte aligned) with 16-byte stores.
        const int chunks16 = n_rows * pitch / 16;
        uint4* dst = reinterpret_cast<uint4*>(bk + t * ARCH_ROWS * pitch);
        const uint4* src = reinterpret_cast<const uint4*>(s_bk);
        for (int f = lane; f < chunks16; f += 32) dst[f] = src[f];
        __syncwarp();
    }
    cp_async_wait<0>();
#pragma unroll
    for (int r = 0; r < R; ++r) {
        if (lane + 32 * r == S - 1) scores[blockIdx.x] = cur[r];
    }
    __syncwarp();

    // The walk back from POST, in tiles of ARCH_BACK_ROWS rows from the end; the
    // tile before is staged while lane 0 walks.
    uint8_t* w_bk = smem;  // two tiles of ARCH_BACK_ROWS x pitch bytes
    int* w_path = reinterpret_cast<int*>(smem + 2 * ARCH_BACK_ROWS * pitch);
    const int back_tile = ARCH_BACK_ROWS * pitch;
    const long long n_back = (n + ARCH_BACK_ROWS - 1) / ARCH_BACK_ROWS;
    auto stage_back = [&](long long t, int buf) {  // tile t holds rows [n - (t + 1) B, n - t B) clipped at 0
        const long long hi = n - t * ARCH_BACK_ROWS;
        const long long lo = hi - ARCH_BACK_ROWS > 0 ? hi - ARCH_BACK_ROWS : 0;
        const int chunks16 = (int)(hi - lo) * pitch / 16;
        for (int f = lane; f < chunks16; f += 32) cp_async16(w_bk + buf * back_tile + 16 * f, bk + lo * pitch + 16 * f);
        cp_async_commit();
    };
    int state = S - 1;  // forced end in POST
    stage_back(0, 0);
    for (long long t = 0; t < n_back; ++t) {
        const int buf = (int)(t & 1);
        if (t + 1 < n_back) {
            stage_back(t + 1, buf ^ 1);
        } else {
            cp_async_commit();
        }
        cp_async_wait<1>();
        __syncwarp();
        const long long hi = n - t * ARCH_BACK_ROWS;
        const long long lo = hi - ARCH_BACK_ROWS > 0 ? hi - ARCH_BACK_ROWS : 0;
        const int rows_here = (int)(hi - lo);
        if (lane == 0) {
            const uint8_t* tb = w_bk + buf * back_tile;
            const int last = lo == 0 ? 1 : 0;  // the contig's row 0 has no predecessor
            for (int i = rows_here - 1; i >= last; --i) {
                w_path[i] = state;
                state = tb[i * pitch + state];
            }
            if (last) w_path[0] = state;
        }
        __syncwarp();
        for (int f = lane; f < rows_here; f += 32) paths[row0 + lo + f] = w_path[f];
        __syncwarp();
    }
    cp_async_wait<0>();
}

// The architectural decode above MAX_ARCH_STATES states: a thread-block cluster of C CTAs of
// ARCH_WIDE_THREADS a contig (C up to ARCH_WIDE_MAX_CLUSTER, the most at which every contig's
// cluster runs at once; C = 1 when the contigs fill the card), CTA `rank` holding the states
// [rank * per, ...), and a warp a state.  Warp w of a CTA takes its states w, w + 32, ..., G at a
// time (independent chains: G = 2 in a cluster, 4 alone).  For state s lane l scans the
// predecessors of float4 chunks l, l + 32, ... (p = 4c .. 4c + 3), then the predecessors past the
// last whole round of 32 chunks one at a time (p = tail + l, tail + l + 32, ...), so a lane meets
// its predecessors in increasing order and keeps the first maximum with the strict `take`.  The
// transitions come transposed (`tt`, S rows of `pitch` floats, -inf past S), so a state's
// predecessor column is one contiguous row: the CTA copies its first `tt_smem` states' rows into
// shared memory once a contig and reads the rest through L1 / L2.  The warp then reduces its 32
// (value, index) pairs with two warp reductions: the greatest pick_key (order-preserving, -0 as
// +0, NaN above every number), then the lowest index among the lanes that hold it; the value comes
// from the lane that holds that index.  That is jnp.argmax's first maximum, and it is what one
// strict `take` chain over p = 0 .. S-1 picks for every input: a chain keeps a NaN only when it
// is the first candidate, so lane 0 takes its first candidate unconditionally and every other lane
// starts from (-inf, its first index).  Every CTA keeps the whole previous row in shared memory
// (two rows of `pitch` floats, -inf past S); a state's new score is stored into every CTA's copy
// through distributed shared memory, and a row ends with one cluster barrier (release / acquire:
// the double-buffered rows are never written while a neighbour may read them).  Each CTA's
// emissions come through a ring of ARCH_WIDE_EM_RING rows prefetched with cp.async (STAGED; past
// ARCH_WIDE_STAGED_PITCH the rows live in `work`, one copy a contig, and the emissions are read in
// place).  Backpointers are BP (uint16 up to 65,536 states, int32 beyond) at `bpitch` a row; after
// the last barrier rank 0's thread 0 walks them back from POST through tiles of `walk_rows` rows
// staged with cp.async (tile t + 1 in flight while tile t is walked), or from device memory when
// not even one row pair fits (`walk_rows` 0).
// What bounds it: a contig is one chain of rows, and a row is S x S adds and compares, about five
// instructions each, a reduction a state and a cluster barrier; the default K = 25 (S = 28) never
// reaches it.
constexpr int ARCH_WIDE_THREADS = 1024;
constexpr int ARCH_WIDE_WARPS = ARCH_WIDE_THREADS / 32;
constexpr int ARCH_WIDE_EM_RING = 8;           // emission rows in flight or in use (a ring)
constexpr int ARCH_WIDE_WALK_ROWS = 64;        // backpointer rows a walk tile holds at most
constexpr int ARCH_WIDE_STAGED_PITCH = 4096;   // the widest rows kept in shared memory (40 bytes a pitch float)
constexpr int ARCH_WIDE_MAX_CLUSTER = 8;       // CTAs a contig's cluster at most (the portable size;
                                               // measure_input_range.py times it against 4)

// An order-preserving key of a pick's value: -0 as +0, NaN above every number.
__device__ __forceinline__ uint32_t pick_key(float v) {
    const uint32_t u = v == 0.0f ? 0u : __float_as_uint(v);
    const uint32_t key = u ^ ((uint32_t)((int)u >> 31) | 0x80000000u);  // ~u when negative, else u | 2^31
    return v != v ? 0xffffffffu : key;
}

template <typename BP, bool STAGED, int G>
__global__ void __launch_bounds__(ARCH_WIDE_THREADS) arch_viterbi_wide_kernel(
    const float* __restrict__ emissions, const float* __restrict__ transitions, const float* __restrict__ tt,
    const long long* __restrict__ offsets, long long rows, int S, int pitch, int tt_smem, BP* __restrict__ back,
    int bpitch, int walk_rows, int* __restrict__ paths, float* __restrict__ scores, float* work) {
    namespace cg = cooperative_groups;
    extern __shared__ __align__(16) unsigned char smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
    const int contig = blockIdx.x / C;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long row0 = offsets[contig];
    const long long n = offsets[contig + 1] - row0;
    if (n <= 0 || row0 < 0 || row0 + n > rows) return;  // empty, or bounds outside: the whole cluster leaves
    const int per = (S + C - 1) / C;  // this CTA's states: [lo, hi)
    const int lo = rank * per, hi = min(S, lo + per);
    const float* em = emissions + row0 * S;
    BP* bk = back + row0 * bpitch;
    float* rowbuf = STAGED ? reinterpret_cast<float*>(smem) : work + (size_t)contig * 2 * pitch;
    float* s_em = reinterpret_cast<float*>(smem) + 2 * pitch;  // STAGED: a ring of emission rows
    float* s_tt = reinterpret_cast<float*>(smem) + (STAGED ? (2 + ARCH_WIDE_EM_RING) * pitch : 0);  // tt rows lo ...

    {
        const float4* src = reinterpret_cast<const float4*>(tt + (size_t)lo * pitch);
        float4* dst = reinterpret_cast<float4*>(s_tt);
        const long long n4 = (long long)max(0, min(tt_smem, hi - lo)) * pitch / 4;
        for (long long f = tid; f < n4; f += ARCH_WIDE_THREADS) dst[f] = src[f];
    }
    if (STAGED || rank == 0) {  // every CTA keeps its own copy of the rows in shared memory
        for (int s = tid; s < pitch; s += ARCH_WIDE_THREADS) {
            rowbuf[s] = s < S ? transitions[s] + em[s] : -CUDART_INF_F;  // transitions[0] + emissions[0]
            rowbuf[pitch + s] = -CUDART_INF_F;
        }
    }
    auto stage = [&](long long i) {  // this CTA's emissions of row i into its ring slot; one group a call
        if (STAGED && i < n)
            for (int s = lo + tid; s < hi; s += ARCH_WIDE_THREADS)
                cp_async4(&s_em[(i % ARCH_WIDE_EM_RING) * pitch + s], em + i * S + s, true);
        cp_async_commit();
    };
    for (int r = 1; r < ARCH_WIDE_EM_RING; ++r) stage(r);
    cp_async_wait<ARCH_WIDE_EM_RING - 2>();  // row 1 is in
    cluster.sync();  // every CTA of the cluster runs, and its row 0 is in place, before any remote store

    const int n_chunks = pitch / 4;
    const int whole = n_chunks / 32 * 32;  // chunks of the whole rounds
    const int tail = 4 * whole;            // the first predecessor scanned one at a time
    for (long long i = 1; i < n; ++i) {
        const float* prev = rowbuf + ((i - 1) & 1) * pitch;
        float* cur = rowbuf + (i & 1) * pitch;
        const float* erow = STAGED ? s_em + (i % ARCH_WIDE_EM_RING) * pitch : em + i * S;
        stage(i + ARCH_WIDE_EM_RING - 1);  // into the slot of row i - 1, read before the last barrier
        const float4* prev4 = reinterpret_cast<const float4*>(prev);
        for (int s0 = lo + warp; s0 < hi; s0 += ARCH_WIDE_WARPS * G) {
            // The warp's next G states, s0 + 32 k, scanned together (a state past this
            // CTA's last repeats it, and its pick is not stored).
            const float* trow[G];
            float best[G];
            int arg[G];
#pragma unroll
            for (int k = 0; k < G; ++k) {
                const int s = min(s0 + ARCH_WIDE_WARPS * k, hi - 1);
                trow[k] = (s - lo < tt_smem ? s_tt + (size_t)(s - lo) * pitch : tt + (size_t)s * pitch);
                best[k] = -CUDART_INF_F;
                arg[k] = whole > 0 ? 4 * lane : tail + lane;
            }
#pragma unroll 2
            for (int c = lane; c < whole; c += 32) {
                const float4 p4 = prev4[c];
#pragma unroll
                for (int k = 0; k < G; ++k) {
                    const float4 t4 = reinterpret_cast<const float4*>(trow[k])[c];
                    const float a = p4.x + t4.x, b = p4.y + t4.y, d = p4.z + t4.z, e = p4.w + t4.w;
                    if (a > best[k] || c == 0) {  // lane 0's first candidate is the chain's start
                        best[k] = a;
                        arg[k] = 4 * c;
                    }
                    if (b > best[k]) {
                        best[k] = b;
                        arg[k] = 4 * c + 1;
                    }
                    if (d > best[k]) {
                        best[k] = d;
                        arg[k] = 4 * c + 2;
                    }
                    if (e > best[k]) {
                        best[k] = e;
                        arg[k] = 4 * c + 3;
                    }
                }
            }
            for (int p = tail + lane; p < S; p += 32) {
                const float pv = prev[p];
#pragma unroll
                for (int k = 0; k < G; ++k) {
                    const float a = pv + trow[k][p];
                    if (a > best[k] || p == 0) {
                        best[k] = a;
                        arg[k] = p;
                    }
                }
            }
#pragma unroll
            for (int k = 0; k < G; ++k) {
                const uint32_t key = pick_key(best[k]);
                const uint32_t top = __reduce_max_sync(FULL, key);
                const uint32_t win = __reduce_min_sync(FULL, key == top ? (uint32_t)arg[k] : 0xffffffffu);
                const int holder = (int)win < tail ? (int)(win >> 2) & 31 : (int)(win - tail) & 31;
                const float v = __shfl_sync(FULL, best[k], holder);
                const int s = s0 + ARCH_WIDE_WARPS * k;
                if (s < hi) {
                    const float score = v + erow[s];
                    if (STAGED) {
                        if (lane < C) *cluster.map_shared_rank(&cur[s], lane) = score;  // every CTA's copy
                    } else if (lane == 0) {
                        cur[s] = score;
                    }
                    if (lane == 0) bk[i * bpitch + s] = (BP)win;
                }
            }
        }
        cp_async_wait<ARCH_WIDE_EM_RING - 2>();  // row i + 1 is in
        cluster.sync();  // the row is complete in every copy, and the next emission row staged, before either is read
    }
    cp_async_wait<0>();
    if (rank != 0) return;  // rank 0 walks: the cluster's backpointers are visible after the last barrier
    if (tid == 0) scores[contig] = rowbuf[((n - 1) & 1) * pitch + S - 1];

    // The walk back from POST (forced end), rows [lo, hi) a tile from the end.
    if (walk_rows == 0) {
        if (tid == 0) {
            int state = S - 1;
            paths[row0 + n - 1] = state;
            for (long long i = n - 1; i > 0; --i) {
                state = (int)bk[i * bpitch + state];
                paths[row0 + i - 1] = state;
            }
        }
        return;
    }
    __syncthreads();  // the score is read before the walk's tiles overwrite the rows
    BP* w_bk = reinterpret_cast<BP*>(smem);  // two tiles of walk_rows x bpitch
    int* w_path = reinterpret_cast<int*>(w_bk + 2 * (size_t)walk_rows * bpitch);
    const int tile = walk_rows * bpitch;
    const long long n_back = (n + walk_rows - 1) / walk_rows;
    auto stage_back = [&](long long t) {  // tile t holds rows [n - (t + 1) W, n - t W) clipped at 0
        const long long r_hi = n - t * walk_rows;
        const long long r_lo = r_hi - walk_rows > 0 ? r_hi - walk_rows : 0;
        const long long chunks16 = (r_hi - r_lo) * bpitch * (long long)sizeof(BP) / 16;
        unsigned char* dst = reinterpret_cast<unsigned char*>(w_bk + (t & 1) * tile);
        const unsigned char* src = reinterpret_cast<const unsigned char*>(bk + r_lo * bpitch);
        for (long long f = tid; f < chunks16; f += ARCH_WIDE_THREADS) cp_async16(dst + 16 * f, src + 16 * f);
        cp_async_commit();
    };
    int state = S - 1;
    stage_back(0);
    for (long long t = 0; t < n_back; ++t) {
        if (t + 1 < n_back) {
            stage_back(t + 1);
        } else {
            cp_async_commit();
        }
        cp_async_wait<1>();
        __syncthreads();  // tile t is in; every thread is done with the path tile before
        const long long r_hi = n - t * walk_rows;
        const long long r_lo = r_hi - walk_rows > 0 ? r_hi - walk_rows : 0;
        const int rows_here = (int)(r_hi - r_lo);
        if (tid == 0) {
            const BP* tb = w_bk + (t & 1) * tile;
            const int last = r_lo == 0 ? 1 : 0;  // the contig's row 0 has no predecessor
            for (int r = rows_here - 1; r >= last; --r) {
                w_path[r] = state;
                state = (int)tb[r * bpitch + state];
            }
            if (last) w_path[0] = state;
        }
        __syncthreads();  // the path tile is written, and tile t walked, before tile t + 2 is staged
        for (int f = tid; f < rows_here; f += ARCH_WIDE_THREADS) paths[row0 + r_lo + f] = w_path[f];
    }
    cp_async_wait<0>();
}

// The block-a-contig decode's geometry, shared by its launches.
struct ArchWideGeometry {
    int S, pitch, bpitch, walk_rows, budget;
    size_t fwd, row_bytes, walk_pair;  // the forward's row bytes, one tt row, a walk row pair
};

// The rows of a CTA's transposed transitions kept in shared memory, with `ctas` CTAs a contig.
int arch_wide_tt_smem(const ArchWideGeometry& g, int ctas) {
    return (int)std::min<size_t>((size_t)((g.S + ctas - 1) / ctas), ((size_t)g.budget - g.fwd) / g.row_bytes);
}

// A CTA's dynamic shared memory with `ctas` CTAs a contig: the forward's rows and its transitions,
// or the walk's tiles, whichever is more.
size_t arch_wide_smem(const ArchWideGeometry& g, int ctas) {
    return std::max(g.fwd + (size_t)arch_wide_tt_smem(g, ctas) * g.row_bytes, (size_t)g.walk_rows * g.walk_pair);
}

// How many clusters of c CTAs (c = 2 .. ARCH_WIDE_MAX_CLUSTER) of the paired kernel the current
// device runs at once for g's S states, 0 where it refuses the size; asked once a (device, S), when
// the kernels' shared-memory limit is also set.
template <typename BP, bool STAGED>
cudaError_t arch_wide_fit(const ArchWideGeometry& g, int active[ARCH_WIDE_MAX_CLUSTER + 1]) {
    static std::mutex mutex;
    static std::map<std::pair<int, int>, std::array<int, ARCH_WIDE_MAX_CLUSTER + 1>> fits;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    const std::lock_guard<std::mutex> lock(mutex);
    auto it = fits.find({device, g.S});
    if (it == fits.end()) {
        auto paired = arch_viterbi_wide_kernel<BP, STAGED, 2>;
        err = cudaFuncSetAttribute(paired, cudaFuncAttributeMaxDynamicSharedMemorySize, g.budget);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(arch_viterbi_wide_kernel<BP, STAGED, 4>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, g.budget);
        if (err != cudaSuccess) return err;
        std::array<int, ARCH_WIDE_MAX_CLUSTER + 1> fit{};
        cudaLaunchAttribute attr;
        attr.id = cudaLaunchAttributeClusterDimension;
        attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
        cudaLaunchConfig_t cfg = {};
        cfg.blockDim = dim3(ARCH_WIDE_THREADS);
        cfg.attrs = &attr;
        cfg.numAttrs = 1;
        for (int c = 2; c <= ARCH_WIDE_MAX_CLUSTER; ++c) {
            attr.val.clusterDim.x = c;
            cfg.gridDim = dim3(c);
            cfg.dynamicSmemBytes = arch_wide_smem(g, c);
            if (cudaOccupancyMaxActiveClusters(&fit[c], paired, &cfg) != cudaSuccess) fit[c] = 0;
        }
        cudaGetLastError();  // a refused size is an answer, not an error of the launch
        it = fits.emplace(std::make_pair(device, g.S), fit).first;
    }
    std::copy(it->second.begin(), it->second.end(), active);
    return cudaSuccess;
}

// The cluster: the most CTAs (up to ARCH_WIDE_MAX_CLUSTER, and no fewer than 32 states a CTA) at
// which every contig's cluster runs at once on this device; one CTA a contig when none does.
template <typename BP, bool STAGED>
cudaError_t arch_wide_cluster(const ArchWideGeometry& g, int n_contigs, int* ctas) {
    int active[ARCH_WIDE_MAX_CLUSTER + 1];
    const cudaError_t err = arch_wide_fit<BP, STAGED>(g, active);
    if (err != cudaSuccess) return err;
    *ctas = 1;
    for (int c = std::min(ARCH_WIDE_MAX_CLUSTER, (g.S + 31) / 32); c > 1 && *ctas == 1; --c)
        if (active[c] >= n_contigs) *ctas = c;
    return cudaSuccess;
}

template <typename BP, bool STAGED>
int launch_arch_wide(const ArchWideGeometry& g, int n_contigs, long long rows, const float* em, const float* tr,
                     const float* tt, const long long* off, BP* back, int* paths, float* scores, float* work,
                     cudaStream_t stream) {
    int ctas = 1;
    cudaError_t err = arch_wide_cluster<BP, STAGED>(g, n_contigs, &ctas);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = ctas;
    attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)n_contigs * ctas);
    cfg.blockDim = dim3(ARCH_WIDE_THREADS);
    cfg.dynamicSmemBytes = arch_wide_smem(g, ctas);
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    auto paired = arch_viterbi_wide_kernel<BP, STAGED, 2>;
    auto alone = arch_viterbi_wide_kernel<BP, STAGED, 4>;  // a CTA a contig: more states a warp
    err = cudaLaunchKernelEx(&cfg, ctas > 1 ? paired : alone, em, tr, tt, off, rows, g.S, g.pitch, arch_wide_tt_smem(g, ctas), back,
                             g.bpitch, g.walk_rows, paths, scores, work);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

int arch_pitch(int S) { return (S + 15) / 16 * 16; }

size_t arch_smem_bytes(int S, int R) {
    const int pitch = arch_pitch(S);
    const int fwd = 2 * ARCH_ROWS * S * 4 + ARCH_ROWS * pitch;
    const int bwd = 2 * ARCH_BACK_ROWS * pitch + ARCH_BACK_ROWS * 4;
    const size_t room = ((fwd > bwd ? fwd : bwd) + 15) / 16 * 16;
    const bool trans_smem = R > 1 && S <= ARCH_SMEM_TRANSITIONS;
    return room + (trans_smem ? (size_t)S * S * 4 : 0);
}

template <int R>
int launch_arch(const float* em, const float* trans, const long long* offsets, int n_contigs, long long rows, int S,
                uint8_t* back, int* paths, float* scores, cudaStream_t stream) {
    const size_t smem = arch_smem_bytes(S, R);
    cudaError_t err = cudaFuncSetAttribute(arch_viterbi_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int trans_smem = R > 1 && S <= ARCH_SMEM_TRANSITIONS;
    arch_viterbi_kernel<R><<<n_contigs, 32, smem, stream>>>(em, trans, offsets, rows, S, arch_pitch(S), trans_smem,
                                                             back, paths, scores);
    return (int)cudaGetLastError();
}

// Gene workspace, in 4-byte words: vin, vout (VEC a chunk), cval (4 a chunk),
// cflag, dirty, maps, xend (1 a chunk), first_dirty (1 a strand), runs (2 a
// strand), pattern (32 a strand), two counters.
size_t gene_workspace_words(long long n_chunks, long long n_chains) { return 24 * n_chunks + 35 * n_chains + 2; }

}  // namespace

extern "C" {

int kts_arch_max_states() { return MAX_ARCH_STATES; }
int kts_gene_chunk() { return GENE_CHUNK; }
int kts_gene_warmup() { return GENE_WARMUP; }
int kts_arch_pitch(int S) { return arch_pitch(S); }
long long kts_gene_workspace_words(long long n_chunks, long long n_chains) {
    return (long long)gene_workspace_words(n_chunks, n_chains);
}

// Gene-HMM Viterbi over strands laid end to end in the three inputs.  The
// caller cuts them into `n_chunks` chunks of at most `chunk` positions
// (`chunks`: int64 start, end, strand start, strand index a chunk, in strand
// order; `chain_chunks`: the first chunk of each of the `n_chains` strands and
// the total), allocates `back` (a word a position) and `workspace`
// (kts_gene_workspace_words), and checks the bounds.  `warmup` is the guess's
// run before a chunk (GENE_WARMUP; 0 forces every chunk but a strand's first
// to be re-run).  Launches on `stream` and waits on it once a fix-up round;
// stats (host): chunks, fix-up rounds, re-run chunks, chunks filled from a
// three-step pattern.  Returns the first CUDA error.
int kts_gene_viterbi(const void* codemit, const void* entry_b, const void* exit_b, const void* chunks,
                     const void* chain_chunks, int n_chunks, int n_chains, int chunk, int warmup, float indel,
                     float ins_extend, void* back, void* states, void* workspace, long long* stats, void* stream) {
    stats[0] = n_chunks;
    stats[1] = stats[2] = stats[3] = 0;
    if (n_chunks <= 0) return 0;
    if (chunk < 1 || warmup < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* ce = static_cast<const float*>(codemit);
    const float* eb = static_cast<const float*>(entry_b);
    const float* xb = static_cast<const float*>(exit_b);
    const long long* tab = static_cast<const long long*>(chunks);
    const long long* cc = static_cast<const long long*>(chain_chunks);
    uint32_t* bk = static_cast<uint32_t*>(back);
    float* ws = static_cast<float*>(workspace);
    const long long n = n_chunks, nc = n_chains;
    float* vin = ws;
    float* vout = vin + VEC * n;
    float* cval = vout + VEC * n;
    int* cflag = reinterpret_cast<int*>(cval + 4 * n);
    int* dirty = cflag + n;
    uint32_t* maps = reinterpret_cast<uint32_t*>(dirty + n);
    int* xend = reinterpret_cast<int*>(maps + n);
    int* first_dirty = xend + n;
    int* runs = first_dirty + nc;
    float* pattern = reinterpret_cast<float*>(runs + 2 * nc);
    int* counters = reinterpret_cast<int*>(pattern + 32 * nc);  // re-runs listed this round, chunks filled

    const int blocks = (n_chunks + 31) / 32;
    gene_forward_kernel<false><<<blocks, 32, 0, st>>>(ce, eb, xb, tab, nullptr, n_chunks, chunk, warmup, indel,
                                                      ins_extend, bk, vin, vout, cval, cflag);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if ((err = cudaMemsetAsync(counters, 0, 2 * sizeof(int), st)) != cudaSuccess) return (int)err;
    for (;;) {
        if ((err = cudaMemsetAsync(counters, 0, sizeof(int), st)) != cudaSuccess) return (int)err;
        if ((err = cudaMemsetAsync(first_dirty, 0x7f, nc * sizeof(int), st)) != cudaSuccess) return (int)err;
        gene_check_kernel<<<(n_chunks + 127) / 128, 128, 0, st>>>(tab, n_chunks, vin, vout, dirty, counters,
                                                                  first_dirty);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        int counts[2];
        if ((err = cudaMemcpyAsync(counts, counters, sizeof(counts), cudaMemcpyDeviceToHost, st)) != cudaSuccess)
            return (int)err;
        if ((err = cudaStreamSynchronize(st)) != cudaSuccess) return (int)err;
        stats[3] = counts[1];
        if (counts[0] == 0) break;
        if (stats[1] >= n) return (int)cudaErrorUnknown;  // each round makes one more chunk of every strand exact
        stats[1] += 1;
        stats[2] += counts[0];
        gene_forward_kernel<true><<<(counts[0] + 31) / 32, 32, 0, st>>>(
            ce, eb, xb, tab, dirty, counts[0], chunk, 0, indel, ins_extend, bk, vin, vout, cval, cflag);
        gene_fill_test_kernel<<<n_chains, 32, 0, st>>>(cc, first_dirty, cflag, cval, vout, indel, ins_extend, runs,
                                                       pattern);
        gene_fill_kernel<<<n_chunks, 128, 0, st>>>(tab, runs, pattern, bk, vin, vout, counters);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    gene_walk_kernel<true><<<blocks, 32, 0, st>>>(tab, n_chunks, chunk, bk, maps, nullptr, nullptr);
    gene_link_kernel<<<n_chains, 32, 0, st>>>(cc, vout, maps, xend);
    gene_walk_kernel<false><<<blocks, 32, 0, st>>>(tab, n_chunks, chunk, bk, nullptr, xend,
                                                   static_cast<int8_t*>(states));
    return (int)cudaGetLastError();
}

// Architectural Viterbi over `n_contigs` contigs of S states (contig c owns
// rows [offsets[c], offsets[c + 1]) of the `rows` emission rows; the caller
// checks that the offsets run from 0 to `rows` and that no contig is empty,
// and the kernel skips a contig outside them); `back` is scratch of
// kts_arch_pitch(S) bytes a row.  Launches on `stream`; returns the launch's
// CUDA error.
int kts_arch_viterbi(const void* emissions, const void* transitions, const void* offsets, int n_contigs,
                     long long rows, int S, void* back, void* paths, void* scores, void* stream) {
    if (n_contigs <= 0) return 0;
    if (S < 1 || S > MAX_ARCH_STATES) return (int)cudaErrorInvalidValue;
    const float* em = static_cast<const float*>(emissions);
    const float* tr = static_cast<const float*>(transitions);
    const long long* off = static_cast<const long long*>(offsets);
    uint8_t* bk = static_cast<uint8_t*>(back);
    int* pa = static_cast<int*>(paths);
    float* sc = static_cast<float*>(scores);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (S <= 32) return launch_arch<1>(em, tr, off, n_contigs, rows, S, bk, pa, sc, st);
    if (S <= 64) return launch_arch<2>(em, tr, off, n_contigs, rows, S, bk, pa, sc, st);
    if (S <= 128) return launch_arch<4>(em, tr, off, n_contigs, rows, S, bk, pa, sc, st);
    return launch_arch<8>(em, tr, off, n_contigs, rows, S, bk, pa, sc, st);
}

// Bytes of one backpointer of the block-a-contig decode for S states: 2 up to 65,536, else 4.
int kts_arch_wide_bp_bytes(int S) { return S <= 65536 ? 2 : 4; }

// Floats a row of the transposed transitions the block-a-contig decode takes (S rounded up to 4).
int kts_arch_wide_pitch(int S) { return (S + 3) / 4 * 4; }

// Backpointers a row of its `back` scratch (16 bytes a row rounded up).
int kts_arch_wide_bp_pitch(int S) { return kts_arch_wide_bp_bytes(S) == 2 ? (S + 7) / 8 * 8 : (S + 3) / 4 * 4; }

// Floats of `work` a contig: the two rows of scores when they are too wide for shared memory (one
// copy in device memory for the contig's cluster), else 0.
int kts_arch_wide_work_floats(int S) {
    const int pitch = kts_arch_wide_pitch(S);
    return pitch <= ARCH_WIDE_STAGED_PITCH ? 0 : 2 * pitch;
}

// The block-a-contig decode's geometry for S states on the current device (not exported).
static cudaError_t arch_wide_geometry(int S, ArchWideGeometry& g) {
    int device = 0, budget = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&budget, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    const int pitch = kts_arch_wide_pitch(S), bpitch = kts_arch_wide_bp_pitch(S), bp_bytes = kts_arch_wide_bp_bytes(S);
    const size_t row_bytes = 4 * (size_t)pitch;
    const size_t fwd = pitch <= ARCH_WIDE_STAGED_PITCH ? (2 + ARCH_WIDE_EM_RING) * row_bytes : 0;  // score rows, ring
    const size_t walk_pair = 2 * (size_t)bpitch * bp_bytes + 4;  // a row in each walk tile and its path entry
    const int walk_rows = (int)std::min<size_t>(ARCH_WIDE_WALK_ROWS, (size_t)budget / walk_pair);
    g = ArchWideGeometry{S, pitch, bpitch, walk_rows, budget, fwd, row_bytes, walk_pair};
    return cudaSuccess;
}

// The CTAs a contig's cluster the block-a-contig decode launches with for S states and
// `n_contigs` contigs on the current device (1: a CTA a contig), or minus a CUDA error.
int kts_arch_wide_cluster(int S, int n_contigs) {
    ArchWideGeometry g;
    cudaError_t err = S < 1 ? cudaErrorInvalidValue : arch_wide_geometry(S, g);
    int ctas = 1;
    if (err == cudaSuccess)
        err = kts_arch_wide_bp_bytes(S) == 4 ? arch_wide_cluster<int32_t, false>(g, n_contigs, &ctas)
              : g.pitch <= ARCH_WIDE_STAGED_PITCH ? arch_wide_cluster<uint16_t, true>(g, n_contigs, &ctas)
                                                  : arch_wide_cluster<uint16_t, false>(g, n_contigs, &ctas);
    return err == cudaSuccess ? ctas : -(int)err;
}

// The architectural Viterbi for any S >= 1 with a block a contig (the caller takes it above
// kts_arch_max_states()).  `tt` is the transitions transposed, S rows of kts_arch_wide_pitch(S)
// floats padded with -inf; `back` is scratch of kts_arch_wide_bp_pitch(S) backpointers a row of
// kts_arch_wide_bp_bytes(S) bytes; `work` holds kts_arch_wide_work_floats(S) floats a contig.  Same
// contract as kts_arch_viterbi otherwise.
int kts_arch_viterbi_wide(const void* emissions, const void* transitions, const void* tt, const void* offsets,
                          int n_contigs, long long rows, int S, void* back, void* paths, void* scores, void* work,
                          void* stream) {
    if (n_contigs <= 0) return 0;
    if (S < 1) return (int)cudaErrorInvalidValue;
    ArchWideGeometry g;
    const cudaError_t err = arch_wide_geometry(S, g);
    if (err != cudaSuccess) return (int)err;
    const float* em = static_cast<const float*>(emissions);
    const float* tr = static_cast<const float*>(transitions);
    const float* ttp = static_cast<const float*>(tt);
    const long long* off = static_cast<const long long*>(offsets);
    int* pa = static_cast<int*>(paths);
    float* sc = static_cast<float*>(scores);
    float* wk = static_cast<float*>(work);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (kts_arch_wide_bp_bytes(S) == 4)
        return launch_arch_wide<int32_t, false>(g, n_contigs, rows, em, tr, ttp, off, static_cast<int32_t*>(back), pa,
                                                sc, wk, st);
    if (g.pitch <= ARCH_WIDE_STAGED_PITCH)
        return launch_arch_wide<uint16_t, true>(g, n_contigs, rows, em, tr, ttp, off, static_cast<uint16_t*>(back), pa,
                                                sc, wk, st);
    return launch_arch_wide<uint16_t, false>(g, n_contigs, rows, em, tr, ttp, off, static_cast<uint16_t*>(back), pa,
                                             sc, wk, st);
}

}  // extern "C"
