// Viterbi decodes of the BGC toolkit for NVIDIA Hopper (sm_90a).
//
// Two kernels, each the counterpart of an XLA program of the JAX package
// (neither has a Pallas source):
//
//   gene_viterbi_kernel  replaces kaptive_tpu/bgc/genefinder.py::_viterbi_states:
//     the forward lax.scan of the 7-state codon-phase HMM (N, C0, C1, C2, I0,
//     I1, I2) over every position of a contig strand, and the reverse
//     lax.scan that walks the backpointers from the best last state.
//   arch_viterbi_kernel  replaces kaptive_tpu/bgc/kernels.py::architectural_viterbi:
//     the max-plus decode over a contig's ORF emission rows with a forced
//     end in POST (the last state).
//
// Both compute what the XLA programs compute, bit for bit: every operation is
// a float32 add, max or subtract in the JAX package's order, and each pick
// takes the first candidate among equals (a strict `>` over the candidates in
// order).  Build without --use_fast_math: nvcc then neither reorders nor
// contracts float32 adds.  The plain PyTorch forms are
// kaptive_tpu_torch/ops/viterbi.py::gene_viterbi_plain and ::arch_viterbi_plain.
//
// Built by kaptive_tpu_torch/ops/viterbi_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with a plain C interface, loaded with ctypes.
//
// What bounds the gene decode.  A step reads 12 bytes (codon emission, entry
// and exit scores), writes a 4-byte backpointer word that the reverse pass
// reads again, and writes one state byte: ~21 bytes a step, ~0.07 ms for the
// two 5.77 M-step strands of a 5.3 Mb contig at 3.35 TB/s.  But step i needs
// the seven scores of step i-1: a candidate add, up to three compare-selects,
// the codon add, the clamp, a three-level max and the subtract, ~10
// dependent float32 operations of ~4 cycles, so ~40 cycles a step and ~0.1 s
// for one 5.77 M-step chain at the card's clock.  That chain, not memory, is
// the floor for a decode that must equal the reference exactly (a parallel
// max-plus scan would reassociate nothing, but it would do 7x more work per
// step and tie-break on other paths' values).  The design keeps the chain
// short and everything else off it:
//   * One warp per chain (a contig strand; chains run side by side on the
//     SMs).  Lane 0 runs the recursion with the seven scores in registers.
//   * The warp stages the next TILE = 128 positions' inputs with coalesced
//     loads into registers before lane 0 starts the current tile, and moves
//     them to shared memory after it: lane 0 never waits on device memory.
//   * Backpointers are the seven source states, 3 bits each, packed into one
//     word a position in shared memory and stored by the warp 128 words at a
//     time.
//   * The reverse pass stages the words of a tile from the end the same way;
//     lane 0 walks them (a shift and a mask a step) and the warp stores the
//     tile's 128 state bytes.
//
// What bounds the architectural decode.  N rows of S = K + 3 states (28 at
// the default K = 25) and N a few hundred to a few thousand ORFs a contig:
// N x S x S adds and compares and ~4 N S bytes, microseconds of work at the
// card's rates.  It is bound by its N dependent steps: one block per contig,
// one thread per state, S candidates in order a step and two block barriers,
// ~200-300 cycles a step; one thread walks the backpointers back from POST.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;              // positions a warp stages at once
constexpr int PER_LANE = TILE / 32;
constexpr float NEG = -1.0e9f;         // the JAX package's -BIG clamp
constexpr int MAX_ARCH_STATES = 256;   // backpointers are bytes

enum : uint32_t { SN = 0, SC0 = 1, SC1 = 2, SC2 = 3, SI0 = 4, SI1 = 5, SI2 = 6 };

// One candidate of a pick: it replaces the running best only when strictly
// greater, so the first of equal candidates wins (jnp.argmax's rule).
__device__ __forceinline__ void take(float cand, uint32_t src, float& best, uint32_t& arg) {
    if (cand > best) {
        best = cand;
        arg = src;
    }
}

__global__ void __launch_bounds__(32) gene_viterbi_kernel(
    const float* __restrict__ codemit, const float* __restrict__ entry_b, const float* __restrict__ exit_b,
    const long long* __restrict__ offsets, long long total, float indel, float ins_extend,
    uint32_t* __restrict__ back, int8_t* __restrict__ states) {
    __shared__ float s_in[2][3][TILE];
    __shared__ uint32_t s_back[TILE];
    __shared__ int8_t s_state[TILE];

    const int lane = threadIdx.x;
    const long long base = offsets[blockIdx.x];
    const long long L = offsets[blockIdx.x + 1] - base;
    if (L <= 0 || base < 0 || base + L > total) return;  // empty, or bounds outside the inputs
    const float* ce_g = codemit + base;
    const float* eb_g = entry_b + base;
    const float* xb_g = exit_b + base;
    uint32_t* back_g = back + base;
    int8_t* state_g = states + base;
    const long long n_tiles = (L + TILE - 1) / TILE;

    // ---- forward pass ----
    float r_ce[PER_LANE], r_eb[PER_LANE], r_xb[PER_LANE];
    auto fetch = [&](long long t) {
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) {
            const long long i = t * TILE + lane + 32 * k;
            const bool in = i < L;
            r_ce[k] = in ? ce_g[i] : 0.f;
            r_eb[k] = in ? eb_g[i] : 0.f;
            r_xb[k] = in ? xb_g[i] : 0.f;
        }
    };
    auto stash = [&](int buf) {
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) {
            s_in[buf][0][lane + 32 * k] = r_ce[k];
            s_in[buf][1][lane + 32 * k] = r_eb[k];
            s_in[buf][2][lane + 32 * k] = r_xb[k];
        }
    };

    fetch(0);
    stash(0);
    __syncwarp();

    float vN = 0.f, vC0 = NEG, vC1 = NEG, vC2 = NEG, vI0 = NEG, vI1 = NEG, vI2 = NEG;
    for (long long t = 0; t < n_tiles; ++t) {
        const int buf = (int)(t & 1);
        if (t + 1 < n_tiles) fetch(t + 1);  // in flight while lane 0 works on tile t
        const int n = (int)(L - t * TILE < TILE ? L - t * TILE : TILE);
        if (lane == 0) {
#pragma unroll 4
            for (int j = 0; j < n; ++j) {
                const float ce = s_in[buf][0][j], eb = s_in[buf][1][j], xb = s_in[buf][2][j];
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
                vN = nN - m;
                vC0 = n0 - m;
                vC1 = n1 - m;
                vC2 = n2 - m;
                vI0 = n4 - m;
                vI1 = n5 - m;
                vI2 = n6 - m;
                s_back[j] = bN | b0 << 3 | b1 << 6 | b2 << 9 | b4 << 12 | b5 << 15 | b6 << 18;
            }
        }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) {
            const int j = lane + 32 * k;
            if (j < n) back_g[t * TILE + j] = s_back[j];
        }
        if (t + 1 < n_tiles) stash(buf ^ 1);
        __syncwarp();
    }

    // The last state: the first maximum of the final scores.
    uint32_t state = SN;
    {
        float best = vN;
        take(vC0, SC0, best, state);
        take(vC1, SC1, best, state);
        take(vC2, SC2, best, state);
        take(vI0, SI0, best, state);
        take(vI1, SI1, best, state);
        take(vI2, SI2, best, state);
    }

    // ---- reverse pass: each lane reads back the words it wrote ----
    uint32_t r_back[PER_LANE];
    auto fetch_back = [&](long long t) {
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) {
            const long long i = t * TILE + lane + 32 * k;
            r_back[k] = i < L ? back_g[i] : 0u;
        }
    };
    fetch_back(n_tiles - 1);
    for (long long t = n_tiles - 1; t >= 0; --t) {
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) s_back[lane + 32 * k] = r_back[k];
        __syncwarp();
        if (t > 0) fetch_back(t - 1);  // in flight while lane 0 walks tile t
        const int n = (int)(L - t * TILE < TILE ? L - t * TILE : TILE);
        if (lane == 0) {
            for (int j = n - 1; j >= 0; --j) {
                s_state[j] = (int8_t)state;
                state = (s_back[j] >> (3 * state)) & 7u;
            }
        }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) {
            const int j = lane + 32 * k;
            if (j < n) state_g[t * TILE + j] = s_state[j];
        }
        __syncwarp();
    }
}

__global__ void arch_viterbi_kernel(const float* __restrict__ emissions, const float* __restrict__ transitions,
                                    const long long* __restrict__ offsets, long long rows, int S,
                                    uint8_t* __restrict__ back,
                                    int* __restrict__ paths, float* __restrict__ scores) {
    __shared__ float prev[MAX_ARCH_STATES];
    const int s = threadIdx.x;
    const long long row0 = offsets[blockIdx.x];
    const long long n = offsets[blockIdx.x + 1] - row0;
    if (n <= 0 || row0 < 0 || row0 + n > rows) return;  // empty, or bounds outside the emissions
    const float* em = emissions + row0 * S;
    uint8_t* bk = back + row0 * S;
    const bool live = s < S;

    float cur = live ? transitions[s] + em[s] : 0.f;  // transitions[0] + emissions[0]
    for (long long i = 1; i < n; ++i) {
        if (live) prev[s] = cur;
        __syncthreads();
        if (live) {
            float best = prev[0] + transitions[s];
            uint32_t arg = 0;
            for (int p = 1; p < S; ++p) take(prev[p] + transitions[p * S + s], (uint32_t)p, best, arg);
            cur = best + em[i * S + s];
            bk[i * S + s] = (uint8_t)arg;
        }
        __syncthreads();
    }
    if (s == S - 1) scores[blockIdx.x] = cur;
    __syncthreads();  // every backpointer of the block is written
    if (s == 0) {
        int* path = paths + row0;
        int state = S - 1;  // forced end in POST
        path[n - 1] = state;
        for (long long i = n - 1; i >= 1; --i) {
            state = bk[i * S + state];
            path[i - 1] = state;
        }
    }
}

}  // namespace

extern "C" {

int kts_arch_max_states() { return MAX_ARCH_STATES; }

// Gene-HMM Viterbi over `n_chains` chains laid end to end in the `total`
// positions of the three inputs (chain c is [offsets[c], offsets[c + 1]); the
// caller checks that the offsets run from 0 to `total` without decreasing, and
// the kernel skips a chain outside them); `back` is scratch of one word a position.
// Launches on `stream`; returns the launch's CUDA error.
int kts_gene_viterbi(const void* codemit, const void* entry_b, const void* exit_b, const void* offsets,
                     int n_chains, long long total, float indel, float ins_extend, void* back, void* states,
                     void* stream) {
    if (n_chains <= 0) return 0;
    gene_viterbi_kernel<<<n_chains, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(codemit), static_cast<const float*>(entry_b),
        static_cast<const float*>(exit_b), static_cast<const long long*>(offsets), total, indel, ins_extend,
        static_cast<uint32_t*>(back), static_cast<int8_t*>(states));
    return (int)cudaGetLastError();
}

// Architectural Viterbi over `n_contigs` contigs of S states (contig c owns
// rows [offsets[c], offsets[c + 1]) of the `rows` emission rows; the caller
// checks that the offsets run from 0 to `rows` and that no contig is empty, and
// the kernel skips a contig outside them); `back` is scratch of one byte a row and state.
// Launches on `stream`; returns the launch's CUDA error.
int kts_arch_viterbi(const void* emissions, const void* transitions, const void* offsets, int n_contigs,
                     long long rows, int S, void* back, void* paths, void* scores, void* stream) {
    if (n_contigs <= 0) return 0;
    if (S < 1 || S > MAX_ARCH_STATES) return (int)cudaErrorInvalidValue;
    const int threads = (S + 31) / 32 * 32;
    arch_viterbi_kernel<<<n_contigs, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(emissions), static_cast<const float*>(transitions),
        static_cast<const long long*>(offsets), rows, S, static_cast<uint8_t*>(back), static_cast<int*>(paths),
        static_cast<float*>(scores));
    return (int)cudaGetLastError();
}

}  // extern "C"
