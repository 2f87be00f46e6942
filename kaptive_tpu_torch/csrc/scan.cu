// Row-compact minimizer scan for NVIDIA Hopper (sm_90a).
//
// Replaces kaptive_tpu/ops/scan_pallas.py::_rowcompact_kernel (launched by
// rowcompact_scan_tpu).  It computes what that kernel computes, bit for bit,
// on all three outputs: per 128-position row of a sentinel-padded code
// stream, the 2-bit forward and reverse k-mers, the canonical minimum, the
// murmur3 fmix32 hash, the w-window minimum (leftmost wins ties), minimizer
// selection and an order-preserving compaction to 64 slots.  The plain
// PyTorch version is kaptive_tpu_torch/ops/scan.py::rowcompact_scan_plain.
//
// Built by kaptive_tpu_torch/ops/scan_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with a plain C interface, loaded with ctypes.
//
// Layout.  One block per (genome, tile of TILE_ROWS = 32 rows = 4,096
// positions); nothing crosses blocks.  The block loads its tile's codes with
// a halo of PRE = 32 positions before (>= w-1, for the windows that select
// the tile's first positions) and POST = 64 after (>= k+w-2) into shared
// memory, then in three passes over shared memory computes
//   1. each position's canonical hash, strand and k-mer validity (once);
//   2. each window start's winning offset (strict <, so the leftmost wins),
//      or -1 where the window is invalid;
//   3. selection: p is selected iff the window starting at p-d chose offset
//      d for some d < w, and p's own k-mer is valid.
// The Pallas kernel instead swept whole (1024+16, 128) VMEM tiles with
// shift-by-one rolls; on the card each thread reads its neighbours from
// shared memory directly.
//
// Compaction.  A row is 128 positions = 4 warps.  __ballot_sync and __popc
// give each selected lane its rank within its warp, and a 4-entry shared
// prefix joins the warps.  Slots at rank < 64 are written in order, the rest
// of the row's 64 slots get 0xFFFFFFFF / -1, and counts holds the full count,
// even above 64 (the caller then seeds that genome on the host).
//
// Boundary guards are those of _scan_tile, with positions counted from the
// first interior row and length = R * 128: a k-mer is valid when
// gpos < length-k+1, a window when gpos < length-k-w+2, nothing before 0.
// Positions outside the padded stream read as the sentinel code.
//
// What bounds it.  The outputs are 4 + 4 bytes per slot, 512 bytes per
// 128-position row, against 128 bytes of codes read: for 32 genomes of
// 45,056 rows that is ~923 MB written and ~185 MB read, ~0.33 ms at the
// H100's 3.35 TB/s.  Each position costs ~35 shared-memory loads (k codes,
// w hashes, w window offsets) and ~100 integer operations, ~1-2 ms for the
// same batch at the card's issue rates, and the kernel measures 3.4 ms
// there (NVIDIA H100 80GB HBM3, 700 W): instruction throughput bounds this
// first version, not bytes.  A rolling k-mer and a sliding-window minimum
// would cut the per-position work.
//
// Arithmetic is native uint32: the murmur multiplies wrap mod 2^32 as the
// JAX package's uint32 ops do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW = 128;
constexpr int SLOTS = 64;
constexpr int TILE_ROWS = 32;
constexpr int TILE = TILE_ROWS * ROW;  // positions per block
constexpr int PRE = 32;                // halo before the tile (>= w-1)
constexpr int POST = 64;               // halo after the tile (>= k+w-2)
constexpr int N_CODE = PRE + TILE + POST;
constexpr int N_HASH = PRE + TILE + 32;  // hashes read by windows starting in [-PRE, TILE)
constexpr int N_WIN = PRE + TILE;        // window starts read by the tile's selection
constexpr int THREADS = 512;             // 4 rows per compaction pass
constexpr int ROWS_PER_PASS = THREADS / ROW;
constexpr int MAX_K = 16;                // 2k bits must fit in 32
constexpr int MAX_W = PRE;
constexpr uint32_t UMAX = 0xFFFFFFFFu;
constexpr uint8_t SENTINEL = 4;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x;
}

__global__ void __launch_bounds__(THREADS) rowcompact_scan_kernel(
    const uint8_t* __restrict__ codes,  // (B, R + 2*halo_rows, 128)
    int R, int halo_rows, int k, int w,
    uint32_t* __restrict__ hashes,      // out (B, R, 64)
    int32_t* __restrict__ aux,          // out (B, R, 64)
    int32_t* __restrict__ counts) {     // out (B, R)
    __shared__ uint8_t s_code[N_CODE];
    __shared__ uint32_t s_hash[N_HASH];
    __shared__ uint8_t s_flag[N_HASH];  // bit 0: forward strand canonical, bit 1: k-mer valid
    __shared__ int8_t s_delta[N_WIN];   // winning offset of the window starting here, or -1
    __shared__ int s_warp[THREADS / 32];

    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const long long length = (long long)R * ROW;
    const long long t0 = (long long)blockIdx.x * TILE;  // first stream position of the tile
    const long long padded_len = (long long)(R + 2 * halo_rows) * ROW;
    const uint8_t* g = codes + (long long)b * padded_len;
    const long long local0 = t0 - PRE;                  // stream position of shared index 0
    const long long base = (long long)halo_rows * ROW + local0;

    for (int i = tid; i < N_CODE; i += THREADS) {
        const long long p = base + i;
        s_code[i] = (p >= 0 && p < padded_len) ? g[p] : SENTINEL;
    }
    __syncthreads();

    // 1. Canonical k-mer hash, strand and validity of every position the
    //    windows read.
    const long long kmer_end = length - k + 1;
    for (int i = tid; i < N_HASH; i += THREADS) {
        uint32_t fwd = 0, rev = 0;
        bool bad = false;
        for (int j = 0; j < k; ++j) {
            const uint32_t c = s_code[i + j];
            bad |= c >= SENTINEL;
            fwd = (fwd << 2) | (c & 3u);
            rev |= (3u - (c & 3u)) << (2 * j);
        }
        const long long gpos = local0 + i;
        const bool valid = !bad && gpos >= 0 && gpos < kmer_end;
        s_hash[i] = valid ? mix32(min(fwd, rev)) : UMAX;
        s_flag[i] = (uint8_t)((fwd <= rev ? 1 : 0) | (valid ? 2 : 0));
    }
    __syncthreads();

    // 2. Winning offset of each window start (strict <: leftmost on ties).
    const long long window_end = length - k - w + 2;
    for (int i = tid; i < N_WIN; i += THREADS) {
        uint32_t best = s_hash[i];
        int off = 0;
        for (int j = 1; j < w; ++j) {
            const uint32_t h = s_hash[i + j];
            if (h < best) {
                best = h;
                off = j;
            }
        }
        const long long gpos = local0 + i;
        const bool ok = best != UMAX && gpos >= 0 && gpos < window_end;
        s_delta[i] = (int8_t)(ok ? off : -1);
    }
    __syncthreads();

    // 3. Selection and per-row compaction, ROWS_PER_PASS rows at a time.
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int row_warp0 = warp & ~3;  // first of the 4 warps that hold this row
    const int col = tid & (ROW - 1);
    for (int pass = 0; pass < TILE_ROWS / ROWS_PER_PASS; ++pass) {
        const int rr = pass * ROWS_PER_PASS + tid / ROW;
        const int i = PRE + rr * ROW + col;
        bool sel = false;
        for (int d = 0; d < w; ++d) sel |= s_delta[i - d] == d;
        sel &= (s_flag[i] & 2) != 0;
        const unsigned mask = __ballot_sync(0xffffffffu, sel);
        const int within = __popc(mask & ((1u << lane) - 1u));
        if (lane == 0) s_warp[warp] = __popc(mask);
        __syncthreads();
        int before = 0;
        for (int q = row_warp0; q < warp; ++q) before += s_warp[q];
        const int total = s_warp[row_warp0] + s_warp[row_warp0 + 1] + s_warp[row_warp0 + 2]
                          + s_warp[row_warp0 + 3];
        const long long grow = (long long)blockIdx.x * TILE_ROWS + rr;
        if (grow < R) {
            const size_t out_row = ((size_t)b * R + grow) * SLOTS;
            const int rank = before + within;
            if (sel && rank < SLOTS) {
                hashes[out_row + rank] = s_hash[i];
                aux[out_row + rank] = col | ((s_flag[i] & 1) << 7);
            }
            if (col < SLOTS && col >= total) {
                hashes[out_row + col] = UMAX;
                aux[out_row + col] = -1;
            }
            if (col == 0) counts[(size_t)b * R + grow] = total;
        }
        __syncthreads();  // s_warp is rewritten by the next pass
    }
}

}  // namespace

extern "C" {

int kts_rowcompact_max_k() { return MAX_K; }
int kts_rowcompact_max_w() { return MAX_W; }

// Launches the scan on `stream`; returns the CUDA error of the launch (0 = ok).
int kts_rowcompact_scan(const void* codes, int B, int R, int halo_rows, int k, int w,
                        void* hashes, void* aux, void* counts, void* stream) {
    if (B <= 0 || R <= 0) return 0;
    const dim3 grid((unsigned)((R + TILE_ROWS - 1) / TILE_ROWS), (unsigned)B);
    rowcompact_scan_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const uint8_t*>(codes), R, halo_rows, k, w,
        static_cast<uint32_t*>(hashes), static_cast<int32_t*>(aux),
        static_cast<int32_t*>(counts));
    return (int)cudaGetLastError();
}

}  // extern "C"
