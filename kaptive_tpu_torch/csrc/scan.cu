// Minimizer scans for NVIDIA Hopper (sm_90a): the row-compact scan and the flat scan.
//
// rowcompact_scan_kernel<W> replaces kaptive_tpu/ops/scan_pallas.py::_rowcompact_kernel (launched
// by rowcompact_scan_tpu).  It computes what that kernel computes, bit for bit,
// on all three outputs: per 128-position row of a sentinel-padded code
// stream, the 2-bit forward and reverse k-mers, the canonical minimum, the
// murmur3 fmix32 hash, the w-window minimum (leftmost wins ties), minimizer
// selection and an order-preserving compaction to 64 slots.  The plain
// PyTorch version is kaptive_tpu_torch/ops/scan.py::rowcompact_scan_plain.
// minimizer_scan_kernel<W> (the flat scan, described before it below) shares its first three
// stages.  Both take k <= 16 and w <= 32 (the main path's (15, 10) among them); every other
// k >= 1 and w >= 1 takes the run-time form at the end of the file (scan_any_*_kernel).
//
// Built by kaptive_tpu_torch/ops/scan_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with a plain C interface, loaded with ctypes.
//
// What bounds it.  The outputs are 4 + 4 bytes per slot, 512 bytes per
// 128-position row, against 128 bytes of codes read: for 32 genomes of
// 45,056 rows that is ~923 MB written and ~185 MB read, ~0.33 ms at the
// H100's 3.35 TB/s, and a position needs a k-mer, a hash and a window minimum
// whatever the design: ~35 integer operations, 0.39 ms for the same batch.
// The two are close.  The issue rate of the SMs bounds this kernel: the
// w = 10 instance compiles to ~1,200 SASS operations a thread, ~75 a
// position, and it runs 4 x 45,056 rows in 0.094 ms and 32 x 45,056 rows in
// 0.72 ms (NVIDIA H100 80GB HBM3, 700 W): 51% and 54% of that bound.  So the
// design keeps what a position costs to issue down, and makes every output
// store a whole line.
//
// Layout.  One block per (genome, tile of TILE_ROWS = 32 rows = 4,096
// positions); nothing crosses blocks.  A thread owns a word: 16 consecutive
// positions.  Five stages, a block barrier between them:
//   1. Pack.  One 16-byte load of codes a thread, packed to 2 bits a base
//      (base i of the word at bits 2i, `c & 3` under an invalid base) plus a
//      16-bit mask of invalid bases (code >= 4).  Words outside the padded
//      stream are sentinels.
//   2. Hash (hash_word, below).  A thread gets each of its 16 k-mers from
//      its own and the next packed word by one funnel shift: no loop over k.
//      A k-mer is valid when no invalid bit lies among its k mask bits (an
//      OR over k bits, doubled up once a word) and it starts inside
//      [0, length-k+1).  One hash a position, stored once as a 32-bit word
//      (17 words a thread, so a warp's stores and loads never share a bank);
//      strand bits go to a bit mask.
//   3. Window minimum and selection (select_winners, below): a van Herk /
//      Gil-Werman pass with W a template parameter, ~3 comparisons a
//      position for any W; a valid window (minimum != 0xFFFFFFFF, start
//      inside [0, length-k-W+2)) marks its winner in the tile's selection
//      mask in shared memory (selection by scatter).
//   4, 5. Ranking and store (rank_and_store_rows, shared with the run-time
//      form): each row's selected positions ranked by __popc / __ffs over its
//      four mask words, the first 64 staged in shared memory, and each row
//      written as two 256-byte stores; counts holds the full count.
// The Pallas kernel instead swept whole (1024+16, 128) VMEM tiles with
// shift-by-one rolls and compacted with a butterfly network.
//
// Boundary guards are those of _scan_tile, with positions counted from the
// first interior row and length = R * 128: a k-mer is valid when
// gpos < length-k+1, a window when gpos < length-k-w+2, nothing before 0.
//
// In flight.  288 threads a block: the tile's 256 words, 2 words (32
// positions, >= w-1) before it for the windows that select its first
// positions, and 2 + 1 after it for the last windows' reach and the last
// k-mers'.  32-55 registers a thread over the 32 instances (47 at w = 10) and 37 KB of shared
// memory: 4 blocks (36 warps) an SM, set by registers; forcing 5 or more made
// it slower.  The grid is (R / 32, B) blocks: 1,408 a 5.8 Mb genome.
//
// Arithmetic is native uint32: the murmur multiplies wrap mod 2^32 as the
// JAX package's uint32 ops do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW = 128;
constexpr int SLOTS = 64;
constexpr int WORD = 16;                // positions a thread owns: one 16-byte load of codes
constexpr int TILE_ROWS = 32;
constexpr int TILE = TILE_ROWS * ROW;   // positions per block
constexpr int HALO = 32;                // positions before the tile whose windows can select in it (>= w-1)
constexpr int START_WORDS = (HALO + TILE) / WORD;  // words whose positions start a window the tile reads
constexpr int HASH_WORDS = START_WORDS + 2;        // + the 31 positions the last window reaches over
constexpr int CODE_WORDS = HASH_WORDS + 1;         // + the k-1 bases the last k-mer reaches over
constexpr int MASK_WORDS = HASH_WORDS / 2;         // 32-bit mask words over the hashed positions
constexpr int HASH_STRIDE = WORD + 1;              // hash words a thread: odd, so conflict-free
constexpr int THREADS = 288;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 16;               // 2k bits must fit in 32
constexpr int MAX_W = HALO;
constexpr uint32_t UMAX = 0xFFFFFFFFu;
constexpr uint32_t SENTINEL_WORD = 0x04040404u;

static_assert(THREADS >= CODE_WORDS && THREADS % 32 == 0, "one word a thread in every stage");
static_assert(HASH_WORDS % 2 == 0 && HALO % 32 == 0, "mask words line up with rows");

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x;
}

// Four code bytes -> 8 bits, base i at bits 2i (`c & 3` of each byte).
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
    uint32_t t = x & 0x03030303u;
    t = (t | (t >> 6)) & 0x000F000Fu;
    return (t | (t >> 12)) & 0xFFu;
}

// Four code bytes -> 4 bits, bit i set where byte i is an invalid base (>= 4).
__device__ __forceinline__ uint32_t invalid4(uint32_t x) {
    const uint32_t y = __vcmpgtu4(x, 0x03030303u) & 0x01010101u;
    return ((y * 0x01020408u) >> 24) & 0xFu;
}

// Sixteen code bytes -> the packed word (base i at bits 2i) and its 16-bit invalid mask.
__device__ __forceinline__ void pack_word(uint4 v, uint32_t* word, uint16_t* inv) {
    *word = pack4(v.x) | (pack4(v.y) << 8) | (pack4(v.z) << 16) | (pack4(v.w) << 24);
    *inv = (uint16_t)(invalid4(v.x) | (invalid4(v.y) << 4) | (invalid4(v.z) << 8) | (invalid4(v.w) << 12));
}

// The two bits of every base swapped, so that __brev puts them back in order.
__device__ __forceinline__ uint32_t swap_pairs(uint32_t x) {
    return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

// A 16-bit mask spread to the odd bits: bit i -> bit 2i + 1 (the high bit of base i's pair).
__device__ __forceinline__ uint32_t spread_hi(uint32_t x) {
    x = (x | (x << 8)) & 0x00FF00FFu;
    x = (x | (x << 4)) & 0x0F0F0F0Fu;
    x = (x | (x << 2)) & 0x33333333u;
    x = (x | (x << 1)) & 0x55555555u;
    return x << 1;
}

// The low n bits set, for n in [0, 32].
__device__ __forceinline__ uint32_t low_bits(int n) { return n >= 32 ? UMAX : (1u << n) - 1u; }

// How many of a word's 16 positions, which start at stream position g0, lie below `end`.
__device__ __forceinline__ int below(long long end, long long g0) {
    const long long n = end - g0;
    return n <= 0 ? 0 : (n >= WORD ? WORD : (int)n);
}

// Bit j: an invalid base among the k that start at base j of an invalid mask (an OR over k mask
// bits, doubled up): two words' 32 bits for k <= 16, three words' 48 in 64 for k <= 32.
template <class U>
__device__ __forceinline__ U kmer_bad(U inv, int k) {
    U bad = inv;
    for (int cover = 1; cover < k;) {
        const int step = min(cover, k - cover);
        bad |= bad >> step;
        cover += step;
    }
    return bad;
}

// Stage 2 of every kernel: the hashes of a word's 16 k-mer starts to out[0..15] (0xFFFFFFFF where
// the bit of `valid_bits` is clear) and its strand bits.  (w0, w1) are the packed words whose base
// 0 is the word's first k-mer start: the reverse field, the kk = min(k, 16) bases that start at a
// position.  (f0, f1) are the packed words whose base 0 lies k - kk positions later: the forward
// field, the kk bases that end at the k-mer's last (the same words for k <= 16).  With two words in
// two registers, a thread gets a field by one funnel shift and a mask.  In this packing the reverse
// field IS the reverse-complement's complement (rev = ~field), and the forward k-mer is its field
// with the 2-bit groups reversed: __brev of the same shift of the words with each base's two bits
// swapped (swapped once a word, not once a position).  No loop over k.  For k > 16 these are the
// JAX package's uint32 packings, whose shifts of 32 or more give 0: the forward word keeps the
// k-mer's last 16 bases and the reverse word its first 16.
//
// A strand compares the JAX package's packings of the raw codes, in which a sentinel (code 4)
// ORs 4 << 2(kk-1-i) into fwd and 3 - 4 = 0xFFFFFFFF << 2i into rev.  With REBUILD, a k-mer that
// holds sentinels gets those words back from the packed fields and their invalid masks (inv_r from
// w0's first base, inv_f from f0's): fwd | (the mask spread to base pairs, in forward order) << 2,
// bits past 31 dropped, and rev | 0xFFFFFFFF << 2 j_min, j_min the reverse field's first sentinel.
// Without it the strands are those of the packed fields, which the row-compact scans read only
// where the k-mer is valid.
template <bool REBUILD>
__device__ __forceinline__ uint32_t hash_word(uint32_t w0, uint32_t w1, uint32_t f0, uint32_t f1, uint32_t inv_r,
                                              uint32_t inv_f, uint32_t valid_bits, int kk, uint32_t* out) {
    const uint32_t x0 = swap_pairs(f0), x1 = swap_pairs(f1);
    const uint32_t kmask = kk >= 16 ? UMAX : (1u << (2 * kk)) - 1u;
    const int fwd_shift = 32 - 2 * kk;
    const uint32_t ih0 = REBUILD ? spread_hi(inv_f & 0xFFFFu) : 0u;  // already pair-swapped: high bits
    const uint32_t ih1 = REBUILD ? spread_hi(inv_f >> 16) : 0u;
    uint32_t strand_bits = 0;
#pragma unroll
    for (int j = 0; j < WORD; ++j) {
        // Bases j .. j+kk-1 at bits 2i of the funnel-shifted words: that field is the reverse
        // complement's complement, (3 - c) << 2i = ~field; the forward k-mer, c << 2(kk-1-i), is
        // the field with its 2-bit groups in reverse order: __brev of the pair-swapped words.
        uint32_t rev = ~__funnelshift_r(w0, w1, 2 * j) & kmask;
        uint32_t fwd = __brev(__funnelshift_r(x0, x1, 2 * j)) >> fwd_shift;
        out[j] = (valid_bits >> j) & 1u ? mix32(min(fwd, rev)) : UMAX;
        if (REBUILD) {
            const uint32_t mr = (inv_r >> j) & low_bits(kk);
            if (mr) rev |= UMAX << (2 * (__ffs(mr) - 1));
            if ((inv_f >> j) & low_bits(kk)) fwd |= (__brev(__funnelshift_r(ih0, ih1, 2 * j)) >> fwd_shift) << 2;
        }
        strand_bits |= (fwd <= rev ? 1u : 0u) << j;
    }
    return strand_bits;
}

// Stage 3 of both kernels: the winner of each of a word's 16 W-windows, marked in the tile's
// selection mask (selection by scatter: no position reads W offsets).  W is a template parameter,
// so the van Herk / Gil-Werman pass over the word's run of 16 + W - 1 hashes (hash i at
// h[i + i / 16]) has every index known at compile time: suffix minima of the blocks of W
// backwards (<=, the leftmost wins), prefix minima forwards (<), and the window's winner is the
// suffix part unless the prefix part is strictly smaller: ~3 comparisons a position for any W.
// A window marks its winner when its start bit is set in `starts` and its minimum is not
// 0xFFFFFFFF; a winner's hash is then not 0xFFFFFFFF, so its k-mer is valid.
template <int W>
__device__ __forceinline__ void select_winners(const uint32_t* h, uint32_t starts, int word, uint32_t* s_sel) {
    static_assert(W >= 1 && W <= MAX_W, "the halo covers w - 1 positions");
    constexpr int LAST = (WORD - 1) / W * W + W - 1;  // end of the block of W that holds start 15
    uint32_t suffix_h[WORD];
    int suffix_p[WORD];
    uint32_t cur_h = 0;
    int cur_p = 0;
#pragma unroll
    for (int i = LAST; i >= 0; --i) {  // suffix minima inside blocks of W: <=, the leftmost wins
        const uint32_t x = h[i + (i >> 4)];
        if (i % W == W - 1 || x <= cur_h) {
            cur_h = x;
            cur_p = i;
        }
        if (i < WORD) {
            suffix_h[i] = cur_h;
            suffix_p[i] = cur_p;
        }
    }
    uint32_t marks_lo = 0;           // bit i: position i of the run is some window's winner
    unsigned long long marks_hi = 0;  // the same, for the windows that reach past position 31
#pragma unroll
    for (int i = 0; i < WORD + W - 1; ++i) {  // prefix minima inside blocks of W: strict <
        const uint32_t x = h[i + (i >> 4)];
        if (i % W == 0 || x < cur_h) {
            cur_h = x;
            cur_p = i;
        }
        if (i >= W - 1) {  // the window that starts at j ends here
            const int j = i - (W - 1);
            const bool right = cur_h < suffix_h[j];  // the left part wins ties
            const uint32_t best = right ? cur_h : suffix_h[j];
            const int win = right ? cur_p : suffix_p[j];
            if (best != UMAX && (starts & (1u << j))) {
                if (i < 32) marks_lo |= 1u << win;
                else marks_hi |= 1ull << win;
            }
        }
    }
    const unsigned long long marks = (marks_hi | marks_lo) << ((word & 1) * WORD);
    const uint32_t m0 = (uint32_t)marks, m1 = (uint32_t)(marks >> 32);
    if (m0) atomicOr(&s_sel[word >> 1], m0);
    if (m1) atomicOr(&s_sel[(word >> 1) + 1], m1);
}

// The shared slot of run position x: a word's 16 hashes, then one spare slot (HASH_STRIDE).
__device__ __forceinline__ int slot(int x) { return x + (x >> 4); }

// Stages 4 and 5 of the row-compact kernels, over a tile of `rows` rows whose selection mask is
// `sel` (bit q: tile position q, a winner of some window) and whose position q hashes to
// s_hash[slot(x0 + q)]; the outputs start at the genome's row 0.  The mask needs no AND with
// validity: a winner's hash is not 0xFFFFFFFF, so its k-mer is valid.
//   4. Ranking.  A row is four mask words.  The thread that owns a word counts the row's set bits
//      before it (__popc) and walks its own set bits (__ffs): the (hash, col | strand << 7) pairs
//      of the first 64 ranks go to the row's 512 bytes of `stage` in shared memory.  Work follows
//      the ~3 selected positions of a word, not its 16.
//   5. Store.  A warp takes a row at a time; each lane stores two neighbouring slots of hashes and
//      of aux, 0xFFFFFFFF / -1 past the row's count: a row leaves as two 256-byte stores.  counts
//      holds the full count, even above 64 (the caller then seeds that genome on the host).
__device__ __forceinline__ void rank_and_store_rows(const uint32_t* sel, const uint16_t* strand,
                                                    const uint32_t* s_hash, int x0, int rows, uint2* stage,
                                                    int* total, long long row0, long long R, uint32_t* hashes,
                                                    int32_t* aux, int32_t* counts) {
    for (int t = threadIdx.x; t < rows * (ROW / WORD); t += THREADS) {
        const int r = t / (ROW / WORD), col0 = t % (ROW / WORD) * WORD;  // the word's row and first column
        const int mi = t >> 1, mw = r * (ROW / 32);                       // its mask word, its row's first
        uint32_t mine = t & 1 ? sel[mi] >> WORD : sel[mi] & 0xFFFFu;
        int rank = t & 1 ? __popc(sel[mi] & 0xFFFFu) : 0;
#pragma unroll
        for (int q = 0; q < ROW / 32 - 1; ++q)
            if (mw + q < mi) rank += __popc(sel[mw + q]);
        if (col0 == ROW - WORD) total[r] = rank + __popc(mine);  // the row's full count
        const uint32_t st = strand[t];
        while (mine && rank < SLOTS) {
            const int j = __ffs(mine) - 1;
            mine &= mine - 1;
            stage[r * SLOTS + rank++] = make_uint2(s_hash[slot(x0 + t * WORD + j)],
                                                   (uint32_t)(col0 + j) | (((st >> j) & 1u) << 7));
        }
    }
    __syncthreads();
    const int lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < rows && row0 + r < R; r += WARPS) {
        // Slots 2 lane and 2 lane + 1; 0xFFFFFFFF / -1 past the row's count.
        const int n = total[r];
        const uint4 v = *reinterpret_cast<const uint4*>(&stage[r * SLOTS + 2 * lane]);  // (h, a, h, a)
        const bool live0 = 2 * lane < n, live1 = 2 * lane + 1 < n;
        const size_t out_row = (size_t)(row0 + r) * SLOTS + 2 * lane;
        *reinterpret_cast<uint2*>(hashes + out_row) = make_uint2(live0 ? v.x : UMAX, live1 ? v.z : UMAX);
        *reinterpret_cast<int2*>(aux + out_row) = make_int2(live0 ? (int)v.y : -1, live1 ? (int)v.w : -1);
        if (lane == 0) counts[row0 + r] = n;
    }
}

template <int W>
__global__ void __launch_bounds__(THREADS) rowcompact_scan_kernel(
    const uint8_t* __restrict__ codes,  // (B, R + 2*halo_rows, 128)
    int R, int halo_rows, int k,
    uint32_t* __restrict__ hashes,      // out (B, R, 64)
    int32_t* __restrict__ aux,          // out (B, R, 64)
    int32_t* __restrict__ counts) {     // out (B, R)
    __shared__ uint32_t s_word[CODE_WORDS];               // 16 bases a word, 2 bits each
    __shared__ uint16_t s_inv[CODE_WORDS];                // their invalid bits
    __shared__ uint32_t s_hash[HASH_WORDS * HASH_STRIDE];
    __shared__ uint16_t s_strand[HASH_WORDS];             // forward strand canonical
    __shared__ uint32_t s_sel[MASK_WORDS];                // selected, one bit a position
    __shared__ __align__(16) uint2 s_stage[TILE_ROWS][SLOTS];  // each row's (hash, aux) slots
    __shared__ int s_total[TILE_ROWS];                     // each row's full count

    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const long long length = (long long)R * ROW;
    const long long padded_len = (long long)(R + 2 * halo_rows) * ROW;
    const long long first = (long long)blockIdx.x * TILE - HALO;  // stream position of the block's word 0
    const uint8_t* g = codes + (long long)b * padded_len;
    const long long g0 = first + (long long)tid * WORD;           // stream position of this thread's word

    // 1. Pack.
    if (tid < CODE_WORDS) {
        const long long p = (long long)halo_rows * ROW + g0;  // index into the padded stream
        uint4 v = make_uint4(SENTINEL_WORD, SENTINEL_WORD, SENTINEL_WORD, SENTINEL_WORD);
        if (p >= 0 && p + WORD <= padded_len) v = *reinterpret_cast<const uint4*>(g + p);
        pack_word(v, &s_word[tid], &s_inv[tid]);
    }
    if (tid < MASK_WORDS) s_sel[tid] = 0;
    __syncthreads();

    // 2. Hash, strand and validity of the word's 16 k-mer starts.  A k-mer is valid when no
    //    invalid base lies among its k and it starts inside [0, length-k+1).
    if (tid < HASH_WORDS) {
        const uint32_t inv32 = (uint32_t)s_inv[tid] | ((uint32_t)s_inv[tid + 1] << 16);
        const uint32_t inside = low_bits(below(length - k + 1, g0)) & ~low_bits(below(0, g0));
        const uint32_t valid_bits = ~kmer_bad(inv32, k) & inside;
        const uint32_t w0 = s_word[tid], w1 = s_word[tid + 1];
        s_strand[tid] = (uint16_t)hash_word<false>(w0, w1, w0, w1, inv32, inv32, valid_bits, k,
                                                   s_hash + tid * HASH_STRIDE);
    }
    __syncthreads();

    // 3. The winner of each of the word's 16 windows, marked in the tile's mask.  Window starts
    //    inside [0, length-k-W+2).
    if (tid < START_WORDS) {
        const uint32_t starts = low_bits(below(length - k - W + 2, g0)) & ~low_bits(below(0, g0));
        select_winners<W>(s_hash + tid * HASH_STRIDE, starts, tid, s_sel);
    }
    __syncthreads();
    // 4, 5. Rank each row's winners, stage the first 64, store each row as whole lines.
    rank_and_store_rows(s_sel + HALO / 32, s_strand + HALO / WORD, s_hash, HALO, TILE_ROWS, &s_stage[0][0], s_total,
                        (long long)blockIdx.x * TILE_ROWS, R, hashes + (size_t)b * R * SLOTS,
                        aux + (size_t)b * R * SLOTS, counts + (size_t)b * R);
}

template <int W>
cudaError_t launch(const uint8_t* codes, int B, int R, int halo_rows, int k, uint32_t* hashes,
                   int32_t* aux, int32_t* counts, cudaStream_t stream) {
    const dim3 grid((unsigned)((R + TILE_ROWS - 1) / TILE_ROWS), (unsigned)B);
    rowcompact_scan_kernel<W><<<grid, THREADS, 0, stream>>>(codes, R, halo_rows, k, hashes, aux, counts);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------------------------
// Flat minimizer scan.
//
// Replaces the XLA program kaptive_tpu/ops/minimizer.py::minimizer_scan.  For each position of
// a (B, L) uint8 code stream (each row its own stream) it writes what that function returns:
// `selected` (the position starts the w-window minimum of some window, the leftmost winning
// ties), the canonical k-mer's murmur3 hash as an int64 value in [0, 2^32) (0xFFFFFFFF where no
// valid k-mer starts; the values callers receive, so no pass converts them) and the strand
// (forward packing <= reverse packing).  The plain PyTorch version is
// kaptive_tpu_torch/ops/scan.py::minimizer_scan_plain.
//
// The semantics are the JAX function's, rolls included: the k-mer at position i reads the codes
// at (i + j) mod L, packed raw (a code >= 4 ORs its high bits into the word, and 3 - c wraps),
// so `strands` agree at every position, also where no valid k-mer starts.  A k-mer is valid
// when none of its codes is >= 4 and i < L-k+1; a window starting at s is valid when its
// minimum is not 0xFFFFFFFF and s < L-k-w+2.  The end guards sit at the row's length L.
//
// What bounds it.  A position reads 1 byte and writes 10 (selected, the 8-byte hash, strand):
// 11 bytes, and a k-mer, a hash and a window minimum need ~35 integer operations whatever the
// design.  For four 5.3 Mb genomes of 5,767,168 padded positions (23.07 M) that is 0.0757 ms of
// bytes at 3.35 TB/s and 0.0482 ms of operations at 16.75 T/s: the stores bound it.  The w = 10
// instance compiles to 54 registers without spills (4 blocks an SM, set by registers) and scans
// that stream in 0.096 ms, 79% of the bound (NVIDIA H100 80GB HBM3, 700 W; the first kernel, a
// thread a position with k and w read at run time, took 0.42 ms).  w = 32 needs 72 registers and
// spills 4 bytes: 0.121 ms.
//
// Design: the row-compact kernel's first three stages over tiles of TILE = 4,096 positions of a
// row, one block a (tile, row), 288 threads, a thread a word of 16 positions; W a template
// parameter, k a run-time mask.  What differs:
//   1. Pack.  One 16-byte load a word where the row is 16-byte aligned (L % 16 == 0 and the
//      pointers aligned: every main-path width is a multiple of 128).  A word that crosses the
//      row's edge (the last tile's, or every word of an unaligned row) is read a byte at a time:
//      the sentinel before 0, the code at g mod L past L, as jnp.roll does; a word from
//      L + 15 on is all sentinels (no output reads it).  A flag marks a word with a code > 4.
//   2. Hash, and strands at every position.  The packed words keep `c & 3` and an invalid mask,
//      not the raw codes; for codes 0-4 (all the encoder emits) the raw packings are rebuilt from
//      the two (hash_word<true>, only in words whose k-mers reach a sentinel: the pad tail and
//      contig edges).  A word whose k-mers reach a code > 4 takes its strands from a loop over
//      its raw codes (raw_strands), exact and never run on encoder output.
//   3. Windows: select_winners<W>, as in the row-compact scan.
//   4. Store the tile as whole lines (store_flat_tile, shared with the run-time form).
// ---------------------------------------------------------------------------------------------

// The code at position g of a row of L codes, as the JAX scan's rolls read it.
__device__ __forceinline__ uint32_t code_at(const uint8_t* row, long long L, long long g) {
    return g < 0 ? 4u : row[g < L ? g : g % L];
}

// The strand bits of the word that starts at g0, from the raw codes: the JAX packing itself, of
// the kk = min(k, 16) bases each uint32 word keeps (the reverse word's first, the forward word's last).
__device__ __noinline__ uint32_t raw_strands(const uint8_t* row, long long L, long long g0, int k) {
    const int kk = min(k, 16);
    uint32_t bits = 0;
    for (int j = 0; j < WORD; ++j) {
        uint32_t fwd = 0, rev = 0;
        for (int i = 0; i < kk; ++i) {
            rev |= (3u - code_at(row, L, g0 + j + i)) << (2 * i);
            fwd |= code_at(row, L, g0 + j + k - kk + i) << (2 * (kk - 1 - i));
        }
        bits |= (fwd <= rev ? 1u : 0u) << j;
    }
    return bits;
}

// Four bits -> four bytes of 0 / 1, bit i to byte i.
__device__ __forceinline__ uint32_t bytes4(uint32_t b) { return (b * 0x00204081u) & 0x01010101u; }

__device__ __forceinline__ uint4 bytes16(uint32_t b) {
    return make_uint4(bytes4(b & 15u), bytes4((b >> 4) & 15u), bytes4((b >> 8) & 15u), bytes4((b >> 12) & 15u));
}

// Stage 4 of the flat kernels: a tile's first n positions, from its selection mask `sel` (bit q:
// tile position q), its strand words and the hashes at s_hash[slot(x0 + q)] (x0 even); the outputs
// start at the tile's first position.  Where the row is aligned (n a multiple of 16), a thread
// writes a word's 16 `selected` and 16 `strands` bytes as one 16-byte store each, and the hashes
// leave as 16-byte pairs of int64, consecutive threads on consecutive pairs, so a warp writes 512
// contiguous bytes a store; else a position at a time.
__device__ __forceinline__ void store_flat_tile(const uint32_t* sel, const uint16_t* strand, const uint32_t* s_hash,
                                                int x0, int n, bool aligned, uint8_t* selected, long long* hashes,
                                                uint8_t* strands) {
    const int tid = threadIdx.x;
    if (aligned) {
        for (int v = tid; 2 * v < n; v += THREADS) {
            const uint32_t* h = s_hash + slot(x0 + 2 * v);  // x0 + 2v and x0 + 2v + 1 share a word
            *reinterpret_cast<longlong2*>(hashes + 2 * v) = make_longlong2(h[0], h[1]);
        }
        for (int t = tid; t * WORD < n; t += THREADS) {
            const uint32_t bits = (sel[t >> 1] >> ((t & 1) * WORD)) & 0xFFFFu;
            *reinterpret_cast<uint4*>(selected + t * WORD) = bytes16(bits);
            *reinterpret_cast<uint4*>(strands + t * WORD) = bytes16(strand[t]);
        }
    } else {
        for (int q = tid; q < n; q += THREADS) {
            selected[q] = (uint8_t)((sel[q >> 5] >> (q & 31)) & 1u);
            hashes[q] = s_hash[slot(x0 + q)];
            strands[q] = (uint8_t)((strand[q >> 4] >> (q & 15)) & 1u);
        }
    }
}

template <int W>
__global__ void __launch_bounds__(THREADS) minimizer_scan_kernel(
    const uint8_t* __restrict__ codes,  // (B, L)
    long long L, int k, bool aligned,   // aligned: L % 16 == 0 and every pointer 16-byte aligned
    uint8_t* __restrict__ selected,     // out (B, L): 0 or 1
    long long* __restrict__ hashes,     // out (B, L): values in [0, 2^32)
    uint8_t* __restrict__ strands) {    // out (B, L): 0 or 1
    __shared__ uint32_t s_word[CODE_WORDS];
    __shared__ uint16_t s_inv[CODE_WORDS];
    __shared__ uint8_t s_odd[CODE_WORDS];                 // a code > 4 in the word
    __shared__ uint32_t s_hash[HASH_WORDS * HASH_STRIDE];
    __shared__ uint16_t s_strand[HASH_WORDS];
    __shared__ uint32_t s_sel[MASK_WORDS];

    const int tid = threadIdx.x;
    const long long tile0 = (long long)blockIdx.x * TILE;
    const long long g0 = tile0 - HALO + (long long)tid * WORD;  // stream position of this thread's word
    const uint8_t* row = codes + (long long)blockIdx.y * L;

    // 1. Pack.
    if (tid < CODE_WORDS) {
        uint4 v = make_uint4(SENTINEL_WORD, SENTINEL_WORD, SENTINEL_WORD, SENTINEL_WORD);
        if (aligned && g0 >= 0 && g0 + WORD <= L) {
            v = *reinterpret_cast<const uint4*>(row + g0);
        } else if (g0 + WORD > 0 && g0 < L + MAX_K - 1) {
            uint32_t part[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int i = 0; i < WORD; ++i) part[i >> 2] |= code_at(row, L, g0 + i) << (8 * (i & 3));
            v = make_uint4(part[0], part[1], part[2], part[3]);
        }
        pack_word(v, &s_word[tid], &s_inv[tid]);
        s_odd[tid] = (__vcmpgtu4(v.x, SENTINEL_WORD) | __vcmpgtu4(v.y, SENTINEL_WORD)
                      | __vcmpgtu4(v.z, SENTINEL_WORD) | __vcmpgtu4(v.w, SENTINEL_WORD)) != 0u;
    }
    if (tid < MASK_WORDS) s_sel[tid] = 0;
    __syncthreads();

    // 2. Hash and strand of the word's 16 k-mer starts; the strands of the tile's words only.
    if (tid < HASH_WORDS) {
        const uint32_t w0 = s_word[tid], w1 = s_word[tid + 1];
        const uint32_t inv32 = (uint32_t)s_inv[tid] | ((uint32_t)s_inv[tid + 1] << 16);
        const uint32_t inside = low_bits(below(L - k + 1, g0)) & ~low_bits(below(0, g0));
        const uint32_t valid_bits = ~kmer_bad(inv32, k) & inside;
        const bool stored = tid >= HALO / WORD && tid < START_WORDS;
        uint32_t* out = s_hash + tid * HASH_STRIDE;
        const uint32_t strand_bits = stored && (inv32 & low_bits(WORD + k - 1))
                                         ? hash_word<true>(w0, w1, w0, w1, inv32, inv32, valid_bits, k, out)
                                         : hash_word<false>(w0, w1, w0, w1, inv32, inv32, valid_bits, k, out);
        if (stored) s_strand[tid] = (uint16_t)(s_odd[tid] | s_odd[tid + 1] ? raw_strands(row, L, g0, k) : strand_bits);
    }
    __syncthreads();

    // 3. The winner of each of the word's 16 windows, marked in the tile's mask.
    if (tid < START_WORDS) {
        const uint32_t starts = low_bits(below(L - k - W + 2, g0)) & ~low_bits(below(0, g0));
        select_winners<W>(s_hash + tid * HASH_STRIDE, starts, tid, s_sel);
    }
    __syncthreads();

    // 4. Store the tile's positions inside the row.
    const int n = (int)min((long long)TILE, L - tile0);
    const long long out0 = (long long)blockIdx.y * L + tile0;
    store_flat_tile(s_sel + HALO / 32, s_strand + HALO / WORD, s_hash, HALO, n, aligned, selected + out0,
                    hashes + out0, strands + out0);
}

template <int W>
cudaError_t launch_flat(const uint8_t* codes, int B, long long L, int k, bool aligned, uint8_t* selected,
                        long long* hashes, uint8_t* strands, cudaStream_t stream) {
    const dim3 grid((unsigned)((L + TILE - 1) / TILE), (unsigned)B);
    minimizer_scan_kernel<W><<<grid, THREADS, 0, stream>>>(codes, L, k, aligned, selected, hashes, strands);
    return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// ---------------------------------------------------------------------------------------------
// The run-time form of both scans: k and w read at run time, one tiled pass in shared memory.
//
// The tiled kernels above take k <= MAX_K (a k-mer in two packed words) and w <= MAX_W (the
// block's halo, a template parameter).  The JAX scans set no bound on either: they pack into
// uint32 with XLA's shifts, which give 0 for a shift of 32 or more, so for k > 16 the forward
// word keeps the k-mer's last 16 bases and the reverse word its first 16, while validity still
// spans all k; and the window of w k-mer starts may be as wide as the stream.  scan_rt_kernel
// computes the same outputs, bit for bit, for every (k, w) whose run fits a block's shared memory
// (rt_plan); the sparse-table form below takes the rest.
//
// What bounds it.  As for the tiled kernels: the flat scan's 11 bytes a position (a code read;
// selected, an int64 hash and a strand written), the row-compact scan's ~35 integer operations a
// position.  The form before this one ran a thread a position through device memory: a loop over
// k raw bytes, floor(log2 w) sparse-table passes of 8-byte keys, a scatter of selected bytes and
// (row-compact) a compaction that read them all back, ~24 + 24 log2(w) bytes a position and 7 to
// 13 launches: at (17, 40) 5.8% (flat) and 3.4% (row-compact) of the bound on an NVIDIA H100
// 80GB HBM3 at 700 W.  Here a position costs what it costs in the tiled kernels plus the halo a
// tile recomputes, and nothing but the outputs goes through device memory: ~1.8x the tiled
// kernels' time at (17, 40), 44% (flat) and 28% (row-compact) of the bound (PERF.md section 6,
// measure_flat_scan.py).
//
// Layout.  One block of THREADS = 288 threads per (tile of T = RT_TILE = 4,096 positions (32
// scan rows), row).  The block's run starts hb = w - 1 positions before the tile, rounded up to a
// 32-bit mask word; it hashes hb + T + w - 1 positions (nhw words of 16) and packs k + 31 more
// codes.  The halo a tile recomputes grows with w (35% of a block's positions at w = 1,100); a
// wider tile would cut that share but doubles the shared memory a block holds, so that past
// w ~ 1,000 an SM holds one block of 9 warps instead of three (measure_flat_scan.py times an
// 8,192-position build beside this one).  A thread takes a word of 16 positions at a time (a
// loop over the run's words):
//   1. Pack.  16-byte loads of codes packed to 2 bits a base with a 16-bit invalid mask, and (flat)
//      a flag for a code > 4, as in the tiled kernels; the flat form reads the code at g mod L past
//      the row's end (the rolls) and the sentinel before 0; the row-compact form reads its padded
//      stream (a code outside the stream reaches only k-mers and windows its guards reject).
//      For k > 32, an exclusive prefix count of invalid bases over the run's words (a block scan).
//   2. Hash (hash_word): the reverse field is the kk = min(k, 16) bases that start at a position,
//      the forward field the kk that end at its k-mer's last base: each one funnel shift of two
//      packed words (the forward pair itself funnel-shifted by (k - kk) mod 16 bases once a word).
//      Validity: no invalid bit among the k-mer's k mask bits: an OR over a 48-bit window of mask
//      words for k <= 32, the difference of two prefix counts past that.  The flat form rebuilds
//      the raw packings' strands where a k-mer holds a sentinel and loops over raw codes where it
//      reaches a code > 4 (raw_strands), as the tiled flat kernel does.
//   3. Windows, van Herk / Gil-Werman in blocks of w over the run: a forward segmented scan
//      stores each position's prefix minimum inside its block (hash and position in two shared
//      arrays); a backward one gives each window start its suffix minimum, joins the prefix
//      minimum at the window's end and marks the winner in the tile's selection mask (selection
//      by scatter; a thread skips a winner it has just marked).  Ties go left by the scans'
//      directions, with 32-bit compares: forward a minimum moves only when strictly smaller,
//      backward also on a tie, and the join takes the prefix part only when strictly smaller.
//      Each scan is a thread's 16 positions in registers, then a block scan of the words'
//      (minimum since the last restart, its position, restart seen) triples (a warp's shuffles,
//      then the 9 warps' totals scanned in each warp's lanes, a carry from one round of 288
//      words to the next).  ~3 comparisons a position, whatever w is.
//   4. Output.  Flat: selected, int64 hashes and strands of the tile as whole lines, as
//      minimizer_scan_kernel stores them.  Row-compact: each 128-position row ranks its winners
//      (__popc over the mask words before a word, __ffs over its own), stages the first 64 (hash,
//      col | strand << 7) pairs in shared memory (over the prefix arrays, free by then) and
//      leaves as two 256-byte stores; counts holds the full count, even above 64.
// No key, span or selected array goes through device memory, and the wrapper allocates nothing
// but the outputs.
//
// Shared memory: ~10.6 bytes a hashed position (a 32-bit hash, a 32-bit and a 16-bit prefix
// minimum, each padded to 17 words of 16 for conflict-free strides) and 7 bytes a word of codes:
// ~48 KB at w = 40, ~70 KB at w = 1,100 (T = 4,096).  Above 48 KB the launch opts in with
// cudaFuncSetAttribute.  The range: k <= RT_MAX_K and the plan at T = 4,096 within the 227 KB a
// block can have (w up to ~8,400 at k <= 32: kts_scan_any_max_w).
// ---------------------------------------------------------------------------------------------

constexpr int RT_TILE = 4096;                // positions a block outputs (32 scan rows)
constexpr int RT_MAX_K = 1024;               // the longest k-mer the form takes
constexpr int RT_MAX_SMEM = 232448;          // the shared memory a block can opt in to on sm_90 (227 KB)

// A block scan's element: the leftmost minimum hash since the last restart (or over all), its run
// position, and whether a restart (a block of w's first position in scan order) was seen.
struct Seg {
    uint32_t h;
    int p, f;
};

// The geometry of a run-time launch; rt_plan fills it, the kernel reads it.
struct RtPlan {
    int k, w, tile;
    int hb;      // positions of the run before the tile: w - 1 rounded up to a 32-bit mask word
    int nhw;     // words of hashed positions: hb + tile + w - 1 positions rounded up
    int ncw;     // words of codes: the hashed words, the k - 1 bases the last k-mer reaches, 2 spare
    int off_pre_h, off_hash, off_pre_p, off_word, off_inv, off_flag, off_cnt, off_sel, off_strand, off_tot;
    int smem;    // dynamic shared bytes
};

// The plan of a block for (k, w); false when its run does not fit the block's shared memory.
bool rt_plan(int k, long long w, RtPlan* out) {
    const int tile = RT_TILE;
    if (k < 1 || k > RT_MAX_K || w < 1 || w > (1 << 16)) return false;
    RtPlan p{};
    p.k = k;
    p.w = (int)w;
    p.tile = tile;
    p.hb = (int)((w - 1 + 31) / 32 * 32);
    const long long nh = p.hb + (long long)tile + w - 1;
    p.nhw = (int)((nh + WORD - 1) / WORD);
    p.ncw = p.nhw + (k + WORD - 1) / WORD + 2;
    if ((long long)p.nhw * WORD >= (1 << 16)) return false;  // run positions are 16-bit
    long long off = 0;
    auto take = [&off](long long bytes) {
        const long long at = off;
        off += (bytes + 15) / 16 * 16;
        return (int)at;
    };
    const long long slots = (long long)p.nhw * HASH_STRIDE;
    p.off_pre_h = take(4 * slots);  // first: the row-compact staging (4 tile + tile / 32 bytes) reuses it
    p.off_hash = take(4 * slots);
    p.off_pre_p = take(2 * slots);
    p.off_word = take(4LL * p.ncw);
    p.off_inv = take(2LL * p.ncw);
    p.off_flag = take(p.ncw);
    p.off_cnt = take(k > 32 ? 4LL * p.ncw : 0);
    p.off_sel = take(tile / 8);
    p.off_strand = take(tile / 8);
    p.off_tot = take(2LL * WARPS * (long long)sizeof(Seg));
    if (off > RT_MAX_SMEM) return false;
    p.smem = (int)off;
    *out = p;
    return true;
}

// a before b in scan order.  Forward (positions ascending), b takes the minimum only when strictly
// smaller; backward (descending), also on a tie: either way the leftmost minimum wins.
template <bool BACKWARD>
__device__ __forceinline__ Seg seg_join(Seg a, Seg b) {
    if (b.f) return b;
    return (BACKWARD ? b.h <= a.h : b.h < a.h) ? Seg{b.h, b.p, a.f} : a;
}

__device__ __forceinline__ int shfl_up(int x, int d) { return __shfl_up_sync(0xFFFFFFFFu, x, d); }
__device__ __forceinline__ int shfl(int x, int src) { return __shfl_sync(0xFFFFFFFFu, x, src); }

__device__ __forceinline__ Seg shfl_up(Seg s, int d) {
    return Seg{__shfl_up_sync(0xFFFFFFFFu, s.h, d), __shfl_up_sync(0xFFFFFFFFu, s.p, d),
               __shfl_up_sync(0xFFFFFFFFu, s.f, d)};
}
__device__ __forceinline__ Seg shfl(Seg s, int src) {
    return Seg{__shfl_sync(0xFFFFFFFFu, s.h, src), __shfl_sync(0xFFFFFFFFu, s.p, src),
               __shfl_sync(0xFFFFFFFFu, s.f, src)};
}

// An inclusive scan across a warp's lanes (Hillis-Steele: a lane below the shift keeps its value).
template <class V, class Join>
__device__ __forceinline__ V warp_inclusive(V x, int lanes, Join join) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int d = 1; d < lanes; d <<= 1) {
        const V o = shfl_up(x, d);
        if (lane >= d) x = join(o, x);
    }
    return x;
}

// One round of a block scan in thread order: returns this thread's exclusive prefix (after
// `carry`, the value of the rounds before) and folds the round's total into `carry`.  A warp
// scans its lanes; every warp then scans the warps' totals in its own lanes, so no thread walks
// them one by one.  Every thread calls it; `tot` holds two rounds of warp totals, so a round
// writes one half while the round before may still read the other.
template <class V, class Join>
__device__ __forceinline__ V block_exclusive(V x, V* tot, int round, V& carry, V identity, Join join) {
    static_assert(WARPS <= 16, "the warps' totals fit a half warp");
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const V incl = warp_inclusive(x, 32, join);
    const V up = shfl_up(incl, 1);
    V* t = tot + (round & 1) * WARPS;
    if (lane == 31) t[warp] = incl;
    __syncthreads();
    const V totals = warp_inclusive(lane < WARPS ? t[lane] : identity, 16, join);
    const V earlier = shfl(totals, warp > 0 ? warp - 1 : 0);
    const V before = warp > 0 ? join(carry, earlier) : carry;
    carry = join(carry, shfl(totals, WARPS - 1));
    return lane == 0 ? before : join(before, up);
}

// Invalid bases among run positions [0, x): a word's prefix count and its own bits below x.
__device__ __forceinline__ int invalid_before(const int* cnt, const uint16_t* inv, int x) {
    return cnt[x >> 4] + __popc((uint32_t)inv[x >> 4] & ((1u << (x & 15)) - 1u));
}

struct RtArgs {
    const uint8_t* codes;
    long long n;        // codes a row of the input: L (flat), (R + 2 halo_rows) * 128 (row-compact)
    long long pad;      // index of stream position 0 in a row: 0 (flat), halo_rows * 128 (row-compact)
    long long length;   // stream positions: L, or R * 128
    bool aligned;       // flat: L % 16 == 0 and every pointer 16-byte aligned
    uint8_t* selected;  // flat outputs (B, L)
    long long* hashes64;
    uint8_t* strands;
    uint32_t* hashes32;  // row-compact outputs (B, R, 64), (B, R, 64), (B, R)
    int32_t* aux;
    int32_t* counts;
};

template <bool FLAT>
__global__ void __launch_bounds__(THREADS) scan_rt_kernel(const RtPlan P, const RtArgs A) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint32_t* s_pre_h = reinterpret_cast<uint32_t*>(smem + P.off_pre_h);  // prefix minima: hash
    uint32_t* s_hash = reinterpret_cast<uint32_t*>(smem + P.off_hash);
    uint16_t* s_pre_p = reinterpret_cast<uint16_t*>(smem + P.off_pre_p);  // prefix minima: run position
    uint32_t* s_word = reinterpret_cast<uint32_t*>(smem + P.off_word);
    uint16_t* s_inv = reinterpret_cast<uint16_t*>(smem + P.off_inv);
    uint8_t* s_odd = smem + P.off_flag;                                     // a code > 4 in the word
    int* s_cnt = reinterpret_cast<int*>(smem + P.off_cnt);                  // k > 32: invalid bases before a word
    uint32_t* s_sel = reinterpret_cast<uint32_t*>(smem + P.off_sel);       // the tile's selection mask
    uint16_t* s_strand = reinterpret_cast<uint16_t*>(smem + P.off_strand); // the tile's strands
    Seg* s_tot = reinterpret_cast<Seg*>(smem + P.off_tot);

    const int tid = threadIdx.x;
    const int k = P.k, w = P.w, T = P.tile, hb = P.hb;
    const long long length = A.length;
    const long long tile0 = (long long)blockIdx.x * T;
    const long long r0 = tile0 - hb;  // stream position of run position 0
    const uint8_t* row = A.codes + (long long)blockIdx.y * A.n;

    // 1. Pack.
    for (int wd = tid; wd < P.ncw; wd += THREADS) {
        const long long g0 = r0 + (long long)wd * WORD;
        uint4 v = make_uint4(SENTINEL_WORD, SENTINEL_WORD, SENTINEL_WORD, SENTINEL_WORD);
        if (FLAT) {
            if (A.aligned && g0 >= 0 && g0 + WORD <= length) {
                v = *reinterpret_cast<const uint4*>(row + g0);
            } else if (g0 + WORD > 0 && g0 < length + k - 1) {
                uint32_t part[4] = {0u, 0u, 0u, 0u};
#pragma unroll
                for (int i = 0; i < WORD; ++i) part[i >> 2] |= code_at(row, length, g0 + i) << (8 * (i & 3));
                v = make_uint4(part[0], part[1], part[2], part[3]);
            }
            s_odd[wd] = (__vcmpgtu4(v.x, SENTINEL_WORD) | __vcmpgtu4(v.y, SENTINEL_WORD)
                         | __vcmpgtu4(v.z, SENTINEL_WORD) | __vcmpgtu4(v.w, SENTINEL_WORD)) != 0u;
        } else {
            const long long p = A.pad + g0;
            if (p >= 0 && p + WORD <= A.n) v = *reinterpret_cast<const uint4*>(row + p);
        }
        pack_word(v, &s_word[wd], &s_inv[wd]);
    }
    for (int i = tid; i < T / 32; i += THREADS) s_sel[i] = 0;
    __syncthreads();
    if (k > 32) {  // invalid bases before each code word
        int carry = 0;
        int* tot = reinterpret_cast<int*>(s_tot);
        for (int base = 0; base < P.ncw; base += THREADS) {
            const int wd = base + tid;
            const int c = wd < P.ncw ? __popc((uint32_t)s_inv[wd]) : 0;
            const int before = block_exclusive(c, tot, base / THREADS, carry, 0, [](int a, int b) { return a + b; });
            if (wd < P.ncw) s_cnt[wd] = before;
        }
        __syncthreads();
    }

    // 2. Hash, validity and strands of each hashed word's 16 k-mer starts.  A k-mer is valid when
    //    no invalid base lies among its k and it starts inside [0, length-k+1).
    const int kk = min(k, WORD);
    const int fo = k - kk;  // the forward field's first base, from the k-mer's start
    for (int wd = tid; wd < P.nhw; wd += THREADS) {
        const long long g0 = r0 + (long long)wd * WORD;
        uint32_t bad;
        if (k <= 32) {
            bad = (uint32_t)kmer_bad((unsigned long long)s_inv[wd] | ((unsigned long long)s_inv[wd + 1] << 16)
                                         | ((unsigned long long)s_inv[wd + 2] << 32), k) & 0xFFFFu;
        } else {
            bad = 0;
            const int x0 = wd * WORD;
#pragma unroll 4
            for (int j = 0; j < WORD; ++j)
                if (invalid_before(s_cnt, s_inv, x0 + j + k) != invalid_before(s_cnt, s_inv, x0 + j)) bad |= 1u << j;
        }
        const uint32_t inside = low_bits(below(length - k + 1, g0)) & ~low_bits(below(0, g0));
        const uint32_t valid_bits = ~bad & inside & 0xFFFFu;
        const uint32_t w0 = s_word[wd], w1 = s_word[wd + 1];
        const int a = wd + (fo >> 4), sh = 2 * (fo & 15);
        const uint32_t f0 = __funnelshift_r(s_word[a], s_word[a + 1], sh);
        const uint32_t f1 = __funnelshift_r(s_word[a + 1], s_word[a + 2], sh);
        const uint32_t inv_r = (uint32_t)s_inv[wd] | ((uint32_t)s_inv[wd + 1] << 16);
        const uint32_t inv_f = (uint32_t)(((unsigned long long)s_inv[a] | ((unsigned long long)s_inv[a + 1] << 16)
                                           | ((unsigned long long)s_inv[a + 2] << 32)) >> (fo & 15));
        uint32_t* out = s_hash + wd * HASH_STRIDE;
        const bool stored = wd >= hb / WORD && wd < (hb + T) / WORD;  // a word of the tile
        uint32_t strand_bits;
        if (FLAT && stored && ((inv_r | inv_f) & low_bits(WORD + kk - 1))) {
            strand_bits = hash_word<true>(w0, w1, f0, f1, inv_r, inv_f, valid_bits, kk, out);
            bool odd = false;  // a code > 4 among the bases the word's k-mers reach
            for (int q = wd; q <= (wd * WORD + WORD - 2 + k) >> 4; ++q) odd |= s_odd[q] != 0;
            if (odd) strand_bits = raw_strands(row, length, g0, k);
        } else {
            strand_bits = hash_word<false>(w0, w1, f0, f1, inv_r, inv_f, valid_bits, kk, out);
        }
        if (stored) s_strand[wd - hb / WORD] = (uint16_t)strand_bits;
    }
    __syncthreads();

    // 3a. Prefix minima inside blocks of w (a block starts where x % w == 0), forward.  A word's
    //     16 hashes stay in registers from the word's own pass to its pass after the block scan.
    const Seg none{UMAX, 0, 0};
    uint32_t hv[WORD];
    Seg carry = none;
    for (int base = 0; base < P.nhw; base += THREADS) {
        const int wd = base + tid;
        const int x0 = wd * WORD;
        const int p0 = x0 % w;  // the word's first position inside its block
        Seg mine = none;
        if (wd < P.nhw) {
            int p = p0;
#pragma unroll
            for (int j = 0; j < WORD; ++j) {
                hv[j] = s_hash[slot(x0 + j)];
                if (p == 0 || hv[j] < mine.h) mine = Seg{hv[j], x0 + j, mine.f | (p == 0)};
                if (++p == w) p = 0;
            }
        }
        const Seg before = block_exclusive(mine, s_tot, base / THREADS, carry, none,
                                           [](Seg a, Seg b) { return seg_join<false>(a, b); });
        if (wd < P.nhw) {
            uint32_t cur_h = before.h;
            int cur_p = before.p, p = p0;
#pragma unroll
            for (int j = 0; j < WORD; ++j) {
                if (p == 0 || hv[j] < cur_h) {
                    cur_h = hv[j];
                    cur_p = x0 + j;
                }
                s_pre_h[slot(x0 + j)] = cur_h;
                s_pre_p[slot(x0 + j)] = (uint16_t)cur_p;
                if (++p == w) p = 0;
            }
        }
    }
    __syncthreads();

    // 3b. Suffix minima inside blocks of w (a block ends where x % w == w - 1), backward; the
    //     window that starts at x is its suffix minimum joined with the prefix minimum at x + w - 1
    //     (the suffix part wins a tie: it lies left).  It marks its winner when its minimum is
    //     not 0xFFFFFFFF (so the winner's k-mer is valid) and it starts inside [0, length-k-w+2).
    carry = none;
    const long long n_starts = length - k - w + 2;
    for (int base = 0; base < P.nhw; base += THREADS) {
        const int wd = P.nhw - 1 - (base + tid);
        const int x0 = wd * WORD;
        const int p0 = wd >= 0 ? (x0 + WORD - 1) % w : 0;  // the word's last position inside its block
        Seg mine = none;
        if (wd >= 0) {
            int p = p0;
#pragma unroll
            for (int j = WORD - 1; j >= 0; --j) {
                hv[j] = s_hash[slot(x0 + j)];
                if (p == w - 1 || hv[j] <= mine.h) mine = Seg{hv[j], x0 + j, mine.f | (p == w - 1)};
                if (--p < 0) p = w - 1;
            }
        }
        const Seg before = block_exclusive(mine, s_tot, base / THREADS, carry, none,
                                           [](Seg a, Seg b) { return seg_join<true>(a, b); });
        if (wd >= 0) {
            const long long g0 = r0 + x0;
            const uint32_t starts = wd < (hb + T) / WORD
                                        ? low_bits(below(n_starts, g0)) & ~low_bits(below(0, g0)) : 0u;
            uint32_t cur_h = before.h;
            int cur_p = before.p, p = p0, last = -(1 << 30);
#pragma unroll
            for (int j = WORD - 1; j >= 0; --j) {
                if (p == w - 1 || hv[j] <= cur_h) {
                    cur_h = hv[j];
                    cur_p = x0 + j;
                }
                if (--p < 0) p = w - 1;
                if ((starts >> j) & 1u) {
                    const int e = slot(x0 + j + w - 1);
                    const uint32_t pre_h = s_pre_h[e];
                    const bool right = pre_h < cur_h;
                    const uint32_t best = right ? pre_h : cur_h;
                    const int win = (right ? (int)s_pre_p[e] : cur_p) - hb;  // the winner's tile position
                    if (best != UMAX && win != last) {
                        last = win;
                        if (win >= 0 && win < T) atomicOr(&s_sel[win >> 5], 1u << (win & 31));
                    }
                }
            }
        }
    }
    __syncthreads();

    // 4. Output.
    if (FLAT) {
        const long long out0 = (long long)blockIdx.y * length + tile0;
        store_flat_tile(s_sel, s_strand, s_hash, hb, (int)min((long long)T, length - tile0), A.aligned,
                        A.selected + out0, A.hashes64 + out0, A.strands + out0);
    } else {  // the staging reuses the prefix arrays, free by now
        const long long R = length / ROW;
        const size_t genome = (size_t)blockIdx.y * R;
        uint2* stage = reinterpret_cast<uint2*>(smem + P.off_pre_h);
        rank_and_store_rows(s_sel, s_strand, s_hash, hb, T / ROW, stage, reinterpret_cast<int*>(stage + T / ROW * SLOTS),
                            (long long)blockIdx.x * (T / ROW), R, A.hashes32 + genome * SLOTS, A.aux + genome * SLOTS,
                            A.counts + genome);
    }
}

// One launch of the run-time form over B rows of `length` positions; cudaErrorInvalidValue when
// (k, w) does not fit a block (the caller then takes the sparse-table form).
template <bool FLAT>
cudaError_t launch_rt(const RtArgs& a, int B, int k, long long w, cudaStream_t stream) {
    RtPlan p;
    if (!rt_plan(k, w, &p)) return cudaErrorInvalidValue;
    const long long tiles = (a.length + p.tile - 1) / p.tile;
    if (B > 65535 || tiles > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
    const cudaError_t err =
        cudaFuncSetAttribute(scan_rt_kernel<FLAT>, cudaFuncAttributeMaxDynamicSharedMemorySize, RT_MAX_SMEM);
    if (err != cudaSuccess) return err;
    scan_rt_kernel<FLAT><<<dim3((unsigned)tiles, (unsigned)B), THREADS, p.smem, stream>>>(p, a);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------------------------
// The sparse-table form: every k >= 1 and w >= 1, for the (k, w) whose run does not fit a block.
//
// Four kernels over device memory, a thread a position:
//   1. scan_any_hash_kernel: the packings of the k codes from the raw bytes (every shift below 32
//      guarded explicitly: a shift by 32 or more is undefined in C++), validity, strand, hash; it
//      writes each position's window key, hash << 32 | position (so the minimum key is the
//      smallest hash and, among equals, the leftmost position), its strand, and clears selected.
//   2. scan_any_span_kernel, a = floor(log2 w) times: the minimum key over a span of 2^(j+1)
//      positions from two of 2^j (a sparse table, ping-pong between two buffers).
//   3. scan_any_select_kernel: a window starting at s is the two overlapping spans [s, s + 2^a)
//      and [s + w - 2^a, s + w); when its minimum's hash is not 0xFFFFFFFF and s < length-k-w+2,
//      its winner's `selected` byte is set (selection by scatter; colliding writes store the same
//      1).  A winner's hash is not 0xFFFFFFFF, so its k-mer is valid.
//   4. (row-compact only) scan_any_compact_kernel: a warp a 128-position row ranks the selected
//      positions (a ballot-free count of its four bytes a lane and a warp scan) and writes the
//      first 64 (hash, col | strand << 7) pairs in order, 0xFFFFFFFF / -1 past the row's count.
// Windows only read k-mer starts inside [0, length-k+1), so no window of either scan reads past
// the stream, however wide: the row-compact scan's sentinel halo is read only by the k-mers.
//
// What bounds it.  A position moves its code in, 8-byte keys in and out of every span pass and
// its outputs: ~(24 + 24 a) bytes, and ~4 k + 20 integer operations, so the a span passes bound
// it for any w above a few.  It takes windows and k-mers wider than a block's run: w past ~8,400
// or k past RT_MAX_K.
// ---------------------------------------------------------------------------------------------

constexpr int ANY_THREADS = 256;

// The JAX package's uint32 packings of the k codes that start at index p of a row of n codes
// (an index past n wraps, as the rolls do): forward = OR c_j << 2(k-1-j), reverse = OR (3 - c_j)
// << 2j, each term whose shift is 32 or more dropped; `bad`: a code >= 4 among the k.
__device__ __forceinline__ void pack_any(const uint8_t* row, long long n, long long p, int k, uint32_t* fwd,
                                         uint32_t* rev, bool* bad) {
    uint32_t f = 0, r = 0;
    bool b = false;
    for (int j = 0; j < k; ++j) {
        long long idx = p + j;
        if (idx >= n) idx %= n;
        const uint32_t c = row[idx];
        b |= c >= 4u;
        const int sf = 2 * (k - 1 - j);
        if (sf < 32) f |= c << sf;
        if (j < 16) r |= (3u - c) << (2 * j);
    }
    *fwd = f;
    *rev = r;
    *bad = b;
}

// Stage 1: position g of each stream (buffer index pad + g of a row of n codes), g < length.
__global__ void __launch_bounds__(ANY_THREADS) scan_any_hash_kernel(
    const uint8_t* __restrict__ codes,      // (B, n)
    long long n, long long pad, long long length, int k,
    unsigned long long* __restrict__ keys,  // out (B, length): hash << 32 | g
    uint8_t* __restrict__ strands,          // out (B, length): 0 or 1
    long long* __restrict__ hashes,         // out (B, length), values in [0, 2^32); may be null
    uint8_t* __restrict__ selected) {       // out (B, length): cleared
    const long long g = (long long)blockIdx.x * ANY_THREADS + threadIdx.x;
    if (g >= length) return;
    const long long b = blockIdx.y;
    uint32_t fwd, rev;
    bool bad;
    pack_any(codes + b * n, n, pad + g, k, &fwd, &rev, &bad);
    const bool valid = !bad && g < length - k + 1;
    const uint32_t h = valid ? mix32(min(fwd, rev)) : UMAX;
    const long long o = b * length + g;
    keys[o] = ((unsigned long long)h << 32) | (unsigned long long)g;
    strands[o] = fwd <= rev ? 1 : 0;
    if (hashes) hashes[o] = (long long)h;
    selected[o] = 0;
}

// Stage 2: out[g] = min(in[g], in[g + step]), the second only inside the stream.
__global__ void __launch_bounds__(ANY_THREADS) scan_any_span_kernel(
    const unsigned long long* __restrict__ in, long long length, long long step,
    unsigned long long* __restrict__ out) {
    const long long g = (long long)blockIdx.x * ANY_THREADS + threadIdx.x;
    if (g >= length) return;
    const long long o = (long long)blockIdx.y * length + g;
    unsigned long long v = in[o];
    if (g + step < length) v = min(v, in[o + step]);
    out[o] = v;
}

// Stage 3: the window that starts at s (s < n_starts) takes the spans at s and s + tail.
__global__ void __launch_bounds__(ANY_THREADS) scan_any_select_kernel(
    const unsigned long long* __restrict__ span, long long length, long long n_starts, long long tail,
    uint8_t* __restrict__ selected) {
    const long long s = (long long)blockIdx.x * ANY_THREADS + threadIdx.x;
    if (s >= n_starts) return;
    const long long base = (long long)blockIdx.y * length;
    const unsigned long long m = min(span[base + s], span[base + s + tail]);
    if ((uint32_t)(m >> 32) != UMAX) selected[base + (long long)(m & 0xFFFFFFFFull)] = 1;
}

// Stage 4 of the row-compact scan: a warp a row of 128 positions, lane l its positions 4l .. 4l+3.
__global__ void __launch_bounds__(ANY_THREADS) scan_any_compact_kernel(
    const unsigned long long* __restrict__ keys, const uint8_t* __restrict__ strands,
    const uint8_t* __restrict__ selected, long long R,
    uint32_t* __restrict__ hashes,  // out (B, R, 64)
    int32_t* __restrict__ aux,      // out (B, R, 64)
    int32_t* __restrict__ counts) { // out (B, R)
    const long long row = (long long)blockIdx.x * (ANY_THREADS / 32) + (threadIdx.x >> 5);
    if (row >= R) return;  // the whole warp leaves together
    const int lane = threadIdx.x & 31;
    const long long r = (long long)blockIdx.y * R + row;  // the row in the batch
    const long long p0 = r * ROW + 4 * lane;              // this lane's first position in the (B, R * 128) arrays
    uint32_t mine = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) mine |= (selected[p0 + j] ? 1u : 0u) << j;
    const int n = __popc(mine);
    int incl = n;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
        const int other = __shfl_up_sync(0xFFFFFFFFu, incl, s);
        if (lane >= s) incl += other;
    }
    const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
    int rank = incl - n;
    uint32_t* h_row = hashes + r * SLOTS;
    int32_t* a_row = aux + r * SLOTS;
    while (mine && rank < SLOTS) {
        const int j = __ffs(mine) - 1;
        mine &= mine - 1;
        h_row[rank] = (uint32_t)(keys[p0 + j] >> 32);
        a_row[rank] = (4 * lane + j) | ((int)strands[p0 + j] << 7);
        ++rank;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        const int slot = 2 * lane + q;
        if (slot >= total) {
            h_row[slot] = UMAX;
            a_row[slot] = -1;
        }
    }
    if (lane == 0) counts[r] = total;
}

// Stages 2 and 3 over B streams of `length` k-mer starts; spans_a and spans_b are scratch of
// B * length keys each (spans_b unread for w < 4, both for w == 1).
cudaError_t scan_any_windows(const unsigned long long* keys, unsigned long long* spans_a,
                             unsigned long long* spans_b, int B, long long length, int k, long long w,
                             uint8_t* selected, cudaStream_t stream) {
    const long long n_starts = length - k - w + 2;
    if (n_starts <= 0) return cudaSuccess;  // no window fits: nothing is selected
    int a = 0;
    while ((2LL << a) <= w) ++a;  // 2^a <= w < 2^(a+1)
    const dim3 grid((unsigned)((length + ANY_THREADS - 1) / ANY_THREADS), (unsigned)B);
    const unsigned long long* span = keys;
    for (int j = 0; j < a; ++j) {
        unsigned long long* out = j % 2 == 0 ? spans_a : spans_b;
        scan_any_span_kernel<<<grid, ANY_THREADS, 0, stream>>>(span, length, 1LL << j, out);
        span = out;
    }
    const dim3 sgrid((unsigned)((n_starts + ANY_THREADS - 1) / ANY_THREADS), (unsigned)B);
    scan_any_select_kernel<<<sgrid, ANY_THREADS, 0, stream>>>(span, length, n_starts, w - (1LL << a), selected);
    return cudaGetLastError();
}

bool any_grid_ok(int B, long long length) {
    return B <= 65535 && (length + ANY_THREADS - 1) / ANY_THREADS <= 0x7FFFFFFFLL && length < (1LL << 32);
}

}  // namespace

extern "C" {

// The largest k and w of the tiled kernels; every other (k, w) takes a run-time form.
int kts_scan_tiled_max_k() { return MAX_K; }
int kts_scan_tiled_max_w() { return MAX_W; }

// The dynamic shared bytes of a run-time launch at (k, w); 0 when its run does not fit a block
// (the sparse-table form's inputs).
int kts_scan_any_smem(int k, long long w) {
    RtPlan p;
    return rt_plan(k, w, &p) ? p.smem : 0;
}

// The widest window the run-time form takes at k; 0 when it takes no window at k.
long long kts_scan_any_max_w(int k) {
    long long lo = 0, hi = 1 << 16;  // lo fits (or is 0), hi + 1 does not
    while (lo < hi) {
        const long long mid = (lo + hi + 1) / 2;
        if (kts_scan_any_smem(k, mid)) lo = mid;
        else hi = mid - 1;
    }
    return lo;
}

// One case a window width: both scans take w = 1 .. MAX_W as a template argument.
#define KTS_WIDTHS(X)                                                                                \
    X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16) X(17)    \
    X(18) X(19) X(20) X(21) X(22) X(23) X(24) X(25) X(26) X(27) X(28) X(29) X(30) X(31) X(32)

// Launches the scan on `stream`; returns the CUDA error of the launch (0 = ok).
int kts_rowcompact_scan(const void* codes, int B, int R, int halo_rows, int k, int w,
                        void* hashes, void* aux, void* counts, void* stream) {
    if (B <= 0 || R <= 0) return 0;
    if (k < 1 || k > MAX_K || w < 1 || w > MAX_W) return (int)cudaErrorInvalidValue;
#define KTS_SCAN(W)                                                                             \
    case W:                                                                                     \
        return (int)launch<W>(static_cast<const uint8_t*>(codes), B, R, halo_rows, k,           \
                              static_cast<uint32_t*>(hashes), static_cast<int32_t*>(aux),       \
                              static_cast<int32_t*>(counts), static_cast<cudaStream_t>(stream));
    switch (w) { KTS_WIDTHS(KTS_SCAN) }
#undef KTS_SCAN
    return (int)cudaErrorInvalidValue;
}

// The flat scan of a (B, L) code stream on `stream`; returns the CUDA error of the launch.
int kts_minimizer_scan(const void* codes, int B, long long L, int k, int w,
                       void* selected, void* hashes, void* strands, void* stream) {
    if (B <= 0 || L <= 0) return 0;
    if (k < 1 || k > MAX_K || w < 1 || w > MAX_W) return (int)cudaErrorInvalidValue;
    if ((L + TILE - 1) / TILE > 0x7FFFFFFFLL || B > 65535) return (int)cudaErrorInvalidValue;
    const bool aligned = L % WORD == 0 && aligned16(codes) && aligned16(selected) && aligned16(hashes)
                         && aligned16(strands);
#define KTS_FLAT(W)                                                                                  \
    case W:                                                                                          \
        return (int)launch_flat<W>(static_cast<const uint8_t*>(codes), B, L, k, aligned,             \
                                   static_cast<uint8_t*>(selected), static_cast<long long*>(hashes), \
                                   static_cast<uint8_t*>(strands), static_cast<cudaStream_t>(stream));
    switch (w) { KTS_WIDTHS(KTS_FLAT) }
#undef KTS_FLAT
    return (int)cudaErrorInvalidValue;
}

#undef KTS_WIDTHS

// The row-compact scan's run-time form (kts_scan_any_smem(k, w) > 0) on `stream`: one launch, no
// scratch.  Returns the CUDA error of the launch.
int kts_rowcompact_scan_any(const void* codes, int B, int R, int halo_rows, int k, long long w, void* hashes,
                            void* aux, void* counts, void* stream) {
    if (B <= 0 || R <= 0) return 0;
    if (halo_rows < 0) return (int)cudaErrorInvalidValue;
    RtArgs a{};
    a.codes = static_cast<const uint8_t*>(codes);
    a.n = (long long)(R + 2LL * halo_rows) * ROW;
    a.pad = (long long)halo_rows * ROW;
    a.length = (long long)R * ROW;
    a.hashes32 = static_cast<uint32_t*>(hashes);
    a.aux = static_cast<int32_t*>(aux);
    a.counts = static_cast<int32_t*>(counts);
    return (int)launch_rt<false>(a, B, k, w, static_cast<cudaStream_t>(stream));
}

// The flat scan's run-time form (kts_scan_any_smem(k, w) > 0) of a (B, L) code stream on `stream`:
// one launch, no scratch.  Returns the CUDA error of the launch.
int kts_minimizer_scan_any(const void* codes, int B, long long L, int k, long long w, void* selected,
                           void* hashes, void* strands, void* stream) {
    if (B <= 0 || L <= 0) return 0;
    RtArgs a{};
    a.codes = static_cast<const uint8_t*>(codes);
    a.n = L;
    a.length = L;
    a.aligned = L % WORD == 0 && aligned16(codes) && aligned16(selected) && aligned16(hashes) && aligned16(strands);
    a.selected = static_cast<uint8_t*>(selected);
    a.hashes64 = static_cast<long long*>(hashes);
    a.strands = static_cast<uint8_t*>(strands);
    return (int)launch_rt<true>(a, B, k, w, static_cast<cudaStream_t>(stream));
}

// The row-compact scan's sparse-table form (any k >= 1, w >= 1) on `stream`, with the caller's
// scratch: keys, spans_a and spans_b (B * R * 128 eight-byte words each), strands and selected
// (B * R * 128 bytes each).  Returns the first CUDA error of its launches.
int kts_rowcompact_scan_sparse(const void* codes, int B, int R, int halo_rows, int k, long long w, void* hashes,
                               void* aux, void* counts, void* keys, void* spans_a, void* spans_b, void* strands,
                               void* selected, void* stream) {
    if (B <= 0 || R <= 0) return 0;
    const long long length = (long long)R * ROW;
    if (k < 1 || w < 1 || halo_rows < 0 || !any_grid_ok(B, length)) return (int)cudaErrorInvalidValue;
    const auto st = static_cast<cudaStream_t>(stream);
    auto* key = static_cast<unsigned long long*>(keys);
    auto* str = static_cast<uint8_t*>(strands);
    auto* sel = static_cast<uint8_t*>(selected);
    const dim3 grid((unsigned)((length + ANY_THREADS - 1) / ANY_THREADS), (unsigned)B);
    scan_any_hash_kernel<<<grid, ANY_THREADS, 0, st>>>(static_cast<const uint8_t*>(codes),
                                                       length + 2LL * halo_rows * ROW, (long long)halo_rows * ROW,
                                                       length, k, key, str, nullptr, sel);
    cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess)
        err = scan_any_windows(key, static_cast<unsigned long long*>(spans_a),
                               static_cast<unsigned long long*>(spans_b), B, length, k, w, sel, st);
    if (err != cudaSuccess) return (int)err;
    const dim3 cgrid((unsigned)((R + ANY_THREADS / 32 - 1) / (ANY_THREADS / 32)), (unsigned)B);
    scan_any_compact_kernel<<<cgrid, ANY_THREADS, 0, st>>>(key, str, sel, R, static_cast<uint32_t*>(hashes),
                                                          static_cast<int32_t*>(aux), static_cast<int32_t*>(counts));
    return (int)cudaGetLastError();
}

// The flat scan's sparse-table form (any k >= 1, w >= 1) of a (B, L) code stream on `stream`, with
// the caller's scratch: keys, spans_a and spans_b (B * L eight-byte words each).
int kts_minimizer_scan_sparse(const void* codes, int B, long long L, int k, long long w, void* selected,
                              void* hashes, void* strands, void* keys, void* spans_a, void* spans_b, void* stream) {
    if (B <= 0 || L <= 0) return 0;
    if (k < 1 || w < 1 || !any_grid_ok(B, L)) return (int)cudaErrorInvalidValue;
    const auto st = static_cast<cudaStream_t>(stream);
    auto* key = static_cast<unsigned long long*>(keys);
    auto* sel = static_cast<uint8_t*>(selected);
    const dim3 grid((unsigned)((L + ANY_THREADS - 1) / ANY_THREADS), (unsigned)B);
    scan_any_hash_kernel<<<grid, ANY_THREADS, 0, st>>>(static_cast<const uint8_t*>(codes), L, 0, L, k, key,
                                                       static_cast<uint8_t*>(strands),
                                                       static_cast<long long*>(hashes), sel);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)scan_any_windows(key, static_cast<unsigned long long*>(spans_a),
                                 static_cast<unsigned long long*>(spans_b), B, L, k, w, sel, st);
}

}  // extern "C"
