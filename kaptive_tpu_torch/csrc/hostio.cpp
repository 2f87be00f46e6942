// Native host-side I/O kernels of the PyTorch/CUDA port of kaptive-tpu.
//
// Takes the data-loader role of upstream Kaptive's Rust rammappy FASTA parser
// (kaptive/core/genome.py:44-46) for the streaming input pipeline: FASTA
// parsing, 2-bit DNA encoding and host seeding at memory bandwidth, so
// CPU-side ingest does not starve the card.  Built by
// kaptive_tpu_torch/native/hostio.py with g++ at first use.
//
// C ABI (ctypes-friendly), two-pass usage:
//   1. fasta_scan(data, n, &n_records, &total_seq_len)
//   2. caller allocates output buffers
//   3. fasta_parse(data, n, seq_out, name_out, name_cap,
//                  seq_offsets, seq_lengths, name_offsets, name_lengths)
//
// encode_dna_2bit(data, n, out): byte -> {A,a:0 C,c:1 G,g:2 T,t/U,u:3 else 4}.
//
// Beside the input pipeline it holds decide's greedy overlap cull
// (cull_overlaps), a per-hit loop too slow in Python.

#include <cstdint>
#include <cstddef>
#include <cstring>
#include <vector>

// The seeding kernel carries AVX-512 fast paths (16 minimizer lanes per
// iteration); every vector loop has a scalar twin and the build works on any
// target, so the guard is purely a compile-time feature test.
#if defined(__AVX512F__) && defined(__AVX512BW__)
#include <immintrin.h>
#define KT_AVX512 1
#endif

extern "C" {

// Line framing via memchr (SIMD in libc): returns the line's exclusive end.
static inline size_t line_end_of(const uint8_t* data, size_t n, size_t i) {
    const uint8_t* nl = (const uint8_t*)memchr(data + i, '\n', n - i);
    return nl ? (size_t)(nl - data) : n;
}

// Whitespace a sequence line may carry (stripped): \r, space, tab.
static inline bool line_has_ws(const uint8_t* q, size_t len) {
    return memchr(q, '\r', len) || memchr(q, ' ', len) || memchr(q, '\t', len);
}

// Pass 1: count records and total sequence bytes (newlines/whitespace
// stripped).  memchr-framed lines: clean sequence lines (the overwhelming
// case) cost three SIMD scans and one length add instead of a byte loop.
void fasta_scan(const uint8_t* data, size_t n, int64_t* n_records, int64_t* total_seq_len) {
    int64_t records = 0;
    int64_t seq_len = 0;
    size_t i = 0;
    while (i < n) {
        const size_t end = line_end_of(data, n, i);
        if (data[i] == '>') {
            records++;
        } else {
            size_t len = end - i;
            if (line_has_ws(data + i, len)) {
                for (size_t j = i; j < end; j++) {
                    uint8_t c = data[j];
                    len -= (c == '\r' || c == ' ' || c == '\t');
                }
            }
            seq_len += (int64_t)len;
        }
        i = end + 1;
    }
    *n_records = records;
    *total_seq_len = seq_len;
}

// Pass 2: fill packed sequence/name buffers and per-record offsets/lengths.
// Names are truncated at the first whitespace (standard FASTA id convention).
// Clean sequence lines memcpy wholesale.  Returns 0 on success, -1 if name
// buffer capacity is exceeded.
int fasta_parse(const uint8_t* data, size_t n,
                uint8_t* seq_out, uint8_t* name_out, int64_t name_cap,
                int64_t* seq_offsets, int64_t* seq_lengths,
                int64_t* name_offsets, int64_t* name_lengths) {
    int64_t rec = -1;
    int64_t seq_pos = 0;
    int64_t name_pos = 0;
    size_t i = 0;
    while (i < n) {
        const size_t end = line_end_of(data, n, i);
        if (data[i] == '>') {
            if (rec >= 0) seq_lengths[rec] = seq_pos - seq_offsets[rec];
            rec++;
            name_offsets[rec] = name_pos;
            size_t j = i + 1;
            while (j < end && data[j] != ' ' && data[j] != '\t' && data[j] != '\r') j++;
            const int64_t nlen = (int64_t)(j - (i + 1));
            if (name_pos + nlen > name_cap) return -1;
            memcpy(name_out + name_pos, data + i + 1, (size_t)nlen);
            name_pos += nlen;
            name_lengths[rec] = nlen;
            seq_offsets[rec] = seq_pos;
        } else {
            const size_t len = end - i;
            if (!line_has_ws(data + i, len)) {
                memcpy(seq_out + seq_pos, data + i, len);
                seq_pos += (int64_t)len;
            } else {
                for (size_t j = i; j < end; j++) {
                    uint8_t c = data[j];
                    if (c != '\r' && c != ' ' && c != '\t') seq_out[seq_pos++] = c;
                }
            }
        }
        i = end + 1;
    }
    if (rec >= 0) seq_lengths[rec] = seq_pos - seq_offsets[rec];
    return 0;
}

// Byte -> 2-bit code LUT encode (A0 C1 G2 T/U3, else 4).
static const uint8_t* dna_lut() {
    static uint8_t lut[256];
    static bool init = false;
    if (!init) {
        memset(lut, 4, sizeof(lut));
        lut['A'] = lut['a'] = 0;
        lut['C'] = lut['c'] = 1;
        lut['G'] = lut['g'] = 2;
        lut['T'] = lut['t'] = 3;
        lut['U'] = lut['u'] = 3;
        init = true;
    }
    return lut;
}

void encode_dna_2bit(const uint8_t* data, size_t n, uint8_t* out) {
    const uint8_t* lut = dna_lut();
    for (size_t i = 0; i < n; i++) out[i] = lut[data[i]];
}

// Fused contig-stream build: encode contig bytes, concatenate with `gap`
// sentinel codes between contigs into a pre-sized flat buffer (caller pads
// the allocation with sentinels), 2-bit-pack the real prefix 4 codes/byte
// (sentinels pack as 0), and record invalid-base positions (the sparse
// device upload's exception list).  One pass per output instead of four
// numpy passes on the ingest threads.
//
//   flat_out:   [alloc] uint8, PRE-FILLED with 4 by the caller
//   packed_out: [packed_len] uint8 with packed_len = (real_len + 3) / 4,
//               real_len = sum(lengths) + gap * (n_seqs - 1)
//   exc_out:    [exc_cap] int32 exception positions
// Returns the exception count (may exceed exc_cap: only the first exc_cap
// are written; callers treat overflow as "use the dense form").
int64_t build_contig_stream(const uint8_t* seq, const int64_t* offsets,
                            const int64_t* lengths, int64_t n_seqs, int64_t gap,
                            uint8_t* flat_out, uint8_t* packed_out,
                            int32_t* exc_out, int64_t exc_cap) {
    const uint8_t* lut = dna_lut();
#if defined(KT_AVX512) && defined(__AVX512VBMI__)
    // 64-entry vpermb LUT over (byte & 63): the valid alphabet lives in the
    // ASCII letter range (byte & 0xC0) == 0x40, where & 63 separates upper
    // from lower case; every other slot decodes to 0xFF (= exception).
    // A function-local static with an initializer: C++11 makes its first
    // initialization thread-safe, and ingest threads call this concurrently.
    struct alignas(64) Lut64 {
        uint8_t v[64];
        Lut64() {
            memset(v, 0xFF, sizeof(v));
            v['A' & 63] = 0; v['a' & 63] = 0;
            v['C' & 63] = 1; v['c' & 63] = 1;
            v['G' & 63] = 2; v['g' & 63] = 2;
            v['T' & 63] = 3; v['t' & 63] = 3;
            v['U' & 63] = 3; v['u' & 63] = 3;
        }
    };
    static const Lut64 lut64_table;
    const uint8_t* lut64 = lut64_table.v;
    const __m512i vlut = _mm512_load_si512(lut64);
    const __m512i vC0 = _mm512_set1_epi8((char)0xC0);
    const __m512i v40 = _mm512_set1_epi8(0x40);
    const __m512i vFF = _mm512_set1_epi8((char)0xFF);
    const __m512i wm1 = _mm512_set1_epi16(0x0401);
    const __m512i wm2 = _mm512_set1_epi32(0x00100001);
#endif
    int64_t pos = 0;
    int64_t n_exc = 0;
    uint8_t acc = 0;
    for (int64_t s = 0; s < n_seqs; s++) {
        const uint8_t* src = seq + offsets[s];
        const int64_t len = lengths[s];
        for (int64_t i = 0; i < len; ) {
#if defined(KT_AVX512) && defined(__AVX512VBMI__)
            // Vector fast path: 64 valid bases -> 64 flat codes + 16 packed
            // bytes per iteration.  Requires a packed-byte-aligned position;
            // any block containing a non-ACGTU byte falls through to the
            // scalar exception-recording loop for up to 64 bytes, then
            // vector mode resumes.
            if ((pos & 3) == 0 && i + 64 <= len) {
                const __m512i raw = _mm512_loadu_si512(src + i);
                const __m512i code = _mm512_permutexvar_epi8(raw, vlut);
                const __mmask64 ok =
                    _mm512_cmpeq_epi8_mask(_mm512_and_si512(raw, vC0), v40) &
                    _mm512_cmpneq_epi8_mask(code, vFF);
                if (ok == ~(__mmask64)0) {
                    _mm512_storeu_si512(flat_out + pos, code);
                    const __m512i pair = _mm512_maddubs_epi16(code, wm1);
                    const __m512i quad = _mm512_madd_epi16(pair, wm2);
                    _mm_storeu_si128((__m128i*)(packed_out + (pos >> 2)),
                                     _mm512_cvtepi32_epi8(quad));
                    pos += 64;
                    i += 64;
                    continue;
                }
            }
#endif
            uint8_t code = lut[src[i]];
            flat_out[pos] = code;
            if (code >= 4) {
                if (n_exc < exc_cap) exc_out[n_exc] = (int32_t)pos;
                n_exc++;
                code = 0;  // sentinels pack as 0
            }
            acc |= (uint8_t)(code << ((pos & 3) * 2));
            if ((pos & 3) == 3) { packed_out[pos >> 2] = acc; acc = 0; }
            pos++;
            i++;
        }
        if (s + 1 < n_seqs) {  // inter-contig sentinel gap (k-1 codes)
            for (int64_t g = 0; g < gap; g++) {
                if (n_exc < exc_cap) exc_out[n_exc] = (int32_t)pos;
                n_exc++;
                // flat_out already sentinel-filled; sentinel packs as 0
                if ((pos & 3) == 3) { packed_out[pos >> 2] = acc; acc = 0; }
                pos++;
            }
        }
    }
    if (pos & 3) packed_out[pos >> 2] = acc;
    return n_exc;
}

// Host seeding kernel: minimizer scan + sorted-table match in one C pass.
//
// Mirrors kaptive_tpu_torch/ops/minimizer.py::minimizer_scan_host exactly (rolling
// 2-bit packed canonical k-mers, murmur3 32-bit finalizer, w-window minimum
// with leftmost-on-tie, invalid-base masking) and then expands each selected
// minimizer against the sorted gene-table hash array (lower/upper bound,
// occurrence count capped at max_occ) — the host half of the mapper's
// seed stage, so ingest threads can hand the device pre-seeded chains and the
// card spends its cycles on the DP sweeps instead of the gather-bound match.
//
//   codes:  [L] uint8 base codes (0-3 valid, >=4 sentinel), contig stream
//   table:  [T] uint32 sorted ascending canonical-minimizer hashes
//   out_ti / out_cpos / out_cstrand: [cap_out] anchor rows
//     (table row index, flat contig-stream position, contig strand bit)
//   out_counts: [2] -> {n_minimizers, n_candidates}
// Returns the total anchor count, which may exceed cap_out (only the first
// cap_out rows are written; callers treat overflow as "redo with a larger
// buffer" — the count is exact either way).
//   bloom: optional [1 << (bloom_bits - 5)] uint32 membership bitmap over the
//     table hashes (bit hash & (2^bloom_bits - 1)); NULL disables the gate.
//     One in-memory bit test replaces two binary searches for the ~99.5% of
//     genome minimizers that miss the gene table.
int64_t seed_anchors(const uint8_t* codes, int64_t L, int32_t k, int32_t w,
                     const uint32_t* table, int64_t T,
                     const uint32_t* bloom, int32_t bloom_bits,
                     const int32_t* buckets, int32_t bucket_shift,
                     int32_t max_occ, int64_t cap_out,
                     int32_t* out_ti, int32_t* out_cpos, uint8_t* out_cstrand,
                     int64_t* out_counts) {
    out_counts[0] = 0;
    out_counts[1] = 0;
    const int64_t nk = L - (int64_t)k + 1;   // k-mer start positions
    const int64_t nw = nk - (int64_t)w + 1;  // window start positions
    if (nk <= 0 || nw <= 0 || k > 16 || w < 1) return 0;

    const uint32_t MAXU = 0xFFFFFFFFu;
    const uint64_t MAXK = ~(uint64_t)0;
    const uint32_t mask = (k < 16) ? ((1u << (2 * k)) - 1) : MAXU;

    // Pipeline per 32K-window chunk, every stage branch-free over dense data:
    //   pack:  codes -> local 2-bit buffer (vector maddubs path; invalid
    //          positions recorded sparsely and zero-packed)
    //   fill:  per-position canonical-k-mer keys by EXTRACTION from the
    //          packed buffer (one u64 covers 16 consecutive k-mers for
    //          k <= 16: 16 + 15 bases = 62 bits), so lanes are independent —
    //          unlike a rolling-register scan, which serializes the loop.
    //          fwd = 2-bit-field reversal of the extracted word, rev = its
    //          field-wise complement (e ^ mask): same hashes as the rolling
    //          formulation, zero loop-carried state.
    //   vh:    van Herk / Gil-Werman prefix+suffix mins over w-blocks of
    //          (hash << 32 | position) keys; the u64 min breaks hash ties on
    //          the leftmost position for free.
    //   emit:  window minima -> distinct+valid byte mask -> u64-at-a-time
    //          bit scan (window argmins are non-decreasing, so "new emit"
    //          == "differs from previous window").  Each emitted minimizer
    //          PREFETCHES its bloom word; by the time the match loop runs,
    //          the random 16 MB-bitmap reads (the former hot spot: ~1M
    //          cache misses/genome) have already landed in L2.
    //   match: bloom-gated sorted-table lookup, unchanged semantics.
    const int64_t CHUNK = 1 << 15;  // window starts per block
    const int64_t BUF = CHUNK + (int64_t)w + 8;
    uint64_t* key = new uint64_t[BUF];
    uint64_t* pre = new uint64_t[BUF];   // running min from w-block start
    uint64_t* suf = new uint64_t[BUF];   // running min to w-block end
    uint8_t* strd = new uint8_t[BUF];
    uint64_t* mwin = new uint64_t[CHUNK + 8];    // per-window minima
    uint8_t* dmask = new uint8_t[CHUNK + 8];     // distinct+valid emit mask
    uint64_t* emitbuf = new uint64_t[CHUNK];     // distinct minimizer keys
    const int64_t PBYTES = (CHUNK + w + k + 64) / 4 + 24;
    uint8_t* lp = new uint8_t[PBYTES];           // chunk-local packed codes
    int64_t* badbuf = new int64_t[CHUNK + w + k + 64];  // invalid positions

    const int rsh = 32 - 2 * k;
    int64_t n_min = 0, n_cand = 0, n_anch = 0;
    uint64_t carry_m = MAXK;  // previous chunk's last window minimum

    for (int64_t wstart = 0; wstart < nw; wstart += CHUNK) {
        const int64_t n_win = (nw - wstart < CHUNK) ? (nw - wstart) : CHUNK;
        const int64_t need = n_win + w - 1;  // k-mer starts [wstart, wstart+need)
        const int64_t base0 = wstart;
        const int64_t nbases = need + k - 1;  // <= L - base0 by construction

        // --- pack codes[base0 .. base0+nbases) to 2-bit, 4 codes/byte ---
        int64_t nbad = 0;
        {
            const int64_t nb = (nbases + 3) / 4;
            int64_t j = 0;
#ifdef KT_AVX512
            // 64 codes -> 16 packed bytes: u8 pair-combine (c0 + 4*c1),
            // i16 pair-combine (p0 + 16*p1), narrow i32 -> i8.  A block
            // containing any invalid code (rare: contig gaps, ambiguity
            // codes) drops to one scalar block, then vector mode resumes.
            const __m512i wm1 = _mm512_set1_epi16(0x0401);
            const __m512i wm2 = _mm512_set1_epi32(0x00100001);
            const __m512i inv = _mm512_set1_epi8(4);
            while (j + 16 <= nb && 4 * j + 64 <= nbases) {
                const int64_t p = base0 + 4 * j;
                const __m512i c = _mm512_loadu_si512(codes + p);
                if (_mm512_cmpge_epu8_mask(c, inv)) {
                    for (int64_t je = j + 16; j < je; j++) {
                        const int64_t q = base0 + 4 * j;
                        uint8_t c0 = codes[q], c1 = codes[q + 1];
                        uint8_t c2 = codes[q + 2], c3 = codes[q + 3];
                        if ((c0 | c1 | c2 | c3) >= 4) {
                            if (c0 >= 4) { badbuf[nbad++] = q;     c0 = 0; }
                            if (c1 >= 4) { badbuf[nbad++] = q + 1; c1 = 0; }
                            if (c2 >= 4) { badbuf[nbad++] = q + 2; c2 = 0; }
                            if (c3 >= 4) { badbuf[nbad++] = q + 3; c3 = 0; }
                        }
                        lp[j] = (uint8_t)(c0 | (c1 << 2) | (c2 << 4) | (c3 << 6));
                    }
                    continue;
                }
                const __m512i pair = _mm512_maddubs_epi16(c, wm1);
                const __m512i quad = _mm512_madd_epi16(pair, wm2);
                _mm_storeu_si128((__m128i*)(lp + j), _mm512_cvtepi32_epi8(quad));
                j += 16;
            }
#endif
            for (; j < nb; j++) {
                const int64_t p = base0 + 4 * j;
                uint8_t c0 = (4 * j     < nbases) ? codes[p]     : 0;
                uint8_t c1 = (4 * j + 1 < nbases) ? codes[p + 1] : 0;
                uint8_t c2 = (4 * j + 2 < nbases) ? codes[p + 2] : 0;
                uint8_t c3 = (4 * j + 3 < nbases) ? codes[p + 3] : 0;
                if ((c0 | c1 | c2 | c3) >= 4) {
                    if (c0 >= 4) { badbuf[nbad++] = p;     c0 = 0; }
                    if (c1 >= 4) { badbuf[nbad++] = p + 1; c1 = 0; }
                    if (c2 >= 4) { badbuf[nbad++] = p + 2; c2 = 0; }
                    if (c3 >= 4) { badbuf[nbad++] = p + 3; c3 = 0; }
                }
                lp[j] = (uint8_t)(c0 | (c1 << 2) | (c2 << 4) | (c3 << 6));
            }
            for (int64_t jj = nb; jj < nb + 16; jj++) lp[jj] = 0;
        }

        // --- fill: independent per-position keys from the packed buffer ---
        int64_t b = 0;
#ifdef KT_AVX512
        {
            const __m512i sh_lo = _mm512_set_epi64(14, 12, 10, 8, 6, 4, 2, 0);
            const __m512i sh_hi = _mm512_set_epi64(30, 28, 26, 24, 22, 20, 18, 16);
            const __m512i vmask = _mm512_set1_epi32((int)mask);
            const __m512i c3333 = _mm512_set1_epi32(0x33333333);
            const __m512i c0f0f = _mm512_set1_epi32(0x0F0F0F0F);
            const __m512i bswap_ctl = _mm512_broadcast_i32x4(
                _mm_set_epi8(12, 13, 14, 15, 8, 9, 10, 11, 4, 5, 6, 7, 0, 1, 2, 3));
            const __m512i mur1 = _mm512_set1_epi32((int)0x85EBCA6Bu);
            const __m512i mur2 = _mm512_set1_epi32((int)0xC2B2AE35u);
            const __m512i iota8 = _mm512_set_epi64(7, 6, 5, 4, 3, 2, 1, 0);
            for (; b + 16 <= need; b += 16) {
                uint64_t wrd;
                memcpy(&wrd, lp + (b >> 2), 8);
                const __m512i w8 = _mm512_set1_epi64((long long)wrd);
                const __m256i e_lo = _mm512_cvtepi64_epi32(_mm512_srlv_epi64(w8, sh_lo));
                const __m256i e_hi = _mm512_cvtepi64_epi32(_mm512_srlv_epi64(w8, sh_hi));
                __m512i e = _mm512_inserti64x4(_mm512_castsi256_si512(e_lo), e_hi, 1);
                e = _mm512_and_si512(e, vmask);
                // reverse the 2-bit fields: pairs, nibbles, then bswap32
                __m512i x = _mm512_or_si512(
                    _mm512_slli_epi32(_mm512_and_si512(e, c3333), 2),
                    _mm512_and_si512(_mm512_srli_epi32(e, 2), c3333));
                x = _mm512_or_si512(
                    _mm512_slli_epi32(_mm512_and_si512(x, c0f0f), 4),
                    _mm512_and_si512(_mm512_srli_epi32(x, 4), c0f0f));
                x = _mm512_shuffle_epi8(x, bswap_ctl);
                const __m512i fwd = _mm512_srli_epi32(x, rsh);
                const __m512i rev = _mm512_xor_si512(e, vmask);
                __m512i h = _mm512_min_epu32(fwd, rev);
                const __mmask16 le = _mm512_cmple_epu32_mask(fwd, rev);
                _mm_storeu_si128((__m128i*)(strd + b),
                    _mm512_cvtepi32_epi8(_mm512_maskz_set1_epi32(le, 1)));
                h = _mm512_xor_si512(h, _mm512_srli_epi32(h, 16));
                h = _mm512_mullo_epi32(h, mur1);
                h = _mm512_xor_si512(h, _mm512_srli_epi32(h, 13));
                h = _mm512_mullo_epi32(h, mur2);
                h = _mm512_xor_si512(h, _mm512_srli_epi32(h, 16));
                // key = (u64)hash << 32 | (u32)position: the position is cut to
                // 32 bits as in the scalar path, so it never reaches the hash field
                const __m512i lo32 = _mm512_set1_epi64(0xFFFFFFFFLL);
                const __m512i pos_lo = _mm512_and_si512(
                    _mm512_add_epi64(_mm512_set1_epi64(base0 + b), iota8), lo32);
                const __m512i pos_hi = _mm512_and_si512(
                    _mm512_add_epi64(_mm512_set1_epi64(base0 + b + 8), iota8), lo32);
                const __m512i h_lo = _mm512_slli_epi64(
                    _mm512_cvtepu32_epi64(_mm512_castsi512_si256(h)), 32);
                const __m512i h_hi = _mm512_slli_epi64(
                    _mm512_cvtepu32_epi64(_mm512_extracti64x4_epi64(h, 1)), 32);
                _mm512_storeu_si512(key + b, _mm512_or_si512(h_lo, pos_lo));
                _mm512_storeu_si512(key + b + 8, _mm512_or_si512(h_hi, pos_hi));
            }
        }
#endif
        for (; b < need; b++) {
            uint64_t wrd;
            memcpy(&wrd, lp + (b >> 2), 8);
            uint32_t e = (uint32_t)(wrd >> ((b & 3) * 2)) & mask;
            uint32_t x = e;
            x = ((x & 0x33333333u) << 2) | ((x >> 2) & 0x33333333u);
            x = ((x & 0x0F0F0F0Fu) << 4) | ((x >> 4) & 0x0F0F0F0Fu);
            x = __builtin_bswap32(x);
            const uint32_t fwd = x >> rsh;
            const uint32_t rev = e ^ mask;
            uint32_t h = fwd < rev ? fwd : rev;
            strd[b] = (uint8_t)(fwd <= rev);
            h ^= h >> 16; h *= 0x85EBCA6Bu;
            h ^= h >> 13; h *= 0xC2B2AE35u;
            h ^= h >> 16;
            key[b] = ((uint64_t)h << 32) | (uint64_t)(uint32_t)(base0 + b);
        }
        // Invalidate every k-mer overlapping an invalid base (sparse).
        for (int64_t bi = 0; bi < nbad; bi++) {
            const int64_t bad = badbuf[bi];
            int64_t lo = bad - k + 1 - base0; if (lo < 0) lo = 0;
            int64_t hi = bad + 1 - base0; if (hi > need) hi = need;
            for (int64_t bb = lo; bb < hi; bb++) key[bb] = MAXK;
        }

        // --- van Herk prefix/suffix mins over w-aligned blocks ---
        for (int64_t b0 = 0; b0 < need; b0 += w) {
            const int64_t b1 = (b0 + w < need) ? b0 + w : need;
            uint64_t m = key[b0];
            pre[b0] = m;
            for (int64_t j = b0 + 1; j < b1; j++) {
                const uint64_t v = key[j];
                m = v < m ? v : m;
                pre[j] = m;
            }
            m = key[b1 - 1];
            suf[b1 - 1] = m;
            for (int64_t j = b1 - 2; j >= b0; j--) {
                const uint64_t v = key[j];
                m = v < m ? v : m;
                suf[j] = m;
            }
        }

        // --- emit: window minima, distinct+valid mask, sparse bit scan ---
        for (int64_t i = 0; i < n_win; i++) {
            const uint64_t a = suf[i];
            const uint64_t bb = pre[i + w - 1];
            mwin[i] = bb < a ? bb : a;
        }
        // Argmins are non-decreasing, so a window emits iff its minimum
        // differs from the previous window's (equal keys <=> equal argmin
        // position; an all-invalid window is MAXK and never valid).
        dmask[0] = (uint8_t)((mwin[0] != carry_m) & ((mwin[0] >> 32) != (uint64_t)MAXU));
        for (int64_t i = 1; i < n_win; i++) {
            dmask[i] = (uint8_t)((mwin[i] != mwin[i - 1]) & ((mwin[i] >> 32) != (uint64_t)MAXU));
        }
        carry_m = mwin[n_win - 1];
        int64_t ne = 0;
        const uint32_t bmask = (1u << bloom_bits) - 1;
        {
            const int64_t n8 = n_win / 8;
            for (int64_t g = 0; g < n8; g++) {
                uint64_t wv;
                memcpy(&wv, dmask + 8 * g, 8);
                while (wv) {  // each set byte is one distinct minimizer
                    const int j = __builtin_ctzll(wv) >> 3;
                    wv &= wv - (((uint64_t)1) << (j * 8));
                    const uint64_t m = mwin[8 * g + j];
                    emitbuf[ne++] = m;
                    const uint32_t bh = (uint32_t)(m >> 32);
                    if (bloom) __builtin_prefetch(&bloom[(bh & bmask) >> 5], 0, 1);
                    if (buckets) __builtin_prefetch(&buckets[bh >> bucket_shift], 0, 1);
                }
            }
            for (int64_t i = 8 * n8; i < n_win; i++) {
                if (dmask[i]) {
                    const uint64_t m = mwin[i];
                    emitbuf[ne++] = m;
                    const uint32_t bh = (uint32_t)(m >> 32);
                    if (bloom) __builtin_prefetch(&bloom[(bh & bmask) >> 5], 0, 1);
                    if (buckets) __builtin_prefetch(&buckets[bh >> bucket_shift], 0, 1);
                }
            }
        }
        n_min += ne;

        // --- match: bloom gate (words prefetched above) + table lookup ---
        for (int64_t j = 0; j < ne; j++) {
            const uint64_t m = emitbuf[j];
            const uint32_t bh = (uint32_t)(m >> 32);
            if (bloom) {  // membership gate: one bit test per minimizer
                const uint32_t bit = bh & bmask;
                if (!((bloom[bit >> 5] >> (bit & 31)) & 1)) continue;
            }
            // Sorted-table lookup: [lo, hi) = run of this hash.  With the
            // optional hash-prefix bucket index (same structure as the
            // device's bucketed_first_ge) the search spans one bucket's
            // occupancy (~log2(max bucket) steps) instead of the full table.
            int64_t lo = 0, hi = T;
            if (buckets) {
                const uint32_t bi = bh >> bucket_shift;
                lo = buckets[bi];
                hi = buckets[bi + 1];
            }
            const int64_t span_hi = hi;
            while (lo < hi) {
                const int64_t mid = (lo + hi) >> 1;
                if (table[mid] < bh) lo = mid + 1; else hi = mid;
            }
            if (lo >= span_hi || table[lo] != bh) continue;
            int64_t hi2 = lo, top = span_hi;
            while (hi2 < top) {  // upper bound
                const int64_t mid = (hi2 + top) >> 1;
                if (table[mid] <= bh) hi2 = mid + 1; else top = mid;
            }
            n_cand++;
            int64_t cnt = hi2 - lo;
            if (cnt > max_occ) cnt = max_occ;
            const int64_t best = (int64_t)(uint32_t)m;
            const uint8_t bstrand = strd[best - wstart];
            for (int64_t q = 0; q < cnt; q++) {
                if (n_anch < cap_out) {
                    out_ti[n_anch] = (int32_t)(lo + q);
                    out_cpos[n_anch] = (int32_t)best;
                    out_cstrand[n_anch] = bstrand;
                }
                n_anch++;
            }
        }
    }
    delete[] key;
    delete[] pre;
    delete[] suf;
    delete[] strd;
    delete[] mwin;
    delete[] dmask;
    delete[] emitbuf;
    delete[] lp;
    delete[] badbuf;
    out_counts[0] = n_min;
    out_counts[1] = n_cand;
    return n_anch;
}

// Greedy overlap cull (core/interval.py::Intervals.cull_overlaps): items are
// visited in order[]; an item of positive length is kept unless it overlaps a
// kept item of the same group key by more than frac of the shorter one
// (overlap > 0 and overlap > frac * min_len, in double as numpy does).  Only
// kept items block others, and an item is compared with its own group's kept
// items alone.  A first pass gives each visit its group's dense id (an
// open-addressed table over the keys) and each group a slice of one buffer,
// as long as its visits; the second keeps each group's kept (start, end)
// pairs packed in its slice.  gkey may be null (one group).
void cull_overlaps(const int64_t* starts, const int64_t* ends, const int64_t* gkey,
                   int64_t n, const int64_t* order, int64_t n_order, double frac,
                   uint8_t* kept) {
    memset(kept, 0, (size_t)n);
    int64_t cap = 16;
    while (cap < 2 * n_order) cap <<= 1;
    const uint64_t mask = (uint64_t)cap - 1;
    std::vector<int64_t> slot_key(cap), slot_id(cap, -1), dense(n_order), base(1, 0);
    for (int64_t o = 0; o < n_order; o++) {
        const int64_t g = gkey ? gkey[order[o]] : 0;
        uint64_t h = (uint64_t)g * 0x9E3779B97F4A7C15ull;  // Fibonacci hash, linear probe
        h ^= h >> 29;
        while (slot_id[h & mask] >= 0 && slot_key[h & mask] != g) h++;
        int64_t& id = slot_id[h & mask];
        if (id < 0) {
            id = (int64_t)base.size() - 1;
            slot_key[h & mask] = g;
            base.push_back(0);
        }
        dense[o] = id;
        base[id + 1]++;
    }
    for (size_t d = 1; d < base.size(); d++) base[d] += base[d - 1];
    std::vector<int64_t> n_in(base.size(), 0), ks(2 * n_order);
    for (int64_t o = 0; o < n_order; o++) {
        const int64_t i = order[o];
        const int64_t s = starts[i], e = ends[i], len = e - s;
        if (len <= 0) continue;
        const int64_t d = dense[o];
        int64_t* slice = ks.data() + 2 * base[d];
        bool blocked = false;
        for (int64_t r = 0; r < n_in[d]; r++) {
            const int64_t ks_r = slice[2 * r], ke_r = slice[2 * r + 1];
            const int64_t overlap = (e < ke_r ? e : ke_r) - (s > ks_r ? s : ks_r);
            const int64_t klen = ke_r - ks_r;
            const int64_t min_len = len < klen ? len : klen;
            if (overlap > 0 && (double)overlap > frac * (double)min_len) { blocked = true; break; }
        }
        if (blocked) continue;
        kept[i] = 1;
        slice[2 * n_in[d]] = s;
        slice[2 * n_in[d] + 1] = e;
        n_in[d]++;
    }
}

}  // extern "C"
