// K2 and K4: the bitstream packers.
//
// Both concatenate N variable-length records into one MSB-first,
// big-endian u32 stream that starts at bit `start_bit`.
//
// K2, pack_locals, replaces imageencoder_tpu/ops/pallas_pack.py
// _pack_locals_call (reached through pack_locals_pallas): a record is a
// register file of lw words plus a bit length, as K1 (encode.cu) writes
// it, or a P-frame macroblock's vector pair, built in registers from the
// vectors; the front end (LocalsFront) yields both in stream order, so no
// copy merges them first.  A record's length costs 4 bytes to read, so K2
// is reduce, then scan, in two launches and nothing else: the first sums
// the lengths of each tile, and of each group of 8 tiles; in the second
// every CTA adds up the sums before its own (the groups before its group,
// the tiles before it there: a few hundred values in L2), so it knows its
// start before it begins and waits for no other CTA.  It composes its
// words in shared memory and stores them 16 bytes at a time.  A word that
// tiles share is written once, whole, by the tile that holds its first
// bit: that tile reads on past its last record for the bits the word
// still lacks.  No global atomic, no zeroed buffer, no scratch to clear.
// With a histogram buffer (the image and raw video paths, Huffman on) it
// also takes K3's place, imageencoder_tpu/ops/pallas_kernels.py _hist_call:
// launch 1 zeroes the 256 bins, and launch 2 counts the bytes of exactly
// the words it stores (per-warp bins in shared memory, one global atomicAdd
// a nonzero bin a CTA), so no launch reads the stream again.
// Bound: HBM bytes (the register files and lengths read, about 4 bytes a
// record written).
//
// K4 replaces pallas_pack.py _pack_call (reached through
// pack_records_pallas and device_pack.pack_blocks_device).  Its front ends
// yield each record's length and then its fields, so no field tensor is
// built first:
//   pack_records: [N, F] (value, width) fields, the generic form (also
//                 over segments, each from its own start bit);
//   pack_payload: the Huffman payload, 16 stream bytes a record, each
//                 byte's code looked up in shared memory;
//   pack_coeffs:  a recon video's motion-vector and block records, read
//                 from the coefficient tensor and the vectors.
// pack_records runs on a single-pass packer (pack_tiles): a record's
// length costs as much to find as its fields (its widths), so each tile
// finds them once and looks back for its start.  pack_coeffs and
// pack_payload run on K2's two launches instead.  pack_coeffs
// (CoeffsFront below): the transform that wrote the coefficients
// (transform.cu: K5 and the recon step) also wrote each block's record
// length, 4 bytes a block, and a vector record's length is arithmetic, so
// launch 1 sums lengths alone and launch 2 emits with every tile's start
// known, with K3 folded in as in K2.  pack_payload (PayloadFront), one
// stream or a batch of streams or of byte windows: launch 1 reads the
// bytes once more to sum their codes' lengths, which costs less than the
// single pass's look-back, its wait for the last tile and its merge (over
// a batch each stream's CTAs waited on their own, a share of a persistent
// grid); its grid is not persistent, and a CTA past its stream's bytes
// leaves, so the card's CTAs go to whichever stream has work.
// Bound: HBM bytes.  pack_payload reads 1 byte per coded byte twice (both
// launches read the bytes) and writes the payload, pack_coeffs 4 bytes
// per coefficient and the lengths, and writes the stream.  pack_payload
// reads its codes, the dict, its start bit and its byte count from the
// dict kernel's table (huffman.cu, dict_table.cuh), so its tiles are
// bounded by the bytes coded, not by the worst-case word buffer.
// The single-pass design keeps everything else on chip: the scan is one pass
// (decoupled look-back over tiles taken in order); a tile's words are
// composed in shared memory and leave by 16-byte stores; the words tiles
// share are merged once at the end instead of by global atomics; the
// output is not zeroed first.
//
// A batch of image streams (the serving path, models/batch.py) takes K2
// and pack_payload once each: blockIdx.y is the stream, and each stream has
// its own register files or bytes, output words, sums, total and histogram
// at a fixed stride, so no tile composes a word from two streams and every
// stream ends where its own records do.
//
// The TPU kernel's merge tree, its bit-reversal pre-permute, the capped
// level schedule and the row splice are workarounds for a machine without
// scatter or atomics; none of them has a counterpart here.
#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "bits.cuh"
#include "dict_table.cuh"
#include "records.cuh"

namespace {

// ---- K4: the single-pass packer (pack_records) ----

constexpr int kTile = 256;  // records a tile, threads a CTA
constexpr unsigned long long kFlagA = 1ull << 62;  // a tile's aggregate
constexpr unsigned long long kFlagP = 2ull << 62;  // its inclusive prefix
constexpr unsigned long long kValue = kFlagA - 1ull;

__device__ __forceinline__ unsigned long long ld_acquire(
        const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
}

// Coherent at the card's scope, and free to overlap with other loads.
__device__ __forceinline__ unsigned long long ld_relaxed(
        const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
    asm volatile("st.release.gpu.global.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
}

// Counts the bytes of word w, the stream's bytes b0 .. b0 + 3, that lie
// before byte `end`, into the shared bins.  The count, not the flush, is
// the histogram's cost, and it is bound by instructions: the word's place
// against the end is taken once, not a byte at a time.
__device__ __forceinline__ void count_bytes(int* bins, uint32_t w,
                                            long long b0, long long end) {
    const int live = (int)max(min(end - b0, 4ll), 0ll);
#pragma unroll
    for (int j = 0; j < 4; j++)
        if (j < live) atomicAdd(bins + ((w >> (24 - 8 * j)) & 0xFFu), 1);
}

// Zeroes kWarps sets of 256 bins (a warp's own), or adds them up and into
// the global histogram, a nonzero bin an atomicAdd.
template <int kWarpsHist>
__device__ __forceinline__ void zero_bins(int* bins) {
    for (int k = threadIdx.x; k < kWarpsHist * 256; k += blockDim.x)
        bins[k] = 0;
}

template <int kWarpsHist>
__device__ __forceinline__ void flush_bins(const int* bins, int32_t* hist) {
    for (int k = threadIdx.x; k < 256; k += blockDim.x) {
        int c = 0;
#pragma unroll
        for (int w = 0; w < kWarpsHist; w++) c += bins[w * 256 + k];
        if (c) atomicAdd(hist + k, c);
    }
}

// One pack's outputs and scratch.  scratch: u64 words zeroed by the
// caller, [0] the tile counter, [1] tiles done, [2] the error flag, [3 + t]
// tile t's status (flag | value); edges: u64 [2 * n_tiles], each tile's
// first and last span word as ((word + 1) << 32) | bits, 0 for none.
struct PackOut {
    long long n;  // records
    long long n_tiles;
    long long start_bit;
    const uint32_t* prefix;
    long long prefix_words;
    uint32_t* out;
    long long n_words;
    unsigned long long* scratch;
    unsigned long long* edges;
    long long* total;
    int span_words;       // capacity of the shared span
    int max_record_bits;  // longer records are refused

    __device__ __forceinline__ uint32_t prefix_word(long long w) const {
        return w < prefix_words ? prefix[w] : 0u;
    }
};

// A record's words into the tile's span: the first and last word may be
// shared with the neighbouring records (shared-memory atomicOr), the
// interior ones are the record's alone.
struct SpanSink {
    uint32_t* span;
    int base;
    int last;
    __device__ __forceinline__ void operator()(int k, uint32_t w) const {
        if (k == 0 || k == last) {
            if (w != 0u) atomicOr(span + base + k, w);
        } else {
            span[base + k] = w;
        }
    }
};

// The exclusive prefix (start_bit included) of tile t, by decoupled
// look-back: warp 0 publishes the tile's aggregate, then reads the status
// of kWindow earlier tiles at a time (kPerLane consecutive ones a lane),
// adding aggregates back to the nearest inclusive prefix, and publishes
// its own.  Tiles are taken in order from a counter, so every tile looked
// at belongs to a running CTA.  The prefixes advance by at most a window
// per round trip to L2, so the window is wide.
constexpr int kPerLane = 4;
constexpr int kWindow = 32 * kPerLane;

__device__ __forceinline__ long long look_back(unsigned long long* status,
                                               long long t, long long agg,
                                               long long start_bit) {
    const int lane = threadIdx.x & 31;
    if (t == 0) {
        if (lane == 0) st_release(status, kFlagP | (start_bit + agg));
        return start_bit;
    }
    if (lane == 0) st_release(status + t, kFlagA | agg);
    long long excl = 0;
    for (long long top = t - 1;; top -= kWindow) {
        // Lane l holds tiles top - kPerLane * l - k, k = 0..kPerLane-1,
        // nearest first: all read at once, then the unpublished ones read
        // again up to the lane's nearest inclusive prefix.
        unsigned long long s[kPerLane];
#pragma unroll
        for (int k = 0; k < kPerLane; k++) {
            const long long j = top - kPerLane * lane - k;
            s[k] = j >= 0 ? ld_relaxed(status + j) : kFlagP;  // before tile 0
        }
        int first_p = kPerLane;  // the lane's nearest inclusive prefix
#pragma unroll
        for (int k = 0; k < kPerLane; k++) {
            const long long j = top - kPerLane * lane - k;
            while ((s[k] >> 62) == 0) s[k] = ld_relaxed(status + j);
            if ((s[k] >> 62) == 2) {
                first_p = k;
                break;
            }
        }
        const unsigned p = __ballot_sync(0xffffffffu, first_p < kPerLane);
        const int stop = p ? __ffs(p) - 1 : 31;
        long long v = 0;
#pragma unroll
        for (int k = 0; k < kPerLane; k++)
            if (lane < stop || (lane == stop && k <= first_p))
                v += (long long)(s[k] & kValue);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, o);
        excl += v;
        if (p) break;
    }
    if (lane == 0) st_release(status + t, kFlagP | (excl + agg));
    return excl;
}

// The packer.  A CTA takes tiles of kTile * ITEMS records from the tile
// counter, each thread ITEMS consecutive records.  Per tile: each record's
// length from the front end; a block scan of the threads' sums; the tile's
// prefix by look-back; the tile's span of output words composed in shared
// memory, each record emitted from the state its thread kept; the span's
// interior words stored by 16-byte stores; its first and last word, which
// other tiles (or the prefix) may share, kept as edges.  When every tile is
// done, every CTA merges the edges: the tile holding the first stream bit
// of a shared word ORs in the later tiles' parts of it and stores it, once.
// No word of the output is written twice or by an atomic, and nothing of
// it is zeroed first: the words past the stream's last word are left as
// they were.
template <int ITEMS, class Front>
__device__ __forceinline__ void pack_tiles(const Front& fe,
                                           const PackOut& a) {
    constexpr long long kRecords = (long long)kTile * ITEMS;
    extern __shared__ __align__(16) uint32_t span[];
    __shared__ long long warp_sums[32];
    __shared__ long long s_tile, s_agg, s_excl;
    unsigned long long* counter = a.scratch;
    unsigned long long* done = a.scratch + 1;
    unsigned long long* err = a.scratch + 2;
    unsigned long long* status = a.scratch + 3;
    const int tid = threadIdx.x;

    for (;;) {
        // Take a tile only when about to pack it: a later tile's look-back
        // waits for this one's aggregate.
        if (tid == 0) s_tile = (long long)atomicAdd(counter, 1ull);
        __syncthreads();
        const long long t = s_tile;
        if (t >= a.n_tiles) break;
        const long long first = t * kRecords + (long long)tid * ITEMS;
        typename Front::State st[ITEMS];
        long long lens[ITEMS];
        long long sum = 0;
        unsigned refused = 0u;
#pragma unroll
        for (int r = 0; r < ITEMS; r++) {
            long long len = first + r < a.n ? fe.length(first + r, st[r]) : 0;
            if (len < 0 || len > a.max_record_bits) refused |= 1u << r;
            lens[r] = len < 0 ? 0 : len;
            sum += lens[r];
        }
        if (refused) atomicExch(err, 1ull);
        const long long local = ie::block_exclusive_scan(sum, warp_sums);
        if (tid == kTile - 1) s_agg = local + sum;
        __syncthreads();
        const long long agg = s_agg;
        // ceil((31 + agg) / 32) words hold the tile at any offset.
        const long long need = (agg + 62) >> 5;
        const bool fits = need <= a.span_words;
        if (fits) {
            for (long long k = tid; k < need; k += kTile) span[k] = 0u;
        } else if (tid == 0) {
            atomicExch(err, 1ull);
        }
        if (tid < 32) {
            const long long excl = look_back(status, t, agg, a.start_bit);
            if (tid == 0) s_excl = excl;
        }
        __syncthreads();
        const long long s0 = s_excl;
        const long long f = s0 >> 5;
        const int nspan = agg > 0 ? (int)(((s0 + agg - 1) >> 5) - f + 1) : 0;
        if (fits) {
            long long rs = s0 + local;
#pragma unroll
            for (int r = 0; r < ITEMS; r++) {
                const long long len = lens[r];
                if (len > 0 && !(refused >> r & 1u)) {
                    const int lead = (int)(rs & 31);
                    const int touched = (int)((lead + len + 31) >> 5);
                    ie::BitEmitter<SpanSink> em(
                        SpanSink{span, (int)((rs >> 5) - f), touched - 1},
                        lead);
                    fe.emit(st[r], em);
                    em.finish();
                }
                rs += len;
            }
        }
        __syncthreads();
        if (fits) {
            const long long lo = f + 1;
            const long long hi = min(f + nspan - 1, a.n_words);
            if (lo < hi) {
                const long long a0 = min((lo + 3) & ~3ll, hi);
                const long long a1 = a0 + ((hi - a0) & ~3ll);
                // Interior words: every byte lies inside the stream.
                if (tid < a0 - lo)
                    a.out[lo + tid] =
                        span[lo + tid - f] | a.prefix_word(lo + tid);
                if (tid < hi - a1)
                    a.out[a1 + tid] =
                        span[a1 + tid - f] | a.prefix_word(a1 + tid);
                for (long long v = a0 + 4 * tid; v < a1; v += 4 * kTile) {
                    const uint32_t* sp = span + (v - f);
                    *reinterpret_cast<uint4*>(a.out + v) = make_uint4(
                        sp[0] | a.prefix_word(v), sp[1] | a.prefix_word(v + 1),
                        sp[2] | a.prefix_word(v + 2),
                        sp[3] | a.prefix_word(v + 3));
                }
            }
        }
        if (tid == 0) {
            a.edges[2 * t] = fits && nspan > 0
                ? ((unsigned long long)(f + 1) << 32) | span[0] : 0ull;
            a.edges[2 * t + 1] = fits && nspan > 1
                ? ((unsigned long long)(f + nspan) << 32) | span[nspan - 1]
                : 0ull;
            __threadfence();  // the edges before the count that reveals them
            atomicAdd(done, 1ull);
        }
    }

    // A CTA past the words the final merge writes has nothing to wait for,
    // and leaves instead of polling the counter.
    if (blockIdx.x != 0 && (long long)blockIdx.x * kTile
                               >= max(2 * a.n_tiles, a.start_bit >> 5))
        return;
    // Every tile has been taken by a running CTA: wait for all of them.
    if (tid == 0)
        while (ld_acquire(done) < (unsigned long long)a.n_tiles)
            __nanosleep(64);
    __syncthreads();
    const long long total = a.n_tiles
        ? (long long)(ld_acquire(status + a.n_tiles - 1) & kValue)
        : a.start_bit;
    const long long g = blockIdx.x * (long long)kTile + tid;
    const long long stride = (long long)gridDim.x * kTile;
    for (long long e = g; e < 2 * a.n_tiles; e += stride) {
        const unsigned long long ed = ld_relaxed(a.edges + e);
        if (ed == 0ull) continue;
        const long long w = (long long)(ed >> 32) - 1;
        const long long t = e >> 1;
        const long long s0 =
            t ? (long long)(ld_relaxed(status + t - 1) & kValue) : a.start_bit;
        if (s0 > max(32 * w, a.start_bit)) continue;  // an earlier tile's word
        uint32_t v = (uint32_t)ed | a.prefix_word(w);
        const long long end = min(32 * (w + 1), total);
        for (long long t2 = t + 1; t2 < a.n_tiles; t2++) {
            if ((long long)(ld_relaxed(status + t2 - 1) & kValue) >= end)
                break;
            v |= (uint32_t)ld_relaxed(a.edges + 2 * t2);
        }
        if (w < a.n_words) a.out[w] = v;
    }
    const long long head = min(a.start_bit >> 5, a.n_words);
    for (long long w = g; w < head; w += stride) a.out[w] = a.prefix_word(w);
    if (g == 0) {
        // An empty stream that starts inside a word: that word is prefix.
        if (total == a.start_bit && (a.start_bit & 31) && head < a.n_words)
            a.out[head] = a.prefix_word(head);
        *a.total = ld_acquire(err) ? -1 : total;
    }
}

// The front ends: length(i, st) is record i's length in bits (-1 for a
// record that breaks the front end's contract), keeping in st what
// emit(st, em) needs to emit its fields; kItems is the records a thread.

// pack_records: [N, F] fields (value, width 0..16), read from global
// memory as the thread walks them.
struct RecordsFront {
    static constexpr int kItems = 1;
    struct State {
        long long r;
    };
    const int32_t* vals;
    const int32_t* nbits;
    int f;

    __device__ __forceinline__ long long length(long long r,
                                                State& st) const {
        st.r = r;
        long long len = 0;
        for (int k = 0; k < f; k++) {
            const int nb = nbits[r * f + k];
            if (nb < 0 || nb > 16) return -1;
            len += nb;
        }
        return len;
    }

    template <class E>
    __device__ __forceinline__ void emit(const State& st, E& em) const {
        for (int k = 0; k < f; k++)
            em.put(nbits[st.r * f + k], (uint32_t)vals[st.r * f + k]);
    }
};

// pack_payload on K2's two launches (pack_known_kernel below): 16 stream
// bytes a record, one 16-byte load, taken in the order w>>24, >>16, >>8,
// &0xFF, each replaced by its code from a table in shared memory ((length
// << 16) | code); bytes before first or at or past nbytes have width 0.
// Over a batch of streams of n_in words each, at a stride of n_in words
// and of one table a stream: to_stream reads the stream's start bit (the
// dict's bits), its dict words, its first byte and its byte count from its
// table, and so its records, which bound its tiles (a CTA past them
// leaves); enter loads its codes into shared memory.  A record's length
// costs its 16 bytes' codes, so launch 1 reads the bytes once to sum them
// and launch 2 again to emit them.
struct PayloadFront {
    // Records a thread: 4 over a batch (tiles of 16 KB of bytes, half the
    // CTAs, and still enough of them to fill the card), 2 for one stream
    // (whose tiles would otherwise be too few).
    static constexpr int kItemsOne = 2;
    static constexpr int kItemsBatch = 4;
    static constexpr int lw = 8;  // a record is at most 16 codes of 16 bits
    static constexpr bool kAllAtomic = true;  // emitted a code at a time
    static constexpr bool kStrided = true;    // see tile_sums_kernel
    struct State {
        uint32_t w[4];
        long long r;
    };
    struct Cursor {
        long long r;
    };
    const uint32_t* words;
    long long n_in;
    long long nbytes;
    const uint32_t* tab;
    long long first;
    const int32_t* table;  // the known launches' tables, one a stream

    __device__ __forceinline__ void load(long long r, uint32_t* w) const {
        const long long b = 4 * r;
        if (b + 3 < n_in) {
            const uint4 v = *reinterpret_cast<const uint4*>(words + b);
            w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
        } else {
#pragma unroll
            for (int k = 0; k < 4; k++)
                w[k] = b + k < n_in ? words[b + k] : 0u;
        }
    }
    // The table entry of byte k of the record.
    __device__ __forceinline__ uint32_t code(const uint32_t* w, int k) const {
        return tab[(w[k >> 2] >> (24 - 8 * (k & 3))) & 0xFFu];
    }
    // The same, 0 outside [first, nbytes).
    __device__ __forceinline__ uint32_t entry(const uint32_t* w, long long r,
                                              int k) const {
        const long long b = 16 * r + k;
        return b >= first && b < nbytes ? code(w, k) : 0u;
    }
    // Whether all 16 bytes of record r lie in [first, nbytes): all but a
    // window's first and last record, which alone take a check a byte.
    __device__ __forceinline__ bool whole(long long r) const {
        return 16 * r >= first && 16 * r + 16 <= nbytes;
    }

    // Record r's length from its loaded words.
    __device__ __forceinline__ int length_of(const uint32_t* w,
                                             long long r) const {
        int len = 0;
        if (whole(r)) {
#pragma unroll
            for (int k = 0; k < 16; k++) len += (int)(code(w, k) >> 16);
        } else {
#pragma unroll
            for (int k = 0; k < 16; k++) len += (int)(entry(w, r, k) >> 16);
        }
        return len;
    }

    // Stream k of a batch: its words, and from its table its start bit,
    // dict words, byte window and records.
    template <class Out>
    __device__ __forceinline__ void to_stream(long long k, Out& a) {
        words += k * n_in;
        table += k * ie::kTableWords;
        const long long* meta =
            reinterpret_cast<const long long*>(table + ie::kTableMeta);
        nbytes = min(meta[ie::kMetaNbytes], 4 * n_in);
        first = max(meta[ie::kMetaFirstByte], 0ll);
        a.start_bit = meta[ie::kMetaDictBits];
        a.prefix = reinterpret_cast<const uint32_t*>(table + ie::kTableDict);
        a.prefix_words = ie::kDictWords;
        a.n = max((nbytes + 15) / 16, 0ll);
    }

    // The codes into shared memory, once the CTA's records are asked for:
    // one entry a byte value, (length << 16) | code.
    __device__ __forceinline__ void enter() {
        __shared__ uint32_t codes[256];
        for (int k = threadIdx.x; k < 256; k += blockDim.x)
            codes[k] =
                ((uint32_t)min(max(table[ie::kTableCodeL + k], 0), 0xFFFF)
                 << 16)
                | ((uint32_t)table[ie::kTableCodeW + k] & 0xFFFFu);
        tab = codes;
        __syncthreads();
    }

    __device__ __forceinline__ Cursor at(long long i) const {
        return Cursor{i};
    }

    // Launch 2: the record's words are asked for; its length waits for
    // the codes (settle, after enter).
    template <bool kWords>
    __device__ __forceinline__ int next(Cursor& c, State& st) const {
        st.r = c.r++;
        load(st.r, st.w);
        return 0;
    }
    __device__ __forceinline__ int settle(const State& st, int) const {
        return length_of(st.w, st.r);
    }

    // Launch 1: the lengths of a thread's kCount records, every step-th
    // from `first`, all loads in flight at once; the codes come into
    // shared memory meanwhile.
    template <int kCount>
    __device__ __forceinline__ void strided_lengths(long long first,
                                                    long long step,
                                                    long long n, int* len) {
        uint32_t w[kCount][4];
#pragma unroll
        for (int j = 0; j < kCount; j++)
            if (first + step * j < n) load(first + step * j, w[j]);
        enter();
#pragma unroll
        for (int j = 0; j < kCount; j++) {
            const long long r = first + step * j;
            len[j] = r < n ? length_of(w[j], r) : 0;
        }
    }

    __device__ __forceinline__ bool refused(int len) const {
        return len < 0 || len > 32 * lw;
    }

    __device__ __forceinline__ int reach_length(long long i,
                                                State& st) const {
        st.r = i;
        load(i, st.w);
        const int len = length_of(st.w, i);
        return refused(len) ? -1 : len;
    }
    __device__ __forceinline__ void reach_fill(long long, State&) const {}
    __device__ __forceinline__ long long skip_empty(long long i) const {
        return i;
    }

    // Two codes a put (at most 32 bits): half the emitter's steps.
    template <class Sink>
    __device__ __forceinline__ void emit_words(const State& st, int lead,
                                               const Sink& sink) const {
        ie::BitEmitter<Sink> em(sink, lead);
        const bool all = whole(st.r);
#pragma unroll
        for (int k = 0; k < 16; k += 2) {
            const uint32_t e0 = all ? code(st.w, k) : entry(st.w, st.r, k);
            const uint32_t e1 =
                all ? code(st.w, k + 1) : entry(st.w, st.r, k + 1);
            const int n1 = (int)(e1 >> 16);
            em.put((int)(e0 >> 16) + n1,
                   ((e0 & 0xFFFFu) << n1) | (e1 & 0xFFFFu & ((1u << n1) - 1u)));
        }
        em.finish();
    }
};

__global__ void __launch_bounds__(kTile) pack_records_kernel(
        const int32_t* __restrict__ vals, const int32_t* __restrict__ nbits,
        int f, PackOut a) {
    const RecordsFront fe{vals, nbits, f};
    pack_tiles<RecordsFront::kItems>(fe, a);
}

// pack_records over segments: blockIdx.y is the segment, with its own N
// records of f fields, its own start bit starts[y] (its bit phase in the
// stream it joins), output row, total, and scratch and edges at the given
// strides (the sharded video's vector segments, parallel/video_sharding.py).
__global__ void __launch_bounds__(kTile) pack_records_segments_kernel(
        const int32_t* __restrict__ vals, const int32_t* __restrict__ nbits,
        int f, const long long* __restrict__ starts,
        long long scratch_stride, long long edges_stride, PackOut a) {
    const long long b = blockIdx.y;
    vals += b * a.n * f;
    nbits += b * a.n * f;
    a.out += b * a.n_words;
    a.total += b;
    a.scratch += b * scratch_stride;
    a.edges += b * edges_stride;
    a.start_bit = starts[b];
    const RecordsFront fe{vals, nbits, f};
    pack_tiles<RecordsFront::kItems>(fe, a);
}

// Fills in the launch-side fields of PackOut for tiles of kTile * items
// records and launches a persistent grid: as many CTAs as fit on the card
// at once, at most one a tile, so that every CTA that waits for the others
// waits on running ones.  With n_streams > 1 the grid's y is the stream and
// the card's CTAs are shared among the streams; a CTA waits only for tiles
// of its own stream that running CTAs have taken.
template <class... P, class... A>
int launch_pack_streams(void (*kernel)(P...), int items, PackOut a,
                        long long max_record_bits, long long n_streams,
                        cudaStream_t s, A... args) {
    if (n_streams < 1 || n_streams > 65535)
        return (int)cudaErrorInvalidValue;
    const long long records = (long long)kTile * items;  // a tile
    a.n_tiles = (a.n + records - 1) / records;
    a.max_record_bits = (int)max_record_bits;
    a.span_words = (int)(records * ((max_record_bits + 31) / 32) + 2);
    const size_t smem = (size_t)a.span_words * sizeof(uint32_t);
    cudaError_t e = cudaSuccess;
    if (smem > 48 * 1024)
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int per_sm = 0, dev = 0, sms = 0;
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kTile, smem);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long grid = std::max(
        1ll, std::min(a.n_tiles, ((long long)per_sm * sms + n_streams - 1)
                                     / n_streams));
    kernel<<<dim3((unsigned)grid, (unsigned)n_streams), kTile, smem, s>>>(
        args..., a);
    return (int)cudaGetLastError();
}

template <class... P, class... A>
int launch_pack(void (*kernel)(P...), int items, PackOut a,
                long long max_record_bits, cudaStream_t s, A... args) {
    return launch_pack_streams(kernel, items, a, max_record_bits, 1, s,
                               args...);
}

PackOut pack_out(long long n, long long start_bit, const void* prefix,
                 long long prefix_words, void* out, long long n_words,
                 void* scratch, void* edges, void* total) {
    PackOut a{};
    a.n = n;
    a.start_bit = start_bit;
    a.prefix = (const uint32_t*)prefix;
    a.prefix_words = prefix ? prefix_words : 0;
    a.out = (uint32_t*)out;
    a.n_words = n_words;
    a.scratch = (unsigned long long*)scratch;
    a.edges = (unsigned long long*)edges;
    a.total = (long long*)total;
    return a;
}

// ---- K2: reduce, then pack with every tile's start known ----

// K2's records in stream order.  Without vectors (n_macro == 0) record i
// is block i: register file local[i], lw words MSB-first, of lens[i] bits
// (bits past the length are zero).  With them the stream is a video's: per
// frame f, n_macro vector records (x then y, nbits two's-complement bits
// each, from mvecs[p] of the p-th P-frame; empty on an I-frame, f % gop ==
// 0), then the frame's n_micro block records.  A block record longer than
// its register file (K1 refused it) or of negative length is refused.  A
// thread walks consecutive records with a cursor, so it divides once.
// kVec false compiles the vector records out: a thread's loads then
// depend on nothing but its first record's number.
template <bool kVec>
struct LocalsFront {
    static constexpr bool kAllAtomic = false;  // see OwnedSink
    static constexpr bool kStrided = false;    // see tile_sums_kernel
    struct State {
        const uint32_t* row;  // a block record's register file, or null
        uint32_t w0, w1;      // the record's first two words
        int len;
    };
    struct Cursor {
        unsigned fi, j;  // frame, record in the frame (with vectors)
        unsigned b;      // block (without)
        unsigned pf;     // the frame's place among the P-frames
        bool live;       // a P-frame: its vector records hold bits
    };
    const uint32_t* local;
    const int32_t* lens;
    int lw;
    const int32_t* mvecs;
    unsigned n_macro, n_micro;
    int gop, nbits;

    __device__ __forceinline__ void enter_frame(Cursor& c) const {
        const unsigned g = c.fi / (unsigned)gop;
        c.live = c.fi != g * (unsigned)gop;
        c.pf = c.fi - g - 1u;
    }

    // Stream k of a batch of block records (no vectors), a.n records each.
    template <class Out>
    __device__ __forceinline__ void to_stream(long long k, const Out& a) {
        local += k * a.n * lw;
        lens += k * a.n;
    }
    __device__ __forceinline__ void enter() const {}
    __device__ __forceinline__ int settle(const State&, int len) const {
        return len;
    }

    __device__ __forceinline__ Cursor at(long long i) const {
        Cursor c{};
        c.b = (unsigned)i;
        if (kVec && n_macro) {
            const unsigned per = n_macro + n_micro;
            c.fi = (unsigned)i / per;
            c.j = (unsigned)i - c.fi * per;
            enter_frame(c);
        }
        return c;
    }

    // The record at the cursor into st (with kWords its first two words
    // too) and the cursor one on.  Returns the length as stored, not yet
    // checked (see refused): nothing here waits for a load, so the loads
    // of a thread's consecutive records are in flight together.
    template <bool kWords>
    __device__ __forceinline__ int next(Cursor& c, State& st) const {
        unsigned b = c.b++;
        if (kVec && n_macro) {
            const unsigned j = c.j;
            const bool live = c.live;
            const unsigned at = c.pf * n_macro + j;
            b = c.fi * n_micro + (j - n_macro);
            if (++c.j == n_macro + n_micro) {
                c.j = 0u;
                c.fi++;
                enter_frame(c);
            }
            if (j < n_macro) {
                st.row = nullptr;
                st.w0 = st.w1 = 0u;
                if (!live) return st.len = 0;
                const int2 v = __ldg(reinterpret_cast<const int2*>(mvecs)
                                     + at);
                const uint32_t m = (1u << nbits) - 1u;
                st.w0 = (((uint32_t)v.x & m) << (32 - nbits))
                        | (((uint32_t)v.y & m) << (32 - 2 * nbits));
                return st.len = 2 * nbits;
            }
        }
        st.row = local + (long long)b * lw;
        st.len = __ldg(lens + b);
        if (kWords) {
            st.w0 = __ldg(st.row);
            st.w1 = lw > 1 ? __ldg(st.row + 1) : 0u;
        }
        return st.len;
    }

    // A length no record may have: negative, or past the register file.
    __device__ __forceinline__ bool refused(int len) const {
        return len < 0 || len > 32 * lw;
    }

    // Record i into st and its length, -1 where it is refused.
    __device__ __forceinline__ long long length(long long i,
                                                State& st) const {
        Cursor c = at(i);
        const int len = next<true>(c, st);
        return refused(len) ? -1 : len;
    }

    // The reach past a tile (pack_known_kernel): record i's length, st
    // filled as far as the reach needs (whole, here), and the rest of st
    // where the reach emits the record (nothing left).
    __device__ __forceinline__ int reach_length(long long i,
                                                State& st) const {
        return (int)length(i, st);
    }
    __device__ __forceinline__ void reach_fill(long long, State&) const {}

    // The first record at or after i that may hold bits: past an I-frame's
    // run of empty vector records in one step.
    __device__ __forceinline__ long long skip_empty(long long i) const {
        if (!kVec || !n_macro) return i;
        const Cursor c = at(i);
        return (c.j < n_macro && !c.live)
            ? (long long)c.fi * (n_macro + n_micro) + n_macro : i;
    }

    // The record's words, shifted to start `lead` bits into the first,
    // handed to sink(k, word) for k = 0 .. touched - 1.
    template <class Sink>
    __device__ __forceinline__ void emit_words(const State& st, int lead,
                                               const Sink& sink) const {
        const int own = (st.len + 31) >> 5;
        const int touched = (lead + st.len + 31) >> 5;
        uint32_t prev = 0u;
        for (int k = 0; k < touched; k++) {
            const uint32_t cur = k >= own ? 0u : k == 0 ? st.w0
                : k == 1 ? st.w1 : __ldg(st.row + k);
            sink(k, __funnelshift_r(cur, prev, lead));
            prev = cur;
        }
    }
};

// K4 pack_coeffs on K2's two launches: a recon video's records straight
// from its coefficients, int32 frames [H, W] `frame` elements apart (block
// (r, c), coefficient (u, v) at [B*r + u, B*c + v]), and its motion
// vectors int32 [P, n_macro, 2].  In stream order, per frame f: n_macro
// vector records (x then y, nbits two's-complement bits each, from
// mvecs[p] of the p-th P-frame; empty on an I-frame, f % gop == 0), then
// the frame's n_micro block records in row-major order.  A vector
// record's length is arithmetic.  A block record's is lens[f * n_micro +
// b] as the transform wrote it (transform.cu, records.cuh's block_stats),
// which is all launch 1 reads.  Launch 2 reads the block by rows of
// 16-byte loads and puts it in zig-zag order in registers; it takes the
// tile's scan from the lengths too (kLengthsFirst), so the scan need not
// wait for the blocks, and their stats are taken where they are emitted,
// as K1 emits them (records.cuh).  Launch 2's reach past its tile reads
// lengths, and loads only the blocks whose bits it takes.  Without
// lengths each is taken from its block.  A block record longer than lw
// words is refused.
template <int B>
struct CoeffsFront {
    static constexpr int K = B * B;
    static constexpr bool kLengthsFirst = true;
    static constexpr bool kAllAtomic = true;  // see OwnedSink
    static constexpr bool kStrided = false;   // see tile_sums_kernel
    struct State {
        int kind;  // 0 empty, 1 vectors (x, y in q[0], q[1]), 2 block,
                   // 3 a block whose length alone was read
        int q[K];
    };
    struct Cursor {
        unsigned fi, j;  // frame, record in the frame
        unsigned pf;     // the frame's place among the P-frames
        bool live;       // a P-frame: its vector records hold bits
    };
    const int32_t* coeffs;
    const int32_t* lens;
    const int32_t* mvecs;
    long long width, frame;  // coefficients a row, a frame
    unsigned blocks_x, n_macro, n_micro;
    int gop, nbits, use_rle, lw;

    template <class Out>
    __device__ __forceinline__ void to_stream(long long, const Out&) const {}
    __device__ __forceinline__ void enter() const {}
    __device__ __forceinline__ int settle(const State&, int len) const {
        return len;
    }

    __device__ __forceinline__ void enter_frame(Cursor& c) const {
        const unsigned g = c.fi / (unsigned)gop;
        c.live = c.fi != g * (unsigned)gop;
        c.pf = c.fi - g - 1u;
    }

    __device__ __forceinline__ Cursor at(long long i) const {
        Cursor c{};
        const unsigned per = n_macro + n_micro;
        c.fi = (unsigned)i / per;
        c.j = (unsigned)i - c.fi * per;
        enter_frame(c);
        return c;
    }

    // The record at the cursor into st and the cursor one on; its length.
    // With kFull a block's coefficients are loaded; its length is read
    // from lens where there are lengths, else taken from them.
    template <bool kFull>
    __device__ __forceinline__ int next(Cursor& c, State& st) const {
        const unsigned j = c.j, fi = c.fi, pf = c.pf;
        const bool live = c.live;
        if (++c.j == n_macro + n_micro) {
            c.j = 0u;
            c.fi++;
            enter_frame(c);
        }
        if (j < n_macro) {
            st.kind = live ? 1 : 0;
            if (!live) return 0;
            const int2 v = __ldg(reinterpret_cast<const int2*>(mvecs)
                                 + (long long)pf * n_macro + j);
            st.q[0] = v.x;
            st.q[1] = v.y;
            return 2 * nbits;
        }
        const unsigned b = j - n_macro;
        const int* len_at = lens + (long long)fi * n_micro + b;
        if (!kFull && lens) {
            st.kind = 3;
            return __ldg(len_at);
        }
        const unsigned by = b / blocks_x;
        const int32_t* base = coeffs + fi * frame + (long long)by * B * width
                              + (long long)(b - by * blocks_x) * B;
        int nat[K];
#pragma unroll
        for (int r = 0; r < B; r++)
#pragma unroll
            for (int c4 = 0; c4 < B / 4; c4++) {
                const int4 v = __ldg(reinterpret_cast<const int4*>(
                    base + r * width + 4 * c4));
                nat[r * B + 4 * c4] = v.x;
                nat[r * B + 4 * c4 + 1] = v.y;
                nat[r * B + 4 * c4 + 2] = v.z;
                nat[r * B + 4 * c4 + 3] = v.w;
            }
        ie::gather_zigzag<B>(nat, st.q);
        st.kind = 2;
        if (kLengthsFirst && lens) return __ldg(len_at);
        return ie::block_stats<K>(st.q, use_rle).len;
    }

    __device__ __forceinline__ bool refused(int len) const {
        return len < 0 || len > 32 * lw;
    }

    __device__ __forceinline__ long long length(long long i,
                                                State& st) const {
        Cursor c = at(i);
        const int len = next<true>(c, st);
        return refused(len) ? -1 : len;
    }

    // The reach past a tile (pack_known_kernel): record i's length (from
    // lens, st left pending) and, for the records it emits, the rest.
    __device__ __forceinline__ int reach_length(long long i,
                                                State& st) const {
        Cursor c = at(i);
        const int len = next<!kLengthsFirst>(c, st);
        return refused(len) ? -1 : len;
    }
    __device__ __forceinline__ void reach_fill(long long i,
                                               State& st) const {
        if (st.kind == 3) {
            Cursor c = at(i);
            next<true>(c, st);
        }
    }

    // The first record at or after i that may hold bits: past an I-frame's
    // run of empty vector records in one step.
    __device__ __forceinline__ long long skip_empty(long long i) const {
        if (!n_macro) return i;
        const Cursor c = at(i);
        return (c.j < n_macro && !c.live)
            ? (long long)c.fi * (n_macro + n_micro) + n_macro : i;
    }

    template <class Sink>
    __device__ __forceinline__ void emit_words(const State& st, int lead,
                                               const Sink& sink) const {
        ie::BitEmitter<Sink> em(sink, lead);
        if (st.kind == 1) {
            em.put(nbits, (uint32_t)st.q[0]);
            em.put(nbits, (uint32_t)st.q[1]);
        } else if (st.kind == 2) {
            ie::emit_block<K>(em, st.q, ie::block_stats<K>(st.q, use_rle),
                              use_rle);
        }
        em.finish();
    }
};

// A record's words into the words a tile owns, span[0 .. nspan): words
// outside them belong to a neighbouring tile and are dropped.  The
// record's first and last word may be shared with its neighbours
// (shared-memory atomicOr); the interior ones are its alone, stored, or
// with kAllAtomic (Front::kAllAtomic) OR'd in as well: pack_coeffs, which
// emits its records a field at a time, measured 5.7 us faster so on the
// 720p25 recon video (H100); K2 keeps its stores (tools/k2_variants.py
// tries all_atomic on it).
template <bool kAllAtomic>
struct OwnedSink {
    uint32_t* span;
    int base;
    int last;
    int nspan;
    __device__ __forceinline__ void operator()(int k, uint32_t w) const {
        const int i = base + k;
        if ((unsigned)i >= (unsigned)nspan) return;
        if (kAllAtomic || k == 0 || k == last) {
            if (w != 0u) atomicOr(span + i, w);
        } else {
            span[i] = w;
        }
    }
};

// Record `st` of `len` > 0 bits at stream bit `pos` into the owned words.
template <class Front>
__device__ __forceinline__ void emit_owned(
        const Front& fe, const typename Front::State& st, int len,
        long long pos, long long w0, uint32_t* span, int nspan) {
    const int lead = (int)(pos & 31);
    fe.emit_words(st, lead, OwnedSink<Front::kAllAtomic>{
                                span, (int)((pos >> 5) - w0),
                                ((lead + len + 31) >> 5) - 1, nspan});
}

// One scan-free pack's outputs.  sums: i64 [n_tiles + ceil(n_tiles /
// kWarps)], tile t's bits and then each group of kWarps tiles', or -1
// where one holds a refused record; total: i64 [1]; hist: i32 [256], the
// stream's byte histogram, or null.  A batch of n_streams streams has
// these for each stream, out and sums at strides of n_words and
// sums_stride; n_tiles is a stream's tiles at most, which sizes the grid
// and its sums, n a stream's records (the front end's to_stream may set a
// stream's own n, start bit and prefix: pack_payload's from its table);
// starts, where not null, i64 [n_streams] on the device, each stream's own
// start bit in place of start_bit.
struct KnownOut {
    long long n;  // records
    long long n_tiles;
    long long n_streams;
    long long sums_stride;
    long long start_bit;
    const uint32_t* prefix;
    long long prefix_words;
    uint32_t* out;
    long long n_words;
    long long* sums;
    long long* total;
    int32_t* hist;
    const long long* starts;

    __device__ __forceinline__ uint32_t prefix_word(long long w) const {
        return w < prefix_words ? prefix[w] : 0u;
    }

    // Stream k of a batch.
    __device__ __forceinline__ void to_stream(long long k) {
        if (starts) start_bit = starts[k];
        out += k * n_words;
        sums += k * sums_stride;
        total += k;
        if (hist) hist += 256 * k;
    }

    // The stream's own tiles of kTile * items records (at least one, which
    // writes the total): CTAs past them leave.
    __device__ __forceinline__ long long tiles(int items) const {
        const long long records = (long long)kTile * items;
        return max(1ll, (n + records - 1) / records);
    }
};

constexpr int kWarps = kTile / 32;

// Launch 1: the bits of each tile of kTile * ITEMS records into sums[t],
// -1 for one that holds a refused record.  A warp a tile and kWarps tiles
// (a group) a CTA, each lane consecutive records (one cursor), group g's
// bits into sums[n_tiles + g]; or, with Front::kStrided, a CTA a tile, its
// threads' records every kTile-th (pack_payload: 16-byte loads side by
// side, the codes coming into shared memory meanwhile; a sum needs no
// order) and no group sums: a group of its tiles (64 KB of bytes) was too
// much work for one CTA, and too few CTAs left the SMs unevenly loaded.
// CTA 0 also zeroes the histogram that launch 2 counts into; a CTA past
// its stream's tiles leaves.  grid: (ceil(n_tiles / kWarps), n_streams),
// with kStrided (n_tiles, n_streams).
template <int ITEMS, class Front>
__global__ void __launch_bounds__(kTile) tile_sums_kernel(Front fe,
                                                          KnownOut a) {
    constexpr int kPerLane = kWarps * ITEMS;  // kTile * ITEMS / 32
    __shared__ long long warp_sum[kWarps];
    a.to_stream(blockIdx.y);
    fe.to_stream(blockIdx.y, a);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if constexpr (Front::kStrided) {
        const long long t = blockIdx.x;
        if (t >= a.tiles(ITEMS)) return;
        if (a.hist && t == 0) a.hist[threadIdx.x] = 0;  // kTile == 256
        int len[ITEMS];
        fe.template strided_lengths<ITEMS>(t * kTile * ITEMS + threadIdx.x,
                                           kTile, a.n, len);
        int sum = 0;
        int bad = 0;
#pragma unroll
        for (int r = 0; r < ITEMS; r++)
            if (fe.refused(len[r])) bad = 1; else sum += len[r];
        sum = __reduce_add_sync(0xffffffffu, sum);
        bad = __any_sync(0xffffffffu, bad);
        if (lane == 0) warp_sum[warp] = bad ? -1 : sum;
        __syncthreads();
        if (threadIdx.x == 0) {
            long long tile = 0;
            for (int k = 0; k < kWarps; k++)
                tile = (tile < 0 || warp_sum[k] < 0) ? -1 : tile + warp_sum[k];
            a.sums[t] = tile;
        }
    } else {
        if ((long long)blockIdx.x * kWarps >= a.tiles(ITEMS)) return;
        const long long t = (long long)blockIdx.x * kWarps + warp;
        if (a.hist && blockIdx.x == 0) a.hist[threadIdx.x] = 0;
        const long long first = (t * 32 + lane) * kPerLane;
        typename Front::Cursor c = fe.at(first);
        int len[kPerLane];
#pragma unroll
        for (int r = 0; r < kPerLane; r++) {
            typename Front::State st;
            len[r] = first + r < a.n ? fe.template next<false>(c, st) : 0;
        }
        int sum = 0;  // a tile's bits fit: kTile * ITEMS records of <= 32 lw
        int bad = 0;
#pragma unroll
        for (int r = 0; r < kPerLane; r++)
            if (fe.refused(len[r])) bad = 1; else sum += len[r];
        sum = __reduce_add_sync(0xffffffffu, sum);
        bad = __any_sync(0xffffffffu, bad);
        const long long tile = bad ? -1 : sum;
        if (lane == 0) {
            if (t < a.n_tiles) a.sums[t] = tile;
            warp_sum[warp] = tile;
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            long long group = 0;
            for (int k = 0; k < kWarps; k++)
                group = (group < 0 || warp_sum[k] < 0) ? -1
                                                       : group + warp_sum[k];
            a.sums[a.n_tiles + blockIdx.x] = group;
        }
    }
}

// Launch 2: tile t of kTile * ITEMS records, each thread ITEMS consecutive
// ones.  The tile starts at start_bit plus the sums before it and owns the
// words whose first bit lies in its bits (tile 0 also the word that holds
// start_bit and the prefix words before it).  Its records go into those
// words in shared memory; the bits its last word lacks come from the
// records that follow, read by warp 0; then the words leave, the prefix
// OR'd in.  A tile with a refused record writes nothing and the last tile
// reports the total as -1.  Everything a thread reads up front (its
// records' lengths and first two words, the sums; pack_payload's records
// and codes, the lengths settled from them after the codes' barrier) is
// asked for before the one barrier that the starts need, so a CTA waits
// for memory once; a record's further words are read as it is emitted.  With kHist the bytes
// of every word it stores are counted (the stream's end, where it lies in
// the tile's last word, is where warp 0's reach past the tile runs out of
// records) and added to a.hist.  A CTA past its stream's tiles leaves.
// grid: (n_tiles, n_streams).
template <int ITEMS, class Front, bool kHist>
__global__ void __launch_bounds__(kTile) pack_known_kernel(Front fe,
                                                           KnownOut a) {
    constexpr long long kRecords = (long long)kTile * ITEMS;
    constexpr long long kAll = 1ll << 62;  // no byte of the word is past the end
    extern __shared__ __align__(16) uint32_t span[];
    __shared__ long long warp_before[kWarps];
    __shared__ int warp_bits[kWarps];
    __shared__ int warp_bad[kWarps];
    __shared__ int bins[kHist ? kWarps * 256 : 1];  // a warp's own 256
    __shared__ long long s_end;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const long long t = blockIdx.x;
    a.to_stream(blockIdx.y);
    fe.to_stream(blockIdx.y, a);
    const long long tiles = a.tiles(ITEMS);
    if (t >= tiles) return;
    int* my_bins = bins + (kHist ? warp * 256 : 0);
    if (kHist) zero_bins<kWarps>(bins);

    const long long first = t * kRecords + (long long)tid * ITEMS;
    typename Front::Cursor c = fe.at(first);
    typename Front::State rec[ITEMS];
    int lens[ITEMS];
#pragma unroll
    for (int r = 0; r < ITEMS; r++)
        lens[r] = first + r < a.n ? fe.template next<true>(c, rec[r]) : 0;

    // The bits before this tile: the groups before its own, then the
    // tiles before it in its group (with Front::kStrided every tile before
    // it: launch 1 wrote no group sums).
    const long long mine = a.sums[t];
    const long long group = Front::kStrided ? 0 : t / kWarps;
    const long long ahead = Front::kStrided ? t : group + t % kWarps;
    long long before = 0;
    int bad = 0;
    for (long long u = tid; u < ahead; u += kTile) {
        const long long v =
            a.sums[u < group ? a.n_tiles + u : group * kWarps + u - group];
        if (v < 0) bad = 1; else before += v;
    }
    fe.enter();
#pragma unroll
    for (int r = 0; r < ITEMS; r++)
        if (first + r < a.n) lens[r] = fe.settle(rec[r], lens[r]);
    int sum = 0;
#pragma unroll
    for (int r = 0; r < ITEMS; r++) {
        if (mine < 0) lens[r] = 0;  // a tile with a refused record
        sum += lens[r];  // else every length is one a record may have
    }
    // At most ceil((31 + bits) / 32) + 1 words are owned.
    const int cover = (int)((max(mine, 0ll) + 62) >> 5) + 1;
    for (int k = tid; k < cover; k += kTile) span[k] = 0u;

    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        before += __shfl_xor_sync(0xffffffffu, before, o);
    bad = __any_sync(0xffffffffu, bad);
    if (lane == 31) warp_bits[warp] = incl;
    if (lane == 0) {
        warp_before[warp] = before;
        warp_bad[warp] = bad;
    }
    __syncthreads();
    long long s0 = a.start_bit;
    int excl = incl - sum;
    bad = 0;
#pragma unroll
    for (int k = 0; k < kWarps; k++) {
        s0 += warp_before[k];
        bad |= warp_bad[k];
        if (k < warp) excl += warp_bits[k];
    }
    const long long s1 = s0 + max(mine, 0ll);
    if (t == tiles - 1 && tid == 0)
        *a.total = (bad || mine < 0) ? -1 : s1;
    const long long w0 = t == 0 ? a.start_bit >> 5 : (s0 + 31) >> 5;
    const long long w1 = (s1 + 31) >> 5;
    const int nspan = (int)(w1 - w0);

    long long rs = s0 + excl;
#pragma unroll
    for (int r = 0; r < ITEMS; r++) {
        if (lens[r] > 0)
            emit_owned(fe, rec[r], lens[r], rs, w0, span, nspan);
        rs += lens[r];
    }

    // The last word's bits past this tile's end, from the records that
    // follow, 32 at a time; only their parts of that word land.  Where they
    // run out first, the stream ends in this word, at s1 + got.
    const int need = (int)(32 * w1 - s1);
    if (kHist && tid == 0) s_end = kAll;
    if (tid < 32 && nspan > 0 && need > 0) {
        long long i = min((t + 1) * kRecords, a.n);
        int got = 0;
        while (got < need && i < a.n) {
            i = fe.skip_empty(i);
            typename Front::State so;
            const int len = i + tid < a.n
                ? max(fe.reach_length(i + tid, so), 0) : 0;
            int upto = len;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int up = __shfl_up_sync(0xffffffffu, upto, o);
                if (tid >= o) upto += up;
            }
            const int at = got + upto - len;
            if (len > 0 && at < need) {
                fe.reach_fill(i + tid, so);
                emit_owned(fe, so, len, s1 + at, w0, span, nspan);
            }
            got += __shfl_sync(0xffffffffu, upto, 31);
            i += 32;
        }
        if (kHist && tid == 0 && got < need) s_end = (s1 + got + 7) >> 3;
    }
    __syncthreads();

    const long long hi = min(w1, a.n_words);
    const long long end = kHist ? s_end : kAll;  // the stream's end byte
    if (w0 < hi) {
        const long long a0 = min((w0 + 3) & ~3ll, hi);
        const long long a1 = a0 + ((hi - a0) & ~3ll);
        if (tid < a0 - w0) {
            const uint32_t w = span[tid] | a.prefix_word(w0 + tid);
            a.out[w0 + tid] = w;
            if (kHist) count_bytes(my_bins, w, 4 * (w0 + tid), end);
        }
        if (tid < hi - a1) {
            const uint32_t w = span[a1 + tid - w0] | a.prefix_word(a1 + tid);
            a.out[a1 + tid] = w;
            if (kHist) count_bytes(my_bins, w, 4 * (a1 + tid), end);
        }
        for (long long v = a0 + 4 * tid; v < a1; v += 4 * kTile) {
            const uint32_t* sp = span + (v - w0);
            const uint4 q = make_uint4(
                sp[0] | a.prefix_word(v), sp[1] | a.prefix_word(v + 1),
                sp[2] | a.prefix_word(v + 2), sp[3] | a.prefix_word(v + 3));
            *reinterpret_cast<uint4*>(a.out + v) = q;
            if (kHist) {
                count_bytes(my_bins, q.x, 4 * v, end);
                count_bytes(my_bins, q.y, 4 * v + 4, end);
                count_bytes(my_bins, q.z, 4 * v + 8, end);
                count_bytes(my_bins, q.w, 4 * v + 12, end);
            }
        }
    }
    if (t == 0) {
        const long long head = min(a.start_bit >> 5, a.n_words);
        for (long long w = tid; w < head; w += kTile) {
            a.out[w] = a.prefix_word(w);
            if (kHist) count_bytes(my_bins, a.prefix_word(w), 4 * w, kAll);
        }
    }
    if (kHist) {
        __syncthreads();
        flush_bins<kWarps>(bins, a.hist);
    }
}

// K2's front end from its entry point's arguments, and the number of
// records into *n; false where they are not a stream K2 takes.
bool locals_front(const void* local, const void* lens, long long n_blocks,
                  int lw, const void* mvecs, long long n_frames,
                  long long n_macro, int gop, int mvec_nbits,
                  LocalsFront<true>* fe, long long* n) {
    if (lw < 1 || n_blocks < 0) return false;
    *fe = LocalsFront<true>{};
    fe->local = (const uint32_t*)local;
    fe->lens = (const int32_t*)lens;
    fe->lw = lw;
    *n = n_blocks;
    if (n_macro > 0) {
        if (n_frames < 1 || n_blocks % n_frames || gop < 1 || mvec_nbits < 1
            || mvec_nbits > 16 || n_macro >= (1ll << 31))
            return false;
        fe->mvecs = (const int32_t*)mvecs;
        fe->n_macro = (unsigned)n_macro;
        fe->n_micro = (unsigned)(n_blocks / n_frames);
        fe->gop = gop;
        fe->nbits = mvec_nbits;
        *n += n_frames * n_macro;
    }
    return *n < (1ll << 31);
}

// Records a thread of K2's pack takes: a tile's words (kTile * items * lw
// and three of slack) stay within 16 KB of shared memory where they can;
// 4 a thread measured slower, the CTAs being fewer and longer.
int locals_items(int lw) { return lw <= 8 ? 2 : 1; }

// Records a thread of K4 pack_coeffs takes: a 4x4 block's state is 17
// registers, an 8x8 block's 65.
constexpr int kCoeffsItems4 = 2;
int coeffs_items(int block_size) {
    return block_size == 4 ? kCoeffsItems4 : 1;
}

// Tiles, and the i64 sums launch 1 writes for them.
long long known_tiles(long long n_records, int items) {
    const long long records = (long long)kTile * items;
    return std::max(1ll, (n_records + records - 1) / records);
}

long long known_sums(long long n_records, int items) {
    const long long tiles = known_tiles(n_records, items);
    return tiles + (tiles + kWarps - 1) / kWarps;
}

// K2's two launches for a front end whose records are at most fe.lw words.
template <int ITEMS, class Front>
int launch_known(const Front& fe, KnownOut a, cudaStream_t s) {
    const long long records = (long long)kTile * ITEMS;
    a.n_tiles = known_tiles(a.n, ITEMS);
    const size_t smem = (size_t)(records * fe.lw + 3) * sizeof(uint32_t);
    auto* kernel = a.hist ? pack_known_kernel<ITEMS, Front, true>
                          : pack_known_kernel<ITEMS, Front, false>;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const long long sums_grid = Front::kStrided
        ? a.n_tiles : (a.n_tiles + kWarps - 1) / kWarps;  // tiles or groups
    const unsigned streams = (unsigned)a.n_streams;
    tile_sums_kernel<ITEMS><<<dim3((unsigned)sums_grid, streams), kTile, 0,
                              s>>>(fe, a);
    kernel<<<dim3((unsigned)a.n_tiles, streams), kTile, smem, s>>>(fe, a);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* ie_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// K2.  local: u32 [n_blocks, lw]; lens: i32 [n_blocks]; mvecs: i32
// [P, n_macro, 2], 8-byte aligned, the P-frames' vectors in order, with
// n_frames frames in GOPs of gop and mvec_nbits (1..16) bits a component,
// or n_macro == 0 for block records alone (see LocalsFront).  start_bit,
// prefix, out and total as for K4 below, out not zeroed; sums: i64
// [ie_pack_locals_scratch(records, lw)], scratch that needs no clearing;
// hist: i32 [256], not zeroed, receives the stream's byte histogram, or
// null.  Fewer than 2^31 records.
extern "C" int ie_pack_locals_scratch(long long n_records, int lw) {
    return (int)known_sums(n_records, locals_items(lw));
}

static KnownOut known_out(long long n_streams, long long start_bit,
                   const void* prefix, long long prefix_words, void* out,
                   long long n_words, void* sums, long long sums_stride,
                   void* total, void* hist, const void* starts = nullptr) {
    KnownOut a{};
    a.starts = (const long long*)starts;
    a.n_streams = n_streams;
    a.sums_stride = sums_stride;
    a.start_bit = start_bit;
    a.prefix = (const uint32_t*)prefix;
    a.prefix_words = prefix ? prefix_words : 0;
    a.out = (uint32_t*)out;
    a.n_words = n_words;
    a.sums = (long long*)sums;
    a.total = (long long*)total;
    a.hist = (int32_t*)hist;
    return a;
}

extern "C" int ie_pack_locals(const void* local, const void* lens,
                              long long n_blocks, int lw, const void* mvecs,
                              long long n_frames, long long n_macro, int gop,
                              int mvec_nbits, long long start_bit,
                              const void* prefix, long long prefix_words,
                              void* out, long long n_words, void* sums,
                              void* total, void* hist, void* stream) {
    LocalsFront<true> fe;
    KnownOut a = known_out(1, start_bit, prefix, prefix_words, out, n_words,
                           sums, 0, total, hist);
    if (!locals_front(local, lens, n_blocks, lw, mvecs, n_frames, n_macro,
                      gop, mvec_nbits, &fe, &a.n))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int items = locals_items(lw);
    if (fe.n_macro)
        return items == 2 ? launch_known<2>(fe, a, s)
                          : launch_known<1>(fe, a, s);
    LocalsFront<false> blocks{};  // the image path: no vector records
    blocks.local = fe.local;
    blocks.lens = fe.lens;
    blocks.lw = lw;
    return items == 2 ? launch_known<2>(blocks, a, s)
                      : launch_known<1>(blocks, a, s);
}

// K2 over a batch of n_streams image streams of n_blocks block records
// each: local u32 [n_streams, n_blocks, lw]; lens i32 [n_streams,
// n_blocks].  Every stream starts at start_bit, or with starts (i64
// [n_streams] on the device, not null) at its own, behind the same prefix,
// in its own n_words words of out [n_streams, n_words]; sums: i64
// [n_streams, ie_pack_locals_scratch(n_blocks, lw)]; total: i64
// [n_streams]; hist: i32 [n_streams, 256] or null.  The same two launches
// as one stream's.  The sharded encode packs a rank's segments so, each at
// its final bit phase (parallel/sharding.py).
extern "C" int ie_pack_locals_batch(const void* local, const void* lens,
                                    long long n_blocks, int lw,
                                    long long n_streams, long long start_bit,
                                    const void* starts, const void* prefix,
                                    long long prefix_words, void* out,
                                    long long n_words, void* sums,
                                    void* total, void* hist, void* stream) {
    LocalsFront<true> fe;
    KnownOut a = known_out(n_streams, start_bit, prefix, prefix_words, out,
                           n_words, sums,
                           ie_pack_locals_scratch(n_blocks, lw), total, hist,
                           starts);
    if (n_streams < 1 || n_streams > 65535
        || !locals_front(local, lens, n_blocks, lw, nullptr, 1, 0, 1, 0, &fe,
                         &a.n))
        return (int)cudaErrorInvalidValue;
    LocalsFront<false> blocks{};
    blocks.local = fe.local;
    blocks.lens = fe.lens;
    blocks.lw = lw;
    cudaStream_t s = (cudaStream_t)stream;
    return locals_items(lw) == 2 ? launch_known<2>(blocks, a, s)
                                 : launch_known<1>(blocks, a, s);
}

// K4 pack_records' entry points share their tail: start_bit; prefix, u32
// [prefix_words] OR'd into the first words (the header or dict; may be
// null); out, u32 [n_words], 16-byte aligned, not zeroed: the stream's
// words are written up to its last, the rest is left as it was; scratch,
// u64 [3 + n_tiles] zeroed; edges, u64 [2 * n_tiles]; total, i64 [1]: the
// stream's end bit (start_bit included), or -1 if a record was refused
// (longer than the front end's bound).  A tile is ie_pack_tile() threads of
// 1 to 4 records each, so n_tiles <= ceil(N / ie_pack_tile()).

extern "C" int ie_pack_tile() { return kTile; }

// vals, nbits: i32 [N, F], widths 0..16.
extern "C" int ie_pack_records(const void* vals, const void* nbits,
                               long long n, int f, long long start_bit,
                               const void* prefix, long long prefix_words,
                               void* out, long long n_words, void* scratch,
                               void* edges, void* total, void* stream) {
    const PackOut a = pack_out(n, start_bit, prefix, prefix_words, out,
                               n_words, scratch, edges, total);
    return launch_pack(pack_records_kernel, RecordsFront::kItems, a,
                       16ll * f, (cudaStream_t)stream, (const int32_t*)vals,
                       (const int32_t*)nbits, f);
}

// pack_records over n_segments segments of n records each in one launch:
// vals, nbits i32 [n_segments, n, f]; starts i64 [n_segments] on the
// device, each segment's start bit; out u32 [n_segments, n_words], 16-byte
// aligned rows; total i64 [n_segments]; each segment's scratch (u64,
// zeroed) and edges at strides of scratch_stride and edges_stride words,
// at least 3 + n_tiles and 2 * n_tiles for n records.  No prefix.
extern "C" int ie_pack_records_segments(const void* vals, const void* nbits,
                                        long long n, int f,
                                        long long n_segments,
                                        const void* starts, void* out,
                                        long long n_words, void* scratch,
                                        long long scratch_stride, void* edges,
                                        long long edges_stride, void* total,
                                        void* stream) {
    const PackOut a = pack_out(n, 0, nullptr, 0, out, n_words, scratch,
                               edges, total);
    return launch_pack_streams(
        pack_records_segments_kernel, RecordsFront::kItems, a, 16ll * f,
        n_segments, (cudaStream_t)stream, (const int32_t*)vals,
        (const int32_t*)nbits, f, (const long long*)starts, scratch_stride,
        edges_stride);
}

// K4 pack_payload, K2's two launches (PayloadFront), over
// one stream or a batch of n_streams: words u32 [n_streams, n_in], 16-byte
// aligned, the inner streams (n_in % 4 == 0 where n_streams > 1); table
// i32 [n_streams, ie_dict_table_words()], 8-byte aligned, the dict
// kernel's output (dict_table.cuh): the codes and lengths (<= 16) of the
// bytes, the dict words OR'd in before the start bit (the dict's bits),
// the first byte and the number of the stream's bytes to code; out u32
// [n_streams, n_words], 16-byte aligned rows, not zeroed: each stream's
// words are written up to its last, the rest is left as it was; sums i64
// [n_streams, ie_pack_payload_scratch(n_in)], scratch that needs no
// clearing; total i64 [n_streams]: each stream's end bit (the dict's bits
// included), or -1 if a record was refused.  The grid is sized by the
// records n_in words allow; each stream is bounded by its own table's
// byte count, and a CTA past it leaves at once.  No start_bit or prefix
// argument: both come from the table.
extern "C" int ie_pack_payload_scratch(long long n_in) {
    return (int)known_sums((n_in + 3) / 4, PayloadFront::kItemsOne);
}

extern "C" int ie_pack_payload_batch(const void* words, long long n_in,
                                     const void* table, long long n_streams,
                                     void* out, long long n_words,
                                     void* sums, void* total, void* stream) {
    if (n_streams < 1 || n_streams > 65535 || n_in < 0)
        return (int)cudaErrorInvalidValue;
    PayloadFront fe{};
    fe.words = (const uint32_t*)words;
    fe.n_in = n_in;
    fe.table = (const int32_t*)table;
    KnownOut a = known_out(n_streams, 0, nullptr, 0, out, n_words, sums,
                           ie_pack_payload_scratch(n_in), total, nullptr);
    a.n = (n_in + 3) / 4;
    cudaStream_t s = (cudaStream_t)stream;
    return n_streams > 1 ? launch_known<PayloadFront::kItemsBatch>(fe, a, s)
                         : launch_known<PayloadFront::kItemsOne>(fe, a, s);
}

extern "C" int ie_pack_payload(const void* words, long long n_in,
                               const void* table, void* out,
                               long long n_words, void* sums, void* total,
                               void* stream) {
    return ie_pack_payload_batch(words, n_in, table, 1, out, n_words, sums,
                                 total, stream);
}

// K4 pack_coeffs, K2's two launches.  coeffs: i32 [F, H, W], 16-byte
// aligned, W % 4 == 0; lens: i32 [F, (H / B) * (W / B)], each block's
// record length as K5 and the recon step write it (ie_quantize_image,
// ie_recon_step, with the same use_rle), or null to take them from the
// coefficients; mvecs: i32 [P, n_macro, 2], 8-byte aligned, the vectors of
// the P-frames (f % gop != 0) in order.  Records: F * (n_macro + (H / B) *
// (W / B)), fewer than 2^31; a block record longer than lw words is
// refused.  start_bit, prefix, out and total as for K4 above; sums: i64
// [ie_pack_coeffs_scratch(records, block_size)], scratch that needs no
// clearing; hist: i32 [256], not zeroed, receives the stream's byte
// histogram, or null.
extern "C" int ie_pack_coeffs_scratch(long long n_records, int block_size) {
    return (int)known_sums(n_records, coeffs_items(block_size));
}

extern "C" int ie_pack_coeffs(const void* coeffs, long long frames,
                              long long height, long long width,
                              int block_size, const void* lens,
                              const void* mvecs, long long n_macro, int gop,
                              int mvec_nbits, int use_rle, int lw,
                              long long start_bit, const void* prefix,
                              long long prefix_words, void* out,
                              long long n_words, void* sums, void* total,
                              void* hist, void* stream) {
    if ((block_size != 4 && block_size != 8) || width % 4 || gop < 1
        || lw < 1 || frames < 0 || n_macro < 0
        || (n_macro && (mvec_nbits < 1 || mvec_nbits > 16)))
        return (int)cudaErrorInvalidValue;
    const long long blocks_x = width / block_size;
    const long long n_micro = blocks_x * (height / block_size);
    KnownOut a = known_out(1, start_bit, prefix, prefix_words, out, n_words,
                           sums, 0, total, hist);
    a.n = frames * (n_macro + n_micro);
    if (a.n >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (block_size == 4) {
        const CoeffsFront<4> fe{(const int32_t*)coeffs, (const int32_t*)lens,
                                (const int32_t*)mvecs, width, height * width,
                                (unsigned)blocks_x, (unsigned)n_macro,
                                (unsigned)n_micro, gop, mvec_nbits, use_rle,
                                lw};
        return launch_known<kCoeffsItems4>(fe, a, s);
    }
    const CoeffsFront<8> fe{(const int32_t*)coeffs, (const int32_t*)lens,
                            (const int32_t*)mvecs, width, height * width,
                            (unsigned)blocks_x, (unsigned)n_macro,
                            (unsigned)n_micro, gop, mvec_nbits, use_rle, lw};
    return launch_known<1>(fe, a, s);
}
