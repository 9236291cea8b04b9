// A serial chain walked in parallel: the scheme of D1 (the Huffman
// decode, huffman_decode.cu) and D2 (the offset walk, walk.cu).
//
// A chain is a run of steps through a bit string: the step at a position
// is a pure function of the bits from there (a codeword, or a block
// record) and gives the next position.  The host walks it serially
// (runtime.cpp:956 walk_offsets and :1227 huffman_fsm_decode walk it in
// speculative chunks on CPU threads, with a serial stitch).  Here:
//
//  1. walk:   one thread a chunk of `chunk_bits` bits walks from the
//             chunk's first bit, the wrong place in general, and marks in
//             three bitmaps the positions it stepped from (V), those whose
//             step emitted an item (E) and those it refused (R: a step
//             the true chain of a valid stream never takes, after which
//             the walker tries the next bit).  From the first position
//             it shares with the true chain, the walker IS the true chain
//             up to its next refused position.
//  2. check:  one thread a chunk follows the true chain from the
//             chunk's likely entry, the walker exit of the chunk before:
//             it steps until it lands on a V position, then adopts the
//             walker's steps up to the next R position (counting the
//             items by popcounts of E) or to the walker's exit.  A chunk
//             whose exit differs from the next chunk's likely entry is a
//             break.  A chain that never meets the walker is walked whole.
//  3. stitch: one CTA.  Warp 0 takes the breaks in order; from each it
//             follows the true chain through the chunks after it until
//             an exit equals a walker exit again (one thread, on the card:
//             no host loop, no flag read back).  Then the CTA scans the
//             item counts into each chunk's first item index and the
//             total.
//  4. emit:   one thread a chunk walks the true chain from its entry and
//             writes its items.
//
// A true step that the walker refuses (a block record with a count past
// B*B: a corrupt stream) is stepped over by the check and the stitch, so
// the result is exact for any bits; a stream that never syncs costs a
// serial walk and stays right.  Every read of the bits is bounded by the
// byte count in device memory and reads zero past it.
//
// The chunks start at `start` and are `chunk_bits` long.  A closed chain
// (D1) ends where a step runs past the last bit; an open one (D2) reads
// zeros past it, so its last live chunk runs on until the emitter has
// written `limit` items.  The grid covers `n_max` chunks, a bound the host
// knows; the kernels count the live ones from the byte count.
#pragma once

#include <climits>
#include <cstdint>

#include "bits.cuh"

namespace ie {

constexpr long long kChainEnded = LLONG_MAX / 4;  // past every chunk

// n (at most 25) bits from bit `pos` of d, MSB-first; zero past nbytes.
__device__ __forceinline__ uint32_t bits_at(const uint8_t* d,
                                            long long nbytes, long long pos,
                                            int n) {
    const long long byte = pos >> 3;
    uint32_t w = 0;
#pragma unroll
    for (int i = 0; i < 4; i++) {
        const long long bi = byte + i;
        w = (w << 8) | (bi < nbytes ? (uint32_t)__ldg(d + bi) : 0u);
    }
    return n ? (w << (pos & 7)) >> (32 - n) : 0u;
}

// One step of a chain from a position.
struct ChainStep {
    long long next;   // the position after the step
    long long off;    // D2: where the record's fields start
    uint32_t val;     // D1: the symbol; D2: the record's count
    uint32_t width;   // D2: the record's field width b
    bool emits;       // the step yields an item (a symbol, a record)
    bool valid;       // a walker may take it (else it tries the next bit)
    bool stop;        // the chain ends here (D1: the bits run out)
};

struct ChainGeom {
    long long start, chunk_bits;
    int n_live;
    bool open;

    __device__ __forceinline__ long long lo(int c) const {
        return start + (long long)c * chunk_bits;
    }
    __device__ __forceinline__ long long hi(int c) const {
        return (open && c == n_live - 1) ? LLONG_MAX : lo(c) + chunk_bits;
    }
    __device__ __forceinline__ bool walked(int c) const {
        return c < n_live && !(open && c == n_live - 1);
    }
};

__device__ __forceinline__ ChainGeom chain_geom(long long start,
                                                long long chunk_bits,
                                                long long nbytes,
                                                long long n_max, bool open) {
    const long long span = 8 * nbytes - start;
    long long n = span > 0 ? (span + chunk_bits - 1) / chunk_bits : 0;
    if (open && n < 1) n = 1;
    if (n > n_max) n = n_max;
    return {start, chunk_bits, (int)n, open};
}

// The scratch of n chunks, carved from one int64 buffer.
struct ChainScratch {
    // Per chunk: the walker's exit, its item count and its last refused
    // offset (-1 for none); the true chain's exit, item count and entry;
    // the first item's index.
    long long *wexit, *witems, *wlast, *exit, *items, *entry, *base;
    uint32_t *brk, *whole, *vmap, *emap, *rmap;
    int map_words;  // bitmap words a chunk

    __host__ __device__ static long long words(long long n, int chunk_bits) {
        const long long f = (n + 31) / 32;
        const long long maps = 3 * n * (chunk_bits / 32);
        return 7 * n + f + (maps + 1) / 2;
    }

    __device__ ChainScratch(void* p, long long n, int chunk_bits) {
        long long* q = static_cast<long long*>(p);
        wexit = q;
        witems = q + n;
        wlast = q + 2 * n;
        exit = q + 3 * n;
        items = q + 4 * n;
        entry = q + 5 * n;
        base = q + 6 * n;
        const long long f = (n + 31) / 32;
        map_words = chunk_bits / 32;
        brk = reinterpret_cast<uint32_t*>(q + 7 * n);
        whole = brk + f;
        vmap = whole + f;
        emap = vmap + n * map_words;
        rmap = emap + n * map_words;
    }
};

// Set bits of m in [0, o).
__device__ __forceinline__ long long rank_bits(const uint32_t* m, int o) {
    long long r = 0;
    const int w = o >> 5;
    for (int i = 0; i < w; i++) r += __popc(m[i]);
    if (o & 31) r += __popc(m[w] & ((1u << (o & 31)) - 1u));
    return r;
}

// The first set bit of m at or after o (< n_bits), or -1.
__device__ __forceinline__ int next_bit(const uint32_t* m, int o,
                                        int n_bits) {
    int w = o >> 5;
    uint32_t x = m[w] & (~0u << (o & 31));
    for (;;) {
        if (x) return (w << 5) + __ffs(x) - 1;
        if (++w >= (n_bits >> 5)) return -1;
        x = m[w];
    }
}

// 1. The speculative walk of chunk c from its first bit.
template <class Walk>
__device__ void chain_walk(const Walk& w, const ChainGeom& g,
                           const ChainScratch& s, int c) {
    if (!g.walked(c)) return;
    const int nw = s.map_words;
    uint32_t* V = s.vmap + (size_t)c * nw;
    uint32_t* E = s.emap + (size_t)c * nw;
    uint32_t* R = s.rmap + (size_t)c * nw;
    const long long lo = g.lo(c), end = lo + g.chunk_bits;
    long long pos = lo, items = 0, last = -1;
    int cur = 0;
    uint32_t v = 0, e = 0, r = 0;
    while (pos < end) {
        const int wi = (int)((pos - lo) >> 5);
        for (; cur < wi; cur++) {  // positions only grow: each word once
            V[cur] = v; E[cur] = e; R[cur] = r;
            v = e = r = 0;
        }
        const ChainStep st = w.step(pos);
        if (st.stop) {
            pos = kChainEnded;
            break;
        }
        const uint32_t bit = 1u << ((pos - lo) & 31);
        if (!st.valid) {
            r |= bit;
            last = pos - lo;
            pos++;
            continue;
        }
        v |= bit;
        if (st.emits) {
            e |= bit;
            items++;
        }
        pos = st.next;
    }
    for (; cur < nw; cur++) {
        V[cur] = v; E[cur] = e; R[cur] = r;
        v = e = r = 0;
    }
    s.wexit[c] = pos;
    s.witems[c] = items;
    s.wlast[c] = last;
}

struct ChainFollow {
    long long exit, items;
    bool whole;  // stepped, and never met the walker
};

// The true chain through chunk c from `entry` (>= the chunk's first bit).
template <class Walk>
__device__ ChainFollow chain_follow(const Walk& w, const ChainGeom& g,
                                    const ChainScratch& s, int c,
                                    long long entry) {
    const int nb = (int)g.chunk_bits;
    const uint32_t* V = s.vmap + (size_t)c * s.map_words;
    const uint32_t* E = s.emap + (size_t)c * s.map_words;
    const uint32_t* R = s.rmap + (size_t)c * s.map_words;
    const long long lo = g.lo(c), hi = g.hi(c), end = lo + nb;
    long long pos = entry, items = 0, steps = 0;
    bool adopted = false;
    while (pos < hi) {
        if (pos < end) {
            const int o = (int)(pos - lo);
            if ((V[o >> 5] >> (o & 31)) & 1u) {
                // The walker stepped from here: its steps are the true
                // chain's up to its next refusal, or to its exit.  Past
                // its last refusal (the usual case: a walker refuses
                // only before it meets the true chain) no bitmap is
                // scanned but E's words before o.
                adopted = true;
                const int q = o > s.wlast[c] ? -1 : next_bit(R, o, nb);
                if (q < 0) {
                    items += s.witems[c] - rank_bits(E, o);
                    pos = s.wexit[c];
                    break;
                }
                items += rank_bits(E, q) - rank_bits(E, o);
                pos = lo + q;  // the true chain takes the refused step
            }
        }
        const ChainStep st = w.step(pos);
        if (st.stop) {
            pos = kChainEnded;
            break;
        }
        items += st.emits;
        pos = st.next;
        steps++;
    }
    return {pos, items, !adopted && steps > 0};
}

// 2. The true chain through chunk c from its likely entry; a warp's
// chunks write their break and walked-whole flags as one word each.
template <class Walk>
__device__ void chain_check(const Walk& w, const ChainGeom& g,
                            const ChainScratch& s, int c, long long n_max) {
    bool brk = false, whole = false;
    if (c < g.n_live) {
        const long long h = c == 0 ? g.start : s.wexit[c - 1];
        s.entry[c] = h;
        s.exit[c] = h;
        s.items[c] = 0;
        if (g.walked(c)) {
            const ChainFollow f = chain_follow(w, g, s, c, h);
            s.exit[c] = f.exit;
            s.items[c] = f.items;
            whole = f.whole;
            brk = c + 1 < g.n_live && f.exit != s.wexit[c];
        }
    }
    const uint32_t bb = __ballot_sync(~0u, brk);
    const uint32_t wb = __ballot_sync(~0u, whole);
    if ((threadIdx.x & 31) == 0 && c < n_max) {
        s.brk[c >> 5] = bb;
        s.whole[c >> 5] = wb;
    }
}

// From the break after chunk c: the true chain through the chunks after
// it until it meets a walker exit again; returns the last chunk it
// walked.
template <class Walk>
__device__ int chain_resolve(const Walk& w, const ChainGeom& g,
                             const ChainScratch& s, int c) {
    long long entry = s.exit[c];
    for (int d = c + 1;; d++) {
        s.entry[d] = entry;
        if (!g.walked(d)) return d;  // the open last chunk: the emitter's
        const ChainFollow f = chain_follow(w, g, s, d, entry);
        s.exit[d] = f.exit;
        s.items[d] = f.items;
        const uint32_t bit = 1u << (d & 31);
        s.whole[d >> 5] = f.whole ? (s.whole[d >> 5] | bit)
                                  : (s.whole[d >> 5] & ~bit);
        if (d == g.n_live - 1 || f.exit == s.wexit[d]) return d;
        entry = f.exit;
    }
}

// 3. One CTA: the breaks in order, then each chunk's first item index
// and, where given, the total and the stats (chunks, chunks walked
// whole).
template <class Walk>
__device__ void chain_stitch(const Walk& w, const ChainGeom& g,
                             const ChainScratch& s, long long* total,
                             long long* stats) {
    __shared__ long long warp_sums[32];
    const int n = g.n_live;
    const int nf = (n + 31) >> 5;
    if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        int resolved = -1;
        for (int g0 = 0; g0 < nf; g0 += 32) {
            const uint32_t word = g0 + lane < nf ? s.brk[g0 + lane] : 0u;
            uint32_t lanes = __ballot_sync(~0u, word != 0);
            while (lanes) {
                const int l = __ffs(lanes) - 1;
                lanes &= lanes - 1;
                uint32_t bits = __shfl_sync(~0u, word, l);
                while (bits) {
                    const int c = ((g0 + l) << 5) + __ffs(bits) - 1;
                    bits &= bits - 1;
                    if (c <= resolved) continue;  // walked in a cascade
                    if (lane == 0) resolved = chain_resolve(w, g, s, c);
                    resolved = __shfl_sync(~0u, resolved, 0);
                }
            }
        }
    }
    __syncthreads();
    const int per = (n + (int)blockDim.x - 1) / (int)blockDim.x;
    const int c0 = min((int)threadIdx.x * per, n), c1 = min(c0 + per, n);
    long long sum = 0, whole = 0;
    for (int c = c0; c < c1; c++) {
        sum += s.items[c];
        whole += (s.whole[c >> 5] >> (c & 31)) & 1u;
    }
    const long long first = block_exclusive_scan(sum, warp_sums);
    __syncthreads();
    const long long whole_before = block_exclusive_scan(whole, warp_sums);
    long long run = first;
    for (int c = c0; c < c1; c++) {
        s.base[c] = run;
        run += s.items[c];
    }
    if (threadIdx.x == blockDim.x - 1) {
        if (total != nullptr) *total = first + sum;
        if (stats != nullptr) {
            stats[0] = n;
            stats[1] = whole_before + whole;
        }
    }
}

// 4. Chunk c's items from its true entry, at most up to index `limit`.
template <class Walk, class Sink>
__device__ void chain_emit(const Walk& w, const ChainGeom& g,
                           const ChainScratch& s, int c, long long limit,
                           Sink sink) {
    if (c >= g.n_live) return;
    long long pos = s.entry[c], idx = s.base[c];
    const long long hi = g.hi(c);
    while (pos < hi && idx < limit) {
        const ChainStep st = w.step(pos);
        if (st.stop) break;
        if (st.emits) sink(idx++, st);
        pos = st.next;
    }
}

constexpr int kChainThreads = 128;   // walk, check and emit: a chunk a thread
constexpr int kStitchThreads = 512;  // the stitch: one CTA

}  // namespace ie
