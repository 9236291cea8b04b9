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
//             the walker tries the next bit, or after 32 in a row skips
//             256 bits).  From the first position it shares with the
//             true chain, the walker IS the true chain up to its next
//             refused position.
//  2. check:  one thread a chunk follows the true chain from the
//             chunk's likely entry, the walker exit of the chunk before:
//             it steps until it lands on a V position, then adopts the
//             walker's steps up to the next R position (counting the
//             items by popcounts of E) or to the walker's exit.  A chunk
//             whose exit differs from the next chunk's likely entry is a
//             break.  A chain that never meets the walker is walked whole.
//             A warp writes its chunks' item sum, a CTA its chunks'.
//  3. stitch: one CTA.  Warp 0 sweeps the chain in order (one thread
//             follows, on the card: no host loop, no flag read back).  A
//             warp scan of the chunks' counts and break flags, 32 chunks
//             or 32 groups of 32 at a time, finds the next event: a break,
//             or, for a chain with jumps (D2 over a video: after a
//             frame's last record the true chain skips the next P-frame's
//             vector block, which only an item's index tells), the chunk
//             in which the item count reaches the next jump.  There the
//             true chain is walked to the item before the jump (a select
//             over E) and jumps, or the break's exit is taken, and the
//             chain re-enters the chunks after until it enters one where
//             the check did; a chunk jumped over whole is written by the
//             whole warp.  Then the CTA scans the CTAs' sums into each
//             CTA's first item index and the total.
//  4. emit:   one thread a chunk walks the true chain from its entry and
//             writes its items, their indices from a scan of its CTA's
//             counts (and takes the jumps, which it knows by the items'
//             indices).
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

constexpr int kChainThreads = 128;   // walk, check and emit: a chunk a thread
constexpr int kStitchThreads = 512;  // the stitch: one CTA
constexpr long long kNever = LLONG_MAX;  // no further jump
constexpr int kSkipAfter = 32;  // a walker's refusals in a row before it
constexpr int kSkipBits = 256;  // leaves this many bits untried

// The scratch of n chunks, carved from one int64 buffer.
struct ChainScratch {
    // Per chunk: the walker's exit, its item count and its last refused
    // offset (-1 for none); the true chain's exit, item count and entry.
    // Per group of 32 chunks (a warp's) and per CTA of the walk's grid:
    // the item counts' sums; per CTA its first item's index.
    long long *wexit, *witems, *wlast, *exit, *items, *entry, *gsum, *csum,
        *cbase;
    uint32_t *brk, *whole, *vmap, *emap, *rmap;
    int map_words;  // bitmap words a chunk

    __host__ __device__ static long long words(long long n, int chunk_bits) {
        const long long f = (n + 31) / 32;
        const long long nc = (n + kChainThreads - 1) / kChainThreads;
        const long long maps = 3 * n * (chunk_bits / 32);
        return 6 * n + 2 * f + 2 * nc + (maps + 1) / 2;
    }

    __device__ ChainScratch(void* p, long long n, int chunk_bits) {
        long long* q = static_cast<long long*>(p);
        wexit = q;
        witems = q + n;
        wlast = q + 2 * n;
        exit = q + 3 * n;
        items = q + 4 * n;
        entry = q + 5 * n;
        const long long f = (n + 31) / 32;
        const long long nc = (n + kChainThreads - 1) / kChainThreads;
        gsum = q + 6 * n;
        csum = gsum + f;
        cbase = csum + nc;
        map_words = chunk_bits / 32;
        brk = reinterpret_cast<uint32_t*>(cbase + nc);
        whole = brk + f;
        vmap = whole + f;
        emap = vmap + n * map_words;
        rmap = emap + n * map_words;
    }

    // Chunk d's item count, its group's and its CTA's sums with it (one
    // thread at a time: the stitch's).
    __device__ void set_items(int d, long long v) const {
        const long long delta = v - items[d];
        items[d] = v;
        gsum[d >> 5] += delta;
        csum[d / kChainThreads] += delta;
    }

    __device__ void set_whole(int d, bool w) const {
        const uint32_t bit = 1u << (d & 31);
        whole[d >> 5] = w ? (whole[d >> 5] | bit) : (whole[d >> 5] & ~bit);
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

// The position of set bit r (from 0) of m (< n_bits), or -1.
__device__ __forceinline__ int select_bit(const uint32_t* m, long long r,
                                          int n_bits) {
    for (int w = 0; w < (n_bits >> 5); w++) {
        uint32_t x = m[w];
        const int pc = __popc(x);
        if (r < pc) {
            for (; r > 0; r--) x &= x - 1;
            return (w << 5) + __ffs(x) - 1;
        }
        r -= pc;
    }
    return -1;
}

__device__ __forceinline__ long long warp_inclusive_scan(long long v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const long long t = __shfl_up_sync(~0u, v, o);
        if (lane >= o) v += t;
    }
    return v;
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
    int cur = 0, refused = 0;
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
            // Bits no valid stream holds here (a P-frame's vectors read as
            // records): after kSkipAfter refusals in a row the walker
            // leaves kSkipBits untried.  The true chain takes a refused
            // step itself, so any skip keeps the result exact.
            r |= bit;
            last = pos - lo;
            pos += ++refused < kSkipAfter ? 1 : kSkipBits;
            if (refused == kSkipAfter) refused = 0;
            continue;
        }
        refused = 0;
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

// The position after the k-th (k >= 1) item of the true chain from `pos`
// in chunk c, an item that starts in the chunk: as chain_follow, with the
// walker's items counted by E's bits and the k-th found by a select.
template <class Walk>
__device__ long long chain_locate(const Walk& w, const ChainGeom& g,
                                  const ChainScratch& s, int c,
                                  long long pos, long long k) {
    const int nb = (int)g.chunk_bits;
    const uint32_t* V = s.vmap + (size_t)c * s.map_words;
    const uint32_t* E = s.emap + (size_t)c * s.map_words;
    const uint32_t* R = s.rmap + (size_t)c * s.map_words;
    const long long lo = g.lo(c), end = lo + nb;
    for (;;) {
        if (pos < end) {
            const int o = (int)(pos - lo);
            if ((V[o >> 5] >> (o & 31)) & 1u) {
                const int q = o > s.wlast[c] ? -1 : next_bit(R, o, nb);
                const long long r0 = rank_bits(E, o);
                const long long avail = rank_bits(E, q < 0 ? nb : q) - r0;
                if (k <= avail)
                    return w.step(lo + select_bit(E, r0 + k - 1, nb)).next;
                k -= avail;
                pos = q < 0 ? s.wexit[c] : lo + q;
                if (q < 0) continue;
            }
        }
        const ChainStep st = w.step(pos);
        if (st.stop) return kChainEnded;
        pos = st.next;
        if (st.emits && --k == 0) return pos;
    }
}

// 2. The true chain through chunk c from its likely entry; a warp's
// chunks write their break and walked-whole flags as one word each, and
// their item counts' sum; a CTA its chunks' sum.
template <class Walk>
__device__ void chain_check(const Walk& w, const ChainGeom& g,
                            const ChainScratch& s, int c, long long n_max) {
    __shared__ long long cta_sums[kChainThreads / 32];
    bool brk = false, whole = false;
    long long items = 0;
    if (c < g.n_live) {
        const long long h = c == 0 ? g.start : s.wexit[c - 1];
        s.entry[c] = h;
        s.exit[c] = h;
        if (g.walked(c)) {
            const ChainFollow f = chain_follow(w, g, s, c, h);
            s.exit[c] = f.exit;
            items = f.items;
            whole = f.whole;
            brk = c + 1 < g.n_live && f.exit != s.wexit[c];
        }
    }
    if (c < n_max) s.items[c] = items;
    const uint32_t bb = __ballot_sync(~0u, brk);
    const uint32_t wb = __ballot_sync(~0u, whole);
    long long sum = items;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(~0u, sum, o);
    if ((threadIdx.x & 31) == 0) {
        if (c < n_max) {
            s.brk[c >> 5] = bb;
            s.whole[c >> 5] = wb;
            s.gsum[c >> 5] = sum;
        }
        cta_sums[threadIdx.x >> 5] = sum;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        long long t = 0;
        for (int i = 0; i < kChainThreads / 32; i++) t += cta_sums[i];
        s.csum[blockIdx.x] = t;
    }
}

// No jumps: a chain whose steps are all pure functions of the bits.
struct NoJumps {
    __device__ long long first() const { return kNever; }
    __device__ long long next(long long) const { return kNever; }
    __device__ long long bits(long long) const { return 0; }
};

// From chunk c, whose entry is the true chain's and whose counts are
// those of the chain from there without a jump, with `base` items before
// it (warp-uniform): the first chunk at or after c that is not walked,
// that a break ends (its exit is not the next chunk's recorded entry), or
// in which the item count reaches `jump` (the item before a jump ends in
// it).  A warp tests 32 chunks at once, and 32 groups of 32 at once by
// their sums and break words; c and base come back for that chunk.
__device__ __forceinline__ void chain_next_event(const ChainGeom& g,
                                                 const ChainScratch& s,
                                                 int& c, long long& base,
                                                 long long jump) {
    const int lane = threadIdx.x & 31;
    const int n_groups = (g.n_live + 31) >> 5;
    for (;;) {
        // The chunks of c's group from c.
        const int g0 = c >> 5;
        const int cc = (g0 << 5) + lane;
        const bool in = cc >= c, live = g.walked(cc);
        const long long n = in && live ? s.items[cc] : 0;
        const uint32_t bw = g0 < n_groups ? s.brk[g0] : 0u;
        const long long inc = warp_inclusive_scan(n);
        uint32_t hit = __ballot_sync(
            ~0u, in && (!live || ((bw >> lane) & 1u) || base + inc >= jump));
        if (hit) {
            const int l = __ffs(hit) - 1;
            base += __shfl_sync(~0u, inc - n, l);
            c = (g0 << 5) + l;
            return;
        }
        base += __shfl_sync(~0u, inc, 31);
        c = (g0 + 1) << 5;
        // Whole groups from there.
        for (;;) {
            const int gg = (c >> 5) + lane;
            const bool full = g.walked((gg << 5) + 31);  // all 32 walked
            const long long m = full ? s.gsum[gg] : 0;
            const long long inc2 = warp_inclusive_scan(m);
            const bool brk = full && s.brk[gg] != 0u;
            hit = __ballot_sync(~0u, !full || brk || base + inc2 >= jump);
            if (hit) {
                const int l = __ffs(hit) - 1;
                base += __shfl_sync(~0u, inc2 - m, l);
                c = ((c >> 5) + l) << 5;
                break;  // to that group's chunks
            }
            base += __shfl_sync(~0u, inc2, 31);
            c += 32 * 32;
        }
    }
}

// The true chain through chunk d from `e`, with `bd` items before it,
// taking the jumps it reaches (the next at item count `jump`, advanced);
// d's entry, exit, count and walked-whole flag are set.  Returns the
// exit.
template <class Walk, class Jumps>
__device__ long long chain_fix(const Walk& w, const ChainGeom& g,
                               const ChainScratch& s, const Jumps& jumps,
                               int d, long long e, long long bd,
                               long long& jump) {
    s.entry[d] = e;
    long long pos = e, idx = bd;
    bool whole = false;
    while (pos < g.hi(d)) {
        const ChainFollow f = chain_follow(w, g, s, d, pos);
        if (idx + f.items < jump) {
            idx += f.items;
            pos = f.exit;
            whole = f.whole;
            break;
        }
        pos = chain_locate(w, g, s, d, pos, jump - idx) + jumps.bits(jump);
        idx = jump;
        jump = jumps.next(jump);
    }
    s.set_items(d, idx - bd);
    s.exit[d] = pos;
    s.set_whole(d, whole);
    return pos;
}

// Chunks [d, dz) that the true chain jumps over whole, entered at e past
// their end: no item, entry and exit e.  The warp writes 32 at a time.
__device__ __forceinline__ void chain_skip(const ChainScratch& s, int d,
                                          int dz, long long e) {
    for (int x = d + (int)(threadIdx.x & 31); x < dz; x += 32) {
        const long long delta = -s.items[x];
        s.items[x] = 0;
        s.entry[x] = e;
        s.exit[x] = e;
        atomicAnd(&s.whole[x >> 5], ~(1u << (x & 31)));
        atomicAdd(reinterpret_cast<unsigned long long*>(&s.gsum[x >> 5]),
                  (unsigned long long)delta);
        atomicAdd(reinterpret_cast<unsigned long long*>(
                      &s.csum[x / kChainThreads]),
                  (unsigned long long)delta);
    }
    __syncwarp();
}

// 3. One CTA.  Warp 0 sweeps the chunks in order from the chain's start:
// a warp scan finds the next event (chain_next_event); at a jump the true
// chain is walked to the item before it and jumps; at a break its exit
// is taken; either way the chain then re-enters the chunks after until it
// enters one at the position recorded there, from where the recorded
// chain stands (chunks it jumps over whole are written by the warp at
// once).  Only the chunks between an event and that meeting are written,
// each count's group and CTA sums with it.  Then the CTA scans the CTAs'
// sums into each one's first item index and, where given, the total and
// the stats (chunks, chunks walked whole).
template <class Walk, class Jumps = NoJumps>
__device__ void chain_stitch(const Walk& w, const ChainGeom& g,
                             const ChainScratch& s, long long* total,
                             long long* stats, const Jumps& jumps = {}) {
    __shared__ long long warp_sums[32];
    if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        long long jump = jumps.first(), base = 0;
        int c = 0;
        for (;;) {
            chain_next_event(g, s, c, base, jump);
            if (!g.walked(c)) break;
            long long e = 0;
            if (lane == 0) {
                e = base + s.items[c] >= jump
                    ? chain_fix(w, g, s, jumps, c, s.entry[c], base, jump)
                    : s.exit[c];
                base += s.items[c];
            }
            e = __shfl_sync(~0u, e, 0);
            base = __shfl_sync(~0u, base, 0);
            jump = __shfl_sync(~0u, jump, 0);
            int d = c + 1;
            // Every lane reads d's entry before lane 0 may write it: the
            // condition is lane 0's, broadcast.
            while (__shfl_sync(~0u, g.walked(d) && e != s.entry[d], 0)) {
                if (e >= g.hi(d)) {  // to the chunk e lies in
                    const long long z = (e - g.start) / g.chunk_bits;
                    const int dz = (int)(z < g.n_live ? z : g.n_live);
                    chain_skip(s, d, dz, e);
                    d = dz;
                    continue;
                }
                if (lane == 0) {
                    e = chain_fix(w, g, s, jumps, d, e, base, jump);
                    base += s.items[d];
                }
                __syncwarp();
                e = __shfl_sync(~0u, e, 0);
                base = __shfl_sync(~0u, base, 0);
                jump = __shfl_sync(~0u, jump, 0);
                d++;
            }
            if (!g.walked(d)) {
                if (lane == 0 && d < g.n_live) s.entry[d] = e;  // open
                break;
            }
            c = d;
        }
    }
    __syncthreads();
    const int nc = (g.n_live + kChainThreads - 1) / kChainThreads;
    const int per = (nc + (int)blockDim.x - 1) / (int)blockDim.x;
    const int c0 = min((int)threadIdx.x * per, nc), c1 = min(c0 + per, nc);
    long long sum = 0;
    for (int b = c0; b < c1; b++) sum += s.csum[b];
    long long run = block_exclusive_scan(sum, warp_sums);
    for (int b = c0; b < c1; b++) {
        s.cbase[b] = run;
        run += s.csum[b];
    }
    if (threadIdx.x == blockDim.x - 1 && total != nullptr) *total = run;
    if (stats != nullptr) {
        __syncthreads();
        const int nf = (g.n_live + 31) >> 5;
        long long whole = 0;
        for (int i = threadIdx.x; i < nf; i += blockDim.x)
            whole += __popc(s.whole[i]);
        whole += block_exclusive_scan(whole, warp_sums);
        if (threadIdx.x == blockDim.x - 1) {
            stats[0] = g.n_live;
            stats[1] = whole;
        }
    }
}

// The index of chunk c's first item, from its CTA's first index and a
// scan of the CTA's counts; every thread of the CTA calls it.
__device__ __forceinline__ long long chain_base(const ChainGeom& g,
                                                const ChainScratch& s,
                                                int c) {
    __shared__ long long warp_sums[32];
    const long long n = c < g.n_live ? s.items[c] : 0;
    return s.cbase[blockIdx.x] + block_exclusive_scan(n, warp_sums);
}

// 4. Chunk c's items from its true entry, at most up to index `limit`;
// every thread of the CTA calls it.
template <class Walk, class Sink>
__device__ void chain_emit(const Walk& w, const ChainGeom& g,
                           const ChainScratch& s, int c, long long limit,
                           Sink sink) {
    if ((long long)blockIdx.x * blockDim.x >= g.n_live) return;
    long long idx = chain_base(g, s, c);
    if (c >= g.n_live) return;
    long long pos = s.entry[c];
    const long long hi = g.hi(c);
    while (pos < hi && idx < limit) {
        const ChainStep st = w.step(pos);
        if (st.stop) break;
        if (st.emits) sink(idx++, st);
        pos = st.next;
    }
}

}  // namespace ie
