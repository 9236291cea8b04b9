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
//  3. rounds: D1 only: up to kMaxRounds launches of one thread a chunk:
//             chunk d takes as its entry the exit chunk d - 1 had after
//             the round before and, where that differs from its recorded
//             entry, follows the true chain again from there.  A break
//             moves one chunk a round; a round after one that moved no
//             exit returns at once (a flag word on the device: the host
//             reads nothing).  Huffman codes mostly resynchronize within a
//             chunk or two, so on images a few rounds leave no break.
//  4. table:  D1 only, for a chain without jumps whose steps are at most
//             max_step < kTabEntries bits (a code of at most 15 bits), and
//             only where the rounds left a break.  Every chunk's true
//             entry lies in its first max_step bits, so one thread a
//             (chunk, entry offset) follows the chunk from each offset,
//             and the chunk becomes a map of entry offsets to exit offsets
//             (one nibble each, 16 in a word, the last the ended chain); a
//             warp scans its 32 chunks' maps, one CTA the warps'
//             composites, and one thread a chunk applies them from chunk
//             0's entry.  Exact for any bits: no break is left.  Where
//             chains never resynchronize (a run of one codeword, met out
//             of phase) a round moves the true chain only one chunk on;
//             the table does not care.
//  5. sweep:  D2 only, one warp, where the check left a break or the
//             chain jumps (on the card: no host loop, no flag read back).
//             A warp scan of the chunks' counts and break flags, 32 chunks
//             or 32 groups of 32 at a time, finds the next event: a break,
//             or, for a chain with jumps (D2 over a video: after a frame's
//             last record the true chain skips the next P-frame's vector
//             block, which only an item's index tells), the chunk in which
//             the item count reaches the next jump.  There the warp walks
//             the true chain to the item before the jump (a select over E)
//             and jumps, or takes the break's exit, and the chain
//             re-enters the chunks after until it enters one where the
//             check did; the warp searches the bitmaps 32 words at a time,
//             and writes a chunk jumped over whole at once.
//  6. scan:   one CTA scans the CTAs' sums into each CTA's first item
//             index and the total.
//  7. emit:   one thread a chunk walks the true chain from its entry and
//             writes its items, their indices from a scan of its CTA's
//             counts (chain_base; D2 takes the jumps, which it knows by
//             the items' indices; D1 gathers a CTA's symbols in shared
//             memory and stores them together).
//
// A true step that the walker refuses (a block record with a count past
// B*B: a corrupt stream) is stepped over by the check and the sweep, so
// the result is exact for any bits; a stream that never syncs
// costs a serial walk and stays right.  Every read of the bits is bounded
// by the byte count in device memory and reads zero past it.
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

constexpr int kChainThreads = 128;   // walk, check, rounds, emit: a
                                     // chunk a thread
constexpr int kStitchThreads = 512;  // the stitch, the table's top: one CTA
constexpr int kSweepThreads = 32;    // D2's stitch: one warp (with 512
                                     // threads ptxas held the sweep to 64
                                     // registers, and it spilled)
constexpr int kMaxRounds = 32;       // round launches a call, at most
constexpr int kTabThreads = 512;     // the table: 32 chunks x 16 offsets
constexpr int kTabEntries = 16;      // entry offsets a chunk's map holds
constexpr int kTabEnded = 15;        // the map's state of an ended chain
constexpr unsigned long long kMapIdentity = 0xFEDCBA9876543210ull;
constexpr long long kNever = LLONG_MAX;  // no further jump
constexpr int kSkipAfter = 32;  // a walker's refusals in a row before it
constexpr int kSkipBits = 256;  // leaves this many bits untried

// What the scan writes where the caller gives a `stats` tensor: the int64
// entries in this order (a shorter tensor takes the first ones).
enum ChainStat {
    kStatChunks,        // live chunks
    kStatWhole,         // chunks the true chain walked whole
    kStatSweepBreaks,   // breaks the sweep fixed (D2)
    kStatRewalked,      // chunks the sweep walked again (chain_fix)
    kStatSkipped,       // chunks the sweep jumped over whole (chain_skip)
    kStatTurns,         // turns of chain_next_event's scans
    kStatJumps,         // jumps taken
    kStatRounds,        // rounds that changed a chunk (D1)
    kStatLongestRun,    // most chunks walked again or skipped after an event
    kStatBreaksLeft,    // 1 where the rounds (D2: the check) left a break:
                        // D1's table ran, D2's sweep fixed it
    kNumStats
};

// The scratch of n chunks, carved from one int64 buffer.
struct ChainScratch {
    // Per chunk: the walker's exit, its item count and its last refused
    // offset (-1 for none); the true chain's exit (two buffers: round r
    // reads one and writes the other), item count and entry.  Per group
    // of 32 chunks (a warp's) and per CTA of the walk's grid: the item
    // counts' sums; per CTA its first item's index.  A flag word a round
    // (0: the check): whether it moved an exit.
    long long *wexit, *witems, *wlast, *exit, *exit_b, *items, *entry, *gsum,
        *csum, *cbase, *flags;
    uint32_t *brk, *whole, *vmap, *emap, *rmap;
    int map_words;  // bitmap words a chunk
    // D1's table (4), last (D2's scratch ends before it, and D2 never
    // touches these): per (chunk, entry offset) the exit offset, walked
    // whole and the item count; per chunk its warp's scan of the maps, per
    // warp of chunks the composite (then the entry offset of its first).
    uint8_t *tnext, *twhole;
    int32_t* titems;
    unsigned long long *tmap, *tagg;

    // The words of n chunks, with the table's (D1) or without (D2).
    __host__ __device__ static long long words(long long n, int chunk_bits,
                                               bool with_table) {
        const long long f = (n + 31) / 32;
        const long long nc = (n + kChainThreads - 1) / kChainThreads;
        const long long maps = 3 * n * (chunk_bits / 32);
        const long long table = n * kTabEntries / 2 + n + f +  // titems ...
                                (2 * n * kTabEntries + 7) / 8;  // ... twhole
        return 7 * n + 2 * f + 2 * nc + (kMaxRounds + 1) + (maps + 1) / 2 +
               (with_table ? table : 0);
    }

    __device__ ChainScratch(void* p, long long n, int chunk_bits) {
        long long* q = static_cast<long long*>(p);
        wexit = q;
        witems = q + n;
        wlast = q + 2 * n;
        exit = q + 3 * n;
        items = q + 4 * n;
        entry = q + 5 * n;
        exit_b = q + 6 * n;
        const long long f = (n + 31) / 32;
        const long long nc = (n + kChainThreads - 1) / kChainThreads;
        gsum = q + 7 * n;
        csum = gsum + f;
        cbase = csum + nc;
        flags = cbase + nc;
        map_words = chunk_bits / 32;
        brk = reinterpret_cast<uint32_t*>(flags + kMaxRounds + 1);
        whole = brk + f;
        vmap = whole + f;
        emap = vmap + n * map_words;
        rmap = emap + n * map_words;
        long long* tab = q + 7 * n + 2 * f + 2 * nc + (kMaxRounds + 1) +
                         (3 * n * map_words + 1) / 2;
        tmap = reinterpret_cast<unsigned long long*>(tab);
        tagg = tmap + n;
        titems = reinterpret_cast<int32_t*>(tagg + f);
        tnext = reinterpret_cast<uint8_t*>(titems + n * kTabEntries);
        twhole = tnext + n * kTabEntries;
    }

    // The exits after round r (0: the check's).
    __device__ long long* exits(int r) const { return (r & 1) ? exit_b : exit; }

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

__device__ __forceinline__ long long warp_inclusive_scan(long long v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const long long t = __shfl_up_sync(~0u, v, o);
        if (lane >= o) v += t;
    }
    return v;
}

// The bitmap searches of one thread (the walk, the check, the rounds, the
// table).
struct Solo {
    // Set bits of m in [0, o).
    __device__ static long long rank(const uint32_t* m, int o) {
        long long r = 0;
        const int w = o >> 5;
        for (int i = 0; i < w; i++) r += __popc(m[i]);
        if (o & 31) r += __popc(m[w] & ((1u << (o & 31)) - 1u));
        return r;
    }

    // The first set bit of m at or after o (< n_bits), or -1.
    __device__ static int next(const uint32_t* m, int o, int n_bits) {
        int w = o >> 5;
        uint32_t x = m[w] & (~0u << (o & 31));
        for (;;) {
            if (x) return (w << 5) + __ffs(x) - 1;
            if (++w >= (n_bits >> 5)) return -1;
            x = m[w];
        }
    }

    // The position of set bit r (from 0) of m (< n_bits), or -1.
    __device__ static int select(const uint32_t* m, long long r,
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
};

// The same searches by the 32 lanes of a warp, 32 words a turn; every
// lane calls them with the same arguments and gets the result (the
// stitch's sweep: the warp follows the true chain together, and lane 0
// writes).
struct Warp {
    __device__ static bool leader() { return (threadIdx.x & 31) == 0; }

    __device__ static long long rank(const uint32_t* m, int o) {
        const int lane = threadIdx.x & 31, w = o >> 5;
        long long r = 0;
        for (int i = lane; i < w; i += 32) r += __popc(m[i]);
        if (lane == 0 && (o & 31))
            r += __popc(m[w] & ((1u << (o & 31)) - 1u));
#pragma unroll
        for (int k = 16; k > 0; k >>= 1) r += __shfl_xor_sync(~0u, r, k);
        return r;
    }

    __device__ static int next(const uint32_t* m, int o, int n_bits) {
        const int lane = threadIdx.x & 31, nw = n_bits >> 5;
        for (int w0 = o >> 5; w0 < nw; w0 += 32) {
            const int w = w0 + lane;
            uint32_t x = w < nw ? m[w] : 0u;
            if (w == (o >> 5)) x &= ~0u << (o & 31);
            const uint32_t hit = __ballot_sync(~0u, x != 0u);
            if (hit) {
                const int l = __ffs(hit) - 1;
                const uint32_t xl = __shfl_sync(~0u, x, l);
                return ((w0 + l) << 5) + __ffs(xl) - 1;
            }
        }
        return -1;
    }

    __device__ static int select(const uint32_t* m, long long r,
                                 int n_bits) {
        const int lane = threadIdx.x & 31, nw = n_bits >> 5;
        for (int w0 = 0; w0 < nw; w0 += 32) {
            const int w = w0 + lane;
            const uint32_t x = w < nw ? m[w] : 0u;
            const long long pc = __popc(x);
            const long long inc = warp_inclusive_scan(pc);
            const uint32_t hit = __ballot_sync(~0u, r < inc);
            if (hit) {
                const int l = __ffs(hit) - 1;
                uint32_t xl = __shfl_sync(~0u, x, l);
                for (long long k = r - __shfl_sync(~0u, inc - pc, l); k > 0;
                     k--)
                    xl &= xl - 1;
                return ((w0 + l) << 5) + __ffs(xl) - 1;
            }
            r -= __shfl_sync(~0u, inc, 31);
        }
        return -1;
    }
};

// 1. The speculative walk of chunk c from its first bit.
template <class Walk>
__device__ void chain_walk(const Walk& w, const ChainGeom& g,
                           const ChainScratch& s, int c) {
    if (c == 0) s.flags[0] = 0;  // the check raises it
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

// The true chain through chunk c from `entry` (>= the chunk's first bit),
// by one thread or a warp (Team).
template <class Team, class Walk>
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
                const int q = o > s.wlast[c] ? -1 : Team::next(R, o, nb);
                if (q < 0) {
                    items += s.witems[c] - Team::rank(E, o);
                    pos = s.wexit[c];
                    break;
                }
                items += Team::rank(E, q) - Team::rank(E, o);
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
template <class Team, class Walk>
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
                const int q = o > s.wlast[c] ? -1 : Team::next(R, o, nb);
                const long long r0 = Team::rank(E, o);
                const long long avail = Team::rank(E, q < 0 ? nb : q) - r0;
                if (k <= avail)
                    return w.step(lo + Team::select(E, r0 + k - 1, nb)).next;
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

// A warp's chunks write their break and walked-whole flags as one word
// each (a warp owns its word), their item counts and the counts' sum; a
// CTA its chunks' sum.  A warp with a break raises `flag`.  Every thread
// of the CTA calls it.
__device__ __forceinline__ void chain_publish(const ChainScratch& s, int c,
                                              long long n_max,
                                              long long items, bool brk,
                                              bool whole, long long* flag) {
    __shared__ long long cta_sums[kChainThreads / 32];
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
        if (bb) *flag = 1;  // every writer writes 1
        cta_sums[threadIdx.x >> 5] = sum;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        long long t = 0;
        for (int i = 0; i < kChainThreads / 32; i++) t += cta_sums[i];
        s.csum[blockIdx.x] = t;
    }
}

// 2. The true chain through chunk c from its likely entry, the walker
// exit of the chunk before; a break where its exit is not the next
// chunk's likely entry.
template <class Walk>
__device__ void chain_check(const Walk& w, const ChainGeom& g,
                            const ChainScratch& s, int c, long long n_max) {
    bool brk = false, whole = false;
    long long items = 0;
    if (c == 0)  // the rounds raise them
        for (int r = 1; r <= kMaxRounds; r++) s.flags[r] = 0;
    if (c < g.n_live) {
        const long long h = c == 0 ? g.start : s.wexit[c - 1];
        long long x = h;
        s.entry[c] = h;
        if (g.walked(c)) {
            const ChainFollow f = chain_follow<Solo>(w, g, s, c, h);
            x = f.exit;
            items = f.items;
            whole = f.whole;
            brk = c + 1 < g.n_live && f.exit != s.wexit[c];
        }
        s.exit[c] = x;
    }
    chain_publish(s, c, n_max, items, brk, whole, s.flags);
}

// 3. Round r (1 <= r <= kMaxRounds) of a chain without jumps (D1): chunk
// c enters where chunk c - 1 left after round r - 1 (the other exit
// buffer: no thread reads an exit written in the same launch).  Where that entry is new, c follows the
// true chain again from it; an entry at or past the chunk's end gives no
// item and exit = entry, as chain_skip does; the open chunk takes the
// entry and follows nothing.  Chunk c's exit then differs from chunk
// c + 1's entry (a break) exactly where it moved in this round.  A round
// after one that moved no exit returns at once, and so does every round
// after it (the check zeroes their flag words).  A CTA with no new entry and no break
// word to clear only carries its exits over.
template <class Walk>
__device__ void chain_round(const Walk& w, const ChainGeom& g,
                            const ChainScratch& s, int c, long long n_max,
                            int r) {
    if (s.flags[r - 1] == 0) return;
    const long long* before = s.exits(r - 1);
    long long* after = s.exits(r);
    const bool live = c < g.n_live;
    const long long e = !live ? 0 : c == 0 ? g.start : before[c - 1];
    const bool fresh = live && e != s.entry[c];
    const bool brk_set = live && ((s.brk[c >> 5] >> (c & 31)) & 1u);
    if (!__syncthreads_or(fresh || brk_set)) {
        if (live) after[c] = before[c];
        return;
    }
    bool moved = false, whole = false;
    long long items = 0;
    if (live) {
        long long x = before[c];
        items = s.items[c];
        whole = (s.whole[c >> 5] >> (c & 31)) & 1u;
        if (fresh) {
            s.entry[c] = e;
            x = e;
            items = 0;
            whole = false;
            if (g.walked(c)) {
                const ChainFollow f = chain_follow<Solo>(w, g, s, c, e);
                x = f.exit;
                items = f.items;
                whole = f.whole;
            }
        }
        after[c] = x;
        moved = x != before[c];
    }
    chain_publish(s, c, n_max, items, moved && c + 1 < g.n_live, whole,
                  s.flags + r);
}

// f after g, on maps of entry offsets (a nibble each).
__device__ __forceinline__ unsigned long long map_compose(
        unsigned long long f, unsigned long long g) {
    unsigned long long r = 0;
#pragma unroll
    for (int k = 0; k < kTabEntries; k++) {
        const int x = (int)((g >> (4 * k)) & 15u);
        r |= ((f >> (4 * x)) & 15ull) << (4 * k);
    }
    return r;
}

__device__ __forceinline__ int map_at(unsigned long long f, int k) {
    return (int)((f >> (4 * k)) & 15u);
}

// 4. Thread t: chunk t / 16 from entry offset t % 16 (< max_step: every
// exit lies within max_step bits of the next chunk's start); then warp 0
// scans the CTA's 32 chunks' maps.  A CTA of kTabThreads.
template <class Walk>
__device__ void chain_tabulate(const Walk& w, const ChainGeom& g,
                               const ChainScratch& s, int max_step,
                               int rounds) {
    __shared__ uint8_t next[kTabThreads];
    if (s.flags[rounds] == 0) return;  // the rounds left no break
    const long long t = (long long)blockIdx.x * kTabThreads + threadIdx.x;
    const int c = (int)(t / kTabEntries), k = (int)(t % kTabEntries);
    uint8_t nx = kTabEnded;
    if (c < g.n_live) {
        int items = 0;
        bool whole = false;
        if (k < max_step) {
            const ChainFollow f = chain_follow<Solo>(w, g, s, c, g.lo(c) + k);
            items = (int)f.items;
            whole = f.whole;
            if (f.exit != kChainEnded) nx = (uint8_t)(f.exit - g.lo(c + 1));
        }
        s.tnext[t] = nx;
        s.titems[t] = items;
        s.twhole[t] = whole;
    }
    next[threadIdx.x] = nx;
    __syncthreads();
    if (threadIdx.x < 32) {  // lane l: the CTA's chunk l
        const int lane = threadIdx.x;
        const int cc = (int)(blockIdx.x * (kTabThreads / kTabEntries)) + lane;
        unsigned long long m = kMapIdentity;  // past the live chunks
        if (cc < g.n_live) {
            m = 0;
            for (int x = 0; x < kTabEntries; x++)
                m |= (unsigned long long)next[lane * kTabEntries + x] << (4 * x);
        }
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const unsigned long long before = __shfl_up_sync(~0u, m, o);
            if (lane >= o) m = map_compose(m, before);
        }
        if (cc < g.n_live) s.tmap[cc] = m;
        if (lane == 31) s.tagg[blockIdx.x] = m;
    }
}

// One CTA: the warps' composites scanned, each replaced by the entry
// offset of its warp's first chunk (chunk 0's is 0).
__device__ __forceinline__ void chain_tabulate_top(const ChainGeom& g,
                                                   const ChainScratch& s,
                                                   int rounds) {
    __shared__ unsigned long long part[kStitchThreads];
    if (s.flags[rounds] == 0) return;
    const int n = (g.n_live + 31) >> 5;
    const int per = (n + (int)blockDim.x - 1) / (int)blockDim.x;
    const int b0 = min((int)threadIdx.x * per, n), b1 = min(b0 + per, n);
    unsigned long long f = kMapIdentity;
    for (int b = b0; b < b1; b++) f = map_compose(s.tagg[b], f);
    for (int o = 1; o < (int)blockDim.x; o <<= 1) {
        part[threadIdx.x] = f;
        __syncthreads();
        if ((int)threadIdx.x >= o) f = map_compose(f, part[threadIdx.x - o]);
        __syncthreads();
    }
    part[threadIdx.x] = f;  // inclusive
    __syncthreads();
    int v = threadIdx.x == 0 ? 0 : map_at(part[threadIdx.x - 1], 0);
    for (int b = b0; b < b1; b++) {
        const unsigned long long a = s.tagg[b];
        s.tagg[b] = (unsigned long long)v;
        v = map_at(a, v);
    }
}

// Chunk c's true entry, count and walked-whole flag from the table,
// published as the check's (no break; the emit reads no exit).  One
// thread a chunk, every thread of the CTA.
__device__ __forceinline__ void chain_tabulate_apply(const ChainGeom& g,
                                                     const ChainScratch& s,
                                                     int c, long long n_max,
                                                     int rounds) {
    if (s.flags[rounds] == 0) return;
    bool whole = false;
    long long items = 0;
    if (c < g.n_live) {
        const int v = (int)s.tagg[c >> 5];
        const int k = (c & 31) == 0 ? v : map_at(s.tmap[c - 1], v);
        long long e = kChainEnded;
        if (k != kTabEnded) {
            const long long t = (long long)c * kTabEntries + k;
            e = g.lo(c) + k;
            items = s.titems[t];
            whole = s.twhole[t];
        }
        s.entry[c] = e;
    }
    chain_publish(s, c, n_max, items, false, whole,
                  s.flags + rounds);  // no break: never raised
}

// What the sweep counts (ChainStat), where stats are asked for.
struct SweepCounts {
    long long breaks = 0, rewalked = 0, skipped = 0, turns = 0, jumps = 0,
              longest = 0;
};

// From chunk c, whose entry is the true chain's and whose counts are
// those of the chain from there without a jump, with `base` items before
// it (warp-uniform): the first chunk at or after c that is not walked,
// that a break ends (its exit is not the next chunk's recorded entry), or
// in which the item count reaches `jump` (the item before a jump ends in
// it).  A warp tests 32 chunks at once, and 32 groups of 32 at once by
// their sums and break words; c and base come back for that chunk, and
// with kCount `turns` counts the scans.
template <bool kCount>
__device__ __forceinline__ void chain_next_event(const ChainGeom& g,
                                                 const ChainScratch& s,
                                                 int& c, long long& base,
                                                 long long jump,
                                                 long long& turns) {
    const int lane = threadIdx.x & 31;
    const int n_groups = (g.n_live + 31) >> 5;
    for (;;) {
        if (kCount) turns++;
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
            if (kCount) turns++;
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

// What chain_fix leaves: the chunk's exit and item count, the next jump
// and the jumps it took.
struct ChainFix {
    long long exit, count, jump;
    int taken;
};

// The true chain through chunk d from `e`, with `bd` items before it,
// taking the jumps it reaches (the next at item count `jump`), followed by
// the whole warp (every lane calls it with the same arguments); lane 0
// sets d's entry, exit, count and walked-whole flag.
template <class Walk, class Jumps>
__device__ __forceinline__ ChainFix chain_fix(const Walk& w,
                                              const ChainGeom& g,
                                              const ChainScratch& s,
                                              const Jumps& jumps, int d,
                                              long long e, long long bd,
                                              long long jump) {
    long long pos = e, idx = bd;
    int taken = 0;
    bool whole = false;
    while (pos < g.hi(d)) {
        const ChainFollow f = chain_follow<Warp>(w, g, s, d, pos);
        if (idx + f.items < jump) {
            idx += f.items;
            pos = f.exit;
            whole = f.whole;
            break;
        }
        pos = chain_locate<Warp>(w, g, s, d, pos, jump - idx) +
              jumps.bits(jump);
        idx = jump;
        jump = jumps.next(jump);
        taken++;
    }
    __syncwarp();  // every lane has read d's fields
    if (Warp::leader()) {
        s.entry[d] = e;
        s.set_items(d, idx - bd);
        s.exit[d] = pos;
        s.set_whole(d, whole);
    }
    __syncwarp();
    return {pos, idx - bd, jump, taken};
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

// 5. D2's sweep, by one warp (every lane calls it), where the check left a
// break or the chain jumps: the chunks in order from the chain's start; a
// warp scan finds the next event (chain_next_event); at a jump the true
// chain is walked to the item before it and jumps; at a break its exit is
// taken; either way the chain then re-enters the chunks after until it
// enters one at the position recorded there, from where the recorded
// chain stands (chunks it jumps over whole are written by the warp at
// once).  Only the chunks between an event and that meeting are written,
// each count's group and CTA sums with it.  With kCount, `n` gets its
// counts (the same in every lane).
template <bool kCount, class Walk, class Jumps>
__device__ __forceinline__ void chain_sweep(const Walk& w,
                                            const ChainGeom& g,
                                            const ChainScratch& s,
                                            const Jumps& jumps,
                                            SweepCounts& n) {
    const int lane = threadIdx.x & 31;
    long long jump = jumps.first(), base = 0;
    int c = 0;
    for (;;) {
        chain_next_event<kCount>(g, s, c, base, jump, n.turns);
        if (!g.walked(c)) break;
        if (kCount) n.breaks += (s.brk[c >> 5] >> (c & 31)) & 1u;
        // A jump in chunk c: c is walked again from its entry; else the
        // chain leaves c at its recorded exit (a break's).  One call site
        // of chain_fix, so that it is inlined.
        bool again = base + s.items[c] >= jump;
        long long span = again ? -1 : 0;  // chunks written after c
        long long e = again ? s.entry[c] : s.exit[c];
        if (!again) base += s.items[c];
        int d = again ? c : c + 1;
        // Every lane reads d's entry before lane 0 may write it: the
        // condition is lane 0's, broadcast.
        while (__shfl_sync(~0u, g.walked(d) && (again || e != s.entry[d]),
                           0)) {
            again = false;
            if (e >= g.hi(d)) {  // to the chunk e lies in
                const long long z = (e - g.start) / g.chunk_bits;
                const int dz = (int)(z < g.n_live ? z : g.n_live);
                chain_skip(s, d, dz, e);
                if (kCount) {
                    n.skipped += dz - d;
                    span += dz - d;
                }
                d = dz;
                continue;
            }
            const ChainFix f = chain_fix(w, g, s, jumps, d, e, base, jump);
            e = f.exit;
            base += f.count;
            jump = f.jump;
            if (kCount) {
                n.jumps += f.taken;
                n.rewalked++;
                span++;
            }
            d++;
        }
        if (kCount && span > n.longest) n.longest = span;
        if (!g.walked(d)) {
            if (lane == 0 && d < g.n_live) s.entry[d] = e;  // open
            break;
        }
        c = d;
    }
}

__device__ __forceinline__ void put_stat(long long* stats, int n_stats,
                                         int i, long long v) {
    if (i < n_stats) stats[i] = v;
}

// 6. One CTA (every thread calls it, after the sweep where one ran): the
// CTAs' sums scanned into each one's first item index and, where given,
// the total and the first n_stats stats (ChainStat; thread 0 holds the
// sweep's counts in `n`).
__device__ __forceinline__ void chain_scan(const ChainGeom& g,
                                           const ChainScratch& s, int rounds,
                                           long long* total, long long* stats,
                                           int n_stats,
                                           const SweepCounts& n) {
    __shared__ long long warp_sums[32];
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
    if (stats == nullptr) return;
    __syncthreads();
    const int nf = (g.n_live + 31) >> 5;
    long long whole = 0;
    for (int i = threadIdx.x; i < nf; i += blockDim.x)
        whole += __popc(s.whole[i]);
    whole += block_exclusive_scan(whole, warp_sums);
    if (threadIdx.x == 0) {
        put_stat(stats, n_stats, kStatSweepBreaks, n.breaks);
        put_stat(stats, n_stats, kStatRewalked, n.rewalked);
        put_stat(stats, n_stats, kStatSkipped, n.skipped);
        put_stat(stats, n_stats, kStatTurns, n.turns);
        put_stat(stats, n_stats, kStatJumps, n.jumps);
        put_stat(stats, n_stats, kStatLongestRun, n.longest);
    }
    if (threadIdx.x == blockDim.x - 1) {  // holds the inclusive count
        long long changed = 0;
        for (int r = 1; r <= rounds; r++) changed += s.flags[r - 1] != 0;
        put_stat(stats, n_stats, kStatChunks, g.n_live);
        put_stat(stats, n_stats, kStatWhole, whole);
        put_stat(stats, n_stats, kStatRounds, changed);
        put_stat(stats, n_stats, kStatBreaksLeft, s.flags[rounds] != 0);
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

}  // namespace ie
