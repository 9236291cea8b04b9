// The Huffman dict on the card: a byte histogram in, everything the payload
// pack needs out (dict_table.cuh), so that nothing waits on the host between
// the histogram and K4's pack_payload.
//
// No TPU kernel: this is the host step between K3 and K4, the port's
// ops/huffman.py::_dict_and_codes and dict_tensors with the out-total and
// fallback arithmetic of the encode (the JAX package's
// imageencoder_tpu/ops/huffman.py:194 _dict_and_codes, whose tree build is
// native C++ there, runtime.cpp:1549).  One CTA of 256 threads, a thread a
// byte value:
//
// 1. The leaves: the present bytes, ids by ascending byte, keys
//    (freq << 17) | (byte << 9) | id, sorted by a bitonic network across
//    the CTA (shuffles within a warp, a shared-memory exchange and one
//    barrier for each of the six steps between warps).
// 2. The tree.  heapq pops the two smallest keys, and every key is unique,
//    so any exact two-smallest selection builds the same tree.  Here two
//    sorted queues, the leaves and the internal nodes in the order they
//    are made: the two-queue method.  It is exact because the nodes are
//    made in increasing key order.  The heap pops keys in increasing order
//    (a new node's frequency exceeds its children's).  A node made later
//    from e0 < e1 than another from g0 < g1 has at least its frequency, and
//    the same only when all four frequencies are equal; then the four
//    keys, popped in the order g0, g1, e0, e1 and of disjoint subtrees,
//    have increasing first bytes, and the later node's first byte (e0's)
//    exceeds the earlier one's (g0's).
//
//    One warp merges in rounds.  A round takes the 64 smallest live keys
//    x1 < x2 < ... (the merge of the next 64 of each queue, two a lane: a
//    bitonic merge in registers), n1 the node x1 and x2 make, and c the
//    count of those keys below n1's key.  It makes k = c / 2 (at least 1)
//    nodes at once, lane j node n + made + j from x(2j+1) and x(2j+2).
//    This is the heap's own sequence.  Until n1 is popped, each pop takes
//    the smallest live key, and while the keys below n1 last, the nodes of
//    this round (each at least n1, being made later) are not among the two
//    smallest: so pops 2j+1 and 2j+2 take x(2j+1) and x(2j+2) for every
//    j < k.  The comparisons with n1's key never reach its id: the live
//    nodes are disjoint subtrees, so their first bytes are distinct, and
//    n1's first byte is one of x1's and x2's, which are no longer live;
//    every (freq, first byte) pair among them and n1 differs, and the id,
//    the lowest field, decides nothing.  The 64 smallest of the two
//    windows are the 64 smallest live keys, so c counts no key out of
//    order; a round makes up to 32 nodes.  (A window of 32, one key a
//    lane, takes 21 rounds on the 4096x912 image's histogram where 64
//    takes 14, and read 0.2-1.0 us slower on an H100.)
//
//    Where n <= 32 (the chains of deep trees: every round would make one
//    node) lane 0 merges serially, one node a step, its queue heads in
//    registers.
// 3. Depths by pointer jumping.  A node made in round r has children made
//    in earlier rounds, so the tree is at most as deep as the rounds (or
//    the serial steps) it took: ceil(log2(rounds + 1)) jumps cover it.
//    Lengths are at least 1.
// 4. The 15-bit limit (_limit_lengths) serially, step by step as written
//    (the scan for the depth to split only where that depth can have
//    moved); its two failures become the error word, on which the host
//    raises.  The
//    reassignment by a stable sort on (old length, byte) is a rank: the
//    bytes of shorter old lengths (a prefix over the lengths), plus the
//    byte's place among the bytes of its old length (__match_any_sync in
//    its warp, the counts of the warps before it).
// 5. Canonical codes (by length, then byte) and the serialized dict: groups
//    by length, longest first, at most 127 entries a group, [8: 0x80 | n]
//    [4: len], then per entry [8: byte][len: code], and one 0 bit.  A
//    byte's place among those of its length comes from __match_any_sync
//    and per-warp counts, as in 4; each entry's bit offset follows from the
//    counts per length, so every thread writes its own.
// 6. out total = dict bits + sum of freq * length (int64); the fallback flag
//    (fewer than 2 bytes, or a coded stream not smaller than the inner one);
//    the bytes K4 codes.
//
// Bound: latency.  It moves about 4 KB; its time is the chain of the
// merge's rounds (12-15 on the main paths' histograms, 34 on geometric
// counts up to 2^30, against 255 serial steps), the barriers around them
// and, where a depth passes 15, the limit's serial steps.
//
// A batch of streams (the serving path, models/batch.py) is one launch of
// a CTA a stream: CTA b reads histogram b and total b and writes table b,
// so each stream decides its own fallback and its own error word, and the
// streams' merges run side by side on as many SMs.
#include <cstdint>

#include <cuda_runtime.h>

#include "dict_table.cuh"

namespace {

constexpr int kSyms = 256;     // threads: one a byte value
constexpr int kWarps = kSyms / 32;
constexpr int kMaxLen = 15;    // MAX_CODE_LEN: the dict's 4-bit length field
constexpr int kMaxGroup = 127;  // MAX_GROUP: the dict's 7-bit group size
constexpr int kSerialMax = 32;  // at most this many leaves: lane 0 merges
constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull;
static_assert(kSyms == ie::kDictWords, "a thread a byte and a dict word");

// ORs the nb-bit field v (nb <= 32) into the MSB-first words at bit off.
__device__ __forceinline__ void put_bits(uint32_t* words, int off, int nb,
                                         uint32_t v) {
    const unsigned long long x = (unsigned long long)v
                                 << (64 - nb - (off & 31));
    atomicOr(words + (off >> 5), (uint32_t)(x >> 32));
    if ((uint32_t)x) atomicOr(words + (off >> 5) + 1, (uint32_t)x);
}

// The key of the node that e0 and e1 make: their frequencies' sum, the
// smaller first byte, its id.
__device__ __forceinline__ unsigned long long node_key(unsigned long long e0,
                                                       unsigned long long e1,
                                                       int node) {
    const unsigned long long b0 = (e0 >> 9) & 0xFFull;
    const unsigned long long b1 = (e1 >> 9) & 0xFFull;
    return (((e0 >> 17) + (e1 >> 17)) << 17) | ((b0 < b1 ? b0 : b1) << 9)
           | (unsigned)node;
}

__device__ __forceinline__ unsigned long long key_min(unsigned long long a,
                                                      unsigned long long b) {
    return a < b ? a : b;
}

__device__ __forceinline__ unsigned long long key_max(unsigned long long a,
                                                      unsigned long long b) {
    return a < b ? b : a;
}

// The rounds of step 2, in warp 0: the nodes n .. 2n - 2, their keys in
// inode[] and their children's up[] entries.  Returns the rounds taken.
__device__ __forceinline__ int merge_rounds(const unsigned long long* leaf,
                                            unsigned long long* inode,
                                            int* up, int n, int lane) {
    int li = 0, ih = 0, it = 0, rounds = 0;
    while (it < n - 1) {
        // Place p (x[0] at p = lane, x[1] at p = lane + 32) takes the
        // p-th next leaf and the p-th last of the next 64 internal nodes:
        // their minima, place by place, are the 64 smallest live keys as
        // a bitonic sequence, which a bitonic merge sorts (the exchange at
        // distance 32 in registers, then five within each half).
        unsigned long long x[2];
#pragma unroll
        for (int q = 0; q < 2; q++) {
            const int p = lane + 32 * q;
            const unsigned long long l = li + p < n ? leaf[li + p] : kNone;
            const int ir = ih + 63 - p;
            x[q] = key_min(l, ir < it ? inode[ir] : kNone);
        }
        const unsigned long long lo = key_min(x[0], x[1]);
        x[1] = key_max(x[0], x[1]);
        x[0] = lo;
#pragma unroll
        for (int q = 0; q < 2; q++) {
#pragma unroll
            for (int d = 16; d > 0; d >>= 1) {
                const unsigned long long o = __shfl_xor_sync(kAll, x[q], d);
                x[q] = (lane & d) ? key_max(x[q], o) : key_min(x[q], o);
            }
        }
        // Place p now holds the (p + 1)-th smallest live key.
        const int node = n + it;
        const unsigned long long x1 = __shfl_sync(kAll, x[0], 0);
        const unsigned long long x2 = __shfl_sync(kAll, x[0], 1);
        const unsigned long long n1 = node_key(x1, x2, node);
        const int k = (__popc(__ballot_sync(kAll, x[0] < n1))
                       + __popc(__ballot_sync(kAll, x[1] < n1))) >> 1;
        // Node j from places 2j and 2j + 1: x[0] for j < 16, else x[1].
        const int pair = (2 * lane) & 31;
        const unsigned long long a0 = __shfl_sync(kAll, x[0], pair);
        const unsigned long long a1 = __shfl_sync(kAll, x[0], pair + 1);
        const unsigned long long b0 = __shfl_sync(kAll, x[1], pair);
        const unsigned long long b1 = __shfl_sync(kAll, x[1], pair + 1);
        const unsigned long long e0 = lane < 16 ? a0 : b0;
        const unsigned long long e1 = lane < 16 ? a1 : b1;
        if (lane < k) {
            up[e0 & 0x1FFu] = node + lane;
            up[e1 & 0x1FFu] = node + lane;
            inode[it + lane] = node_key(e0, e1, node + lane);
        }
        const int nl =  // leaves taken
            __popc(__ballot_sync(kAll, lane < 2 * k
                                           && (int)(x[0] & 0x1FFu) < n))
            + __popc(__ballot_sync(kAll, lane + 32 < 2 * k
                                             && (int)(x[1] & 0x1FFu) < n));
        li += nl;
        ih += 2 * k - nl;
        it += k;
        rounds++;
        __syncwarp();
    }
    return rounds;
}

// Step 2 for n <= kSerialMax, in lane 0: one node a step.  Each queue's
// next two keys (l0, l1: leaf[li], leaf[li + 1]; i0, i1: inode[ih],
// inode[ih + 1]; kNone past the end) decide both pops without a branch,
// and the two keys after them, loaded at the top of the step, are first
// needed at its end.
__device__ __forceinline__ void merge_serial(const unsigned long long* leaf,
                                             unsigned long long* inode,
                                             int* up, int n) {
    int li = 0, ih = 0, it = 0;
    unsigned long long l0 = leaf[0], l1 = leaf[1];  // n >= 2
    unsigned long long i0 = kNone, i1 = kNone;
    for (int node = n; node <= 2 * n - 2; node++) {
        const unsigned long long l2 = li + 2 < n ? leaf[li + 2] : kNone;
        const unsigned long long l3 = li + 3 < n ? leaf[li + 3] : kNone;
        const unsigned long long i2 = ih + 2 < it ? inode[ih + 2] : kNone;
        const unsigned long long i3 = ih + 3 < it ? inode[ih + 3] : kNone;
        const bool a = l0 < i0;  // the first pop takes a leaf
        const unsigned long long e0 = a ? l0 : i0;
        const unsigned long long lh = a ? l1 : l0, nh = a ? i0 : i1;
        const bool b = lh < nh;  // the second pop takes a leaf
        const unsigned long long e1 = b ? lh : nh;
        const int nl = (int)a + (int)b;  // leaves taken
        up[e0 & 0x1FFu] = node;
        up[e1 & 0x1FFu] = node;
        const unsigned long long nk = node_key(e0, e1, node);
        const unsigned long long nl0 = nl == 0 ? l0 : nl == 1 ? l1 : l2;
        const unsigned long long nl1 = nl == 0 ? l1 : nl == 1 ? l2 : l3;
        const unsigned long long ni0 = nl == 2 ? i0 : nl == 1 ? i1 : i2;
        const unsigned long long ni1 = nl == 2 ? i1 : nl == 1 ? i2 : i3;
        li += nl;
        ih += 2 - nl;
        inode[it] = nk;  // the largest key made so far
        l0 = nl0;
        l1 = nl1;
        i0 = it == ih ? nk : ni0;
        i1 = it == ih + 1 ? nk : ni1;
        it++;
    }
}

// Step 4 in one thread: _limit_lengths's rebalance, its steps as
// written, lim[] the counts by depth on entry and by new length on exit;
// returns the error word.  A step at depth ln moves a pair from ln up one,
// paid for by splitting a code at the deepest depth j <= ln - 2 that has
// one.  Only these steps take codes from ln, so its count is known before
// them; and j is scanned for only where it can have moved: after a step
// at j < ln - 2, j + 1 (two codes more, none deeper up to ln - 2) is the
// deepest, and after one at j = ln - 2, j stays while it keeps a code.
__device__ __forceinline__ int limit_lengths(int* lim, int max_len) {
    for (int ln = max_len; ln > kMaxLen; ln--) {
        int left = lim[ln];
        int j = ln - 2;
        while (j > 0 && lim[j] == 0) j--;
        for (; left > 1; left -= 2) {
            if (j == 0) return 1;
            lim[ln - 1] += 1;
            lim[j + 1] += 2;
            lim[j] -= 1;
            if (j < ln - 2) {
                j++;
            } else if (lim[j] == 0) {
                while (j > 0 && lim[j] == 0) j--;
            }
        }
        lim[ln] = left;
        if (left == 1) return 1;  // an odd code left over
    }
    return 0;
}

__global__ void __launch_bounds__(kSyms) huffman_dict_kernel(
        const int32_t* __restrict__ hist,
        const long long* __restrict__ total_bits, int32_t* __restrict__ table) {
    __shared__ unsigned long long swap[2][kSyms];  // the sort's exchanges
    __shared__ unsigned long long leaf[kSyms];   // the leaves' keys, sorted
    __shared__ unsigned long long inode[kSyms];  // internal keys, as made
    __shared__ int up[2 * kSyms];                // parent, then jumped
    __shared__ int dep[2 * kSyms];
    __shared__ int cnt[kSyms];   // present bytes by tree depth
    __shared__ int lim[kSyms];   // the same, limited to 15
    __shared__ int shorter[kSyms];  // present bytes of smaller tree depth
    __shared__ int wcnt[kWarps][kSyms];  // a warp's present bytes by length
    __shared__ uint32_t dict[ie::kDictWords];
    __shared__ long long next_code[kMaxLen + 1];
    __shared__ int bits_before[kMaxLen + 1], chunks_before[kMaxLen + 1];
    __shared__ int warp_int[kWarps];
    __shared__ long long warp_sum[kWarps];
    __shared__ int s_err, s_dict_bits, s_rounds;
    hist += (long long)blockIdx.x * kSyms;  // the CTA's stream
    total_bits += blockIdx.x;
    table += (long long)blockIdx.x * ie::kTableWords;
    const int s = threadIdx.x;
    const int lane = s & 31;
    const int warp = s >> 5;
    const unsigned below_lane = (1u << lane) - 1u;
    const long long total = *total_bits;
    long long* meta = reinterpret_cast<long long*>(table + ie::kTableMeta);
    const int f = total >= 0 ? hist[s] : 0;
    const bool present = f > 0;

    // ---- 1. the leaves ----
    const unsigned ballot = __ballot_sync(kAll, present);
    if (lane == 0) warp_int[warp] = __popc(ballot);
    dict[s] = 0u;
    cnt[s] = 0;
    lim[s] = 0;
    if (s == 0) s_err = 0;
    __syncthreads();
    int id = __popc(ballot & below_lane);
    int n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; w++) {
        if (w < warp) id += warp_int[w];
        n += warp_int[w];
    }
    if (n < 2) {  // the fallback: no code for one byte value
        table[ie::kTableCodeW + s] = 0;
        table[ie::kTableCodeL + s] = 0;
        table[ie::kTableDict + s] = 0;
        if (s < ie::kMetaFields)
            meta[s] = s == ie::kMetaInnerBits ? total
                : s == ie::kMetaFallback ? 1 : 0;
        return;
    }
    // Bitonic sort, ascending: thread s ends holding the s-th smallest key
    // (the absent bytes' kNone last).
    unsigned long long key = present
        ? ((unsigned long long)f << 17) | ((unsigned long long)s << 9)
              | (unsigned)id
        : kNone;
    int buf = 0;
#pragma unroll
    for (int k = 2; k <= kSyms; k <<= 1) {
#pragma unroll
        for (int j = k >> 1; j > 0; j >>= 1) {
            unsigned long long o;
            if (j >= 32) {  // across warps
                swap[buf][s] = key;
                __syncthreads();
                o = swap[buf][s ^ j];
                buf ^= 1;  // the next exchange writes the other buffer
            } else {
                o = __shfl_xor_sync(kAll, key, j);
            }
            key = ((s & j) == 0) == ((s & k) == 0) ? key_min(key, o)
                                                   : key_max(key, o);
        }
    }
    leaf[s] = key;
    __syncthreads();

    // ---- 2. the tree ----
    const int root = 2 * n - 2;
    if (warp == 0) {
        int rounds = n - 1;
        if (n <= kSerialMax) {
            if (lane == 0) merge_serial(leaf, inode, up, n);
        } else {
            rounds = merge_rounds(leaf, inode, up, n, lane);
        }
        if (lane == 0) {
            up[root] = root;
            s_rounds = rounds;
        }
    }
    __syncthreads();

    // ---- 3. depths ----
    for (int i = s; i <= root; i += kSyms) dep[i] = i == root ? 0 : 1;
    const int jumps = 32 - __clz(s_rounds);  // 2^jumps > the tree's depth
    __syncthreads();
    for (int r = 0; r < jumps; r++) {
        int nd[2], np[2];
#pragma unroll
        for (int k = 0; k < 2; k++) {
            const int i = s + k * kSyms;
            if (i <= root) {
                const int p = up[i];
                nd[k] = dep[i] + dep[p];
                np[k] = up[p];
            }
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < 2; k++) {
            const int i = s + k * kSyms;
            if (i <= root) {
                dep[i] = nd[k];
                up[i] = np[k];
            }
        }
        __syncthreads();
    }
    int len = present ? max(dep[id], 1) : 0;  // leaf depths: at most 255
    if (present) atomicAdd(&cnt[len], 1);
    const int wmax = __reduce_max_sync(kAll, len);
    if (lane == 0) warp_int[warp] = wmax;
    __syncthreads();
    int max_len = 0;
#pragma unroll
    for (int w = 0; w < kWarps; w++) max_len = max(max_len, warp_int[w]);

    // ---- 4. the length limit ----
    if (max_len > kMaxLen) {
#pragma unroll
        for (int w = 0; w < kWarps; w++) wcnt[w][s] = 0;
        if (s == 0) {
            int before = 0;
            for (int l = 0; l <= max_len; l++) {
                lim[l] = cnt[l];
                shorter[l] = before;
                before += cnt[l];
            }
            s_err = limit_lengths(lim, max_len);
        }
        __syncthreads();
        if (s_err) {
            table[ie::kTableCodeW + s] = 0;
            table[ie::kTableCodeL + s] = 0;
            table[ie::kTableDict + s] = 0;
            if (s < ie::kMetaFields)
                meta[s] = s == ie::kMetaInnerBits ? total
                    : (s == ie::kMetaFallback || s == ie::kMetaError) ? 1 : 0;
            return;
        }
        // The shortest lengths go to the bytes that had them: rank by
        // (old length, byte), then the rank's place in the new counts.
        const unsigned same = __match_any_sync(kAll, len);
        const int in_warp = __popc(same & below_lane);
        if (present && in_warp == 0) wcnt[warp][len] = __popc(same);
        __syncthreads();
        int nl = 0;
        if (present) {
            int r = shorter[len] + in_warp;
            for (int w = 0; w < warp; w++) r += wcnt[w][len];
            int c = lim[1];
            nl = 1;
            while (c <= r) c += lim[++nl];
        }
        __syncthreads();
        len = nl;
        if (s <= kMaxLen) cnt[s] = 0;
        __syncthreads();
        if (present) atomicAdd(&cnt[len], 1);
    }
    if (s < kWarps * (kMaxLen + 1))
        wcnt[s / (kMaxLen + 1)][s % (kMaxLen + 1)] = 0;
    __syncthreads();

    // ---- 5. canonical codes and the serialized dict ----
    const unsigned same = __match_any_sync(kAll, len);
    const int in_warp = __popc(same & below_lane);
    if (s == 0) {
        long long code = 0;
        next_code[0] = 0;
        for (int l = 1; l <= kMaxLen; l++) {
            code = (code + (l > 1 ? cnt[l - 1] : 0)) << 1;
            next_code[l] = code;
        }
        int bits = 0, chunks = 0;
        for (int l = kMaxLen; l >= 1; l--) {
            bits_before[l] = bits;
            chunks_before[l] = chunks;
            bits += cnt[l] * (8 + l);
            chunks += (cnt[l] + kMaxGroup - 1) / kMaxGroup;
        }
        s_dict_bits = 12 * chunks + bits + 1;  // one 0 bit ends the dict
    }
    if (present && in_warp == 0) wcnt[warp][len] = __popc(same);
    __syncthreads();
    uint32_t code = 0u;
    if (present) {
        int r = in_warp;  // the byte's place among those of its length
        for (int w = 0; w < warp; w++) r += wcnt[w][len];
        code = (uint32_t)(next_code[len] + r);
        const int off = 12 * (chunks_before[len] + r / kMaxGroup + 1)
                        + bits_before[len] + r * (8 + len);
        put_bits(dict, off, 8 + len, ((uint32_t)s << len) | code);
        if (r % kMaxGroup == 0)  // this byte opens a group: its header
            put_bits(dict, off - 12, 12,
                     ((0x80u | (uint32_t)min(kMaxGroup, cnt[len] - r)) << 4)
                         | (uint32_t)len);
    }

    // ---- 6. the totals ----
    long long part = (long long)f * len;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(kAll, part, o);
    if (lane == 0) warp_sum[warp] = part;
    __syncthreads();
    table[ie::kTableCodeW + s] = (int32_t)code;
    table[ie::kTableCodeL + s] = len;
    table[ie::kTableDict + s] = (int32_t)dict[s];
    if (s == 0) {
        long long payload = 0;
        for (int w = 0; w < kWarps; w++) payload += warp_sum[w];
        const long long out_total = s_dict_bits + payload;
        const bool fallback = ((total + 7) >> 3) < ((out_total + 7) >> 3);
        meta[ie::kMetaDictBits] = s_dict_bits;
        meta[ie::kMetaOutTotal] = out_total;
        meta[ie::kMetaInnerBits] = total;
        meta[ie::kMetaFallback] = fallback;
        meta[ie::kMetaNbytes] = fallback ? 0 : (total + 7) >> 3;
        meta[ie::kMetaError] = 0;
        for (int k = ie::kMetaError + 1; k < ie::kMetaFields; k++) meta[k] = 0;
    }
}

}  // namespace

extern "C" int ie_dict_table_words() { return ie::kTableWords; }

// hist: i32 [n_streams, 256], each inner stream's byte histogram;
// total_bits: i64 [n_streams], its length in bits (-1 for a refused stream:
// no dict, the fallback flag set); table: i32 [n_streams,
// ie_dict_table_words()], each row written whole (dict_table.cuh).  One
// launch, a CTA a stream.
extern "C" int ie_huffman_dict_batch(const void* hist, const void* total_bits,
                                     void* table, long long n_streams,
                                     void* stream) {
    if (n_streams < 1 || n_streams > 65535)
        return (int)cudaErrorInvalidValue;
    huffman_dict_kernel<<<(unsigned)n_streams, kSyms, 0,
                          (cudaStream_t)stream>>>(
        (const int32_t*)hist, (const long long*)total_bits,
        (int32_t*)table);
    return (int)cudaGetLastError();
}

// One stream: hist i32 [256], total_bits i64 [1], table i32
// [ie_dict_table_words()].
extern "C" int ie_huffman_dict(const void* hist, const void* total_bits,
                               void* table, void* stream) {
    return ie_huffman_dict_batch(hist, total_bits, table, 1, stream);
}
