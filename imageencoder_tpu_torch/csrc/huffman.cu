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
//    (freq << 17) | (byte << 9) | id, sorted by counting ranks.
// 2. The tree, serially in thread 0.  heapq pops the two smallest keys, and
//    every key is unique, so any exact two-smallest selection builds the same
//    tree.  Here two sorted queues, the leaves and the internal nodes in the
//    order they are made: the two-queue method.  It is exact because the
//    nodes are made in increasing key order.  The heap pops keys in
//    increasing order (a new node's frequency exceeds its children's).  A
//    node made later from e0 < e1 than another from g0 < g1 has at least its
//    frequency, and the same only when all four frequencies are equal; then
//    the four keys, popped in the order g0, g1, e0, e1 and of disjoint
//    subtrees, have increasing first bytes, and the later node's first byte
//    (e0's) exceeds the earlier one's (g0's).
// 3. Depths by pointer jumping (9 rounds cover 511 nodes), at least 1.
// 4. The 15-bit limit (_limit_lengths) serially, exactly as written; its two
//    failures become the error word, on which the host raises.  The
//    reassignment by a stable sort on (old length, byte) is a rank count.
// 5. Canonical codes (by length, then byte) and the serialized dict: groups
//    by length, longest first, at most 127 entries a group, [8: 0x80 | n]
//    [4: len], then per entry [8: byte][len: code], and one 0 bit.  Each
//    entry's bit offset follows from the counts per length, so every thread
//    writes its own.
// 6. out total = dict bits + sum of freq * length (int64); the fallback flag
//    (fewer than 2 bytes, or a coded stream not smaller than the inner one);
//    the bytes K4 codes.
//
// Bound: latency.  It moves about 4 KB; its time is the serial merge, up
// to 255 dependent steps.
//
// A batch of streams (the serving path, models/batch.py) is one launch of
// a CTA a stream: CTA b reads histogram b and total b and writes table b,
// so each stream decides its own fallback and its own error word, and the
// streams' serial merges run side by side on as many SMs.
#include <cstdint>

#include <cuda_runtime.h>

#include "dict_table.cuh"

namespace {

constexpr int kSyms = 256;     // threads: one a byte value
constexpr int kMaxLen = 15;    // MAX_CODE_LEN: the dict's 4-bit length field
constexpr int kMaxGroup = 127;  // MAX_GROUP: the dict's 7-bit group size
constexpr int kJumps = 9;      // 2^9 > the 510 edges of the deepest tree
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

__global__ void __launch_bounds__(kSyms) huffman_dict_kernel(
        const int32_t* __restrict__ hist,
        const long long* __restrict__ total_bits, int32_t* __restrict__ table) {
    __shared__ unsigned long long keys[kSyms];   // by byte; kNone if absent
    __shared__ unsigned long long leaf[kSyms];   // the leaves' keys, sorted
    __shared__ unsigned long long inode[kSyms];  // internal keys, as made
    __shared__ int up[2 * kSyms];                // parent, then jumped
    __shared__ int dep[2 * kSyms];
    __shared__ int cnt[kSyms];   // present bytes by tree depth
    __shared__ int lim[kSyms];   // the same, limited to 15
    __shared__ int lens[kSyms];  // length by byte
    __shared__ uint32_t dict[ie::kDictWords];
    __shared__ long long next_code[kMaxLen + 1];
    __shared__ int bits_before[kMaxLen + 1], chunks_before[kMaxLen + 1];
    __shared__ int warp_int[kSyms / 32];
    __shared__ long long warp_sum[kSyms / 32];
    __shared__ int s_err, s_dict_bits;
    hist += (long long)blockIdx.x * kSyms;  // the CTA's stream
    total_bits += blockIdx.x;
    table += (long long)blockIdx.x * ie::kTableWords;
    const int s = threadIdx.x;
    const int lane = s & 31;
    const int warp = s >> 5;
    const long long total = *total_bits;
    long long* meta = reinterpret_cast<long long*>(table + ie::kTableMeta);
    const int f = total >= 0 ? hist[s] : 0;
    const bool present = f > 0;

    // ---- 1. the leaves ----
    const unsigned ballot = __ballot_sync(0xffffffffu, present);
    if (lane == 0) warp_int[warp] = __popc(ballot);
    dict[s] = 0u;
    cnt[s] = 0;
    lim[s] = 0;
    if (s == 0) s_err = 0;
    __syncthreads();
    int id = __popc(ballot & ((1u << lane) - 1u));
    int n = 0;
#pragma unroll
    for (int w = 0; w < kSyms / 32; w++) {
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
    const unsigned long long key = present
        ? ((unsigned long long)f << 17) | ((unsigned long long)s << 9)
              | (unsigned)id
        : kNone;
    keys[s] = key;
    __syncthreads();
    if (present) {
        int rank = 0;
        for (int t = 0; t < kSyms; t++) rank += keys[t] < key;
        leaf[rank] = key;
    }
    __syncthreads();

    // ---- 2. the tree ----
    // A merge is one thread's dependent steps, so its inputs stay in
    // registers: each queue's next two keys (l0, l1: leaf[li], leaf[li + 1];
    // i0, i1: inode[ih], inode[ih + 1]; kNone past the end) decide both pops
    // without a branch, and the two keys after them, loaded at the top of
    // the merge, are first needed at its end.
    const int root = 2 * n - 2;
    if (s == 0) {
        int li = 0, ih = 0, it = 0;
        unsigned long long l0 = leaf[0], l1 = leaf[1];  // n >= 2
        unsigned long long i0 = kNone, i1 = kNone;
        for (int node = n; node <= root; node++) {
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
            const unsigned long long tie =
                min((e0 >> 9) & 0xFFull, (e1 >> 9) & 0xFFull);
            const unsigned long long nk = (((e0 >> 17) + (e1 >> 17)) << 17)
                                          | (tie << 9) | (unsigned)node;
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
        up[root] = root;
    }
    __syncthreads();

    // ---- 3. depths ----
    for (int i = s; i <= root; i += kSyms) dep[i] = i == root ? 0 : 1;
    __syncthreads();
    for (int r = 0; r < kJumps; r++) {
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
    lens[s] = len;
    if (present) atomicAdd(&cnt[len], 1);
    const int wmax = __reduce_max_sync(0xffffffffu, len);
    if (lane == 0) warp_int[warp] = wmax;
    __syncthreads();
    int max_len = 0;
#pragma unroll
    for (int w = 0; w < kSyms / 32; w++) max_len = max(max_len, warp_int[w]);

    // ---- 4. the length limit ----
    if (max_len > kMaxLen) {
        if (s == 0) {
            for (int l = 0; l <= max_len; l++) lim[l] = cnt[l];
            int err = 0;
            for (int ln = max_len; ln > kMaxLen && !err; ln--) {
                while (lim[ln] > 1) {
                    // A pair at depth ln moves up one, paid for by
                    // splitting a code at the deepest depth j <= ln - 2.
                    int j = ln - 2;
                    while (j > 0 && lim[j] == 0) j--;
                    if (j == 0) {
                        err = 1;
                        break;
                    }
                    lim[ln] -= 2;
                    lim[ln - 1] += 1;
                    lim[j + 1] += 2;
                    lim[j] -= 1;
                }
                if (!err && lim[ln] == 1) err = 1;  // an odd code left over
            }
            s_err = err;
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
        int nl = 0;
        if (present) {
            int r = 0;
            for (int l = 1; l < len; l++) r += cnt[l];
            for (int t = 0; t < s; t++) r += lens[t] == len;
            int c = lim[1];
            nl = 1;
            while (c <= r) c += lim[++nl];
        }
        __syncthreads();
        len = nl;
        lens[s] = len;
        if (s <= kMaxLen) cnt[s] = 0;
        __syncthreads();
        if (present) atomicAdd(&cnt[len], 1);
    }
    __syncthreads();

    // ---- 5. canonical codes and the serialized dict ----
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
    __syncthreads();
    uint32_t code = 0u;
    if (present) {
        int r = 0;  // the byte's place among those of its length
        for (int t = 0; t < s; t++) r += lens[t] == len;
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
        part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) warp_sum[warp] = part;
    __syncthreads();
    table[ie::kTableCodeW + s] = (int32_t)code;
    table[ie::kTableCodeL + s] = len;
    table[ie::kTableDict + s] = (int32_t)dict[s];
    if (s == 0) {
        long long payload = 0;
        for (int w = 0; w < kSyms / 32; w++) payload += warp_sum[w];
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
