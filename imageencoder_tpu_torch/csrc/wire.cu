// The wire emit: the encoded streams as wire-order bytes on the card.
//
// Replaces no TPU kernel.  It takes the place of the host's last step of
// the JAX package's encode: imageencoder_tpu/ops/device_pack.py:261
// (words_to_bytes: the u32 words byte-swapped into big-endian bytes, cut
// to the stream's bytes) and, for a stream that takes the raw-copy
// fallback, imageencoder_tpu/ops/huffman.py:295 (_fallback: one 0 bit,
// then the inner stream's bytes, shifted by one bit, padded to the byte).
// The TPU keeps its streams as u32 words because it has no cheap byte
// stores; the card has them, so the bytes leave it in the order the wire
// wants and the host makes one exact copy a call (ops/huffman.py::Tail).
//
// Input: B streams.  Each stream's inner words (K2's or K4 pack_coeffs's
// row, the header OR'd in) and, with Huffman, its payload (K4
// pack_payload's row) and its dict table (dict_table.cuh): the table's
// fallback flag picks the inner words with one 0 bit before them, or the
// payload; its inner bits or its out total give the stream's bits.
// Without Huffman a total a stream gives them.  A refused stream (bits
// -1) or a table whose error word is set writes nothing.
// Output: one byte buffer.  Stream b starts at the wire bytes of the
// streams before it, each rounded up to 16 (ops/cuda_pack.py::
// wire_offsets), so no 16-byte store holds bytes of two streams; its bytes
// past its count, up to that boundary, are zero.
//
// Bound on this card: HBM bytes, each stream's bytes read once and written
// once.  Design: the offsets and the choice of source are read from the
// tables or totals on the card, so no host wait comes before the launch.
// blockIdx.y is the stream; a CTA past its stream's bytes leaves, the
// others first sum the padded counts of the streams before theirs.  Each
// thread then takes a 16-byte vector of output a turn: a 16-byte load of
// four source words (scalar loads at a row's ragged end), the bytes past
// the source's count zeroed (the words past a stream's end are never
// written by the packers), on the fallback a funnel shift by one bit with
// the word before (out[k] = v[k - 1] << 31 | v[k] >> 1 on big-endian
// values: no shift of 32 or more), each word's bytes swapped by
// __byte_perm, one 16-byte store.
#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "dict_table.cuh"

namespace {

constexpr int kEmitThreads = 256;
constexpr long long kEmitCtas = 8 * 132;  // a full H100 at 256 threads a CTA

struct WirePlan {
    long long src_bytes;  // the bytes read: the stream's, or the inner one's
    long long out_bytes;  // the wire bytes: src_bytes, one more on the
                          // fallback; 0 for a refused stream
    bool fallback;
};

__device__ __forceinline__ long long pad16(long long n) {
    return (n + 15) & ~15LL;
}

// Stream b's plan from its table (tables != null) or its total.  `cap`, the
// most bytes its inner words can give, bounds what a table says (a coded
// stream is never longer than its inner one): the host raises where it
// would bind.
__device__ WirePlan wire_plan(const int32_t* tables, const long long* totals,
                              long long b, long long cap) {
    WirePlan p{0, 0, false};
    long long bits;
    if (tables != nullptr) {
        const long long* meta = reinterpret_cast<const long long*>(
            tables + b * ie::kTableWords + ie::kTableMeta);
        const long long inner = meta[ie::kMetaInnerBits];
        if (inner < 0 || meta[ie::kMetaError] != 0) return p;
        p.fallback = meta[ie::kMetaFallback] != 0;
        bits = p.fallback ? inner : meta[ie::kMetaOutTotal];
    } else {
        bits = totals[b];
        if (bits < 0) return p;
    }
    p.src_bytes = (bits + 7) / 8;
    p.out_bytes = min(p.src_bytes + (p.fallback ? 1LL : 0LL), cap);
    return p;
}

// Word k's bytes at or past `nbytes` zeroed (the shift is 8, 16 or 24).
__device__ __forceinline__ uint32_t keep_bytes(uint32_t w, long long k,
                                               long long nbytes) {
    const long long keep = nbytes - 4 * k;
    if (keep <= 0) return 0u;
    return keep >= 4 ? w : w & (0xFFFFFFFFu << (8 * (4 - (int)keep)));
}

// Word k of a row of n words, zero before it, past it and past nbytes.
__device__ __forceinline__ uint32_t src_word(const uint32_t* row,
                                             long long n, long long k,
                                             long long nbytes) {
    if (k < 0 || k >= n || 4 * k >= nbytes) return 0u;
    return keep_bytes(__ldg(row + k), k, nbytes);
}

__device__ long long block_sum(long long v) {
    __shared__ long long warp_sums[kEmitThreads / 32];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
    __syncthreads();
    long long s = 0;
    for (int w = 0; w < kEmitThreads / 32; w++) s += warp_sums[w];
    return s;
}

__device__ __forceinline__ uint32_t swap_bytes(uint32_t w) {
    return __byte_perm(w, 0u, 0x0123);
}

__global__ void __launch_bounds__(kEmitThreads) emit_wire_kernel(
        const uint32_t* inner, long long inner_stride, long long inner_words,
        const uint32_t* payload, long long payload_stride,
        long long payload_words, const int32_t* tables,
        const long long* totals, unsigned char* out) {
    const long long b = blockIdx.y;
    const long long cap = 4 * inner_words + 1;
    const WirePlan p = wire_plan(tables, totals, b, cap);
    const long long n_vec = (p.out_bytes + 15) / 16;
    const long long first = (long long)blockIdx.x * kEmitThreads;
    if (first >= n_vec) return;  // uniform over the CTA
    long long before = 0;
    for (long long k = threadIdx.x; k < b; k += kEmitThreads)
        before += pad16(wire_plan(tables, totals, k, cap).out_bytes);
    before = block_sum(before);

    const bool from_inner = tables == nullptr || p.fallback;
    const uint32_t* row = from_inner ? inner + b * inner_stride
                                     : payload + b * payload_stride;
    const long long n = from_inner ? inner_words : payload_words;
    const long long nb = p.src_bytes;
    uint4* dst = reinterpret_cast<uint4*>(out + before);
    for (long long j = first + threadIdx.x; j < n_vec;
         j += (long long)gridDim.x * kEmitThreads) {
        const long long k = 4 * j;
        uint32_t v0, v1, v2, v3;
        if (k + 3 < n && 4 * (k + 4) <= nb) {  // a whole vector of the stream
            const uint4 q = __ldg(reinterpret_cast<const uint4*>(row) + j);
            v0 = q.x;
            v1 = q.y;
            v2 = q.z;
            v3 = q.w;
        } else {
            v0 = src_word(row, n, k, nb);
            v1 = src_word(row, n, k + 1, nb);
            v2 = src_word(row, n, k + 2, nb);
            v3 = src_word(row, n, k + 3, nb);
        }
        if (p.fallback) {  // one 0 bit first: each word takes the last bit
                           // of the word before
            const uint32_t prev = src_word(row, n, k - 1, nb);
            v3 = __funnelshift_r(v3, v2, 1);
            v2 = __funnelshift_r(v2, v1, 1);
            v1 = __funnelshift_r(v1, v0, 1);
            v0 = __funnelshift_r(v0, prev, 1);
        }
        dst[j] = make_uint4(swap_bytes(v0), swap_bytes(v1), swap_bytes(v2),
                            swap_bytes(v3));
    }
}

}  // namespace

// The wire emit.  inner: u32 [n_streams, inner_stride], each row 16-byte
// aligned, its first inner_words words the stream's; payload: u32
// [n_streams, payload_stride] the same, or null; tables: i32 [n_streams,
// kTableWords] (8-byte aligned), or null for totals: i64 [n_streams].
// With tables a payload row is read where a stream is coded, an inner row
// where it falls back; without them the inner rows.  out: u8, 16-byte
// aligned, at least n_streams * pad16(4 * inner_words + 1) bytes, written
// up to the last stream's padded end.
extern "C" int ie_emit_wire(const void* inner, long long inner_stride,
                            long long inner_words, const void* payload,
                            long long payload_stride,
                            long long payload_words, const void* tables,
                            const void* totals, long long n_streams,
                            void* out, void* stream) {
    if (n_streams < 1 || n_streams > 65535 || inner_words < 0 ||
        (tables == nullptr && totals == nullptr) ||
        (tables != nullptr && payload == nullptr))
        return (int)cudaErrorInvalidValue;
    const long long n_vec = (4 * inner_words + 1 + 15) / 16;
    const long long per_stream = std::max(1LL, kEmitCtas / n_streams);
    const long long ctas =
        std::min((n_vec + kEmitThreads - 1) / kEmitThreads, per_stream);
    emit_wire_kernel<<<dim3((unsigned)std::max(1LL, ctas),
                            (unsigned)n_streams),
                       kEmitThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)inner, inner_stride, inner_words,
        (const uint32_t*)payload, payload_stride, payload_words,
        (const int32_t*)tables, (const long long*)totals,
        (unsigned char*)out);
    return (int)cudaGetLastError();
}
