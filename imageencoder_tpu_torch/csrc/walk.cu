// D2: the offset walk over the block records, on the card.
//
// Replaces the JAX package's host walk: walk_offsets
// (imageencoder_tpu/runtime/native/runtime.cpp:956, speculative chunks
// on CPU threads and a serial stitch) and its Python fallback
// (models/image.py:179-228).  No TPU kernel did this work.
//
// What it computes: from the header's end, n_blocks records, each 4 bits
// of width b, then with RLE b bits of count (else count = B*B), then
// b * count bits of fields; for record i its fields' offset, b and count
// (a count past B*B is kept as read: D3 takes B*B fields), and the bit
// after the last record.  Reads past the payload's byte count give zero
// bits (runtime.cpp:569 read_field): a device buffer holds other bytes
// there, so every read is bounded by the count in device memory.
//
// Design: a chain (chain.cuh).  A record's parse is a pure function of
// its position, so a chunk walker that starts mid-record is right from
// the first position it shares with the true chain.  With RLE a parse
// with a count past B*B cannot start a record of a valid stream: the
// walker refuses it and tries the next bit (runtime.cpp:940-955 does the
// same), and the check steps over such a record if the true chain has
// one.  The chain is open: the last live chunk runs on past the payload,
// through records of zeros, until n_blocks records are written.
//
// Bound: bytes, the payload read once and 16 bytes a record written (1.5
// MB and 3.7 MB for the 4096x912 image: about 1.6 us at 3.35 TB/s).  The
// walk is latency-bound: two bounded reads a record, ~100 records a
// chunk, three passes.
#include <cstdint>

#include <cuda_runtime.h>

#include "chain.cuh"

namespace {

using ie::ChainGeom;
using ie::ChainScratch;
using ie::ChainStep;

struct RecordWalk {
    const uint8_t* data;
    long long nbytes;
    int k;
    bool rle;

    __device__ __forceinline__ ChainStep step(long long pos) const {
        const uint32_t b = ie::bits_at(data, nbytes, pos, 4);
        long long count, off;
        if (rle) {
            count = ie::bits_at(data, nbytes, pos + 4, (int)b);
            off = pos + 4 + b;
        } else {
            count = k;
            off = pos + 4;
        }
        ChainStep s;
        s.next = off + (long long)b * count;
        s.off = off;
        s.val = (uint32_t)count;
        s.width = b;
        s.emits = true;
        s.valid = !rle || count <= k;
        s.stop = false;
        return s;
    }
};

struct Args {
    const uint8_t* data;
    const long long* nbytes;
    int k;
    bool rle;
    long long start, chunk_bits, n_max;
    void* scratch;
};

__device__ __forceinline__ RecordWalk walk_of(const Args& a) {
    return {a.data, *a.nbytes, a.k, a.rle};
}

__device__ __forceinline__ ChainGeom geom_of(const Args& a) {
    return ie::chain_geom(a.start, a.chunk_bits, *a.nbytes, a.n_max, true);
}

__device__ __forceinline__ int chunk_index() {
    return (int)(blockIdx.x * blockDim.x + threadIdx.x);
}

__global__ void __launch_bounds__(ie::kChainThreads)
offset_walk_kernel(Args a) {
    const ChainScratch s(a.scratch, a.n_max, (int)a.chunk_bits);
    ie::chain_walk(walk_of(a), geom_of(a), s, chunk_index());
}

__global__ void __launch_bounds__(ie::kChainThreads)
offset_check_kernel(Args a) {
    const ChainScratch s(a.scratch, a.n_max, (int)a.chunk_bits);
    ie::chain_check(walk_of(a), geom_of(a), s, chunk_index(), a.n_max);
}

__global__ void __launch_bounds__(ie::kStitchThreads)
offset_stitch_kernel(Args a, long long* stats) {
    const ChainScratch s(a.scratch, a.n_max, (int)a.chunk_bits);
    ie::chain_stitch(walk_of(a), geom_of(a), s, nullptr, stats);
}

struct RecordSink {
    long long* offs;
    int32_t* dbits;
    int32_t* counts;
    long long* end;
    long long n;
    __device__ __forceinline__ void operator()(long long i,
                                               const ChainStep& st) const {
        offs[i] = st.off;
        dbits[i] = (int32_t)st.width;
        counts[i] = (int32_t)st.val;
        if (i == n - 1) *end = st.next;
    }
};

__global__ void __launch_bounds__(ie::kChainThreads)
offset_emit_kernel(Args a, RecordSink sink) {
    const ChainScratch s(a.scratch, a.n_max, (int)a.chunk_bits);
    ie::chain_emit(walk_of(a), geom_of(a), s, chunk_index(), sink.n, sink);
}

}  // namespace

// int64 words of scratch for n_chunks chunks of chunk_bits (D1 and D2).
extern "C" int ie_chain_scratch_words(long long n_chunks, int chunk_bits) {
    return (int)ChainScratch::words(n_chunks, chunk_bits);
}

// D2.  data: the payload (u8, `nbytes` int64 on the device); n_chunks:
// chunks of chunk_bits (a multiple of 32) that cover the buffer from
// start_bit; offs: int64 [n_blocks]; dbits, counts: int32 [n_blocks];
// end: int64 [1]; scratch: int64 [ie_chain_scratch_words(n_chunks,
// chunk_bits)]; stats: int64 [2] or null.  n_blocks >= 1.  Four launches
// on `stream`, nothing read back.
extern "C" int ie_walk_offsets(const void* data, const void* nbytes,
                               long long start_bit, long long n_chunks,
                               int chunk_bits, long long n_blocks,
                               int use_rle, int block_size, void* offs,
                               void* dbits, void* counts, void* end,
                               void* scratch, void* stats, void* stream) {
    const Args a{(const uint8_t*)data, (const long long*)nbytes,
                 block_size * block_size, use_rle != 0, start_bit,
                 chunk_bits, n_chunks, scratch};
    const cudaStream_t st = (cudaStream_t)stream;
    const unsigned grid =
        (unsigned)((n_chunks + ie::kChainThreads - 1) / ie::kChainThreads);
    cudaError_t e;  // stop at the first refused launch, as D1 does
    offset_walk_kernel<<<grid, ie::kChainThreads, 0, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    offset_check_kernel<<<grid, ie::kChainThreads, 0, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    offset_stitch_kernel<<<1, ie::kStitchThreads, 0, st>>>(
        a, (long long*)stats);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    offset_emit_kernel<<<grid, ie::kChainThreads, 0, st>>>(
        a, RecordSink{(long long*)offs, (int32_t*)dbits, (int32_t*)counts,
                      (long long*)end, n_blocks});
    return (int)cudaGetLastError();
}
