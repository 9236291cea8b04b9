// K2 and K4: the bitstream packer, one kernel body with two front ends.
//
// Replaces the TPU kernels imageencoder_tpu/ops/pallas_pack.py
// _pack_locals_call (K2, reached through pack_locals_pallas) and _pack_call
// (K4, reached through pack_records_pallas).  Both concatenate N
// variable-length records into one MSB-first, big-endian u32 stream that
// starts at bit `start_bit`.  The front ends differ in what a record is:
//   K2 pack_locals:  a register file of lw words plus a bit length, as the
//                    encode front end (encode.cu) writes it;
//   K4 pack_records: F (value, nbits) fields of at most 16 bits, emitted
//                    MSB-first as the thread walks them.
//
// One thread per record.  The record's start is an int64 exclusive scan of
// the record lengths: a shared-memory block scan inside the kernel, on top
// of per-block starts that the wrapper takes from torch.cumsum (as the JAX
// package takes its chunk starts from an XLA cumsum).  Each record is
// funnel-shifted by start & 31 and OR'd in at word start >> 5 with
// atomicOr: records' bits never overlap, so the OR equals the serial
// writer.  Only the first and last word of a record can be shared, and
// zero words are skipped.
//
// The TPU kernel's merge tree, its bit-reversal pre-permute, the capped
// level schedule and the row splice are workarounds for a machine without
// scatter or atomics; none of them has a counterpart here.
//
// Bound on this card: HBM bytes and launch overhead.  K2 reads 28 bytes
// per 4x4 record and writes about 4; K4 reads 8 bytes per field.
#include <cstdint>

#include <cuda_runtime.h>

#include "bits.cuh"

namespace {

constexpr int kPackThreads = 256;

struct StreamSink {
    uint32_t* out;
    long long base;
    long long n_words;
    __device__ __forceinline__ void operator()(int k, uint32_t w) const {
        const long long i = base + k;
        if (w != 0u && i < n_words) atomicOr(out + i, w);
    }
};

__global__ void __launch_bounds__(kPackThreads) pack_locals_kernel(
        const uint32_t* __restrict__ local, const int32_t* __restrict__ lens,
        long long n, int lw, const long long* __restrict__ block_start,
        uint32_t* __restrict__ out, long long n_words) {
    __shared__ long long warp_sums[32];
    const long long i = blockIdx.x * (long long)kPackThreads + threadIdx.x;
    const long long len = i < n ? (long long)lens[i] : 0;
    const long long start =
        block_start[blockIdx.x] + ie::block_exclusive_scan(len, warp_sums);
    if (i >= n || len == 0) return;
    const int s = (int)(start & 31);
    const StreamSink sink{out, start >> 5, n_words};
    const uint32_t* row = local + i * lw;
    const int touched = (int)((s + len + 31) >> 5);
    uint32_t prev = 0u;
    for (int k = 0; k < touched; k++) {
        const uint32_t cur = k < lw ? row[k] : 0u;
        sink(k, s ? ((cur >> s) | (prev << (32 - s))) : cur);
        prev = cur;
    }
}

__global__ void __launch_bounds__(kPackThreads) pack_records_kernel(
        const int32_t* __restrict__ vals, const int32_t* __restrict__ nbits,
        long long n, int f, const long long* __restrict__ block_start,
        uint32_t* __restrict__ out, long long n_words) {
    __shared__ long long warp_sums[32];
    const long long i = blockIdx.x * (long long)kPackThreads + threadIdx.x;
    long long len = 0;
    if (i < n)
        for (int k = 0; k < f; k++) len += nbits[i * f + k];
    const long long start =
        block_start[blockIdx.x] + ie::block_exclusive_scan(len, warp_sums);
    if (i >= n || len == 0) return;
    ie::BitEmitter<StreamSink> em(StreamSink{out, start >> 5, n_words},
                                  (int)(start & 31));
    for (int k = 0; k < f; k++)
        em.put(nbits[i * f + k], (uint32_t)vals[i * f + k]);
    em.finish();
}

}  // namespace

extern "C" int ie_pack_threads() { return kPackThreads; }

extern "C" const char* ie_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// local: u32 [N, lw]; lens: i32 [N]; block_start: i64 [ceil(N / 256)], the
// absolute start bit of each block of 256 records; out: u32 [n_words],
// zeroed or pre-filled with bits that lie before start_bit.
extern "C" int ie_pack_locals(const void* local, const void* lens,
                              long long n, int lw, const void* block_start,
                              void* out, long long n_words, void* stream) {
    if (n <= 0) return (int)cudaGetLastError();
    const unsigned grid = (unsigned)((n + kPackThreads - 1) / kPackThreads);
    pack_locals_kernel<<<grid, kPackThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)local, (const int32_t*)lens, n, lw,
        (const long long*)block_start, (uint32_t*)out, n_words);
    return (int)cudaGetLastError();
}

// vals, nbits: i32 [N, F]; otherwise as ie_pack_locals.
extern "C" int ie_pack_records(const void* vals, const void* nbits,
                               long long n, int f, const void* block_start,
                               void* out, long long n_words, void* stream) {
    if (n <= 0) return (int)cudaGetLastError();
    const unsigned grid = (unsigned)((n + kPackThreads - 1) / kPackThreads);
    pack_records_kernel<<<grid, kPackThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)vals, (const int32_t*)nbits, n, f,
        (const long long*)block_start, (uint32_t*)out, n_words);
    return (int)cudaGetLastError();
}
