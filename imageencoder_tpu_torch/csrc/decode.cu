// D3: the block decode, on the card.
//
// Replaces the JAX package's host engine decode_to_image_exact
// (imageencoder_tpu/runtime/native/runtime.cpp:2219, body :767-832) and
// its numpy chain (models/image.py:231-274, ops/dct.py:154-172, 204-215,
// 268-271, ops/blockify.py:21-27).  No TPU kernel did this work: the
// JAX package's device inverse (ops/pipeline.py:251-275) is f32 and may
// differ at ties, this one is the exact f64 engine's.
//
// One thread a block: min(count, B*B) fields of b bits at off + j*b,
// each read bounded by the payload's byte count in device memory (zero
// past it), sign-extended; row-major coefficient c is zig-zag field
// izz[c], so the coefficients come out of zig-zag order as they are read
// and no register array is indexed by data.  Then y[c] = (double)coef *
// quant[c] (one rounded multiply), the inverse in idct2_exact's order
// (transform.cuh::exact_matvec: acc = 0, then acc = acc + y[c] * W[c][t]
// for c = 0..K-1, each a __dmul_rn and a __dadd_rn; the library builds
// with --fmad=false), + 128.0, clamped to [0, 255] and truncated (the
// floor for those values), stored straight into the [H, W] image, one
// 4- or 8-byte store a row: the deblockify is the store's addressing.
//
// The host engine skips zero coefficients (runtime.cpp:813); this sums
// all K.  A zero coefficient adds a product of +-0 to the sum: x + (+-0)
// is x for every x but a zero sum, where the sign of the zero may differ,
// and the + 128.0 that follows makes both the same.  So the pixels are
// bit-equal.
//
// Bound: the f64 operations, 544 a 4x4 block (16 dequantize multiplies,
// 256 multiplies, 256 adds, 16 adds of 128): 7.59 us for 233,472 blocks
// at 16.7 T f64 ops/s; the bytes (payload, 16 bytes of record, the
// pixels) take less.  At 4x4 the weights (2 KB) and the quant sit in
// shared memory and every thread reads them at the same address.
#include <cstdint>

#include <cuda_runtime.h>

#include "chain.cuh"
#include "transform.cuh"

namespace {

constexpr int kDecodeThreads = 128;

template <int B>
__global__ void __launch_bounds__(kDecodeThreads) decode_blocks_kernel(const uint8_t* data,
                                     const long long* nbytes_p,
                                     const long long* offs,
                                     const int32_t* dbits,
                                     const int32_t* counts,
                                     long long n_blocks,
                                     const double* quant, const double* wi,
                                     const int32_t* izz, long long width,
                                     uint8_t* img) {
    constexpr int K = B * B;
    __shared__ int s_izz[K];
    for (int i = threadIdx.x; i < K; i += blockDim.x) s_izz[i] = izz[i];
    __syncthreads();
    const double* const mats[1] = {wi};
    const double* const vecs[1] = {quant};
    const ie::TableCache<K, 1, 1> tables(mats, vecs);
    const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= n_blocks) return;
    const long long nbytes = *nbytes_p;
    const long long off = offs[n];
    const int b = dbits[n];
    const int cnt = counts[n] < K ? counts[n] : K;
    double y[K];
#pragma unroll
    for (int c = 0; c < K; c++) {
        const int j = s_izz[c];
        int v = 0;
        if (b > 0 && j < cnt) {
            uint32_t u = ie::bits_at(data, nbytes, off + (long long)j * b, b);
            if (u & (1u << (b - 1))) u |= ~0u << b;  // sign-extend
            v = (int)u;
        }
        y[c] = __dmul_rn((double)v, tables.vec[0][c]);
    }
    double acc[K];
    ie::exact_matvec<K>(y, tables.mat[0], acc);
    const long long wb = width / B;
    uint8_t* base = img + (n / wb) * B * width + (n % wb) * B;
#pragma unroll
    for (int r = 0; r < B; r++) {
        uint32_t px[B / 4] = {};
#pragma unroll
        for (int c = 0; c < B; c++) {
            double v = __dadd_rn(acc[r * B + c], 128.0);
            v = v < 0.0 ? 0.0 : (v > 255.0 ? 255.0 : v);
            px[c / 4] |= (uint32_t)v << (8 * (c % 4));  // trunc == floor
        }
        if constexpr (B == 4) {
            *reinterpret_cast<uint32_t*>(base + r * width) = px[0];
        } else {
            *reinterpret_cast<uint2*>(base + r * width) =
                make_uint2(px[0], px[1]);
        }
    }
}

}  // namespace

// D3.  data: the payload (u8, `nbytes` int64 on the device); offs: int64,
// dbits, counts: int32 [n_blocks] (D2's records); quant: f64 [B*B]
// row-major; wi: f64 [B*B, B*B], the inverse weights (ops/dct.py::
// _inv_weights); izz: int32 [B*B], the zig-zag position of each row-major
// coefficient; img: u8 [H, width], width a multiple of B, 8-byte aligned
// rows for B = 8.  One launch on `stream`.
extern "C" int ie_decode_blocks(const void* data, const void* nbytes,
                                const void* offs, const void* dbits,
                                const void* counts, long long n_blocks,
                                const void* quant, const void* wi,
                                const void* izz, int block_size,
                                long long width, void* img, void* stream) {
    const unsigned grid =
        (unsigned)((n_blocks + kDecodeThreads - 1) / kDecodeThreads);
    const cudaStream_t st = (cudaStream_t)stream;
    if (block_size == 4) {
        decode_blocks_kernel<4><<<grid, kDecodeThreads, 0, st>>>(
            (const uint8_t*)data, (const long long*)nbytes,
            (const long long*)offs, (const int32_t*)dbits,
            (const int32_t*)counts, n_blocks, (const double*)quant,
            (const double*)wi, (const int32_t*)izz, width, (uint8_t*)img);
    } else if (block_size == 8) {
        decode_blocks_kernel<8><<<grid, kDecodeThreads, 0, st>>>(
            (const uint8_t*)data, (const long long*)nbytes,
            (const long long*)offs, (const int32_t*)dbits,
            (const int32_t*)counts, n_blocks, (const double*)quant,
            (const double*)wi, (const int32_t*)izz, width, (uint8_t*)img);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
