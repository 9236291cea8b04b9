// K5: block DCT-quantize of a whole image, coefficients in place.
//
// Replaces the TPU kernel imageencoder_tpu/ops/pallas_kernels.py
// (_dctq_call, reached through dct_quantize and pipeline.quantize_image,
// the transform of the recon-reference video encode).  For an [H, W] image
// of u8 pixels or int16 residuals it writes int32 [H, W]: block (r, c),
// coefficient (u, v) at [B*r + u, B*c + v].
//
// The TPU kernel computes in f32 with block-diagonal matmuls over 32x128
// tiles and differs from the host engine at rounding ties.  Here one
// thread takes one block and runs the f64 transform of transform.cuh in
// the reference's exact order, the same device function as K1, with the
// tables in natural order; the coefficients equal the host engine's bit
// for bit.
//
// Bound on this card: HBM bytes and launch overhead.  A 4x4 block reads 16
// or 32 bytes and writes 64 for about 544 f64 flops.
#include <cstdint>

#include <cuda_runtime.h>

#include "transform.cuh"

namespace {

template <int B, class T>
__global__ void quantize_image_kernel(
        const T* __restrict__ img, long long width, long long blocks_x,
        long long n_blocks, const double* __restrict__ w,
        const double* __restrict__ scale, const double* __restrict__ quant,
        int32_t* __restrict__ out) {
    constexpr int K = B * B;
    const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (n >= n_blocks) return;
    const long long by = n / blocks_x;
    const long long bx = n - by * blocks_x;
    const long long at = by * B * width + bx * B;

    double x[K];
    ie::load_block<B>(img + at, width, x);
    int q[K];
    ie::dct_quantize<K>(x, w, scale, quant, q);
    int32_t* o = out + at;
#pragma unroll
    for (int r = 0; r < B; r++)
#pragma unroll
        for (int c = 0; c < B; c++) o[r * width + c] = q[r * B + c];
}

template <class T>
int launch(const T* im, long long width, int block_size, long long blocks_x,
           long long n, const double* w, const double* sc, const double* q,
           int32_t* out, cudaStream_t s) {
    const int threads = 128;
    const unsigned grid = (unsigned)((n + threads - 1) / threads);
    if (block_size == 4) {
        quantize_image_kernel<4, T><<<grid, threads, 0, s>>>(
            im, width, blocks_x, n, w, sc, q, out);
    } else if (block_size == 8) {
        quantize_image_kernel<8, T><<<grid, threads, 0, s>>>(
            im, width, blocks_x, n, w, sc, q, out);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

// img: [H, W] of u8 (dtype 0) or int16 (dtype 1); w: f64 [K, K] forward
// weights, scale and quant f64 [K], all in natural order; out: i32 [H, W].
extern "C" int ie_quantize_image(const void* img, int dtype,
                                 long long height, long long width,
                                 int block_size, const void* w,
                                 const void* scale, const void* quant,
                                 void* out, void* stream) {
    const long long blocks_x = width / block_size;
    const long long n = blocks_x * (height / block_size);
    if (n <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    const auto* wt = (const double*)w;
    const auto* sc = (const double*)scale;
    const auto* q = (const double*)quant;
    auto* o = (int32_t*)out;
    if (dtype == 0)
        return launch((const uint8_t*)img, width, block_size, blocks_x, n,
                      wt, sc, q, o, s);
    if (dtype == 1)
        return launch((const int16_t*)img, width, block_size, blocks_x, n,
                      wt, sc, q, o, s);
    return (int)cudaErrorInvalidValue;
}
