// K5: block DCT-quantize of a whole image, coefficients in place; and the
// recon P-frame step that fuses K5 with the frame's reconstruction.
//
// Both replace the TPU kernel imageencoder_tpu/ops/pallas_kernels.py
// (_dctq_call, reached through dct_quantize and pipeline.quantize_image,
// the transform of the recon-reference video encode).  For an [H, W]
// image of u8 pixels or int16 residuals K5 writes int32 [H, W]: block
// (r, c), coefficient (u, v) at [B*r + u, B*c + v].  The TPU kernel
// computes in f32 with block-diagonal matmuls over 32x128 tiles and
// differs from the host engine at rounding ties; here one thread takes one
// block and runs the f64 transform of transform.cuh in the reference's
// exact order, the same device function as K1, so the coefficients equal
// the host engine's bit for bit.  K5 runs on I-frames.
//
// The recon step (ie_recon_step) is a recon P-frame's whole frame step,
// one thread a block, in registers: the residual cur - pred, the forward
// transform, the int32 coefficients written in place, the dequantize
// (q * quant, one rounded multiply), the inverse in idct2_exact order
// (acc = 0; acc = acc + y[c] * wi[c][k]), then pred + (acc + 128), clamped
// to [0, 255] and truncated: the u8 reconstruction that becomes the next
// frame's reference, bit-identical to runtime/native.py::
// idct_recon_exact_native, in one launch with nothing in between.
//
// Bound on this card: f64 operations.  A 4x4 block of the recon step reads
// 32 bytes and writes 80 for about 1.1k separately rounded f64 ops (K5:
// about 544), at 64 f64 ops an SM a clock; the tables sit in shared
// memory (transform.cuh), so the inner loops issue only the f64 ops and a
// 16-byte broadcast load per 2 weights.
#include <cstdint>

#include <cuda_runtime.h>

#include "transform.cuh"

namespace {

constexpr int kThreads = 128;

template <int B, class T>
__global__ void __launch_bounds__(kThreads) quantize_image_kernel(
        const T* __restrict__ img, long long width, long long blocks_x,
        long long n_blocks, const double* __restrict__ w,
        const double* __restrict__ scale, const double* __restrict__ quant,
        int32_t* __restrict__ out) {
    constexpr int K = B * B;
    const ie::TableCache<K, 1, 2> tab({w}, {scale, quant});
    const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (n >= n_blocks) return;
    const long long by = n / blocks_x;
    const long long bx = n - by * blocks_x;
    const long long at = by * B * width + bx * B;

    double x[K];
    ie::load_block<B>(img + at, width, x);
    int q[K];
    ie::dct_quantize<K>(x, tab.mat[0], tab.vec[0], tab.vec[1], q);
    int32_t* o = out + at;
#pragma unroll
    for (int r = 0; r < B; r++)
#pragma unroll
        for (int c = 0; c < B; c++) o[r * width + c] = q[r * B + c];
}

// Rows of a block move as 32-bit words of pixels and 16-byte vectors of
// coefficients: B is 4 or 8, W a multiple of 4, the buffers 16-byte
// aligned (the wrapper checks).
template <int B>
__global__ void __launch_bounds__(kThreads) recon_step_kernel(
        const uint8_t* __restrict__ cur, const uint8_t* __restrict__ pred,
        long long width, long long blocks_x, long long n_blocks,
        const double* __restrict__ w, const double* __restrict__ scale,
        const double* __restrict__ quant, const double* __restrict__ wi,
        int32_t* __restrict__ coeffs, uint8_t* __restrict__ recon) {
    constexpr int K = B * B;
    constexpr int kWords = B / 4;  // u32 words of pixels in a block row
    const ie::TableCache<K, 2, 2> tab({w, wi}, {scale, quant});
    const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (n >= n_blocks) return;
    const long long by = n / blocks_x;
    const long long bx = n - by * blocks_x;
    const long long at = by * B * width + bx * B;

    uint32_t pw[B * kWords];  // the prediction, kept for the last step
    double x[K];
#pragma unroll
    for (int r = 0; r < B; r++)
#pragma unroll
        for (int k = 0; k < kWords; k++) {
            const long long o = at + r * width + 4 * k;
            const uint32_t cw = *reinterpret_cast<const uint32_t*>(cur + o);
            pw[r * kWords + k] = *reinterpret_cast<const uint32_t*>(pred + o);
#pragma unroll
            for (int s = 0; s < 4; s++) {
                const int res = (int)((cw >> (8 * s)) & 0xFFu)
                    - (int)((pw[r * kWords + k] >> (8 * s)) & 0xFFu);
                x[r * B + 4 * k + s] = __dsub_rn((double)res, 128.0);
            }
        }
    int q[K];
    ie::dct_quantize<K>(x, tab.mat[0], tab.vec[0], tab.vec[1], q);
#pragma unroll
    for (int r = 0; r < B; r++)
#pragma unroll
        for (int k = 0; k < B / 4; k++)
            *reinterpret_cast<int4*>(coeffs + at + r * width + 4 * k) =
                make_int4(q[r * B + 4 * k], q[r * B + 4 * k + 1],
                          q[r * B + 4 * k + 2], q[r * B + 4 * k + 3]);

    // Dequantize into x, then the exact-order inverse.
#pragma unroll
    for (int c = 0; c < K; c++) x[c] = __dmul_rn((double)q[c], tab.vec[1][c]);
    double acc[K];
    ie::exact_matvec<K>(x, tab.mat[1], acc);
#pragma unroll
    for (int r = 0; r < B; r++)
#pragma unroll
        for (int k = 0; k < kWords; k++) {
            uint32_t word = 0;
#pragma unroll
            for (int s = 0; s < 4; s++) {
                const int i = r * B + 4 * k + s;
                const double p = (double)((pw[r * kWords + k] >> (8 * s))
                                          & 0xFFu);
                double v = __dadd_rn(p, __dadd_rn(acc[i], 128.0));
                v = v < 0.0 ? 0.0 : (v > 255.0 ? 255.0 : v);
                word |= (uint32_t)v << (8 * s);  // truncates, as the cast
            }
            *reinterpret_cast<uint32_t*>(recon + at + r * width + 4 * k) =
                word;
        }
}

template <class T>
int launch(const T* im, long long width, int block_size, long long blocks_x,
           long long n, const double* w, const double* sc, const double* q,
           int32_t* out, cudaStream_t s) {
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    if (block_size == 4) {
        quantize_image_kernel<4, T><<<grid, kThreads, 0, s>>>(
            im, width, blocks_x, n, w, sc, q, out);
    } else if (block_size == 8) {
        quantize_image_kernel<8, T><<<grid, kThreads, 0, s>>>(
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

// cur, pred: u8 [H, W]; w, wi: f64 [K, K] forward and inverse weights,
// scale and quant f64 [K], natural order; coeffs: i32 [H, W]; recon: u8
// [H, W].  W % 4 == 0 and every buffer 16-byte aligned.
extern "C" int ie_recon_step(const void* cur, const void* pred,
                             long long height, long long width,
                             int block_size, const void* w,
                             const void* scale, const void* quant,
                             const void* wi, void* coeffs, void* recon,
                             void* stream) {
    const long long blocks_x = width / block_size;
    const long long n = blocks_x * (height / block_size);
    if (n <= 0) return (int)cudaGetLastError();
    if (width % 4) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    cudaStream_t s = (cudaStream_t)stream;
    const auto* c = (const uint8_t*)cur;
    const auto* p = (const uint8_t*)pred;
    const auto* wt = (const double*)w;
    const auto* sc = (const double*)scale;
    const auto* q = (const double*)quant;
    const auto* wv = (const double*)wi;
    auto* co = (int32_t*)coeffs;
    auto* re = (uint8_t*)recon;
    if (block_size == 4) {
        recon_step_kernel<4><<<grid, kThreads, 0, s>>>(
            c, p, width, blocks_x, n, wt, sc, q, wv, co, re);
    } else if (block_size == 8) {
        recon_step_kernel<8><<<grid, kThreads, 0, s>>>(
            c, p, width, blocks_x, n, wt, sc, q, wv, co, re);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
