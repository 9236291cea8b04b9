// D3: the block decode, on the card.
//
// Replaces the JAX package's host engine decode_to_image_exact
// (imageencoder_tpu/runtime/native/runtime.cpp:2219, body :767-832) and
// its numpy chain (models/image.py:231-274, ops/dct.py:154-172, 204-215,
// 268-271, ops/blockify.py:21-27); with a prediction, the P-frame engine
// decode_residual_to_image_exact (runtime.cpp:2245, the same body) and
// the numpy chain of models/video.py:637-647.  No TPU kernel did this work: the
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
// With a prediction (a P-frame) the pixel is (double)pred + (acc + 128.0),
// each add a __dadd_rn, then the clamp and the truncation, in the host
// engine's order (runtime.cpp:820-829); the prediction's row is one load.
//
// One launch decodes a set of frames: G frames of n_blocks records each,
// frame g's records at g * rec_stride, its prediction and its pixels at
// g * the frames' strides.  The video decode takes frame k of every GOP in
// one launch, so a video takes gop launches.
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

struct Frames {
    long long n_blocks;    // records (blocks) a frame
    long long n_frames;
    long long rec_stride;  // records from one frame's first to the next's
    long long pred_stride, img_stride;  // bytes from frame to frame
};

template <int B, bool kPred>
__global__ void __launch_bounds__(kDecodeThreads) decode_blocks_kernel(
        const uint8_t* data, const long long* nbytes_p,
        const long long* offs, const int32_t* dbits, const int32_t* counts,
        Frames fr, const double* quant, const double* wi,
        const int32_t* izz, long long width, const uint8_t* pred,
        uint8_t* img) {
    constexpr int K = B * B;
    __shared__ int s_izz[K];
    for (int i = threadIdx.x; i < K; i += blockDim.x) s_izz[i] = izz[i];
    __syncthreads();
    const double* const mats[1] = {wi};
    const double* const vecs[1] = {quant};
    const ie::TableCache<K, 1, 1> tables(mats, vecs);
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= fr.n_blocks * fr.n_frames) return;
    const long long g = t / fr.n_blocks, n = t - g * fr.n_blocks;
    const long long r = g * fr.rec_stride + n;
    const long long nbytes = *nbytes_p;
    const long long off = offs[r];
    const int b = dbits[r];
    const int cnt = counts[r] < K ? counts[r] : K;
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
    const long long at = (n / wb) * B * width + (n % wb) * B;
    uint8_t* base = img + g * fr.img_stride + at;
    const uint8_t* pbase = kPred ? pred + g * fr.pred_stride + at : nullptr;
#pragma unroll
    for (int rr = 0; rr < B; rr++) {
        uint32_t pw[B / 4] = {};
        if constexpr (kPred) {
            if constexpr (B == 4) {
                pw[0] = *reinterpret_cast<const uint32_t*>(pbase + rr * width);
            } else {
                const uint2 p2 =
                    *reinterpret_cast<const uint2*>(pbase + rr * width);
                pw[0] = p2.x;
                pw[1] = p2.y;
            }
        }
        uint32_t px[B / 4] = {};
#pragma unroll
        for (int c = 0; c < B; c++) {
            double v = __dadd_rn(acc[rr * B + c], 128.0);
            if constexpr (kPred)
                v = __dadd_rn((double)((pw[c / 4] >> (8 * (c % 4))) & 0xFFu),
                              v);
            v = v < 0.0 ? 0.0 : (v > 255.0 ? 255.0 : v);
            px[c / 4] |= (uint32_t)v << (8 * (c % 4));  // trunc == floor
        }
        if constexpr (B == 4) {
            *reinterpret_cast<uint32_t*>(base + rr * width) = px[0];
        } else {
            *reinterpret_cast<uint2*>(base + rr * width) =
                make_uint2(px[0], px[1]);
        }
    }
}

template <int B>
void launch(const uint8_t* data, const long long* nbytes,
            const long long* offs, const int32_t* dbits,
            const int32_t* counts, const Frames& fr, const double* quant,
            const double* wi, const int32_t* izz, long long width,
            const uint8_t* pred, uint8_t* img, cudaStream_t st) {
    const long long n = fr.n_blocks * fr.n_frames;
    const unsigned grid = (unsigned)((n + kDecodeThreads - 1)
                                     / kDecodeThreads);
    if (pred != nullptr)
        decode_blocks_kernel<B, true><<<grid, kDecodeThreads, 0, st>>>(
            data, nbytes, offs, dbits, counts, fr, quant, wi, izz, width,
            pred, img);
    else
        decode_blocks_kernel<B, false><<<grid, kDecodeThreads, 0, st>>>(
            data, nbytes, offs, dbits, counts, fr, quant, wi, izz, width,
            pred, img);
}

}  // namespace

// D3.  data: the payload (u8, `nbytes` int64 on the device); offs: int64,
// dbits, counts: int32 (D2's records), n_frames rows of n_blocks records,
// row g at g * rec_stride; quant: f64 [B*B] row-major; wi: f64 [B*B,
// B*B], the inverse weights (ops/dct.py::_inv_weights); izz: int32
// [B*B], the zig-zag position of each row-major coefficient; pred: u8
// frames [H, width] at pred_stride bytes apart, or null (no prediction);
// img: u8 frames [H, width] at img_stride bytes apart.  width is a
// multiple of B, and for B = 8 rows start 8-byte aligned.  One launch on
// `stream`.
extern "C" int ie_decode_blocks(const void* data, const void* nbytes,
                                const void* offs, const void* dbits,
                                const void* counts, long long n_blocks,
                                long long n_frames, long long rec_stride,
                                const void* quant, const void* wi,
                                const void* izz, int block_size,
                                long long width, const void* pred,
                                long long pred_stride, void* img,
                                long long img_stride, void* stream) {
    if (n_blocks * n_frames <= 0) return (int)cudaGetLastError();
    const Frames fr{n_blocks, n_frames, rec_stride, pred_stride,
                    img_stride};
    const cudaStream_t st = (cudaStream_t)stream;
    if (block_size == 4) {
        launch<4>((const uint8_t*)data, (const long long*)nbytes,
                  (const long long*)offs, (const int32_t*)dbits,
                  (const int32_t*)counts, fr, (const double*)quant,
                  (const double*)wi, (const int32_t*)izz, width,
                  (const uint8_t*)pred, (uint8_t*)img, st);
    } else if (block_size == 8) {
        launch<8>((const uint8_t*)data, (const long long*)nbytes,
                  (const long long*)offs, (const int32_t*)dbits,
                  (const int32_t*)counts, fr, (const double*)quant,
                  (const double*)wi, (const int32_t*)izz, width,
                  (const uint8_t*)pred, (uint8_t*)img, st);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
