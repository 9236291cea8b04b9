// K5: block DCT-quantize of F frames, coefficients in place; and the
// recon P-frame step that fuses K5 with the frames' reconstruction.
//
// Both replace the TPU kernel imageencoder_tpu/ops/pallas_kernels.py
// (_dctq_call, reached through dct_quantize and pipeline.quantize_image,
// the transform of the recon-reference video encode).  For F frames of
// [H, W] u8 pixels or int16 residuals K5 writes int32 [F, H, W]: block
// (r, c), coefficient (u, v) at [f, B*r + u, B*c + v].  The TPU kernel
// computes in f32 with block-diagonal matmuls over 32x128 tiles and
// differs from the host engine at rounding ties; here one thread takes one
// block at a time and runs the f64 transform of transform.cuh in the
// reference's exact order, the same device function as K1, dividing by an
// integer quant entry through its reciprocal as K1 does (transform.cuh,
// Division), so the coefficients equal the host engine's bit for bit.  K5
// runs on I-frames.
//
// The recon step (ie_recon_step) is the recon P-frames' whole step, one
// thread a block, in registers: the residual cur - pred, the forward
// transform, the int32 coefficients written in place, the dequantize
// (q * quant, one rounded multiply), the inverse in idct2_exact order
// (acc = 0; acc = acc + y[c] * wi[c][k]), then pred + (acc + 128), clamped
// to [0, 255] and truncated: the u8 reconstruction that becomes the next
// frame's reference, bit-identical to runtime/native.py::
// idct_recon_exact_native, in one launch with nothing in between.
//
// Frames.  Every tensor has its own frame stride in elements, so frame k
// of every GOP (x[k::gop]) goes in as it lies, with no copy.  Both kernels
// may also write each block's record length in bits (int32 [F, N], N
// blocks a frame in row-major order): records.cuh's gather_zigzag and
// block_stats on the coefficients the thread holds, the stats K1 and K4's
// pack_coeffs front end use, so K4 can sum them before it packs.
//
// Bound on this card: f64 operations.  A 4x4 block of the recon step reads
// 32 bytes and writes 84 for about 1.1k separately rounded f64 ops (K5:
// about 544), at 64 f64 ops an SM a clock.  The tables sit in shared
// memory (transform.cuh), filled once a CTA.  One launch takes every
// frame, so the grid is large, and it is capped at kSlots CTAs a CTA slot
// of the card, each thread looping over blocks past that: measured
// (tools/k5_variants.py) against one CTA a slot (a single wave whose last
// loop turn runs on a few threads), 2, and one block a thread uncapped,
// 4 a slot is the fastest on the step or within 1%.  The inner loops
// issue only the f64 ops and a 16-byte broadcast load per 2 weights, each
// loop turn anew: the tables' loads are the same every turn, and hoisted
// out of the loop they would take 544 (the step: 1,088) doubles of
// registers and spill (keep_loads_in_loop).
#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "records.cuh"
#include "transform.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSlots = 4;  // CTAs a resident CTA slot of the card

// Where block n of the frames lies: frame f, its block b in the frame and
// b's offset there.  Fewer than 2^31 blocks (the entry points check), so
// the divisions are 32-bit.
struct BlockAt {
    long long f, b, at;
};

__device__ __forceinline__ BlockAt block_at(unsigned n, unsigned per_frame,
                                            unsigned blocks_x, int bsize,
                                            long long width) {
    BlockAt p;
    const unsigned f = n / per_frame;
    const unsigned b = n - f * per_frame;
    const unsigned by = b / blocks_x;
    p.f = f;
    p.b = b;
    p.at = ((long long)by * width + (b - by * blocks_x)) * bsize;
    return p;
}

// The record length of the block's coefficients q (natural order).
template <int B>
__device__ __forceinline__ int record_bits(const int* q, int use_rle) {
    int zz[B * B];
    ie::gather_zigzag<B>(q, zz);
    return ie::block_stats<B * B>(zz, use_rle).len;
}

// A block's coefficients out, one 16-byte store a 4-wide row segment.
template <int B>
__device__ __forceinline__ void store_block(int32_t* o, long long width,
                                            const int* q) {
#pragma unroll
    for (int r = 0; r < B; r++)
#pragma unroll
        for (int k = 0; k < B / 4; k++)
            *reinterpret_cast<int4*>(o + r * width + 4 * k) =
                make_int4(q[r * B + 4 * k], q[r * B + 4 * k + 1],
                          q[r * B + 4 * k + 2], q[r * B + 4 * k + 3]);
}

// Frame strides (elements) of a call's tensors, and its lengths' output.
struct Strides {
    long long in, in2, coeffs, recon, lens;
};

template <int B, class T>
__global__ void __launch_bounds__(kThreads) quantize_image_kernel(
        const T* __restrict__ img, long long width, unsigned blocks_x,
        unsigned per_frame, unsigned n_blocks,
        const double* __restrict__ w, const double* __restrict__ scale,
        const double* __restrict__ quant, const double* __restrict__ recip,
        int32_t* __restrict__ out, int32_t* __restrict__ lens, int use_rle,
        Strides s) {
    constexpr int K = B * B;
    const ie::TableCache<K, 1, 3> tab({w}, {scale, quant, recip});
    for (unsigned n = blockIdx.x * blockDim.x + threadIdx.x; n < n_blocks;
         n += gridDim.x * blockDim.x) {
        ie::keep_loads_in_loop();
        const BlockAt p = block_at(n, per_frame, blocks_x, B, width);
        double x[K];
        ie::load_block_vec<B>(img + p.f * s.in + p.at, width, x);
        int q[K];
        ie::dct_quantize<K>(x, tab.mat[0], tab.vec[0], tab.vec[1], q,
                            tab.vec[2]);
        store_block<B>(out + p.f * s.coeffs + p.at, width, q);
        if (lens) lens[p.f * s.lens + p.b] = record_bits<B>(q, use_rle);
    }
}

// Rows of a block move as 32-bit words of pixels and 16-byte vectors of
// coefficients: B is 4 or 8, W a multiple of 4, every frame 16-byte
// aligned (the wrapper checks).
template <int B>
__global__ void __launch_bounds__(kThreads) recon_step_kernel(
        const uint8_t* __restrict__ cur, const uint8_t* __restrict__ pred,
        long long width, unsigned blocks_x, unsigned per_frame,
        unsigned n_blocks, const double* __restrict__ w,
        const double* __restrict__ scale, const double* __restrict__ quant,
        const double* __restrict__ recip, const double* __restrict__ wi,
        int32_t* __restrict__ coeffs, uint8_t* __restrict__ recon,
        int32_t* __restrict__ lens, int use_rle, Strides s) {
    constexpr int K = B * B;
    constexpr int kWords = B / 4;  // u32 words of pixels in a block row
    const ie::TableCache<K, 2, 3> tab({w, wi}, {scale, quant, recip});
    for (unsigned n = blockIdx.x * blockDim.x + threadIdx.x; n < n_blocks;
         n += gridDim.x * blockDim.x) {
        ie::keep_loads_in_loop();
        const BlockAt p = block_at(n, per_frame, blocks_x, B, width);
        const uint8_t* c = cur + p.f * s.in + p.at;
        const uint8_t* pr = pred + p.f * s.in2 + p.at;

        uint32_t pw[B * kWords];  // the prediction, kept for the last step
        double x[K];
#pragma unroll
        for (int r = 0; r < B; r++)
#pragma unroll
            for (int k = 0; k < kWords; k++) {
                const long long o = r * width + 4 * k;
                const uint32_t cw = *reinterpret_cast<const uint32_t*>(c + o);
                pw[r * kWords + k] =
                    *reinterpret_cast<const uint32_t*>(pr + o);
#pragma unroll
                for (int t = 0; t < 4; t++) {
                    const int res = (int)((cw >> (8 * t)) & 0xFFu)
                        - (int)((pw[r * kWords + k] >> (8 * t)) & 0xFFu);
                    x[r * B + 4 * k + t] = __dsub_rn((double)res, 128.0);
                }
            }
        int q[K];
        ie::dct_quantize<K>(x, tab.mat[0], tab.vec[0], tab.vec[1], q,
                            tab.vec[2]);
        store_block<B>(coeffs + p.f * s.coeffs + p.at, width, q);
        if (lens) lens[p.f * s.lens + p.b] = record_bits<B>(q, use_rle);

        // Dequantize into x, then the exact-order inverse.
#pragma unroll
        for (int j = 0; j < K; j++)
            x[j] = __dmul_rn((double)q[j], tab.vec[1][j]);
        double acc[K];
        ie::exact_matvec<K>(x, tab.mat[1], acc);
        uint8_t* re = recon + p.f * s.recon + p.at;
#pragma unroll
        for (int r = 0; r < B; r++)
#pragma unroll
            for (int k = 0; k < kWords; k++) {
                uint32_t word = 0;
#pragma unroll
                for (int t = 0; t < 4; t++) {
                    const int i = r * B + 4 * k + t;
                    const double pv = (double)((pw[r * kWords + k] >> (8 * t))
                                               & 0xFFu);
                    double v = __dadd_rn(pv, __dadd_rn(acc[i], 128.0));
                    v = v < 0.0 ? 0.0 : (v > 255.0 ? 255.0 : v);
                    word |= (uint32_t)v << (8 * t);  // truncates, as the cast
                }
                *reinterpret_cast<uint32_t*>(re + r * width + 4 * k) = word;
            }
    }
}

// CTAs for n blocks: as many as the card holds at once (kSlots a slot),
// and no more than one a kThreads blocks.
template <class Kernel>
int grid_for(Kernel kernel, long long n, unsigned* grid) {
    int per_sm = 0, dev = 0, sms = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, 0);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const long long need = (n + kThreads - 1) / kThreads;
    *grid = (unsigned)std::max(
        1ll, std::min(need, (long long)kSlots * std::max(per_sm, 1) * sms));
    return 0;
}

// The tables (f64): the forward weights w [K, K], scale, quant and its
// reciprocals [K], natural order; the recon step's inverse weights wi.
struct Tables {
    const double *w, *scale, *quant, *recip, *wi;
};

template <int B, class T>
int launch_quantize(const T* im, long long width, unsigned blocks_x,
                    unsigned per_frame, unsigned n, const Tables& t,
                    int32_t* out, int32_t* lens, int use_rle,
                    const Strides& st, cudaStream_t s) {
    unsigned grid = 0;
    const int e = grid_for(quantize_image_kernel<B, T>, n, &grid);
    if (e) return e;
    quantize_image_kernel<B, T><<<grid, kThreads, 0, s>>>(
        im, width, blocks_x, per_frame, n, t.w, t.scale, t.quant, t.recip,
        out, lens, use_rle, st);
    return (int)cudaGetLastError();
}

template <class T>
int launch(const T* im, long long width, int block_size, unsigned blocks_x,
           unsigned per_frame, unsigned n, const Tables& t, int32_t* out,
           int32_t* lens, int use_rle, const Strides& st, cudaStream_t s) {
    if (block_size == 4)
        return launch_quantize<4>(im, width, blocks_x, per_frame, n, t, out,
                                  lens, use_rle, st, s);
    if (block_size == 8)
        return launch_quantize<8>(im, width, blocks_x, per_frame, n, t, out,
                                  lens, use_rle, st, s);
    return (int)cudaErrorInvalidValue;
}

template <int B>
int launch_step(const uint8_t* c, const uint8_t* p, long long width,
                unsigned blocks_x, unsigned per_frame, unsigned n,
                const Tables& t, int32_t* co, uint8_t* re, int32_t* lens,
                int use_rle, const Strides& st, cudaStream_t s) {
    unsigned grid = 0;
    const int e = grid_for(recon_step_kernel<B>, n, &grid);
    if (e) return e;
    recon_step_kernel<B><<<grid, kThreads, 0, s>>>(
        c, p, width, blocks_x, per_frame, n, t.w, t.scale, t.quant, t.recip,
        t.wi, co, re, lens, use_rle, st);
    return (int)cudaGetLastError();
}

// Blocks a call covers, or -1 where they are not fewer than 2^31.
long long blocks_of(long long frames, long long height, long long width,
                    int block_size) {
    const long long n = frames * (height / block_size)
                        * (width / block_size);
    return n < (1ll << 31) ? n : -1;
}

}  // namespace

// img: F frames [H, W] of u8 (dtype 0) or int16 (dtype 1), img_stride
// elements apart; w: f64 [K, K] forward weights, scale, quant and recip
// f64 [K] (recip: ops/cuda_encode.py::reciprocals, RN(1/q) for an
// integer quant q in 1..255, else 0), all in natural order; out: i32
// frames [H, W], out_stride apart; lens: i32 [F, (H/B)*(W/B)] rows
// lens_stride apart, each block's record length (use_rle: the RLE
// mode's), or null.  Every frame starts 16-byte aligned; fewer than 2^31
// blocks in all.
extern "C" int ie_quantize_image(const void* img, int dtype,
                                 long long frames, long long img_stride,
                                 long long height, long long width,
                                 int block_size, const void* w,
                                 const void* scale, const void* quant,
                                 const void* recip, void* out,
                                 long long out_stride, void* lens,
                                 long long lens_stride, int use_rle,
                                 void* stream) {
    const long long n = blocks_of(frames, height, width, block_size);
    if (n < 0 || block_size < 1) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const auto blocks_x = (unsigned)(width / block_size);
    const auto per_frame = (unsigned)(blocks_x * (height / block_size));
    cudaStream_t s = (cudaStream_t)stream;
    const Strides st{img_stride, 0, out_stride, 0, lens_stride};
    const Tables t{(const double*)w, (const double*)scale,
                   (const double*)quant, (const double*)recip, nullptr};
    auto* o = (int32_t*)out;
    auto* ln = (int32_t*)lens;
    if (dtype == 0)
        return launch((const uint8_t*)img, width, block_size, blocks_x,
                      per_frame, (unsigned)n, t, o, ln, use_rle, st, s);
    if (dtype == 1)
        return launch((const int16_t*)img, width, block_size, blocks_x,
                      per_frame, (unsigned)n, t, o, ln, use_rle, st, s);
    return (int)cudaErrorInvalidValue;
}

// cur, pred: u8 F frames [H, W], cur_stride and pred_stride apart; w, wi:
// f64 [K, K] forward and inverse weights, scale, quant and recip f64 [K],
// natural order (recip as for ie_quantize_image); coeffs: i32 frames
// [H, W], coeffs_stride apart; recon: u8 frames [H, W], recon_stride
// apart; lens as for ie_quantize_image, or null.  W % 4 == 0, every frame
// 16-byte aligned, fewer than 2^31 blocks in all.
extern "C" int ie_recon_step(const void* cur, long long cur_stride,
                             const void* pred, long long pred_stride,
                             long long frames, long long height,
                             long long width, int block_size, const void* w,
                             const void* scale, const void* quant,
                             const void* recip, const void* wi, void* coeffs,
                             long long coeffs_stride, void* recon,
                             long long recon_stride, void* lens,
                             long long lens_stride, int use_rle,
                             void* stream) {
    const long long n = blocks_of(frames, height, width, block_size);
    if (n < 0 || block_size < 1 || width % 4)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const auto blocks_x = (unsigned)(width / block_size);
    const auto per_frame = (unsigned)(blocks_x * (height / block_size));
    cudaStream_t s = (cudaStream_t)stream;
    const Strides st{cur_stride, pred_stride, coeffs_stride, recon_stride,
                     lens_stride};
    const Tables t{(const double*)w, (const double*)scale,
                   (const double*)quant, (const double*)recip,
                   (const double*)wi};
    const auto* c = (const uint8_t*)cur;
    const auto* p = (const uint8_t*)pred;
    auto* co = (int32_t*)coeffs;
    auto* re = (uint8_t*)recon;
    auto* ln = (int32_t*)lens;
    if (block_size == 4)
        return launch_step<4>(c, p, width, blocks_x, per_frame, (unsigned)n,
                              t, co, re, ln, use_rle, st, s);
    if (block_size == 8)
        return launch_step<8>(c, p, width, blocks_x, per_frame, (unsigned)n,
                              t, co, re, ln, use_rle, st, s);
    return (int)cudaErrorInvalidValue;
}
