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
// sign-extended; row-major coefficient c is zig-zag field izz[c], so the
// coefficients come out of zig-zag order as they are read and no register
// array is indexed by data.  The fields are read from shared memory: a
// warp's 32 consecutive blocks have consecutive records, so their fields
// lie in one span of the payload, from the lowest record start to the
// highest field end.  The warp stages that span (16-byte loads, aligned,
// each a coalesced share of the warp's; every byte at or past the payload's
// byte count reads as zero) into its own shared buffer as MSB-first words,
// and each field is then two 32-bit shared loads and a funnel shift.  The
// buffer holds the widest span a stream can give (32 records of B*B
// 15-bit fields with their headers); a warp whose span is wider (records
// that are not consecutive, or a corrupt count that jumps the next record
// far ahead) reads its fields from device memory, four bounded byte
// loads a field, as before.  Then y[c] = (double)coef *
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
// g * the frames' strides.  The frame is the grid's y and a frame's blocks
// its x, so no warp spans two frames (whose records may lie far apart).
// The video decode takes frame k of every GOP in one launch, so a video
// takes gop launches.
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

// A CTA's threads: 128 at 4x4; 256 at 8x8, which read 19% faster so on
// a 4096x912 noise image on an H100 (tools/d3_variants.py), and no faster
// at 4x4.
template <int B>
constexpr int kDecodeThreads = B == 4 ? 128 : 256;
constexpr unsigned kAll = 0xffffffffu;

// A warp's staging buffer.  The widest span of 32 valid records: its
// first field at most 127 bits past the 16-byte boundary below it, then
// 32 records of at most B*B fields of at most 15 bits, 31 of them followed
// by the next record's 4-bit width and count of at most 15 bits; and the
// word after the last field's, which its read takes too.
template <int B>
constexpr long long kSpanBits = 127 + 32LL * 15 * B * B + 31 * (4 + 15);
template <int B>
constexpr int kSpanWords = (int)(((kSpanBits<B> + 31) / 32 + 1 + 3) / 4 * 4);

struct Frames {
    long long n_blocks;    // records (blocks) a frame
    long long n_frames;
    long long rec_stride;  // records from one frame's first to the next's
    long long pred_stride, img_stride;  // bytes from frame to frame
};

__device__ __forceinline__ uint32_t swap_bytes(uint32_t w) {
    return __byte_perm(w, 0u, 0x0123);
}

// The warp's bytes [first, first + 16 * n16) as MSB-first words into
// span, n16 vectors a lane at a time; bytes outside [0, nbytes) read 0.
__device__ __forceinline__ void stage_span(const uint8_t* data,
                                           long long nbytes, long long first,
                                           int n16, uint32_t* span,
                                           int lane) {
    const bool aligned = ((uintptr_t)data & 15) == 0;
    for (int i = lane; i < n16; i += 32) {
        const long long at = first + 16LL * i;
        uint4 v;
        if (aligned && at >= 0 && at + 16 <= nbytes) {
            v = __ldg(reinterpret_cast<const uint4*>(data + at));
        } else {
            uint32_t w[4] = {};
#pragma unroll
            for (int k = 0; k < 16; k++) {
                const long long bi = at + k;
                const uint32_t byte =
                    bi >= 0 && bi < nbytes ? (uint32_t)__ldg(data + bi) : 0u;
                w[k / 4] |= byte << (8 * (k % 4));  // as a little-endian load
            }
            v = make_uint4(w[0], w[1], w[2], w[3]);
        }
        reinterpret_cast<uint4*>(span)[i] =
            make_uint4(swap_bytes(v.x), swap_bytes(v.y), swap_bytes(v.z),
                       swap_bytes(v.w));
    }
}

// y[c] = coefficient c (row-major), dequantized: field s_izz[c] of the
// record, read by field(j) (raw, b bits), sign-extended.
template <int K, class Field>
__device__ __forceinline__ void read_coeffs(const int* s_izz, int b, int cnt,
                                            const double* quant, Field field,
                                            double* y) {
#pragma unroll
    for (int c = 0; c < K; c++) {
        const int j = s_izz[c];
        int v = 0;
        if (b > 0 && j < cnt) {
            uint32_t u = field(j);
            if (u & (1u << (b - 1))) u |= ~0u << b;  // sign-extend
            v = (int)u;
        }
        y[c] = __dmul_rn((double)v, quant[c]);
    }
}

template <int B, bool kPred>
__global__ void __launch_bounds__(kDecodeThreads<B>) decode_blocks_kernel(
        const uint8_t* data, const long long* nbytes_p,
        const long long* offs, const int32_t* dbits, const int32_t* counts,
        Frames fr, const double* quant, const double* wi,
        const int32_t* izz, long long width, const uint8_t* pred,
        uint8_t* img) {
    constexpr int K = B * B;
    __shared__ int s_izz[K];
    __shared__ __align__(16)
        uint32_t s_span[kDecodeThreads<B> / 32][kSpanWords<B>];
    for (int i = threadIdx.x; i < K; i += blockDim.x) s_izz[i] = izz[i];
    __syncthreads();
    const double* const mats[1] = {wi};
    const double* const vecs[1] = {quant};
    const ie::TableCache<K, 1, 1> tables(mats, vecs);
    const int lane = threadIdx.x & 31;
    const long long g = blockIdx.y;  // the frame
    const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const bool valid = n < fr.n_blocks;
    const long long r = g * fr.rec_stride + n;
    const long long nbytes = *nbytes_p;
    const long long off = valid ? offs[r] : 0;
    const int b = valid ? dbits[r] : 0;
    const int cnt = valid ? (counts[r] < K ? counts[r] : K) : 0;
    const long long nf = b > 0 && cnt > 0 ? cnt : 0;  // fields to read

    // The warp's span: from the 16-byte boundary below its first record's
    // start, up to the highest field end.
    const long long first = (__shfl_sync(kAll, off, 0) >> 3) & ~15LL;
    const long long rel = off - 8 * first;
    const long long end = rel + nf * b;
    const bool fits = nf == 0 || (rel >= 0 && end <= kSpanBits<B>);
    double y[K];
    if (__all_sync(kAll, fits)) {
        const unsigned last = __reduce_max_sync(
            kAll, nf == 0 ? 0u : (unsigned)end);
        // Words 0 .. (last - 1) / 32 + 1: a field's read takes its first
        // word and the next.
        const int n16 = last == 0 ? 0 : (int)(((last + 31) / 32 + 1 + 3) / 4);
        uint32_t* span = s_span[threadIdx.x >> 5];
        stage_span(data, nbytes, first, n16, span, lane);
        __syncwarp();
        const int at = (int)rel;
        read_coeffs<K>(s_izz, b, cnt, tables.vec[0], [&](int j) {
            const int p = at + j * b;
            return __funnelshift_l(span[(p >> 5) + 1], span[p >> 5], p & 31)
                   >> (32 - b);
        }, y);
    } else {
        read_coeffs<K>(s_izz, b, cnt, tables.vec[0], [&](int j) {
            return ie::bits_at(data, nbytes, off + (long long)j * b, b);
        }, y);
    }
    if (!valid) return;
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

// The frames in launches of at most 65,535 (the grid's y).
template <int B>
void launch(const uint8_t* data, const long long* nbytes,
            const long long* offs, const int32_t* dbits,
            const int32_t* counts, Frames fr, const double* quant,
            const double* wi, const int32_t* izz, long long width,
            const uint8_t* pred, uint8_t* img, cudaStream_t st) {
    const unsigned gx = (unsigned)((fr.n_blocks + kDecodeThreads<B> - 1)
                                   / kDecodeThreads<B>);
    const long long all = fr.n_frames;
    for (long long g0 = 0; g0 < all; g0 += 65535) {
        fr.n_frames = all - g0 < 65535 ? all - g0 : 65535;
        const dim3 grid(gx, (unsigned)fr.n_frames);
        const long long r0 = g0 * fr.rec_stride;
        uint8_t* im = img + g0 * fr.img_stride;
        if (pred != nullptr)
            decode_blocks_kernel<B, true><<<grid, kDecodeThreads<B>, 0,
                                            st>>>(
                data, nbytes, offs + r0, dbits + r0, counts + r0, fr, quant,
                wi, izz, width, pred + g0 * fr.pred_stride, im);
        else
            decode_blocks_kernel<B, false><<<grid, kDecodeThreads<B>, 0,
                                             st>>>(
                data, nbytes, offs + r0, dbits + r0, counts + r0, fr, quant,
                wi, izz, width, pred, im);
    }
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
