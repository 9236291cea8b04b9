// K1: the encode front end, pixels -> per-block register files.
//
// Replaces the TPU kernel imageencoder_tpu/ops/pallas_encode.py
// (_frontend_call, reached through encode_locals).  It reproduces that
// kernel's output, a register file of lw MSB-first words and a bit length
// per block, but computes the transform in f64 in the reference's exact
// order, so the stream equals the host engine's encode_image(backend=
// "numpy") byte for byte instead of differing at f32 rounding ties.
//
// One thread per B x B block:
//   x = pixel - 128; for each coefficient j (in zig-zag order, the host
//   permutes the weight columns): acc = 0, acc += x[c] * w[c][j] for
//   c = 0..K-1 (one rounded multiply, then one rounded add), then
//   acc * scale[j], / quant[j], round half away from zero
//   (ops/dct.py::dct2_exact, pipeline.py::_round_half_away);
//   then the RLE stats of ops/rle.py::block_stats (trailing-strip quirk,
//   ffs(0) clamp) and the wire fields of block_fields, emitted MSB-first.
//
// The _rn intrinsics keep every multiply and add separately rounded; the
// library is also built with --fmad=false so no contraction slips in.
//
// Bound on this card: HBM bytes and launch overhead.  A 4x4 block reads 16
// bytes and writes 28 (6 words + a length) for about 512 f64 flops, which
// the H100 SXM runs at 34 TFLOP/s without tensor cores; the per-thread
// stores are strided by lw words, which the L2 merges.
#include <cstdint>

#include <cuda_runtime.h>

#include "bits.cuh"

namespace {

struct RowSink {
    uint32_t* row;
    int lw;
    __device__ __forceinline__ void operator()(int k, uint32_t w) const {
        if (k < lw) row[k] = w;
    }
};

template <int B>
__global__ void encode_locals_kernel(
        const uint8_t* __restrict__ img, long long width,
        long long blocks_x, long long n_blocks,
        const double* __restrict__ wz, const double* __restrict__ scale_z,
        const double* __restrict__ quant_z, int use_rle, int lw,
        uint32_t* __restrict__ out_words, int32_t* __restrict__ out_lens) {
    constexpr int K = B * B;
    const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (n >= n_blocks) return;
    const long long by = n / blocks_x;
    const long long bx = n - by * blocks_x;
    const uint8_t* p = img + by * B * width + bx * B;

    double x[K];
#pragma unroll
    for (int r = 0; r < B; r++)
#pragma unroll
        for (int c = 0; c < B; c++)
            x[r * B + c] = __dsub_rn((double)p[r * width + c], 128.0);

    int q[K];
#pragma unroll
    for (int j = 0; j < K; j++) {
        double acc = 0.0;
#pragma unroll
        for (int c = 0; c < K; c++)
            acc = __dadd_rn(acc, __dmul_rn(x[c], __ldg(wz + c * K + j)));
        const double y = __dmul_rn(acc, __ldg(scale_z + j));
        const double z = __ddiv_rn(y, __ldg(quant_z + j));
        const double t = trunc(z);
        const double d = __dsub_rn(z, t);
        const double r = (d >= 0.5 || d <= -0.5)
            ? (z >= 0.0 ? __dadd_rn(t, 1.0) : __dsub_rn(t, 1.0)) : t;
        q[j] = (int)r;
    }

    // RLE stats (ops/rle.py::block_stats).
    int length_full = 0, length_head = 0, max_bits = 0;
#pragma unroll
    for (int j = 0; j < K; j++) {
        const int v = q[j];
        if (v != 0) {
            length_full = j + 1;
            if (j < K - 1) length_head = j + 1;
            const unsigned mag = v >= 0 ? (unsigned)v : (unsigned)(-v - 1);
            max_bits = max(max_bits, 33 - __clz((int)mag));  // bits_needed
        }
    }
    const int ffs_len = 32 - __clz(length_full);
    const int db = max(max(max_bits, ffs_len), 1);
    int count, n_payload;
    if (use_rle) {
        const int gap = (K - 1) - length_head;
        count = (length_full == K && gap > 0) ? length_head : length_full;
        n_payload = count;
    } else {
        count = length_full;
        n_payload = K;
    }
    out_lens[n] = 4 + (use_rle ? db : 0) + n_payload * db;

    // Wire fields (ops/rle.py::block_fields): width, count, payload.
    uint32_t* row = out_words + n * lw;
    ie::BitEmitter<RowSink> em(RowSink{row, lw}, 0);
    em.put(4, (uint32_t)db);
    if (use_rle) em.put(db, (uint32_t)count);
#pragma unroll
    for (int j = 0; j < K; j++)
        if (j < n_payload) em.put(db, (uint32_t)q[j]);
    em.finish();
    for (int k = em.word; k < lw; k++) row[k] = 0u;
}

}  // namespace

// img: u8 [H, W]; wz: f64 [K, K] forward weights with zig-zag-ordered
// columns; scale_z, quant_z: f64 [K] in zig-zag order; out_words: u32
// [N, lw]; out_lens: i32 [N].  Returns the launch's cudaError_t.
extern "C" int ie_encode_locals(
        const void* img, long long height, long long width, int block_size,
        const void* wz, const void* scale_z, const void* quant_z,
        int use_rle, int lw, void* out_words, void* out_lens, void* stream) {
    const long long blocks_x = width / block_size;
    const long long n = blocks_x * (height / block_size);
    if (n <= 0) return (int)cudaGetLastError();
    const int threads = 128;
    const unsigned grid = (unsigned)((n + threads - 1) / threads);
    cudaStream_t s = (cudaStream_t)stream;
    const auto* im = (const uint8_t*)img;
    const auto* w = (const double*)wz;
    const auto* sc = (const double*)scale_z;
    const auto* qz = (const double*)quant_z;
    auto* ow = (uint32_t*)out_words;
    auto* ol = (int32_t*)out_lens;
    if (block_size == 4) {
        encode_locals_kernel<4><<<grid, threads, 0, s>>>(
            im, width, blocks_x, n, w, sc, qz, use_rle, lw, ow, ol);
    } else if (block_size == 8) {
        encode_locals_kernel<8><<<grid, threads, 0, s>>>(
            im, width, blocks_x, n, w, sc, qz, use_rle, lw, ow, ol);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
