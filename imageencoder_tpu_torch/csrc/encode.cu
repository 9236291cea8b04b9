// K1: the encode front end, samples -> per-block register files.
//
// Replaces the TPU kernel imageencoder_tpu/ops/pallas_encode.py
// (_frontend_call, reached through encode_locals and, for video,
// encode_locals_cols).  It reproduces that kernel's output, a register
// file of lw MSB-first words and a bit length per block, but computes the
// transform in f64 in the reference's exact order (transform.cuh), so the
// stream equals the host engine's encode_image / encode_video
// (backend="numpy") byte for byte instead of differing at f32 rounding
// ties.
//
// The input is u8 pixels [H, W] or int16 video samples [F*H, W]: frames
// stacked vertically, I-frame rows holding pixels and P-frame rows the
// residual cur - pred in [-255, 255].  Both take the same -128 bias.  The
// caller sizes the register file for the input's data_bits bound (u8: 6
// words at 4x4, the residual range: 7).  A record longer than lw words is
// refused: the kernel sets *err, keeps the record's length and writes zero
// words for it.  The flag stays on the device until the host reads the
// stream's total, and the host raises there.  Nothing is truncated.
//
// One thread per B x B block: the transform, then the RLE stats of
// ops/rle.py::block_stats (trailing-strip quirk, ffs(0) clamp) and the
// wire fields of block_fields, emitted MSB-first.
//
// Bound on this card: f64 operations.  A 4x4 block reads 16 or 32 bytes
// and writes 28 or 32 (lw words + a length) for about 544 separately
// rounded f64 ops: 256 __dmul_rn and 256 __dadd_rn, with no FMA.  The H100
// SXM issues 64 f64 ops an SM a clock, about 16.7 T such ops/s (its 34
// TFLOP/s counts an FMA as two), so the ops bound it above the bytes.  The
// tables sit in shared memory (transform.cuh); the per-thread stores are
// strided by lw words, which the L2 merges.
#include <cstdint>

#include <cuda_runtime.h>

#include "bits.cuh"
#include "transform.cuh"

namespace {

struct RowSink {
    uint32_t* row;
    __device__ __forceinline__ void operator()(int k, uint32_t w) const {
        row[k] = w;
    }
};

template <int B, class T>
__global__ void encode_locals_kernel(
        const T* __restrict__ img, long long width,
        long long blocks_x, long long n_blocks,
        const double* __restrict__ wz, const double* __restrict__ scale_z,
        const double* __restrict__ quant_z, int use_rle, int lw,
        uint32_t* __restrict__ out_words, int32_t* __restrict__ out_lens,
        int* __restrict__ err) {
    constexpr int K = B * B;
    const ie::TableCache<K, 1, 2> tab({wz}, {scale_z, quant_z});
    const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (n >= n_blocks) return;
    const long long by = n / blocks_x;
    const long long bx = n - by * blocks_x;

    double x[K];
    ie::load_block<B>(img + by * B * width + bx * B, width, x);
    int q[K];
    ie::dct_quantize<K>(x, tab.mat[0], tab.vec[0], tab.vec[1], q);

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
    const int len = 4 + (use_rle ? db : 0) + n_payload * db;
    out_lens[n] = len;

    uint32_t* row = out_words + n * lw;
    if (len > 32 * lw) {  // the register file cannot hold it: refuse
        *err = 1;
        for (int k = 0; k < lw; k++) row[k] = 0u;
        return;
    }
    // Wire fields (ops/rle.py::block_fields): width, count, payload.
    ie::BitEmitter<RowSink> em(RowSink{row}, 0);
    em.put(4, (uint32_t)db);
    if (use_rle) em.put(db, (uint32_t)count);
#pragma unroll
    for (int j = 0; j < K; j++)
        if (j < n_payload) em.put(db, (uint32_t)q[j]);
    em.finish();
    for (int k = em.word; k < lw; k++) row[k] = 0u;
}

template <class T>
int launch(const T* im, long long width, int block_size, long long blocks_x,
           long long n, const double* w, const double* sc, const double* qz,
           int use_rle, int lw, uint32_t* ow, int32_t* ol, int* err,
           cudaStream_t s) {
    const int threads = 128;
    const unsigned grid = (unsigned)((n + threads - 1) / threads);
    if (block_size == 4) {
        encode_locals_kernel<4, T><<<grid, threads, 0, s>>>(
            im, width, blocks_x, n, w, sc, qz, use_rle, lw, ow, ol, err);
    } else if (block_size == 8) {
        encode_locals_kernel<8, T><<<grid, threads, 0, s>>>(
            im, width, blocks_x, n, w, sc, qz, use_rle, lw, ow, ol, err);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

// img: [H, W] of u8 (dtype 0) or int16 (dtype 1); wz: f64 [K, K] forward
// weights with zig-zag-ordered columns; scale_z, quant_z: f64 [K] in
// zig-zag order; out_words: u32 [N, lw]; out_lens: i32 [N]; err: i32 [1],
// zeroed by the caller, set to 1 if any record is longer than lw words.
// Returns the launch's cudaError_t.
extern "C" int ie_encode_locals(
        const void* img, int dtype, long long height, long long width,
        int block_size, const void* wz, const void* scale_z,
        const void* quant_z, int use_rle, int lw, void* out_words,
        void* out_lens, void* err, void* stream) {
    const long long blocks_x = width / block_size;
    const long long n = blocks_x * (height / block_size);
    if (n <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    const auto* w = (const double*)wz;
    const auto* sc = (const double*)scale_z;
    const auto* qz = (const double*)quant_z;
    auto* ow = (uint32_t*)out_words;
    auto* ol = (int32_t*)out_lens;
    auto* e = (int*)err;
    if (dtype == 0)
        return launch((const uint8_t*)img, width, block_size, blocks_x, n, w,
                      sc, qz, use_rle, lw, ow, ol, e, s);
    if (dtype == 1)
        return launch((const int16_t*)img, width, block_size, blocks_x, n, w,
                      sc, qz, use_rle, lw, ow, ol, e, s);
    return (int)cudaErrorInvalidValue;
}
