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
// One thread per B x B block: the transform, then the record of
// records.cuh (the RLE stats and wire fields, shared with K4's
// pack_coeffs), emitted MSB-first.
//
// Bound on this card: f64 operations.  A 4x4 block reads 16 or 32 bytes
// and writes 28 or 32 (lw words + a length) for 544 separately rounded
// f64 ops as the bound counts them: 256 multiplies and 256 adds, then a
// scale multiply and a divide a coefficient.  The H100 SXM issues 64 f64
// ops an SM a clock, about 16.7 T such ops/s (its 34 TFLOP/s counts an
// FMA as two), so the ops bound it above the bytes.  What the design does
// about it:
//   * the divide is a multiply by the host's reciprocal and two FMAs, not
//     __ddiv_rn's seed, Newton chain and slow-path check (transform.cuh);
//   * a row of samples is one 4-, 8- or 16-byte load, biased in integer
//     arithmetic and converted once;
//   * the tables sit in shared memory (transform.cuh);
//   * the CTA's register files are composed in shared memory and leave by
//     coalesced 16-byte stores, the zero words past each record included.
#include <cstdint>

#include <cuda_runtime.h>

#include "bits.cuh"
#include "records.cuh"
#include "transform.cuh"

namespace {

constexpr int kThreads = 128;

struct RowSink {
    uint32_t* row;
    __device__ __forceinline__ void operator()(int k, uint32_t w) const {
        row[k] = w;
    }
};

template <int B, class T>
__global__ void __launch_bounds__(kThreads) encode_locals_kernel(
        const T* __restrict__ img, long long width,
        long long blocks_x, long long n_blocks,
        const double* __restrict__ wz, const double* __restrict__ scale_z,
        const double* __restrict__ quant_z,
        const double* __restrict__ recip_z, int use_rle, int lw,
        uint32_t* __restrict__ out_words, int32_t* __restrict__ out_lens,
        int* __restrict__ err) {
    constexpr int K = B * B;
    extern __shared__ __align__(16) uint32_t stage[];  // [kThreads][lw]
    const ie::TableCache<K, 1, 3> tab({wz}, {scale_z, quant_z, recip_z});
    const long long n0 = blockIdx.x * (long long)kThreads;
    const long long n = n0 + threadIdx.x;
    uint32_t* row = stage + threadIdx.x * lw;

    if (n < n_blocks) {
        const long long by = n / blocks_x;
        const long long bx = n - by * blocks_x;
        double x[K];
        ie::load_block_vec<B>(img + by * B * width + bx * B, width, x);
        int q[K];
        ie::dct_quantize<K>(x, tab.mat[0], tab.vec[0], tab.vec[1], q,
                            tab.vec[2]);
        const ie::BlockStats st = ie::block_stats<K>(q, use_rle);
        out_lens[n] = st.len;
        int k = 0;
        if (st.len > 32 * lw) {  // the register file cannot hold it: refuse
            *err = 1;
        } else {
            ie::BitEmitter<RowSink> em(RowSink{row}, 0);
            ie::emit_block<K>(em, q, st, use_rle);
            em.finish();
            k = em.word;
        }
        for (; k < lw; k++) row[k] = 0u;
    }
    __syncthreads();

    // The CTA's files are one contiguous run of words, 16-byte aligned:
    // n0 * lw words is a multiple of 4.
    const long long rows = min((long long)kThreads, n_blocks - n0);
    const int words = (int)(rows * lw);
    uint32_t* out = out_words + n0 * lw;
    for (int v = threadIdx.x; v < words / 4; v += kThreads)
        reinterpret_cast<uint4*>(out)[v] =
            reinterpret_cast<const uint4*>(stage)[v];
    for (int v = (words / 4) * 4 + threadIdx.x; v < words; v += kThreads)
        out[v] = stage[v];
}

template <int B, class T>
int launch_one(const T* im, long long width, long long blocks_x, long long n,
               const double* w, const double* sc, const double* qz,
               const double* rz, int use_rle, int lw, uint32_t* ow,
               int32_t* ol, int* err, cudaStream_t s) {
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    const size_t smem = (size_t)kThreads * lw * sizeof(uint32_t);
    auto* kernel = encode_locals_kernel<B, T>;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<grid, kThreads, smem, s>>>(im, width, blocks_x, n, w, sc, qz,
                                        rz, use_rle, lw, ow, ol, err);
    return (int)cudaGetLastError();
}

template <class T>
int launch(const T* im, long long width, int block_size, long long blocks_x,
           long long n, const double* w, const double* sc, const double* qz,
           const double* rz, int use_rle, int lw, uint32_t* ow, int32_t* ol,
           int* err, cudaStream_t s) {
    if (block_size == 4)
        return launch_one<4>(im, width, blocks_x, n, w, sc, qz, rz, use_rle,
                             lw, ow, ol, err, s);
    if (block_size == 8)
        return launch_one<8>(im, width, blocks_x, n, w, sc, qz, rz, use_rle,
                             lw, ow, ol, err, s);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// img: [H, W] of u8 (dtype 0) or int16 (dtype 1), 16-byte aligned, W a
// multiple of the block size; wz: f64 [K, K] forward weights with
// zig-zag-ordered columns; scale_z, quant_z, recip_z: f64 [K] in zig-zag
// order, recip_z[j] = RN(1 / quant_z[j]) where that is an integer in
// 1..255, else 0 (divide by __ddiv_rn); out_words: u32 [N, lw], 16-byte
// aligned; out_lens: i32 [N]; err: i32 [1], zeroed by the caller, set to
// 1 if any record is longer than lw words.  Returns the launch's
// cudaError_t.
extern "C" int ie_encode_locals(
        const void* img, int dtype, long long height, long long width,
        int block_size, const void* wz, const void* scale_z,
        const void* quant_z, const void* recip_z, int use_rle, int lw,
        void* out_words, void* out_lens, void* err, void* stream) {
    const long long blocks_x = width / block_size;
    const long long n = blocks_x * (height / block_size);
    if (n <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    const auto* w = (const double*)wz;
    const auto* sc = (const double*)scale_z;
    const auto* qz = (const double*)quant_z;
    const auto* rz = (const double*)recip_z;
    auto* ow = (uint32_t*)out_words;
    auto* ol = (int32_t*)out_lens;
    auto* e = (int*)err;
    if (dtype == 0)
        return launch((const uint8_t*)img, width, block_size, blocks_x, n, w,
                      sc, qz, rz, use_rle, lw, ow, ol, e, s);
    if (dtype == 1)
        return launch((const int16_t*)img, width, block_size, blocks_x, n, w,
                      sc, qz, rz, use_rle, lw, ow, ol, e, s);
    return (int)cudaErrorInvalidValue;
}
