// The f64 block transform shared by K1 (encode.cu), K5 and the recon step
// (transform.cu): x = sample - 128, the 2-D DCT in the reference's exact
// order, * scale, / quant, round half away from zero; and, for the recon
// step, the exact-order inverse.
//
// Division.  K5 and the step divide by __ddiv_rn.  K1 divides by an
// integer quant q in 1..255 through its reciprocal r = RN(1/q), taken on
// the host: z0 = RN(y * r), e = y - z0 * q (one FMA, exact), z =
// RN(e * r + z0) (one FMA).  For those q that z equals RN(y / q) bit for
// bit (tests/test_torch_division.py emulates it with exact rationals;
// chip_smoke.py's division sweep runs it beside __ddiv_rn on the card).
// The two explicit FMAs are part of the division, not contractions of the
// DCT's multiplies and adds, which stay separately rounded.  A quant entry
// outside 1..255 has r = 0 in the table and keeps __ddiv_rn.
//
// For each coefficient j: acc = 0; acc = acc + x[c] * w[c][j] for
// c = 0..K-1, one rounded multiply then one rounded add
// (ops/dct.py::dct2_exact); then acc * scale[j], / quant[j], and a
// trunc-based round half away from zero (pipeline.py::_round_half_away).
// The _rn intrinsics keep every multiply and add separately rounded; the
// library is also built with --fmad=false so no contraction slips in.
// The caller picks the coefficient order through the tables: K1 passes
// weight columns, scales and quant in zig-zag order, K5 in natural order.
//
// Tables.  A CTA copies its tables into shared memory once (TableCache),
// and every thread then reads them at warp-uniform addresses: a broadcast,
// no bank conflicts.  At 4x4 the sum runs c-outer over 16 accumulators,
// so each weight row w[c][0..15] is read as 8 16-byte loads; each
// coefficient's own order (c = 0..15) is unchanged.  At 8x8 the tables
// (32 KB each) stay in global memory and the sum runs j-outer, one
// accumulator at a time, to keep registers in bounds.
#pragma once

#include <cstdint>

namespace ie {

// The B x B block at p (row pitch `pitch` samples), biased by -128.  The
// sample type is u8 (pixels) or int16 (video residuals cur - pred).
template <int B, class T>
__device__ __forceinline__ void load_block(const T* p, long long pitch,
                                           double* x) {
#pragma unroll
    for (int r = 0; r < B; r++)
#pragma unroll
        for (int c = 0; c < B; c++)
            x[r * B + c] = __dsub_rn((double)p[r * pitch + c], 128.0);
}

// K1's loader: the B x B block at p, one vector load a row (B samples of
// 1 or 2 bytes: 4, 8 or 16 bytes), each sample biased by -128 in integer
// arithmetic and converted once; the value equals load_block's.  Rows
// must be aligned to their own size (the wrapper checks the base; W % B
// == 0 does the rest).
template <int Bytes> struct VecOf;
template <> struct VecOf<4> { using type = uint32_t; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<16> { using type = uint4; };

template <int B, class T>
__device__ __forceinline__ void load_block_vec(const T* p, long long pitch,
                                               double* x) {
    constexpr int kBytes = B * (int)sizeof(T);
    constexpr int kWords = kBytes / 4;
    using Vec = typename VecOf<kBytes>::type;
#pragma unroll
    for (int r = 0; r < B; r++) {
        const Vec v = *reinterpret_cast<const Vec*>(p + r * pitch);
        uint32_t w[kWords];
        if constexpr (kWords == 1) {
            w[0] = v;
        } else if constexpr (kWords == 2) {
            w[0] = v.x; w[1] = v.y;
        } else {
            w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
        }
#pragma unroll
        for (int c = 0; c < B; c++) {
            int s;
            if constexpr (sizeof(T) == 1)
                s = (int)((w[c / 4] >> (8 * (c % 4))) & 0xFFu);
            else
                s = (int)(int16_t)(w[c / 2] >> (16 * (c % 2)));
            x[r * B + c] = __int2double_rn(s - 128);
        }
    }
}

// A loop over blocks calls this at the top of each turn: to the compiler it
// may write any memory, so the tables' loads, the same every turn, are not
// hoisted out of the loop into registers (hundreds of doubles, spilled).
// It emits no instruction.
__device__ __forceinline__ void keep_loads_in_loop() {
    asm volatile("" ::: "memory");
}

// Whether a K-coefficient transform keeps its tables in shared memory.
template <int K>
constexpr bool kSharedTables = K <= 16;

// N tables of K*K doubles and M of K doubles, in shared memory where
// kSharedTables<K>, else the global pointers as given.  Construct it in
// every thread of the CTA before any thread returns: it synchronizes.
template <int K, int N, int M>
struct TableCache {
    static constexpr bool kShared = kSharedTables<K>;
    const double* mat[N];
    const double* vec[M];

    __device__ __forceinline__ TableCache(const double* const (&gm)[N],
                                          const double* const (&gv)[M]) {
        if constexpr (kShared) {
            __shared__ __align__(16) double s_mat[N][K * K];
            __shared__ __align__(16) double s_vec[M][K];
            for (int i = threadIdx.x; i < N * K * K; i += blockDim.x)
                s_mat[i / (K * K)][i % (K * K)] =
                    __ldg(gm[i / (K * K)] + i % (K * K));
            for (int i = threadIdx.x; i < M * K; i += blockDim.x)
                s_vec[i / K][i % K] = __ldg(gv[i / K] + i % K);
            __syncthreads();
#pragma unroll
            for (int t = 0; t < N; t++) mat[t] = s_mat[t];
#pragma unroll
            for (int t = 0; t < M; t++) vec[t] = s_vec[t];
        } else {
#pragma unroll
            for (int t = 0; t < N; t++) mat[t] = gm[t];
#pragma unroll
            for (int t = 0; t < M; t++) vec[t] = gv[t];
        }
    }
};

// out[j] = 0 + x[0] * m[0][j] + ... + x[K-1] * m[K-1][j], in that order,
// each step a rounded multiply then a rounded add.
template <int K>
__device__ __forceinline__ void exact_matvec(const double* x, const double* m,
                                             double* out) {
    if constexpr (kSharedTables<K>) {
#pragma unroll
        for (int j = 0; j < K; j++) out[j] = 0.0;
#pragma unroll
        for (int c = 0; c < K; c++) {
            const double2* row = reinterpret_cast<const double2*>(m + c * K);
#pragma unroll
            for (int j = 0; j < K / 2; j++) {
                const double2 wv = row[j];
                out[2 * j] = __dadd_rn(out[2 * j], __dmul_rn(x[c], wv.x));
                out[2 * j + 1] = __dadd_rn(out[2 * j + 1],
                                           __dmul_rn(x[c], wv.y));
            }
        }
    } else {
#pragma unroll 1
        for (int j = 0; j < K; j++) {
            double acc = 0.0;
#pragma unroll
            for (int c = 0; c < K; c++)
                acc = __dadd_rn(acc, __dmul_rn(x[c], __ldg(m + c * K + j)));
            out[j] = acc;
        }
    }
}

// The quantized coefficients of x (biased samples) under weights w,
// scale and quant.  With recip (K1), entries with a nonzero reciprocal
// divide through it (see Division above); without, all by __ddiv_rn.
template <int K>
__device__ __forceinline__ void dct_quantize(const double* x, const double* w,
                                             const double* scale,
                                             const double* quant, int* q,
                                             const double* recip = nullptr) {
    double acc[K];
    exact_matvec<K>(x, w, acc);
#pragma unroll
    for (int j = 0; j < K; j++) {
        const double y = __dmul_rn(acc[j], scale[j]);
        double z;
        if (recip != nullptr && recip[j] != 0.0) {  // warp-uniform
            const double r = recip[j];
            const double z0 = __dmul_rn(y, r);
            const double e = __fma_rn(-z0, quant[j], y);
            z = __fma_rn(e, r, z0);
        } else {
            z = __ddiv_rn(y, quant[j]);
        }
        const double t = trunc(z);
        const double d = __dsub_rn(z, t);
        const double r = (d >= 0.5 || d <= -0.5)
            ? (z >= 0.0 ? __dadd_rn(t, 1.0) : __dsub_rn(t, 1.0)) : t;
        q[j] = (int)r;
    }
}

}  // namespace ie
