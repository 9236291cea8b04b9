// The f64 block transform shared by K1 (encode.cu) and K5 (transform.cu):
// x = sample - 128, the 2-D DCT in the reference's exact order, * scale,
// / quant, round half away from zero.
//
// For each coefficient j: acc = 0; acc = acc + x[c] * w[c][j] for
// c = 0..K-1, one rounded multiply then one rounded add
// (ops/dct.py::dct2_exact); then acc * scale[j], / quant[j], and a
// trunc-based round half away from zero (pipeline.py::_round_half_away).
// The _rn intrinsics keep every multiply and add separately rounded; the
// library is also built with --fmad=false so no contraction slips in.
// The caller picks the coefficient order through the tables: K1 passes
// weight columns, scales and quant in zig-zag order, K5 in natural order.
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

template <int K>
__device__ __forceinline__ void dct_quantize(
        const double* x, const double* __restrict__ w,
        const double* __restrict__ scale, const double* __restrict__ quant,
        int* q) {
#pragma unroll
    for (int j = 0; j < K; j++) {
        double acc = 0.0;
#pragma unroll
        for (int c = 0; c < K; c++)
            acc = __dadd_rn(acc, __dmul_rn(x[c], __ldg(w + c * K + j)));
        const double y = __dmul_rn(acc, __ldg(scale + j));
        const double z = __ddiv_rn(y, __ldg(quant + j));
        const double t = trunc(z);
        const double d = __dsub_rn(z, t);
        const double r = (d >= 0.5 || d <= -0.5)
            ? (z >= 0.0 ? __dadd_rn(t, 1.0) : __dsub_rn(t, 1.0)) : t;
        q[j] = (int)r;
    }
}

}  // namespace ie
