// The check behind K1's division: its reciprocal division beside
// __ddiv_rn, on the card, over every integer quant q in 1..255.
//
// K1 (encode.cu, transform.cuh) divides y by q as z0 = RN(y * r),
// e = fma(-z0, q, y), z = fma(e, r, z0) with r = RN(1/q) from the host.
// This entry runs that division and __ddiv_rn side by side and counts the
// quotients whose bits differ (+0 and -0 count as equal: K1 rounds the
// quotient to an integer, which they share).  The y values:
//   * structured: for every q and every integer k with |k| <= k_max, the
//     17 doubles from 8 ulps below to 8 ulps above k*q, (k + 1/2)*q and
//     (k + 1/4)*q: the quotients at and around an integer, a rounding tie
//     of the quantizer, and a quarter;
//   * random: n_random seeded doubles (splitmix64), sign, exponent and
//     mantissa drawn, each divided by every q.
// It is no kernel of the encode path and has no plain version: the CPU
// counterpart is tests/test_torch_division.py, exact rationals.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 255;

__device__ __forceinline__ unsigned long long splitmix64(
        unsigned long long x) {
    x += 0x9E3779B97F4A7C15ull;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
    return x ^ (x >> 31);
}

// The doubles next to y, one ulp up and down.
__device__ __forceinline__ double next_up(double y) {
    if (y == 0.0) return __longlong_as_double(1ll);  // the least subnormal
    const long long b = __double_as_longlong(y);
    return __longlong_as_double(y > 0.0 ? b + 1 : b - 1);
}

__device__ __forceinline__ double next_down(double y) {
    return -next_up(-y);
}

struct Tally {
    unsigned long long* out;  // [0] mismatches, [1] checks, [2] y, [3] q
    unsigned long long bad = 0, checks = 0;

    __device__ __forceinline__ void check(double y, int q, const double* rt) {
        const double qd = (double)q;
        const double r = rt[q];
        const double z0 = __dmul_rn(y, r);
        const double e = __fma_rn(-z0, qd, y);
        const double z = __fma_rn(e, r, z0);
        const double ref = __ddiv_rn(y, qd);
        checks++;
        if (__double_as_longlong(z) != __double_as_longlong(ref)
                && !(z == 0.0 && ref == 0.0)) {
            bad++;
            out[2] = (unsigned long long)__double_as_longlong(y);
            out[3] = (unsigned long long)q;
        }
    }

    __device__ __forceinline__ void flush() {
        if (bad) atomicAdd(out, bad);
        atomicAdd(out + 1, checks);
    }
};

__global__ void __launch_bounds__(kThreads) div_sweep_structured(
        const double* __restrict__ recip, long long k_max,
        unsigned long long* __restrict__ out) {
    const long long ks = 2 * k_max + 1;
    const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
    if (i >= ks * kQ) return;
    const int q = 1 + (int)(i / ks);
    const long long k = i % ks - k_max;
    Tally t{out};
    const double centers[3] = {(double)k * q, ((double)k + 0.5) * q,
                               ((double)k + 0.25) * q};
#pragma unroll 1
    for (int c = 0; c < 3; c++) {
        double y = centers[c];
        for (int d = 0; d < 8; d++) y = next_down(y);
        for (int d = 0; d < 17; d++) {
            t.check(y, q, recip);
            y = next_up(y);
        }
    }
    t.flush();
}

__global__ void __launch_bounds__(kThreads) div_sweep_random(
        const double* __restrict__ recip, long long n, int max_exp,
        unsigned long long seed, unsigned long long* __restrict__ out) {
    const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
    if (i >= n) return;
    const unsigned long long h = splitmix64(seed ^ splitmix64(i));
    // Exponents 2^-24 .. 2^max_exp, a random mantissa and sign.
    const int e = (int)((h >> 53) % (unsigned)(max_exp + 25)) - 24;
    const double m = 1.0 + (double)(h & ((1ull << 52) - 1)) * 0x1p-52;
    const double y = ldexp((h >> 52) & 1 ? -m : m, e);
    Tally t{out};
#pragma unroll 1
    for (int q = 1; q <= kQ; q++) t.check(y, q, recip);
    t.flush();
}

}  // namespace

// recip: f64 [256], recip[q] = RN(1/q) for q in 1..255; out: u64 [4],
// zeroed by the caller: mismatches, checks, and one mismatching (y bits,
// q).  k_max bounds the structured quotients; n_random random y each go
// through every q, with |y| < 2^(max_exp + 1).
extern "C" int ie_div_sweep(const void* recip, long long k_max,
                            long long n_random, int max_exp,
                            unsigned long long seed, void* out,
                            void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const auto* r = (const double*)recip;
    auto* o = (unsigned long long*)out;
    const long long n1 = (2 * k_max + 1) * kQ;
    div_sweep_structured<<<(unsigned)((n1 + kThreads - 1) / kThreads),
                           kThreads, 0, s>>>(r, k_max, o);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || n_random <= 0) return (int)e;
    div_sweep_random<<<(unsigned)((n_random + kThreads - 1) / kThreads),
                       kThreads, 0, s>>>(r, n_random, max_exp, seed, o);
    return (int)cudaGetLastError();
}
