// A block's wire record from its quantized coefficients, shared by K1
// (encode.cu, which computes the coefficients) and K4's pack_coeffs front
// end (pack.cu, which reads them from a coefficient tensor), so both emit
// the same records by construction.
//
// The record (ops/rle.py::block_stats and block_fields): a 4-bit data
// width db, then in RLE mode a db-bit count, then n_payload coefficients
// of db bits each, in zig-zag order, MSB-first.  The stats keep the
// reference's quirks: db is at least ffs(length_full) and at least 1 (the
// ffs(0) clamp), and in RLE mode a block whose last coefficient is nonzero
// after a zero drops that coefficient and its zero run (the trailing-strip
// quirk).
#pragma once

#include <cstdint>
#include <type_traits>
#include <utility>

#include "bits.cuh"

namespace ie {

// The j-th cell of the B x B zig-zag scan, as a row-major index: cells
// sorted by x + y and, within a diagonal, by y where x - y is odd, else by
// x (ops/zigzag.py).  Evaluated by the compiler (see gather_zigzag).
__host__ __device__ constexpr int zigzag_at(int b, int j) {
    for (int i = 0; i < b * b; i++) {
        const int x = i % b, y = i / b;
        const int s = x + y, k = ((x - y) & 1) ? y : x;
        int rank = 0;
        for (int i2 = 0; i2 < b * b; i2++) {
            const int x2 = i2 % b, y2 = i2 / b;
            const int s2 = x2 + y2, k2 = ((x2 - y2) & 1) ? y2 : x2;
            if (s2 < s || (s2 == s && k2 < k)) rank++;
        }
        if (rank == j) return i;
    }
    return -1;
}

// zz[j] = nat[zigzag_at(B, j)] for j = 0..B*B-1, every index a template
// argument, so the permutation is register renaming and no array indexing
// survives into the code.
template <int B, int... J>
__device__ __forceinline__ void gather_zigzag_seq(
        const int* nat, int* zz, std::integer_sequence<int, J...>) {
    ((zz[J] = nat[std::integral_constant<int, zigzag_at(B, J)>::value]), ...);
}

template <int B>
__device__ __forceinline__ void gather_zigzag(const int* nat, int* zz) {
    gather_zigzag_seq<B>(nat, zz, std::make_integer_sequence<int, B * B>{});
}

struct BlockStats {
    int db;         // data width, 1..32
    int count;      // the count field (RLE mode)
    int n_payload;  // coefficients written
    int len;        // record length in bits
};

// The stats of K zig-zag-ordered coefficients.
template <int K>
__device__ __forceinline__ BlockStats block_stats(const int* q, int use_rle) {
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
    BlockStats s;
    s.db = max(max(max_bits, ffs_len), 1);
    if (use_rle) {
        const int gap = (K - 1) - length_head;
        s.count = (length_full == K && gap > 0) ? length_head : length_full;
        s.n_payload = s.count;
    } else {
        s.count = length_full;
        s.n_payload = K;
    }
    s.len = 4 + (use_rle ? s.db : 0) + s.n_payload * s.db;
    return s;
}

// Emits the record MSB-first (the caller finishes the emitter).
template <int K, class Sink>
__device__ __forceinline__ void emit_block(BitEmitter<Sink>& em, const int* q,
                                           const BlockStats& s, int use_rle) {
    em.put(4, (uint32_t)s.db);
    if (use_rle) em.put(s.db, (uint32_t)s.count);
#pragma unroll
    for (int j = 0; j < K; j++)
        if (j < s.n_payload) em.put(s.db, (uint32_t)q[j]);
}

}  // namespace ie
