// Device helpers shared by the encode and pack kernels: an MSB-first bit
// emitter and an int64 block-wide exclusive scan.
//
// The wire format is a big-endian stream of u32 words, MSB first
// (ops/device_pack.words_to_bytes).  A record is a run of fields of at most
// 32 bits each; the emitter appends them to a 64-bit accumulator and hands
// each completed word to a sink.  Every shift below stays under 64 (the
// accumulator) or under 32 (a word): a shift by the full width is
// undefined in CUDA.
#pragma once

#include <cstdint>

namespace ie {

// Appends fields MSB-first and hands each completed u32 word, with its
// index, to `sink`.  `lead` zero bits are emitted first: a record that
// starts at bit `start` of a stream starts `start & 31` bits into its first
// word.
template <class Sink>
struct BitEmitter {
    Sink sink;
    unsigned long long acc;
    int nacc;  // valid low bits of acc, < 32 between calls
    int word;

    __device__ __forceinline__ BitEmitter(Sink s, int lead)
        : sink(s), acc(0ull), nacc(lead), word(0) {}

    __device__ __forceinline__ void put(int nb, uint32_t v) {
        if (nb <= 0) return;
        if (nb < 32) v &= (1u << nb) - 1u;
        acc = (acc << nb) | v;  // nacc + nb < 64
        nacc += nb;
        if (nacc >= 32) {
            nacc -= 32;
            sink(word++, (uint32_t)(acc >> nacc));
            acc &= (1ull << nacc) - 1ull;
        }
    }

    // Flushes the partial last word, zero-padded on the right.
    __device__ __forceinline__ void finish() {
        if (nacc > 0) sink(word++, (uint32_t)(acc << (32 - nacc)));
    }
};

// Exclusive scan of one int64 value per thread across the block.  Every
// thread of the block must call it.  `warp_sums` is shared scratch of 32.
__device__ __forceinline__ long long block_exclusive_scan(
        long long v, long long* warp_sums) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = (blockDim.x + 31) >> 5;
    long long inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const long long t = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += t;
    }
    if (lane == 31) warp_sums[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        long long ws = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const long long t = __shfl_up_sync(0xffffffffu, ws, o);
            if (lane >= o) ws += t;
        }
        if (lane < n_warps) warp_sums[lane] = ws;
    }
    __syncthreads();
    return (warp ? warp_sums[warp - 1] : 0) + inc - v;
}

}  // namespace ie
