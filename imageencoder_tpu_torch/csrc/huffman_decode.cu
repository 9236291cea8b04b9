// D1: the Huffman payload decoded on the card.
//
// Replaces the JAX package's host decode: huffman_fsm_decode
// (imageencoder_tpu/runtime/native/runtime.cpp:1227, a byte FSM walked in
// speculative chunks on CPU threads) and its Python fallback
// (ops/huffman.py:614-663).  No TPU kernel did this work.
//
// What it computes: the reference's bit-by-bit tree walk from the dict's
// end to the buffer's end (Huffman.cpp:376-383): a leaf emits its symbol
// and the walk restarts at the root; a bit with no child is consumed and
// the walk restarts at the root; a code the buffer's end cuts off emits
// nothing.  Padding bits may decode to symbols, as on the host.
//
// One step of the walk is one lookup.  The host turns the dict into a
// table over L-bit windows (ops/huffman.py::decode_table, L the longest
// code, at most 15): entry = symbol | bits consumed << 8 | emit << 12,
// where the bits consumed end at a leaf or at the first bit with no child.
// The table travels to the card inside the stream's one upload.  A step
// whose bits run past the buffer's end stops the walk.  The walk is a
// chain (chain.cuh): chunks of codewords walk speculatively, a check
// follows the true chain through each from its likely entry, and rounds
// pass each break's exit on (Huffman codes resynchronize within a few
// codewords, so a break rarely outlives a round).  Where chains never
// resynchronize (a run of one codeword, met out of phase) a round moves
// the true chain only one chunk on: where the rounds leave a break, the
// table settles it, since a step is at most max_len bits and a chunk's
// true entry lies in its first max_len bits (chain.cuh 4).
//
// Bound: bytes, the stream read once and the payload written once (2.1
// MB and 1.5 MB for the 4096x912 image: about 1.1 us at 3.35 TB/s).  The
// design is latency-bound instead: each thread walks ~100 dependent
// table lookups of its chunk three times (walk, check, emit); the rounds
// walk again only the chunks after a break, the table (where they left
// one) each chunk from each of its first max_len entries to where it
// meets the walk, and the stitch, one CTA, only scans the CTAs' counts:
// D1 never sweeps.
#include <cstdint>

#include <cuda_runtime.h>

#include "chain.cuh"

namespace {

using ie::ChainGeom;
using ie::ChainScratch;
using ie::ChainStep;

struct HuffmanWalk {
    const uint8_t* data;
    long long nbytes;
    const uint16_t* table;
    int max_len;

    __device__ __forceinline__ ChainStep step(long long pos) const {
        const uint32_t e =
            __ldg(table + ie::bits_at(data, nbytes, pos, max_len));
        const int len = (e >> 8) & 15;
        ChainStep s;
        s.next = pos + len;
        s.off = 0;
        s.val = e & 0xFFu;
        s.width = 0;
        s.emits = (e >> 12) & 1u;
        s.valid = true;
        s.stop = len == 0 || pos + len > 8 * nbytes;  // 0: never built
        return s;
    }
};

struct Args {
    const uint8_t* data;
    const long long* nbytes;
    const uint16_t* table;
    int max_len;
    long long start, chunk_bits, n_max;
    void* scratch;
};

__device__ __forceinline__ HuffmanWalk walk_of(const Args& a) {
    return {a.data, *a.nbytes, a.table, a.max_len};
}

__device__ __forceinline__ ChainGeom geom_of(const Args& a) {
    return ie::chain_geom(a.start, a.chunk_bits, *a.nbytes, a.n_max, false);
}

__device__ __forceinline__ int chunk_index() {
    return (int)(blockIdx.x * blockDim.x + threadIdx.x);
}

__global__ void __launch_bounds__(ie::kChainThreads)
huffman_walk_kernel(Args a) {
    const ChainScratch s(a.scratch, a.n_max, (int)a.chunk_bits);
    ie::chain_walk(walk_of(a), geom_of(a), s, chunk_index());
}

__global__ void __launch_bounds__(ie::kChainThreads)
huffman_check_kernel(Args a) {
    const ChainScratch s(a.scratch, a.n_max, (int)a.chunk_bits);
    ie::chain_check(walk_of(a), geom_of(a), s, chunk_index(), a.n_max);
}

__global__ void __launch_bounds__(ie::kChainThreads)
huffman_round_kernel(Args a, int r) {
    const ChainScratch s(a.scratch, a.n_max, (int)a.chunk_bits);
    ie::chain_round(walk_of(a), geom_of(a), s, chunk_index(), a.n_max, r);
}

// 4. The chain's table, where the rounds left a break: no step is longer
// than max_len bits.
__global__ void __launch_bounds__(ie::kTabThreads)
huffman_table_kernel(Args a, int rounds) {
    const ChainScratch s(a.scratch, a.n_max, (int)a.chunk_bits);
    ie::chain_tabulate(walk_of(a), geom_of(a), s, a.max_len, rounds);
}

__global__ void __launch_bounds__(ie::kStitchThreads)
huffman_table_top_kernel(Args a, int rounds) {
    const ChainScratch s(a.scratch, a.n_max, (int)a.chunk_bits);
    ie::chain_tabulate_top(geom_of(a), s, rounds);
}

__global__ void __launch_bounds__(ie::kChainThreads)
huffman_table_apply_kernel(Args a, int rounds) {
    const ChainScratch s(a.scratch, a.n_max, (int)a.chunk_bits);
    ie::chain_tabulate_apply(geom_of(a), s, chunk_index(), a.n_max, rounds);
}

// The stitch: after the rounds and the table no break is left, so it
// only scans the CTAs' counts (D1 has no sweep).
__global__ void __launch_bounds__(ie::kStitchThreads)
huffman_stitch_kernel(Args a, int rounds, long long* count,
                      long long* stats, int n_stats) {
    const ChainScratch s(a.scratch, a.n_max, (int)a.chunk_bits);
    ie::chain_scan(geom_of(a), s, rounds, count, stats, n_stats,
                   ie::SweepCounts{});
}

constexpr int kStageBytes = 24576;  // the emit's shared symbols a CTA

// 6. Chunk c's symbols from its true entry, at most up to index `cap`.  A
// CTA's chunks write one run of the output (its first index, then a scan
// of its counts): where the run fits kStageBytes, each thread writes its
// symbols to shared memory and the CTA stores the run together, else each
// thread stores its own.
__global__ void __launch_bounds__(ie::kChainThreads)
huffman_emit_kernel(Args a, uint8_t* out, long long cap) {
    __shared__ uint8_t stage[kStageBytes];
    const ChainScratch s(a.scratch, a.n_max, (int)a.chunk_bits);
    const ChainGeom g = geom_of(a);
    const HuffmanWalk w = walk_of(a);
    const int c = chunk_index();
    if ((long long)blockIdx.x * blockDim.x >= g.n_live) return;
    long long idx = ie::chain_base(g, s, c);
    const long long base = s.cbase[blockIdx.x];
    const long long run = min(s.csum[blockIdx.x], max(cap - base, 0ll));
    const bool staged = run <= kStageBytes;  // the same in the whole CTA
    if (c < g.n_live) {
        long long pos = s.entry[c];
        const long long hi = g.hi(c);
        while (pos < hi && idx < cap) {
            const ChainStep st = w.step(pos);
            if (st.stop) break;
            if (st.emits) {
                if (staged)
                    stage[idx - base] = (uint8_t)st.val;
                else
                    out[idx] = (uint8_t)st.val;
                idx++;
            }
            pos = st.next;
        }
    }
    if (!staged) return;
    __syncthreads();
    for (long long i = threadIdx.x; i < run; i += blockDim.x)
        out[base + i] = stage[i];
}

}  // namespace

// D1.  data: the stream (u8, `nbytes` int64 on the device); start_bit:
// the dict's end; n_chunks: chunks of chunk_bits (a multiple of 32) that
// cover the stream from start_bit; table: u16 [1 << max_len]; out: u8
// [cap]; count: int64 [1], the bytes decoded; scratch: int64
// [ie_chain_scratch_words(n_chunks, chunk_bits, 1)]; rounds: 0 ..
// ie::kMaxRounds round launches (the wrapper passes
// cuda_decode.CHAIN_ROUNDS; other counts are for tests, to force the
// table); stats: int64 [n_stats] (ie::ChainStat, the first n_stats) or
// null.  Walk, check, the rounds, the table's three
// launches (which return at once where the rounds left no break), stitch,
// emit on `stream`, nothing read back.
extern "C" int ie_huffman_decode(const void* data, const void* nbytes,
                                 long long start_bit, long long n_chunks,
                                 int chunk_bits, const void* table,
                                 int max_len, void* out, long long cap,
                                 void* count, void* scratch, int rounds,
                                 void* stats, int n_stats, void* stream) {
    if (max_len < 1 || max_len > ie::kTabEnded || rounds < 0 ||
        rounds > ie::kMaxRounds || n_stats < 0)
        return (int)cudaErrorInvalidValue;
    const Args a{(const uint8_t*)data, (const long long*)nbytes,
                 (const uint16_t*)table, max_len, start_bit, chunk_bits,
                 n_chunks, scratch};
    const cudaStream_t st = (cudaStream_t)stream;
    const unsigned grid =
        (unsigned)((n_chunks + ie::kChainThreads - 1) / ie::kChainThreads);
    // A refused launch must not leave the next one to run on stale
    // scratch: stop at the first error.
    cudaError_t e;
    huffman_walk_kernel<<<grid, ie::kChainThreads, 0, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    huffman_check_kernel<<<grid, ie::kChainThreads, 0, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    for (int r = 1; r <= rounds; r++) {
        huffman_round_kernel<<<grid, ie::kChainThreads, 0, st>>>(a, r);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    const unsigned tab_grid = (unsigned)((n_chunks * ie::kTabEntries +
                                          ie::kTabThreads - 1) /
                                         ie::kTabThreads);
    huffman_table_kernel<<<tab_grid, ie::kTabThreads, 0, st>>>(a, rounds);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    huffman_table_top_kernel<<<1, ie::kStitchThreads, 0, st>>>(a, rounds);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    huffman_table_apply_kernel<<<grid, ie::kChainThreads, 0, st>>>(a,
                                                                    rounds);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    huffman_stitch_kernel<<<1, ie::kStitchThreads, 0, st>>>(
        a, rounds, (long long*)count, (long long*)stats, n_stats);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    huffman_emit_kernel<<<grid, ie::kChainThreads, 0, st>>>(
        a, (uint8_t*)out, cap);
    return (int)cudaGetLastError();
}
