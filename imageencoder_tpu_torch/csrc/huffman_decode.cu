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
// chain (chain.cuh): chunks of codewords walk speculatively and a stitch
// on the card finds their true entries; Huffman codes resynchronize
// within a few codewords, so a chunk's walk is almost always adopted.
//
// Bound: bytes, the stream read once and the payload written once (2.1
// MB and 1.5 MB for the 4096x912 image: about 1.1 us at 3.35 TB/s).  The
// design is latency-bound instead: each thread walks ~100 dependent
// table lookups of its chunk three times (walk, check, emit), and the
// stitch is one CTA.
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

__global__ void __launch_bounds__(ie::kStitchThreads)
huffman_stitch_kernel(Args a, long long* count,
                                      long long* stats) {
    const ChainScratch s(a.scratch, a.n_max, (int)a.chunk_bits);
    ie::chain_stitch(walk_of(a), geom_of(a), s, count, stats);
}

struct SymbolSink {
    uint8_t* out;
    __device__ __forceinline__ void operator()(long long i,
                                               const ChainStep& st) const {
        out[i] = (uint8_t)st.val;
    }
};

__global__ void __launch_bounds__(ie::kChainThreads)
huffman_emit_kernel(Args a, uint8_t* out, long long cap) {
    const ChainScratch s(a.scratch, a.n_max, (int)a.chunk_bits);
    ie::chain_emit(walk_of(a), geom_of(a), s, chunk_index(), cap,
                   SymbolSink{out});
}

}  // namespace

// D1.  data: the stream (u8, `nbytes` int64 on the device); start_bit:
// the dict's end; n_chunks: chunks of chunk_bits (a multiple of 32) that
// cover the stream from start_bit; table: u16 [1 << max_len]; out: u8
// [cap]; count: int64 [1], the bytes decoded; scratch: int64
// [ie_chain_scratch_words(n_chunks, chunk_bits)]; stats: int64 [2] or
// null.  Four launches on `stream`, nothing read back.
extern "C" int ie_huffman_decode(const void* data, const void* nbytes,
                                 long long start_bit, long long n_chunks,
                                 int chunk_bits, const void* table,
                                 int max_len, void* out, long long cap,
                                 void* count, void* scratch, void* stats,
                                 void* stream) {
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
    huffman_stitch_kernel<<<1, ie::kStitchThreads, 0, st>>>(
        a, (long long*)count, (long long*)stats);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    huffman_emit_kernel<<<grid, ie::kChainThreads, 0, st>>>(
        a, (uint8_t*)out, cap);
    return (int)cudaGetLastError();
}
