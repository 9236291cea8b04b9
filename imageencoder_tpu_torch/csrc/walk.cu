// D2: the offset walk over the block records, on the card.
//
// Replaces the JAX package's host walk: walk_offsets
// (imageencoder_tpu/runtime/native/runtime.cpp:956, speculative chunks
// on CPU threads and a serial stitch) and its Python fallback
// (models/image.py:179-228).  No TPU kernel did this work.
//
// What it computes: from the header's end, n_blocks records, each 4 bits
// of width b, then with RLE b bits of count (else count = B*B), then
// b * count bits of fields; for record i its fields' offset, b and count
// (a count past B*B is kept as read: D3 takes B*B fields), and the bit
// after the last record.  Reads past the payload's byte count give zero
// bits (runtime.cpp:569 read_field): a device buffer holds other bytes
// there, so every read is bounded by the count in device memory.
//
// Design: a chain (chain.cuh).  A record's parse is a pure function of
// its position, so a chunk walker that starts mid-record is right from
// the first position it shares with the true chain.  With RLE a parse
// with a count past B*B cannot start a record of a valid stream: the
// walker refuses it and tries the next bit (runtime.cpp:940-955 does the
// same), and the check steps over such a record if the true chain has
// one.  The chain is open: the last live chunk runs on past the payload,
// through records of zeros, until every record is written.
//
// A video (the JAX package's models/video.py:507-550, one host walk a
// frame) is one chain over the whole payload: n_micro records a frame,
// and before each P-frame's records (frame f, f % gop != 0) a block of
// vbits = 2 * n_macro * mvec_bits bits of vectors that the true chain
// jumps over.  The walkers and the check know no index, so they walk
// vector bits as records and resynchronize later, which is harmless: the
// stitch's sweep (chain.cuh) takes the breaks and the jumps in the
// chain's order (a warp scan of the chunks' and groups' counts finds the
// chunk that holds a frame's last record; the warp walks the true chain
// there to it, jumps, and re-enters the chunks after until the chain
// meets a walker again), and the emitter, which knows its records'
// indices, takes the same jumps and writes each frame's vector start bit
// and record start bit.  A jump in the open last chunk is the emitter's
// alone.  An image is a video of one frame.  A chain without the jumps
// would parse the vector bits as records and, misaligned, take refused
// records of up to 15 * 32767 bits: it need never meet a walker again, so
// the breaks are not followed before the jumps are known.  D2 runs no
// rounds (chain.cuh 3): on the 4096x912 image the check leaves no break,
// and on 3840x2160 two rounds were slower than none (PERF.md); the sweep
// fixes what the check leaves, where it leaves any.
//
// Bound: bytes, the payload read once and 16 bytes a record written (1.5
// MB and 3.7 MB for the 4096x912 image: about 1.6 us at 3.35 TB/s).  The
// walk is latency-bound: two bounded reads a record, ~100 records a
// chunk, three passes.
//
// The vector read (read_vectors_kernel, the host's read_signed_fields,
// runtime.cpp:1472): one thread a field, mvec_bits bits at the frame's
// vector start bit D2 wrote, bounded by the byte count, sign-extended
// (int32 [F, n_macro, 2], zero rows for I-frames).
#include <cstdint>

#include <cuda_runtime.h>

#include "chain.cuh"

namespace {

using ie::ChainGeom;
using ie::ChainScratch;
using ie::ChainStep;

struct RecordWalk {
    const uint8_t* data;
    long long nbytes;
    int k;
    bool rle;

    __device__ __forceinline__ ChainStep step(long long pos) const {
        const uint32_t b = ie::bits_at(data, nbytes, pos, 4);
        long long count, off;
        if (rle) {
            count = ie::bits_at(data, nbytes, pos + 4, (int)b);
            off = pos + 4 + b;
        } else {
            count = k;
            off = pos + 4;
        }
        ChainStep s;
        s.next = off + (long long)b * count;
        s.off = off;
        s.val = (uint32_t)count;
        s.width = b;
        s.emits = true;
        s.valid = !rle || count <= k;
        s.stop = false;
        return s;
    }
};

// A video's frames: n_micro records each; a P-frame's records follow its
// vbits bits of vectors.  Record index i (i records before) starts frame
// i / n_micro where i % n_micro == 0.  As the stitch's jumps
// (chain.cuh): the item counts at which the chain jumps, and how far.
struct Frames {
    long long n_micro, n_frames, vbits;
    int gop;

    // The bits the true chain jumps after `idx` records, at the start of
    // frame idx / n_micro (idx a frame's first record).
    __device__ __forceinline__ long long jump(long long idx) const {
        return (idx / n_micro) % gop ? vbits : 0;
    }
    __host__ __device__ long long next(long long idx) const {
        if (vbits == 0 || gop < 2) return ie::kNever;
        long long f = idx / n_micro + 1;
        if (f % gop == 0) f++;  // an I-frame: no vectors before it
        return f < n_frames ? f * n_micro : ie::kNever;
    }
    __host__ __device__ long long first() const { return next(0); }
    __device__ long long bits(long long) const { return vbits; }
};

struct Args {
    const uint8_t* data;
    const long long* nbytes;
    int k;
    bool rle;
    long long start, chunk_bits, n_max;
    void* scratch;
    Frames fr;
};

__device__ __forceinline__ RecordWalk walk_of(const Args& a) {
    return {a.data, *a.nbytes, a.k, a.rle};
}

__device__ __forceinline__ ChainGeom geom_of(const Args& a) {
    return ie::chain_geom(a.start, a.chunk_bits, *a.nbytes, a.n_max, true);
}

__device__ __forceinline__ int chunk_index() {
    return (int)(blockIdx.x * blockDim.x + threadIdx.x);
}

__global__ void __launch_bounds__(ie::kChainThreads)
offset_walk_kernel(Args a) {
    const ChainScratch s(a.scratch, a.n_max, (int)a.chunk_bits);
    ie::chain_walk(walk_of(a), geom_of(a), s, chunk_index());
}

__global__ void __launch_bounds__(ie::kChainThreads)
offset_check_kernel(Args a) {
    const ChainScratch s(a.scratch, a.n_max, (int)a.chunk_bits);
    ie::chain_check(walk_of(a), geom_of(a), s, chunk_index(), a.n_max);
}

struct RecordSink {
    long long* offs;
    int32_t* dbits;
    int32_t* counts;
    long long* end;
    long long* vstart;  // a frame's vector start bit, or null
    long long* rstart;  // a frame's record start bit, or null
    long long n;
};

// The stitch, one warp: it sweeps where the check left a break or the
// chain jumps, then scans the counts.  kCount: the sweep counts what it
// does (only where stats are asked for).
template <bool kCount>
__global__ void __launch_bounds__(ie::kSweepThreads)
offset_stitch_kernel(Args a, RecordSink sink, long long* stats,
                     int n_stats) {
    const ChainScratch s(a.scratch, a.n_max, (int)a.chunk_bits);
    const ChainGeom g = geom_of(a);
    ie::SweepCounts n;
    if (a.fr.first() != ie::kNever || s.flags[0] != 0)
        ie::chain_sweep<kCount>(walk_of(a), g, s, a.fr, n);
    __syncthreads();
    ie::chain_scan(g, s, 0, nullptr, stats, n_stats, n);
    if (threadIdx.x == 0 && sink.vstart != nullptr) {
        sink.vstart[0] = a.start;
        sink.rstart[0] = a.start;
    }
}

// 6. Chunk c's records from its true entry, with the frames' jumps and
// start bits.
__global__ void __launch_bounds__(ie::kChainThreads)
offset_emit_kernel(Args a, RecordSink sink) {
    const ChainScratch s(a.scratch, a.n_max, (int)a.chunk_bits);
    const ChainGeom g = geom_of(a);
    const RecordWalk w = walk_of(a);
    const int c = chunk_index();
    if ((long long)blockIdx.x * blockDim.x >= g.n_live) return;
    long long idx = ie::chain_base(g, s, c);
    if (c >= g.n_live) return;
    long long pos = s.entry[c];
    long long frame_end = (idx / a.fr.n_micro + 1) * a.fr.n_micro;
    const long long hi = g.hi(c);
    while (pos < hi && idx < sink.n) {
        const ChainStep st = w.step(pos);
        sink.offs[idx] = st.off;
        sink.dbits[idx] = (int32_t)st.width;
        sink.counts[idx] = (int32_t)st.val;
        pos = st.next;
        if (++idx == sink.n) *sink.end = pos;
        if (idx == frame_end && idx < sink.n) {
            const long long jump = a.fr.jump(idx);
            if (sink.vstart != nullptr) {
                const long long f = idx / a.fr.n_micro;
                sink.vstart[f] = pos;
                sink.rstart[f] = pos + jump;
            }
            pos += jump;
            frame_end += a.fr.n_micro;
        }
    }
}

constexpr int kVectorThreads = 256;

__global__ void __launch_bounds__(kVectorThreads)
read_vectors_kernel(const uint8_t* data, const long long* nbytes_p,
                    const long long* vstart, long long n_frames, int gop,
                    long long n_fields, int mb, int32_t* out) {
    const long long t = blockIdx.x * (long long)kVectorThreads + threadIdx.x;
    if (t >= n_frames * n_fields) return;
    const long long f = t / n_fields;
    int32_t v = 0;
    if (f % gop) {
        uint32_t u = ie::bits_at(data, *nbytes_p,
                                 vstart[f] + (t - f * n_fields) * mb, mb);
        if ((u >> (mb - 1)) & 1u) u |= ~0u << mb;  // sign-extend
        v = (int32_t)u;
    }
    out[t] = v;
}

}  // namespace

// int64 words of scratch for n_chunks chunks of chunk_bits: D1's with its
// table (with_table 1), D2's without.
extern "C" int ie_chain_scratch_words(long long n_chunks, int chunk_bits,
                                      int with_table) {
    return (int)ChainScratch::words(n_chunks, chunk_bits, with_table != 0);
}

// D2 over a video.  data: the payload (u8, `nbytes` int64 on the device);
// n_chunks: chunks of chunk_bits (a multiple of 32) that cover the buffer
// from start_bit (frame 0's first record); n_frames frames of n_micro >= 1
// records, a P-frame's (f % gop != 0) after vbits bits of vectors; offs:
// int64 [n_frames * n_micro]; dbits, counts: int32 [the same]; end: int64
// [1]; vstart, rstart: int64 [n_frames], each frame's vector and record
// start bits (equal for an I-frame), or both null (an image is a video of
// one frame, gop 1 and no vector bits); scratch: int64
// [ie_chain_scratch_words(n_chunks, chunk_bits, 0)]; stats: int64
// [n_stats] (ie::ChainStat, the first n_stats) or null.  4 launches on
// `stream`, nothing read back.
extern "C" int ie_walk_video(const void* data, const void* nbytes,
                             long long start_bit, long long n_chunks,
                             int chunk_bits, long long n_micro,
                             long long n_frames, int gop, long long vbits,
                             int use_rle, int block_size, void* offs,
                             void* dbits, void* counts, void* end,
                             void* vstart, void* rstart, void* scratch,
                             void* stats, int n_stats, void* stream) {
    if (n_micro < 1 || n_frames < 1 || gop < 1 || vbits < 0 || n_stats < 0)
        return (int)cudaErrorInvalidValue;
    const Args a{(const uint8_t*)data, (const long long*)nbytes,
                 block_size * block_size, use_rle != 0, start_bit,
                 chunk_bits, n_chunks, scratch,
                 Frames{n_micro, n_frames, vbits, gop}};
    const RecordSink sink{(long long*)offs, (int32_t*)dbits,
                          (int32_t*)counts, (long long*)end,
                          (long long*)vstart, (long long*)rstart,
                          n_micro * n_frames};
    const cudaStream_t st = (cudaStream_t)stream;
    const unsigned grid =
        (unsigned)((n_chunks + ie::kChainThreads - 1) / ie::kChainThreads);
    cudaError_t e;  // stop at the first refused launch, as D1 does
    offset_walk_kernel<<<grid, ie::kChainThreads, 0, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    offset_check_kernel<<<grid, ie::kChainThreads, 0, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if (stats != nullptr)
        offset_stitch_kernel<true><<<1, ie::kSweepThreads, 0, st>>>(
            a, sink, (long long*)stats, n_stats);
    else
        offset_stitch_kernel<false><<<1, ie::kSweepThreads, 0, st>>>(
            a, sink, nullptr, 0);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    offset_emit_kernel<<<grid, ie::kChainThreads, 0, st>>>(a, sink);
    return (int)cudaGetLastError();
}

// The vector read.  data: the payload (u8, `nbytes` int64 on the
// device); vstart: int64 [n_frames], D2's vector start bits; out: int32
// [n_frames, n_fields], n_fields = 2 * n_macro fields of mb (1..16) bits
// each, sign-extended, zero on I-frames (f % gop == 0).  One launch.
extern "C" int ie_read_vectors(const void* data, const void* nbytes,
                               const void* vstart, long long n_frames,
                               int gop, long long n_fields, int mb,
                               void* out, void* stream) {
    if (gop < 1 || mb < 1 || mb > 16) return (int)cudaErrorInvalidValue;
    const long long n = n_frames * n_fields;
    if (n <= 0) return (int)cudaGetLastError();
    read_vectors_kernel<<<(unsigned)((n + kVectorThreads - 1)
                                     / kVectorThreads),
                          kVectorThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, (const long long*)nbytes,
        (const long long*)vstart, n_frames, gop, n_fields, mb,
        (int32_t*)out);
    return (int)cudaGetLastError();
}
