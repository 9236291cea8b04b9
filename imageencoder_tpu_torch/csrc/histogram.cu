// K3: 256-bin byte histogram of a packed u32 word stream.
//
// Replaces the TPU kernel imageencoder_tpu/ops/pallas_kernels.py
// (_hist_call, reached through byte_histogram and
// pipeline.stream_byte_histogram).  Bytes are taken in stream order, w>>24,
// w>>16, w>>8, w&0xFF, and only the first nbytes = ceil(total_bits / 8)
// count.  total_bits is read from device memory, so nothing waits on the
// host between the pack and this kernel.
//
// Each block takes 4096 consecutive words (coalesced, one word per thread
// per step), counts into shared-memory bins, then adds its bins to the
// global histogram with one atomicAdd per nonzero bin.  The word buffer is
// a worst-case bound about 6x the stream, so blocks that lie wholly past
// nbytes exit at once.  The TPU kernel's nibble one-hot matmuls have no
// counterpart here: the card has shared-memory atomics.
//
// The windowed form (ie_byte_histogram_rows) counts the bytes [lo, hi) of
// each row of a batch of word rows, the row the grid's y: the sharded
// encode's segments (parallel/sharding.py), each a row whose word 0 is the
// stream's word base >> 5.  Stage 1 counts the bytes a segment covers
// whole (the JAX package's _segment_byte_histogram, sharding.py:91-103),
// stage 2 the bytes it owns once the junction word is merged in (its code
// bits: the histogram times the code lengths).  Both windows differ from
// the bytes a packer stores (K2 and K4 count every byte of the words they
// write, the junction words too), so the window is counted here, in one
// launch for all of a rank's segments, and the packers stay as the main
// path has them.
//
// Bound on this card: HBM bytes (4 per word read) and launch overhead.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kHistThreads = 256;  // one shared bin per thread
constexpr int kWordsPerThread = 16;
constexpr long long kBlockWords = (long long)kHistThreads * kWordsPerThread;

// This block's words of `words` counted into hist where their bytes lie in
// [lo, hi).  A block wholly outside the window exits at once (the test is
// the same for all its threads).
__device__ __forceinline__ void histogram_block(
        const uint32_t* __restrict__ words, long long n_words, long long lo,
        long long hi, int32_t* __restrict__ hist) {
    __shared__ int bins[kHistThreads];
    const long long w0 = blockIdx.x * kBlockWords;
    if (w0 * 4 >= hi || (w0 + kBlockWords) * 4 <= lo) return;
    bins[threadIdx.x] = 0;
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kWordsPerThread; k++) {
        const long long wi = w0 + (long long)k * kHistThreads + threadIdx.x;
        const long long b0 = wi * 4;
        if (wi < n_words && b0 < hi && b0 + 4 > lo) {
            const uint32_t w = words[wi];
#pragma unroll
            for (int j = 0; j < 4; j++)
                if (b0 + j >= lo && b0 + j < hi)
                    atomicAdd(&bins[(w >> (24 - 8 * j)) & 0xFFu], 1);
        }
    }
    __syncthreads();
    const int c = bins[threadIdx.x];
    if (c) atomicAdd(hist + threadIdx.x, c);
}

__global__ void __launch_bounds__(kHistThreads) byte_histogram_kernel(
        const uint32_t* __restrict__ words, long long n_words,
        const long long* __restrict__ total_bits, int32_t* __restrict__ hist) {
    histogram_block(words, n_words, 0, (total_bits[0] + 7) >> 3, hist);
}

// Row blockIdx.y: words [row * n_words, (row + 1) * n_words), its window
// [lo[row], hi[row]) in bytes of the row, its bins at hist + 256 * row.
__global__ void __launch_bounds__(kHistThreads) byte_histogram_rows_kernel(
        const uint32_t* __restrict__ words, long long n_words,
        const long long* __restrict__ lo, const long long* __restrict__ hi,
        int32_t* __restrict__ hist) {
    const long long r = blockIdx.y;
    histogram_block(words + r * n_words, n_words, lo[r], hi[r],
                    hist + 256 * r);
}

unsigned grid_x(long long n_words) {
    return (unsigned)((n_words + kBlockWords - 1) / kBlockWords);
}

}  // namespace

// words: u32 [n_words]; total_bits: i64 [1] on the device; hist: i32 [256],
// zeroed by the caller.
extern "C" int ie_byte_histogram(const void* words, long long n_words,
                                 const void* total_bits, void* hist,
                                 void* stream) {
    if (n_words <= 0) return (int)cudaGetLastError();
    byte_histogram_kernel<<<grid_x(n_words), kHistThreads, 0,
                            (cudaStream_t)stream>>>(
        (const uint32_t*)words, n_words, (const long long*)total_bits,
        (int32_t*)hist);
    return (int)cudaGetLastError();
}

// words: u32 [n_rows, n_words]; lo, hi: i64 [n_rows] on the device, each
// row's window in bytes of the row; hist: i32 [n_rows, 256], zeroed by the
// caller.  At most 65535 rows.
extern "C" int ie_byte_histogram_rows(const void* words, long long n_words,
                                      long long n_rows, const void* lo,
                                      const void* hi, void* hist,
                                      void* stream) {
    if (n_rows < 0 || n_rows > 65535) return (int)cudaErrorInvalidValue;
    if (n_words <= 0 || n_rows == 0) return (int)cudaGetLastError();
    byte_histogram_rows_kernel<<<dim3(grid_x(n_words), (unsigned)n_rows),
                                 kHistThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, n_words, (const long long*)lo,
        (const long long*)hi, (int32_t*)hist);
    return (int)cudaGetLastError();
}
