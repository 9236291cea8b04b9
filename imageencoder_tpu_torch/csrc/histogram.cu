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
// Bound on this card: HBM bytes (4 per word read) and launch overhead.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kHistThreads = 256;  // one shared bin per thread
constexpr int kWordsPerThread = 16;
constexpr long long kBlockWords = (long long)kHistThreads * kWordsPerThread;

__global__ void __launch_bounds__(kHistThreads) byte_histogram_kernel(
        const uint32_t* __restrict__ words, long long n_words,
        const long long* __restrict__ total_bits, int32_t* __restrict__ hist) {
    __shared__ int bins[kHistThreads];
    const long long nbytes = (total_bits[0] + 7) >> 3;
    const long long w0 = blockIdx.x * kBlockWords;
    if (w0 * 4 >= nbytes) return;  // the whole block lies past the stream
    bins[threadIdx.x] = 0;
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kWordsPerThread; k++) {
        const long long wi = w0 + (long long)k * kHistThreads + threadIdx.x;
        const long long b0 = wi * 4;
        if (wi < n_words && b0 < nbytes) {
            const uint32_t w = words[wi];
#pragma unroll
            for (int j = 0; j < 4; j++)
                if (b0 + j < nbytes)
                    atomicAdd(&bins[(w >> (24 - 8 * j)) & 0xFFu], 1);
        }
    }
    __syncthreads();
    const int c = bins[threadIdx.x];
    if (c) atomicAdd(hist + threadIdx.x, c);
}

}  // namespace

// words: u32 [n_words]; total_bits: i64 [1] on the device; hist: i32 [256],
// zeroed by the caller.
extern "C" int ie_byte_histogram(const void* words, long long n_words,
                                 const void* total_bits, void* hist,
                                 void* stream) {
    if (n_words <= 0) return (int)cudaGetLastError();
    const unsigned grid =
        (unsigned)((n_words + kBlockWords - 1) / kBlockWords);
    byte_histogram_kernel<<<grid, kHistThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, n_words, (const long long*)total_bits,
        (int32_t*)hist);
    return (int)cudaGetLastError();
}
