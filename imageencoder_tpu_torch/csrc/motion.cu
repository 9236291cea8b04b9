// K6 and K7: motion search and motion-compensated prediction.
//
// K6 motion_search replaces the TPU kernel
// imageencoder_tpu/ops/pallas_motion.py (_sad_maps_call, reached through
// sad_maps_pallas in video_pipeline.sad_motion_search) together with the
// descent that reads its maps (video_pipeline.py:155-169).  The TPU builds
// all D^2 = (2*merange - 1)^2 translation SAD maps, because per-window
// gathers are slow there, and then descends by lookups.  The descent
// reads only 9 candidates a level, so here each macroblock is searched
// directly, one warp per 16x16 macroblock and 8 neighbouring macroblocks
// of one macroblock row per CTA:
//   * the CTA's reachable reference window goes into shared memory: the
//     positions clip(pos + off, 0, dim - 16) for |off| <= span, where span
//     = merange/2 + merange/4 + ... + 1 bounds every candidate offset, plus
//     the 16 pixels of a block (158 x 46 bytes at merange 16, less at the
//     border).  A window larger than 48 KB (merange above ~80) is read
//     from global memory instead, through the same indexing;
//   * lane l holds 8 current pixels, row l / 2, columns 8 * (l % 2) + 0..7.
//     A candidate's SAD is 8 absolute differences a lane, summed across
//     the warp by xor shuffles, so every lane holds it and runs the same
//     serial step of the reference descent (ops/motion.py,
//     Block.cpp:268-339) in registers: MER_SIGNS order, acceptance on
//     diff <= running so later candidates win ties, running starting each
//     level at the previous level's best, a candidate p > 0 skipped when
//     its clamped (effective) position is the block's own, and the
//     unclamped offset kept as the vector;
//   * the output is int32 [F, Nmb, 2] as (x, y).  There is no limit on the
//     frame's width (the TPU kernel lays macroblock columns over 128
//     lanes).
// Bound on this card: instruction issue (36 candidates of 256 byte reads
// from shared memory a macroblock at merange 16), and the window load.
//
// K7 predict replaces imageencoder_tpu/ops/pallas_motion.py (_predict_call,
// reached through predict_translate_pallas), which on the TPU builds the
// prediction as masked translations to avoid gathers.  Here it is the
// gather itself: one thread copies one 16-byte macroblock row from the
// clamped window, ref[py + r, px .. px + 15] with px = clip(bx + mx, 0,
// W - 16), py = clip(by + my, 0, H - 16) (ops/motion.py::predict_image).
// Bound on this card: HBM bytes, one read of the reference and one write
// of the prediction.
#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMacro = 16;
constexpr int kSearchWarps = 8;  // macroblocks per CTA, one warp each
constexpr int kSearchThreads = 32 * kSearchWarps;
constexpr int kWindowSmemMax = 48 * 1024;
constexpr int kPredictThreads = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return min(max(v, lo), hi);
}

// Sum of the step sizes merange/2, merange/4, ..., 1 (ops/motion.py::
// search_steps): the largest |offset| any candidate can reach.
__host__ __device__ __forceinline__ int search_span(int merange) {
    int span = 0;
    for (int s = merange / 2; s > 0; s /= 2) span += s;
    return span;
}

// grid: (ceil(nbx / kSearchWarps), nby, F).
__global__ void __launch_bounds__(kSearchThreads) motion_search_kernel(
        const uint8_t* __restrict__ cur, const uint8_t* __restrict__ ref,
        int h, int w, int merange, int window_in_smem,
        int32_t* __restrict__ mvec) {
    extern __shared__ uint8_t window[];
    // MER_SIGNS (algo.cpp:90-100) as (x, y), in evaluation order.
    const int sx[9] = {0, 1, 1, 0, -1, -1, -1, 0, 1};
    const int sy[9] = {0, 0, 1, 1, 1, 0, -1, -1, -1};

    const int nbx = w / kMacro;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int mbx0 = blockIdx.x * kSearchWarps;
    const int mbx = mbx0 + warp;
    const int last = min(mbx0 + kSearchWarps, nbx) - 1;
    const int by = blockIdx.y * kMacro;
    const long long f = blockIdx.z;
    const long long plane = (long long)h * w;

    const int span = search_span(merange);
    const int x0 = clampi(mbx0 * kMacro - span, 0, w - kMacro);
    const int y0 = clampi(by - span, 0, h - kMacro);
    const uint8_t* base = ref + f * plane + (long long)y0 * w + x0;
    long long pitch = w;
    if (window_in_smem) {
        const int ww = clampi(last * kMacro + span, 0, w - kMacro) + kMacro
                       - x0;
        const int wh = clampi(by + span, 0, h - kMacro) + kMacro - y0;
        for (int row = warp; row < wh; row += kSearchWarps)
            for (int col = lane; col < ww; col += 32)
                window[row * ww + col] = base[(long long)row * w + col];
        base = window;
        pitch = ww;
    }
    __syncthreads();
    if (mbx >= nbx) return;

    const int bx = mbx * kMacro;
    const int r = lane >> 1;
    const int c0 = (lane & 1) * 8;
    int cv[8];
    const uint8_t* cp = cur + f * plane + (long long)(by + r) * w + bx + c0;
#pragma unroll
    for (int k = 0; k < 8; k++) cv[k] = cp[k];

    int offx = 0, offy = 0, best = 0x7fffffff;
    for (int step = merange / 2; step > 0; step /= 2) {
        int running = best, selx = offx, sely = offy;
#pragma unroll
        for (int p = 0; p < 9; p++) {
            const int cx = offx + sx[p] * step;
            const int cy = offy + sy[p] * step;
            const int px = clampi(bx + cx, 0, w - kMacro);
            const int py = clampi(by + cy, 0, h - kMacro);
            const uint8_t* q = base + (long long)(py - y0 + r) * pitch
                               + (px - x0 + c0);
            int d = 0;
#pragma unroll
            for (int k = 0; k < 8; k++) d += abs(cv[k] - (int)q[k]);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                d += __shfl_xor_sync(0xffffffffu, d, o);
            const bool at_self = px == bx && py == by;
            if (!(p > 0 && at_self) && d <= running) {
                running = d;
                selx = cx;
                sely = cy;
            }
        }
        offx = selx;
        offy = sely;
        best = running;
    }
    if (lane == 0) {
        const long long mb = (long long)blockIdx.y * nbx + mbx;
        int32_t* o = mvec + (f * (long long)nbx * (h / kMacro) + mb) * 2;
        o[0] = offx;
        o[1] = offy;
    }
}

__global__ void __launch_bounds__(kPredictThreads) predict_kernel(
        const uint8_t* __restrict__ ref, const int32_t* __restrict__ mvec,
        long long n_rows, int h, int w, uint8_t* __restrict__ pred) {
    const int nbx = w / kMacro;
    const long long t = blockIdx.x * (long long)kPredictThreads
                        + threadIdx.x;
    if (t >= n_rows * nbx) return;
    const long long fy = t / nbx;            // frame-stacked row f*h + y
    const int mbx = (int)(t - fy * nbx);
    const long long f = fy / h;
    const int y = (int)(fy - f * h);
    const int mb = (y / kMacro) * nbx + mbx;
    const int32_t* mv = mvec + (f * (long long)(nbx * (h / kMacro)) + mb) * 2;
    const int px = clampi(mbx * kMacro + mv[0], 0, w - kMacro);
    const int py = clampi((y / kMacro) * kMacro + mv[1], 0, h - kMacro);
    const uint8_t* src = ref + (f * h + py + y % kMacro) * (long long)w + px;
    uint32_t v[4];
#pragma unroll
    for (int k = 0; k < 4; k++)
        v[k] = (uint32_t)src[4 * k] | ((uint32_t)src[4 * k + 1] << 8)
             | ((uint32_t)src[4 * k + 2] << 16)
             | ((uint32_t)src[4 * k + 3] << 24);
    // The row starts at a multiple of 16 bytes: w % 16 == 0 and the
    // wrapper allocates pred.
    *(uint4*)(pred + fy * w + mbx * kMacro) = make_uint4(v[0], v[1], v[2],
                                                         v[3]);
}

}  // namespace

// cur, ref: u8 [F, H, W] (frame f of cur searched in frame f of ref);
// H, W multiples of 16; mvec: i32 [F, (H/16)*(W/16), 2] as (x, y).
extern "C" int ie_motion_search(const void* cur, const void* ref,
                                long long n_frames, int h, int w,
                                int merange, void* mvec, void* stream) {
    const int nbx = w / kMacro;
    const int nby = h / kMacro;
    if (n_frames <= 0 || nbx <= 0 || nby <= 0)
        return (int)cudaGetLastError();
    if (n_frames > 65535 || nby > 65535) return (int)cudaErrorInvalidValue;
    const long long reach = kMacro + 2LL * search_span(merange);
    const long long ww = std::min<long long>(w, reach
                                             + (kSearchWarps - 1) * kMacro);
    const long long wh = std::min<long long>(h, reach);
    const int in_smem = ww * wh <= kWindowSmemMax;
    const size_t smem = in_smem ? (size_t)(ww * wh) : 0;
    const dim3 grid((unsigned)((nbx + kSearchWarps - 1) / kSearchWarps),
                    (unsigned)nby, (unsigned)n_frames);
    motion_search_kernel<<<grid, kSearchThreads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)cur, (const uint8_t*)ref, h, w, merange, in_smem,
        (int32_t*)mvec);
    return (int)cudaGetLastError();
}

// ref: u8 [F, H, W]; mvec: i32 [F, (H/16)*(W/16), 2]; pred: u8 [F, H, W],
// 16-byte aligned.
extern "C" int ie_predict(const void* ref, const void* mvec,
                          long long n_frames, int h, int w, void* pred,
                          void* stream) {
    const long long n = n_frames * h * (w / kMacro);
    if (n <= 0) return (int)cudaGetLastError();
    const unsigned grid = (unsigned)((n + kPredictThreads - 1)
                                     / kPredictThreads);
    predict_kernel<<<grid, kPredictThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)ref, (const int32_t*)mvec, n_frames * h, h, w,
        (uint8_t*)pred);
    return (int)cudaGetLastError();
}
