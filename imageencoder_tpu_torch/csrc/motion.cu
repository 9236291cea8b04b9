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
// of one macroblock row per CTA.  The output is int32 [F, Nmb, 2] as
// (x, y); there is no limit on the frame's width (the TPU kernel lays
// macroblock columns over 128 lanes).
//
// Bound on this card: HBM bytes set the floor (one read of both frames),
// but the kernel runs well above it on its instructions, 9 candidates of
// 256 byte differences a level.  The design keeps them few:
//   * the CTA's reachable reference window (the positions clip(pos + off,
//     0, dim - 16) for |off| <= span = merange/2 + merange/4 + ... + 1,
//     plus the 16 pixels of a block) is loaded with 16-byte vector loads
//     from a 16-byte aligned column into shared memory, at a pitch of 4
//     mod 8 words (176 x 46 bytes at merange 16).  A window larger than
//     48 KB (merange above about 75) is read from global memory instead,
//     through the same word indexing;
//   * lane l holds the current block's packed u32 words of rows l/4 and
//     l/4 + 8, column word l%4.  A level's 9 candidates take 3 columns
//     and 3 rows; each column's word offset and byte shift, and each
//     row's offset, are computed once a level.  A candidate then costs a
//     lane 4 word loads (conflict-free at that pitch), 2 funnel shifts
//     that align its 4 bytes, and 2 __vsadu4;
//   * the 9 candidates of a level are scored independently, each summed
//     across the warp by one __reduce_add_sync (a single REDUX, which
//     every lane receives; a 16-shuffle transpose reduction of the 9
//     partial sums measured slower);
//   * the reference descent's serial step (ops/motion.py,
//     Block.cpp:268-339) becomes a min over keys in registers: starting
//     from `running` (the previous level's best), acceptance on diff <=
//     running lets the last candidate with the least SAD win, so candidate
//     p's key is (SAD << 5) | (16 - p), `running` enters as
//     (best << 5) | 31, and the least key gives the new best and
//     candidate.  A candidate p > 0 whose clamped (effective) position is
//     the block's own is skipped; the vector keeps the unclamped offset.
//
// K7 predict replaces imageencoder_tpu/ops/pallas_motion.py (_predict_call,
// reached through predict_translate_pallas), which on the TPU builds the
// prediction as masked translations to avoid gathers.  Here it is the
// gather itself, ref[py + r, px .. px + 15] with px = clip(bx + mx, 0,
// W - 16), py = clip(by + my, 0, H - 16) (ops/motion.py::predict_image),
// and on the encode paths it is not a launch of its own: when the descent
// ends, the warp that searched a macroblock still has the block's pixels in
// registers and its CTA the reference window in shared memory, so the
// search's epilogue reads the winning window once more and writes one of
//   * the predicted block, u8 (search_predict: the recon path, whose next
//     launch forms the residual itself); or
//   * the int16 residual cur - pred into the stack [F*H, W] that K1 reads
//     (search_residual: the raw path).  There the kernel takes the whole
//     video: frame f is searched in frame f - 1, and a GOP's first frame,
//     which has no reference, is written as its pixels, so no torch op
//     selects frames, converts them or scatters the residual.
// The search takes a stripe of the frames (the sharded video encode,
// parallel/video_sharding.py): cur holds rows row0 .. row0 + h - 1 of each
// frame, ref is a separate stack whose frame f holds global rows
// row0 - halo .. row0 + h + halo - 1 of cur[f]'s reference (halo rows from
// the neighbouring stripes), and every candidate is clamped in global rows
// to [0, h_glob - 16], so a stripe's vectors are the whole frame's.  A
// whole frame is the stripe row0 = 0, halo = 0, h_glob = h.  In the raw
// path's stripe f0 is the chunk's first global frame: frame f is intra
// where (f0 + f) % gop == 0, and its reference comes from ref like any
// other (the chunk's first frame's from the previous chunk).
// predict_kernel, K7 alone with the vectors given, stays for a decoder,
// which has vectors and no search: one thread copies one 16-byte
// macroblock row through aligned word loads and a funnel shift.
// Bound on this card: HBM bytes, one read of the reference and one write
// of the prediction (the fused kernels: the frames read, the vectors and
// the prediction or the residual written).
#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMacro = 16;
constexpr int kSearchWarps = 8;  // macroblocks per CTA, one warp each
constexpr int kSearchThreads = 32 * kSearchWarps;
constexpr int kWindowSmemMax = 48 * 1024;
constexpr int kPredictThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kBestLow = 31;  // low key bits of the carried best

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return min(max(v, lo), hi);
}

__device__ __forceinline__ long long clampll(long long v, long long lo,
                                             long long hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// Sum of the step sizes merange/2, merange/4, ..., 1 (ops/motion.py::
// search_steps): the largest |offset| any candidate can reach.
__host__ __device__ __forceinline__ int search_span(int merange) {
    int span = 0;
    for (int s = merange / 2; s > 0; s /= 2) span += s;
    return span;
}

// Bytes of a window row of `width` bytes: a multiple of 16 that is 4 mod
// 8 words, so the 32 lanes' word loads of one candidate (8 rows x 4
// neighbouring words) fall in 32 distinct banks.
__host__ __device__ __forceinline__ int window_pitch(int width) {
    return (width % 32 == 0) ? width + 16 : width;
}

// MER_SIGNS (algo.cpp:90-100) as (x, y), in evaluation order, packed two
// bits a candidate as sign + 1: no array a lane indexes at run time.
constexpr unsigned kSignX = 1u | 2u << 2 | 2u << 4 | 1u << 6 | 0u << 8
                            | 0u << 10 | 0u << 12 | 1u << 14 | 2u << 16;
constexpr unsigned kSignY = 1u | 1u << 2 | 2u << 4 | 2u << 6 | 2u << 8
                            | 1u << 10 | 0u << 12 | 0u << 14 | 0u << 16;

__device__ __forceinline__ int sign_x(int p) {
    return (int)((kSignX >> (2 * p)) & 3u) - 1;
}

__device__ __forceinline__ int sign_y(int p) {
    return (int)((kSignY >> (2 * p)) & 3u) - 1;
}

// The 4 window bytes at word `i`, shifted right by `sh` bits (0, 8, 16
// or 24): the candidate column's alignment, the same in every lane.  In
// shared memory the next word is always read (the window has a word of
// slack past its end); in global memory only where the bytes straddle two
// words, so no read passes the frame's end.
template <bool kSmem>
__device__ __forceinline__ uint32_t window_bytes(const uint32_t* win, int i,
                                                 unsigned sh) {
    if constexpr (kSmem) return __funnelshift_r(win[i], win[i + 1], sh);
    const uint32_t lo = __ldg(win + i);
    return sh ? __funnelshift_r(lo, __ldg(win + i + 1), sh) : lo;
}

// Where a search's frames lie in the whole frame (see the header).
struct Stripe {
    int row0;             // global row of cur's first row
    int halo;             // rows of ref above row0 (and below the last)
    int h_glob;           // the frame's height: the clamp
    long long ref_plane;  // bytes from one ref frame to the next
    long long f0;         // global index of frame 0 (kResidual)
};

// P-frames among the frames 0 .. x - 1 of a video in GOPs of gop.
__device__ __forceinline__ long long p_before(long long x, int gop) {
    return x - (x + gop - 1) / gop;
}

// What the search writes besides the vectors.
constexpr int kVectors = 0;   // nothing: K6 alone
constexpr int kPredict = 1;   // the predicted block, u8
constexpr int kResidual = 2;  // cur - pred, int16; intra frames as pixels

// Four pixels less four predicted ones as int16, two to a word.
__device__ __forceinline__ uint2 residual4(uint32_t cur, uint32_t pred) {
    int d[4];
#pragma unroll
    for (int k = 0; k < 4; k++)
        d[k] = (int)((cur >> (8 * k)) & 0xFFu)
               - (int)((pred >> (8 * k)) & 0xFFu);
    return make_uint2(((uint32_t)d[0] & 0xFFFFu) | ((uint32_t)d[1] << 16),
                      ((uint32_t)d[2] & 0xFFFFu) | ((uint32_t)d[3] << 16));
}

// grid: (ceil(nbx / kSearchWarps), nby, F).  Frame f of cur (h rows, the
// stripe st) is searched in frame f of ref.  With gop > 0 (kResidual) frame
// f with (st.f0 + f) % gop == 0 is intra, not searched, and the vectors of
// the others are stored densely, in order.  `out` is the prediction u8
// [F, h, W] or the residual int16 [F*h, W].
template <bool kSmem, int kOut>
__global__ void __launch_bounds__(kSearchThreads) motion_search_kernel(
        const uint8_t* __restrict__ cur, const uint8_t* __restrict__ ref,
        int h, int w, int merange, int gop, Stripe st,
        int32_t* __restrict__ mvec, void* __restrict__ out) {
    extern __shared__ uint4 window_smem[];

    const int nbx = w / kMacro;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int mbx0 = blockIdx.x * kSearchWarps;
    const int mbx = mbx0 + warp;
    const int last = min(mbx0 + kSearchWarps, nbx) - 1;
    const int by_loc = blockIdx.y * kMacro;  // in cur
    const int by = st.row0 + by_loc;          // in the frame
    const int h_glob = st.h_glob;
    const long long f = blockIdx.z;
    const long long plane = (long long)h * w;
    const int c = lane & 3;
    const int r = lane >> 2;
    long long fv = f;  // the frame's place among the vectors
    if constexpr (kOut == kResidual) {
        if (gop > 0 && (st.f0 + f) % gop == 0) {  // intra: the pixels
            if (mbx >= nbx) return;
            const long long at = f * plane + (long long)(by_loc + r) * w
                                 + mbx * kMacro + 4 * c;
            int16_t* o = static_cast<int16_t*>(out) + at;
            *reinterpret_cast<uint2*>(o) = residual4(__ldg(
                reinterpret_cast<const uint32_t*>(cur + at)), 0u);
            *reinterpret_cast<uint2*>(o + 8LL * w) = residual4(__ldg(
                reinterpret_cast<const uint32_t*>(cur + at + 8LL * w)), 0u);
            return;
        }
        if (gop > 0) fv = p_before(st.f0 + f, gop) - p_before(st.f0, gop);
    }

    // The window: rows y0 .. y0 + wh - 1, columns xa .. xa + width - 1,
    // xa the 16-byte aligned column at or before the leftmost reachable.
    const int span = search_span(merange);
    const int x0 = clampi(mbx0 * kMacro - span, 0, w - kMacro);
    const int xa = x0 & ~15;
    const int xe = clampi(last * kMacro + span, 0, w - kMacro) + kMacro;
    const int width = min(w, (xe + 15) & ~15) - xa;
    const int y0 = clampi(by - span, 0, h_glob - kMacro);
    const int wh = clampi(by + span, 0, h_glob - kMacro) + kMacro - y0;
    const uint8_t* src = ref + f * st.ref_plane
                         + (long long)(y0 - st.row0 + st.halo) * w + xa;
    const uint32_t* win;
    int pitch;  // bytes
    if constexpr (kSmem) {
        pitch = window_pitch(width);
        const int vecs = width / 16;
        for (int i = threadIdx.x; i < wh * vecs; i += kSearchThreads) {
            const int row = i / vecs;
            const int v = i - row * vecs;
            window_smem[row * (pitch / 16) + v] = __ldg(
                reinterpret_cast<const uint4*>(src + (long long)row * w) + v);
        }
        win = reinterpret_cast<const uint32_t*>(window_smem);
        __syncthreads();
    } else {
        pitch = w;
        win = reinterpret_cast<const uint32_t*>(src);
    }
    if (mbx >= nbx) return;

    // Lane l: column word c = l % 4 of rows r and r + 8, r = l / 4.
    const int bx = mbx * kMacro;
    const uint8_t* cp = cur + f * plane + (long long)(by_loc + r) * w + bx
                        + 4 * c;
    const uint32_t cur0 = __ldg(reinterpret_cast<const uint32_t*>(cp));
    const uint32_t cur1 = __ldg(reinterpret_cast<const uint32_t*>(
        cp + 8LL * w));
    const int pitch_w = pitch / 4;
    const int row8_w = 8 * pitch_w;

    int offx = 0, offy = 0;
    unsigned best = 0xFFFFFu;  // above any SAD (16 * 16 * 255 < 2^16)
    for (int step = merange / 2; step > 0; step /= 2) {
        // Effective positions: 3 columns and 3 rows serve the 9 candidates.
        // A column gives this lane's word and the bytes' shift, a row its
        // word offset; each records whether it is the block's own.
        int colw[3], roww[3];
        unsigned sh[3];
        bool selfx[3], selfy[3];
#pragma unroll
        for (int k = 0; k < 3; k++) {
            const int px = clampi(bx + offx + (k - 1) * step, 0, w - kMacro);
            const int py = clampi(by + offy + (k - 1) * step, 0,
                                  h_glob - kMacro);
            colw[k] = (px - xa + 4 * c) >> 2;
            sh[k] = 8u * (unsigned)(px & 3);
            roww[k] = (py - y0 + r) * pitch_w;
            selfx[k] = px == bx;
            selfy[k] = py == by;
        }
        // Each candidate's SAD, summed over the warp by one redux; the key
        // (SAD << 5) | (16 - p) orders by SAD, then later candidate first.
        // Below the first level candidate 0 is the previous level's winner:
        // its SAD is `best`, and accepting it changes nothing, so it is not
        // scored again.
        unsigned won = (best << 5) | kBestLow;
        const bool first = step == merange / 2;
#pragma unroll
        for (int p = 0; p < 9; p++) {
            if (p == 0 && !first) continue;
            const int kx = sign_x(p) + 1;
            const int ky = sign_y(p) + 1;
            const int i = roww[ky] + colw[kx];
            const unsigned part =
                __vsadu4(window_bytes<kSmem>(win, i, sh[kx]), cur0)
                + __vsadu4(window_bytes<kSmem>(win, i + row8_w, sh[kx]), cur1);
            const unsigned total = __reduce_add_sync(kFull, part);
            if (p == 0 || !(selfx[kx] && selfy[ky]))
                won = min(won, (total << 5) | (unsigned)(16 - p));
        }
        best = won >> 5;
        if ((won & 31u) != kBestLow) {
            const int p = 16 - (int)(won & 31u);
            offx += sign_x(p) * step;
            offy += sign_y(p) * step;
        }
    }
    if (lane == 0) {
        const long long mb = (long long)blockIdx.y * nbx + mbx;
        int32_t* o = mvec + (fv * (long long)nbx * (h / kMacro) + mb) * 2;
        o[0] = offx;
        o[1] = offy;
    }
    if constexpr (kOut != kVectors) {
        // The winning window, clamped as every candidate was: this lane's
        // words of rows r and r + 8 once more, and out they go.
        const int px = clampi(bx + offx, 0, w - kMacro);
        const int py = clampi(by + offy, 0, h_glob - kMacro);
        const int i = (py - y0 + r) * pitch_w + ((px - xa + 4 * c) >> 2);
        const unsigned sh = 8u * (unsigned)(px & 3);
        const uint32_t p0 = window_bytes<kSmem>(win, i, sh);
        const uint32_t p1 = window_bytes<kSmem>(win, i + row8_w, sh);
        const long long at = f * plane + (long long)(by_loc + r) * w + bx
                             + 4 * c;
        if constexpr (kOut == kPredict) {
            uint8_t* o = static_cast<uint8_t*>(out) + at;
            *reinterpret_cast<uint32_t*>(o) = p0;
            *reinterpret_cast<uint32_t*>(o + 8LL * w) = p1;
        } else {
            int16_t* o = static_cast<int16_t*>(out) + at;
            *reinterpret_cast<uint2*>(o) = residual4(cur0, p0);
            *reinterpret_cast<uint2*>(o + 8LL * w) = residual4(cur1, p1);
        }
    }
}

__global__ void __launch_bounds__(kPredictThreads) predict_kernel(
        const uint8_t* __restrict__ ref, long long ref_stride,
        const int32_t* __restrict__ mvec, long long mvec_stride,
        long long n_rows, int h, int w, uint8_t* __restrict__ pred,
        long long pred_stride) {
    const int nbx = w / kMacro;
    const long long t = blockIdx.x * (long long)kPredictThreads
                        + threadIdx.x;
    if (t >= n_rows * nbx) return;
    const long long fy = t / nbx;            // frame-stacked row f*h + y
    const int mbx = (int)(t - fy * nbx);
    const long long f = fy / h;
    const int y = (int)(fy - f * h);
    const int mb = (y / kMacro) * nbx + mbx;
    // Any int32 vector: the window's corner is clamped into the frame in
    // 64 bits, as the host clamps it (ops/motion.py::predict_image).
    const int32_t* mv = mvec + f * mvec_stride + 2LL * mb;
    const int px = (int)clampll(mbx * kMacro + (long long)mv[0], 0,
                                w - kMacro);
    const int py = (int)clampll((y / kMacro) * kMacro + (long long)mv[1], 0,
                                h - kMacro);
    // The row's 16 bytes start px & 3 bytes into an aligned word (rows
    // start at multiples of 16 bytes): 4 words, and a fifth only where the
    // bytes straddle it, so no read passes the row's end.
    const uint32_t* src = reinterpret_cast<const uint32_t*>(
        ref + f * ref_stride + (long long)(py + y % kMacro) * w) + (px >> 2);
    const unsigned sh = 8u * (unsigned)(px & 3);
    uint32_t s[5];
#pragma unroll
    for (int k = 0; k < 4; k++) s[k] = __ldg(src + k);
    s[4] = sh ? __ldg(src + 4) : 0u;
    uint32_t v[4];
#pragma unroll
    for (int k = 0; k < 4; k++) v[k] = __funnelshift_r(s[k], s[k + 1], sh);
    // The row starts at a multiple of 16 bytes: w % 16 == 0 and the
    // frames start 16-byte aligned.
    *(uint4*)(pred + f * pred_stride + (long long)y * w + mbx * kMacro) =
        make_uint4(v[0], v[1], v[2], v[3]);
}

// The stripe of a whole frame of h rows.
Stripe whole_frame(int h, int w) {
    return Stripe{0, 0, h, (long long)h * w, 0};
}

// Whether ref holds every row a search of the stripe can read: the rows
// the clamped candidates of its macroblocks reach, +-span around it.
bool stripe_ok(int h, int merange, const Stripe& st) {
    if (st.row0 < 0 || st.halo < 0 || st.row0 + h > st.h_glob
        || st.h_glob % kMacro || st.f0 < 0)
        return false;
    const int span = search_span(merange);
    return st.row0 - st.halo <= std::max(0, st.row0 - span)
           && st.row0 + h + st.halo >= std::min(st.h_glob, st.row0 + h + span);
}

template <int kOut>
int launch_search(const uint8_t* cur, const uint8_t* ref, long long n_frames,
                  int h, int w, int merange, int gop, const Stripe& st,
                  int32_t* mvec, void* out, cudaStream_t s) {
    const int nbx = w / kMacro;
    const int nby = h / kMacro;
    if (!stripe_ok(h, merange, st)) return (int)cudaErrorInvalidValue;
    if (n_frames <= 0 || nbx <= 0 || nby <= 0)
        return (int)cudaGetLastError();
    if (n_frames > 65535 || nby > 65535) return (int)cudaErrorInvalidValue;
    // The widest window of any CTA (see motion_search_kernel): a multiple
    // of 16 bytes covering 8 blocks, 2 * span and the alignment, at most w.
    const long long span = search_span(merange);
    const long long width = std::min<long long>(
        w, ((kSearchWarps * kMacro + 2 * span + 30) / 16) * 16);
    const long long rows = std::min<long long>(st.h_glob, kMacro + 2 * span);
    const long long bytes = (width + 16) * rows + 16;  // + a word of slack
    const dim3 grid((unsigned)((nbx + kSearchWarps - 1) / kSearchWarps),
                    (unsigned)nby, (unsigned)n_frames);
    if (bytes <= kWindowSmemMax)
        motion_search_kernel<true, kOut>
            <<<grid, kSearchThreads, (size_t)bytes, s>>>(
                cur, ref, h, w, merange, gop, st, mvec, out);
    else
        motion_search_kernel<false, kOut><<<grid, kSearchThreads, 0, s>>>(
            cur, ref, h, w, merange, gop, st, mvec, out);
    return (int)cudaGetLastError();
}

}  // namespace

// cur, ref: u8 [F, H, W] (frame f of cur searched in frame f of ref), both
// 16-byte aligned; H, W multiples of 16; mvec: i32 [F, (H/16)*(W/16), 2]
// as (x, y).
extern "C" int ie_motion_search(const void* cur, const void* ref,
                                long long n_frames, int h, int w,
                                int merange, void* mvec, void* stream) {
    return launch_search<kVectors>(
        (const uint8_t*)cur, (const uint8_t*)ref, n_frames, h, w, merange, 0,
        whole_frame(h, w), (int32_t*)mvec, nullptr, (cudaStream_t)stream);
}

// As ie_motion_search, and pred: u8 [F, H, W], 4-byte aligned: every
// macroblock's window at its vector.
extern "C" int ie_search_predict(const void* cur, const void* ref,
                                 long long n_frames, int h, int w,
                                 int merange, void* mvec, void* pred,
                                 void* stream) {
    return launch_search<kPredict>(
        (const uint8_t*)cur, (const uint8_t*)ref, n_frames, h, w, merange, 0,
        whole_frame(h, w), (int32_t*)mvec, pred, (cudaStream_t)stream);
}

// As ie_search_predict on a stripe: cur u8 [F, h, W], rows row0 .. row0 +
// h - 1 of frames h_glob rows tall; ref u8 [F, h + 2 * halo, W], frame f's
// reference from global row row0 - halo (rows outside the frame are never
// read); pred u8 [F, h, W].  ref must hold the rows the search reaches:
// halo >= the search's span, or the stripe at the frame's edge.
extern "C" int ie_search_predict_stripe(const void* cur, const void* ref,
                                        long long n_frames, int h, int w,
                                        int row0, int halo, int h_glob,
                                        int merange, void* mvec, void* pred,
                                        void* stream) {
    const Stripe st{row0, halo, h_glob, (long long)(h + 2 * halo) * w, 0};
    return launch_search<kPredict>(
        (const uint8_t*)cur, (const uint8_t*)ref, n_frames, h, w, merange, 0,
        st, (int32_t*)mvec, pred, (cudaStream_t)stream);
}

// frames: u8 [F, H, W], 16-byte aligned, a video of GOPs of `gop` >= 1
// frames: frame f with f % gop != 0 is searched in frame f - 1.  mvec: i32
// [P, (H/16)*(W/16), 2], the searched frames' vectors in order; residual:
// i16 [F*H, W], 8-byte aligned: cur - pred on the searched frames' rows,
// the pixels on the others'.
extern "C" int ie_search_residual(const void* frames, long long n_frames,
                                  int h, int w, int merange, int gop,
                                  void* mvec, void* residual, void* stream) {
    if (gop < 1) return (int)cudaErrorInvalidValue;
    const auto* cur = (const uint8_t*)frames;
    // Frame 0 is intra, so frame -1 is never read.
    return launch_search<kResidual>(
        cur, cur - (long long)h * w, n_frames, h, w, merange, gop,
        whole_frame(h, w), (int32_t*)mvec, residual, (cudaStream_t)stream);
}

// As ie_search_residual on a stripe of a chunk of frames: cur u8 [F, h, W]
// (see ie_search_predict_stripe), global frames f0 .. f0 + F - 1, frame f
// intra where (f0 + f) % gop == 0; ref u8 [F, h + 2 * halo, W], frame f's
// reference (the raw frame before it, haloed; for f = 0 the previous
// chunk's last frame), never read for an intra frame.  mvec: i32
// [P, (h/16)*(W/16), 2], the chunk's P-frames' vectors in order.
extern "C" int ie_search_residual_stripe(const void* cur, const void* ref,
                                         long long n_frames, int h, int w,
                                         int row0, int halo, int h_glob,
                                         int merange, long long f0, int gop,
                                         void* mvec, void* residual,
                                         void* stream) {
    if (gop < 1) return (int)cudaErrorInvalidValue;
    const Stripe st{row0, halo, h_glob, (long long)(h + 2 * halo) * w, f0};
    return launch_search<kResidual>(
        (const uint8_t*)cur, (const uint8_t*)ref, n_frames, h, w, merange,
        gop, st, (int32_t*)mvec, residual, (cudaStream_t)stream);
}

// mvec: i32 [F, (H/16)*(W/16), 2], frame f at f * mvec_stride int32s;
// ref and pred: u8 [F, H, W] frames at ref_stride and pred_stride bytes
// apart, each frame 16-byte aligned.  Vectors may take any int32 value.
extern "C" int ie_predict(const void* ref, long long ref_stride,
                          const void* mvec, long long mvec_stride,
                          long long n_frames, int h, int w, void* pred,
                          long long pred_stride, void* stream) {
    const long long n = n_frames * h * (w / kMacro);
    if (n <= 0) return (int)cudaGetLastError();
    const unsigned grid = (unsigned)((n + kPredictThreads - 1)
                                     / kPredictThreads);
    predict_kernel<<<grid, kPredictThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)ref, ref_stride, (const int32_t*)mvec, mvec_stride,
        n_frames * h, h, w, (uint8_t*)pred, pred_stride);
    return (int)cudaGetLastError();
}
