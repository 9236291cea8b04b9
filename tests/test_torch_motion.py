"""K6/K7 port (imageencoder_tpu_torch/ops/motion.py, cuda_motion.py)
against the JAX package, on the CPU, where the wrappers run their plain
versions.

  * sad_maps_plain equals the TPU kernel's maps,
    pallas_motion.sad_maps_pallas(interpret=True), on every row < D and
    column < nbx (the kernel's padding rows and lanes are garbage);
  * the plain search and prediction equal video_pipeline.sad_motion_search
    through the Pallas kernels in interpret mode and through the lax.scan
    maps, and the host engine's ops/motion.find_motion / predict_image,
    bit for bit: merange 1 (no levels), frames wider than 2048 px, and
    motion pushed against every border;
  * the plain versions of the fused wrappers (the search with the
    prediction as its epilogue): search_predict equals sad_motion_search's
    vectors and prediction, and search_residual the vectors, and the
    residual cur - pred, of a whole video's P-frames against the frames
    before them, with the I-frames' pixels on their rows: gop 1 (no
    P-frame), a last GOP cut short, vectors that clamp at all four edges;
  * the stripe search on frames that lie apart (frame k of every GOP),
    into views of larger buffers, equal to the dense call.

Inputs are seeded numpy frames.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from imageencoder_tpu.ops import video_pipeline as jax_vp
from imageencoder_tpu.ops.motion import find_motion, predict_image
from imageencoder_tpu.ops.pallas_motion import LANE, sad_maps_pallas
from imageencoder_tpu_torch.ops import cuda_motion
from imageencoder_tpu_torch.ops.motion import (descend_plain,
                                               motion_search_plain,
                                               predict_plain, sad_maps_plain)


def moving_frames(n: int, h: int, w: int, seed: int, dy: int = 2,
                  dx: int = -3) -> np.ndarray:
    """Blocky content shifted by (dy, dx) a frame, plus noise (the content
    model of bench.py's video timing)."""
    rng = np.random.default_rng(seed)
    base = np.kron(rng.integers(0, 256, (h // 4 + 1, w // 4 + 1)),
                   np.ones((4, 4)))[:h, :w]
    out = [np.clip(np.roll(base, (dy * k, dx * k), (0, 1))
                   + rng.normal(0, 3, (h, w)), 0, 255) for k in range(n)]
    return np.stack(out).astype(np.uint8)


def cur_ref(frames: np.ndarray):
    """(cur, ref) pairs: frame f against frame f - 1."""
    return frames[1:], frames[:-1]


@pytest.mark.parametrize("merange", [4, 8])
def test_sad_maps_equal_pallas_kernel(merange):
    cur, ref = cur_ref(moving_frames(3, 32, 48, merange))
    d = 2 * merange - 1
    nby, nbx = 2, 3
    want = np.asarray(sad_maps_pallas(jnp.asarray(cur), jnp.asarray(ref),
                                      merange, interpret=True))
    want = (want[:, :d].reshape(2, d, nby, d, LANE)[..., :nbx]
            .transpose(0, 1, 3, 2, 4))                 # [F, dy, dx, by, bx]
    got = sad_maps_plain(torch.from_numpy(cur), torch.from_numpy(ref),
                         merange)
    assert got.dtype == torch.int32 and got.shape == (2, d, d, nby, nbx)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


@pytest.mark.parametrize("mode", ["interpret", "scan"])
@pytest.mark.parametrize("merange,shape,shift", [
    (4, (32, 48), (2, -3)),
    (8, (32, 48), (-5, 7)),     # motion against the top and right borders
    (16, (48, 64), (6, 9)),
    (1, (32, 48), (2, -3)),     # no search levels: zero vectors
])
def test_search_and_prediction_equal_jax(monkeypatch, mode, merange, shape,
                                         shift):
    h, w = shape
    frames = moving_frames(3, h, w, merange + h, *shift)
    cur, ref = cur_ref(frames)
    monkeypatch.setattr(jax_vp, "_SAD_MAPS_MODE", mode)
    off, pred = jax_vp.sad_motion_search(jnp.asarray(cur), jnp.asarray(ref),
                                         merange)
    got = motion_search_plain(torch.from_numpy(cur), torch.from_numpy(ref),
                              merange)
    np.testing.assert_array_equal(got.numpy(), np.asarray(off))
    gp = predict_plain(torch.from_numpy(ref), got)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(pred))
    for f in range(cur.shape[0]):
        mv, _ = find_motion(cur[f], ref[f], merange)
        np.testing.assert_array_equal(got[f].numpy(), mv)
        np.testing.assert_array_equal(gp[f].numpy(),
                                      predict_image(ref[f], mv, h, w))


@pytest.mark.parametrize("merange,shape", [(4, (16, 2176)), (16, (32, 2064))])
def test_wide_frames_equal_host_engine(merange, shape):
    """Wider than the TPU kernel's 128 macroblock lanes (2048 px)."""
    h, w = shape
    cur, ref = cur_ref(moving_frames(2, h, w, w, 1, 5))
    got = cuda_motion.motion_search(torch.from_numpy(cur),
                                    torch.from_numpy(ref), merange)
    mv, _ = find_motion(cur[0], ref[0], merange)
    np.testing.assert_array_equal(got[0].numpy(), mv)
    pred = cuda_motion.predict(torch.from_numpy(ref), got)
    np.testing.assert_array_equal(pred[0].numpy(),
                                  predict_image(ref[0], mv, h, w))


def test_descent_takes_later_ties_and_skips_the_clamped_self():
    """Hand-built maps: every SAD equal, so each level's last candidate
    that is not skipped wins.  At the top-left block, candidates that
    clamp back onto the block itself are skipped although their raw
    offsets are not zero."""
    merange = 4                       # levels of step 2 and 1
    h, w = 32, 32
    d = 2 * merange - 1
    maps = torch.full((1, d, d, 2, 2), 7, dtype=torch.int32)
    got = descend_plain(maps, h, w, merange)
    for n, (bx, by) in enumerate([(0, 0), (16, 0), (0, 16), (16, 16)]):
        ox = oy = 0
        for step in (2, 1):
            sel = (ox, oy)
            for p, (sx, sy) in enumerate([(0, 0), (1, 0), (1, 1), (0, 1),
                                          (-1, 1), (-1, 0), (-1, -1),
                                          (0, -1), (1, -1)]):
                cx, cy = ox + sx * step, oy + sy * step
                ex = min(max(bx + cx, 0), w - 16) - bx
                ey = min(max(by + cy, 0), h - 16) - by
                if p == 0 or (ex, ey) != (0, 0):
                    sel = (cx, cy)
            ox, oy = sel
        assert tuple(got[0, n].tolist()) == (ox, oy), n
    # The top-left block ends on a candidate whose raw offset points out
    # of the frame: the vector keeps the unclamped offset.
    assert got[0, 0].tolist() == [3, -3]


def test_wrappers_on_cpu_run_the_plain_versions():
    cur, ref = cur_ref(moving_frames(3, 32, 32, 5))
    c, r = torch.from_numpy(cur), torch.from_numpy(ref)
    before = (cuda_motion.motion_search.launches,
              cuda_motion.predict.launches)
    mv = cuda_motion.motion_search(c, r, 8)
    pred = cuda_motion.predict(r, mv)
    assert (cuda_motion.motion_search.launches,
            cuda_motion.predict.launches) == before
    assert torch.equal(mv, motion_search_plain(c, r, 8))
    assert torch.equal(pred, predict_plain(r, mv))
    with pytest.raises(ValueError, match="macroblock"):
        cuda_motion.motion_search(c[:, :20], r[:, :20], 8)
    with pytest.raises(ValueError, match="mvec"):
        cuda_motion.predict(r, mv[:, :1])


def wrapping_frames(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """8x8 random blocks moving by (2, 3) pixels a frame and wrapping
    around the frame, plus noise (bench.py's video content): blocks at the
    borders find their match outside the frame."""
    rng = np.random.default_rng(seed)
    base = np.kron(rng.integers(0, 256, (h // 8, w // 8)), np.ones((8, 8)))
    return np.stack([np.clip(np.roll(base, (f * 2, f * 3), (0, 1))
                             + rng.normal(0, 3, base.shape), 0, 255)
                     .astype(np.uint8) for f in range(n)])


def test_fused_plain_versions_clamp_at_every_edge(monkeypatch):
    """The content played forwards and backwards, as it is and mirrored:
    vectors point out of the frame at all four edges, and the fused
    wrappers' vectors, prediction and residual equal the JAX package's."""
    h, w, merange = 96, 128, 16
    frames = wrapping_frames(2, h, w, 16)
    monkeypatch.setattr(jax_vp, "_SAD_MAPS_MODE", "scan")
    edges = np.zeros(4, bool)
    by, bx = np.mgrid[0:h:16, 0:w:16]
    for video in (frames, frames[::-1], frames[:, :, ::-1],
                  frames[::-1, :, ::-1]):
        video = np.ascontiguousarray(video)
        cur, ref = cur_ref(video)
        off, pred = jax_vp.sad_motion_search(jnp.asarray(cur),
                                             jnp.asarray(ref), merange)
        off, pred = np.asarray(off), np.asarray(pred)
        mv, gp = cuda_motion.search_predict(torch.from_numpy(cur),
                                            torch.from_numpy(ref), merange)
        np.testing.assert_array_equal(mv.numpy(), off)
        np.testing.assert_array_equal(gp.numpy(), pred)
        px, py = bx.ravel() + off[0, :, 0], by.ravel() + off[0, :, 1]
        edges |= [(px < 0).any(), (px > w - 16).any(), (py < 0).any(),
                  (py > h - 16).any()]
        mv2, stack = cuda_motion.search_residual(torch.from_numpy(video), 2,
                                                 merange)
        np.testing.assert_array_equal(mv2.numpy(), off)
        assert stack.dtype == torch.int16 and stack.shape == (2 * h, w)
        np.testing.assert_array_equal(stack[:h].numpy(), video[0])
        np.testing.assert_array_equal(
            stack[h:].numpy(), cur[0].astype(np.int16) - pred[0])
    assert edges.all(), edges


@pytest.mark.parametrize("n,gop", [(5, 1), (6, 4), (3, 3), (7, 2), (1, 4)])
def test_search_residual_equals_jax_per_p_frame(monkeypatch, n, gop):
    """A whole video in: every P-frame's vectors and residual against the
    frame before it, the I-frames' pixels in between; no P-frame at gop 1
    and in a one-frame video, a second GOP of 2 frames at (6, 4)."""
    h, w, merange = 32, 48, 8
    frames = moving_frames(n, h, w, 10 * n + gop)
    monkeypatch.setattr(jax_vp, "_SAD_MAPS_MODE", "scan")
    before = cuda_motion.search_residual.launches
    mv, stack = cuda_motion.search_residual(torch.from_numpy(frames), gop,
                                            merange)
    assert cuda_motion.search_residual.launches == before  # CPU: plain
    p_idx = [f for f in range(n) if f % gop]
    assert cuda_motion.p_frames(n, gop) == p_idx
    assert mv.dtype == torch.int32 and mv.shape == (len(p_idx), 6, 2)
    stack = stack.numpy().reshape(n, h, w)
    if p_idx:
        off, pred = jax_vp.sad_motion_search(
            jnp.asarray(frames[p_idx]),
            jnp.asarray(frames[[f - 1 for f in p_idx]]), merange)
        np.testing.assert_array_equal(mv.numpy(), np.asarray(off))
        np.testing.assert_array_equal(
            stack[p_idx], frames[p_idx].astype(np.int16) - np.asarray(pred))
    i_idx = [f for f in range(n) if f % gop == 0]
    np.testing.assert_array_equal(stack[i_idx], frames[i_idx])
    with pytest.raises(ValueError, match="gop"):
        cuda_motion.search_residual(torch.from_numpy(frames), 0, merange)


# ---- on a stripe (the sharded video encode) ----

def stripes_of(video: np.ndarray, n_stripes: int, halo: int):
    """Each stripe of the frames after the first, and the haloed reference
    stack of the frame before each (zero rows past the frame's edges):
    [(row0, cur [F, h, W], ref [F, h + 2 * halo, W])]."""
    f, h_glob, w = video.shape
    h = h_glob // n_stripes
    padded = np.zeros((f, h_glob + 2 * halo, w), np.uint8)
    padded[:, halo:halo + h_glob] = video
    out = []
    for s in range(n_stripes):
        r0 = s * h
        out.append((r0, np.ascontiguousarray(video[1:, r0:r0 + h]),
                    np.ascontiguousarray(padded[:-1, r0:r0 + h + 2 * halo])))
    return out


@pytest.mark.parametrize("n_stripes", [1, 2, 4])
@pytest.mark.parametrize("f0,gop", [(0, 4), (1, 4), (3, 4), (2, 3)])
def test_stripes_equal_the_whole_frame_search(monkeypatch, n_stripes, f0,
                                              gop):
    """Each stripe's search on its haloed reference, clamped in global
    rows, gives the whole frame's vectors and residual rows: the wrapping
    content sends vectors out of the top and bottom stripes' frame edges
    and across stripe borders; f0 puts a P-frame at a chunk's start."""
    h, w, merange = 128, 64, 16
    video = np.concatenate([wrapping_frames(4, h, w, 31),
                            wrapping_frames(2, h, w, 32)[:, ::-1]])
    video = np.ascontiguousarray(video)
    halo = merange
    p_idx = cuda_motion.p_frames(len(video) - 1, gop, f0)
    monkeypatch.setattr(jax_vp, "_SAD_MAPS_MODE", "scan")
    off, pred = jax_vp.sad_motion_search(jnp.asarray(video[1:][p_idx]),
                                         jnp.asarray(video[:-1][p_idx]),
                                         merange)
    off, pred = np.asarray(off), np.asarray(pred)
    mvs, rows = [], []
    for r0, cur, ref in stripes_of(video, n_stripes, halo):
        cur_t, ref_t = torch.from_numpy(cur), torch.from_numpy(ref)
        mv, stack = cuda_motion.search_residual_stripe(cur_t, ref_t, r0, halo,
                                                       h, f0, gop, merange)
        mvs.append(mv.numpy().reshape(len(p_idx), -1, w // 16, 2))
        rows.append(stack.numpy().reshape(len(cur), -1, w))
        mv2, pr = cuda_motion.search_predict_stripe(cur_t, ref_t, r0, halo, h,
                                                    merange)
        hs = cur.shape[1]
        np.testing.assert_array_equal(
            mv2.numpy()[p_idx], mv.numpy())
        np.testing.assert_array_equal(pr.numpy()[p_idx],
                                      pred[:, r0:r0 + hs])
    np.testing.assert_array_equal(
        np.concatenate(mvs, axis=1).reshape(off.shape), off)
    want = video[1:].astype(np.int16)
    want[p_idx] -= pred
    np.testing.assert_array_equal(np.concatenate(rows, axis=1), want)
    if n_stripes > 1 and p_idx:  # the clamp at both frame edges is met
        by = np.repeat(np.arange(h // 16) * 16, w // 16)
        py = by + off[..., 1]
        assert (py < 0).any() and (py > h - 16).any()


def test_stripe_plain_versions_equal_whole_frame_ones():
    """A stripe of the whole frame (row0 0, halo 0) is the whole-frame
    search, prediction and residual."""
    video = moving_frames(5, 48, 64, 40)
    cur, ref = torch.from_numpy(video[1:]), torch.from_numpy(video[:-1])
    for got, want in zip(cuda_motion.search_predict_stripe(cur, ref, 0, 0, 48,
                                                           8),
                         cuda_motion.search_predict(cur, ref, 8)):
        assert torch.equal(got, want)
    frames = torch.from_numpy(video)
    ref0 = torch.cat([torch.zeros_like(frames[:1]), frames[:-1]])
    for got, want in zip(cuda_motion.search_residual_stripe(
            frames, ref0, 0, 0, 48, 0, 4, 8),
            cuda_motion.search_residual(frames, 4, 8)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("n_stripes", [1, 2])
@pytest.mark.parametrize("k,gop", [(1, 4), (3, 4), (2, 3)])
def test_stripe_search_takes_frames_that_lie_apart(n_stripes, k, gop):
    """search_predict_stripe of frame k of every GOP (cur[k::gop]) in the
    references that lie as far apart, into views of larger buffers
    (mvec[k - 1::gop - 1], out[k::gop]), as the sharded recon steps: the
    dense call's vectors and prediction, written into those rows and no
    other, and returned as the buffers given."""
    h_glob, w, merange = 64, 48, 16
    video = wrapping_frames(11, h_glob, w, 35)
    halo = merange if n_stripes > 1 else 0
    for r0, cur, ref in stripes_of(video, n_stripes, halo):
        cur_t, ref_t = torch.from_numpy(cur), torch.from_numpy(ref)
        sel, sel_ref = cur_t[k::gop], ref_t[k::gop]
        n = sel.shape[0]
        mv_buf = torch.full((n * (gop - 1), (cur.shape[1] // 16) * (w // 16),
                             2), -99, dtype=torch.int32)
        out_buf = torch.full_like(cur_t, 77)
        mvec, out = mv_buf[k - 1::gop - 1], out_buf[k::gop]
        got = cuda_motion.search_predict_stripe(sel, sel_ref, r0, halo,
                                                h_glob, merange, mvec=mvec,
                                                out=out)
        want = cuda_motion.search_predict_stripe(sel.contiguous(),
                                                 sel_ref.contiguous(), r0,
                                                 halo, h_glob, merange)
        assert got[0] is mvec and got[1] is out
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        rest = torch.ones(len(mv_buf), dtype=torch.bool)
        rest[k - 1::gop - 1] = False
        assert (mv_buf[rest] == -99).all()
        rest = torch.ones(len(out_buf), dtype=torch.bool)
        rest[k::gop] = False
        assert (out_buf[rest] == 77).all()


@pytest.mark.parametrize("row0,halo,h_glob", [
    (16, 4, 64),    # the halo shorter than the search's reach (15 rows)
    (48, 16, 64),   # past the frame's last row
    (0, 16, 40),    # a frame of no whole macroblocks
    (-16, 16, 64)])
def test_stripe_wrappers_refuse_what_they_cannot_search(row0, halo, h_glob):
    cur = torch.zeros((2, 32, 32), dtype=torch.uint8)
    ref = torch.zeros((2, 32 + 2 * halo, 32), dtype=torch.uint8)
    with pytest.raises(ValueError):
        cuda_motion.search_predict_stripe(cur, ref, row0, halo, h_glob, 16)
    with pytest.raises(ValueError):
        cuda_motion.search_residual_stripe(cur, ref, row0, halo, h_glob, 0,
                                           4, 16)


def test_stripe_at_the_frame_edges_needs_no_halo_there():
    """The top and bottom stripes read no row past the frame's edge: the
    halo there may be garbage."""
    h, w, merange = 64, 48, 16
    video = wrapping_frames(3, h, w, 33)
    for r0, cur, ref in stripes_of(video, 2, merange):
        garbage = ref.copy()
        if r0 == 0:
            garbage[:, :merange] = 255
        else:
            garbage[:, -merange:] = 255
        for a, b in zip(cuda_motion.search_predict_stripe(
                torch.from_numpy(cur), torch.from_numpy(ref), r0, merange, h,
                merange),
                cuda_motion.search_predict_stripe(
                torch.from_numpy(cur), torch.from_numpy(garbage), r0,
                merange, h, merange)):
            assert torch.equal(a, b)
