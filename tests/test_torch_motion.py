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
    P-frame), a last GOP cut short, vectors that clamp at all four edges.

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
