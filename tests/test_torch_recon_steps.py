"""The recon video encode stepped by GOP (ops/video_pipeline.py::gop_steps
and make_encode_video_packed_recon) and the many-frame K5 and recon step it
runs (ops/cuda_encode.py), on the CPU, where every kernel wrapper runs its
plain version.

  * quantize_image and recon_step over F frames handed in as views of
    every gop-th frame (frames[k::gop], coeffs[k::gop], lens[k::gop])
    equal F one-frame calls, 4x4 and 8x8 blocks, both norms;
  * the record lengths they write equal the JAX package's
    rle.block_stats(...)["total_bits"] on the same zig-zag coefficients,
    RLE on and off, blocks with the trailing-strip quirk among them;
  * gop_steps covers every frame of F in {0, 1, 2, 5, 9, 25} frames once
    for gop in {1, 2, 3, 4, F, F + 1}: step 0 the I-frames, step k frame k
    of every GOP that has one, each P-frame after its reference, and the
    P-frame rows mvecs[k - 1::gop - 1] the stream's P-frames in order;
  * encode_video(ref_mode="recon", device="cpu") equals the JAX package's
    encode_video(backend="numpy", ref_mode="recon") byte for byte for
    those F and gop at 64x48, Huffman on and off, with 8x8 blocks, and
    with no frame at all.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_recon_steps.py -q
"""

import numpy as np
import pytest

import torch

from imageencoder_tpu.models import video as jax_video
from imageencoder_tpu.ops import rle as jax_rle
from imageencoder_tpu.ops.zigzag import zigzag_order
from imageencoder_tpu.utils.quant import QuantMatrix
import imageencoder_tpu_torch
from imageencoder_tpu_torch.ops import (cuda_encode, cuda_kernels,
                                        device_pack, video_pipeline)

from tests.test_torch_video import JPEG4, bench_frames, yuv420

W, H = 64, 48
MERANGE = 8
FRAME_COUNTS = (0, 1, 2, 5, 9, 25)


def quant_for(b: int) -> np.ndarray:
    i, j = np.indices((b, b))
    return (np.array(JPEG4, np.float64) if b == 4
            else (1 + 2 * (i + j)).astype(np.float64))


def gops_for(n: int) -> list[int]:
    return sorted({1, 2, 3, 4, n, n + 1} - {0})


def jax_lengths(coeffs: torch.Tensor, b: int, use_rle: bool) -> np.ndarray:
    """The JAX package's record lengths of int32 [F, H, W] coefficients in
    place: rle.block_stats of each block's zig-zag coefficients."""
    f, h, w = coeffs.shape
    nat = (coeffs.numpy().reshape(f, h // b, b, w // b, b)
           .transpose(0, 1, 3, 2, 4).reshape(-1, b * b))
    stats = jax_rle.block_stats(nat[:, zigzag_order(b)], use_rle)
    return np.asarray(stats["total_bits"]).reshape(f, -1)


@pytest.mark.parametrize("b", [4, 8])
@pytest.mark.parametrize("norm", ["reference", "ortho"])
def test_many_frames_on_strided_views_equal_one_frame_calls(b, norm):
    gop, n = 3, 8
    frames = torch.from_numpy(bench_frames(W, H, n, 5 + b))
    q = quant_for(b)
    n_micro = (H // b) * (W // b)
    coeffs = torch.full((n, H, W), -7, dtype=torch.int32)
    lens = torch.full((n, n_micro), -7, dtype=torch.int32)
    got, got_lens = cuda_encode.quantize_image(
        frames[0::gop], q, b, norm, out=coeffs[0::gop], lens=lens[0::gop])
    assert got.data_ptr() == coeffs.data_ptr()
    assert got_lens.data_ptr() == lens.data_ptr()
    for f in range(0, n, gop):
        assert torch.equal(coeffs[f],
                           cuda_encode.quantize_image(frames[f], q, b, norm))
    for k in (1, 2):
        cur = frames[k::gop]
        pred = frames[k - 1::gop][:cur.shape[0]]
        recon = torch.zeros(cur.shape, dtype=torch.uint8)
        step = cuda_encode.recon_step(cur, pred, q, b, norm,
                                      out=coeffs[k::gop], recon=recon,
                                      lens=lens[k::gop])
        assert [x.data_ptr() for x in step] == [
            coeffs[k].data_ptr(), recon.data_ptr(), lens[k].data_ptr()]
        for i, f in enumerate(range(k, n, gop)):
            one = cuda_encode.recon_step(frames[f], pred[i], q, b, norm)
            assert torch.equal(coeffs[f], one[0])
            assert torch.equal(recon[i], one[1])
    np.testing.assert_array_equal(lens.numpy(), jax_lengths(coeffs, b, True))


@pytest.mark.parametrize("use_rle", [True, False])
@pytest.mark.parametrize("b", [4, 8])
def test_lengths_equal_the_jax_block_stats(use_rle, b):
    """Residuals over the whole range under quant all ones (wide
    coefficients), smooth frames under a coarse quant (short records,
    zero blocks), and blocks whose last zig-zag coefficient alone is
    nonzero after zeros (the RLE trailing strip)."""
    rng = np.random.default_rng(b + use_rle)
    res = rng.integers(-255, 256, (3, H, W)).astype(np.int16)
    ones = np.ones((b, b))
    _, lens = cuda_encode.quantize_image(
        torch.from_numpy(res), ones, b, lens=torch.empty(
            (3, (H // b) * (W // b)), dtype=torch.int32), use_rle=use_rle)
    coeffs = cuda_encode.quantize_image(torch.from_numpy(res), ones, b)
    np.testing.assert_array_equal(lens.numpy(),
                                  jax_lengths(coeffs, b, use_rle))
    frames = torch.from_numpy(bench_frames(W, H, 4, b))
    coeffs = torch.empty((4, H, W), dtype=torch.int32)
    lens = torch.empty((4, (H // b) * (W // b)), dtype=torch.int32)
    cuda_encode.recon_step(frames[1::2], frames[0::2], 4 * quant_for(b), b,
                           out=coeffs[1::2], lens=lens[1::2],
                           use_rle=use_rle)
    cuda_encode.quantize_image(frames[0::2], 4 * quant_for(b), b,
                               out=coeffs[0::2], lens=lens[0::2],
                               use_rle=use_rle)
    np.testing.assert_array_equal(lens.numpy(),
                                  jax_lengths(coeffs, b, use_rle))
    last = zigzag_order(b)[-1]
    strip = torch.zeros((1, 5 * b, b), dtype=torch.int32)  # block 4: zeros
    for blk in range(4):
        strip[0, blk * b + last // b, last % b] = 3 - 2 * blk
    strip[0, :b, 0] = 1
    want = jax_lengths(strip, b, use_rle)
    np.testing.assert_array_equal(
        cuda_encode.record_lengths(strip, b, use_rle).numpy(), want)


@pytest.mark.parametrize("n", FRAME_COUNTS)
def test_gop_steps_cover_every_frame_once_in_stream_order(n):
    for gop in gops_for(n):
        steps = video_pipeline.gop_steps(n, gop)
        assert [k for k, _ in steps] == list(range(min(gop, n)))
        taken = [list(range(k, n, gop))[:n_k] for k, n_k in steps]
        assert [len(f) for f in taken] == [n_k for _, n_k in steps]
        assert sorted(f for fs in taken for f in fs) == list(range(n))
        assert taken[:1] in ([], [list(range(0, n, gop))])  # the I-frames
        # Each P-frame comes a step after its reference, frame f - 1, and
        # the GOPs that have a frame k are the first n_k.
        for k, fs in enumerate(taken[1:], 1):
            assert all(f - 1 in taken[k - 1] for f in fs)
            assert fs == [g * gop + k for g in range(len(fs))]
        # Step k's vectors go to rows k - 1, k - 1 + (gop - 1), ... of the
        # P-frames in stream order: exactly its frames' rows.
        p_rows = [f for f in range(n) if f % gop]
        for k, fs in enumerate(taken[1:], 1):
            rows = list(range(len(p_rows)))[k - 1::gop - 1]
            assert [p_rows[r] for r in rows] == fs


@pytest.mark.parametrize("huff", [True, False])
@pytest.mark.parametrize("n", FRAME_COUNTS)
def test_recon_streams_equal_the_host_engine(n, huff):
    data = yuv420(bench_frames(W, H, n, 40 + n)) if n else bytes(W * H)
    port_quant = imageencoder_tpu_torch.quant_from_numpy(np.array(JPEG4))
    quant = QuantMatrix(np.array(JPEG4, np.uint32))
    for gop in gops_for(n):
        got = imageencoder_tpu_torch.encode_video(
            data, W, H, port_quant, True, gop, MERANGE, use_huffman=huff,
            ref_mode="recon", device="cpu")
        want = jax_video.encode_video(data, W, H, quant, True, gop, MERANGE,
                                      use_huffman=huff, backend="numpy",
                                      ref_mode="recon")
        assert got == bytes(want), (n, gop, huff)


@pytest.mark.parametrize("norm", ["reference", "ortho"])
def test_recon_streams_with_8x8_blocks_equal_the_host_engine(norm):
    data = yuv420(bench_frames(W, H, 9, 8))
    i, j = np.indices((8, 8))
    quant = QuantMatrix((1 + 2 * (i + j)).astype(np.uint32))
    for gop, huff in ((4, True), (3, False)):
        got = imageencoder_tpu_torch.encode_video(
            data, W, H, imageencoder_tpu_torch.quant_from_numpy(quant.matrix),
            False, gop, MERANGE, use_huffman=huff, norm=norm,
            ref_mode="recon", block_size=8, device="cpu")
        assert got == bytes(jax_video.encode_video(
            data, W, H, quant, False, gop, MERANGE, use_huffman=huff,
            norm=norm, backend="numpy", ref_mode="recon", block_size=8))


@pytest.mark.parametrize("with_hist", [True, False])
def test_no_frame_packs_the_header_alone(with_hist):
    """The device encoder on zero frames: no step, and the stream is the
    header words, its histogram theirs."""
    enc = video_pipeline.make_encode_video_packed_recon(
        4, MERANGE, 5, 4, True, "reference", with_hist=with_hist)
    hdr = torch.tensor([0x12345678, 0x0ABCDEF0 - 2 ** 31], dtype=torch.int32)
    got = enc(torch.zeros((0, H, W), dtype=torch.uint8), np.array(JPEG4),
              57, hdr)
    assert int(got[1]) == 57
    words = device_pack.as_uint(got[0][:2]).tolist()
    assert words == [0x12345678, 0x0ABCDEF0 + 2 ** 31]
    if with_hist:
        assert torch.equal(got[2], cuda_kernels.byte_histogram_plain(
            got[0], got[1]))
