"""The port's video decode on the CPU: imageencoder_tpu_torch.decode_video(
device="cpu") byte for byte against imageencoder_tpu.models.video.
decode_video(backend="numpy"), the exact f64 engine, and each piece of it
against the JAX package's host code.

  * streams of both packages' encoders: raw and recon reference, Huffman
    and RLE on and off, gop 1, 3, 4 and 5, merange 1, 8 and 16, 4x4 and
    8x8 blocks, norm "reference" and "ortho", motioncomp on and off; a
    header-only stream, a 40-frame stream (spliced in the encode), an
    all-I video at 36x20, streams cut short; the reference's rejections;
  * the wrappers' plain versions (what a CPU tensor runs): D2 over a
    whole video against the host's frame walk
    (models/video.py::_iter_parsed_frames), the vector read against its
    vectors, D3 with a prediction against the host's P-frame chain, and
    K7 on the vectors a decoder reads, out to +-2^(mb - 1), on views of
    every k-th frame.

No tolerance: bytes are equal.  The same streams, on the card, are in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

import torch

from imageencoder_tpu.models import image as jax_image
from imageencoder_tpu.models import video as jax_video
from imageencoder_tpu.ops import motion as jax_motion
from imageencoder_tpu.ops.blockify import deblockify
from imageencoder_tpu.ops.dct import clamp_to_u8
from imageencoder_tpu.utils.quant import QuantMatrix
import imageencoder_tpu_torch
from imageencoder_tpu_torch import quant_from_numpy
from imageencoder_tpu_torch.models import video
from imageencoder_tpu_torch.models.headers import VideoParams
from imageencoder_tpu_torch.ops import bitpack, cuda_decode, cuda_motion
from imageencoder_tpu_torch.utils.exceptions import StreamFormatError

from test_torch_decode import dict_stream  # tests/ is on the path
from test_torch_video import JPEG4, bench_frames, yuv420

W, H = 64, 48


def quant(b: int) -> QuantMatrix:
    if b == 4:
        return QuantMatrix(np.array(JPEG4, np.uint32))
    i, j = np.indices((b, b))
    return QuantMatrix((1 + 2 * (i + j)).astype(np.uint32))


def encode(writer: str, data: bytes, w: int, h: int, b: int, use_rle: bool,
           gop: int, merange: int, huff: bool, mode: str,
           norm: str = "reference") -> bytes:
    q = quant(b)
    if writer == "port":
        return imageencoder_tpu_torch.encode_video(
            data, w, h, quant_from_numpy(q.matrix), use_rle, gop, merange,
            use_huffman=huff, norm=norm, ref_mode=mode, block_size=b,
            device="cpu")
    return bytes(jax_video.encode_video(
        data, w, h, q, use_rle, gop, merange, use_huffman=huff, norm=norm,
        backend="numpy", ref_mode=mode, block_size=b))


def held(data: bytes, motioncomp: bool = True, norm: str = "reference",
         b: int = 4):
    """decode_video(device="cpu") against the host engine: equal bytes,
    params and size.  Returns the host's result."""
    got = imageencoder_tpu_torch.decode_video(data, motioncomp, norm, b,
                                              device="cpu")
    want = jax_video.decode_video(data, motioncomp, norm, backend="numpy",
                                  block_size=b)
    assert got[0] == want[0]
    p, q = got[1], want[1]
    assert (p.frame_count, p.gop, p.merange) == (q.frame_count, q.gop,
                                                 q.merange)
    assert got[2] == want[2]
    return want


# (writer, mode, huffman, rle, gop, merange, block size, norm, frames)
MATRIX = [
    ("port", "raw", True, True, 4, 8, 4, "reference", 7),
    ("port", "recon", True, True, 3, 1, 4, "reference", 8),
    ("port", "raw", False, True, 4, 16, 4, "reference", 9),
    ("port", "recon", False, False, 1, 8, 4, "reference", 6),
    ("port", "raw", True, False, 5, 1, 4, "ortho", 9),
    ("port", "recon", True, True, 4, 8, 8, "ortho", 6),
    ("jax", "raw", True, True, 3, 8, 4, "reference", 7),
    ("jax", "recon", False, True, 4, 1, 8, "reference", 8),
    ("jax", "raw", False, False, 4, 8, 4, "ortho", 6),
]


@pytest.mark.parametrize("writer,mode,huff,use_rle,gop,merange,b,norm,n",
                         MATRIX)
def test_decode_video_equals_host_engine(writer, mode, huff, use_rle, gop,
                                         merange, b, norm, n):
    data = yuv420(bench_frames(W, H, n, n + gop))
    stream = encode(writer, data, W, H, b, use_rle, gop, merange, huff, mode,
                    norm)
    assert bool(stream[0] & 0x80) == huff
    for motioncomp in (True, False):
        held(stream, motioncomp, norm, b)


def test_decode_frames_are_decode_video_y_planes():
    data = yuv420(bench_frames(W, H, 7, 3))
    stream = encode("port", data, W, H, 4, True, 4, 8, True, "recon")
    frames = imageencoder_tpu_torch.decode_frames(stream, device="cpu")
    assert frames.dtype == torch.uint8 and frames.shape == (7, H, W)
    yuv, _, _ = held(stream)
    y = np.frombuffer(yuv, np.uint8).reshape(7, -1)[:, :W * H]
    np.testing.assert_array_equal(frames.numpy().reshape(7, -1), y)
    assert (np.frombuffer(yuv, np.uint8).reshape(7, -1)[:, W * H:]
            == video.UV_FILL).all()


@pytest.mark.parametrize("huff", [True, False])
def test_header_only_stream_is_an_empty_video(huff):
    stream = encode("port", b"", W, H, 4, True, 4, 8, huff, "raw")
    yuv, params, size = held(stream)
    assert yuv == b"" and params.frame_count == 0 and size == (W, H)
    frames = imageencoder_tpu_torch.decode_frames(stream, device="cpu")
    assert frames.shape == (0, H, W)


def test_forty_frames_spliced_in_the_encode():
    """Past the encode's 32 frames a call: GOP-aligned chunks spliced on
    the host; the decode walks them as one video."""
    data = yuv420(bench_frames(32, 32, 40, 11))
    held(encode("port", data, 32, 32, 4, True, 4, 8, True, "raw"))


@pytest.mark.parametrize("huff", [True, False])
def test_all_i_video_at_a_size_no_multiple_of_16(huff):
    frames = np.stack([np.roll(bench_frames(40, 24, 1, 5)[0][:20, :36],
                               f, 1) for f in range(5)])
    held(encode("port", yuv420(frames), 36, 20, 4, True, 1, 8, huff, "raw"))


@pytest.mark.parametrize("huff,keep", [(True, 0.6), (False, 0.5),
                                       (False, 0.9)])
def test_truncated_stream_decodes_as_on_the_host(huff, keep):
    """Records and vectors past the end read zero bits on both sides."""
    data = yuv420(bench_frames(W, H, 8, 2))
    stream = encode("port", data, W, H, 4, True, 4, 8, huff, "raw")
    held(stream[:int(len(stream) * keep)])


def hand_stream(w: int, h: int, n: int, gop: int, body_bits: int = 2400,
                b: int = 4) -> bytes:
    """A stream without Huffman: the header of a w x h video of n frames,
    then seeded random bits."""
    q = quant_from_numpy(np.full((b, b), 3))
    writer = video.video_header(q, True, w, h, VideoParams(n, gop, 8), False)
    body = np.random.default_rng(w + h + n).integers(
        0, 256, body_bits // 8).astype(np.uint8).tobytes()
    return bitpack.concat_bit_segments([(writer.getvalue(), writer.position),
                                        (body, body_bits)])


@pytest.mark.parametrize("w,h,n,gop,ok", [
    (40, 24, 3, 4, False),  # P-frames off the macroblock grid
    (42, 24, 2, 1, False),  # no multiple of the block
    (42, 24, 0, 1, True),   # ... but no frame to decode
    (40, 24, 3, 1, True),   # all I-frames: no macroblock needed
    (0, 16, 3, 4, True),    # frames of no pixel
    (48, 32, 5, 2, True),   # random records and vectors
])
def test_hand_built_streams_decode_or_raise_as_on_the_host(w, h, n, gop, ok):
    stream = hand_stream(w, h, n, gop)
    if ok:
        held(stream)
        return
    with pytest.raises(ValueError):
        jax_video.decode_video(stream, backend="numpy")
    with pytest.raises(StreamFormatError):  # a ValueError
        imageencoder_tpu_torch.decode_video(stream, device="cpu")


def test_rejections_raise_the_host_engine_classes():
    with pytest.raises(StreamFormatError, match="empty stream"):
        imageencoder_tpu_torch.decode_video(b"", device="cpu")
    with pytest.raises(Exception, match="empty stream"):
        jax_video.decode_video(b"", backend="numpy")
    no_dict = b"\x80\x00"  # the Huffman flag, then a group of 0 entries
    for fn in (lambda: imageencoder_tpu_torch.decode_video(no_dict,
                                                           device="cpu"),
               lambda: jax_video.decode_video(no_dict, backend="numpy")):
        with pytest.raises(ValueError, match="without a dict"):
            fn()
    corrupt = dict_stream([(1, 1, 2), (2, 1, 2)])  # a duplicate code
    with pytest.raises(StreamFormatError, match="duplicate"):
        imageencoder_tpu_torch.decode_video(corrupt, device="cpu")
    with pytest.raises(Exception, match="duplicate"):
        jax_video.decode_video(corrupt, backend="numpy")


# ---- the wrappers' plain versions against the host's pieces ----


def front(stream: bytes):
    """The JAX package's host front half, and the port's plan."""
    (payload, _q, use_rle, params, w, h,
     parsed) = jax_video.parse_video_stream(stream)
    plan = video.plan_video(stream)
    return bytes(payload), use_rle, params, w, h, parsed, plan


def u8(data: bytes, tail: int = 64) -> torch.Tensor:
    return torch.tensor(list(data) + [0xFF] * tail, dtype=torch.uint8)


@pytest.mark.parametrize("gop,merange,use_rle", [(4, 16, True), (5, 1, True),
                                                 (1, 8, False),
                                                 (3, 8, False)])
def test_walk_video_and_vector_read_equal_the_host_walk(gop, merange,
                                                         use_rle):
    data = yuv420(bench_frames(W, H, 9, gop))
    stream = encode("port", data, W, H, 4, use_rle, gop, merange, False,
                    "raw")
    payload, use_rle, params, w, h, parsed, plan = front(stream)
    nbytes = torch.tensor([len(payload)])
    n, n_micro = params.frame_count, plan["n_blocks"]
    offs, dbits, counts, end, vstart, rstart = cuda_decode.walk_video(
        u8(payload), nbytes, plan["start"], n, n_micro, max(1, gop),
        plan["vbits"], use_rle, 4, chunk_bits=32)
    for f, (mv, start, recs) in enumerate(parsed):
        assert int(rstart[f]) == start
        assert int(vstart[f]) == start - (0 if mv is None else
                                          plan["vbits"])
        for got, want in zip((offs, dbits, counts), recs):
            np.testing.assert_array_equal(
                got[f * n_micro:(f + 1) * n_micro].numpy(), want)
    last = jax_image.walk_block_offsets(None, parsed[-1][1], n_micro,
                                        use_rle, packed=payload)[3]
    assert int(end) == last
    mvec = cuda_decode.read_vectors(u8(payload), nbytes, vstart, max(1, gop),
                                    plan["n_macro"], plan["mb"])
    assert mvec.shape == (n, plan["n_macro"], 2)
    for f, (mv, _, _) in enumerate(parsed):
        want = np.zeros((plan["n_macro"], 2)) if mv is None else mv
        np.testing.assert_array_equal(mvec[f].numpy(), want)
    assert cuda_decode.walk_video.launches == 0  # the plain versions
    assert cuda_decode.read_vectors.launches == 0


def test_p_frame_block_decode_equals_the_host_chain():
    """D3 with a prediction on frames k::gop of a video: the host's
    clamp(pred + (inverse + 128)) (models/video.py:637-647)."""
    data = yuv420(bench_frames(W, H, 8, 6))
    stream = encode("port", data, W, H, 4, True, 4, 8, False, "recon")
    payload, use_rle, params, w, h, parsed, plan = front(stream)
    n_micro = plan["n_blocks"]
    recs = [torch.from_numpy(np.concatenate([p[2][i] for p in parsed]))
            .view(8, n_micro) for i in range(3)]
    rng = np.random.default_rng(0)
    pred = torch.from_numpy(rng.integers(0, 256, (2, H, W), np.uint8))
    out = torch.zeros((8, H, W), dtype=torch.uint8)
    q = quant(4)
    got = cuda_decode.decode_blocks(
        u8(payload), torch.tensor([len(payload)]), *(r[1::4] for r in recs),
        torch.from_numpy(q.as_float().reshape(-1)), 4, "reference", H, W,
        pred=pred, out=out[1::4])
    assert got.shape == (2, H, W) and (out[0::4] == 0).all()
    for g, f in enumerate((1, 5)):
        blocks, _ = jax_image.decode_blocks(
            None, parsed[f][1], n_micro, q, use_rle, backend="numpy",
            residual=True, packed=payload)
        res = deblockify(blocks, H, W)
        want = clamp_to_u8(pred[g].numpy().astype(np.float64) + res)
        np.testing.assert_array_equal(out[f].numpy(), want)
    assert cuda_decode.decode_blocks.launches == 0


@pytest.mark.parametrize("mb", [2, 6, 16])
def test_predict_takes_every_vector_a_stream_holds(mb):
    """Vectors out to +-2^(mb - 1), the widest a P-frame's fields hold,
    clamp at every edge as the host's predict_image does; ref, vectors
    and out as views of every k-th frame."""
    rng = np.random.default_rng(mb)
    frames = torch.from_numpy(rng.integers(0, 256, (6, 48, 64), np.uint8))
    n_macro = 3 * 4
    lim = 1 << (mb - 1)
    mvec = torch.from_numpy(rng.choice(
        [-lim, -lim + 1, -1, 0, 1, lim - 1, 17, -33], (6, n_macro, 2))
        .astype(np.int32))
    out = torch.zeros_like(frames)
    got = cuda_motion.predict(frames[0::3], mvec[1::3], out=out[1::3])
    assert got.data_ptr() == out[1::3].data_ptr()
    for g, f in enumerate((1, 4)):
        want = jax_motion.predict_image(frames[3 * g].numpy(),
                                        mvec[f].numpy(), 48, 64)
        np.testing.assert_array_equal(out[f].numpy(), want)
    assert (out[0::3] == 0).all() and (out[2::3] == 0).all()
    assert cuda_motion.predict.launches == 0
