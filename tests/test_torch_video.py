"""The port's video encode (imageencoder_tpu_torch/models/video.py and
ops/video_pipeline.py) and K5 against the JAX package, on the CPU, where
every kernel wrapper runs its plain version.

  * quantize_image (K5) equals the host engine's exact f64 transform
    (ops/dct.forward_transform) bit for bit, on pixels and on residuals,
    and the TPU kernel pallas_kernels.dct_quantize(interpret=True) except
    where the f64 quotient lies within 1e-6 of a rounding tie (the TPU
    kernel computes in f32);
  * K1 on int16 residuals: the extreme residual blocks pack exactly in
    register files of video_lw words, and int16 samples outside the
    residual range are refused, not truncated: the host raises where it
    reads the stream's total;
  * the reconstruction, and the fused recon step's plain version
    (residual, K5, reconstruction), equal runtime/native.py::
    idct_recon_exact_native;
  * K4's pack_coeffs front end (its plain version here), from the record
    lengths beside the coefficients or from the coefficients alone, equals
    the JAX package's recon fields (pipeline.fields_from_coeffs and the
    vector fields of video_pipeline.py:353-362) packed by
    device_pack.pack_blocks_device, bit for bit;
  * encode_video(device="cpu") equals imageencoder_tpu's
    encode_video(backend="numpy") byte for byte, raw and recon reference,
    Huffman on and off, gop 1/3/4, RLE off, 40 frames (chunked) and an
    empty input, and stays within the tolerance of
    tests/test_video_device.py:73-86 of encode_video(backend="jax");
  * the frames a device pass takes (models/video.py::frames_per_pass) from
    a given free memory: whole GOPs, growing with the memory, within the
    32-bit indices, fewer for recon, and at the 720p cell's shape the
    buffers summed by hand; and the stream, with that budget forced to one
    GOP, to an uneven chunk and to the whole clip, byte for byte the host
    engine's.

Inputs are seeded frames built like bench.py's video content, and the 4x4
top-left of the JPEG luminance table, one array made into each package's
QuantMatrix.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from imageencoder_tpu.models import video as jax_video
from imageencoder_tpu.ops import bitpack
from imageencoder_tpu.ops import rle as jax_rle
from imageencoder_tpu.ops.dct import (_inv_weights, dct_matrix,
                                      forward_transform)
from imageencoder_tpu.ops.device_pack import pack_blocks_device
from imageencoder_tpu.ops.pipeline import fields_from_coeffs
from imageencoder_tpu.ops.blockify import blockify
from imageencoder_tpu.ops.pallas_encode import frontend_lw, video_lw
from imageencoder_tpu.ops.pallas_kernels import dct_quantize
from imageencoder_tpu.ops.zigzag import zigzag_order
from imageencoder_tpu.runtime.native import idct_recon_exact_native
from imageencoder_tpu.utils.quant import QuantMatrix
import imageencoder_tpu_torch
from imageencoder_tpu_torch.models import video as port_video
from imageencoder_tpu_torch.ops import (cuda_encode, cuda_pack, device_pack,
                                        pipeline)
from imageencoder_tpu_torch.utils import profiling

from tests.test_video_parity import make_video

JPEG4 = [[16, 11, 10, 16], [12, 12, 14, 19], [14, 13, 16, 24],
         [14, 17, 22, 29]]
QUANT = QuantMatrix(np.array(JPEG4, np.uint32))
PORT_QUANT = imageencoder_tpu_torch.quant_from_numpy(QUANT.matrix)


def bench_frames(w: int, h: int, n: int, seed: int) -> np.ndarray:
    """bench.py:229-238's content: 8x8 random blocks moving by (2, 3)
    pixels a frame, plus Gaussian noise of sigma 3."""
    rng = np.random.default_rng(seed)
    base = np.kron(rng.integers(0, 256, (h // 8, w // 8)), np.ones((8, 8)))
    return np.stack([np.clip(np.roll(base, (f * 2, f * 3), (0, 1))
                             + rng.normal(0, 3, base.shape), 0, 255)
                     .astype(np.uint8) for f in range(n)])


def yuv420(frames: np.ndarray) -> bytes:
    h, w = frames.shape[1:]
    return b"".join(f.tobytes() + bytes([0x80]) * (w * h // 2)
                    for f in frames)


def residual_image(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = bench_frames(w, h, 2, seed)
    noise = rng.integers(-255, 256, (h, w)) * (rng.random((h, w)) < 0.05)
    return np.clip(a[1].astype(np.int16) - a[0] + noise,
                   -255, 255).astype(np.int16)


@pytest.mark.parametrize("kind,b,norm", [
    ("pixels", 4, "reference"), ("residual", 4, "reference"),
    ("residual", 8, "ortho")])
def test_quantize_image_equals_exact_host(kind, b, norm):
    h, w = 32, 48
    x = (bench_frames(w, h, 1, 4)[0] if kind == "pixels"
         else residual_image(h, w, 5))
    q = np.array(JPEG4, np.float64) if b == 4 else np.full((b, b), 3.0)
    got = cuda_encode.quantize_image(torch.from_numpy(x), q, b, norm)
    assert got.dtype == torch.int32 and got.shape == (h, w)
    want = forward_transform(blockify(x.astype(np.float64) + 0.0, b), q, norm)
    want = (want.reshape(h // b, w // b, b, b).transpose(0, 2, 1, 3)
            .reshape(h, w))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["pixels", "residual"])
def test_quantize_image_equals_tpu_kernel_off_ties(kind):
    """Equal to the TPU kernel wherever the exact quotient is not within
    1e-6 of .5, where the kernel's f32 arithmetic may round the other
    way."""
    h, w = 64, 128
    x = (bench_frames(w, h, 1, 6)[0] if kind == "pixels"
         else residual_image(h, w, 7))
    q = np.array(JPEG4, np.float64)
    dm = jnp.asarray(np.asarray(dct_matrix(4, "reference"), np.float32))
    tpu = np.asarray(dct_quantize(jnp.asarray(x.astype(np.float32)),
                                  jnp.asarray(q, jnp.float32), dm, 4,
                                  interpret=True))
    got = cuda_encode.quantize_image_plain(torch.from_numpy(x), q).numpy()
    # The exact quotient before rounding, from the f64 reference order.
    blocks = blockify(x.astype(np.float64) - 128.0, 4).reshape(-1, 16)
    wf, scale = cuda_encode.encode_tables(4, "reference", zigzag=False)
    z = (blocks @ wf) * scale / q.reshape(-1)
    z = z.reshape(h // 4, w // 4, 4, 4).transpose(0, 2, 1, 3).reshape(h, w)
    near_tie = np.abs(np.abs(z - np.trunc(z)) - 0.5) < 1e-6
    assert (got[~near_tie] == tpu[~near_tie]).all()
    assert np.abs(got - tpu).max() <= 1


def extreme_residuals() -> np.ndarray:
    """Residual blocks at the ends of [-255, 255]: cur 255 over pred 0,
    0 over 255, and an impulse of +255 in a block of -255, whose record
    needs all 16 coefficients at 12 bits (208 bits: 7 words)."""
    x = np.empty((4, 12), np.int16)
    x[:, 0:4] = 255
    x[:, 4:8] = -255
    x[:, 8:12] = -255
    x[1, 9] = 255
    return x


def test_k1_packs_extreme_residuals_in_video_lw_words():
    x = torch.from_numpy(extreme_residuals())
    q = np.ones((4, 4))
    lw = cuda_encode.record_words(torch.int16, 4, "reference")
    assert lw == video_lw(4, "reference") == 7
    assert frontend_lw(4, "reference") == 6
    words, lens, overflow = cuda_encode.encode_locals(x, q)
    assert words.shape == (3, lw) and lens.tolist()[2] == 208
    assert overflow.tolist() == [0]
    # The register files hold the records exactly: packed, they equal the
    # host engine's fields of the same coefficients.
    cz = forward_transform(blockify(extreme_residuals().astype(np.float64),
                                    4), q).reshape(3, 16)[:, zigzag_order(4)]
    vals, nbits = jax_rle.block_fields(cz, jax_rle.block_stats(cz, True),
                                       True)
    want, total = bitpack.pack_fields(vals.ravel(), nbits.ravel())
    got_words, got_total = device_pack.merge_records(
        device_pack.as_uint(words), lens, 0, 3 * lw)
    assert int(got_total) == total
    assert device_pack.stream_bytes(got_words, total) == want
    with pytest.raises(TypeError, match="int16"):
        cuda_encode.encode_locals(x.to(torch.int32), q)


def wild_samples() -> np.ndarray:
    """int16 samples near +-32767, far outside the residual range: their
    records need about 18 bits a coefficient, more than 7 words."""
    rng = np.random.default_rng(3)
    return (rng.choice([-1, 1], (4, 8)) * rng.integers(30000, 32767, (4, 8))
            ).astype(np.int16)


def test_k1_refuses_samples_outside_the_residual_bound():
    x = torch.from_numpy(wild_samples())
    q = np.ones((4, 4))
    lw = video_lw(4, "reference")
    words, lens, overflow = cuda_encode.encode_locals(x, q)
    refused = lens > 32 * lw
    assert overflow.tolist() == [1] and refused.all()
    assert not words[refused].any()  # refused, not truncated
    words, total = pipeline.make_encode_packed()(x, q, 0, None)
    assert int(total) == -1
    with pytest.raises(ValueError, match="register file"):
        device_pack.host_total(total)


def test_reconstruction_equals_host_engine():
    """reconstruct, and the recon step's plain version from the frame and
    its prediction, both equal the host engine's exact reconstruction; the
    step's coefficients equal K5's on the residual and land in ``out``."""
    h, w = 32, 48
    rng = np.random.default_rng(8)
    res = residual_image(h, w, 9)
    pred = rng.integers(0, 256, (h, w), dtype=np.uint8)
    q = np.array(JPEG4, np.float64)
    coeffs = cuda_encode.quantize_image(torch.from_numpy(res), q)
    got = cuda_encode.reconstruct(coeffs, torch.from_numpy(pred), q, 4,
                                  "reference")
    zz = zigzag_order(4)
    czz = (coeffs.numpy().reshape(h // 4, 4, w // 4, 4).transpose(0, 2, 1, 3)
           .reshape(-1, 16)[:, zz])
    want = idct_recon_exact_native(czz, 4, zz, _inv_weights(4, "reference"),
                                   q, pred, h, w)
    np.testing.assert_array_equal(got.numpy(), want)

    # The same residual as a frame over its prediction (cur = pred + res
    # wherever that is a pixel; elsewhere the residual is clipped).
    cur = np.clip(pred.astype(np.int16) + res, 0, 255).astype(np.uint8)
    step_res = cur.astype(np.int16) - pred
    out = torch.full((h, w), -7, dtype=torch.int32)
    for fn in (cuda_encode.recon_step_plain, cuda_encode.recon_step):
        before = cuda_encode.recon_step.launches
        sq, srec = fn(torch.from_numpy(cur), torch.from_numpy(pred), q, 4,
                      "reference", out=out)
        assert cuda_encode.recon_step.launches == before
        assert sq.data_ptr() == out.data_ptr()
        assert torch.equal(sq, cuda_encode.quantize_image(
            torch.from_numpy(step_res), q))
        czz = (sq.numpy().reshape(h // 4, 4, w // 4, 4).transpose(0, 2, 1, 3)
               .reshape(-1, 16)[:, zz])
        want = idct_recon_exact_native(czz, 4, zz,
                                       _inv_weights(4, "reference"), q, pred,
                                       h, w)
        np.testing.assert_array_equal(srec.numpy(), want)


def recon_records(b: int, n: int, gop: int, seed: int):
    """Seeded coefficients int32 [n, 32, 48] (mostly zero, some blocks
    ending in a nonzero after a zero: the trailing-strip quirk) and the
    P-frames' vectors int32 [P, 6, 2] (none when every frame is an
    I-frame, as the recon encoder passes them)."""
    rng = np.random.default_rng(seed)
    h, w = 32, 48
    mag = 2 ** (cuda_encode.coeff_bound_bits_residual(b, "reference") - 1)
    coeffs = (rng.integers(-mag, mag, (n, h, w))
              * (rng.random((n, h, w)) < 0.3)).astype(np.int32)
    coeffs[:, b - 1::b, b - 1::b] = rng.integers(1, 9, (n, h // b, w // b))
    n_p = sum(1 for f in range(n) if f % gop)
    n_macro = (h // 16) * (w // 16) if n_p else 0
    mvecs = rng.integers(-16, 17, (n_p, n_macro, 2)).astype(np.int32)
    return coeffs, mvecs


def jax_recon_pack(coeffs, mvecs, gop, mvec_nbits, b, use_rle, start, nw,
                   prefix):
    """The JAX package's recon records (video_pipeline.py:334, 353-362)
    packed by pack_blocks_device, with the prefix OR'd in."""
    n, h, w = coeffs.shape
    k = b * b
    n_macro = mvecs.shape[1]
    czz = (coeffs.reshape(n, h // b, b, w // b, b).transpose(0, 1, 3, 2, 4)
           .reshape(-1, k)[:, zigzag_order(b)])
    bv, bb = fields_from_coeffs(jnp.asarray(czz), use_rle)
    bv = np.asarray(bv).reshape(n, -1, k + 2)
    bb = np.asarray(bb).reshape(n, -1, k + 2)
    mv = np.zeros((n, n_macro, k + 2), np.int32)
    mb = np.zeros_like(mv)
    p_idx = [f for f in range(n) if f % gop]
    mv[p_idx, :, :2] = mvecs & ((1 << mvec_nbits) - 1)
    mb[p_idx, :, :2] = mvec_nbits
    vals = np.concatenate([mv, bv], axis=1).reshape(-1, k + 2)
    nbits = np.concatenate([mb, bb], axis=1).reshape(-1, k + 2)
    words, total = pack_blocks_device(jnp.asarray(vals), jnp.asarray(nbits),
                                      jnp.int32(start), nw)
    words = np.asarray(words).copy()
    words[:len(prefix)] |= prefix
    return words, int(total)


@pytest.mark.parametrize("lengths", ["given", "from_coeffs"])
@pytest.mark.parametrize("b,use_rle,gop,n", [
    (4, True, 3, 5), (4, False, 2, 4), (8, True, 3, 4), (8, False, 2, 3),
    (4, True, 1, 3)])
def test_pack_coeffs_equals_jax_fields_and_pack(b, use_rle, gop, n, lengths):
    """From the record lengths the transform writes beside the
    coefficients (the recon path's), and from the coefficients alone."""
    coeffs, mvecs = recon_records(b, n, gop, 10 * b + gop)
    lens = (cuda_encode.record_lengths(torch.from_numpy(coeffs), b, use_rle)
            if lengths == "given" else None)
    mvec_nbits = 6
    k = b * b
    rows = n * (mvecs.shape[1] + (32 // b) * (48 // b))
    nw = device_pack.packed_words_bound(rows, device_pack.local_words(k + 2))
    prefix = np.random.default_rng(n).integers(0, 2 ** 32, 3,
                                               dtype=np.uint64)
    prefix = prefix.astype(np.uint32)
    prefix[2] &= 0xFFFFFF00  # the prefix ends at bit 88
    want_w, want_t = jax_recon_pack(coeffs, mvecs, gop, mvec_nbits, b,
                                    use_rle, 88, nw, prefix)
    lw = cuda_encode.video_lw(b, "reference")
    before = cuda_pack.pack_coeffs.launches
    got_w, got_t = cuda_pack.pack_coeffs(
        torch.from_numpy(coeffs), torch.from_numpy(mvecs), gop, mvec_nbits,
        b, use_rle, lw, 88, nw, prefix=torch.from_numpy(prefix.view(np.int32)),
        lens=lens)
    assert cuda_pack.pack_coeffs.launches == before  # CPU: plain version
    assert int(got_t) == want_t
    np.testing.assert_array_equal(got_w.numpy().view(np.uint32), want_w)


def test_pack_coeffs_refuses_records_past_lw():
    coeffs, mvecs = recon_records(4, 2, 2, 3)
    coeffs[1, 4, 8] = 2 ** 20  # 22-bit coefficients: 378 bits > 7 words
    lw = cuda_encode.video_lw(4, "reference")
    _, total = cuda_pack.pack_coeffs(torch.from_numpy(coeffs),
                                     torch.from_numpy(mvecs), 2, 6, 4, True,
                                     lw, 0, 10000)
    assert int(total) == -1
    with pytest.raises(ValueError, match="register file"):
        device_pack.host_total(total)
    with pytest.raises(ValueError, match="P-frames"):
        cuda_pack.pack_coeffs(torch.from_numpy(coeffs),
                              torch.from_numpy(mvecs[:0]), 2, 6, 4, True,
                              lw, 0, 10000)


CASES = [  # w, h, frames, gop, merange, rle, huffman, ref_mode
    (64, 64, 8, 4, 16, True, True, "raw"),
    (64, 64, 8, 4, 16, True, False, "raw"),
    (64, 64, 8, 4, 16, True, True, "recon"),
    (64, 64, 8, 4, 16, True, False, "recon"),
    (64, 48, 7, 3, 8, False, True, "raw"),
    (64, 48, 7, 3, 8, False, False, "recon"),
    (48, 32, 5, 1, 16, True, True, "recon"),
    (36, 20, 3, 1, 4, True, False, "raw"),   # all-I, not a multiple of 16
    (64, 32, 40, 4, 16, True, True, "raw"),  # chunked: 32 + 8 frames
    (64, 32, 40, 3, 4, True, False, "recon"),
    (32, 32, 6, 4, 1, True, True, "raw"),    # merange 1: zero vectors
    (48, 32, 5, 1, 16, True, True, "raw"),   # gop 1: no P-frame
    (48, 32, 3, 8, 8, True, False, "raw"),   # the only GOP cut short
    (48, 32, 3, 8, 8, True, True, "recon"),
    (64, 32, 35, 32, 4, True, False, "raw"),  # chunks of 32: a GOP of 3
]


@pytest.mark.parametrize("w,h,n,gop,merange,use_rle,huff,mode", CASES)
def test_encode_video_equals_host_engine(w, h, n, gop, merange, use_rle,
                                         huff, mode):
    data = yuv420(bench_frames(w, h, n, w * n + gop))
    got = imageencoder_tpu_torch.encode_video(
        data, w, h, PORT_QUANT, use_rle, gop, merange, use_huffman=huff,
        ref_mode=mode, device="cpu")
    want = jax_video.encode_video(data, w, h, QUANT, use_rle, gop, merange,
                                  use_huffman=huff, backend="numpy",
                                  ref_mode=mode)
    assert isinstance(got, bytes) and got == bytes(want)


@pytest.mark.parametrize("mode", ["raw", "recon"])
@pytest.mark.parametrize("norm", ["ortho", "reference"])
def test_encode_video_8x8_blocks_equals_host_engine(mode, norm):
    i, j = np.indices((8, 8))
    quant = QuantMatrix((1 + 2 * (i + j)).astype(np.uint32))
    data = yuv420(bench_frames(64, 48, 6, 3))
    got = imageencoder_tpu_torch.encode_video(
        data, 64, 48, imageencoder_tpu_torch.quant_from_numpy(quant.matrix),
        True, 3, 8, norm=norm, ref_mode=mode,
        block_size=8, device="cpu")
    assert got == bytes(jax_video.encode_video(
        data, 64, 48, quant, True, 3, 8, norm=norm, backend="numpy",
        ref_mode=mode, block_size=8))


@pytest.mark.parametrize("huff", [True, False])
def test_empty_video_is_a_header_only_stream(huff):
    data = bytes(64 * 64)  # less than one YUV420p frame
    got = imageencoder_tpu_torch.encode_video(data, 64, 64, PORT_QUANT,
                                              True, 4, 16, use_huffman=huff,
                                              device="cpu")
    assert got == bytes(jax_video.encode_video(
        data, 64, 64, QUANT, True, 4, 16, use_huffman=huff,
        backend="numpy"))


def test_geometry_and_mode_are_checked():
    data = yuv420(bench_frames(40, 24, 2, 1))
    with pytest.raises(ValueError, match="multiples of 16"):
        imageencoder_tpu_torch.encode_video(data, 40, 24, PORT_QUANT, True,
                                            4, 16, device="cpu")
    with pytest.raises(ValueError, match="ref_mode"):
        imageencoder_tpu_torch.encode_video(data, 40, 24, PORT_QUANT, True,
                                            1, 16, ref_mode="decoded",
                                            device="cpu")


@pytest.mark.parametrize("mode", ["raw", "recon"])
def test_encode_video_near_the_jax_device_path_and_decodes(mode):
    """The JAX device path computes in f32 and differs at rounding ties:
    on the input of tests/test_video_device.py:73-86, and under its
    tolerance, stream lengths within 16 bytes and decoded pixels within
    0.5 on average.  Both decode."""
    data, frames = make_video(smooth=True, seed=2)
    got = imageencoder_tpu_torch.encode_video(
        data, 64, 64, PORT_QUANT, True, 4, 16, use_huffman=False,
        ref_mode=mode, device="cpu")
    jx = jax_video.encode_video(data, 64, 64, QUANT, True, 4, 16,
                                use_huffman=False, backend="jax",
                                ref_mode=mode)
    assert abs(len(got) - len(jx)) <= 16
    da, params, size = jax_video.decode_video(got, backend="fast")
    db, _, _ = jax_video.decode_video(jx, backend="fast")
    assert (params.frame_count, size) == (8, (64, 64))
    ya = np.frombuffer(da, np.uint8).astype(np.int32)
    yb = np.frombuffer(db, np.uint8).astype(np.int32)
    assert np.abs(ya - yb).mean() < 0.5
    y = ya.reshape(8, -1)[:, :64 * 64]
    mse = ((y - np.stack(frames).reshape(8, -1)) ** 2).mean()
    assert 10 * np.log10(255 ** 2 / mse) > 28


# ---- the frames a device pass takes ----

GEOMETRIES = [  # h, w, gop, block size
    (720, 1280, 4, 4), (48, 64, 3, 4), (64, 96, 1, 8), (16, 16, 1, 4),
    (2160, 3840, 6, 4), (720, 1280, 60, 8)]
FREES = [0, 10 ** 6, 10 ** 8, 10 ** 9, 8 * 10 ** 9, 40 * 10 ** 9,
         79 * 10 ** 9, 10 ** 13]


def cell_pass_bytes(n: int) -> int:
    """One pass over n frames (a multiple of 4) of the 720p cell (gop 4,
    raw, Huffman on), its buffers summed by hand: 57,600 4x4 blocks and
    3,600 macroblocks a frame, 7-word register files."""
    p = 3 * n // 4  # P-frames
    words = 428_400 * n + 64  # 61,200 records of 7 words, the header
    return (1_843_200 * n  # the int16 residual stack
            + 57_600 * 8 * 4 * n  # K1's files and lengths
            + 3_600 * 8 * p  # the vectors
            + 4 * words  # the stream
            + 16 * (61_200 * n // 256 + 1)  # K2's tile sums
            + 4 * ((4 * words * 15) // 32 + 256 + 8)  # K4's payload
            + 16 * (words // 4 // 256 + 1)  # K4's tile sums
            + -(-(4 * words + 1) // 16) * 16  # the wire buffer
            + 65_536)  # the small tensors


@pytest.mark.parametrize("prop", ["gops", "monotone", "indices", "recon",
                                  "cell"])
def test_frames_per_pass(prop):
    def budget(h, w, gop, b, free, mode="raw", huff=True):
        return port_video.frames_per_pass(h, w, gop, mode, huff, b,
                                          device="cuda", free=free)

    if prop == "cell":
        free = 8 * 10 ** 9
        n = budget(720, 1280, 4, 4, free)
        assert n == 384
        assert cell_pass_bytes(n) == port_video.pass_bytes(
            n, 720, 1280, 4, "raw", True)
        assert cell_pass_bytes(n) <= free // 2 < cell_pass_bytes(n + 4)
        # The JAX package's bound off the card.
        assert port_video.frames_per_pass(720, 1280, 4, "raw", True,
                                          device="cpu") == 32
        assert port_video.frames_per_pass(720, 1280, 3, "raw", True,
                                          device="cpu") == 30
        return
    for h, w, gop, b in GEOMETRIES:
        for huff in (True, False):
            got = {mode: [budget(h, w, gop, b, f, mode, huff) for f in FREES]
                   for mode in ("raw", "recon")}
            for mode, ns in got.items():
                if prop == "gops":
                    assert all(n >= gop and n % gop == 0 for n in ns)
                elif prop == "monotone":
                    assert ns == sorted(ns)
                elif prop == "indices":
                    # The most the indices allow, and one GOP more breaks
                    # one of them unless the search's grid stopped it.
                    n = ns[-1]
                    for m, ok in ((n, True), (n + gop, False)):
                        _, _, records, lw = port_video._pass_stream(
                            m, h, w, gop, mode, b, "reference")
                        words = device_pack.packed_words_bound(records, lw)
                        fits = (records < 2 ** 31
                                and not (huff and 4 * words >= 2 ** 31))
                        assert fits == ok or (not ok and m > 65535)
                        assert m <= 65535 or not ok
            if prop == "recon":
                assert all(r <= a for r, a in zip(got["recon"], got["raw"]))


@pytest.mark.parametrize("huff", [True, False])
@pytest.mark.parametrize("mode", ["raw", "recon"])
@pytest.mark.parametrize("budget", [3, 9, 14])  # a GOP, uneven, the clip
def test_forced_frame_budget_equals_host_engine(monkeypatch, budget, mode,
                                                huff):
    """A 14-frame clip in GOPs of 3, its passes' frames forced: one GOP
    (5 passes), 9 frames (9 + 5) and the whole clip (one pass)."""
    w, h, n, gop = 64, 32, 14, 3
    monkeypatch.setattr(port_video, "frames_per_pass",
                        lambda *args, **kwargs: budget)
    data = yuv420(bench_frames(w, h, n, budget))
    with profiling.tracing("encode") as t:
        got = imageencoder_tpu_torch.encode_video(
            data, w, h, PORT_QUANT, True, gop, 8, use_huffman=huff,
            ref_mode=mode, device="cpu")
    assert got == bytes(jax_video.encode_video(
        data, w, h, QUANT, True, gop, 8, use_huffman=huff, backend="numpy",
        ref_mode=mode))
    want = {"encode_passes": -(-n // budget)}
    if mode == "recon":  # each pass's P steps: its GOPs' frames 1 .. gop - 1
        want["recon_steps"] = sum(min(gop, n - s, budget) - 1
                                  for s in range(0, n, budget))
    assert t.counters == want
