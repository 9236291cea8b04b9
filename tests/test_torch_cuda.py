"""The port's CUDA kernels against their plain versions, and its
full-size image and video streams against the JAX package's host engine,
on the card.

Every test here needs a CUDA card: it is marked ``cuda`` and skips where
torch.cuda.is_available() is false.  The file imports no JAX (the machine
with the card has none); run it there, without the JAX-configuring
conftest, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

import torch

import imageencoder_tpu
import imageencoder_tpu_torch
from imageencoder_tpu.models import video as host_video
from imageencoder_tpu.utils.quant import QuantMatrix
from imageencoder_tpu_torch import quant_from_numpy
from imageencoder_tpu_torch.ops import (cuda_encode, cuda_kernels,
                                        cuda_motion, cuda_pack, device_pack,
                                        pipeline)

pytestmark = pytest.mark.cuda

JPEG4 = [[16, 11, 10, 16], [12, 12, 14, 19], [14, 13, 16, 24],
         [14, 17, 22, 29]]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def image(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    f = (128 + 60 * np.sin(x / 9.0) * np.cos(y / 7.0)
         + rng.normal(0, 12, (h, w)))
    return np.clip(np.rint(f), 0, 255).astype(np.uint8)


def quant_for(b: int, kind: str = "jpeg") -> np.ndarray:
    if kind == "ones":
        return np.ones((b, b))
    if kind == "wide":  # entries past 255 and off the integers: __ddiv_rn
        q = quant_for(b)
        q[0, 1], q[1, 0], q[b - 1, b - 1] = 300.0, 1000.0, 2.5
        return q
    if b == 4:
        return np.array(JPEG4, np.float64)
    i, j = np.indices((b, b))
    return (1 + 2 * (i + j)).astype(np.float64)


@pytest.mark.parametrize("h,w,b,norm,use_rle,qkind", [
    (64, 96, 4, "reference", True, "jpeg"),
    (20, 24, 4, "reference", False, "jpeg"),
    (64, 64, 4, "reference", True, "ones"),
    (64, 64, 8, "ortho", True, "jpeg"),
    (64, 64, 8, "reference", False, "ones"),
    (64, 96, 4, "reference", True, "wide"),
    (64, 64, 8, "ortho", False, "wide"),
])
def test_encode_locals_kernel_equals_plain(dev, h, w, b, norm, use_rle,
                                           qkind):
    img = torch.from_numpy(image(h, w, h + w)).to(dev)
    q = quant_for(b, qkind)
    before = cuda_encode.encode_locals.launches
    got = cuda_encode.encode_locals(img, q, b, use_rle, norm)
    want = cuda_encode.encode_locals_plain(img, q, b, use_rle, norm)
    assert cuda_encode.encode_locals.launches == before + 1
    assert len(got) == len(want) == 3
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("start", [0, 37, 2047])
def test_pack_locals_kernel_equals_plain(dev, start):
    img = torch.from_numpy(image(128, 64, 5)).to(dev)
    local, lens, _ = cuda_encode.encode_locals(img, quant_for(4))
    nw = local.shape[0] * 9 + 64
    prefix = torch.full((2,), -1, dtype=torch.int32, device=dev)
    prefix = prefix if start >= 64 else None
    got = cuda_pack.pack_locals(local, lens, start, nw, prefix)
    want = cuda_pack.pack_locals_plain(local, lens, start, nw, prefix)
    assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])


@pytest.mark.parametrize("n,f,start,nw", [
    (1, 3, 0, 8), (1000, 16, 171, 1000 * 8 + 10), (3000, 18, 5, 2000)])
def test_pack_records_kernel_equals_plain(dev, n, f, start, nw):
    rng = np.random.default_rng(n)
    nbits = torch.from_numpy(rng.integers(0, 17, (n, f)).astype(np.int32))
    vals = torch.from_numpy(rng.integers(-(2 ** 15), 2 ** 15, (n, f))
                            .astype(np.int32))
    nbits, vals = nbits.to(dev), vals.to(dev)
    before = cuda_pack.pack_records.launches
    got = cuda_pack.pack_records(vals, nbits, start, nw)
    want = cuda_pack.pack_records_plain(vals, nbits, start, nw)
    assert cuda_pack.pack_records.launches == before + 1
    assert int(got[1]) == int(want[1])
    # K4 defines the words up to the stream's last; the plain version
    # zeroes the rest of the buffer.
    assert torch.equal(cuda_pack.stream_words(*got),
                       cuda_pack.stream_words(*want))


@pytest.mark.parametrize("n_words,nbytes,start", [
    (4096, 4 * 4096 - 3, 700), (1027, 4 * 1027, 0), (5, 9, 37),
    (300000, 4 * 250000 + 1, 2047)])
def test_pack_payload_kernel_equals_plain(dev, n_words, nbytes, start):
    rng = np.random.default_rng(n_words)
    words = torch.from_numpy((rng.integers(0, 2 ** 32, n_words,
                                           dtype=np.uint64) & 0x0F1F3F7F)
                             .astype(np.uint32).view(np.int32)).to(dev)
    code_l = torch.from_numpy(rng.integers(0, 16, 256).astype(np.int32))
    code_w = torch.from_numpy(rng.integers(0, 2 ** 15, 256)
                              .astype(np.int32))
    code_l, code_w = code_l.to(dev), code_w.to(dev)
    prefix = torch.full((start // 32 + 1,), -1, dtype=torch.int32,
                        device=dev)
    prefix[-1] = -(1 << (32 - start % 32)) if start % 32 else 0
    nw = 4 * n_words * 15 // 32 + 300
    before = cuda_pack.pack_payload.launches
    got = cuda_pack.pack_payload(words, nbytes, code_w, code_l, start, nw,
                                 prefix)
    want = cuda_pack.pack_payload_plain(words, nbytes, code_w, code_l,
                                        start, nw, prefix)
    assert cuda_pack.pack_payload.launches == before + 1
    assert int(got[1]) == int(want[1])
    assert torch.equal(cuda_pack.stream_words(*got),
                       cuda_pack.stream_words(*want))


@pytest.mark.parametrize("b,use_rle,gop,h,w,n", [
    (4, True, 4, 720, 1280, 9), (8, True, 3, 64, 96, 7),
    (8, False, 2, 48, 64, 4), (4, False, 1, 32, 48, 3)])
def test_pack_coeffs_kernel_equals_plain(dev, b, use_rle, gop, h, w, n):
    """Recon records straight from coefficients, 4x4 and 8x8 blocks, RLE
    on and off, all-I videos; coefficients up to the residual bound."""
    rng = np.random.default_rng(h + b)
    mag = 2 ** (cuda_encode.coeff_bound_bits_residual(b, "reference") - 1)
    coeffs = (rng.integers(-mag, mag, (n, h, w))
              * (rng.random((n, h, w)) < 0.2)).astype(np.int32)
    n_p = sum(1 for f in range(n) if f % gop)
    n_macro = (h // 16) * (w // 16) if n_p else 0
    mvecs = rng.integers(-16, 17, (n_p, n_macro, 2)).astype(np.int32)
    c, m = torch.from_numpy(coeffs).to(dev), torch.from_numpy(mvecs).to(dev)
    lw = cuda_encode.video_lw(b, "reference")
    nw = device_pack.packed_words_bound(n * (n_macro + h * w // (b * b)),
                                        b * b + 2)
    hdr = torch.full((3,), -1, dtype=torch.int32, device=dev)
    args = (c, m, gop, 6, b, use_rle, lw, 91, nw, hdr)
    before = cuda_pack.pack_coeffs.launches
    got = cuda_pack.pack_coeffs(*args)
    want = cuda_pack.pack_coeffs_plain(*args)
    assert cuda_pack.pack_coeffs.launches == before + 1
    assert int(got[1]) == int(want[1]) > 91
    assert torch.equal(cuda_pack.stream_words(*got),
                       cuda_pack.stream_words(*want))
    c[n - 1, :b, :b] = 2 ** 20  # a record past lw words: refused
    assert int(cuda_pack.pack_coeffs(*args)[1]) == -1


def test_division_sweep_finds_no_mismatch(dev):
    """K1's reciprocal division equals __ddiv_rn for every q in 1..255 (a
    short sweep; chip_smoke.py runs the full one)."""
    got = cuda_encode.division_sweep(dev, 300, 100000, seed=5)
    assert got["checks"] == 255 * (601 * 51 + 100000)
    assert got["mismatches"] == 0, got


@pytest.mark.parametrize("nwords,total_bits", [
    (10000, 8 * 39997 - 5), (5000, 0), (70000, 32 * 20000)])
def test_byte_histogram_kernel_equals_plain(dev, nwords, total_bits):
    rng = np.random.default_rng(nwords)
    words = torch.from_numpy((rng.integers(0, 2 ** 32, nwords,
                                           dtype=np.uint64) & 0x0FFF3FFF)
                             .astype(np.uint32).view(np.int32)).to(dev)
    total = torch.tensor(total_bits, dtype=torch.int64, device=dev)
    got = cuda_kernels.byte_histogram(words, total)
    want = cuda_kernels.byte_histogram_plain(words, total)
    assert torch.equal(got, want)


@pytest.mark.parametrize("use_rle,use_huffman", [
    (True, True), (False, True), (True, False)])
def test_encode_image_on_the_card_equals_host_engine(dev, use_rle,
                                                     use_huffman):
    img = image(96, 128, 3)
    quant = QuantMatrix(np.array(JPEG4, np.uint32))
    got = imageencoder_tpu_torch.encode_image(
        img, quant_from_numpy(quant.matrix), use_rle=use_rle,
        use_huffman=use_huffman, device=dev)
    assert got == imageencoder_tpu.encode_image(
        img, quant, use_rle=use_rle, use_huffman=use_huffman,
        backend="numpy")


@pytest.mark.parametrize("h,w,kind,qkind,use_huffman,branch", [
    (912, 4096, "field", "jpeg", True, "huffman"),  # ex4's geometry
    (912, 4096, "field", "jpeg", False, "raw"),
    (2160, 3840, "field", "jpeg", True, "huffman"),  # a 4K UHD frame
    (2160, 3840, "field", "jpeg", False, "raw"),
    # Full-size noise still pays for the dict: the records' headers skew
    # the byte histogram.  Only a small image takes the raw-copy fallback.
    (912, 4096, "noise", "ones", True, "huffman"),
    (128, 256, "noise", "ones", True, "fallback"),
])
def test_full_size_stream_equals_host_engine_and_decodes(
        dev, h, w, kind, qkind, use_huffman, branch):
    if kind == "noise":
        img = np.random.default_rng(9).integers(0, 256, (h, w), np.uint8)
    else:
        img = image(h, w, h + w)
    quant = QuantMatrix(quant_for(4, qkind).astype(np.uint32))
    got = imageencoder_tpu_torch.encode_image(
        img, quant_from_numpy(quant.matrix), use_huffman=use_huffman,
        device=dev)
    want = imageencoder_tpu.encode_image(img, quant, use_huffman=use_huffman,
                                         backend="numpy")
    assert got == want
    flag = bool(got[0] & 0x80)
    assert branch == ("raw" if not use_huffman else
                      "huffman" if flag else "fallback")
    dec = imageencoder_tpu.decode_image(got, backend="fast")
    assert dec.shape == img.shape
    np.testing.assert_array_equal(
        dec, imageencoder_tpu.decode_image(want, backend="fast"))


def video_frames(w: int, h: int, n: int, seed: int) -> np.ndarray:
    """bench.py's video content: 8x8 random blocks moving by (2, 3) pixels
    a frame, plus Gaussian noise of sigma 3."""
    rng = np.random.default_rng(seed)
    base = np.kron(rng.integers(0, 256, (h // 8, w // 8)), np.ones((8, 8)))
    return np.stack([np.clip(np.roll(base, (f * 2, f * 3), (0, 1))
                             + rng.normal(0, 3, base.shape), 0, 255)
                     .astype(np.uint8) for f in range(n)])


@pytest.mark.parametrize("h,w,merange", [
    (64, 96, 16), (48, 2080, 8), (32, 32, 1), (64, 64, 300),
    (176, 320, 80)])
def test_motion_kernels_equal_plain(dev, h, w, merange):
    """K6 and K7: bit-equal vectors and predictions, frames wider than
    2048 px, no levels (merange 1), a search wider than the frame (merange
    300), and a window too large for shared memory (merange 80 at
    320x176: 320 x 172 bytes, read from global memory)."""
    frames = torch.from_numpy(video_frames(w, h, 4, w + merange)).to(dev)
    cur, ref = frames[1:], frames[:-1]
    before = cuda_motion.motion_search.launches
    mv = cuda_motion.motion_search(cur, ref, merange)
    assert cuda_motion.motion_search.launches == before + 1
    assert torch.equal(mv, cuda_motion.motion_search_plain(cur, ref,
                                                           merange))
    rng = np.random.default_rng(h)
    far = torch.from_numpy(rng.integers(-70, 70, tuple(mv.shape))
                           .astype(np.int32)).to(dev)
    for vec in (mv, far):  # found vectors, and windows against the borders
        assert torch.equal(cuda_motion.predict(ref, vec),
                           cuda_motion.predict_plain(ref, vec))


@pytest.mark.parametrize("b,norm,kind", [
    (4, "reference", "pixels"), (4, "reference", "residual"),
    (8, "ortho", "residual")])
def test_quantize_image_kernel_equals_plain(dev, b, norm, kind):
    a = video_frames(96, 64, 2, b)
    x = (torch.from_numpy(a[1]) if kind == "pixels" else
         torch.from_numpy(a[1].astype(np.int16) - a[0].astype(np.int16)))
    x = x.to(dev)
    q = quant_for(b)
    before = cuda_encode.quantize_image.launches
    got = cuda_encode.quantize_image(x, q, b, norm)
    assert cuda_encode.quantize_image.launches == before + 1
    assert torch.equal(got, cuda_encode.quantize_image_plain(x, q, b, norm))


@pytest.mark.parametrize("b,norm", [(4, "reference"), (8, "ortho")])
def test_recon_step_kernel_equals_plain(dev, b, norm):
    """The fused recon step at 720p: frames over predictions that put the
    residual near +-255 (white over black and back, in blocks), bit-equal
    coefficients and reconstruction, written in place."""
    h, w = 720, 1280
    rng = np.random.default_rng(b)
    pred = video_frames(w, h, 1, 7)[0]
    hi = rng.random((h // 4, w // 4)) < 0.5
    cur = np.where(np.kron(hi, np.ones((4, 4), bool)),
                   rng.integers(250, 256, (h, w)),
                   rng.integers(0, 6, (h, w))).astype(np.uint8)
    pred = np.where(np.kron(hi, np.ones((4, 4), bool)),
                    rng.integers(0, 6, (h, w)), pred).astype(np.uint8)
    res = cur.astype(np.int16) - pred
    assert res.max() >= 250 and res.min() <= -200
    cur_t = torch.from_numpy(cur).to(dev)
    pred_t = torch.from_numpy(pred).to(dev)
    q = quant_for(b)
    out = torch.zeros((h, w), dtype=torch.int32, device=dev)
    before = cuda_encode.recon_step.launches
    got_q, got_r = cuda_encode.recon_step(cur_t, pred_t, q, b, norm, out=out)
    assert cuda_encode.recon_step.launches == before + 1
    assert got_q.data_ptr() == out.data_ptr()
    want_q, want_r = cuda_encode.recon_step_plain(cur_t, pred_t, q, b, norm)
    assert torch.equal(got_q, want_q) and torch.equal(got_r, want_r)
    assert torch.equal(got_q, cuda_encode.quantize_image(
        torch.from_numpy(res).to(dev), q, b, norm))


def extreme_residuals() -> np.ndarray:
    """cur 255 over pred 0, 0 over 255, and an impulse of +255 in a block
    of -255 (a record of 208 bits: 7 words)."""
    x = np.empty((4, 12), np.int16)
    x[:, 0:4] = 255
    x[:, 4:12] = -255
    x[1, 9] = 255
    return x


def wild_samples() -> np.ndarray:
    """int16 samples near +-32767, far outside the residual range: their
    records need about 18 bits a coefficient, more than 7 words."""
    rng = np.random.default_rng(3)
    return (rng.choice([-1, 1], (4, 8)) * rng.integers(30000, 32767, (4, 8))
            ).astype(np.int16)


def test_encode_locals_kernel_takes_extreme_residuals(dev):
    x = torch.from_numpy(extreme_residuals()).to(dev)
    q = np.ones((4, 4))
    words, lens, overflow = cuda_encode.encode_locals(x, q)
    assert words.shape == (3, 7) and lens.tolist()[2] == 208
    assert overflow.tolist() == [0]
    want = cuda_encode.encode_locals_plain(x, q)
    assert torch.equal(words, want[0]) and torch.equal(lens, want[1])
    # Samples outside the residual range: the kernel refuses the records
    # (zero words, as the plain version), and the host raises where it
    # reads the stream's total.
    x = torch.from_numpy(wild_samples()).to(dev)
    got = cuda_encode.encode_locals(x, q)
    want = cuda_encode.encode_locals_plain(x, q)
    assert got[2].tolist() == [1] and (got[1] > 32 * 7).all()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    _, total = pipeline.make_encode_packed()(x, q, 0, None)
    with pytest.raises(ValueError, match="register file"):
        device_pack.host_total(total)


@pytest.mark.parametrize("ref_mode", ["raw", "recon"])
@pytest.mark.parametrize("b,norm,gop,use_rle", [
    (8, "ortho", 3, True), (4, "reference", 1, False),
    (4, "reference", 5, False)])
def test_small_videos_equal_host_engine(dev, ref_mode, b, norm, gop,
                                        use_rle):
    """8x8 blocks, all I-frames, RLE off, and 40 frames (two chunks)."""
    w, h, n = 96, 64, 40
    frames = video_frames(w, h, n, b + gop)
    data = b"".join(f.tobytes() + bytes(w * h // 2) for f in frames)
    quant = QuantMatrix(quant_for(b).astype(np.uint32))
    for huff in (True, False):
        got = imageencoder_tpu_torch.encode_video(
            data, w, h, quant_from_numpy(quant.matrix), use_rle, gop, 8,
            use_huffman=huff, norm=norm, ref_mode=ref_mode, block_size=b,
            device=dev)
        assert got == bytes(host_video.encode_video(
            data, w, h, quant, use_rle, gop, 8, use_huffman=huff, norm=norm,
            backend="numpy", ref_mode=ref_mode, block_size=b))


@pytest.mark.parametrize("ref_mode", ["raw", "recon"])
def test_video_720p25_equals_host_engine_and_decodes(dev, ref_mode):
    """bench.py's video size: 1280x720, 25 frames, gop 4, merange 16, RLE
    and Huffman on."""
    w, h, n = 1280, 720, 25
    frames = video_frames(w, h, n, 0)
    data = b"".join(f.tobytes() + bytes(w * h // 2) for f in frames)
    quant = QuantMatrix(np.array(JPEG4, np.uint32))
    got = imageencoder_tpu_torch.encode_video(
        data, w, h, quant_from_numpy(quant.matrix), True, 4, 16,
        use_huffman=True, ref_mode=ref_mode, device=dev)
    want = host_video.encode_video(data, w, h, quant, True, 4, 16,
                                   use_huffman=True, backend="numpy",
                                   ref_mode=ref_mode)
    assert got == bytes(want) and got[0] & 0x80
    dec, params, size = host_video.decode_video(got, backend="fast")
    assert (params.frame_count, params.gop, size) == (n, 4, (w, h))
    y = np.frombuffer(dec, np.uint8).reshape(n, -1)[:, :w * h]
    mse = ((y.astype(np.float64) - frames.reshape(n, -1)) ** 2).mean()
    assert 10 * np.log10(255 ** 2 / mse) > 28
