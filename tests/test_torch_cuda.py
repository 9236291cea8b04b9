"""The port's CUDA kernels against their plain versions, its full-size
image and video streams against the JAX package's host engine, and its
image and video decode on the card against the host engine's pixels.

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
from imageencoder_tpu_torch.models.image import \
    stream_header as image_stream_header
from imageencoder_tpu_torch.ops import (cuda_decode, cuda_encode,
                                        cuda_kernels, cuda_motion, cuda_pack,
                                        device_pack, dict_table, huffman,
                                        pipeline)
from imageencoder_tpu_torch.utils.exceptions import StreamFormatError

from test_torch_decode import (STREAMS, d1_args,  # tests/ is on the path
                               dict_stream, one_bit_bytes, record_stream)
from test_torch_huffman import (KINDS, histogram, random_histogram)
from test_torch_image import CASES

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


def dirtied(dev, n_words: int) -> None:
    """Fill a buffer of n_words with ones and free it, so that the next
    torch.empty of that size most likely gets the same memory back: a
    pack that depended on its output being zero would then show."""
    torch.full((n_words,), -1, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()


def held_pack_locals(dev, *args, **kwargs):
    """K2 against its plain version over the stream's words (K2 leaves
    the rest of its buffer as allocated); returns the total."""
    dirtied(dev, args[3])
    before = cuda_pack.pack_locals.launches
    got = cuda_pack.pack_locals(*args, **kwargs)
    assert cuda_pack.pack_locals.launches == before + 1
    want = cuda_pack.pack_locals_plain(*args, **kwargs)
    assert int(got[1]) == int(want[1])
    assert torch.equal(cuda_pack.stream_words(*got),
                       cuda_pack.stream_words(*want))
    return int(got[1])


@pytest.mark.parametrize("start", [0, 37, 2047])
def test_pack_locals_kernel_equals_plain(dev, start):
    img = torch.from_numpy(image(128, 64, 5)).to(dev)
    local, lens, _ = cuda_encode.encode_locals(img, quant_for(4))
    nw = local.shape[0] * 9 + 64
    prefix = torch.full((2,), -1, dtype=torch.int32, device=dev)
    prefix = prefix if start >= 64 else None
    assert held_pack_locals(dev, local, lens, start, nw, prefix) > start


def random_locals(dev, n: int, lw: int, seed: int, zero_share: float = 0.2):
    """Register files of random bits, zero past each record's length, as
    K1 leaves them; a share of the records empty."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 32 * lw + 1, n)
    lens[rng.random(n) < zero_share] = 0
    bits = rng.integers(0, 2, (n, 32 * lw), dtype=np.uint8)
    bits[np.arange(32 * lw)[None, :] >= lens[:, None]] = 0
    local = np.packbits(bits, axis=1).view(">u4").astype(np.uint32)
    return (torch.from_numpy(local.view(np.int32)).to(dev),
            torch.from_numpy(lens.astype(np.int32)).to(dev))


@pytest.mark.parametrize("n,lw,start,zero_share", [
    (1, 6, 0, 0.0),            # one record
    (1, 7, 45, 1.0),           # one empty record: the stream is its prefix
    (5000, 6, 37, 0.2),        # empty records among the others
    (5000, 7, 64, 0.97),       # runs of empty records longer than a warp
    (3000, 12, 5, 0.1),        # 2 records a thread
    (700, 30, 2047, 0.1),      # 1 record a thread
    (0, 6, 70, 0.0),           # no record at all
])
def test_pack_locals_kernel_on_any_records(dev, n, lw, start, zero_share):
    local, lens = random_locals(dev, n, lw, n + lw, zero_share)
    prefix = torch.full((start // 32 + 1,), -1, dtype=torch.int32,
                        device=dev)
    prefix[-1] = -(1 << (32 - start % 32)) if start % 32 else 0
    nw = n * lw + start // 32 + 2
    total = held_pack_locals(dev, local, lens, start, nw, prefix)
    assert total == start + int(lens.sum())


@pytest.mark.parametrize("start", [0, 19, 64])
def test_pack_locals_stream_ends_on_a_word_boundary(dev, start):
    """The last record is sized so that the stream ends at a multiple of
    32 bits, and the words past it stay as allocated."""
    local, lens = random_locals(dev, 2100, 7, start, 0.1)
    short = (start + int(lens[:-1].sum())) % 32
    lens[-1] = 32 * 3 - short
    local[-1] = -1
    local[-1, 3:] = 0
    local[-1, 2] = -(1 << short) if short else -1
    total = held_pack_locals(dev, local, lens, start, 2100 * 7 + 3)
    assert total % 32 == 0


def test_pack_locals_refuses_records_past_lw(dev):
    local, lens = random_locals(dev, 3000, 6, 3)
    lens[1500] = 32 * 6 + 1
    got = cuda_pack.pack_locals(local, lens, 0, 3000 * 6 + 1)
    want = cuda_pack.pack_locals_plain(local, lens, 0, 3000 * 6 + 1)
    assert int(got[1]) == int(want[1]) == -1
    with pytest.raises(ValueError, match="register file"):
        device_pack.host_total(got[1])


@pytest.mark.parametrize("h,w,n,gop,nb,lw", [
    (720, 1280, 3, 2, 6, 7),   # an I-frame's 3600 empty records in a row
    (64, 96, 9, 4, 6, 7), (48, 64, 5, 1, 6, 6), (32, 32, 7, 3, 16, 27),
    (64, 64, 6, 8, 2, 7)])
def test_pack_locals_kernel_with_vectors_equals_plain(dev, h, w, n, gop, nb,
                                                      lw):
    """The video's two record sources in stream order: the kernel reads
    the vectors where they lie, the plain version merges copies."""
    n_micro = (h // 4) * (w // 4)
    local, lens = random_locals(dev, n * n_micro, lw, h + n, 0.05)
    n_p = sum(1 for f in range(n) if f % gop)
    n_macro = (h // 16) * (w // 16)
    rng = np.random.default_rng(gop)
    mvecs = torch.from_numpy(rng.integers(-2 ** (nb - 1), 2 ** (nb - 1),
                                          (n_p, n_macro, 2))
                             .astype(np.int32)).to(dev)
    hdr = torch.full((3,), -1, dtype=torch.int32, device=dev)
    nw = (n * n_micro) * lw + n * n_macro + 8
    total = held_pack_locals(dev, local, lens, 96, nw, hdr, mvecs=mvecs,
                             n_frames=n, gop=gop, mvec_nbits=nb)
    assert total == 96 + int(lens.sum()) + n_p * n_macro * 2 * nb


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
    code_l = rng.integers(0, 16, 256)
    code_w = rng.integers(0, 2 ** 15, 256)
    prefix = np.zeros(256, np.int64)  # the dict words: ones up to start
    prefix[:start // 32] = -1
    prefix[start // 32] = -(1 << (32 - start % 32)) if start % 32 else 0
    table = dict_table.make_table(code_w, code_l, prefix, dev,
                                  dict_bits=start, nbytes=nbytes)
    nw = 4 * n_words * 15 // 32 + 300
    before = cuda_pack.pack_payload.launches
    got = cuda_pack.pack_payload(words, table, nw)
    want = cuda_pack.pack_payload_plain(words, table, nw)
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
                                        device_pack.local_words(b * b + 2))
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
    # The search with the prediction as its epilogue: both fused kernels.
    before = (cuda_motion.search_predict.launches,
              cuda_motion.search_residual.launches)
    got_mv, got_pred = cuda_motion.search_predict(cur, ref, merange)
    assert torch.equal(got_mv, mv)
    assert torch.equal(got_pred, cuda_motion.predict_plain(ref, mv))
    for gop in (1, 2, 3, 5):
        got = cuda_motion.search_residual(frames, gop, merange)
        want = cuda_motion.search_residual_plain(frames, gop, merange)
        assert got[0].shape == want[0].shape and got[1].dtype == torch.int16
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (cuda_motion.search_predict.launches,
            cuda_motion.search_residual.launches) == (before[0] + 1,
                                                      before[1] + 4)


@pytest.mark.parametrize("merange", [16, 128])
def test_fused_search_at_720p_with_clamping_vectors(dev, merange):
    """The fused kernels at 1280x720, with the window in shared memory
    (merange 16) and past its 48 KB, read from global memory (merange 128:
    416 x 270 bytes).  The content wraps around the frame as it moves, so
    blocks at the borders find their match outside; played forwards and
    backwards, as it is and mirrored, vectors clamp at all four edges."""
    from imageencoder_tpu_torch.ops.motion import MACRO, macro_origins

    h, w = 720, 1280
    frames = torch.from_numpy(video_frames(w, h, 2, merange)).to(dev)
    bx, by = macro_origins(h, w, dev)
    edges = torch.zeros(4, dtype=torch.bool, device=dev)
    for video in (frames, frames.flip(0), frames.flip(2),
                  frames.flip(0).flip(2)):
        video = video.contiguous()
        cur, ref = video[1:2], video[0:1]
        mv, pred = cuda_motion.search_predict(cur, ref, merange)
        want_mv, want_pred = cuda_motion.search_predict_plain(cur, ref,
                                                              merange)
        assert torch.equal(mv, want_mv) and torch.equal(pred, want_pred)
        px, py = bx + mv[0, :, 0], by + mv[0, :, 1]
        edges |= torch.stack([(px < 0).any(), (px > w - MACRO).any(),
                              (py < 0).any(), (py > h - MACRO).any()])
        got = cuda_motion.search_residual(video, 2, merange)
        assert torch.equal(got[0], want_mv)
        assert torch.equal(got[1][:h], video[0].to(torch.int16))
        assert torch.equal(got[1][h:], cur[0].to(torch.int16) - want_pred[0])
    assert edges.all(), edges


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


@pytest.mark.parametrize("b,norm,use_rle", [
    (4, "reference", True), (4, "reference", False), (8, "ortho", True)])
def test_gop_step_kernels_equal_plain_on_strided_views(dev, b, norm,
                                                       use_rle):
    """The recon loop's kernels over frame k of every GOP at once, on the
    views it hands them (frames[k::gop], coeffs[k::gop], lens[k::gop],
    mvecs[k - 1::gop - 1]): K5 over the I-frames, then each step's
    search_predict and recon step, one launch each, bit-equal to the plain
    versions with the coefficients, reconstructions and record lengths,
    and to one-frame calls; then K4 pack_coeffs from those lengths, with
    and without its histogram, equal to its plain version and to the
    pack that takes the lengths from the coefficients."""
    gop, n, h, w = 4, 11, 64, 96  # a short last GOP: frames 8, 9, 10
    frames = torch.from_numpy(video_frames(w, h, n, b + 11)).to(dev)
    q = quant_for(b)
    n_micro = (h // b) * (w // b)
    n_p = n - len(range(0, n, gop))
    coeffs = torch.zeros((n, h, w), dtype=torch.int32, device=dev)
    lens = torch.zeros((n, n_micro), dtype=torch.int32, device=dev)
    mvecs = torch.zeros((n_p, (h // 16) * (w // 16), 2), dtype=torch.int32,
                        device=dev)
    before = cuda_encode.quantize_image.launches
    got = cuda_encode.quantize_image(frames[0::gop], q, b, norm,
                                     out=coeffs[0::gop], lens=lens[0::gop],
                                     use_rle=use_rle)
    assert cuda_encode.quantize_image.launches == before + 1
    want = cuda_encode.quantize_image_plain(frames[0::gop], q, b, norm,
                                            lens=lens[0::gop].clone(),
                                            use_rle=use_rle)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert torch.equal(coeffs[4], cuda_encode.quantize_image(frames[4], q, b,
                                                             norm))
    carry = frames[0::gop][:3]
    for k in range(1, gop):
        cur = frames[k::gop]
        m = cur.shape[0]
        before = (cuda_motion.search_predict.launches,
                  cuda_encode.recon_step.launches)
        mv, pred = cuda_motion.search_predict(cur, carry[:m], 16,
                                              mvec=mvecs[k - 1::gop - 1])
        want_mv, want_pred = cuda_motion.search_predict_plain(cur, carry[:m],
                                                              16)
        assert torch.equal(mv, want_mv) and torch.equal(pred, want_pred)
        step = cuda_encode.recon_step(cur, pred, q, b, norm,
                                      out=coeffs[k::gop], lens=lens[k::gop],
                                      use_rle=use_rle)
        want = cuda_encode.recon_step_plain(cur, pred, q, b, norm,
                                            lens=torch.empty_like(step[2]),
                                            use_rle=use_rle)
        assert all(torch.equal(x, y) for x, y in zip(step, want))
        assert (cuda_motion.search_predict.launches,
                cuda_encode.recon_step.launches) == (before[0] + 1,
                                                     before[1] + 1)
        one = cuda_encode.recon_step(cur[m - 1], pred[m - 1], q, b, norm)
        assert torch.equal(one[0], coeffs[k + gop * (m - 1)])
        assert torch.equal(one[1], step[1][m - 1])
        carry = step[1]
    lw = cuda_encode.video_lw(b, norm)
    assert torch.equal(lens, cuda_encode.record_lengths(coeffs, b, use_rle))
    nw = device_pack.packed_words_bound(n * (mvecs.shape[1] + n_micro),
                                        device_pack.local_words(b * b + 2))
    hdr = torch.full((3,), -1, dtype=torch.int32, device=dev)
    args = (coeffs, mvecs, gop, 6, b, use_rle, lw, 77, nw, hdr)
    before = cuda_pack.pack_coeffs.launches
    got = cuda_pack.pack_coeffs(*args, lens=lens)
    assert cuda_pack.pack_coeffs.launches == before + 1
    want = cuda_pack.pack_coeffs_plain(*args, lens=lens)
    assert int(got[1]) == int(want[1]) == int(cuda_pack.pack_coeffs(*args)[1])
    assert torch.equal(cuda_pack.stream_words(*got),
                       cuda_pack.stream_words(*want))
    held_hist_pack(cuda_pack.pack_coeffs_hist,
                   cuda_pack.pack_coeffs_hist_plain, *args, lens=lens)


def test_recon_encode_launches_seven_kernels_before_the_pack(dev):
    """One 720p25 recon encode at gop 4: K5 once (the 7 I-frames), then 3
    steps of search_predict and the recon step (frame k of every GOP), then
    K4 pack_coeffs (+ its histogram), the dict and K4 pack_payload once
    each; at gop 1 K5 alone, at gop >= F one step a P-frame."""
    from imageencoder_tpu_torch.models.video import encode_frames

    w, h, n = 1280, 720, 25
    frames = torch.from_numpy(video_frames(w, h, n, 0)).to(dev)
    quant = quant_from_numpy(np.array(JPEG4))
    recon = (cuda_encode.quantize_image, cuda_encode.recon_step,
             cuda_motion.search_predict, cuda_pack.pack_coeffs,
             cuda_pack.pack_coeffs_hist, huffman.build_dict,
             cuda_pack.pack_payload)
    for gop, huff, want in ((4, True, [1, 3, 3, 0, 1, 1, 1]),
                            (4, False, [1, 3, 3, 1, 0, 0, 0]),
                            (1, False, [1, 0, 0, 1, 0, 0, 0]),
                            (30, False, [1, 24, 24, 1, 0, 0, 0])):
        before = launch_counts(recon + ENCODE)
        encode_frames(
            frames, w, h, quant, True, gop, 16, use_huffman=huff,
            ref_mode="recon", device=dev)
        torch.cuda.synchronize()
        got = [a - b for a, b in zip(launch_counts(recon + ENCODE), before)]
        assert got == want + [0, 0, 0] + [int(huff)] * 2, (gop, huff, got)


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
        for motioncomp in (True, False):  # and decoded on the card
            video_held(dev, got, motioncomp, norm, b)


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
    # Decoded on the card: the exact engine's frames, in D1 and D2 once,
    # the vector read once, D3 once a GOP step and K7 once a P step.
    assert video_held(dev, got) == dec
    before = launch_counts(VDECODE + ENCODE)
    frames_d = imageencoder_tpu_torch.decode_frames(got, device=dev)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(launch_counts(VDECODE + ENCODE),
                                  before)] == [1, 1, 1, 4, 3] + [0] * 5
    assert frames_d.device == dev
    np.testing.assert_array_equal(frames_d.cpu().numpy().reshape(n, -1), y)


def held_dict(hist, total):
    """The dict kernel against its plain version: the whole table, bit for
    bit; returns its fields."""
    before = huffman.build_dict.launches
    got = huffman.build_dict(hist, total)
    assert huffman.build_dict.launches == before + 1
    want = huffman.build_dict_plain(hist, total)
    assert torch.equal(got, want), (dict_table.fields(got),
                                    dict_table.fields(want))
    return dict_table.fields(got)


@pytest.mark.parametrize("kind,seed", [
    (k, s) for k, s in KINDS if k not in ("geometric", "two")] + [
    ("two", 7)])
def test_dict_kernel_equals_plain(dev, kind, seed):
    """Ties, fibonacci counts past the 15-bit limit, geometric counts up to
    2^30, uniform, two, one and no symbol, all 256 equal; each with a
    total that ends inside a byte, and a refused stream's total."""
    freqs = histogram(kind, seed)
    if kind == "two":
        freqs[200] = 10 ** 8  # an int32 histogram
    hist = torch.from_numpy(freqs.astype(np.int32)).to(dev)
    inner_bytes = int(freqs.sum())
    for total in (8 * inner_bytes, 8 * inner_bytes - 5, -1):
        if total < -1:
            continue
        got = held_dict(hist, torch.tensor(total, device=dev))
        assert got["inner_bits"] == total


def test_dict_kernel_on_random_histograms(dev):
    """300 seeded histograms, tie-heavy and skewed, sparse and full: the
    two-queue merge builds the heap's tree on each."""
    for seed in range(300):
        freqs = random_histogram(seed)
        hist = torch.from_numpy(freqs.astype(np.int32)).to(dev)
        held_dict(hist, torch.tensor(8 * int(freqs.sum()), device=dev))


def test_dict_kernel_on_every_group_size(dev):
    """Every byte value present, counts that give one long group (more than
    127 codes of one length: two group headers) and single-code groups."""
    for counts in (np.full(256, 1000), np.r_[np.full(200, 10), 2 ** np.arange(
            56) % 100003 + 1], np.arange(1, 257) ** 3):
        hist = torch.from_numpy(np.asarray(counts).astype(np.int32)).to(dev)
        held_dict(hist, torch.tensor(8 * int(np.sum(counts)) + 9,
                                     device=dev))


@pytest.mark.parametrize("path", ["image", "raw", "recon"])
def test_dict_kernel_on_full_size_histograms(dev, path):
    """The histograms of the full-size image and the 720p25 raw and recon
    streams, as the packers count them."""
    quant = np.array(JPEG4, np.float64)
    hdr = torch.zeros(64, dtype=torch.int32, device=dev)
    if path == "image":
        img = torch.from_numpy(image(912, 4096, 5008)).to(dev)
        got = pipeline.make_encode_packed_hist()(img, quant, 70, hdr)
    else:
        from imageencoder_tpu_torch.ops import video_pipeline

        frames = torch.from_numpy(video_frames(1280, 720, 25, 0)).to(dev)
        make = (video_pipeline.make_encode_video_packed if path == "raw"
                else video_pipeline.make_encode_video_packed_recon)
        got = make(4, 16, 6, with_hist=True)(frames, quant, 90, hdr)
    words, total, hist = got
    assert torch.equal(hist, cuda_kernels.byte_histogram_plain(words, total))
    fields = held_dict(hist, total)
    assert fields["fallback"] == 0 and fields["nbytes"] > 10 ** 6


def held_hist_pack(wrapper, plain, *args, **kwargs):
    """A packer with its histogram against its plain version: total, the
    stream's words and the histogram; returns the total."""
    before = wrapper.launches
    got = wrapper(*args, **kwargs)
    assert wrapper.launches == before + 1
    want = plain(*args, **kwargs)
    assert int(got[1]) == int(want[1])
    assert torch.equal(cuda_pack.stream_words(*got[:2]),
                       cuda_pack.stream_words(*want[:2]))
    assert torch.equal(got[2], want[2])
    return int(got[1])


@pytest.mark.parametrize("n,lw,start,zero_share", [
    (1, 6, 0, 0.0), (1, 7, 45, 1.0), (5000, 6, 37, 0.2), (5000, 7, 64, 0.97),
    (3000, 12, 5, 0.1), (700, 30, 2047, 0.1), (0, 6, 70, 0.0)])
def test_pack_locals_hist_kernel_equals_plain(dev, n, lw, start, zero_share):
    """K2 with its histogram on the records of the K2 tests: one record,
    an empty one, runs of empty records longer than a warp, 1 and 2
    records a thread, no record; the prefix words counted too."""
    local, lens = random_locals(dev, n, lw, n + lw, zero_share)
    prefix = torch.full((start // 32 + 1,), -1, dtype=torch.int32,
                        device=dev)
    prefix[-1] = -(1 << (32 - start % 32)) if start % 32 else 0
    dirtied(dev, n * lw + start // 32 + 2)
    total = held_hist_pack(cuda_pack.pack_locals_hist,
                           cuda_pack.pack_locals_hist_plain, local, lens,
                           start, n * lw + start // 32 + 2, prefix)
    assert total == start + int(lens.sum())


@pytest.mark.parametrize("start", [0, 19, 64])
def test_pack_locals_hist_stream_ends_on_a_word_boundary(dev, start):
    local, lens = random_locals(dev, 2100, 7, start, 0.1)
    short = (start + int(lens[:-1].sum())) % 32
    lens[-1] = 32 * 3 - short
    local[-1] = -1
    local[-1, 3:] = 0
    local[-1, 2] = -(1 << short) if short else -1
    total = held_hist_pack(cuda_pack.pack_locals_hist,
                           cuda_pack.pack_locals_hist_plain, local, lens,
                           start, 2100 * 7 + 3)
    assert total % 32 == 0


@pytest.mark.parametrize("h,w,n,gop,nb,lw", [
    (720, 1280, 3, 2, 6, 7), (64, 96, 9, 4, 6, 7), (32, 32, 7, 3, 16, 27)])
def test_pack_locals_hist_kernel_with_vectors_equals_plain(dev, h, w, n, gop,
                                                           nb, lw):
    n_micro = (h // 4) * (w // 4)
    local, lens = random_locals(dev, n * n_micro, lw, h + n, 0.05)
    n_p = sum(1 for f in range(n) if f % gop)
    n_macro = (h // 16) * (w // 16)
    rng = np.random.default_rng(gop)
    mvecs = torch.from_numpy(rng.integers(-2 ** (nb - 1), 2 ** (nb - 1),
                                          (n_p, n_macro, 2))
                             .astype(np.int32)).to(dev)
    hdr = torch.full((3,), -1, dtype=torch.int32, device=dev)
    nw = (n * n_micro) * lw + n * n_macro + 8
    held_hist_pack(cuda_pack.pack_locals_hist,
                   cuda_pack.pack_locals_hist_plain, local, lens, 83, nw, hdr,
                   mvecs=mvecs, n_frames=n, gop=gop, mvec_nbits=nb)


@pytest.mark.parametrize("b,use_rle,gop,h,w,n,start", [
    (4, True, 4, 720, 1280, 9, 91), (8, True, 3, 64, 96, 7, 64),
    (4, False, 1, 32, 48, 3, 7), (4, True, 2, 16, 16, 1, 96)])
def test_pack_coeffs_hist_kernel_equals_plain(dev, b, use_rle, gop, h, w, n,
                                              start):
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
                                        device_pack.local_words(b * b + 2))
    hdr = torch.full((3,), -1, dtype=torch.int32, device=dev)
    held_hist_pack(cuda_pack.pack_coeffs_hist,
                   cuda_pack.pack_coeffs_hist_plain, c, m, gop, 6, b, use_rle,
                   lw, start, nw, hdr)


def test_pack_coeffs_hist_on_a_stream_that_ends_on_a_word(dev):
    """One all-zero 4x4 block record is 7 bits with RLE: a start of
    32 * k - 7 ends the stream on a word boundary."""
    c = torch.zeros((1, 4, 4), dtype=torch.int32, device=dev)
    m = torch.zeros((0, 0, 2), dtype=torch.int32, device=dev)
    lw = cuda_encode.video_lw(4, "reference")
    plain = cuda_pack.pack_coeffs_plain(c, m, 1, 6, 4, True, lw, 0, 8)
    bits = int(plain[1])
    for start in (64 - bits, 65 - bits, 0):
        total = held_hist_pack(cuda_pack.pack_coeffs_hist,
                               cuda_pack.pack_coeffs_hist_plain, c, m, 1, 6,
                               4, True, lw, start, 8)
        assert total == start + bits


def test_no_card_path_builds_the_dict_on_the_host(dev, monkeypatch):
    """With the host dict made to raise, every Huffman path on the card
    still runs and equals the host engine: image, fallback image, raw and
    recon video, and a 40-frame video (K3 on the spliced chunks)."""
    quant = QuantMatrix(np.array(JPEG4, np.uint32))
    q_ones = QuantMatrix(np.ones((4, 4), np.uint32))
    noise = np.random.default_rng(9).integers(0, 256, (128, 256), np.uint8)
    img = image(96, 128, 3)
    w, h = 64, 48
    short = video_frames(w, h, 6, 2)
    long = video_frames(w, h, 40, 3)
    want = [imageencoder_tpu.encode_image(img, quant, use_huffman=True,
                                          backend="numpy"),
            imageencoder_tpu.encode_image(noise, q_ones, use_huffman=True,
                                          backend="numpy")]
    videos = [(short, "raw"), (short, "recon"), (long, "raw")]
    data = [b"".join(f.tobytes() + bytes(w * h // 2) for f in fr)
            for fr, _ in videos]
    want += [bytes(host_video.encode_video(
        d, w, h, quant, True, 3, 8, use_huffman=True, backend="numpy",
        ref_mode=mode)) for d, (_, mode) in zip(data, videos)]

    def host_dict(freqs):
        raise AssertionError("the host dict ran on a card path")

    monkeypatch.setattr(huffman, "_dict_and_codes", host_dict)
    got = [imageencoder_tpu_torch.encode_image(
        im, quant_from_numpy(q.matrix), use_huffman=True, device=dev)
        for im, q in ((img, quant), (noise, q_ones))]
    got += [imageencoder_tpu_torch.encode_video(
        d, w, h, quant_from_numpy(quant.matrix), True, 3, 8,
        use_huffman=True, ref_mode=mode, device=dev)
        for d, (_, mode) in zip(data, videos)]
    assert got == want
    assert not got[1][0] & 0x80  # the fallback image took the fallback


@pytest.mark.parametrize("use_huffman", [True, False])
def test_sizes_no_multiple_of_16_equal_host_engine(dev, use_huffman):
    """encode_image at 20x24 and the all-I video at 36x20, whole paths on
    the card."""
    quant = QuantMatrix(np.array(JPEG4, np.uint32))
    img = image(20, 24, 1)
    assert imageencoder_tpu_torch.encode_image(
        img, quant_from_numpy(quant.matrix), use_huffman=use_huffman,
        device=dev) == imageencoder_tpu.encode_image(
        img, quant, use_huffman=use_huffman, backend="numpy")
    w, h, n = 36, 20, 4
    frames = np.random.default_rng(4).integers(0, 256, (n, h, w), np.uint8)
    data = b"".join(f.tobytes() + bytes(w * h // 2) for f in frames)
    for mode in ("raw", "recon"):
        assert imageencoder_tpu_torch.encode_video(
            data, w, h, quant_from_numpy(quant.matrix), True, 1, 8,
            use_huffman=use_huffman, ref_mode=mode,
            device=dev) == bytes(host_video.encode_video(
                data, w, h, quant, True, 1, 8, use_huffman=use_huffman,
                backend="numpy", ref_mode=mode))


# ---- the image decode: D1-D3 ----

DECODE = (cuda_decode.huffman_decode, cuda_decode.walk_offsets,
          cuda_decode.decode_blocks)
ENCODE = (cuda_encode.encode_locals, cuda_pack.pack_locals,
          cuda_pack.pack_locals_hist, huffman.build_dict,
          cuda_pack.pack_payload)


def launch_counts(wrappers):
    return [fn.launches for fn in wrappers]


@pytest.mark.parametrize("h,w,kind,qkind,use_huffman,branch", [
    (912, 4096, "field", "jpeg", True, "huffman"),  # ex4's geometry
    (912, 4096, "field", "jpeg", False, "raw"),
    (2160, 3840, "field", "jpeg", True, "huffman"),  # a 4K UHD frame
    (2160, 3840, "field", "jpeg", False, "raw"),
    (128, 256, "noise", "ones", True, "fallback"),
])
def test_full_size_round_trip_on_the_card_equals_host_engine(
        dev, h, w, kind, qkind, use_huffman, branch):
    """Encode on the card, decode on the card: the pixels equal
    decode_image(backend="numpy"), and the decode launches D1 (with
    Huffman), D2 and D3 once each and no encode kernel."""
    if kind == "noise":
        img = np.random.default_rng(9).integers(0, 256, (h, w), np.uint8)
    else:
        img = image(h, w, h + w)
    quant = QuantMatrix(quant_for(4, qkind).astype(np.uint32))
    data = imageencoder_tpu_torch.encode_image(
        img, quant_from_numpy(quant.matrix), use_huffman=use_huffman,
        device=dev)
    flag = bool(data[0] & 0x80)
    assert branch == ("raw" if not use_huffman else
                      "huffman" if flag else "fallback")
    before = launch_counts(DECODE + ENCODE)
    got = imageencoder_tpu_torch.decode_image(data, device=dev)
    torch.cuda.synchronize()
    assert got.device == dev and got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got.cpu().numpy(), imageencoder_tpu.decode_image(data,
                                                          backend="numpy"))
    after = launch_counts(DECODE + ENCODE)
    assert [a - b for a, b in zip(after, before)] == (
        [int(flag), 1, 1] + [0] * len(ENCODE))


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("h,w,use_rle,use_huffman,b,norm", CASES)
def test_small_decode_on_the_card_equals_host_engine(
        dev, h, w, use_rle, use_huffman, b, norm, writer):
    """The CPU tests' cases, b = 8 ortho among them, decoded on the card."""
    img = image(h, w, h * w)
    i, j = np.indices((b, b))
    quant = QuantMatrix(np.array(JPEG4, np.uint32) if b == 4
                        else (1 + 2 * (i + j)).astype(np.uint32))
    if writer == "port":
        data = imageencoder_tpu_torch.encode_image(
            img, quant_from_numpy(quant.matrix), use_rle=use_rle,
            use_huffman=use_huffman, norm=norm, block_size=b, device=dev)
    else:
        data = imageencoder_tpu.encode_image(
            img, quant, use_rle=use_rle, use_huffman=use_huffman, norm=norm,
            backend="numpy", block_size=b)
    got = imageencoder_tpu_torch.decode_image(data, norm=norm, block_size=b,
                                              device=dev)
    np.testing.assert_array_equal(
        got.cpu().numpy(), imageencoder_tpu.decode_image(
            data, norm=norm, backend="numpy", block_size=b))


def test_truncated_stream_decodes_on_the_card_as_on_the_host(dev):
    """Records past the stream's end read zeros on the card too."""
    data = imageencoder_tpu.encode_image(
        image(96, 128, 5), QuantMatrix(np.array(JPEG4, np.uint32)),
        use_huffman=False, backend="numpy")
    for cut in (len(data) // 2, 300, 40):
        got = imageencoder_tpu_torch.decode_image(data[:cut], device=dev)
        np.testing.assert_array_equal(
            got.cpu().numpy(),
            imageencoder_tpu.decode_image(data[:cut], backend="numpy"))


def on_dev(args, dev):
    return tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                 for a in args)


@pytest.mark.parametrize("chunk_bits", [32, 64, 1024])
@pytest.mark.parametrize("name", list(STREAMS))
def test_huffman_decode_kernel_equals_plain(dev, name, chunk_bits):
    """D1 on streams whose chunks start out of sync (3-bit codes at 32-bit
    chunks never meet the codeword grid), incomplete trees and padding
    that decodes to symbols; the stream's buffer holds 0xFF past its byte
    count, which the kernel must not read.  A break is left after the
    rounds (and the table settles it) only where every round changed a
    chunk."""
    args = on_dev(d1_args(STREAMS[name], tail=64), dev)
    stats = torch.zeros(len(cuda_decode.CHAIN_STATS), dtype=torch.int64,
                        device=dev)
    before = cuda_decode.huffman_decode.launches
    out, count = cuda_decode.huffman_decode(*args, chunk_bits=chunk_bits,
                                            stats=stats)
    want, want_count = cuda_decode.huffman_decode_plain(*args)
    assert cuda_decode.huffman_decode.launches == before + 1
    n = int(want_count)
    assert int(count) == n
    assert torch.equal(out[:n], want[:n])
    st = dict(zip(cuda_decode.CHAIN_STATS, stats.tolist()))
    assert st["chunks"] == -(-(8 * len(STREAMS[name]) - args[2])
                             // chunk_bits)
    assert st["rounds_changed"] <= cuda_decode.CHAIN_ROUNDS
    assert (not st["breaks_left"]
            or st["rounds_changed"] == cuda_decode.CHAIN_ROUNDS)
    if name == "equal lengths" and chunk_bits == 32:
        # walked whole from the true entry, the table ran, still equal
        assert st["walked_whole"] > 0 and st["breaks_left"] == 1


@pytest.mark.parametrize("kind,use_rle,chunk_bits", [
    ("zeros", True, 32), ("long", True, 32), ("long", False, 32),
    ("long", False, 64), ("random", True, 32), ("random", False, 64),
    ("random", True, 2048), ("corrupt", True, 32), ("corrupt", True, 64),
])
def test_walk_offsets_kernel_equals_plain(dev, kind, use_rle, chunk_bits):
    """D2 on records 4 bits apart, 244- and 259-bit records that keep
    walkers out of phase, random records and records with counts past
    B*B, with many small chunks; 0xFF fills the buffer past the byte
    count, and records past it read zeros."""
    lead = 5
    data, n = record_stream(kind, 300, 11, use_rle, lead=lead)
    payload = torch.tensor(list(data) + [0xFF] * 256, dtype=torch.uint8,
                           device=dev)
    nbytes = torch.tensor([len(data)], dtype=torch.int64, device=dev)
    for n_blocks in (n, n + 40, n // 2):
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        got = cuda_decode.walk_offsets(payload, nbytes, lead, n_blocks,
                                       use_rle, 4, chunk_bits, stats)
        want = cuda_decode.walk_offsets_plain(payload, nbytes, lead,
                                              n_blocks, use_rle, 4)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        if kind == "long" and not use_rle and n_blocks == n:
            assert stats[1] > 0  # walked whole from the true entry


@pytest.mark.parametrize("b,norm,use_rle", [
    (4, "reference", True), (4, "ortho", False), (8, "ortho", True),
    (8, "reference", False)])
def test_decode_blocks_kernel_equals_plain(dev, b, norm, use_rle):
    """D3 on random records of every width, counts past B*B, and fields
    past the byte count (the buffer holds 0xFF there): coefficients up to
    +-16383, so the clamp works both ways."""
    k, lead = b * b, 9
    h, w = 4 * b, 16 * b
    n = (h // b) * (w // b)
    data, _ = record_stream("corrupt", n, 13, use_rle, k=k, lead=lead)
    payload = torch.tensor(list(data) + [0xFF] * 512, dtype=torch.uint8,
                           device=dev)
    quant = torch.tensor(quant_for(b).ravel(), dtype=torch.float64,
                         device=dev)
    for cut in (len(data), 2 * len(data) // 3):
        nbytes = torch.tensor([cut], dtype=torch.int64, device=dev)
        offs, dbits, counts, _ = cuda_decode.walk_offsets_plain(
            payload, nbytes, lead, n, use_rle, b)
        got = cuda_decode.decode_blocks(payload, nbytes, offs, dbits, counts,
                                        quant, b, norm, h, w)
        want = cuda_decode.decode_blocks_plain(payload, nbytes, offs, dbits,
                                               counts, quant, b, norm, h, w)
        assert torch.equal(got, want)
        assert 0 < int((got == 0).sum()) and 0 < int((got == 255).sum())


def test_corrupt_dict_raises_before_any_launch(dev):
    before = launch_counts(DECODE)
    for entries in ([(1, 0, 1), (2, 1, 2)],  # "0" prefixes "01"
                    [(1, 1, 2), (2, 1, 2)],  # a duplicate code
                    [(1, 0, 0), (2, 1, 1)]):  # a zero-length code
        with pytest.raises(StreamFormatError):
            imageencoder_tpu_torch.decode_image(dict_stream(entries),
                                                device=dev)
    assert launch_counts(DECODE) == before


# ---- the video decode ----

VDECODE = (cuda_decode.huffman_decode, cuda_decode.walk_video,
           cuda_decode.read_vectors, cuda_decode.decode_blocks,
           cuda_motion.predict)


def video_held(dev, data: bytes, motioncomp: bool = True,
               norm: str = "reference", b: int = 4) -> bytes:
    """decode_video on the card against the host's exact engine
    (backend="numpy"): equal bytes, params and size."""
    got = imageencoder_tpu_torch.decode_video(data, motioncomp, norm, b,
                                              device=dev)
    want = host_video.decode_video(data, motioncomp, norm, backend="numpy",
                                   block_size=b)
    assert got[0] == want[0]
    assert (got[1].frame_count, got[1].gop, got[1].merange) == (
        want[1].frame_count, want[1].gop, want[1].merange)
    assert got[2] == want[2]
    return got[0]


def small_video(dev, gop: int, merange: int, use_rle: bool, huff: bool,
                n: int = 9, w: int = 64, h: int = 48) -> bytes:
    frames = video_frames(w, h, n, gop + merange)
    data = b"".join(f.tobytes() + bytes(w * h // 2) for f in frames)
    return imageencoder_tpu_torch.encode_video(
        data, w, h, quant_from_numpy(np.array(JPEG4, np.uint32)), use_rle,
        gop, merange, use_huffman=huff, device=dev)


def hand_video(w: int, h: int, n: int, gop: int, merange: int,
               body_bytes: int = 600, seed: int = 0,
               empty_records: bool = False) -> bytes:
    """A stream without Huffman: a w x h video's header, then seeded
    random bytes (records and vectors of any value); with empty_records
    each frame's records are 4 zero bits each (b = 0) and each P-frame's
    vectors random bits, so every vector lies in the stream."""
    from imageencoder_tpu_torch.models.headers import VideoParams
    from imageencoder_tpu_torch.models.video import mvec_bits, video_header
    from imageencoder_tpu_torch.ops.bitpack import concat_bit_segments

    writer = video_header(quant_from_numpy(np.full((4, 4), 3)), True, w, h,
                          VideoParams(n, gop, merange), False)
    rng = np.random.default_rng(seed)
    segments = [(writer.getvalue(), writer.position)]
    if not empty_records:
        body = rng.integers(0, 256, body_bytes).astype(np.uint8).tobytes()
        return concat_bit_segments([*segments, (body, 8 * body_bytes)])
    vbits = 2 * (w // 16) * (h // 16) * mvec_bits(merange)
    for f in range(n):
        if f % gop:
            segments.append((rng.integers(0, 256, -(-vbits // 8)).astype(
                np.uint8).tobytes(), vbits))
        records = 4 * (w // 4) * (h // 4)
        segments.append((bytes(-(-records // 8)), records))
    return concat_bit_segments(segments)


def payload_of(dev, data: bytes, tail: int = 256):
    """(the video's plan, its payload on the card with 0xFF past its byte
    count, the count)."""
    from imageencoder_tpu_torch.models.video import plan_video

    plan = plan_video(data)
    payload = (host_video.parse_video_stream(data)[0] if plan["huffman"]
               else data)
    buf = torch.tensor(list(bytes(payload)) + [0xFF] * tail,
                       dtype=torch.uint8, device=dev)
    return plan, buf, torch.tensor([len(payload)], dtype=torch.int64,
                                   device=dev)


@pytest.mark.parametrize("gop,merange,use_rle,huff,keep", [
    (4, 16, True, True, 1.0), (5, 1, True, False, 1.0),
    (1, 8, False, True, 1.0), (4, 1, False, False, 1.0),
    (3, 16, True, False, 0.6), (4, 8, True, True, 0.8)])
@pytest.mark.parametrize("chunk_bits", [32, 256, 2048])
def test_video_walk_kernel_equals_plain(dev, gop, merange, use_rle, huff,
                                        keep, chunk_bits):
    """D2 over a whole video: gop 1, 3, 4 and 5, merange 1 (2-bit vector
    fields) and 16, RLE on and off, streams cut short, and chunks small
    enough that nearly every chunk holds a frame boundary (64x48 frames
    of 192 records); 0xFF past the byte count.  Then the vector read at
    the start bits D2 wrote."""
    data = small_video(dev, gop, merange, use_rle, huff)
    plan, payload, nbytes = payload_of(dev, data)
    if keep < 1.0:
        nbytes = (nbytes * keep).to(torch.int64)
    n = plan["params"].frame_count
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    args = (payload, nbytes, plan["start"], n, plan["n_blocks"], gop,
            plan["vbits"], use_rle, 4)
    before = cuda_decode.walk_video.launches
    got = cuda_decode.walk_video(*args, chunk_bits, stats)
    assert cuda_decode.walk_video.launches == before + 1
    want = cuda_decode.walk_video_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if plan["vbits"]:
        mv = cuda_decode.read_vectors(payload, nbytes, got[4], gop,
                                      plan["n_macro"], plan["mb"])
        assert torch.equal(mv, cuda_decode.read_vectors_plain(
            payload, nbytes, got[4], gop, plan["n_macro"], plan["mb"]))


def chain_stats(dev) -> torch.Tensor:
    return torch.zeros(len(cuda_decode.CHAIN_STATS), dtype=torch.int64,
                       device=dev)


def named(stats: torch.Tensor) -> dict:
    return dict(zip(cuda_decode.CHAIN_STATS, stats.tolist()))


def test_walk_offsets_breaks_go_to_the_sweep(dev):
    """Records of 244 bits at chunks of 32 bits: each spans 8 chunks, so
    walkers stay out of phase for many chunks; D2 runs no round, and after
    each break the sweep walks a run of chunks again."""
    data, n = record_stream("long", 300, 11, True, lead=5)
    payload = torch.tensor(list(data) + [0xFF] * 256, dtype=torch.uint8,
                           device=dev)
    nbytes = torch.tensor([len(data)], dtype=torch.int64, device=dev)
    stats = chain_stats(dev)
    got = cuda_decode.walk_offsets(payload, nbytes, 5, n, True, 4, 32, stats)
    want = cuda_decode.walk_offsets_plain(payload, nbytes, 5, n, True, 4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    st = named(stats)
    assert st["breaks_left"] == 1 and st["rounds_changed"] == 0
    assert st["sweep_breaks"] > 0 and st["sweep_rewalked"] > 0
    assert st["longest_run"] > 1
    assert st["jumps"] == 0 and st["scan_turns"] > 0


@pytest.mark.parametrize("chunk_bits", [128, 2048])
def test_huffman_decode_emit_past_its_shared_stage(dev, chunk_bits):
    """Codes of about one bit: at chunks of 2048 bits a CTA's symbols
    overflow the emit's shared stage (each thread stores its own), at 128
    (16 Kbit a CTA) they fit."""
    data = huffman.huffman_encode(one_bit_bytes(), "cpu")
    args = on_dev(d1_args(data, tail=64), dev)
    out, count = cuda_decode.huffman_decode(*args, chunk_bits=chunk_bits)
    want, want_count = cuda_decode.huffman_decode_plain(*args)
    n = int(want_count)
    assert int(count) == n and torch.equal(out[:n], want[:n])


@pytest.mark.parametrize("rounds", [0, 2, 8])
@pytest.mark.parametrize("name", ["equal lengths", "port image",
                                  "skewed bytes"])
def test_huffman_decode_table_settles_what_the_rounds_leave(
        dev, monkeypatch, name, rounds):
    """D1 at chunks of 32 bits with 0 to 8 rounds: where they leave a
    break the table of entry offsets settles it (3-bit codes, whose
    chains never resynchronize, always); a break is left only where every
    round changed a chunk."""
    monkeypatch.setattr(cuda_decode, "CHAIN_ROUNDS", rounds)
    args = on_dev(d1_args(STREAMS[name], tail=64), dev)
    stats = chain_stats(dev)
    out, count = cuda_decode.huffman_decode(*args, chunk_bits=32,
                                            stats=stats)
    want, want_count = cuda_decode.huffman_decode_plain(*args)
    n = int(want_count)
    assert int(count) == n and torch.equal(out[:n], want[:n])
    st = named(stats)
    assert st["rounds_changed"] <= rounds
    assert not st["breaks_left"] or st["rounds_changed"] == rounds
    if name == "equal lengths":
        assert st["breaks_left"] == 1 and st["rounds_changed"] == rounds


@pytest.mark.parametrize("kind,use_rle,chunk_bits", [
    ("random", True, 32), ("random", False, 32), ("long", True, 64),
    ("long", False, 32), ("corrupt", True, 32), ("random", True, 2048)])
def test_walk_offsets_sweep_equal_plain(dev, kind, use_rle, chunk_bits):
    """D2 on an image, RLE on and off, with stats (the sweep counts) and
    without (it does not): equal to the plain walk; no round; the sweep
    runs, and fixes a break, exactly where the check left one."""
    data, n = record_stream(kind, 300, 11, use_rle, lead=5)
    payload = torch.tensor(list(data) + [0xFF] * 256, dtype=torch.uint8,
                           device=dev)
    nbytes = torch.tensor([len(data)], dtype=torch.int64, device=dev)
    want = cuda_decode.walk_offsets_plain(payload, nbytes, 5, n, use_rle, 4)
    stats = chain_stats(dev)
    for s in (stats, None):
        got = cuda_decode.walk_offsets(payload, nbytes, 5, n, use_rle, 4,
                                       chunk_bits, s)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    st = named(stats)
    assert st["rounds_changed"] == 0 and st["jumps"] == 0
    assert (st["sweep_breaks"] > 0) == (st["breaks_left"] == 1)
    assert (st["scan_turns"] > 0) == (st["breaks_left"] == 1)
    if chunk_bits == 32:
        assert st["breaks_left"] == 1


@pytest.mark.parametrize("gop", [1, 4, 5])
def test_walk_video_sweep_takes_the_jumps(dev, gop):
    """D2 over a video at gop 1 (no P-frame: the sweep only where the
    check left a break), 4 and 5 (the sweep takes each jump it reaches),
    chunks of 32 and 256 bits: equal to the plain walk, no round."""
    data = small_video(dev, gop, 8, True, True)
    plan, payload, nbytes = payload_of(dev, data)
    n = plan["params"].frame_count
    args = (payload, nbytes, plan["start"], n, plan["n_blocks"], gop,
            plan["vbits"], True, 4)
    want = cuda_decode.walk_video_plain(*args)
    n_p = n - len(range(0, n, gop))
    for chunk_bits in (32, 256):
        stats = chain_stats(dev)
        got = cuda_decode.walk_video(*args, chunk_bits, stats)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        st = named(stats)
        assert st["rounds_changed"] == 0
        if gop == 1:
            assert st["jumps"] == 0
            assert (st["sweep_breaks"] > 0) == (st["breaks_left"] == 1)
        else:
            assert 0 < st["jumps"] <= n_p


def test_chain_stats_layout(dev):
    """stats: the first n entries of CHAIN_STATS, however many are given;
    entries past them stay as they were; two entries are the chunks and
    those walked whole, as before the rounds."""
    args = on_dev(d1_args(STREAMS["equal lengths"], tail=64), dev)
    long = torch.full((len(cuda_decode.CHAIN_STATS) + 3,), -1,
                      dtype=torch.int64, device=dev)
    short = torch.full((2,), -1, dtype=torch.int64, device=dev)
    cuda_decode.huffman_decode(*args, chunk_bits=32, stats=long)
    cuda_decode.huffman_decode(*args, chunk_bits=32, stats=short)
    k = len(cuda_decode.CHAIN_STATS)
    assert long[k:].tolist() == [-1, -1, -1]
    assert short.tolist() == long[:2].tolist()
    assert long[0] == -(-(8 * len(STREAMS["equal lengths"]) - args[2])
                        // 32)
    assert (long[:k] >= 0).all()
    with pytest.raises(ValueError):
        cuda_decode.huffman_decode(*args, stats=short[:1])


def test_decode_image_and_frames_make_no_host_wait(dev):
    """decode_image and decode_frames launch D1's rounds and table and
    leave the pixels on the card without waiting on it: the sync debug
    mode raises at any wait, and an event wait raises too."""
    data = imageencoder_tpu_torch.encode_image(
        image(96, 128, 4), quant_from_numpy(np.array(JPEG4, np.uint32)),
        use_huffman=True, device=dev)
    video = small_video(dev, 4, 16, True, True)
    want = (imageencoder_tpu_torch.decode_image(data, device=dev),
            imageencoder_tpu_torch.decode_frames(video, device=dev))
    torch.cuda.synchronize()

    def no_wait(event):
        raise AssertionError("an event wait in a decode")

    real = torch.cuda.Event.synchronize
    torch.cuda.Event.synchronize = no_wait
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = (imageencoder_tpu_torch.decode_image(data, device=dev),
               imageencoder_tpu_torch.decode_frames(video, device=dev))
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.Event.synchronize = real
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("merange,mb", [(1, 2), (16, 6), (300, 10),
                                        (20000, 16)])
def test_read_vectors_kernel_equals_plain_out_to_the_widest(dev, merange,
                                                            mb):
    """The vector read on random bits: every value of mb-bit fields, the
    extremes +-2^(mb - 1) among them for narrow fields, and vector
    blocks that run past the byte count (0xFF in the buffer there)."""
    data = hand_video(48, 32, 7, 3, merange, seed=mb, empty_records=True)
    plan, payload, nbytes = payload_of(dev, data)
    assert plan["mb"] == mb
    n = plan["params"].frame_count
    _, _, _, _, vstart, _ = cuda_decode.walk_video_plain(
        payload, nbytes, plan["start"], n, plan["n_blocks"], 3,
        plan["vbits"], True, 4)
    values = set()
    for cut in (int(nbytes), int(nbytes) // 3):
        nb = torch.tensor([cut], dtype=torch.int64, device=dev)
        got = cuda_decode.read_vectors(payload, nb, vstart, 3,
                                       plan["n_macro"], mb)
        want = cuda_decode.read_vectors_plain(payload, nb, vstart, 3,
                                              plan["n_macro"], mb)
        assert torch.equal(got, want)
        values |= set(got.unique().tolist())
    if mb == 2:
        assert values == {-2, -1, 0, 1}


@pytest.mark.parametrize("b,norm", [(4, "reference"), (8, "ortho")])
def test_decode_blocks_with_prediction_kernel_equals_plain(dev, b, norm):
    """D3 with a prediction, on every 3rd frame of a stack (records,
    prediction and output all views): records of every width at random
    offsets into random bytes, counts past B*B among them, some fields
    past the byte count (0xFF in the buffer there), onto random
    predictions, clamped both ways."""
    k, n_frames = b * b, 7
    h, w = 4 * b, 16 * b
    n = (h // b) * (w // b)
    rng = np.random.default_rng(b)
    data = rng.integers(0, 256, 4000, np.uint8)
    payload = torch.tensor(list(data) + [0xFF] * 512, dtype=torch.uint8,
                           device=dev)
    nbytes = torch.tensor([3000], dtype=torch.int64, device=dev)
    shape = (n_frames, n)
    recs = [torch.from_numpy(x).to(dev) for x in (
        rng.integers(0, 8 * 3200, shape).astype(np.int64),
        rng.integers(0, 16, shape).astype(np.int32),
        rng.integers(0, k + 4, shape).astype(np.int32))]
    quant = torch.tensor(quant_for(b).ravel(), dtype=torch.float64,
                         device=dev)
    pred = torch.from_numpy(rng.integers(0, 256, (2, h, w), np.uint8)).to(
        dev)
    out = torch.zeros((n_frames, h, w), dtype=torch.uint8, device=dev)
    args = (payload, nbytes, *(r[1::3] for r in recs), quant, b, norm, h, w)
    got = cuda_decode.decode_blocks(*args, pred=pred, out=out[1::3])
    want = cuda_decode.decode_blocks_plain(*args, pred=pred)
    assert torch.equal(got, want) and torch.equal(out[1::3], want)
    assert not out[0::3].any() and not out[2::3].any()
    assert 0 < int((want == 0).sum()) and 0 < int((want == 255).sum())
    assert 0 < int(((want > 0) & (want < 255)).sum())


@pytest.mark.parametrize("h,w", [(48, 64), (720, 1280)])
@pytest.mark.parametrize("mb", [2, 6, 16])
def test_predict_kernel_on_decode_vectors(dev, h, w, mb):
    """K7 on the vectors a decoder reads: any mb-bit value, out to
    +-2^(mb - 1), so windows clamp at every edge; reference, vectors and
    output as views of every 4th frame, as the decode hands them over."""
    rng = np.random.default_rng(h + mb)
    frames = torch.from_numpy(rng.integers(0, 256, (8, h, w), np.uint8)).to(
        dev)
    n_macro = (h // 16) * (w // 16)
    lim = 1 << (mb - 1)
    mvec = torch.from_numpy(rng.integers(-lim, lim, (8, n_macro, 2))
                            .astype(np.int32))
    mvec[:, :4] = torch.tensor([[-lim, -lim], [lim - 1, lim - 1],
                                [-lim, lim - 1], [lim - 1, -lim]])
    mvec = mvec.to(dev)
    out = torch.zeros_like(frames)
    before = cuda_motion.predict.launches
    got = cuda_motion.predict(frames[0::4], mvec[1::4], out=out[1::4])
    assert cuda_motion.predict.launches == before + 1
    want = cuda_motion.predict_plain(frames[0::4], mvec[1::4])
    assert torch.equal(got, want) and torch.equal(out[1::4], want)
    assert not out[0::4].any()
    assert torch.equal(cuda_motion.predict(frames, mvec),
                       cuda_motion.predict_plain(frames, mvec))


@pytest.mark.parametrize("w,h,n,gop,merange", [
    (48, 32, 5, 2, 1), (48, 32, 7, 3, 300), (40, 24, 3, 1, 8)])
def test_random_video_streams_decode_on_the_card_as_on_the_host(
        dev, w, h, n, gop, merange):
    """Streams of random bits after a video header: vectors of every
    value and records of any width, decoded on the card."""
    for seed in range(3):
        video_held(dev, hand_video(w, h, n, gop, merange, seed=seed))
        video_held(dev, hand_video(w, h, n, gop, merange, seed=seed,
                                   empty_records=True))


def test_video_rejections_launch_nothing(dev):
    before = launch_counts(VDECODE)
    with pytest.raises(StreamFormatError):  # P-frames off the 16-px grid
        imageencoder_tpu_torch.decode_video(hand_video(40, 24, 3, 4, 8),
                                            device=dev)
    with pytest.raises(StreamFormatError):
        imageencoder_tpu_torch.decode_video(
            dict_stream([(1, 1, 2), (2, 1, 2)]), device=dev)
    with pytest.raises(ValueError, match="without a dict"):
        imageencoder_tpu_torch.decode_video(b"\x80\x00", device=dev)
    empty = hand_video(48, 32, 0, 4, 8)  # a header-only stream
    assert video_held(dev, empty) == b""
    assert launch_counts(VDECODE) == before


# ---- serving: K2, the dict kernel and K4 pack_payload over a batch ----

def round4(n: int) -> int:
    return -(-n // 4) * 4


def stacked_locals(dev, b: int, n: int, lw: int, seed: int):
    """B streams of random register files, each with its own share of
    empty records (all empty in the second stream)."""
    got = [random_locals(dev, n, lw, seed + k, 1.0 if k == 1 else 0.1 * k)
           for k in range(b)]
    return (torch.stack([g[0] for g in got]).contiguous(),
            torch.stack([g[1] for g in got]).contiguous())


def held_stream_rows(got, want) -> None:
    """Batched pack outputs (words [B, n], totals [B], ...) against their
    plain version: totals, each stream's words, and any further output
    (a histogram, undefined for a refused stream)."""
    assert torch.equal(got[1], want[1])
    for k in range(got[0].shape[0]):
        assert torch.equal(cuda_pack.stream_words(got[0][k], got[1][k]),
                           cuda_pack.stream_words(want[0][k], want[1][k])), k
    kept = got[1] >= 0
    for a, b in zip(got[2:], want[2:]):
        assert torch.equal(a[kept], b[kept])


@pytest.mark.parametrize("hist", [True, False])
@pytest.mark.parametrize("b,n,lw,start", [
    (1, 3000, 9, 70), (5, 3000, 9, 70), (3, 700, 30, 2047), (4, 1, 6, 0),
    (16, 0, 9, 37), (7, 5000, 7, 64), (3, 2100, 12, 19)])
def test_pack_locals_batch_kernel_equals_plain(dev, hist, b, n, lw, start):
    """K2 over a batch against its plain version and, stream by stream,
    against one K2 call per stream: no stream reads another's records."""
    local, lens = stacked_locals(dev, b, n, lw, n + lw)
    prefix = torch.full((start // 32 + 1,), -1, dtype=torch.int32,
                        device=dev)
    prefix[-1] = -(1 << (32 - start % 32)) if start % 32 else 0
    nw = round4(n * lw + start // 32 + 2)
    dirtied(dev, b * nw)
    wrapper, plain, single = (
        (cuda_pack.pack_locals_hist_batch,
         cuda_pack.pack_locals_hist_batch_plain, cuda_pack.pack_locals_hist)
        if hist else (cuda_pack.pack_locals_batch,
                      cuda_pack.pack_locals_batch_plain,
                      cuda_pack.pack_locals))
    before = wrapper.launches
    got = wrapper(local, lens, start, nw, prefix)
    assert wrapper.launches == before + 1
    held_stream_rows(got, plain(local, lens, start, nw, prefix))
    for k in range(b):
        one = single(local[k], lens[k], start, nw, prefix)
        assert int(one[1]) == int(got[1][k])
        assert torch.equal(cuda_pack.stream_words(*one[:2]),
                           cuda_pack.stream_words(got[0][k], got[1][k]))
    assert got[1].tolist() == [start + int(x) for x in lens.sum(dim=1)]


def test_pack_locals_batch_ends_and_refusals_stay_in_their_stream(dev):
    """Stream 0 ends on a word boundary, stream 1 holds a refused record:
    only its total is -1, and stream 2 is packed as alone."""
    local, lens = stacked_locals(dev, 3, 2100, 7, 5)
    short = (19 + int(lens[0, :-1].sum())) % 32
    lens[0, -1] = 32 * 3 - short
    local[0, -1] = -1
    local[0, -1, 3:] = 0
    local[0, -1, 2] = -(1 << short) if short else -1
    lens[1, 1000] = 32 * 7 + 1
    nw = round4(2100 * 7 + 3)
    for wrapper, plain in (
            (cuda_pack.pack_locals_hist_batch,
             cuda_pack.pack_locals_hist_batch_plain),
            (cuda_pack.pack_locals_batch, cuda_pack.pack_locals_batch_plain)):
        dirtied(dev, 3 * nw)
        got = wrapper(local, lens, 19, nw)
        held_stream_rows(got, plain(local, lens, 19, nw))
        assert int(got[1][0]) % 32 == 0 and int(got[1][1]) == -1
        assert int(got[1][2]) == 19 + int(lens[2].sum())


def test_dict_batch_kernel_equals_plain(dev):
    """Every histogram kind, a refused stream and random histograms in one
    batch: each row is the single kernel's table, bit for bit."""
    freqs = [histogram(k, s) for k, s in KINDS if k != "geometric"]
    freqs += [random_histogram(seed) for seed in range(40)]
    totals = [8 * int(f.sum()) - (k % 7) for k, f in enumerate(freqs)]
    totals[3] = -1
    hists = torch.from_numpy(np.stack(freqs).astype(np.int32)).to(dev)
    totals = torch.tensor(totals, dtype=torch.int64, device=dev)
    before = huffman.build_dict_batch.launches
    got = huffman.build_dict_batch(hists, totals)
    assert huffman.build_dict_batch.launches == before + 1
    assert torch.equal(got, huffman.build_dict_batch_plain(hists, totals))
    for k in range(len(freqs)):
        assert torch.equal(got[k], huffman.build_dict(hists[k], totals[k]))
    fallback = [dict_table.fields(t)["fallback"] for t in got]
    assert 0 < sum(fallback) < len(fallback)


@pytest.mark.parametrize("b,n_words", [(1, 4096), (6, 1028), (16, 60000)])
def test_pack_payload_batch_kernel_equals_plain(dev, b, n_words):
    """K4 pack_payload over a batch under each stream's own dict table
    (a fallback stream among them codes no byte): each row is the single
    kernel's payload."""
    rng = np.random.default_rng(b)
    words = torch.from_numpy((rng.integers(0, 2 ** 32, (b, n_words),
                                           dtype=np.uint64) & 0x0F1F3F7F)
                             .astype(np.uint32).view(np.int32)).to(dev)
    totals = torch.from_numpy(32 * n_words - rng.integers(0, 4000, b)).to(dev)
    hists = torch.stack([cuda_kernels.byte_histogram(w, t)
                         for w, t in zip(words, totals)])
    tables = huffman.build_dict_batch(hists, totals)
    if b > 1:  # a stream that takes the fallback: nothing to code
        tables[1] = huffman.build_dict(hists[1], torch.tensor(-1, device=dev))
    nw = round4(huffman.payload_words(n_words))
    dirtied(dev, b * nw)
    before = cuda_pack.pack_payload_batch.launches
    got = cuda_pack.pack_payload_batch(words, tables, nw)
    assert cuda_pack.pack_payload_batch.launches == before + 1
    held_stream_rows(got, cuda_pack.pack_payload_batch_plain(words, tables,
                                                             nw))
    for k in range(b):
        one = cuda_pack.pack_payload(words[k], tables[k], nw)
        assert torch.equal(cuda_pack.stream_words(*one),
                           cuda_pack.stream_words(got[0][k], got[1][k]))


BATCH = (cuda_encode.encode_locals, cuda_pack.pack_locals_batch,
         cuda_pack.pack_locals_hist_batch, huffman.build_dict_batch,
         cuda_pack.pack_payload_batch)


@pytest.mark.parametrize("b,h,w,use_huffman", [
    (16, 912, 4096, True), (16, 912, 4096, False), (8, 2160, 3840, True),
    (8, 2160, 3840, False)])
def test_full_size_batch_equals_host_engine_and_decodes(dev, b, h, w,
                                                        use_huffman):
    """encode_image_batch at the serving sizes: K1, K2, and with Huffman
    the dict and K4 launched once each; every stream equals the host
    engine's and decode_image_batch gives back the host decode's pixels.
    The last image is noise (full-size noise still pays for the dict)."""
    imgs = np.stack([image(h, w, k) for k in range(b - 1)] + [
        np.random.default_rng(9).integers(0, 256, (h, w), np.uint8)])
    quant = QuantMatrix(np.array(JPEG4, np.uint32))
    others = ENCODE[1:]  # the single-stream packers, dict and K4
    before = launch_counts(BATCH + others)
    got = imageencoder_tpu_torch.encode_image_batch(
        imgs, quant_from_numpy(quant.matrix), use_huffman=use_huffman,
        device=dev)
    after = launch_counts(BATCH + others)
    assert [a - c for a, c in zip(after, before)] == (
        [1, int(not use_huffman), int(use_huffman), int(use_huffman),
         int(use_huffman)] + [0] * len(others))
    pixels = imageencoder_tpu_torch.decode_image_batch(got, device=dev)
    for img, data, px in zip(imgs, got, pixels):
        want = imageencoder_tpu.encode_image(img, quant,
                                             use_huffman=use_huffman,
                                             backend="numpy")
        assert data == want
        assert bool(data[0] & 0x80) == use_huffman
        np.testing.assert_array_equal(
            px.cpu().numpy(), imageencoder_tpu.decode_image(want,
                                                            backend="numpy"))


def test_batch_with_a_fallback_stream_equals_host_engine(dev):
    """A batch under quant all ones whose noise image takes the raw-copy
    fallback while the smooth ones are coded: each stream decides alone."""
    imgs = np.stack([image(128, 256, k) for k in range(3)] + [
        np.random.default_rng(9).integers(0, 256, (128, 256), np.uint8)])
    quant = QuantMatrix(np.ones((4, 4), np.uint32))
    got = imageencoder_tpu_torch.encode_image_batch(
        imgs, quant_from_numpy(quant.matrix), device=dev)
    want = [imageencoder_tpu.encode_image(img, quant, use_huffman=True,
                                          backend="numpy") for img in imgs]
    assert got == want
    assert [bool(s[0] & 0x80) for s in got] == [True, True, True, False]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_stream_on_the_card_equals_host_engine(dev, depth):
    imgs = [image(912, 4096, k) for k in range(5)]
    quant = QuantMatrix(np.array(JPEG4, np.uint32))
    got = list(imageencoder_tpu_torch.encode_image_stream(
        iter(imgs), quant_from_numpy(quant.matrix), depth=depth, device=dev))
    assert got == [imageencoder_tpu.encode_image(img, quant, use_huffman=True,
                                                 backend="numpy")
                   for img in imgs]


@pytest.mark.parametrize("kind", ["image", "video"])
def test_cli_on_the_card_writes_the_plain_paths_files(dev, tmp_path, kind):
    """python -m imageencoder_tpu_torch with --device cuda and with
    --device cpu write the same files."""
    from test_torch_cli import write_job

    from imageencoder_tpu_torch import cli

    outs = {}
    for device in ("cuda", "cpu"):
        conf, files = write_job(tmp_path / device, kind, big=True)
        assert cli.main([str(conf), "--device", device]) == 0
        outs[device] = [f.read_bytes() for f in files]
    assert outs["cuda"] == outs["cpu"]


# ---- the sharded and multi-process paths (parallel/) ----
# The card's machine has one card, and NCCL takes one rank a card: the
# sharded paths run in a world of one over NCCL, through its collectives;
# the GOP-distributed encode runs two processes over gloo, both launching
# their kernels on the card.

@pytest.mark.parametrize("rows,n_words", [(1, 5000), (16, 4100), (3, 64)])
def test_byte_histogram_rows_kernel_equals_plain(dev, rows, n_words):
    rng = np.random.default_rng(rows + n_words)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (rows, n_words))
                             .astype(np.int32)).to(dev)
    lo = rng.integers(0, 4 * n_words, rows)
    hi = lo + rng.integers(-3, 4 * n_words, rows)
    lo[0], hi[0] = 3, 4 * n_words - 1  # a window over nearly all of a row
    windows = [torch.from_numpy(x).to(dev) for x in (lo, hi)]
    before = cuda_kernels.byte_histogram_rows.launches
    got = cuda_kernels.byte_histogram_rows(words, *windows)
    assert cuda_kernels.byte_histogram_rows.launches == before + 1
    want = cuda_kernels.byte_histogram_rows_plain(words.cpu(),
                                                  *(w.cpu() for w in windows))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("n,lw", [(233472 // 16, 6), (1000, 9), (40, 3)])
def test_pack_segments_kernel_equals_plain(dev, n, lw):
    rng = np.random.default_rng(n)
    b = 4
    f = (32 * lw - 4) // 16
    vals = torch.from_numpy(rng.integers(0, 2**16, (b * n, f)))
    nbits = torch.from_numpy(rng.integers(0, 17, (b * n, f)))
    local, lens = device_pack.register_files(vals, nbits, lw)
    local = device_pack.as_int32(local).view(b, n, lw)
    lens = lens.to(torch.int32).view(b, n)
    starts = torch.tensor([0, 13, 31, 32 + 7])
    n_words = -(-(n * lw + 3) // 4) * 4
    got = cuda_pack.pack_segments(local.to(dev), lens.to(dev),
                                  starts.to(dev), n_words)
    want = cuda_pack.pack_segments_plain(local, lens, starts, n_words)
    for k in range(b):
        assert int(got[1][k]) == int(want[1][k])
        assert torch.equal(cuda_pack.stream_words(got[0][k].cpu(),
                                                  got[1][k]),
                           cuda_pack.stream_words(want[0][k], want[1][k]))


@pytest.mark.parametrize("n_in,windows", [
    (4096, [(0, 16384, 0), (3, 9000, 13), (1, 2, 31), (5, 5, 7)]),
    (64, [(2, 200, 3)])])
def test_pack_payload_window_kernel_equals_plain(dev, n_in, windows):
    rng = np.random.default_rng(n_in)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (len(windows), n_in))
                             .astype(np.int32))
    freqs = np.bincount(words.numpy().view(np.uint32).astype(">u4")
                        .view(np.uint8).reshape(-1), minlength=256) + 1
    _, cw, cl = huffman._dict_and_codes(freqs)
    tables = torch.stack([dict_table.make_table(
        cw, cl, np.zeros(256), "cpu", dict_bits=start, nbytes=hi,
        first_byte=lo) for lo, hi, start in windows])
    n_words = -(-(4 * n_in * 15 // 32 + 2) // 4) * 4
    got = cuda_pack.pack_payload_window(words.to(dev), tables.to(dev),
                                        n_words)
    want = cuda_pack.pack_payload_batch_plain(words, tables, n_words)
    for k in range(len(windows)):
        assert int(got[1][k]) == int(want[1][k])
        assert torch.equal(cuda_pack.stream_words(got[0][k].cpu(),
                                                  got[1][k]),
                           cuda_pack.stream_words(want[0][k], want[1][k]))


RAGGED = {  # id: image kinds, (H, W), quant kind
    "ragged": (("smooth", "noise", "flat", "smooth"), (96, 256), "jpeg"),
    "fallback_batch": (("smooth",) * 3 + ("noise",), (128, 256), "ones"),
    "one": (("smooth",), (96, 256), "jpeg"),
    "seventeen": (tuple(("smooth", "noise", "flat")[k % 3]
                        for k in range(17)), (64, 128), "jpeg"),
    # Payloads of many tiles and groups of tiles, of very different lengths.
    "long": (("noise", "smooth", "flat", "noise"), (912, 1024), "jpeg"),
}


def ragged_images(kinds, h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([
        rng.integers(0, 256, (h, w), np.uint8) if kind == "noise"
        else np.full((h, w), 90 + k, np.uint8) if kind == "flat"
        else image(h, w, seed + k) for k, kind in enumerate(kinds)])


@pytest.mark.parametrize("case", list(RAGGED))
def test_batch_packers_on_ragged_batches(dev, case):
    """K2 with the histograms over a ragged batch, then K4 pack_payload
    over its payloads (K2's two launches each, into dirtied buffers),
    each against its plain version on the same inputs; the batch's
    streams equal the host engine's."""
    kinds, (h, w), qkind = RAGGED[case]
    imgs = ragged_images(kinds, h, w, len(kinds))
    b = len(imgs)
    quant = QuantMatrix(np.asarray(quant_for(4, qkind), np.uint32))
    pq = quant_from_numpy(quant.matrix)
    start, header = image_stream_header(pq, True, w, h, True, dev)
    local, lens, _ = cuda_encode.encode_locals(
        torch.from_numpy(imgs.reshape(b * h, w)).to(dev), pq.as_float(), 4,
        True, "reference")
    n = local.shape[0] // b
    nw = device_pack.packed_words_bound(n, local.shape[1])
    args = (local.view(b, n, -1), lens.view(b, n), start, nw, header)
    dirtied(dev, b * nw)
    got = cuda_pack.pack_locals_hist_batch(*args)
    held_stream_rows(got, cuda_pack.pack_locals_hist_batch_plain(*args))
    tables = huffman.build_dict_batch(got[2], got[1])
    pnw = round4(huffman.payload_words(nw))
    dirtied(dev, b * pnw)
    before = cuda_pack.pack_payload_batch.launches
    pay = cuda_pack.pack_payload_batch(got[0], tables, pnw)
    assert cuda_pack.pack_payload_batch.launches == before + 1
    held_stream_rows(pay, cuda_pack.pack_payload_batch_plain(got[0], tables,
                                                             pnw))
    nbytes = [dict_table.fields(t)["nbytes"] for t in tables]
    if case in ("ragged", "fallback_batch"):
        assert min(nbytes) == 0 < max(nbytes)  # one stream codes no byte
    if case == "long":  # 20 tiles and more, and a short stream
        assert max(nbytes) > 20 * 8192 and min(nbytes) < max(nbytes) // 4
    streams = imageencoder_tpu_torch.encode_image_batch(imgs, pq, device=dev)
    assert streams == [imageencoder_tpu.encode_image(
        img, quant, use_rle=True, use_huffman=True, backend="numpy")
        for img in imgs]


@pytest.mark.parametrize("b", [1, 3, 17])
def test_pack_payload_window_on_ragged_windows(dev, b):
    """K4 pack_payload over B byte windows of rows long enough for many
    tiles, each from a first byte past 0 at an odd start bit (one window
    empty, one over a whole row), into a dirtied buffer: each row as its
    plain version writes it."""
    rng = np.random.default_rng(100 + b)
    n_in = 24000
    words = torch.from_numpy((rng.integers(0, 2 ** 32, (b, n_in),
                                           dtype=np.uint64) & 0x3F0F1F7F)
                             .astype(np.uint32).view(np.int32))
    freqs = np.bincount(words.numpy().view(np.uint32).astype(">u4")
                        .view(np.uint8).reshape(-1), minlength=256) + 1
    _, cw, cl = huffman._dict_and_codes(freqs)
    first = rng.integers(1, 9, b)
    last = np.minimum(first + rng.integers(0, 4 * n_in, b), 4 * n_in)
    last[0] = 4 * n_in
    if b > 1:
        last[1] = first[1]
    tables = torch.stack([dict_table.make_table(
        cw, cl, np.zeros(256), "cpu", dict_bits=2 * int(rng.integers(16)) + 1,
        nbytes=int(hi), first_byte=int(lo)) for lo, hi in zip(first, last)])
    n_words = round4(4 * n_in * 16 // 32 + 2)
    dirtied(dev, b * n_words)
    got = cuda_pack.pack_payload_window(words.to(dev), tables.to(dev),
                                        n_words)
    held_stream_rows([x.cpu() for x in got],
                     cuda_pack.pack_payload_batch_plain(words, tables,
                                                        n_words))


@pytest.fixture(scope="module")
def nccl_mesh():
    """A world of one over NCCL in this process, and its 1x1 mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist

    from imageencoder_tpu_torch.parallel import distributed, make_mesh

    assert dist.is_nccl_available()
    distributed.initialize(device="cuda")
    try:
        yield make_mesh(1, device="cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("h,w", [(912, 4096), (2160, 3840)])
@pytest.mark.parametrize("entropy", [False, True])
def test_sharded_image_batch_world_of_one(nccl_mesh, h, w, entropy):
    """encode_sharded_image_batch over NCCL, Huffman by stage 1 or by the
    distributed stage 2: the host engine's streams and the one-device
    batch's, through K1, K2 over segments, the windowed K3, the dict
    kernel and K4."""
    from imageencoder_tpu_torch.parallel import encode_sharded_image_batch

    imgs = np.stack([image(h, w, 60 + k) for k in range(3)])
    quant = QuantMatrix(np.array(JPEG4, np.uint32))
    qp = quant_from_numpy(quant.matrix)
    before = launch_counts(SHARDED)
    got = encode_sharded_image_batch(torch.from_numpy(imgs).cuda(), qp,
                                     nccl_mesh, device_entropy=entropy)
    torch.cuda.synchronize()
    ran = [a - b for a, b in zip(launch_counts(SHARDED), before)]
    assert ran == [1, 1, 1 + entropy, int(entropy), 1]
    assert got == [imageencoder_tpu.encode_image(img, quant, use_huffman=True,
                                                 backend="numpy")
                   for img in imgs]
    assert got == imageencoder_tpu_torch.encode_image_batch(imgs, qp,
                                                            device="cuda")


SHARDED = (cuda_encode.encode_locals, cuda_pack.pack_segments,
           cuda_kernels.byte_histogram_rows, cuda_pack.pack_payload_window,
           huffman.build_dict_batch)


@pytest.mark.parametrize("mode", ["concat", "separate"])
def test_sharded_stage2_world_of_one_equals_huffman_encode(nccl_mesh, mode):
    from imageencoder_tpu.ops.huffman import huffman_encode as host_huffman
    from imageencoder_tpu_torch.parallel import sharding

    imgs = np.stack([image(256, 512, 70 + k) for k in range(4)])
    step = sharding.make_sharded_encode_packed(nccl_mesh, mode=mode)
    words, bits, hist = step(torch.from_numpy(imgs).cuda(), JPEG4, 37)
    header = b"\x12\x34\x50\x00\x00"
    got = sharding.encode_sharded_huffman(words, bits, hist, 37, header,
                                          nccl_mesh, mode=mode)
    inner = sharding.assemble_packed_stream(words, bits, 37, header, mode)
    if mode == "concat":
        assert got == host_huffman(inner[0])
    else:
        assert got == [host_huffman(x) for x, _ in inner]


@pytest.mark.parametrize("h,w", [(912, 4096), (2160, 3840), (36, 24)])
def test_sharded_decode_world_of_one(nccl_mesh, h, w):
    from imageencoder_tpu_torch.parallel import decode_image_sharded

    quant = QuantMatrix(np.array(JPEG4, np.uint32))
    data = imageencoder_tpu.encode_image(image(h, w, 80), quant,
                                         use_huffman=True, backend="numpy")
    got = decode_image_sharded(data, nccl_mesh)
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), imageencoder_tpu
                                  .decode_image(data, backend="numpy"))


@pytest.mark.parametrize("ref_mode", ["raw", "recon"])
def test_two_process_gop_encode_at_720p25(dev, ref_mode, tmp_path):
    """Two processes over gloo, each encoding its GOPs of bench.py's video
    on the card: the one-process encode_video's stream and the host
    engine's."""
    from imageencoder_tpu_torch.parallel import dryrun

    w, h, n = 1280, 720, 25
    data = b"".join(f.tobytes() + bytes(w * h // 2)
                    for f in video_frames(w, h, n, 0))
    quant = QuantMatrix(np.array(JPEG4, np.uint32))
    qp = quant_from_numpy(quant.matrix)
    ranks = dryrun.spawn_world(2, [("gops", {
        "data": data, "width": w, "height": h, "quant": qp, "use_rle": True,
        "gop": 4, "merange": 16, "ref_mode": ref_mode, "device": "cuda"})],
        workdir=tmp_path, timeout_s=600)
    want = imageencoder_tpu_torch.encode_video(data, w, h, qp, True, 4, 16,
                                               ref_mode=ref_mode,
                                               device=dev)
    assert want == bytes(host_video.encode_video(
        data, w, h, quant, True, 4, 16, backend="numpy", ref_mode=ref_mode))
    for (stream, missing), in ranks:
        assert missing == [] and stream == want


# ---- images of zero blocks on the card ----

@pytest.mark.parametrize("shape", [(0, 16), (16, 0), (0, 0)], ids=str)
@pytest.mark.parametrize("huff", [True, False])
def test_zero_block_images_on_the_card(dev, shape, huff):
    """A zero-block image's stream decodes on the card to the empty image
    (decode_image returns before any launch), and a batch of them encodes
    to the JAX package's streams through the card's batch path."""
    from imageencoder_tpu.models import batch as host_batch

    quant = QuantMatrix(np.array(JPEG4, np.uint32))
    qp = quant_from_numpy(quant.matrix)
    data = imageencoder_tpu.encode_image(np.zeros(shape, np.uint8), quant,
                                         use_huffman=huff, backend="numpy")
    got = imageencoder_tpu_torch.decode_image(data, device="cuda")
    assert got.device.type == "cuda" and tuple(got.shape) == shape
    assert [tuple(x.shape) for x in imageencoder_tpu_torch.decode_image_batch(
        [data], device="cuda")] == [shape]
    imgs = np.zeros((2, *shape), np.uint8)
    want = list(host_batch.encode_image_batch(imgs, quant, use_huffman=huff))
    assert imageencoder_tpu_torch.encode_image_batch(
        torch.from_numpy(imgs).to(dev), qp, use_huffman=huff,
        device="cuda") == want == [data, data]


# ---- the sharded video (parallel/video_sharding.py) ----

@pytest.mark.parametrize("n_stripes", [1, 2, 4])
@pytest.mark.parametrize("f0,gop", [(0, 4), (1, 4), (2, 3)])
def test_stripe_search_kernels_equal_plain(dev, n_stripes, f0, gop):
    """K6+K7 on a haloed stripe (search_residual_stripe and
    search_predict_stripe) against their plain versions on the card, and
    the stripes' vectors against the whole frame's search."""
    h, w, merange, n = 192, 320, 16, 9
    video = torch.from_numpy(video_frames(w, h, n + 1, 90 + f0)).to(dev)
    hs, halo = h // n_stripes, merange
    padded = torch.zeros((n + 1, h + 2 * halo, w), dtype=torch.uint8,
                         device=dev)
    padded[:, halo:halo + h] = video
    p_idx = cuda_motion.p_frames(n, gop, f0)
    mvs = []
    for s in range(n_stripes):
        cur = video[1:, s * hs:(s + 1) * hs].contiguous()
        ref = padded[:-1, s * hs:(s + 1) * hs + 2 * halo].contiguous()
        args = (cur, ref, s * hs, halo, h)
        for fn, plain, extra in (
                (cuda_motion.search_residual_stripe,
                 cuda_motion.search_residual_stripe_plain, (f0, gop)),
                (cuda_motion.search_predict_stripe,
                 cuda_motion.search_predict_stripe_plain, ())):
            before = fn.launches
            got = fn(*args, *extra, merange)
            assert fn.launches == before + 1
            for a, b in zip(got, plain(*args, *extra, merange)):
                assert torch.equal(a, b)
        mvs.append(cuda_motion.search_residual_stripe(*args, f0, gop,
                                                      merange)[0])
    whole, _ = cuda_motion.search_predict(video[1:][p_idx].contiguous(),
                                          video[:-1][p_idx].contiguous(),
                                          merange)
    got = torch.cat([m.view(len(p_idx), -1, w // 16, 2) for m in mvs], dim=1)
    assert torch.equal(got.reshape(whole.shape), whole)


@pytest.mark.parametrize("n_stripes", [1, 2, 4])
def test_stripe_search_kernel_on_strided_frames_equals_plain(dev, n_stripes):
    """search_predict_stripe as the sharded recon steps it: frame k of
    every GOP of a stripe (cur[k::gop]) searched in references that lie
    apart, into views of the vectors of every P-frame and the predictions
    of every frame (mvec[k - 1::gop - 1], out[k::gop]): one launch a step,
    bit-equal to the plain version on the same views and to the dense
    call, and no row outside the views written."""
    h, w, merange, n, gop = 192, 320, 16, 11, 4  # a short last GOP
    video = torch.from_numpy(video_frames(w, h, n, 93)).to(dev)
    hs = h // n_stripes
    halo = merange if n_stripes > 1 else 0
    padded = torch.zeros((n, h + 2 * halo, w), dtype=torch.uint8,
                         device=dev)
    padded[:, halo:halo + h] = video
    n_p = n - len(range(0, n, gop))
    n_mb = (hs // 16) * (w // 16)
    for s in range(n_stripes):
        cur = video[:, s * hs:(s + 1) * hs].contiguous()
        refs = padded[0::gop, s * hs:(s + 1) * hs + 2 * halo]
        mv_buf = torch.full((n_p, n_mb, 2), -7, dtype=torch.int32,
                            device=dev)
        out_buf = torch.full_like(cur, 9)
        for k in range(1, gop):
            sel = cur[k::gop]
            ref = refs[:sel.shape[0]]
            args = (sel, ref, s * hs, halo, h, merange)
            mvec, out = mv_buf[k - 1::gop - 1], out_buf[k::gop]
            before = cuda_motion.search_predict_stripe.launches
            got = cuda_motion.search_predict_stripe(*args, mvec=mvec,
                                                    out=out)
            assert cuda_motion.search_predict_stripe.launches == before + 1
            assert got[0] is mvec and got[1] is out
            plain = cuda_motion.search_predict_stripe_plain(
                *args, mvec=torch.empty_like(mvec), out=torch.empty_like(out))
            dense = cuda_motion.search_predict_stripe(
                sel.contiguous(), ref.contiguous(), *args[2:])
            for a, b, c in zip(got, plain, dense):
                assert torch.equal(a, b) and torch.equal(a, c)
        assert (out_buf[0::gop] == 9).all()


@pytest.mark.parametrize("n_segments,n", [(18, 3600), (3, 700), (1, 1)])
def test_pack_records_segments_kernel_equals_plain(dev, n_segments, n):
    rng = np.random.default_rng(n)
    vals = torch.from_numpy(rng.integers(-2**15, 2**15, (n_segments, n, 2))
                            .astype(np.int32))
    nbits = torch.full_like(vals, 6)
    starts = torch.from_numpy(rng.integers(0, 32, n_segments))
    n_words = -(-(2 * n * 6 // 32 + 2) // 4) * 4
    before = cuda_pack.pack_records_segments.launches
    got = cuda_pack.pack_records_segments(vals.to(dev), nbits.to(dev),
                                          starts.to(dev), n_words)
    assert cuda_pack.pack_records_segments.launches == before + 1
    want = cuda_pack.pack_records_segments_plain(vals, nbits, starts,
                                                 n_words)
    for k in range(n_segments):
        assert int(got[1][k]) == int(want[1][k])
        assert torch.equal(cuda_pack.stream_words(got[0][k].cpu(),
                                                  got[1][k]),
                           cuda_pack.stream_words(want[0][k], want[1][k]))


SHARDED_VIDEO = (cuda_encode.encode_locals, cuda_pack.pack_segments,
                 cuda_pack.pack_records_segments,
                 cuda_motion.search_residual_stripe,
                 cuda_motion.search_predict_stripe, cuda_encode.recon_step)


@pytest.mark.parametrize("ref_mode", ["raw", "recon"])
@pytest.mark.parametrize("huff", [True, False])
def test_sharded_video_world_of_one_equals_host_engine(nccl_mesh, ref_mode,
                                                       huff):
    """encode_video_sharded over NCCL at 320x176x8: the host engine's
    stream, through the stripe search, K1, K2 and K4 over segments; and
    decode_video_sharded of it: the host engine's frames."""
    from imageencoder_tpu_torch.parallel import (decode_video_sharded,
                                                 encode_video_sharded)

    w, h, n = 320, 176, 8
    frames = video_frames(w, h, n, 91)
    quant = QuantMatrix(np.array(JPEG4, np.uint32))
    data = b"".join(f.tobytes() + bytes([128]) * (w * h // 2) for f in frames)
    want = bytes(host_video.encode_video(data, w, h, quant, True, 4, 16,
                                         use_huffman=huff, backend="numpy",
                                         ref_mode=ref_mode))
    before = launch_counts(SHARDED_VIDEO)
    got = encode_video_sharded(torch.from_numpy(frames).cuda(),
                               quant_from_numpy(quant.matrix), nccl_mesh,
                               True, 4, 16, use_huffman=huff,
                               ref_mode=ref_mode)
    torch.cuda.synchronize()
    ran = [a - b for a, b in zip(launch_counts(SHARDED_VIDEO), before)]
    recon = ref_mode == "recon"
    # Recon: one search and one recon step a GOP step, 3 at gop 4.
    assert ran == [1, 1, 1, int(not recon), 3 * recon, 3 * recon]
    assert got == want
    for mc in (True, False):
        assert decode_video_sharded(got, nccl_mesh, motioncomp=mc)[0] == (
            host_video.decode_video(got, motioncomp=mc, backend="numpy")[0])


@pytest.mark.parametrize("ref_mode", ["raw", "recon"])
def test_sharded_video_world_of_one_at_720p25(nccl_mesh, ref_mode):
    """bench.py's 1280x720x25 video: encode_video_sharded equals the
    one-device encode_frames on the card, Huffman on and off, and its
    decode the one-device decode_video."""
    from imageencoder_tpu_torch.models.video import encode_frames
    from imageencoder_tpu_torch.parallel import (decode_video_sharded,
                                                 encode_video_sharded)

    w, h, n = 1280, 720, 25
    frames = torch.from_numpy(video_frames(w, h, n, 0)).cuda()
    qp = quant_from_numpy(np.array(JPEG4, np.uint32))
    for huff in (True, False):
        got = encode_video_sharded(frames, qp, nccl_mesh, True, 4, 16,
                                   use_huffman=huff, ref_mode=ref_mode)
        assert got == encode_frames(frames, w, h, qp, True, 4, 16,
                                    use_huffman=huff, ref_mode=ref_mode,
                                    device="cuda")
    assert decode_video_sharded(got, nccl_mesh)[0] == (
        imageencoder_tpu_torch.decode_video(got, device="cuda")[0])
