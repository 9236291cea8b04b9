"""The port's CUDA kernels against their plain versions, and its
full-size streams against the JAX package's host engine, on the card.

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
from imageencoder_tpu.utils.quant import QuantMatrix
from imageencoder_tpu_torch.ops import cuda_encode, cuda_kernels, cuda_pack

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
])
def test_encode_locals_kernel_equals_plain(dev, h, w, b, norm, use_rle,
                                           qkind):
    img = torch.from_numpy(image(h, w, h + w)).to(dev)
    q = quant_for(b, qkind)
    before = cuda_encode.encode_locals.launches
    got = cuda_encode.encode_locals(img, q, b, use_rle, norm)
    want = cuda_encode.encode_locals_plain(img, q, b, use_rle, norm)
    assert cuda_encode.encode_locals.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("start", [0, 37, 2047])
def test_pack_locals_kernel_equals_plain(dev, start):
    img = torch.from_numpy(image(128, 64, 5)).to(dev)
    local, lens = cuda_encode.encode_locals(img, quant_for(4))
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
    got = cuda_pack.pack_records(vals, nbits, start, nw)
    want = cuda_pack.pack_records_plain(vals, nbits, start, nw)
    assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])


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
        img, quant, use_rle=use_rle, use_huffman=use_huffman, device=dev)
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
        img, quant, use_huffman=use_huffman, device=dev)
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
