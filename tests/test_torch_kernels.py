"""K3 port (imageencoder_tpu_torch/ops/cuda_kernels.py) against the JAX
package, on the CPU, where the wrapper runs its plain version: the byte
histogram equals pallas_kernels.byte_histogram(..., interpret=True) and
pipeline.stream_byte_histogram, with ragged byte counts.  K3 folded into
the packers (cuda_pack.pack_locals_hist, pack_coeffs_hist) counts what K3
counts on the stream they write, whether it ends inside a word or on a
word boundary."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from imageencoder_tpu.ops import pipeline as jax_pipeline
from imageencoder_tpu.ops.pallas_kernels import byte_histogram
from imageencoder_tpu_torch.ops import cuda_encode, cuda_kernels, cuda_pack


def random_words(seed: int, nwords: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # A skewed byte distribution, as packed streams have.
    return (rng.integers(0, 2 ** 32, nwords, dtype=np.uint64)
            & 0x0FFF3FFF).astype(np.uint32)


@pytest.mark.parametrize("seed,nwords,tail", [(0, 10000, 3), (1, 4096, 0),
                                              (2, 100, 1)])
def test_byte_histogram_matches_pallas(seed, nwords, tail):
    words = random_words(seed, nwords)
    nbytes = nwords * 4 - tail
    want = np.asarray(byte_histogram(jnp.asarray(words), nbytes,
                                     interpret=True))
    # A total that is not a whole number of bytes still counts its last one.
    total = torch.tensor(8 * nbytes - 5, dtype=torch.int64)
    got = cuda_kernels.byte_histogram(torch.from_numpy(words.view(np.int32)),
                                      total)
    assert got.dtype == torch.int32 and got.shape == (256,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("total_bits", [0, 1, 8 * 777 + 3, 32 * 2048])
def test_stream_byte_histogram_matches_jax(total_bits):
    words = random_words(5, 2048)
    want = np.asarray(jax_pipeline.stream_byte_histogram(
        jnp.asarray(words), jnp.int32(total_bits)))
    total = torch.tensor(total_bits, dtype=torch.int64)
    hist = cuda_kernels.byte_histogram(torch.from_numpy(words.view(np.int32)),
                                       total)
    assert hist.dtype == torch.int32 and hist.shape == (256,)
    np.testing.assert_array_equal(
        np.concatenate([[total_bits], hist.numpy()]), want)


def test_byte_order_is_big_endian():
    """Byte 0 of the stream is the top byte of word 0, whatever the
    host's endianness."""
    words = torch.tensor([0x01020304], dtype=torch.int64)
    hist = cuda_kernels.byte_histogram(words.to(torch.int32),
                                       torch.tensor(8))  # one byte only
    assert hist[1].item() == 1 and int(hist.sum()) == 1


def random_records(n: int, lw: int, seed: int):
    """Register files of random bits, zero past each record's length."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 32 * lw + 1, n)
    bits = rng.integers(0, 2, (n, 32 * lw), dtype=np.uint8)
    bits[np.arange(32 * lw)[None, :] >= lens[:, None]] = 0
    local = np.packbits(bits, axis=1).view(">u4").astype(np.uint32)
    return (torch.from_numpy(local.view(np.int32)),
            torch.from_numpy(lens.astype(np.int32)))


@pytest.mark.parametrize("end", ["in a byte", "on a byte", "on a word"])
@pytest.mark.parametrize("with_vectors", [False, True])
def test_pack_locals_hist_counts_what_k3_counts(end, with_vectors):
    local, lens = random_records(600, 6, 3)
    bits = int(lens.sum())
    kwargs = {}
    if with_vectors:  # 3 frames of 200 blocks, 7 vectors, gop 2: one P
        kwargs = dict(mvecs=torch.tensor([[[3, -2]] * 7], dtype=torch.int32),
                      n_frames=3, gop=2, mvec_nbits=6)
        bits += 7 * 12
    start = {"in a byte": 3 + ((3 + bits) % 8 == 0),
             "on a byte": (8 - bits % 8) % 8 + 40,
             "on a word": (32 - bits % 32) % 32 + 64}[end]
    if end == "on a byte" and (start + bits) % 32 == 0:
        start += 8
    prefix = torch.full((start // 32 + 1,), -1, dtype=torch.int32)
    words, total, hist = cuda_pack.pack_locals_hist(
        local, lens, start, 600 * 6 + 40, prefix=prefix, **kwargs)
    assert int(total) == start + bits
    assert (int(total) % 32 == 0) == (end == "on a word")
    assert torch.equal(hist, cuda_kernels.byte_histogram(words, total))
    plain = cuda_pack.pack_locals(local, lens, start, 600 * 6 + 40,
                                  prefix=prefix, **kwargs)
    assert torch.equal(words, plain[0]) and int(total) == int(plain[1])


@pytest.mark.parametrize("start", [0, 13, 32 * 3])
def test_pack_coeffs_hist_counts_what_k3_counts(start):
    rng = np.random.default_rng(start)
    n, h, w, gop = 3, 32, 48, 2
    coeffs = torch.from_numpy((rng.integers(-40, 40, (n, h, w))
                               * (rng.random((n, h, w)) < 0.3))
                              .astype(np.int32))
    mvecs = torch.from_numpy(rng.integers(-8, 9, (1, 6, 2)).astype(np.int32))
    args = (coeffs, mvecs, gop, 6, 4, True,
            cuda_encode.video_lw(4, "reference"), start, 4000)
    words, total, hist = cuda_pack.pack_coeffs_hist(*args)
    assert torch.equal(hist, cuda_kernels.byte_histogram(words, total))
    plain = cuda_pack.pack_coeffs(*args)
    assert torch.equal(words, plain[0]) and int(total) == int(plain[1])
