"""The wire emit's plain version (ops/cuda_pack.py::emit_wire_plain)
against the JAX package's host serialization, byte for byte: its
words_to_bytes (imageencoder_tpu/ops/device_pack.py) for a coded or
Huffman-off stream and its _fallback (imageencoder_tpu/ops/huffman.py)
for one that takes the raw-copy fallback.  Single streams of every
length class around a word, batches that mix the three kinds, a batch of
17, refused streams and failed dicts; the layout rule (wire_offsets)
against where the plain version puts each stream; the tail
(ops/huffman.py::Tail) built on it; and the port's CPU encodes through
that tail against backend="numpy".  Inputs are seeded numpy words."""

import sys

import numpy as np
import pytest
import torch

import imageencoder_tpu
from imageencoder_tpu.models import video as jax_video
from imageencoder_tpu.ops import device_pack as jax_device_pack
from imageencoder_tpu.ops import huffman as jax_huffman
from imageencoder_tpu.utils.quant import QuantMatrix
import imageencoder_tpu_torch as port
from imageencoder_tpu_torch.ops import cuda_pack, dict_table, huffman

W = 140  # words a row: the longest stream below fills every one
# 0 bits, 1-7 bits, whole bytes around 4k-word boundaries (8 (4k - 1),
# 8 4k, 8 (4k + 1) bits), a whole row.
BITS = [0, *range(1, 8),
        *(8 * m for k in (1, 2, 5, 33) for m in (4 * k - 1, 4 * k, 4 * k + 1)),
        32 * W]
ZEROS = np.zeros(256, np.int64)


def words(seed: int, n: int = W) -> torch.Tensor:
    """Random int32 words: every bit past a stream's end is garbage, as
    the packers leave it."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n,
                                         dtype=np.int64).astype(np.int32))


def want(row: torch.Tensor, bits: int, fallback: bool = False) -> bytes:
    """The JAX package's bytes of a stream of ``bits`` bits in ``row``."""
    data = jax_device_pack.words_to_bytes(row.numpy().view(np.uint32), bits)
    return jax_huffman._fallback(data) if fallback else data


def table(inner_bits: int, out_total: int = 0, fallback: int = 0,
          error: int = 0) -> torch.Tensor:
    return dict_table.make_table(ZEROS, ZEROS, ZEROS, "cpu",
                                 inner_bits=inner_bits, out_total=out_total,
                                 fallback=fallback, error=error)


def streams_of(buf: torch.Tensor, sources, n_words: int) -> list[bytes]:
    """Each stream's bytes cut from a wire buffer at the layout's offsets;
    checks that every byte between the streams is zero."""
    nbytes, offsets, end = cuda_pack.wire_layout(sources, n_words)
    assert buf.numel() == cuda_pack.wire_capacity(len(sources), n_words)
    mask = torch.ones(buf.numel(), dtype=torch.bool)
    for at, n in zip(offsets, nbytes):
        assert at % 16 == 0
        mask[at:at + n] = False
    assert not buf[mask].any()
    assert end == (offsets[-1] + nbytes[-1] if nbytes else 0)
    return [buf[at:at + n].numpy().tobytes()
            for at, n in zip(offsets, nbytes)]


@pytest.mark.parametrize("bits", BITS)
def test_a_stream_without_huffman_equals_words_to_bytes(bits):
    row = words(bits)
    buf = cuda_pack.emit_wire_plain(row[None], torch.tensor([bits]))
    assert streams_of(buf, [(bits, False)], W) == [want(row, bits)]


@pytest.mark.parametrize("bits", BITS)
def test_a_coded_stream_equals_words_to_bytes_of_its_payload(bits):
    inner, payload = words(bits), words(bits + 1000, W + 8)
    buf = cuda_pack.emit_wire_plain(inner[None], None,
                                    table(32 * W, out_total=bits)[None],
                                    payload[None])
    assert streams_of(buf, [(bits, False)], W) == [want(payload, bits)]


@pytest.mark.parametrize("bits", BITS)
def test_a_fallback_stream_equals_the_host_fallback(bits):
    inner, payload = words(bits + 2000), words(bits + 3000)
    buf = cuda_pack.emit_wire_plain(inner[None], None,
                                    table(bits, 32 * W, fallback=1)[None],
                                    payload[None])
    got = streams_of(buf, [(bits, True)], W)
    assert got == [want(inner, bits, fallback=True)]
    assert len(got[0]) == (bits + 7) // 8 + 1 and got[0][0] < 0x80


def mixed_tables(n: int, seed: int):
    """n streams of random kinds: coded (out total below the inner
    bits), fallback, a failed dict and a refused stream among them, as
    (tables [n, TABLE_WORDS], the kinds)."""
    rng = np.random.default_rng(seed)
    kinds, rows = [], []
    for k in range(n):
        kind = ("coded", "fallback", "error", "refused")[
            k % 4 if n < 8 else int(rng.choice(4, p=[.45, .45, .05, .05]))]
        inner = int(rng.integers(0, 32 * W + 1))
        out = int(rng.integers(0, inner + 1))
        kinds.append(kind)
        rows.append(table(-1 if kind == "refused" else inner, out,
                          fallback=int(kind in ("fallback", "refused")),
                          error=int(kind == "error")))
    return torch.stack(rows), kinds


@pytest.mark.parametrize("n,seed", [(4, 0), (5, 1), (17, 2), (17, 3)])
def test_a_huffman_batch_of_coded_and_fallback_streams(n, seed):
    tables, kinds = mixed_tables(n, seed)
    inner = torch.stack([words(seed * 100 + k) for k in range(n)])
    payload = torch.stack([words(seed * 100 + 50 + k, W + 4)
                           for k in range(n)])
    buf = cuda_pack.emit_wire_plain(inner, None, tables, payload)
    sources = cuda_pack.wire_sources(None, tables)
    expect = []
    for k, kind in enumerate(kinds):
        f = dict_table.fields(tables[k])
        if kind in ("error", "refused"):
            assert sources[k][0] == -1
            expect.append(b"")
        elif kind == "fallback":
            expect.append(want(inner[k], f["inner_bits"], fallback=True))
        else:
            expect.append(want(payload[k], f["out_total"]))
    assert streams_of(buf, sources, W) == expect


@pytest.mark.parametrize("n,seed", [(3, 4), (17, 5)])
def test_a_batch_without_huffman(n, seed):
    rng = np.random.default_rng(seed)
    totals = rng.integers(0, 32 * W + 1, n)
    totals[1] = -1  # a refused stream: no bytes, its neighbours in place
    rows = torch.stack([words(seed * 100 + k) for k in range(n)])
    buf = cuda_pack.emit_wire_plain(rows, torch.from_numpy(totals))
    sources = [(int(t), False) for t in totals]
    assert streams_of(buf, sources, W) == [
        b"" if t < 0 else want(r, int(t)) for r, t in zip(rows, totals)]


def test_emit_wire_on_the_cpu_is_its_plain_version():
    rows = torch.stack([words(k) for k in range(3)])
    totals = torch.tensor([5, 4480, 17])
    before = cuda_pack.emit_wire.launches
    assert torch.equal(cuda_pack.emit_wire(rows, totals),
                       cuda_pack.emit_wire_plain(rows, totals))
    assert cuda_pack.emit_wire.launches == before


def test_the_offsets_round_each_stream_up_to_16_bytes():
    assert cuda_pack.wire_offsets([0, 1, 15, 16, 17, 0, 3]) == (
        [0, 0, 16, 32, 48, 80, 80], 83)
    assert cuda_pack.wire_offsets([]) == ([], 0)
    assert [cuda_pack.wire_nbytes(b, fb) for b, fb in (
        (0, False), (0, True), (1, False), (8, True), (9, True), (-1, True))
    ] == [0, 1, 1, 2, 3, 0]
    assert cuda_pack.wire_capacity(3, 4) == 3 * 32


def test_the_plain_version_puts_each_stream_at_its_offset():
    bits = [0, 8, 120, 128, 136, 1, 4480]
    rows = torch.stack([words(50 + k) for k in range(len(bits))])
    buf = cuda_pack.emit_wire_plain(rows, torch.tensor(bits))
    offsets, end = cuda_pack.wire_offsets([(b + 7) // 8 for b in bits])
    assert offsets == [0, 0, 16, 32, 48, 80, 96]
    for k, (b, at) in enumerate(zip(bits, offsets)):
        n = (b + 7) // 8
        assert buf[at:at + n].numpy().tobytes() == want(rows[k], b)
    assert end == 96 + 560 and not buf[end:].any()


def test_a_stream_longer_than_its_inner_words_is_refused():
    with pytest.raises(RuntimeError, match="longer than"):
        cuda_pack.emit_wire_plain(words(0, 4)[None], None,
                                  table(128, out_total=200)[None],
                                  words(1, 16)[None])


def test_a_little_endian_view_of_a_word_reverses_its_bytes():
    """The plain version relies on it: it swaps each word's bytes so that
    the view gives them in stream order."""
    assert sys.byteorder == "little"
    word = torch.tensor([0x01020304], dtype=torch.int32)
    assert word.view(torch.uint8).tolist() == [4, 3, 2, 1]
    assert cuda_pack.wire_bytes(word, 32).tolist() == [1, 2, 3, 4]
    assert cuda_pack.wire_bytes(word, 32, True).tolist() == [
        0x00, 0x81, 0x01, 0x82, 0x00]


def test_the_tail_cuts_a_batch_as_the_host_serialization_does():
    rows = torch.stack([words(60 + k) for k in range(4)])
    totals = torch.tensor([0, 33, 4480, 7])
    want_all = [want(r, int(t)) for r, t in zip(rows, totals)]
    assert huffman.Tail(rows, totals).finish() == want_all
    assert huffman.Tail(rows, totals, read=True).finish() == want_all
    assert huffman.Tail(rows, totals, lengths=totals.clone()).finish() == (
        want_all)
    assert huffman.Tail(rows[:0], totals[:0]).finish() == []


def test_the_tail_raises_on_a_refused_stream_or_a_failed_dict():
    rows = torch.stack([words(70 + k) for k in range(2)])
    with pytest.raises(ValueError, match="register file"):
        huffman.Tail(rows, torch.tensor([12, -1])).finish()
    tables = torch.stack([table(100, 50), table(100, error=1)])
    with pytest.raises(RuntimeError, match="length limit"):
        huffman.Tail(rows, None, tables, rows).finish()


JPEG4 = np.array([[16, 11, 10, 16], [12, 12, 14, 19], [14, 13, 16, 24],
                  [14, 17, 22, 29]], np.uint32)


def images(kinds, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(7)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    smooth = 128 + 60 * np.sin(x / 5) * np.cos(y / 7)
    return np.stack([rng.integers(0, 256, (h, w), dtype=np.uint8)
                     if kind == "noise" else np.clip(
                         np.rint(smooth + rng.normal(0, 3, (h, w))), 0,
                         255).astype(np.uint8) for kind in kinds])


@pytest.mark.parametrize("huff", [True, False])
@pytest.mark.parametrize("ones", [True, False])
def test_cpu_batch_and_images_equal_numpy(huff, ones):
    """Coded, fallback (noise under quant all ones) and Huffman-off
    streams through the new tail, against backend="numpy"."""
    q = np.ones((4, 4), np.uint32) if ones else JPEG4
    imgs = images(("smooth", "noise", "smooth"), 64, 96)
    want_all = [imageencoder_tpu.encode_image(im, QuantMatrix(q),
                                              use_huffman=huff,
                                              backend="numpy")
                for im in imgs]
    quant = port.quant_from_numpy(q)
    assert port.encode_image_batch(imgs, quant, use_huffman=huff,
                                   device="cpu") == want_all
    assert [port.encode_image(im, quant, use_huffman=huff, device="cpu")
            for im in imgs] == want_all
    if huff and ones:
        assert [bool(s[0] & 0x80) for s in want_all] == [True, False, True]


def test_cpu_batch_of_zero_images():
    assert port.encode_image_batch(np.zeros((0, 16, 16), np.uint8),
                                   port.quant_from_numpy(JPEG4),
                                   device="cpu") == []


@pytest.mark.parametrize("ref_mode", ["raw", "recon"])
def test_cpu_video_without_huffman_equals_numpy(ref_mode):
    w, h, n = 32, 32, 5
    frames = images(("smooth",) * n, h, w)
    data = b"".join(f.tobytes() + bytes([128]) * (w * h // 2)
                    for f in frames)
    got = port.encode_video(data, w, h, port.quant_from_numpy(JPEG4), True,
                            2, 8, use_huffman=False, ref_mode=ref_mode,
                            device="cpu")
    assert got == bytes(jax_video.encode_video(
        data, w, h, QuantMatrix(JPEG4), True, 2, 8, use_huffman=False,
        backend="numpy", ref_mode=ref_mode))
