"""The Huffman tail of the port on the CPU, where every kernel wrapper runs
its plain version, against the JAX package:

  * the dict kernel's plain version (huffman.build_dict_plain) writes the
    codes, lengths, dict words and dict bits of the JAX package's
    _dict_and_codes, the out total and the fallback flag of its
    huffman_encode_with_hist, and the byte count K4 codes, on histograms
    with ties, fibonacci counts deep enough for the 15-bit limit,
    geometric counts (up to 2^40; up to 2^30, as a card's int32 histogram
    holds them), uniform counts, two symbols, one, none and all 256 equal;
  * the host tail (huffman_encode_from_hist: dict, payload pack, the
    fields read once, then the final or the fallback copy) equals
    huffman_encode_with_hist, and raises on a refused stream and on a
    failed length limit;
  * encode_image and encode_video through that tail equal the JAX
    package's backend="numpy", the raw-copy fallback image included.
"""

import numpy as np
import pytest

import torch

import imageencoder_tpu
from imageencoder_tpu.models import video as jax_video
from imageencoder_tpu.ops import huffman as jax_huffman
from imageencoder_tpu.utils.quant import QuantMatrix
import imageencoder_tpu_torch
from imageencoder_tpu_torch import quant_from_numpy
from imageencoder_tpu_torch.ops import dict_table, huffman
from imageencoder_tpu_torch.ops.device_pack import bytes_to_words

# No import of JAX itself and no other test module: the card tests
# (tests/test_torch_cuda.py) take their histograms from this file on a
# machine without JAX.

JPEG4 = [[16, 11, 10, 16], [12, 12, 14, 19], [14, 13, 16, 24],
         [14, 17, 22, 29]]


def smooth_image(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth field plus noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    f = (128 + 60 * np.sin(x / 9.0) * np.cos(y / 7.0)
         + rng.normal(0, 6, (h, w)))
    return np.clip(np.rint(f), 0, 255).astype(np.uint8)


def moving_frames(w: int, h: int, n: int, seed: int) -> bytes:
    """YUV420p of 8x8 random blocks moving (2, 3) pixels a frame plus
    noise, the UV planes mid-grey."""
    rng = np.random.default_rng(seed)
    base = np.kron(rng.integers(0, 256, (h // 8, w // 8)), np.ones((8, 8)))
    return b"".join(
        np.clip(np.roll(base, (f * 2, f * 3), (0, 1))
                + rng.normal(0, 3, base.shape), 0, 255).astype(np.uint8)
        .tobytes() + bytes([0x80]) * (w * h // 2) for f in range(n))


def histogram(kind: str, seed: int) -> np.ndarray:
    """int64 [256] byte counts of the given kind."""
    rng = np.random.default_rng(seed)
    f = np.zeros(256, np.int64)
    if kind == "ties":  # few distinct counts: heap ties everywhere
        return rng.choice([0, 1, 2, 3, 8], 256).astype(np.int64)
    if kind == "fibonacci":  # a tree as deep as its symbols: past 15
        a, b = 1, 1
        for s in rng.permutation(256)[:30]:
            f[s] = a
            a, b = b, a + b
        return f
    if kind == "geometric":
        return np.floor(2.0 ** rng.uniform(0, 40, 256)).astype(np.int64)
    if kind == "geometric30":  # counts an int32 histogram holds
        return np.floor(2.0 ** rng.uniform(0, 30, 256)).astype(np.int64)
    if kind == "uniform":
        return rng.integers(0, 10 ** 6, 256).astype(np.int64)
    if kind == "two":
        f[[3, 200]] = [1, 10 ** 9]
        return f
    if kind == "one":
        f[rng.integers(0, 256)] = 77
        return f
    if kind == "none":
        return f
    if kind == "equal":  # all 256 equal: every code 8 bits, the fallback
        return np.full(256, 5, np.int64)
    raise ValueError(kind)


KINDS = [("ties", 0), ("ties", 1), ("fibonacci", 2), ("fibonacci", 3),
         ("geometric", 4), ("geometric30", 5), ("uniform", 6), ("two", 7),
         ("one", 8), ("none", 9), ("equal", 10)]


def jax_dict(freqs: np.ndarray):
    """The JAX package's dict as the table holds it, or None: (code_w,
    code_l, dict words u32 [256], dict bits)."""
    built = jax_huffman._dict_and_codes(freqs)
    if built is None:
        return None
    w, words, lengths = built
    stream = w.getvalue()
    buf = np.zeros(1024, np.uint8)
    buf[:len(stream)] = np.frombuffer(stream, np.uint8)
    return (words.astype(np.int64), lengths.astype(np.int64),
            buf.view(">u4").astype(np.uint32),
            int(np.sum(np.asarray(w.nbits, np.int64))))


def inner_of(freqs: np.ndarray, seed: int) -> bytes:
    """A byte stream with exactly the histogram ``freqs``, shuffled."""
    data = np.repeat(np.arange(256, dtype=np.uint8), freqs)
    return np.random.default_rng(seed).permutation(data).tobytes()


@pytest.mark.parametrize("kind,seed", KINDS)
def test_dict_plain_equals_jax_dict(kind, seed):
    freqs = histogram(kind, seed)
    inner_bytes = int(freqs.sum())
    table = huffman.build_dict_plain(torch.from_numpy(freqs),
                                     torch.tensor(8 * inner_bytes))
    assert table.dtype == torch.int32
    assert table.shape == (dict_table.TABLE_WORDS,)
    got = dict_table.fields(table)
    codes = table[dict_table.CODE_W:dict_table.CODE_W + 256].numpy()
    lens = table[dict_table.CODE_L:dict_table.CODE_L + 256].numpy()
    words = table[dict_table.DICT:dict_table.DICT + 256].numpy()
    want = jax_dict(freqs)
    assert got["inner_bits"] == 8 * inner_bytes and got["error"] == 0
    if want is None:
        assert int((freqs > 0).sum()) < 2
        assert got["fallback"] == 1 and got["nbytes"] == 0
        assert not codes.any() and not lens.any() and not words.any()
        return
    code_w, code_l, dict_words, dict_bits = want
    np.testing.assert_array_equal(codes, code_w)
    np.testing.assert_array_equal(lens, code_l)
    np.testing.assert_array_equal(words.view(np.uint32), dict_words)
    assert lens.max() <= huffman.MAX_CODE_LEN
    out_total = dict_bits + int(freqs @ code_l)
    fallback = inner_bytes < (out_total + 7) // 8
    assert (got["dict_bits"], got["out_total"], got["fallback"],
            got["nbytes"]) == (dict_bits, out_total, int(fallback),
                               0 if fallback else inner_bytes)
    if kind == "equal":
        assert fallback
    if inner_bytes <= 3_000_000:  # the stream JAX would write is that long
        stream = jax_huffman.huffman_encode_with_hist(inner_of(freqs, seed),
                                                      freqs)
        assert len(stream) == (inner_bytes + 1 if fallback
                               else (out_total + 7) // 8)
        assert bool(stream[0] & 0x80) != fallback


def random_histogram(seed: int) -> np.ndarray:
    """Histograms with many equal counts (heap ties) or skewed ones, some
    of them sparse."""
    rng = np.random.default_rng(seed)
    kind = seed % 4
    if kind == 0:
        f = rng.choice([1, 1, 2, 3, 4, 8], 256)
    elif kind == 1:
        f = rng.integers(1, 6, 256)
    elif kind == 2:
        f = np.floor(2.0 ** rng.uniform(0, 30, 256))
    else:
        f = rng.geometric(0.05, 256)
    return (f * (rng.random(256) < rng.uniform(0.02, 1.0))).astype(np.int64)


@pytest.mark.parametrize("kind,seed", [
    (k, s) for k, s in KINDS if k not in ("one", "none")]
    + [("random", s) for s in range(12)])
def test_merged_nodes_come_in_key_order(kind, seed):
    """The dict kernel merges from two queues (the leaves, sorted, and the
    internal nodes in the order made), which equals the heap build only if
    the heap makes its internal nodes in increasing key order: checked on
    the heap build itself (the port's _code_lengths_tree)."""
    import heapq

    freqs = (random_histogram(seed) if kind == "random"
             else histogram(kind, seed))
    syms = [s for s in range(256) if freqs[s] > 0]
    if len(syms) < 2:
        freqs[[0, 1]] += 1
        syms = [s for s in range(256) if freqs[s] > 0]
    heap = [(int(freqs[s]) << 17) | (s << 9) | i for i, s in enumerate(syms)]
    heapq.heapify(heap)
    made = []
    while len(heap) > 1:
        e1, e2 = heapq.heappop(heap), heapq.heappop(heap)
        tie = min((e1 >> 9) & 0xFF, (e2 >> 9) & 0xFF)
        made.append((((e1 >> 17) + (e2 >> 17)) << 17) | (tie << 9)
                    | (len(syms) + len(made)))
        heapq.heappush(heap, made[-1])
    assert made == sorted(made)
    assert len(set(made)) == len(made)


def test_dict_plain_of_a_refused_stream():
    """A stream whose pack refused a record (total -1): no dict, the
    fallback flag, and the total kept for the host to raise on."""
    table = huffman.build_dict_plain(torch.from_numpy(histogram("ties", 0)),
                                     torch.tensor(-1))
    got = dict_table.fields(table)
    assert (got["inner_bits"], got["fallback"], got["nbytes"],
            got["error"]) == (-1, 1, 0, 0)


def test_table_layout_round_trips():
    rng = np.random.default_rng(3)
    parts = [rng.integers(-2 ** 31, 2 ** 31, 256) for _ in range(3)]
    vals = dict(zip(dict_table.META_FIELDS, [7, 2 ** 40, -1, 1, 5, 0, 3]))
    table = dict_table.make_table(*parts, "cpu", **vals)
    assert dict_table.TABLE_WORDS == 784
    assert dict_table.fields(table) == vals
    for at, part in zip((dict_table.CODE_W, dict_table.CODE_L,
                         dict_table.DICT), parts):
        np.testing.assert_array_equal(table[at:at + 256].numpy(),
                                      part.astype(np.int32))
    with pytest.raises(ValueError, match="unknown"):
        dict_table.make_table(*parts, "cpu", start=3)


def words_of(inner: bytes, spare: int):
    """The inner stream as int32 words, with ``spare`` words of garbage
    after it (a worst-case buffer whose tail the packer leaves as it is)."""
    words = bytes_to_words(inner)
    tail = np.full(spare, -1, np.int32)
    return torch.from_numpy(np.concatenate([words, tail]))


STREAMS = {  # name: inner stream bytes
    "skewed": (np.random.default_rng(1).geometric(0.2, 20000) % 256)
    .astype(np.uint8).tobytes(),
    "noise": np.random.default_rng(2).integers(0, 256, 4000, np.uint8)
    .tobytes(),
    "one byte value": bytes([9]) * 999,
    "short": b"\x01\x02\x01",
    "empty": b"",
}


@pytest.mark.parametrize("name", list(STREAMS))
@pytest.mark.parametrize("cut", [0, 5])
def test_encode_from_hist_equals_huffman_encode_with_hist(name, cut):
    """The tail on a stream whose total ends ``cut`` bits short of its
    last byte (the byte still counts)."""
    inner = STREAMS[name]
    total = max(8 * len(inner) - cut, 0)
    words = words_of(inner, 17)
    hist = torch.from_numpy(np.bincount(np.frombuffer(inner, np.uint8),
                                        minlength=256).astype(np.int32))
    got = huffman.huffman_encode_from_hist(words, torch.tensor(total), hist)
    assert got == jax_huffman.huffman_encode(inner)
    assert huffman.huffman_encode_device(words, total) == got


def test_encode_from_hist_raises_on_a_refused_stream():
    words = words_of(b"abc", 3)
    hist = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="register file"):
        huffman.huffman_encode_from_hist(words, torch.tensor(-1), hist)


def test_encode_from_hist_raises_on_a_failed_length_limit(monkeypatch):
    """The length limit's failures, which no Huffman tree reaches, set the
    error word, on which the host raises."""
    def fail(lengths, cap):
        raise ValueError("length-limit rebalance ran out of splittable "
                         "depths")

    monkeypatch.setattr(huffman, "_limit_lengths", fail)
    freqs = histogram("fibonacci", 2)
    inner = inner_of(freqs, 0)
    table = huffman.build_dict_plain(torch.from_numpy(freqs),
                                     torch.tensor(8 * len(inner)))
    assert dict_table.fields(table)["error"] == 1
    with pytest.raises(RuntimeError, match="length limit"):
        huffman.huffman_encode_from_hist(
            words_of(inner, 0), torch.tensor(8 * len(inner)),
            torch.from_numpy(freqs.astype(np.int32)))


@pytest.mark.parametrize("h,w,kind,ones,branch", [
    (64, 96, "smooth", False, "huffman"),
    (20, 24, "smooth", False, "fallback"),  # the dict outweighs the gain
    (128, 256, "noise", True, "fallback"),  # the smoke's fallback image
])
def test_encode_image_tail_equals_jax(h, w, kind, ones, branch):
    img = (np.random.default_rng(9).integers(0, 256, (h, w), np.uint8)
           if kind == "noise" else smooth_image(h, w, h + w))
    q = np.ones((4, 4), np.uint32) if ones else np.array(JPEG4, np.uint32)
    quant = QuantMatrix(q)
    got = imageencoder_tpu_torch.encode_image(img, quant_from_numpy(q),
                                              use_huffman=True, device="cpu")
    assert got == imageencoder_tpu.encode_image(img, quant, use_huffman=True,
                                                backend="numpy")
    assert bool(got[0] & 0x80) == (branch == "huffman")


@pytest.mark.parametrize("ref_mode", ["raw", "recon"])
@pytest.mark.parametrize("gop", [1, 3])
def test_encode_video_tail_equals_jax(ref_mode, gop):
    w, h, n = 32, 32, 5
    data = moving_frames(w, h, n, gop)
    quant = QuantMatrix(np.array(JPEG4, np.uint32))
    got = imageencoder_tpu_torch.encode_video(
        data, w, h, quant_from_numpy(quant.matrix), True, gop, 8,
        use_huffman=True, ref_mode=ref_mode, device="cpu")
    assert got == bytes(jax_video.encode_video(
        data, w, h, quant, True, gop, 8, use_huffman=True, backend="numpy",
        ref_mode=ref_mode))
