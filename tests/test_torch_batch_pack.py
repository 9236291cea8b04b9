"""The batch packers on the CPU: K2 over a batch (cuda_pack.pack_locals_
batch, pack_locals_hist_batch) and K4 pack_payload over a batch and over
byte windows (pack_payload_batch, pack_payload_window), whose plain
versions run here, against the JAX package's exact engine
(imageencoder_tpu.encode_image(..., backend="numpy")) and its Huffman
codes, on ragged batches: streams of very different lengths, a stream
with no payload (the raw-copy fallback), the 4 x 128x256 fallback batch
under quant all ones, one stream and 17, windows from a first byte past 0
at odd start bits.

Then a numpy model of the two-launch plan the card runs for K4
pack_payload (csrc/pack.cu: tile_sums_kernel and pack_known_kernel with
PayloadFront::kStrided) against the plain pack on random ragged streams:
which tiles a stream has (the grid is sized by the widest row's words, a
stream's own records bound its tiles), launch 1's strided sums, each
tile's start from every tile sum before it, each thread's consecutive
records, and the words each tile writes whole (those whose first bit it
holds, the last one completed from the records after it, 32 at a time).
The model checks the plan's indexing; the kernels themselves are held
against the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py) and in tools/emulate_pack.py.
"""

import numpy as np
import pytest
import torch

import imageencoder_tpu
from imageencoder_tpu.ops import huffman as jax_huffman
from imageencoder_tpu.utils.quant import QuantMatrix
from imageencoder_tpu_torch import quant_from_numpy
from imageencoder_tpu_torch.models import image
from imageencoder_tpu_torch.ops import (bitpack, cuda_encode, cuda_pack,
                                        device_pack, dict_table, huffman)

from tests.test_torch_image import JPEG4, smooth_image

TILE, ITEMS_BATCH = 256, 4  # pack.cu: kTile, PayloadFront::kItemsBatch


def images(kinds, h: int, w: int, seed: int) -> np.ndarray:
    """Same-shape u8 images of very different content: "smooth", "noise"
    (at these sizes it takes the raw-copy fallback, no byte to code) or
    "flat"."""
    rng = np.random.default_rng(seed)
    out = []
    for k, kind in enumerate(kinds):
        if kind == "noise":
            out.append(rng.integers(0, 256, (h, w), dtype=np.uint8))
        elif kind == "flat":
            out.append(np.full((h, w), 90 + k, np.uint8))
        else:
            out.append(smooth_image(h, w, seed + k))
    return np.stack(out)


def batch_args(imgs: np.ndarray, quant: np.ndarray, use_huffman: bool):
    """K2's arguments for the batch, as models/batch.py::launch_batch
    makes them."""
    b, h, w = imgs.shape
    q = QuantMatrix(np.asarray(quant, np.uint32))
    pq = quant_from_numpy(q.matrix)
    start, header = image.stream_header(pq, True, w, h, use_huffman, "cpu")
    local, lens, _ = cuda_encode.encode_locals(
        torch.from_numpy(imgs.reshape(b * h, w)), pq.as_float(), 4, True,
        "reference")
    n = local.shape[0] // b
    n_words = device_pack.packed_words_bound(n, local.shape[1])
    return q, (local.view(b, n, -1), lens.view(b, n), start, n_words, header)


def host_stream(img, q: QuantMatrix, use_huffman: bool) -> bytes:
    return imageencoder_tpu.encode_image(img, q, use_rle=True,
                                         use_huffman=use_huffman,
                                         norm="reference", block_size=4,
                                         backend="numpy")


CASES = {  # id: image kinds, (H, W), quant
    "ragged": (("smooth", "noise", "flat", "smooth"), (48, 64), JPEG4),
    "fallback_batch": (("smooth", "smooth", "smooth", "noise"), (128, 256),
                       np.ones((4, 4))),
    "one": (("smooth",), (32, 48), JPEG4),
    "seventeen": (tuple(("smooth", "noise", "flat")[k % 3]
                        for k in range(17)), (16, 32), JPEG4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batch_packers_give_the_host_engines_streams(case):
    """K2+hist over the batch, the dict and K4 pack_payload over the batch
    (their plain versions), then the Huffman tail: every stream equals
    the JAX package's exact engine's, coded and fallback alike."""
    kinds, (h, w), quant = CASES[case]
    imgs = images(kinds, h, w, len(kinds))
    q, args = batch_args(imgs, quant, True)
    words, totals, hists = cuda_pack.pack_locals_hist_batch(*args)
    tables = huffman.build_dict_batch(hists, totals)
    n = -(-huffman.payload_words(words.shape[1]) // 4) * 4
    payloads, out_totals = cuda_pack.pack_payload_batch(words, tables, n)
    want = [host_stream(img, q, True) for img in imgs]
    got = huffman.huffman_launch(words, totals, hists).finish()
    assert got == want
    coded = [dict_table.fields(t) for t in tables]
    for k, f in enumerate(coded):
        if not f["fallback"]:
            assert int(out_totals[k]) == f["out_total"]
            assert device_pack.words_to_bytes(
                payloads[k].numpy().view(np.uint32),
                int(out_totals[k])) == want[k]
    if case in ("ragged", "fallback_batch"):
        # Streams of very different lengths, one with nothing to code.
        assert min(f["nbytes"] for f in coded) == 0
        assert max(f["nbytes"] for f in coded) > 0


@pytest.mark.parametrize("case", list(CASES))
def test_k2_batch_alone_gives_the_host_engines_streams(case):
    """K2 over the batch without the histograms (Huffman off): each row's
    words up to its total are the host engine's stream."""
    kinds, (h, w), quant = CASES[case]
    imgs = images(kinds, h, w, 3 + len(kinds))
    q, args = batch_args(imgs, quant, False)
    words, totals = cuda_pack.pack_locals_batch(*args)
    for k, img in enumerate(imgs):
        want = host_stream(img, q, False)
        assert device_pack.words_to_bytes(
            words[k].numpy().view(np.uint32), int(totals[k])) == want


def window_case(seed: int, b: int):
    """B rows of inner words and the tables of byte windows as stage 2
    writes them: each row's codes (the JAX package's, from the row's
    bytes), no dict words, the window [first, nbytes) and an odd start
    bit; one window empty."""
    rng = np.random.default_rng(seed)
    n_w = 40
    words = (rng.integers(0, 2 ** 32, (b, n_w), dtype=np.uint64)
             & 0x0F3FFF1F).astype(np.uint32)
    tables, codes = [], []
    for k in range(b):
        data = words[k].astype(">u4").view(np.uint8)
        freqs = np.bincount(data, minlength=256)
        freqs[[0, 1]] += 1
        _, cw, cl = jax_huffman._dict_and_codes(freqs)
        first = int(rng.integers(1, 9))
        nbytes = first if k == 1 else int(rng.integers(first, 4 * n_w + 1))
        start = 2 * int(rng.integers(0, 16)) + 1
        tables.append(dict_table.make_table(cw, cl, np.zeros(256), "cpu",
                                            dict_bits=start, nbytes=nbytes,
                                            first_byte=first))
        codes.append((cw, cl, first, nbytes, start))
    return words, torch.stack(tables), codes


@pytest.mark.parametrize("b", [1, 3, 17])
def test_pack_payload_window_codes_each_rows_window(b):
    """K4 pack_payload over windows: row k's bytes [first, nbytes) coded
    by the JAX package's codes from its odd start bit, as the sharded
    encode's stage 2 places a segment's owned bytes."""
    words, tables, codes = window_case(b, b)
    got, totals = cuda_pack.pack_payload_window(
        torch.from_numpy(words.view(np.int32)), tables, 64)
    for k, (cw, cl, first, nbytes, start) in enumerate(codes):
        data = words[k].astype(">u4").view(np.uint8)[first:nbytes]
        vals = np.concatenate([[0], cw[data].astype(np.int64)])
        nb = np.concatenate([[start], cl[data].astype(np.int64)])
        want = device_pack.bytes_to_words(bitpack.pack_fields(vals, nb)[0])
        assert int(totals[k]) == start + int(cl[data].sum())
        assert np.array_equal(got[k].numpy()[:len(want)], want)


# ---- the two-launch plan, modelled ----

def record_bits(fields) -> np.ndarray:
    """A record's bits, MSB first: fields [(value, width), ...]."""
    out = [((int(v) >> (nb - 1 - i)) & 1) for v, nb in fields
           for i in range(int(nb))]
    return np.array(out, np.uint8)


def words_of(bits: np.ndarray, lo: int, hi: int, base: int) -> np.ndarray:
    """Words [lo, hi) of a bit run that starts at stream bit ``base``,
    zeros elsewhere."""
    buf = np.zeros(32 * (hi - lo), np.uint8)
    a = base - 32 * lo
    take = bits[max(0, -a):max(0, 32 * (hi - lo) - a)]
    buf[max(a, 0):max(a, 0) + len(take)] = take
    return np.packbits(buf).view(">u4").astype(np.uint32)


def model_plan(streams, starts, threads: int, items: int,
               grid_records: int, n_words: int):
    """The plan csrc/pack.cu runs for K4 pack_payload (PayloadFront::
    kStrided) over a batch of record streams (each a list of records, a
    record a bit array), tiles of threads * items records.  The grid has
    the tiles of grid_records records (what the widest row's words
    allow); a CTA past its own stream's tiles leaves.  Launch 1, a CTA a
    tile: thread i sums records i, i + threads, ... of the tile, and the
    tile's sum is the threads'.  Launch 2, a CTA a tile: the tile starts at
    the stream's start plus every tile sum before it; thread i emits its
    items consecutive records from there plus the threads' bits before
    it, each bit only into the words the tile owns (those whose first bit
    lies in the tile; tile 0 also the word that holds the start); warp 0
    completes the last word from the records after the tile, 32 at a
    time, a record landing only where it starts before the word's end.
    Returns (words [B, n_words] from the tiles' writes, totals, {stream:
    [(tile, w0, w1), ...]}).  Words no tile writes stay all ones."""
    tile = threads * items
    grid = max(1, -(-grid_records // tile))
    out = np.full((len(streams), n_words), 0xFFFFFFFF, np.uint32)
    totals, plan = [], {}
    for k, (recs, start) in enumerate(zip(streams, starts)):
        n = len(recs)
        lens = [len(r) for r in recs]
        tiles = max(1, -(-n // tile))
        assert tiles <= grid
        sums = [sum(sum(lens[r] for r in range(t * tile + i,
                                                min((t + 1) * tile, n),
                                                threads))
                    for i in range(threads)) for t in range(tiles)]
        plan[k] = []
        for t in range(tiles):
            s0 = start + sum(sums[:t])
            s1 = s0 + sums[t]
            w0 = start >> 5 if t == 0 else (s0 + 31) >> 5
            w1 = (s1 + 31) >> 5
            plan[k].append((t, w0, w1))
            span = np.zeros(32 * (w1 - w0), np.uint8)

            def emit(bits, at):
                lo, hi = max(at, 32 * w0), min(at + len(bits), 32 * w1)
                if lo < hi:
                    span[lo - 32 * w0:hi - 32 * w0] = bits[lo - at:hi - at]

            rs = s0
            for i in range(threads):
                for r in range(t * tile + i * items,
                               min(t * tile + (i + 1) * items, n)):
                    emit(recs[r], rs)
                    rs += lens[r]
            assert rs == s1
            need, got, r = 32 * w1 - s1, 0, min((t + 1) * tile, n)
            while w0 < w1 and got < need and r < n:
                upto = np.cumsum(lens[r:r + 32])
                for lane, rec in enumerate(recs[r:r + 32]):
                    at = got + int(upto[lane]) - len(rec)
                    if len(rec) and at < need:
                        emit(rec, s1 + at)
                got += int(upto[-1])
                r += 32
            hi = min(w1, n_words)
            if w0 < hi:
                out[k, w0:hi] = np.packbits(span).view(">u4")[:hi - w0]
        totals.append(start + sum(lens))
        # Tile 0 also writes the words before the start: 0 (no prefix).
        out[k, :start >> 5] = 0
    return out, totals, plan


def plain_words(streams, starts, n_words: int) -> np.ndarray:
    out = np.zeros((len(streams), n_words), np.uint32)
    for k, (recs, start) in enumerate(zip(streams, starts)):
        bits = np.concatenate([np.zeros(start, np.uint8), *recs])
        n = -(-len(bits) // 32)
        out[k, :n] = words_of(bits, 0, n, 0)
    return out


def random_streams(rng, b: int, max_records: int, max_bits: int):
    return [[rng.integers(0, 2, int(rng.integers(0, max_bits + 1)))
             .astype(np.uint8)
             for _ in range(int(rng.integers(0, max_records + 1)))]
            for _ in range(b)]


@pytest.mark.parametrize("seed,b,threads,items", [
    (0, 5, 4, 2), (1, 17, 3, 4), (2, 1, 8, 1), (3, 6, 2, 3)])
def test_tile_plan_writes_each_word_once_and_as_the_plain_pack(
        seed, b, threads, items):
    """The plan on random ragged streams (some empty, some of one record,
    records of 0 bits among them), the grid a tile wider than the widest
    stream: a stream has the tiles its own records need, at least one;
    each tile's start is the sums before it; the tiles' owned words
    partition the stream's words; and what the tiles write equals the
    plain pack, word for word, up to each total."""
    rng = np.random.default_rng(seed)
    tile = threads * items
    streams = random_streams(rng, b, 6 * tile, 70)
    streams[0] = []  # an empty stream: tile 0 alone, the total its start
    starts = [int(s) for s in rng.integers(0, 100, b)]
    n_words = 4 * (-(-max(s + 70 * 6 * tile for s in starts) // 128) + 1)
    got, totals, plan = model_plan(streams, starts, threads, items,
                                   max(map(len, streams)) + tile, n_words)
    want = plain_words(streams, starts, n_words)
    for k, recs in enumerate(streams):
        start, total = starts[k], totals[k]
        assert total == start + sum(len(r) for r in recs)
        assert len(plan[k]) == max(1, -(-len(recs) // tile))
        owned = [w for _, w0, w1 in plan[k] for w in range(w0, w1)]
        assert owned == list(range(start >> 5, (total + 31) >> 5))
        n = (total + 31) >> 5
        assert np.array_equal(got[k, :n], want[k, :n])


def payload_records(words: np.ndarray, table: torch.Tensor):
    """PayloadFront's records of one row: record r is the codes of bytes
    16r .. 16r + 15 inside the table's window, as bits; the records the
    table's byte count asks for."""
    f = dict_table.fields(table)
    cw = table[dict_table.CODE_W:dict_table.CODE_W + 256].numpy()
    cl = table[dict_table.CODE_L:dict_table.CODE_L + 256].numpy()
    data = words.astype(">u4").view(np.uint8)
    nbytes = min(f["nbytes"], len(data))
    first = max(f["first_byte"], 0)
    recs = []
    for r in range(-(-max(nbytes, 0) // 16)):
        idx = [i for i in range(16 * r, 16 * r + 16) if first <= i < nbytes]
        recs.append(record_bits([(cw[data[i]], cl[data[i]]) for i in idx]))
    return recs, f["dict_bits"]


@pytest.mark.parametrize("threads,items", [(TILE, ITEMS_BATCH), (2, 2)])
def test_tile_plan_on_payload_records_is_pack_payload(threads, items):
    """The plan over PayloadFront's records (16 bytes' codes a record) of
    a ragged batch of windows, its grid from the rows' words as the
    card's is, at the card's tile over a batch and at a small one (several
    tiles a row), writes pack_payload_window's words (its plain
    version's)."""
    words, tables, _ = window_case(7, 5)
    streams, starts = zip(*(payload_records(words[k], tables[k])
                            for k in range(len(words))))
    n_words = 64
    got, totals, plan = model_plan(list(streams), list(starts), threads,
                                   items, -(-4 * words.shape[1] // 16),
                                   n_words)
    want, want_t = cuda_pack.pack_payload_window(
        torch.from_numpy(words.view(np.int32)), tables, n_words)
    assert totals == want_t.tolist()
    if threads == 2:
        assert max(len(p) for p in plan.values()) > 1
    for k, t in enumerate(totals):
        n = (t + 31) >> 5
        assert np.array_equal(got[k, :n], want[k, :n].numpy().view(np.uint32))
