"""The whole-stream Huffman encoder.

The counterpart of imageencoder_tpu/ops/huffman.py.  Wire format
(Huffman.cpp:36-46, 233-344): a dict of groups, each [1-bit has-items = 1]
[7-bit group length][4-bit code length] then per entry [8-bit symbol]
[code], ended by one 0 bit; then each input byte replaced by its code,
MSB-first.  When that is not smaller than the input, the stream is
[0 bit][raw input bytes] instead, n + 1 bytes in all.

The host half is the port's copy of the JAX package's: a deterministic
tree build (heap ties broken by frequency, then first symbol), code
lengths limited to 15 bits (JPEG-style adjust), canonical codes and the
serialized dict.  There is no native path.  It is the plain version of the
dict kernel (:func:`build_dict_plain`) and the encode of a CPU tensor.

The device half keeps the stream on the device until its final copy.  The
byte histogram comes from the packer that wrote the inner stream (K2 or K4
pack_coeffs, with K3 folded in; ops/cuda_pack.py), or from K3 for a stream
that arrives packed; the dict kernel (csrc/huffman.cu, :func:`build_dict`)
turns it into the dict table (ops/dict_table.py): codes, dict words, the
out total and the fallback flag; K4's pack_payload front end packs the
payload under the table.  Then the host waits once, for the table's totals
(one small pinned copy), and copies the final words, or on the fallback
flag the inner words, in one exact-size copy.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from ..kernels import build
from . import cuda_kernels, cuda_pack, dict_table
from .bitpack import pack_fields
from .device_pack import bytes_to_words, host_total, stream_bytes, to_device

KEY_BITS = 8
MAX_CODE_LEN = 15  # must fit the 4-bit dict header field
MAX_GROUP = 127  # must fit the 7-bit group length field
DICT_WORDS = dict_table.DICT_WORDS


def code_lengths(freqs: np.ndarray) -> np.ndarray:
    """Huffman code length per symbol (0 for absent ones), at most 15.
    Raises ValueError for fewer than 2 distinct symbols."""
    lengths = _code_lengths_tree(freqs)
    if lengths.max() > MAX_CODE_LEN:
        lengths = _limit_lengths(lengths, MAX_CODE_LEN)
    return lengths


def _code_lengths_tree(freqs: np.ndarray) -> np.ndarray:
    """The Huffman tree's depths (unlimited).  Heap entries are packed
    ints (freq << 17) | (tiebreak << 9) | id, so integer order is the
    (freq, first symbol, id) order."""
    counts = np.asarray(freqs)[:256].tolist()  # Python ints: fast compares
    syms = [s for s, n in enumerate(counts) if n > 0]
    n_syms = len(syms)
    if n_syms < 2:
        raise ValueError("need >= 2 distinct symbols")
    heap = [(counts[s] << 17) | (s << 9) | i for i, s in enumerate(syms)]
    heapq.heapify(heap)
    pop, push = heapq.heappop, heapq.heappush
    children = [None] * (2 * n_syms - 1)
    next_id = n_syms
    while len(heap) > 1:
        e1 = pop(heap)
        e2 = pop(heap)
        tie = min((e1 >> 9) & 0xFF, (e2 >> 9) & 0xFF)
        children[next_id] = (e1 & 0x1FF, e2 & 0x1FF)
        push(heap, (((e1 >> 17) + (e2 >> 17)) << 17) | (tie << 9) | next_id)
        next_id += 1
    # Parents have larger ids than their children: one descending sweep.
    depth = [0] * next_id
    for nid in range(next_id - 1, n_syms - 1, -1):
        left, right = children[nid]
        depth[left] = depth[right] = depth[nid] + 1
    lengths = np.zeros(256, dtype=np.int32)
    lengths[syms] = np.maximum(np.asarray(depth[:n_syms], dtype=np.int32), 1)
    return lengths


def _limit_lengths(lengths: np.ndarray, cap: int) -> np.ndarray:
    """Fold codes longer than ``cap`` back under it, keeping the Kraft sum
    <= 1, then give the shortest lengths to the symbols that had them."""
    hist = np.bincount(lengths[lengths > 0]).astype(np.int64)
    for ln in range(len(hist) - 1, cap, -1):
        while hist[ln] > 1:
            # Move a pair at depth ln up one level, paid for by splitting
            # a code at the deepest occupied depth j <= ln - 2.
            j = ln - 2
            while j > 0 and hist[j] == 0:
                j -= 1
            if j == 0:
                raise ValueError("length-limit rebalance ran out of "
                                 "splittable depths (invalid code profile)")
            hist[ln] -= 2
            hist[ln - 1] += 1
            hist[j + 1] += 2
            hist[j] -= 1
        if hist[ln] == 1:
            raise ValueError("length-limit rebalance left an odd code at "
                             f"depth {ln} (invalid Huffman profile)")
    order = np.argsort(lengths, kind="stable")
    present = order[lengths[order] > 0]
    new_lengths = np.zeros_like(lengths)
    new_lengths[present] = np.repeat(np.arange(len(hist)),
                                     np.maximum(hist, 0))
    return new_lengths


def canonical_codes(lengths: np.ndarray):
    """Canonical codes, shorter first, then by symbol: (words, lengths)."""
    words = np.zeros(256, dtype=np.uint32)
    code = 0
    prev_len = 0
    for ln in np.unique(lengths[lengths > 0]):
        syms = np.nonzero(lengths == ln)[0]
        code <<= int(ln) - prev_len
        prev_len = int(ln)
        words[syms] = code + np.arange(len(syms), dtype=np.uint32)
        code += len(syms)
    return words, lengths


class _FieldSeq:
    """The serialized dict as (value, nbits) fields: ``position`` is its
    length in bits, ``getvalue()`` its bytes."""

    __slots__ = ("values", "nbits", "position")

    def __init__(self, values: np.ndarray, nbits: np.ndarray):
        self.values = values
        self.nbits = nbits
        self.position = int(nbits.sum())

    def getvalue(self) -> bytes:
        return pack_fields(self.values, self.nbits)[0]


def _dict_and_codes(freqs: np.ndarray):
    """(dict fields, code words, code lengths) for a byte histogram, or
    None for fewer than 2 symbols (the caller takes the fallback)."""
    try:
        lengths = code_lengths(freqs)
    except ValueError:
        return None
    words, lengths = canonical_codes(lengths)
    # Groups by code length, longest first (Huffman.cpp:272), entries by
    # symbol, at most MAX_GROUP a group.
    vparts, bparts = [], []
    for ln in np.unique(lengths[lengths > 0])[::-1]:
        syms = np.nonzero(lengths == ln)[0]
        for start in range(0, len(syms), MAX_GROUP):
            chunk = syms[start:start + MAX_GROUP]
            n = len(chunk)
            v = np.empty(2 + 2 * n, dtype=np.int64)
            b = np.empty(2 + 2 * n, dtype=np.int64)
            v[0], b[0] = 0x80 | n, 8  # has-items bit + 7-bit length
            v[1], b[1] = int(ln), 4
            v[2::2], b[2::2] = chunk, KEY_BITS
            v[3::2], b[3::2] = words[chunk], int(ln)
            vparts.append(v)
            bparts.append(b)
    vparts.append(np.zeros(1, dtype=np.int64))  # the closing 0 bit
    bparts.append(np.ones(1, dtype=np.int64))
    return _FieldSeq(np.concatenate(vparts), np.concatenate(bparts)), \
        words, lengths


def _fallback(inner: bytes) -> bytes:
    """[0 bit][raw bytes], padded to len(inner) + 1 bytes."""
    data = np.frombuffer(inner, dtype=np.uint8)
    vals = np.concatenate([[0], data]).astype(np.int64)
    nbits = np.concatenate([[1], np.full(len(data), 8)]).astype(np.int64)
    return pack_fields(vals, nbits, pad_to_bytes=len(inner) + 1)[0]


def payload_words(n_word_lanes: int) -> int:
    """Output words of the payload pack for a W-word inner buffer."""
    return (4 * n_word_lanes * MAX_CODE_LEN) // 32 + DICT_WORDS + 8


def build_dict_plain(hist: torch.Tensor,
                     total_bits: torch.Tensor) -> torch.Tensor:
    """The plain version of the dict kernel, on any device: the table
    (ops/dict_table.py) of :func:`_dict_and_codes` on the histogram
    ``hist`` (any integer dtype, [256]) of an inner stream of
    ``total_bits`` bits (-1 for a refused stream: no dict)."""
    freqs = hist.cpu().numpy().astype(np.int64)
    total = int(total_bits)
    zeros = np.zeros(256, np.int64)
    built = _dict_and_codes(freqs) if total >= 0 else None
    if built is None:
        # Fewer than 2 byte values, or the length limit failed: no dict.
        error = total >= 0 and int((freqs > 0).sum()) >= 2
        return dict_table.make_table(zeros, zeros, zeros, hist.device,
                                     inner_bits=total, fallback=1,
                                     error=int(error))
    w, code_words, lengths = built
    dbuf = np.zeros(DICT_WORDS * 4, dtype=np.uint8)
    dict_stream = w.getvalue()
    dbuf[:len(dict_stream)] = np.frombuffer(dict_stream, dtype=np.uint8)
    out_total = w.position + int(freqs @ lengths.astype(np.int64))
    inner_bytes = (total + 7) // 8
    fallback = inner_bytes < (out_total + 7) // 8
    return dict_table.make_table(
        code_words, lengths, dbuf.view(">u4").astype(np.uint32), hist.device,
        dict_bits=w.position, out_total=out_total, inner_bits=total,
        fallback=int(fallback), nbytes=0 if fallback else inner_bytes)


def build_dict(hist: torch.Tensor, total_bits: torch.Tensor) -> torch.Tensor:
    """The dict table (ops/dict_table.py) of an inner stream's byte
    histogram int32 [256] and its length in bits (an integer tensor of
    one element on the same device).  On a card one launch of
    csrc/huffman.cu, and nothing is read on the host."""
    if hist.device.type == "cpu":
        return build_dict_plain(hist, total_bits)
    dev = hist.device
    build.require(hist, "hist", torch.int32, 1, dev)
    if hist.shape[0] != 256:
        raise ValueError(f"hist: expected 256 bins, got {hist.shape[0]}")
    total = total_bits.reshape(1).to(torch.int64).contiguous()
    build.require(total, "total_bits", torch.int64, 1, dev)
    lib = build.library()
    if lib.ie_dict_table_words() != dict_table.TABLE_WORDS:
        raise RuntimeError("csrc/dict_table.cuh and ops/dict_table.py "
                           "disagree on the table's size")
    table = torch.empty(dict_table.TABLE_WORDS, dtype=torch.int32,
                        device=dev)
    with torch.cuda.device(dev):
        code = lib.ie_huffman_dict(hist.data_ptr(), total.data_ptr(),
                                   table.data_ptr(), build.stream_ptr(dev))
    build.check(code, "ie_huffman_dict")
    build_dict.launches += 1
    return table


build_dict.launches = 0


def read_fields(table: torch.Tensor) -> dict:
    """The table's fields on the host.  On a card one copy into pinned
    memory and the one wait for the device before the stream's copy."""
    meta = dict_table.meta(table)
    if meta.device.type == "cuda":
        host = torch.empty(meta.shape, dtype=meta.dtype, pin_memory=True)
        host.copy_(meta, non_blocking=True)
        torch.cuda.current_stream(meta.device).synchronize()
        meta = host
    return dict(zip(dict_table.META_FIELDS, meta.tolist()))


def huffman_encode_from_hist(words: torch.Tensor, total_bits: torch.Tensor,
                             hist: torch.Tensor) -> bytes:
    """Final stream of an inner stream on the device: its words, its
    length in bits and its byte histogram, as the packers with a histogram
    return them (ops/pipeline.make_encode_packed_hist,
    ops/video_pipeline).

    The dict and the payload pack follow on the device with nothing read
    between them; the compressed size, and so the fallback-if-bigger, is
    known from the histogram alone.  Then the host reads the table's
    totals and one exact-size copy of the final (or, on the fallback, the
    inner) words.
    """
    table = build_dict(hist, total_bits)
    out, _ = cuda_pack.pack_payload(words, table,
                                    payload_words(words.shape[0]))
    meta = read_fields(table)
    inner_bits = host_total(meta["inner_bits"])
    if meta["error"]:
        raise RuntimeError("the Huffman code-length limit found no valid "
                           "code profile for this histogram")
    if meta["fallback"]:
        return _fallback(stream_bytes(words, inner_bits))
    return stream_bytes(out, meta["out_total"])


def huffman_encode_device(words: torch.Tensor, total_bits: int) -> bytes:
    """Huffman over a packed inner stream that has no histogram yet: K3
    counts it, then :func:`huffman_encode_from_hist`."""
    total = to_device(np.array([int(total_bits)], np.int64), words.device)
    return huffman_encode_from_hist(
        words, total, cuda_kernels.byte_histogram(words, total))


def huffman_encode(inner: bytes, device) -> bytes:
    """Huffman over a whole-byte inner stream held on the host (the
    spliced chunks of a long video, a header-only stream): its words go to
    ``device`` and through :func:`huffman_encode_device`, so on a card K3,
    the dict kernel and K4 run and on the CPU their plain versions."""
    words = to_device(bytes_to_words(inner), device)
    return huffman_encode_device(words, 8 * len(inner))
