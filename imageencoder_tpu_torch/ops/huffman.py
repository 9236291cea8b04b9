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
serialized dict.  There is no native path.

The device half keeps the inner stream on the device: the host reads the
histogram (in ``meta``, or from K3) once, decides the fallback-if-bigger
from it, and then reads the final words once.  K4's pack_payload front
end packs the payload from the inner stream's words.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from . import cuda_kernels, cuda_pack
from .bitpack import pack_fields
from .device_pack import bytes_to_words, host_total, stream_bytes

KEY_BITS = 8
MAX_CODE_LEN = 15  # must fit the 4-bit dict header field
MAX_GROUP = 127  # must fit the 7-bit group length field
DICT_WORDS = 256  # dict upper bound: ~6.1k bits for all 256 symbols


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


def pack_payload(words: torch.Tensor, nbytes: int, code_w: torch.Tensor,
                 code_l: torch.Tensor, start_bit: int,
                 dict_words: torch.Tensor):
    """Replace each of the first ``nbytes`` bytes by its code and pack the
    codes after the dict (start_bit = dict bits), with the dict words in
    the first DICT_WORDS words (K4 pack_payload).

    Returns (words int32 [(4W * 15) // 32 + DICT_WORDS + 8], total_bits).
    """
    return cuda_pack.pack_payload(words, nbytes, code_w, code_l, start_bit,
                                  payload_words(words.shape[0]),
                                  prefix=dict_words)


def bucket_words(words: torch.Tensor, inner_bytes: int) -> torch.Tensor:
    """Trim the worst-case pack buffer to a power-of-two bucket of words
    (imageencoder_tpu huffman.py:561-566): the payload pack's work scales
    with the buffer, not the stream."""
    need = (inner_bytes + 3) // 4
    bucket = 1024
    while bucket < need:
        bucket *= 2
    return words[:bucket] if bucket < words.shape[0] else words


def dict_tensors(built, device):
    """(code_w, code_l, dict_words, dict_bits) on ``device`` for a dict
    built by ``_dict_and_codes``: the per-byte codes and lengths, the
    serialized dict as DICT_WORDS stream words, and its length in bits."""
    w, code_words, lengths = built
    dict_stream = w.getvalue()
    dbuf = np.zeros(DICT_WORDS * 4, dtype=np.uint8)
    dbuf[:len(dict_stream)] = np.frombuffer(dict_stream, dtype=np.uint8)
    dict_words = torch.from_numpy(
        dbuf.view(">u4").astype(np.uint32).view(np.int32)).to(device)
    return (torch.as_tensor(code_words.astype(np.int32), device=device),
            torch.as_tensor(lengths.astype(np.int32), device=device),
            dict_words, w.position)


def _encode_with_dict(words: torch.Tensor, inner_bytes: int, built):
    """Pack the payload under a built dict; returns (out words, out_total)
    still on the device."""
    code_w, code_l, dict_words, dict_bits = dict_tensors(built, words.device)
    return pack_payload(words, inner_bytes, code_w, code_l, dict_bits,
                        dict_words)


def huffman_encode_from_meta(words: torch.Tensor, meta) -> bytes:
    """Final stream from the (words, meta) pair of
    ops/pipeline.make_encode_packed_hist, with meta already on the host
    (meta[0] total_bits, meta[1:] the byte histogram).

    The compressed size is dict_bits + freqs . code_lengths, known on the
    host before any packing, so the fallback-if-bigger is decided first;
    then the payload pack runs on the device and its words come back in
    one exact-size copy.
    """
    meta = np.asarray(meta)
    total_bits = host_total(meta[0])
    freqs = meta[1:]
    inner_bytes = (total_bits + 7) // 8
    built = _dict_and_codes(freqs)
    if built is None:
        return _fallback(stream_bytes(words, total_bits))
    w, _, lengths = built
    out_total = w.position + int(freqs.astype(np.int64) @ lengths)
    if inner_bytes < (out_total + 7) // 8:
        return _fallback(stream_bytes(words, total_bits))
    out, _ = _encode_with_dict(bucket_words(words, inner_bytes), inner_bytes,
                               built)
    return stream_bytes(out, out_total)


def huffman_encode_device(words: torch.Tensor, total_bits: int) -> bytes:
    """Huffman over a packed inner stream that has no histogram yet: runs
    K3 itself (one more round trip than :func:`huffman_encode_from_meta`).
    """
    inner_bytes = (int(total_bits) + 7) // 8
    words = bucket_words(words, inner_bytes)
    total = torch.tensor([int(total_bits)], dtype=torch.int64,
                         device=words.device)
    freqs = cuda_kernels.byte_histogram(words, total).cpu().numpy()
    built = _dict_and_codes(freqs)
    if built is None:
        return _fallback(stream_bytes(words, int(total_bits)))
    out, out_total = _encode_with_dict(words, inner_bytes, built)
    out_total = int(out_total)
    if inner_bytes < (out_total + 7) // 8:
        return _fallback(stream_bytes(words, int(total_bits)))
    return stream_bytes(out, out_total)


def huffman_encode(inner: bytes, device) -> bytes:
    """Huffman over a whole-byte inner stream held on the host (the
    spliced chunks of a long video, a header-only stream): its words go to
    ``device`` and through :func:`huffman_encode_device`, so on a card K3
    and K4 run and on the CPU their plain versions."""
    words = torch.from_numpy(bytes_to_words(inner)).to(device)
    return huffman_encode_device(words, 8 * len(inner))
