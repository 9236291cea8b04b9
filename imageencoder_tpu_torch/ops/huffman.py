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
payload under the table.  :func:`huffman_launch` runs those and copies
the table's totals towards pinned memory without waiting;
:meth:`Tail.finish` waits for them (an event), copies the final words, or
on the fallback flag the inner words, exactly, into pinned memory and
waits for that copy unless it has landed (its event): at most two waits
for the device, none of them for work queued after the stream's.  A
batch of streams (models/batch.py) goes through :func:`build_dict_batch`
and cuda_pack.pack_payload_batch, one launch each, and one
:class:`Tail`: the same waits, whatever the batch's size.

The decode half is the port's copy of the JAX package's host decode:
:func:`parse_dict_bytes`, :func:`validate_dict_entries` (the Python
loop; the same rejections as the native validator, the same class) and
:func:`huffman_decode`, a bit walk to byte alignment and then a byte FSM
over the code tree, every bit to the end of the buffer.  That is the
plain version of the decode kernel (ops/cuda_decode.py), which walks the
same tree through :func:`decode_table`; :func:`head_decode` walks the
table on the host over the first symbols only, for the image header.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from ..kernels import build
from . import cuda_kernels, cuda_pack, dict_table
from ..utils.exceptions import StreamFormatError
from .bitpack import BitReader, pack_fields
from .device_pack import bytes_to_words, host_total, to_device, words_to_bytes

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


def build_dict_batch_plain(hists: torch.Tensor,
                           total_bits: torch.Tensor) -> torch.Tensor:
    """The plain version of the dict kernel over a batch:
    :func:`build_dict_plain`, stream by stream: tables [B, TABLE_WORDS]."""
    return torch.stack([build_dict_plain(h, t)
                        for h, t in zip(hists, total_bits)])


def build_dict_batch(hists: torch.Tensor,
                     total_bits: torch.Tensor) -> torch.Tensor:
    """The dict tables int32 [B, TABLE_WORDS] of B inner streams' byte
    histograms int32 [B, 256] and lengths int64 [B].  On a card one launch
    of csrc/huffman.cu, a CTA a stream: each stream takes its own
    fallback and error word."""
    if hists.dim() != 2 or hists.shape[1] != 256 or (
            total_bits.shape != hists.shape[:1]):
        raise ValueError(f"expected hists [B, 256] and total_bits [B], got "
                         f"{tuple(hists.shape)} and "
                         f"{tuple(total_bits.shape)}")
    if hists.device.type == "cpu":
        return build_dict_batch_plain(hists, total_bits)
    dev = hists.device
    build.require(hists, "hists", torch.int32, 2, dev)
    totals = total_bits.to(torch.int64).contiguous()
    build.require(totals, "total_bits", torch.int64, 1, dev)
    b = hists.shape[0]
    tables = torch.empty((b, dict_table.TABLE_WORDS), dtype=torch.int32,
                         device=dev)
    with torch.cuda.device(dev):
        code = build.library().ie_huffman_dict_batch(
            hists.data_ptr(), totals.data_ptr(), tables.data_ptr(), b,
            build.stream_ptr(dev))
    build.check(code, "ie_huffman_dict_batch")
    build_dict_batch.launches += 1
    return tables


build_dict_batch.launches = 0


def _round4(n: int) -> int:
    return -(-n // 4) * 4


class Tail:
    """Streams on the device on their way to the host: the inner words
    int32 [B, W] and their lengths int64 [B], and with Huffman the dict
    tables [B, TABLE_WORDS] and the payloads [B, P] (ops/dict_table.py:
    each stream's fallback flag picks its inner words or its payload).

    Three steps, each waiting for the device once at most, and never for
    more than the work queued before its own event:

      :meth:`read_lengths`  a copy of the lengths (with Huffman the
                            tables' fields) into pinned memory that does
                            not wait, and an event after it;
      :meth:`copy`          waits on that event, then copies each stream's
                            exact words into one pinned buffer and records
                            an event after them;
      :meth:`result`        waits on that event unless it has fired: the
                            streams' bytes.

    A copy queued before another tail's lengths is complete once those are
    read, so :meth:`result` after the next tail's :meth:`copy` does not
    wait (models/batch.py::encode_image_stream chains its images so).  On
    the CPU every step is a plain read.
    """

    def __init__(self, words: torch.Tensor, total_bits: torch.Tensor,
                 tables: torch.Tensor | None = None,
                 payload: torch.Tensor | None = None):
        self.words, self.total_bits = words, total_bits
        self.tables, self.payload = tables, payload
        self.cuda = words.device.type == "cuda"
        self.lengths = self.lengths_ready = None
        self.buffer = self.copied = self.parts = None

    def read_lengths(self) -> None:
        """Start the copy of what sizes the streams (once)."""
        if self.lengths is not None:
            return
        if self.tables is None:
            src = self.total_bits
        else:
            tw, b = dict_table.TABLE_WORDS, self.tables.shape[0]
            src = self.tables.reshape(-1)[
                dict_table.META:(b - 1) * tw + dict_table.TABLE_WORDS]
        if not self.cuda:
            self.lengths = src.clone()
            return
        self.lengths = torch.empty(src.shape, dtype=src.dtype,
                                   pin_memory=True)
        self.lengths.copy_(src, non_blocking=True)
        self.lengths_ready = torch.cuda.Event()
        self.lengths_ready.record()

    def _sources(self) -> list:
        """Per stream (words, bits, fallback) from the lengths read;
        raises on a refused stream or a failed length limit."""
        self.read_lengths()
        if self.lengths_ready is not None:
            self.lengths_ready.synchronize()
        if self.tables is None:
            return [(w, host_total(t), False)
                    for w, t in zip(self.words, self.lengths.tolist())]
        tw = dict_table.TABLE_WORDS
        flat = self.lengths.numpy()
        parts = []
        for b, (inner, out) in enumerate(zip(self.words, self.payload)):
            meta = dict(zip(dict_table.META_FIELDS, flat[
                b * tw:b * tw + 2 * dict_table.N_META].view(np.int64)
                .tolist()))
            inner_bits = host_total(meta["inner_bits"])
            if meta["error"]:
                raise RuntimeError("the Huffman code-length limit found no "
                                   "valid code profile for this histogram")
            parts.append((inner, inner_bits, True) if meta["fallback"]
                         else (out, meta["out_total"], False))
        return parts

    def copy(self, out: torch.Tensor | None = None) -> None:
        """Wait for the lengths, then copy each stream's words into one
        pinned buffer (``out`` where it is large enough, else a new one,
        kept as :attr:`buffer`) without waiting."""
        parts = self._sources()
        sizes = [((bits + 7) // 8 + 3) // 4 for _, bits, _ in parts]
        if not self.cuda:
            self.parts = [(w[:n], bits, fb)
                          for (w, bits, fb), n in zip(parts, sizes)]
            return
        need = sum(sizes)
        if out is None or out.numel() < need:
            out = torch.empty(max(need, 1), dtype=torch.int32,
                              pin_memory=True)
        self.buffer, self.parts, at = out, [], 0
        for (w, bits, fb), n in zip(parts, sizes):
            dst = out[at:at + n]
            dst.copy_(w[:n], non_blocking=True)
            self.parts.append((dst, bits, fb))
            at += n
        self.copied = torch.cuda.Event()
        self.copied.record()

    def result(self) -> list[bytes]:
        """The streams' bytes, after :meth:`copy`."""
        if self.copied is not None and not self.copied.query():
            self.copied.synchronize()
        got = []
        for words, bits, fb in self.parts:
            data = words_to_bytes(words.numpy().view(np.uint32), bits)
            got.append(_fallback(data) if fb else data)
        return got

    def finish(self) -> list[bytes]:
        """:meth:`copy`, then :meth:`result`."""
        self.copy()
        return self.result()


def huffman_launch(words: torch.Tensor, total_bits: torch.Tensor,
                   hist: torch.Tensor, read: bool = True) -> Tail:
    """The device half of the Huffman tail of an inner stream (words
    int32 [W], total a tensor of one element, histogram int32 [256], as
    the packers with a histogram return them) or of a batch (words [B, W],
    totals [B], histograms [B, 256]): the dict kernel, K4 pack_payload
    and, with ``read``, the lengths' copy (:meth:`Tail.read_lengths`).
    Nothing waits; :meth:`Tail.finish` gives the final streams."""
    if words.dim() == 1:
        table = build_dict(hist, total_bits)
        out, _ = cuda_pack.pack_payload(words, table,
                                        payload_words(words.shape[0]))
        tail = Tail(words[None], total_bits.reshape(1), table[None],
                    out[None])
    else:
        tables = build_dict_batch(hist, total_bits)
        out, _ = cuda_pack.pack_payload_batch(
            words, tables, _round4(payload_words(words.shape[1])))
        tail = Tail(words, total_bits, tables, out)
    if read:
        tail.read_lengths()
    return tail


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
    inner) words: :func:`huffman_launch`, then :meth:`Tail.finish`.
    """
    return huffman_launch(words, total_bits, hist).finish()[0]


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


# ---- decode ----


def parse_dict(reader: BitReader):
    """Read the dict's groups: [(symbol, word, length)]; empty when the
    first flag bit is 0."""
    entries = []
    while reader.get_bit():
        seq_len = reader.get(7)
        bit_len = reader.get(4)
        for _ in range(seq_len):
            sym = reader.get(KEY_BITS)
            word = reader.get(bit_len)
            entries.append((sym, word, bit_len))
    return entries


def parse_dict_bytes(data: bytes):
    """(entries, end_bit) of the dict at the head of a Huffman stream.  A
    dict holds a few hundred bytes at most, so a prefix is read; a dict
    that runs to the prefix's end is read again from the whole stream."""
    prefix = data[:65536]
    reader = BitReader(prefix)
    entries = parse_dict(reader)
    if reader.position >= len(prefix) * 8 and len(data) > len(prefix):
        reader = BitReader(data)
        entries = parse_dict(reader)
    return entries, reader.position


def validate_dict_entries(entries) -> None:
    """Raise StreamFormatError on a dict that no code tree represents: a
    zero-length code (the reference encoder's 4-bit length field wraps 16
    to 0), a duplicate code, or a code that extends or prefixes another.
    The port's encoder writes 15-bit length-limited canonical codes and
    never trips this."""
    children = [[-1, -1]]
    leaf = [False]
    for _sym, word, ln in entries:
        if ln < 1:
            raise StreamFormatError(
                "invalid Huffman dictionary: zero-length code (the "
                "reference encoder's 4-bit length-field wrap, 16 -> 0)")
        node = 0
        for k in range(ln - 1, -1, -1):
            if leaf[node]:
                raise StreamFormatError(
                    "invalid Huffman dictionary: a code extends another "
                    "(non-prefix; reference length-field wrap or corrupt "
                    "stream)")
            bit = (word >> k) & 1
            if children[node][bit] == -1:
                children[node][bit] = len(children)
                children.append([-1, -1])
                leaf.append(False)
            node = children[node][bit]
        if leaf[node] or children[node] != [-1, -1]:
            raise StreamFormatError(
                "invalid Huffman dictionary: duplicate code or a code "
                "that prefixes another (non-prefix dict)")
        leaf[node] = True


def _build_tree(entries):
    """The code tree as lists: children[node][bit] (-1 where absent) and
    symbol[node] (-1 for an inner node); the root is node 0."""
    children = [[-1, -1]]
    symbol = [-1]
    for sym, word, ln in entries:
        node = 0
        for k in range(ln - 1, -1, -1):
            bit = (word >> k) & 1
            if children[node][bit] == -1:
                children.append([-1, -1])
                symbol.append(-1)
                children[node][bit] = len(children) - 1
            node = children[node][bit]
        symbol[node] = sym
    return children, symbol


def _tree_step(children, symbol, node: int, bit: int, out: list) -> int:
    """One bit of the reference walk (Huffman.cpp:376-383): a bit with no
    child is consumed and the walk restarts at the root; a leaf emits its
    symbol and restarts there."""
    nxt = children[node][bit]
    if nxt == -1:
        return 0
    if symbol[nxt] >= 0:
        out.append(symbol[nxt])
        return 0
    return nxt


def _build_fsm(children, symbol):
    """Byte-level FSM over the code tree: for each (node, byte), the node
    the walk ends at and the symbols it emits."""
    step = []
    for state in range(len(children)):
        row = []
        for byte in range(256):
            node, outs = state, []
            for k in range(7, -1, -1):
                node = _tree_step(children, symbol, node, (byte >> k) & 1,
                                  outs)
            row.append((node, tuple(outs)))
        step.append(row)
    return step


def decode_payload(data: bytes, start_bit: int, entries) -> bytes:
    """Every symbol of the bits of ``data`` from ``start_bit`` to the end:
    a bit walk to byte alignment, then the byte FSM.  The padding bits at
    the end may decode to symbols; a code the end cuts off emits
    nothing."""
    children, symbol = _build_tree(entries)
    bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
    pos, node, out = start_bit, 0, []
    while pos % 8 and pos < len(bits):
        node = _tree_step(children, symbol, node, int(bits[pos]), out)
        pos += 1
    fsm = _build_fsm(children, symbol)  # node ids are the FSM's states
    for byte in data[pos // 8:]:
        node, outs = fsm[node][byte]
        out.extend(outs)
    return bytes(out)


def huffman_decode(data: bytes) -> bytes:
    """Decompress a stream whose first bit is 1 (a dict follows), every
    bit to the end of the buffer, like the reference (Huffman.cpp:376-383):
    trailing padding may decode to extra symbols, which the parse after
    it ignores.  Raises ValueError on a stream without a dict and
    StreamFormatError on a dict that no code tree represents."""
    entries, dict_end = parse_dict_bytes(data)
    if not entries:
        raise ValueError("huffman_decode called on a stream without a dict")
    validate_dict_entries(entries)
    return decode_payload(data, dict_end, entries)


TABLE_EMIT = 1 << 12  # decode-table entry: symbol | bits << 8 | emit flag


def decode_table(entries):
    """The decode kernel's form of a validated dict: (table uint16
    [2**L], L, shortest code length), L the longest code length.  Entry
    [v] describes the walk from the root over the L-bit window v: it ends
    at a leaf (symbol | depth << 8 | TABLE_EMIT) or at a bit with no child
    (depth << 8, that bit included, nothing emitted).  Every inner node
    lies above depth L, so every window ends within L bits."""
    children, symbol = _build_tree(entries)
    lengths = [ln for _, _, ln in entries]
    max_len = max(lengths)
    # The walks' window ranges partition [0, 2**L): collect them, then
    # lay them out in order.
    starts, sizes, values = [], [], []
    stack = [(0, 0, 0)]  # node, code, depth
    while stack:
        node, code, depth = stack.pop()
        for bit in (0, 1):
            child, c2, d2 = children[node][bit], (code << 1) | bit, depth + 1
            if child != -1 and symbol[child] < 0:
                stack.append((child, c2, d2))
                continue
            starts.append(c2 << (max_len - d2))
            sizes.append(1 << (max_len - d2))
            values.append(d2 << 8 if child == -1 else
                          TABLE_EMIT | (d2 << 8) | symbol[child])
    order = np.argsort(starts)
    table = np.repeat(np.asarray(values, np.uint16)[order],
                      np.asarray(sizes)[order])
    return table, max_len, min(lengths)


def head_decode(data: bytes, start_bit: int, table: np.ndarray,
                max_len: int, n_symbols: int) -> bytes:
    """The first ``n_symbols`` symbols (fewer where the stream ends) of the
    payload from ``start_bit``, walked through :func:`decode_table`'s
    table on the host: what the decode kernel writes first."""
    nbits = 8 * len(data)
    out = bytearray()
    pos = start_bit
    mask = (1 << max_len) - 1
    while len(out) < n_symbols and pos < nbits:
        byte = pos >> 3
        window = int.from_bytes(data[byte:byte + 3].ljust(3, b"\0"), "big")
        e = int(table[(window >> (24 - (pos & 7) - max_len)) & mask])
        ln = (e >> 8) & 15
        if pos + ln > nbits:  # a code the end cuts off
            break
        pos += ln
        if e & TABLE_EMIT:
            out.append(e & 0xFF)
    return bytes(out)
