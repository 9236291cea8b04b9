"""K2 and K4: the bitstream packers.

The counterpart of imageencoder_tpu/ops/pallas_pack.py:

  * :func:`pack_locals` (K2, pack_locals_pallas) concatenates register
    files and bit lengths from the encode front end (ops/cuda_encode.py)
    and, for a video, each P-frame's motion-vector records before the
    frame's blocks, read from the vectors where they lie;
    :func:`pack_locals_hist` also counts the byte histogram of the stream
    it writes (K3, pallas_kernels.byte_histogram, folded in);
    :func:`pack_locals_batch` and :func:`pack_locals_hist_batch` take a
    batch of image streams in the same two launches, and
    :func:`pack_segments` a sharded stream's segments, each from its own
    start bit;
  * K4 (pack_records_pallas) has three front ends on K2's two launches,
    each of which reads its records' fields where they already are:
    :func:`pack_records` [N, F] field tensors of (value, nbits) pairs,
    fields at most 16 bits wide (:func:`pack_records_segments` B segments
    of them, each from its own start bit); :func:`pack_payload` the
    Huffman payload, each stream byte replaced by its code
    (huffman._device_stages.pack_payload), under the dict kernel's table
    (ops/dict_table.py); :func:`pack_payload_batch` a batch of payloads,
    :func:`pack_payload_window` a batch of byte windows, each at its own
    start bit (the sharded Huffman stage); and :func:`pack_coeffs` a recon
    video's motion-vector and block records from its coefficient tensor
    (pipeline.fields_from_coeffs and the vector fields, then the pack),
    launch 1 summing the record lengths the transform wrote beside the
    coefficients, and :func:`pack_coeffs_hist` the same with the
    stream's byte histogram.

The batched entries (the serving path, models/batch.py) give each stream
its own row of words, starting on a word boundary: no word holds bits of
two streams.  Their plain versions are the single-stream plain versions,
stream by stream.  On the card a row must be a whole number of 16-byte
vectors (``n_words`` and the payload's input width multiples of 4).

All return (words int32 [n_words], total_bits int64 0-d tensor, start_bit
included, -1 where a record was refused), the ``_hist`` ones also the
histogram int32 [256] of the stream's first ceil(total_bits / 8) bytes
(undefined for a refused stream); the words are the u32 stream,
MSB-first.  ``prefix`` words, the header or dict bits that lie before
``start_bit``, are OR'd into the first words.  On a CPU tensor the
wrappers run the plain versions, which return zeros past the stream.  On
a CUDA tensor they launch csrc/pack.cu, which writes the stream's words up
to its last one and leaves the rest of the buffer as allocated
(:func:`stream_words` is the part that is defined).  The wrappers run
nothing on the device but their kernels (no scratch to clear), and the
total and every start stay there: nothing waits on the host.

:func:`emit_wire` (csrc/wire.cu) replaces no TPU kernel: it writes the
packers' final streams, one or a batch, as wire-order bytes on the card,
where the JAX package serializes words on the host
(imageencoder_tpu/ops/device_pack.py:261 words_to_bytes, and
ops/huffman.py:295 _fallback for a stream that takes the raw-copy
fallback).  :func:`wire_offsets` is the layout both it and the host use.
"""

from __future__ import annotations

import sys

import torch

from ..kernels import build
from . import cuda_encode, device_pack, dict_table, rle
from .cuda_kernels import byte_histogram_plain
from .motion import p_frames
from .zigzag import zigzag_order

def stream_words(words: torch.Tensor, total_bits) -> torch.Tensor:
    """The words that hold a stream of ``total_bits`` bits (0 for a
    refused one): the part of a pack's output that every version defines.
    Reads the total on the host."""
    total = max(int(total_bits), 0)
    return words[:(total + 31) // 32]


def mvec_words(mvec: torch.Tensor, mvec_nbits: int) -> torch.Tensor:
    """Motion vectors int32 [..., 2] -> their record as one MSB-first word
    (int32 bits): x then y, mvec_nbits two's-complement bits each
    (pallas_encode.py::mvec_locals)."""
    nb = mvec_nbits
    m = mvec.to(torch.int64) & ((1 << nb) - 1)
    return device_pack.as_int32((m[..., 0] << (32 - nb))
                                | (m[..., 1] << (32 - 2 * nb)))


def merged_locals(local, lens, mvecs, n_frames: int, gop: int,
                  mvec_nbits: int):
    """A video's records in stream order as one register-file tensor:
    per frame, its macroblocks' vector records (one word each; zero length
    on an I-frame, f % gop == 0), then its block records.  local int32
    [F * n_micro, lw], lens int32 [F * n_micro], mvecs int32
    [P, n_macro, 2] -> (int32 [F * (n_macro + n_micro), lw], int32 [...])."""
    f = n_frames
    dev = local.device
    lw = local.shape[1]
    n_macro = mvecs.shape[1]
    mlocal = torch.zeros((f, n_macro, lw), dtype=torch.int32, device=dev)
    mlens = torch.zeros((f, n_macro), dtype=torch.int32, device=dev)
    p_idx = p_frames(f, gop)
    if p_idx and n_macro:
        pi = torch.tensor(p_idx, device=dev)
        mlocal[pi, :, 0] = mvec_words(mvecs, mvec_nbits)
        mlens[pi] = 2 * mvec_nbits
    merged = torch.cat([mlocal, local.view(f, -1, lw)], dim=1)
    merged_lens = torch.cat([mlens, lens.view(f, -1)], dim=1)
    return merged.reshape(-1, lw), merged_lens.reshape(-1)


def pack_locals_plain(local, lens, start_bit: int, n_words: int,
                      prefix=None, mvecs=None, n_frames: int = 1,
                      gop: int = 1, mvec_nbits: int = 0):
    """The plain version of K2, on any device: the vector records, where
    given, merged in by copies (:func:`merged_locals`), then the plain
    packer; total -1 where a record is longer than its register file."""
    refused = ((lens < 0) | (lens > 32 * local.shape[1])).any()
    if mvecs is not None:
        local, lens = merged_locals(local, lens, mvecs, n_frames, gop,
                                    mvec_nbits)
    words, total = device_pack.merge_records(
        device_pack.as_uint(local), lens, start_bit, n_words, prefix)
    return words, torch.where(refused, -1, total)


def pack_locals_hist_plain(*args, **kwargs):
    """The plain version of K2 with its histogram: the plain pack, then
    K3's plain version over the stream it wrote."""
    words, total = pack_locals_plain(*args, **kwargs)
    return words, total, byte_histogram_plain(words, total)


def _check_vectors(local, mvecs, n_frames: int, gop: int,
                   mvec_nbits: int) -> None:
    if mvecs.dim() != 3 or mvecs.shape[2] != 2:
        raise ValueError(f"mvecs: expected [P, n_macro, 2], got "
                         f"{tuple(mvecs.shape)}")
    if gop < 1:
        raise ValueError(f"gop must be at least 1, got {gop}")
    n_p = len(p_frames(n_frames, gop))
    if mvecs.shape[0] != n_p:
        raise ValueError(f"mvecs has {mvecs.shape[0]} frames, a video of "
                         f"{n_frames} frames in GOPs of {gop} has {n_p} "
                         f"P-frames")
    if n_frames < 1 or local.shape[0] % n_frames:
        raise ValueError(f"{local.shape[0]} block records do not split "
                         f"into {n_frames} frames")
    if mvecs.shape[1] and not 1 <= mvec_nbits <= 16:
        raise ValueError(f"mvec_nbits must be 1..16, got {mvec_nbits}")


def pack_locals(local: torch.Tensor, lens: torch.Tensor, start_bit: int,
                n_words: int, prefix: torch.Tensor | None = None,
                mvecs: torch.Tensor | None = None, n_frames: int = 1,
                gop: int = 1, mvec_nbits: int = 0):
    """Pack register files int32 [N, lw] with bit lengths int32 [N].

    With ``mvecs`` (int32 [P, n_macro, 2]) the records are a video's, of
    ``n_frames`` frames in GOPs of ``gop``: each P-frame's (f % gop != 0)
    n_macro vector records, x then y at ``mvec_nbits`` bits each, go
    before the frame's N / n_frames block records.  A record longer than
    its register file (one K1 refused) makes the total -1."""
    return _pack_locals(pack_locals, False, local, lens, start_bit, n_words,
                        prefix, mvecs, n_frames, gop, mvec_nbits)


pack_locals.launches = 0


def pack_locals_hist(local: torch.Tensor, lens: torch.Tensor,
                     start_bit: int, n_words: int,
                     prefix: torch.Tensor | None = None,
                     mvecs: torch.Tensor | None = None, n_frames: int = 1,
                     gop: int = 1, mvec_nbits: int = 0):
    """:func:`pack_locals` that also counts the byte histogram of the
    stream it writes, in the same two launches: (words, total_bits, hist
    int32 [256])."""
    return _pack_locals(pack_locals_hist, True, local, lens, start_bit,
                        n_words, prefix, mvecs, n_frames, gop, mvec_nbits)


pack_locals_hist.launches = 0


def _stacked(outs) -> tuple:
    """Per-stream outputs [(a, b, ...), ...] as (stack(a), stack(b), ...)."""
    return tuple(torch.stack(parts) for parts in zip(*outs))


def pack_locals_batch_plain(local, lens, start_bit: int, n_words: int,
                            prefix=None):
    """The plain version of K2 over a batch: :func:`pack_locals_plain`,
    stream by stream."""
    return _stacked(pack_locals_plain(lo, ln, start_bit, n_words, prefix)
                    for lo, ln in zip(local, lens))


def pack_locals_hist_batch_plain(local, lens, start_bit: int, n_words: int,
                                 prefix=None):
    """The plain version of K2 with its histogram over a batch:
    :func:`pack_locals_hist_plain`, stream by stream."""
    return _stacked(pack_locals_hist_plain(lo, ln, start_bit, n_words, prefix)
                    for lo, ln in zip(local, lens))


def pack_locals_batch(local: torch.Tensor, lens: torch.Tensor,
                      start_bit: int, n_words: int,
                      prefix: torch.Tensor | None = None):
    """K2 over B image streams: register files int32 [B, N, lw] and bit
    lengths int32 [B, N] -> (words int32 [B, n_words], each stream in its
    row from ``start_bit`` behind ``prefix``; totals int64 [B], -1 for a
    stream with a refused record).  K2's two launches, whatever B is."""
    return _pack_locals_batch(pack_locals_batch, False, local, lens,
                              start_bit, n_words, prefix)


pack_locals_batch.launches = 0


def pack_locals_hist_batch(local: torch.Tensor, lens: torch.Tensor,
                           start_bit: int, n_words: int,
                           prefix: torch.Tensor | None = None):
    """:func:`pack_locals_batch` that also counts each stream's byte
    histogram, in the same two launches: (words, totals, hists int32
    [B, 256])."""
    return _pack_locals_batch(pack_locals_hist_batch, True, local, lens,
                              start_bit, n_words, prefix)


pack_locals_hist_batch.launches = 0


def pack_segments_plain(local, lens, starts, n_words: int):
    """The plain version of K2 over segments: :func:`pack_locals_plain`,
    segment by segment, each from its own start bit."""
    return _stacked(pack_locals_plain(lo, ln, int(s), n_words)
                    for lo, ln, s in zip(local, lens, starts.tolist()))


def pack_segments(local: torch.Tensor, lens: torch.Tensor,
                  starts: torch.Tensor, n_words: int):
    """K2 over the B segments of a sharded stream (parallel/sharding.py):
    register files int32 [B, N, lw] and bit lengths int32 [B, N], segment
    k from its own start bit ``starts[k]`` (int64 [B] on the device: the
    segment's bit phase in the stream) in its own row -> (words int32
    [B, n_words], totals int64 [B]).  The batch's two launches."""
    if not isinstance(starts, torch.Tensor) or starts.shape != lens.shape[:1]:
        raise ValueError(f"starts: expected a tensor [{lens.shape[0]}]")
    return _pack_locals_batch(pack_segments, False, local, lens, starts,
                              n_words, None)


pack_segments.launches = 0


def _pack_locals_batch(counter, hist: bool, local, lens, start_bit,
                       n_words: int, prefix):
    """K2 over a batch, with or without the histograms, from one start
    bit or (a tensor) one a stream; a launch counts on ``counter``."""
    if local.dim() != 3 or lens.shape != local.shape[:2]:
        raise ValueError(f"expected local [B, N, lw] and lens [B, N], got "
                         f"{tuple(local.shape)} and {tuple(lens.shape)}")
    starts = start_bit if isinstance(start_bit, torch.Tensor) else None
    if local.device.type == "cpu":
        if starts is not None:
            return pack_segments_plain(local, lens, starts, n_words)
        plain = (pack_locals_hist_batch_plain if hist
                 else pack_locals_batch_plain)
        return plain(local, lens, start_bit, n_words, prefix)
    dev = local.device
    build.require(local, "local", torch.int32, 3, dev)
    build.require(lens, "lens", torch.int32, 2, dev)
    if n_words % 4:
        raise ValueError(f"n_words must be a multiple of 4, got {n_words}")
    b, n, lw = local.shape
    prefix_ptr, prefix_words = _prefix(prefix, dev)
    if starts is not None:
        starts = starts.to(torch.int64).contiguous()
        build.require(starts, "starts", torch.int64, 1, dev)
        start_bit = 0
    lib = build.library()
    sums = torch.empty(b * lib.ie_pack_locals_scratch(n, lw),
                       dtype=torch.int64, device=dev)
    total = torch.empty(b, dtype=torch.int64, device=dev)
    out = torch.empty((b, n_words), dtype=torch.int32, device=dev)
    bins = (torch.empty((b, 256), dtype=torch.int32, device=dev) if hist
            else None)
    with torch.cuda.device(dev):
        code = lib.ie_pack_locals_batch(
            local.data_ptr(), lens.data_ptr(), n, lw, b, start_bit,
            None if starts is None else starts.data_ptr(), prefix_ptr,
            prefix_words, out.data_ptr(), n_words,
            sums.data_ptr(), total.data_ptr(),
            bins.data_ptr() if hist else None, build.stream_ptr(dev))
    build.check(code, "ie_pack_locals_batch")
    counter.launches += 1
    return (out, total) + ((bins,) if hist else ())


def _pack_locals(counter, hist: bool, local, lens, start_bit: int,
                 n_words: int, prefix, mvecs, n_frames: int, gop: int,
                 mvec_nbits: int):
    """K2 with or without the histogram; a launch counts on ``counter``."""
    if local.dim() != 2 or lens.shape != local.shape[:1]:
        raise ValueError(f"expected local [N, lw] and lens [N], got "
                         f"{tuple(local.shape)} and {tuple(lens.shape)}")
    if mvecs is not None:
        _check_vectors(local, mvecs, n_frames, gop, mvec_nbits)
    if local.device.type == "cpu":
        plain = pack_locals_hist_plain if hist else pack_locals_plain
        return plain(local, lens, start_bit, n_words, prefix, mvecs,
                     n_frames, gop, mvec_nbits)
    dev = local.device
    build.require(local, "local", torch.int32, 2, dev)
    build.require(lens, "lens", torch.int32, 1, dev)
    n, lw = local.shape
    n_macro, mvec_ptr = 0, None
    if mvecs is not None and mvecs.shape[1]:
        build.require(mvecs, "mvecs", torch.int32, 3, dev)
        if mvecs.numel():
            build.require_aligned(mvecs, "mvecs", 8)
        n_macro, mvec_ptr = mvecs.shape[1], mvecs.data_ptr()
    prefix_ptr, prefix_words = None, 0
    if prefix is not None:
        build.require(prefix, "prefix", torch.int32, 1, dev)
        prefix_ptr, prefix_words = prefix.data_ptr(), prefix.shape[0]
    lib = build.library()
    sums = torch.empty(lib.ie_pack_locals_scratch(n + n_frames * n_macro, lw),
                       dtype=torch.int64, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    out = torch.empty(n_words, dtype=torch.int32, device=dev)
    bins = torch.empty(256, dtype=torch.int32, device=dev) if hist else None
    with torch.cuda.device(dev):
        code = lib.ie_pack_locals(
            local.data_ptr(), lens.data_ptr(), n, lw, mvec_ptr, n_frames,
            n_macro, gop, mvec_nbits, start_bit, prefix_ptr, prefix_words,
            out.data_ptr(), n_words, sums.data_ptr(), total.data_ptr(),
            bins.data_ptr() if hist else None, build.stream_ptr(dev))
    build.check(code, "ie_pack_locals")
    counter.launches += 1
    return (out, total.reshape(())) + ((bins,) if hist else ())


def _prefix(prefix, dev):
    """(pointer, words) of the prefix a K4 front end ORs in, or (None, 0)."""
    if prefix is None:
        return None, 0
    build.require(prefix, "prefix", torch.int32, 1, dev)
    return prefix.data_ptr(), prefix.shape[0]


def pack_records_plain(vals, nbits, start_bit: int, n_words: int,
                       prefix=None):
    """The plain version of K4 pack_records, on any device."""
    return device_pack.pack_blocks(vals, nbits, start_bit, n_words, prefix)


def pack_records(vals: torch.Tensor, nbits: torch.Tensor, start_bit: int,
                 n_words: int, prefix: torch.Tensor | None = None):
    """Pack [N, F] int32 fields (values, widths 0..16; width 0 = skip).
    On the card a width outside 0..16 makes the total -1.  K2's two
    launches: the first sums each tile's widths, the second packs with
    every tile's start known."""
    if vals.device.type == "cpu":
        return pack_records_plain(vals, nbits, start_bit, n_words, prefix)
    dev = vals.device
    build.require(vals, "vals", torch.int32, 2, dev)
    build.require(nbits, "nbits", torch.int32, 2, dev)
    if nbits.shape != vals.shape:
        raise ValueError(f"nbits {tuple(nbits.shape)} != vals "
                         f"{tuple(vals.shape)}")
    n, f = vals.shape
    lib = build.library()
    sums = torch.empty(lib.ie_pack_records_scratch(n), dtype=torch.int64,
                       device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    out = torch.empty(n_words, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = lib.ie_pack_records(
            vals.data_ptr(), nbits.data_ptr(), n, f, start_bit,
            *_prefix(prefix, dev), out.data_ptr(), n_words, sums.data_ptr(),
            total.data_ptr(), build.stream_ptr(dev))
    build.check(code, "ie_pack_records")
    pack_records.launches += 1
    return out, total.reshape(())


pack_records.launches = 0


def pack_records_segments_plain(vals, nbits, starts, n_words: int):
    """The plain version of K4 pack_records over segments:
    :func:`pack_records_plain`, segment by segment, each from its own
    start bit."""
    return _stacked(pack_records_plain(v, nb, int(s), n_words)
                    for v, nb, s in zip(vals, nbits, starts.tolist()))


def pack_records_segments(vals: torch.Tensor, nbits: torch.Tensor,
                          starts: torch.Tensor, n_words: int):
    """K4 pack_records over B segments: [B, N, F] int32 fields (values,
    widths 0..16), segment k from its own start bit ``starts[k]`` (int64
    [B] on the device: its bit phase in the stream it joins) in its own
    row -> (words int32 [B, n_words], totals int64 [B]).  One stream's two
    launches, whatever B is (the sharded video's vector segments,
    parallel/video_sharding.py)."""
    if vals.dim() != 3 or nbits.shape != vals.shape:
        raise ValueError(f"expected vals and nbits [B, N, F], got "
                         f"{tuple(vals.shape)} and {tuple(nbits.shape)}")
    if not isinstance(starts, torch.Tensor) or starts.shape != vals.shape[:1]:
        raise ValueError(f"starts: expected a tensor [{vals.shape[0]}]")
    if vals.device.type == "cpu":
        return pack_records_segments_plain(vals, nbits, starts, n_words)
    dev = vals.device
    build.require(vals, "vals", torch.int32, 3, dev)
    build.require(nbits, "nbits", torch.int32, 3, dev)
    starts = starts.to(torch.int64).contiguous()
    build.require(starts, "starts", torch.int64, 1, dev)
    if n_words % 4:
        raise ValueError(f"n_words must be a multiple of 4, got {n_words}")
    b, n, f = vals.shape
    lib = build.library()
    sums = torch.empty(b * lib.ie_pack_records_scratch(n),
                       dtype=torch.int64, device=dev)
    total = torch.empty(b, dtype=torch.int64, device=dev)
    out = torch.empty((b, n_words), dtype=torch.int32, device=dev)
    if b:
        with torch.cuda.device(dev):
            code = lib.ie_pack_records_segments(
                vals.data_ptr(), nbits.data_ptr(), n, f, b, starts.data_ptr(),
                out.data_ptr(), n_words, sums.data_ptr(), total.data_ptr(),
                build.stream_ptr(dev))
        build.check(code, "ie_pack_records_segments")
        pack_records_segments.launches += 1
    return out, total


pack_records_segments.launches = 0


def payload_fields(words: torch.Tensor, nbytes: int, code_w: torch.Tensor,
                   code_l: torch.Tensor, first: int = 0):
    """The Huffman payload as pack_records records: each of the bytes
    [first, nbytes) replaced by its (code, length), 16 bytes per record;
    the bytes outside them get length 0.  Returns (vals, nbits) int32
    [ceil(4W/16), 16]."""
    data = device_pack.words_to_u8(words)
    n_lanes = data.shape[0]
    idx = torch.arange(n_lanes, device=words.device)
    vals = code_w[data].to(torch.int32)
    live = (idx >= first) & (idx < nbytes)
    nbits = torch.where(live, code_l[data], 0).to(torch.int32)
    rows = -(-n_lanes // 16)
    pad = rows * 16 - n_lanes
    vals = torch.nn.functional.pad(vals, (0, pad)).reshape(rows, 16)
    nbits = torch.nn.functional.pad(nbits, (0, pad)).reshape(rows, 16)
    return vals.contiguous(), nbits.contiguous()


def pack_payload_plain(words, table, n_words: int):
    """The plain version of K4 pack_payload, on any device (it reads the
    table's fields on the host)."""
    t = dict_table
    meta = t.fields(table)
    nbytes = min(meta["nbytes"], 4 * words.shape[0])
    vals, nbits = payload_fields(words, nbytes, table[t.CODE_W:t.CODE_W + 256],
                                 table[t.CODE_L:t.CODE_L + 256],
                                 max(meta["first_byte"], 0))
    return pack_records_plain(vals, nbits, meta["dict_bits"], n_words,
                              table[t.DICT:t.DICT + t.DICT_WORDS])


def pack_payload(words: torch.Tensor, table: torch.Tensor, n_words: int):
    """Pack the Huffman payload of the inner stream ``words`` (int32 [W],
    u32 bits) under the dict kernel's ``table`` (ops/dict_table.py): each
    of the stream's bytes [first_byte, nbytes) (fields of the table, the
    first 0 from the dict kernel), in stream order, replaced by its code of
    the table (lengths at most 16), 16 bytes a record, after the dict's
    bits, the dict's words OR'd into the first words.  Nothing of the table
    is read on the host.  K2's two launches: the first sums each tile's
    code lengths, the second packs with every tile's start known."""
    if words.device.type == "cpu":
        return pack_payload_plain(words, table, n_words)
    dev = words.device
    build.require(words, "words", torch.int32, 1, dev)
    build.require_aligned(words, "words")
    build.require(table, "table", torch.int32, 1, dev)
    build.require_aligned(table, "table", 8)
    if table.shape[0] != dict_table.TABLE_WORDS:
        raise ValueError(f"table: expected {dict_table.TABLE_WORDS} words, "
                         f"got {table.shape[0]}")
    n_in = words.shape[0]
    lib = build.library()
    sums = torch.empty(lib.ie_pack_payload_scratch(n_in), dtype=torch.int64,
                       device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    out = torch.empty(n_words, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = lib.ie_pack_payload(words.data_ptr(), n_in, table.data_ptr(),
                                   out.data_ptr(), n_words, sums.data_ptr(),
                                   total.data_ptr(), build.stream_ptr(dev))
    build.check(code, "ie_pack_payload")
    pack_payload.launches += 1
    return out, total.reshape(())


pack_payload.launches = 0


def pack_payload_batch_plain(words, tables, n_words: int):
    """The plain version of K4 pack_payload over a batch:
    :func:`pack_payload_plain`, stream by stream."""
    return _stacked(pack_payload_plain(w, t, n_words)
                    for w, t in zip(words, tables))


def pack_payload_batch(words: torch.Tensor, tables: torch.Tensor,
                       n_words: int):
    """:func:`pack_payload` of B inner streams int32 [B, W] under their
    dict tables int32 [B, TABLE_WORDS]: (payloads int32 [B, n_words],
    totals int64 [B]).  K2's two launches, whatever B is: the first sums
    each tile's code lengths, the second packs with every tile's start
    known; each stream packs its own table's byte count, and the CTAs
    past it leave."""
    return _pack_payload_batch(pack_payload_batch, words, tables, n_words)


def _pack_payload_batch(counter, words, tables, n_words: int):
    """K4 pack_payload over a batch; a launch counts on ``counter``."""
    if words.dim() != 2 or tables.dim() != 2 or (
            tables.shape != (words.shape[0], dict_table.TABLE_WORDS)):
        raise ValueError(f"expected words [B, W] and tables [B, "
                         f"{dict_table.TABLE_WORDS}], got "
                         f"{tuple(words.shape)} and {tuple(tables.shape)}")
    if words.device.type == "cpu":
        return pack_payload_batch_plain(words, tables, n_words)
    dev = words.device
    build.require(words, "words", torch.int32, 2, dev)
    build.require_aligned(words, "words")
    build.require(tables, "tables", torch.int32, 2, dev)
    build.require_aligned(tables, "tables", 8)
    b, w = words.shape
    if w % 4 or n_words % 4:
        raise ValueError(f"W and n_words must be multiples of 4, got {w} "
                         f"and {n_words}")
    lib = build.library()
    sums = torch.empty(b * lib.ie_pack_payload_scratch(w), dtype=torch.int64,
                       device=dev)
    total = torch.empty(b, dtype=torch.int64, device=dev)
    out = torch.empty((b, n_words), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = lib.ie_pack_payload_batch(
            words.data_ptr(), w, tables.data_ptr(), b, out.data_ptr(),
            n_words, sums.data_ptr(), total.data_ptr(),
            build.stream_ptr(dev))
    build.check(code, "ie_pack_payload_batch")
    counter.launches += 1
    return out, total


pack_payload_batch.launches = 0


def pack_payload_window(words: torch.Tensor, tables: torch.Tensor,
                        n_words: int):
    """K4 pack_payload over byte windows: :func:`pack_payload_batch` of B
    word rows under tables that name each row's bytes [first_byte, nbytes)
    and its start bit (dict_bits), their dict words zero: each row's codes
    from its start bit (the sharded encode's stage 2, each row a segment's
    owned bytes at its output bit phase, parallel/sharding.py).  One
    batch's two launches; the plain version is pack_payload_batch's."""
    return _pack_payload_batch(pack_payload_window, words, tables, n_words)


pack_payload_window.launches = 0


def coeff_fields(coeffs: torch.Tensor, mvecs: torch.Tensor, gop: int,
                 mvec_nbits: int, block_size: int, use_rle: bool):
    """A recon video's records as pack_records fields, in stream order:
    per frame, its macroblocks' vector records (x, y at mvec_nbits bits
    each on a P-frame, zero width on an I-frame), then its blocks' records
    (rle.block_stats and block_fields of the zig-zag coefficients).

    coeffs: int32 [F, H, W], coefficients in place; mvecs: int32
    [P, n_macro, 2], the P-frames' (f % gop != 0) vectors in order.
    Returns (vals, nbits) int32 [F * (n_macro + n_micro), B*B + 2].
    """
    f, h, w = coeffs.shape
    b = block_size
    k = b * b
    dev = coeffs.device
    n_micro = (h // b) * (w // b)
    n_macro = mvecs.shape[1]
    zz = cuda_encode.device_constant(zigzag_order(b), dev)
    czz = cuda_encode._blocks(coeffs.reshape(f * h, w), b)[:, zz]
    bv, bb = rle.block_fields(czz, rle.block_stats(czz, use_rle), use_rle)
    mv = torch.zeros((f, n_macro, k + 2), dtype=torch.int32, device=dev)
    mb = torch.zeros_like(mv)
    p_idx = p_frames(f, gop)
    if p_idx and n_macro:
        pi = torch.tensor(p_idx, device=dev)
        mv[pi, :, :2] = mvecs.to(torch.int32)
        mb[pi, :, :2] = mvec_nbits
    vals = torch.cat([mv, bv.to(torch.int32).view(f, n_micro, k + 2)],
                     dim=1).reshape(-1, k + 2)
    nbits = torch.cat([mb, bb.to(torch.int32).view(f, n_micro, k + 2)],
                      dim=1).reshape(-1, k + 2)
    return vals, nbits


def pack_coeffs_plain(coeffs, mvecs, gop: int, mvec_nbits: int,
                      block_size: int, use_rle: bool, lw: int,
                      start_bit: int, n_words: int, prefix=None, lens=None):
    """The plain version of K4 pack_coeffs, on any device: the fields of
    :func:`coeff_fields`, packed; total -1 where a record is longer than
    lw words.  ``lens``, where given, must be the blocks' record lengths
    (int32 [F, N], cuda_encode.record_lengths): the fields' widths sum to
    them, and a record they put past lw words is refused."""
    vals, nbits = coeff_fields(coeffs, mvecs, gop, mvec_nbits, block_size,
                               use_rle)
    words, total = pack_records_plain(vals, nbits, start_bit, n_words,
                                      prefix)
    refused = (nbits.to(torch.int64).sum(dim=1) > 32 * lw).any()
    if lens is not None:
        refused = refused | (lens.to(torch.int64) > 32 * lw).any()
    return words, torch.where(refused, -1, total)


def pack_coeffs_hist_plain(*args, **kwargs):
    """The plain version of K4 pack_coeffs with its histogram: the plain
    pack, then K3's plain version over the stream it wrote."""
    words, total = pack_coeffs_plain(*args, **kwargs)
    return words, total, byte_histogram_plain(words, total)


def pack_coeffs(coeffs: torch.Tensor, mvecs: torch.Tensor, gop: int,
                mvec_nbits: int, block_size: int, use_rle: bool, lw: int,
                start_bit: int, n_words: int,
                prefix: torch.Tensor | None = None,
                lens: torch.Tensor | None = None):
    """Pack a recon video's records (see :func:`coeff_fields`) straight
    from its coefficients int32 [F, H, W] and vectors int32 [P, n_macro,
    2], in K2's two launches: the first sums the records' lengths, read
    from ``lens`` (int32 [F, N], N blocks a frame, as K5 and the recon
    step write them with the same ``use_rle``) or, without it, taken from
    the coefficients; the second packs, every tile's start known.  A block
    record longer than ``lw`` words (coefficients outside the bound that
    sized it) is refused: the total is -1, on which the host raises
    (device_pack.host_total)."""
    return _pack_coeffs(pack_coeffs, False, coeffs, mvecs, gop, mvec_nbits,
                        block_size, use_rle, lw, start_bit, n_words, prefix,
                        lens)


pack_coeffs.launches = 0


def pack_coeffs_hist(coeffs: torch.Tensor, mvecs: torch.Tensor, gop: int,
                     mvec_nbits: int, block_size: int, use_rle: bool,
                     lw: int, start_bit: int, n_words: int,
                     prefix: torch.Tensor | None = None,
                     lens: torch.Tensor | None = None):
    """:func:`pack_coeffs` that also counts the byte histogram of the
    stream it writes, in the same two launches: (words, total_bits, hist
    int32 [256])."""
    return _pack_coeffs(pack_coeffs_hist, True, coeffs, mvecs, gop,
                        mvec_nbits, block_size, use_rle, lw, start_bit,
                        n_words, prefix, lens)


pack_coeffs_hist.launches = 0


def _pack_coeffs(counter, hist: bool, coeffs, mvecs, gop: int,
                 mvec_nbits: int, block_size: int, use_rle: bool, lw: int,
                 start_bit: int, n_words: int, prefix, lens):
    """K4 pack_coeffs with or without the histogram; a call counts on
    ``counter``."""
    if coeffs.dim() != 3 or mvecs.dim() != 3 or mvecs.shape[2] != 2:
        raise ValueError(f"expected coeffs [F, H, W] and mvecs [P, n, 2], "
                         f"got {tuple(coeffs.shape)} and "
                         f"{tuple(mvecs.shape)}")
    f, h, w = coeffs.shape
    n_p = len(p_frames(f, gop))
    if mvecs.shape[0] != n_p:
        raise ValueError(f"mvecs has {mvecs.shape[0]} frames, the video "
                         f"{n_p} P-frames")
    n_micro = (h // block_size) * (w // block_size)
    if lens is not None and tuple(lens.shape) != (f, n_micro):
        raise ValueError(f"lens: expected [{f}, {n_micro}], got "
                         f"{tuple(lens.shape)}")
    if coeffs.device.type == "cpu":
        plain = pack_coeffs_hist_plain if hist else pack_coeffs_plain
        return plain(coeffs, mvecs, gop, mvec_nbits, block_size, use_rle, lw,
                     start_bit, n_words, prefix, lens)
    if block_size not in (4, 8):
        raise ValueError(f"pack_coeffs takes 4x4 or 8x8 blocks, not "
                         f"{block_size}x{block_size}")
    dev = coeffs.device
    build.require(coeffs, "coeffs", torch.int32, 3, dev)
    build.require_aligned(coeffs, "coeffs")
    if h % block_size or w % block_size or w % 4:
        raise ValueError(f"frames {h}x{w} do not tile into "
                         f"{block_size}-pixel blocks")
    if lens is not None:
        build.require(lens, "lens", torch.int32, 2, dev)
    mvecs = mvecs.to(torch.int32).contiguous()
    build.require(mvecs, "mvecs", torch.int32, 3, dev)
    if mvecs.numel():
        build.require_aligned(mvecs, "mvecs", 8)
    n_macro = mvecs.shape[1]
    lib = build.library()
    n_records = f * (n_macro + n_micro)
    sums = torch.empty(lib.ie_pack_coeffs_scratch(n_records, block_size),
                       dtype=torch.int64, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    out = torch.empty(n_words, dtype=torch.int32, device=dev)
    bins = torch.empty(256, dtype=torch.int32, device=dev) if hist else None
    with torch.cuda.device(dev):
        code = lib.ie_pack_coeffs(
            coeffs.data_ptr(), f, h, w, block_size,
            None if lens is None else lens.data_ptr(), mvecs.data_ptr(),
            n_macro, gop, mvec_nbits, int(use_rle), lw, start_bit,
            *_prefix(prefix, dev), out.data_ptr(), n_words, sums.data_ptr(),
            total.data_ptr(), bins.data_ptr() if hist else None,
            build.stream_ptr(dev))
    build.check(code, "ie_pack_coeffs")
    counter.launches += 1
    return (out, total.reshape(())) + ((bins,) if hist else ())


# ---- the wire emit ----


def wire_nbytes(bits: int, fallback: bool = False) -> int:
    """A stream's wire bytes: ceil(bits / 8), and one more where the
    raw-copy fallback puts a 0 bit before the inner stream; 0 where
    nothing is written (bits < 0: a refused stream or a failed dict)."""
    if bits < 0:
        return 0
    return (bits + 7) // 8 + bool(fallback)


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def wire_offsets(nbytes) -> tuple[list[int], int]:
    """The wire buffer's layout of streams of ``nbytes`` wire bytes each,
    in order: each stream's first byte, the bytes of the streams before it
    each rounded up to 16 (no 16-byte store holds bytes of two streams),
    and the end of the last stream (the bytes the host copies)."""
    offsets, at, end = [], 0, 0
    for n in nbytes:
        offsets.append(at)
        end = at + n
        at += _pad16(n)
    return offsets, end


def wire_capacity(n_streams: int, n_words: int) -> int:
    """The wire buffer's bytes for streams of ``n_words`` inner words each:
    a stream's wire bytes are at most 4 * n_words + 1 (a coded stream is
    never longer than its inner one; the fallback adds a byte), each
    rounded up to 16."""
    return n_streams * _pad16(4 * n_words + 1)


def table_sources(metas) -> list[tuple[int, bool]]:
    """Per stream (bits, fallback) as the emit reads the dict tables'
    fields (rows of host ints in dict_table.META_FIELDS order): the inner
    bits with a 0 bit before them on the fallback, else the out total;
    bits -1 (nothing written) for a refused stream or an error word."""
    got = []
    for row in metas:
        f = dict(zip(dict_table.META_FIELDS, (int(x) for x in row)))
        if f["inner_bits"] < 0 or f["error"]:
            got.append((-1, False))
        elif f["fallback"]:
            got.append((f["inner_bits"], True))
        else:
            got.append((f["out_total"], False))
    return got


def wire_sources(total_bits, tables=None) -> list[tuple[int, bool]]:
    """Per stream (bits, fallback) of the emit's arguments, read on the
    host: the totals, or the tables' fields (:func:`table_sources`)."""
    if tables is None:
        return [(int(t), False) for t in total_bits.tolist()]
    return table_sources(tables[:, dict_table.META:].contiguous()
                         .view(torch.int64).tolist())


def wire_layout(sources, n_words: int) -> tuple[list[int], list[int], int]:
    """(each stream's wire bytes, :func:`wire_offsets`) of streams given as
    (bits, fallback) over inner rows of ``n_words`` words.  Raises where a
    stream would not fit its share of :func:`wire_capacity` (the dict
    kernel never codes a stream longer than its inner one)."""
    nbytes = [wire_nbytes(bits, fb) for bits, fb in sources]
    if any(n > 4 * n_words + 1 for n in nbytes):
        raise RuntimeError(f"a stream of {max(nbytes)} bytes is longer than "
                           f"its {n_words} inner words")
    offsets, end = wire_offsets(nbytes)
    return nbytes, offsets, end


def wire_bytes(row: torch.Tensor, bits: int,
               fallback: bool = False) -> torch.Tensor:
    """One stream's wire bytes, u8 [wire_nbytes(bits, fallback)], from its
    words (int32 bit patterns of big-endian u32 words, any device): the
    first ceil(bits / 8) bytes, the bytes past them read as zero; on the
    fallback one 0 bit first (each word takes the last bit of the word
    before), then zeros to the byte.  On int64 values by shifts and masks;
    each word's bytes are then reversed, because a little-endian view of
    a word as bytes reverses them: the view gives stream order."""
    nbytes = (bits + 7) // 8
    nw = -(-nbytes // 4)
    if nw > row.shape[0]:
        raise ValueError(f"a stream of {bits} bits in {row.shape[0]} words")
    v = device_pack.as_uint(row[:nw])
    if nw:
        v[-1] &= (device_pack.MASK32 << (8 * (4 * nw - nbytes))) \
            & device_pack.MASK32
    if fallback:
        zero = v.new_zeros(1)
        v = (((torch.cat([zero, v]) << 31) & device_pack.MASK32)
             | (torch.cat([v, zero]) >> 1))
    swapped = (((v & 0xFF) << 24) | ((v & 0xFF00) << 8)
               | ((v >> 8) & 0xFF00) | (v >> 24))
    return device_pack.as_int32(swapped).view(torch.uint8)[
        :wire_nbytes(bits, fallback)]


def _wire_args(words, total_bits, tables, payload):
    """Raise unless the emit's arguments fit one another."""
    if words.dim() != 2:
        raise ValueError(f"words: expected [B, W], got {tuple(words.shape)}")
    b = words.shape[0]
    if tables is None:
        if total_bits is None or tuple(total_bits.shape) != (b,):
            raise ValueError(f"total_bits: expected [{b}] without tables")
    elif (tuple(tables.shape) != (b, dict_table.TABLE_WORDS)
          or payload is None or payload.dim() != 2
          or payload.shape[0] != b):
        raise ValueError(f"expected tables [{b}, {dict_table.TABLE_WORDS}] "
                         f"and a payload [{b}, P], got tables "
                         f"{tuple(tables.shape)}")


def emit_wire_plain(words, total_bits, tables=None, payload=None):
    """The plain version of the wire emit, on any device: the lengths read
    on the host, then each stream's :func:`wire_bytes` at its
    :func:`wire_offsets` offset; zeros elsewhere."""
    _wire_args(words, total_bits, tables, payload)
    if sys.byteorder != "little":
        raise RuntimeError("emit_wire_plain views words as little-endian "
                           "bytes")
    b, n = words.shape
    out = torch.zeros(wire_capacity(b, n), dtype=torch.uint8,
                      device=words.device)
    sources = wire_sources(total_bits, tables)
    nbytes, offsets, _ = wire_layout(sources, n)
    for k, ((bits, fb), m, at) in enumerate(zip(sources, nbytes, offsets)):
        if m:
            row = words[k] if tables is None or fb else payload[k]
            out[at:at + m] = wire_bytes(row, bits, fb)
    return out


def emit_wire(words: torch.Tensor, total_bits: torch.Tensor | None,
              tables: torch.Tensor | None = None,
              payload: torch.Tensor | None = None) -> torch.Tensor:
    """B final streams as wire-order bytes: u8 [wire_capacity(B, W)], each
    stream at its :func:`wire_offsets` offset.  words: int32 [B, W], the
    inner streams' words; without Huffman total_bits int64 [B] gives each
    stream's bits; with it the dict tables [B, TABLE_WORDS] pick each
    stream's source, its inner words with one 0 bit first on the fallback
    or its payload int32 [B, P] (total_bits is then not read).  A refused
    stream, or a failed dict, takes no bytes.  On the card one launch of
    csrc/wire.cu, whatever B is; nothing is read on the host, and the
    buffer past the last stream's padded end is left as allocated."""
    _wire_args(words, total_bits, tables, payload)
    if words.device.type == "cpu":
        return emit_wire_plain(words, total_bits, tables, payload)
    dev = words.device
    b, n = words.shape
    out = torch.empty(wire_capacity(b, n), dtype=torch.uint8, device=dev)
    if b == 0:
        return out
    inner_stride = build.frame_stride(words, "words", torch.int32, 2, dev)
    if tables is None:
        totals = total_bits.to(torch.int64).contiguous()
        build.require(totals, "total_bits", torch.int64, 1, dev)
        pay, pay_stride, pay_words, tab = None, 0, 0, None
    else:
        build.require(tables, "tables", torch.int32, 2, dev)
        pay_stride = build.frame_stride(payload, "payload", torch.int32, 2,
                                        dev)
        pay, pay_words, tab, totals = (payload.data_ptr(), payload.shape[1],
                                       tables.data_ptr(), None)
    with torch.cuda.device(dev):
        code = build.library().ie_emit_wire(
            words.data_ptr(), inner_stride, n, pay, pay_stride, pay_words,
            tab, None if totals is None else totals.data_ptr(), b,
            out.data_ptr(), build.stream_ptr(dev))
    build.check(code, "ie_emit_wire")
    emit_wire.launches += 1
    return out


emit_wire.launches = 0
