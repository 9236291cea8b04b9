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
  * K4 (pack_records_pallas) has three front ends, each of which reads
    its records' fields where they already are: on a single-pass kernel
    :func:`pack_records` [N, F] field tensors of (value, nbits) pairs,
    fields at most 16 bits wide (:func:`pack_records_segments` B segments
    of them, each from its own start bit, in one launch).  On K2's two
    launches :func:`pack_payload` the Huffman payload, each stream byte
    replaced by its code (huffman._device_stages.pack_payload), under the
    dict kernel's table (ops/dict_table.py); :func:`pack_payload_batch`
    a batch of payloads, :func:`pack_payload_window` a batch of byte
    windows, each at its own start bit (the sharded Huffman stage); and
    :func:`pack_coeffs` a recon
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
nothing on the device but their kernels (pack_records also clears its
scratch), and the total and every start stay there: nothing waits on the
host.
"""

from __future__ import annotations

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


def _k4(entry: str, n_records: int, n_words: int, dev, args: tuple):
    """Launch a single-pass K4 front end on ``args`` (its arguments before
    ``out``): allocates its output (not zeroed), its zeroed scratch and
    its edges, and returns (words, total_bits)."""
    lib = build.library()
    n_tiles = -(-n_records // lib.ie_pack_tile())
    scratch = torch.zeros(3 + n_tiles, dtype=torch.int64, device=dev)
    edges = torch.empty(max(2 * n_tiles, 1), dtype=torch.int64, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    out = torch.empty(n_words, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = getattr(lib, entry)(
            *args, out.data_ptr(), n_words, scratch.data_ptr(),
            edges.data_ptr(), total.data_ptr(), build.stream_ptr(dev))
    build.check(code, entry)
    return out, total.reshape(())


def pack_records_plain(vals, nbits, start_bit: int, n_words: int,
                       prefix=None):
    """The plain version of K4 pack_records, on any device."""
    return device_pack.pack_blocks(vals, nbits, start_bit, n_words, prefix)


def pack_records(vals: torch.Tensor, nbits: torch.Tensor, start_bit: int,
                 n_words: int, prefix: torch.Tensor | None = None):
    """Pack [N, F] int32 fields (values, widths 0..16; width 0 = skip).
    On the card a width outside 0..16 makes the total -1."""
    if vals.device.type == "cpu":
        return pack_records_plain(vals, nbits, start_bit, n_words, prefix)
    dev = vals.device
    build.require(vals, "vals", torch.int32, 2, dev)
    build.require(nbits, "nbits", torch.int32, 2, dev)
    if nbits.shape != vals.shape:
        raise ValueError(f"nbits {tuple(nbits.shape)} != vals "
                         f"{tuple(vals.shape)}")
    n, f = vals.shape
    got = _k4("ie_pack_records", n, n_words, dev,
              (vals.data_ptr(), nbits.data_ptr(), n, f, start_bit,
               *_prefix(prefix, dev)))
    pack_records.launches += 1
    return got


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
    row -> (words int32 [B, n_words], totals int64 [B]).  One launch (the
    sharded video's vector segments, parallel/video_sharding.py)."""
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
    n_tiles = -(-n // lib.ie_pack_tile())
    scratch_stride, edges_stride = 3 + n_tiles, max(2 * n_tiles, 1)
    scratch = torch.zeros(b * scratch_stride, dtype=torch.int64, device=dev)
    edges = torch.empty(b * edges_stride, dtype=torch.int64, device=dev)
    total = torch.empty(b, dtype=torch.int64, device=dev)
    out = torch.empty((b, n_words), dtype=torch.int32, device=dev)
    if b:
        with torch.cuda.device(dev):
            code = lib.ie_pack_records_segments(
                vals.data_ptr(), nbits.data_ptr(), n, f, b, starts.data_ptr(),
                out.data_ptr(), n_words, scratch.data_ptr(), scratch_stride,
                edges.data_ptr(), edges_stride, total.data_ptr(),
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
