"""K2 and K4: the bitstream packers.

The counterpart of imageencoder_tpu/ops/pallas_pack.py:

  * :func:`pack_locals` (K2, pack_locals_pallas) concatenates register
    files and bit lengths from the encode front end (ops/cuda_encode.py)
    and, for a video, each P-frame's motion-vector records before the
    frame's blocks, read from the vectors where they lie;
    :func:`pack_locals_hist` also counts the byte histogram of the stream
    it writes (K3, pallas_kernels.byte_histogram, folded in);
  * K4 (pack_records_pallas) is one single-pass kernel with three front
    ends, each of which reads its records' fields where they already are:
    :func:`pack_records` [N, F] field tensors of (value, nbits) pairs,
    fields at most 16 bits wide; :func:`pack_payload` the Huffman payload,
    each stream byte replaced by its code (huffman._device_stages
    .pack_payload), under the dict kernel's table (ops/dict_table.py);
    :func:`pack_coeffs` a recon video's motion-vector and block records
    from its coefficient tensor (pipeline.fields_from_coeffs and the
    vector fields, then the pack), and :func:`pack_coeffs_hist` the same
    with the stream's byte histogram.

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
nothing on the device but their kernels (K4 also clears its scratch), and
the total and every start stay there: nothing waits on the host.
"""

from __future__ import annotations

import torch

from ..kernels import build
from . import cuda_encode, device_pack, dict_table, rle
from .cuda_kernels import byte_histogram_plain
from .motion import p_frames
from .zigzag import zigzag_order

HIST_SLOTS = 128  # int64 words of K4's zeroed scratch that hold 256 bins


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


def _k4(entry: str, n_records: int, n_words: int, dev, args: tuple,
        hist: bool | None = None):
    """Launch a K4 front end on ``args`` (its arguments before ``out``):
    allocates its output (not zeroed), its zeroed scratch and its edges,
    and returns (words, total_bits).  An entry that takes a histogram
    (``hist`` not None) gets its bins in the scratch's zeroed tail where
    ``hist`` is true, and they are returned too; else a null pointer."""
    lib = build.library()
    n_tiles = -(-n_records // lib.ie_pack_tile())
    scratch = torch.zeros(3 + n_tiles + (HIST_SLOTS if hist else 0),
                          dtype=torch.int64, device=dev)
    edges = torch.empty(max(2 * n_tiles, 1), dtype=torch.int64, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    out = torch.empty(n_words, dtype=torch.int32, device=dev)
    bins = scratch[3 + n_tiles:].view(torch.int32) if hist else None
    tail = () if hist is None else (bins.data_ptr() if hist else None,)
    with torch.cuda.device(dev):
        code = getattr(lib, entry)(
            *args, out.data_ptr(), n_words, scratch.data_ptr(),
            edges.data_ptr(), total.data_ptr(), *tail, build.stream_ptr(dev))
    build.check(code, entry)
    return (out, total.reshape(())) + ((bins,) if hist else ())


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


def payload_fields(words: torch.Tensor, nbytes: int, code_w: torch.Tensor,
                   code_l: torch.Tensor):
    """The Huffman payload as pack_records records: each of the first
    ``nbytes`` bytes replaced by its (code, length), 16 bytes per record;
    bytes past the stream get length 0.  Returns (vals, nbits) int32
    [ceil(4W/16), 16]."""
    data = device_pack.words_to_u8(words)
    n_lanes = data.shape[0]
    idx = torch.arange(n_lanes, device=words.device)
    vals = code_w[data].to(torch.int32)
    nbits = torch.where(idx < nbytes, code_l[data], 0).to(torch.int32)
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
                                 table[t.CODE_L:t.CODE_L + 256])
    return pack_records_plain(vals, nbits, meta["dict_bits"], n_words,
                              table[t.DICT:t.DICT + t.DICT_WORDS])


def pack_payload(words: torch.Tensor, table: torch.Tensor, n_words: int):
    """Pack the Huffman payload of the inner stream ``words`` (int32 [W],
    u32 bits) under the dict kernel's ``table`` (ops/dict_table.py): each
    of the stream's first ``nbytes`` bytes (a field of the table), in
    stream order, replaced by its code of the table (lengths at most 16),
    16 bytes a record, after the dict's bits, the dict's words OR'd into
    the first words.  Nothing of the table is read on the host."""
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
    got = _k4("ie_pack_payload", -(-words.shape[0] // 4), n_words, dev,
              (words.data_ptr(), words.shape[0], table.data_ptr()))
    pack_payload.launches += 1
    return got


pack_payload.launches = 0


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
                      start_bit: int, n_words: int, prefix=None):
    """The plain version of K4 pack_coeffs, on any device: the fields of
    :func:`coeff_fields`, packed; total -1 where a record is longer than
    lw words."""
    vals, nbits = coeff_fields(coeffs, mvecs, gop, mvec_nbits, block_size,
                               use_rle)
    words, total = pack_records_plain(vals, nbits, start_bit, n_words,
                                      prefix)
    refused = (nbits.to(torch.int64).sum(dim=1) > 32 * lw).any()
    return words, torch.where(refused, -1, total)


def pack_coeffs_hist_plain(*args, **kwargs):
    """The plain version of K4 pack_coeffs with its histogram: the plain
    pack, then K3's plain version over the stream it wrote."""
    words, total = pack_coeffs_plain(*args, **kwargs)
    return words, total, byte_histogram_plain(words, total)


def pack_coeffs(coeffs: torch.Tensor, mvecs: torch.Tensor, gop: int,
                mvec_nbits: int, block_size: int, use_rle: bool, lw: int,
                start_bit: int, n_words: int,
                prefix: torch.Tensor | None = None):
    """Pack a recon video's records (see :func:`coeff_fields`) straight
    from its coefficients int32 [F, H, W] and vectors int32 [P, n_macro,
    2].  A block record longer than ``lw`` words (coefficients outside the
    bound that sized it) is refused: the total is -1, on which the host
    raises (device_pack.host_total)."""
    return _pack_coeffs(pack_coeffs, False, coeffs, mvecs, gop, mvec_nbits,
                        block_size, use_rle, lw, start_bit, n_words, prefix)


pack_coeffs.launches = 0


def pack_coeffs_hist(coeffs: torch.Tensor, mvecs: torch.Tensor, gop: int,
                     mvec_nbits: int, block_size: int, use_rle: bool,
                     lw: int, start_bit: int, n_words: int,
                     prefix: torch.Tensor | None = None):
    """:func:`pack_coeffs` that also counts the byte histogram of the
    stream it writes, in the same launch: (words, total_bits, hist int32
    [256])."""
    return _pack_coeffs(pack_coeffs_hist, True, coeffs, mvecs, gop,
                        mvec_nbits, block_size, use_rle, lw, start_bit,
                        n_words, prefix)


pack_coeffs_hist.launches = 0


def _pack_coeffs(counter, hist: bool, coeffs, mvecs, gop: int,
                 mvec_nbits: int, block_size: int, use_rle: bool, lw: int,
                 start_bit: int, n_words: int, prefix):
    """K4 pack_coeffs with or without the histogram; a launch counts on
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
    if coeffs.device.type == "cpu":
        plain = pack_coeffs_hist_plain if hist else pack_coeffs_plain
        return plain(coeffs, mvecs, gop, mvec_nbits, block_size, use_rle, lw,
                     start_bit, n_words, prefix)
    if block_size not in (4, 8):
        raise ValueError(f"pack_coeffs takes 4x4 or 8x8 blocks, not "
                         f"{block_size}x{block_size}")
    dev = coeffs.device
    build.require(coeffs, "coeffs", torch.int32, 3, dev)
    build.require_aligned(coeffs, "coeffs")
    if h % block_size or w % block_size or w % 4:
        raise ValueError(f"frames {h}x{w} do not tile into "
                         f"{block_size}-pixel blocks")
    mvecs = mvecs.to(torch.int32).contiguous()
    build.require(mvecs, "mvecs", torch.int32, 3, dev)
    if mvecs.numel():
        build.require_aligned(mvecs, "mvecs", 8)
    n_macro = mvecs.shape[1]
    n_records = f * (n_macro + (h // block_size) * (w // block_size))
    got = _k4("ie_pack_coeffs", n_records, n_words, dev,
              (coeffs.data_ptr(), f, h, w, block_size, mvecs.data_ptr(),
               n_macro, gop, mvec_nbits, int(use_rle), lw, start_bit,
               *_prefix(prefix, dev)), hist)
    counter.launches += 1
    return got
