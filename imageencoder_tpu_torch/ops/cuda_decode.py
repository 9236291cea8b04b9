"""D1-D3: the image and video decode on the card.

The JAX package decodes on the host (imageencoder_tpu/runtime/native/
runtime.cpp, with Python fallbacks); no TPU kernel lies on its decode
path.  Here the three stages after the header are kernels, launched one
after the other with nothing read back between them:

  * D1 :func:`huffman_decode` (csrc/huffman_decode.cu; the host's
    huffman_fsm_decode, runtime.cpp:1227): the Huffman payload to its
    bytes, every bit to the end of the buffer, through the dict's decode
    table (ops/huffman.py::decode_table); the byte count stays on the
    device;
  * D2 :func:`walk_offsets` (csrc/walk.cu; walk_offsets, runtime.cpp:956):
    the chain of variable-length block records to each record's payload
    offset, width and count; :func:`walk_video` the same over a whole
    video, one chain that jumps each P-frame's vector block, with each
    frame's vector and record start bits;
  * the vector read :func:`read_vectors` (csrc/walk.cu; read_signed_fields,
    runtime.cpp:1472): every P-frame's motion vectors at the start bits
    D2 wrote;
  * D3 :func:`decode_blocks` (csrc/decode.cu; decode_to_image_exact,
    runtime.cpp:2219, and with a prediction decode_residual_to_image_exact,
    :2245): each block's fields, sign-extended, out of zig-zag,
    dequantized and inverted in the reference's exact f64 order, +128,
    (+ the prediction,) clamped, floored and stored into the [H, W] image;
    one launch takes a set of frames.

D1 and D2 walk a serial chain in parallel (csrc/chain.cuh): chunks of
``chunk_bits`` walk speculatively from their first bit, and a check
follows the true chain through each chunk from its likely entry.  In D1,
:data:`CHAIN_ROUNDS` rounds then pass each break's true exit on to the
chunk after (one chunk a round, on the whole card), and where they leave
a break its table settles it (a step is at most ``max_len`` bits, so a
chunk's true entry lies in its first ``max_len`` bits: the chunk is
followed from each, and a scan of the maps from entry to exit offsets
gives every chunk's true entry).  D2's stitch sweeps the chain in order
where the check left a break, as it does to take a video's jumps.  An
emission pass writes the outputs.  ``stats``, where given (int64 [n >= 2]
on the device), receives the first n of :data:`CHAIN_STATS`: the chunks,
how many of them the true chain walked whole, what D2's sweep did, the
rounds that changed a chunk, and whether a break was left after the
rounds (D1: the table ran) or the check (D2: the sweep fixed it).

Reads past the payload's byte count (a device tensor: D1's output, or
the stream's length) give zero bits, whatever the buffer holds there.

On a CPU tensor each wrapper runs its plain version, the port's copies
of the JAX package's host decode (ops/huffman.py::huffman_decode,
models/image.py::walk_block_offsets and coeffs_from_records,
models/video.py::walk_frames and read_vector_fields, ops/dct.py) on
the host; on a CUDA tensor it launches its kernels or raises.  The plain
versions also take CUDA tensors (they copy to the host and back).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import build
from . import huffman
from .bitpack import to_bits
from .blockify import deblockify
from .cuda_encode import device_constant
from .dct import _inv_weights, clamp_to_u8
from .zigzag import zigzag_order

# Chunk sizes from tools/decode_chunks.py on the H100 (PERF.md): shorter
# chunks give more threads, but more of them end before their walker
# meets the true chain, and each such chunk costs a round (D1) or a step
# of the sweep (D2).
CHUNK_BITS_HUFFMAN = 256  # D1 on an image: about 35 symbols
CHUNK_BITS_HUFFMAN_VIDEO = 512  # D1 on a video: where the table runs
CHUNK_BITS_WALK = 2048  # D2: about 100 records of the image
MAX_CHUNK_BITS = 1 << 20
# Round launches D1 takes after the check: a break moves one chunk a
# round, and two leave no break on the smoke's 4096x912 image (PERF.md); a
# round after one that moved nothing returns at once.  What they leave,
# the table settles.  Only tests set another count (0 to 32, chain.cuh's
# kMaxRounds), to force the table.
CHAIN_ROUNDS = 2
# The entries of ``stats`` (chain.cuh's ChainStat), in order.
CHAIN_STATS = ("chunks", "walked_whole", "sweep_breaks", "sweep_rewalked",
               "sweep_skipped", "scan_turns", "jumps", "rounds_changed",
               "longest_run", "breaks_left")


def payload_capacity(payload_bits: int, min_len: int) -> int:
    """Bytes that hold every symbol of ``payload_bits`` bits of codes no
    shorter than ``min_len`` (a step without a symbol takes a bit at
    least, one with a symbol min_len bits), plus slack for the word
    reads."""
    return max(payload_bits, 0) // min_len + 16


def _host_bytes(buf: torch.Tensor, nbytes: torch.Tensor) -> bytes:
    """The first ``nbytes`` bytes of a uint8 buffer, on the host."""
    n = int(nbytes.reshape(-1)[0])
    return buf[:n].cpu().numpy().tobytes()


def _check_chunks(chunk_bits: int) -> None:
    if chunk_bits % 32 or not 32 <= chunk_bits <= MAX_CHUNK_BITS:
        raise ValueError(f"chunk_bits must be a multiple of 32 in 32.."
                         f"{MAX_CHUNK_BITS}, got {chunk_bits}")


def _n_chunks(span_bits: int, chunk_bits: int) -> int:
    """Chunks that cover ``span_bits`` bits, at least one."""
    return max(1, -(-span_bits // chunk_bits))


def _scratch(lib, n_chunks: int, chunk_bits: int, dev,
             table: bool) -> torch.Tensor:
    """A chain's scratch; D1's holds its table too."""
    words = lib.ie_chain_scratch_words(n_chunks, chunk_bits, int(table))
    return torch.empty(words, dtype=torch.int64, device=dev)


def _check_stats(stats, dev) -> tuple[int | None, int]:
    """(the pointer, the entries the kernel writes)."""
    if stats is None:
        return None, 0
    build.require(stats, "stats", torch.int64, 1, dev)
    if stats.shape[0] < 2:
        raise ValueError("stats: expected at least 2 int64")
    return stats.data_ptr(), min(stats.shape[0], len(CHAIN_STATS))


# ---- D1: the Huffman payload ----

def huffman_decode_plain(stream: torch.Tensor, nbytes: torch.Tensor,
                         start_bit: int, table: torch.Tensor, max_len: int,
                         cap: int, chunk_bits: int = CHUNK_BITS_HUFFMAN,
                         stats: torch.Tensor | None = None):
    """The plain version of D1: the port's copy of the host decode
    (ops/huffman.py::huffman_decode) of the stream's first ``nbytes``
    bytes, which parses the stream's own dict; the table, which is that
    dict in the kernel's form, and the chunking are the kernel's.
    Returns (decoded bytes uint8 [cap], zero past the count; the count
    int64 [1])."""
    data = _host_bytes(stream, nbytes)
    dec = huffman.huffman_decode(data)
    if len(dec) > cap:
        raise ValueError(f"{len(dec)} decoded bytes exceed the capacity "
                         f"{cap}")
    out = np.zeros(cap, np.uint8)
    out[:len(dec)] = np.frombuffer(dec, np.uint8)
    dev = stream.device
    return (torch.from_numpy(out).to(dev),
            torch.tensor([len(dec)], dtype=torch.int64, device=dev))


def huffman_decode(stream: torch.Tensor, nbytes: torch.Tensor,
                   start_bit: int, table: torch.Tensor, max_len: int,
                   cap: int, chunk_bits: int = CHUNK_BITS_HUFFMAN,
                   stats: torch.Tensor | None = None):
    """D1: decode the Huffman payload that starts at ``start_bit`` (the
    dict's end) of ``stream`` (uint8, its byte count ``nbytes`` int64 [1]
    on the same device, a host-known value) under ``table`` (int16
    [2**max_len], ops/huffman.py::decode_table's entries).  Returns (bytes
    uint8 [cap], defined up to the count; the count int64 [1] on the
    device).  ``cap`` must cover every symbol (:func:`payload_capacity`)."""
    if stream.dim() != 1 or nbytes.numel() != 1:
        raise ValueError("expected a 1-D stream and a one-element nbytes")
    if not 1 <= max_len <= huffman.MAX_CODE_LEN or \
            table.shape != (1 << max_len,):
        raise ValueError(f"table of {tuple(table.shape)} entries for codes "
                         f"of at most {max_len} bits")
    _check_chunks(chunk_bits)
    if stream.device.type == "cpu":
        return huffman_decode_plain(stream, nbytes, start_bit, table,
                                    max_len, cap, chunk_bits, stats)
    dev = stream.device
    build.require(stream, "stream", torch.uint8, 1, dev)
    build.require(nbytes, "nbytes", torch.int64, 1, dev)
    build.require(table, "table", torch.int16, 1, dev)
    stats_ptr, n_stats = _check_stats(stats, dev)
    lib = build.library()
    n_chunks = _n_chunks(8 * stream.shape[0] - start_bit, chunk_bits)
    scratch = _scratch(lib, n_chunks, chunk_bits, dev, True)
    out = torch.empty(cap, dtype=torch.uint8, device=dev)
    count = torch.empty(1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        code = lib.ie_huffman_decode(
            stream.data_ptr(), nbytes.data_ptr(), start_bit, n_chunks,
            chunk_bits, table.data_ptr(), max_len, out.data_ptr(), cap,
            count.data_ptr(), scratch.data_ptr(), CHAIN_ROUNDS, stats_ptr,
            n_stats, build.stream_ptr(dev))
    build.check(code, "ie_huffman_decode")
    huffman_decode.launches += 1
    return out, count


huffman_decode.launches = 0


# ---- D2: the offset walk ----

def walk_offsets_plain(payload: torch.Tensor, nbytes: torch.Tensor,
                       start_bit: int, n_blocks: int, use_rle: bool,
                       block_size: int = 4,
                       chunk_bits: int = CHUNK_BITS_WALK,
                       stats: torch.Tensor | None = None):
    """The plain version of D2: the port's copy of the host walk
    (models/image.py::walk_block_offsets) over the payload's first
    ``nbytes`` bytes.  Returns (offs int64 [N], dbits int32 [N], counts
    int32 [N], end bit int64 [1])."""
    # models/image.py imports this module: a function-level import.
    from ..models.image import walk_block_offsets

    data = _host_bytes(payload, nbytes)
    offs, dbits, counts, end = walk_block_offsets(
        None, start_bit, n_blocks, use_rle, block_size, packed=data)
    dev = payload.device
    return (torch.from_numpy(offs).to(dev), torch.from_numpy(dbits).to(dev),
            torch.from_numpy(counts).to(dev),
            torch.tensor([end], dtype=torch.int64, device=dev))


def walk_offsets(payload: torch.Tensor, nbytes: torch.Tensor,
                 start_bit: int, n_blocks: int, use_rle: bool,
                 block_size: int = 4, chunk_bits: int = CHUNK_BITS_WALK,
                 stats: torch.Tensor | None = None):
    """D2: the first ``n_blocks`` block records from ``start_bit`` of the
    payload (uint8; its byte count ``nbytes`` int64 [1] on the device).
    Returns (offs int64 [N], dbits int32 [N], counts int32 [N], end bit
    int64 [1]), as walk_block_offsets.  Nothing is read on the host: the
    chunks cover the whole buffer, and those past the byte count hold no
    record."""
    if payload.dim() != 1 or nbytes.numel() != 1:
        raise ValueError("expected a 1-D payload and a one-element nbytes")
    if block_size not in (4, 8):
        raise ValueError(f"block size must be 4 or 8, got {block_size}")
    _check_chunks(chunk_bits)
    if payload.device.type == "cpu":
        return walk_offsets_plain(payload, nbytes, start_bit, n_blocks,
                                  use_rle, block_size, chunk_bits, stats)
    dev = payload.device
    build.require(payload, "payload", torch.uint8, 1, dev)
    build.require(nbytes, "nbytes", torch.int64, 1, dev)
    stats_ptr, n_stats = _check_stats(stats, dev)
    offs = torch.empty(n_blocks, dtype=torch.int64, device=dev)
    dbits = torch.empty(n_blocks, dtype=torch.int32, device=dev)
    counts = torch.empty(n_blocks, dtype=torch.int32, device=dev)
    if n_blocks == 0:
        return offs, dbits, counts, torch.full((1,), start_bit,
                                               dtype=torch.int64, device=dev)
    end = torch.empty(1, dtype=torch.int64, device=dev)  # the last record's
    lib = build.library()
    n_chunks = _n_chunks(8 * payload.shape[0] - start_bit, chunk_bits)
    scratch = _scratch(lib, n_chunks, chunk_bits, dev, False)
    with torch.cuda.device(dev):  # a video of one frame
        code = lib.ie_walk_video(
            payload.data_ptr(), nbytes.data_ptr(), start_bit, n_chunks,
            chunk_bits, n_blocks, 1, 1, 0, int(use_rle), block_size,
            offs.data_ptr(), dbits.data_ptr(), counts.data_ptr(),
            end.data_ptr(), None, None, scratch.data_ptr(), stats_ptr,
            n_stats, build.stream_ptr(dev))
    build.check(code, "ie_walk_video")
    walk_offsets.launches += 1
    return offs, dbits, counts, end


walk_offsets.launches = 0


def walk_video_plain(payload: torch.Tensor, nbytes: torch.Tensor,
                     start_bit: int, n_frames: int, n_micro: int, gop: int,
                     vbits: int, use_rle: bool, block_size: int = 4,
                     chunk_bits: int = CHUNK_BITS_WALK,
                     stats: torch.Tensor | None = None):
    """The plain version of :func:`walk_video`: the frame loop of the
    port's copy of the host walk (models/video.py::walk_frames, one
    walk_block_offsets a frame), over the payload's first ``nbytes``
    bytes."""
    from ..models.video import walk_frames  # imports this module

    data = _host_bytes(payload, nbytes)
    frames = list(walk_frames(data, start_bit, n_frames, n_micro, gop,
                              vbits, use_rle, block_size))
    dev = payload.device
    offs, dbits, counts = (torch.from_numpy(np.concatenate(
        [fr[2][i] for fr in frames])).to(dev) for i in range(3))
    return (offs, dbits, counts,
            torch.tensor([frames[-1][3]], dtype=torch.int64, device=dev),
            *(torch.tensor([fr[i] for fr in frames], dtype=torch.int64,
                           device=dev) for i in (0, 1)))


def walk_video(payload: torch.Tensor, nbytes: torch.Tensor, start_bit: int,
               n_frames: int, n_micro: int, gop: int, vbits: int,
               use_rle: bool, block_size: int = 4,
               chunk_bits: int = CHUNK_BITS_WALK,
               stats: torch.Tensor | None = None):
    """D2 over a video: ``n_frames`` frames of ``n_micro`` block records
    from ``start_bit`` of the payload (uint8; its byte count ``nbytes``
    int64 [1] on the device), frame f's records after ``vbits`` bits of
    vectors where f % gop != 0.  Returns (offs int64 [F * n_micro], dbits
    int32, counts int32, end bit int64 [1], each frame's vector start bit
    int64 [F] and record start bit int64 [F]): one chain over the whole
    payload, four launches, nothing read on the host."""
    if payload.dim() != 1 or nbytes.numel() != 1:
        raise ValueError("expected a 1-D payload and a one-element nbytes")
    if block_size not in (4, 8):
        raise ValueError(f"block size must be 4 or 8, got {block_size}")
    if n_frames < 1 or n_micro < 1 or gop < 1 or vbits < 0:
        raise ValueError(f"a walk of {n_frames} frames of {n_micro} "
                         f"records, gop {gop}, {vbits} vector bits")
    _check_chunks(chunk_bits)
    if payload.device.type == "cpu":
        return walk_video_plain(payload, nbytes, start_bit, n_frames,
                                n_micro, gop, vbits, use_rle, block_size,
                                chunk_bits, stats)
    dev = payload.device
    build.require(payload, "payload", torch.uint8, 1, dev)
    build.require(nbytes, "nbytes", torch.int64, 1, dev)
    stats_ptr, n_stats = _check_stats(stats, dev)
    n = n_frames * n_micro
    offs = torch.empty(n, dtype=torch.int64, device=dev)
    dbits = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    end = torch.empty(1, dtype=torch.int64, device=dev)
    starts = torch.empty((2, n_frames), dtype=torch.int64, device=dev)
    lib = build.library()
    n_chunks = _n_chunks(8 * payload.shape[0] - start_bit, chunk_bits)
    scratch = _scratch(lib, n_chunks, chunk_bits, dev, False)
    with torch.cuda.device(dev):
        code = lib.ie_walk_video(
            payload.data_ptr(), nbytes.data_ptr(), start_bit, n_chunks,
            chunk_bits, n_micro, n_frames, gop, vbits, int(use_rle),
            block_size, offs.data_ptr(), dbits.data_ptr(),
            counts.data_ptr(), end.data_ptr(), starts[0].data_ptr(),
            starts[1].data_ptr(), scratch.data_ptr(), stats_ptr, n_stats,
            build.stream_ptr(dev))
    build.check(code, "ie_walk_video")
    walk_video.launches += 1
    return offs, dbits, counts, end, starts[0], starts[1]


walk_video.launches = 0


# ---- the vector read ----

def read_vectors_plain(payload: torch.Tensor, nbytes: torch.Tensor,
                       vstart: torch.Tensor, gop: int, n_macro: int,
                       mb: int):
    """The plain version of :func:`read_vectors`: the port's copy of the
    host read (models/video.py::read_vector_fields) of each P-frame."""
    from ..models.video import read_vector_fields  # imports this module

    data = _host_bytes(payload, nbytes)
    starts = vstart.cpu().tolist()
    out = np.zeros((len(starts), n_macro, 2), np.int32)
    for f, pos in enumerate(starts):
        if f % gop:
            out[f] = read_vector_fields(data, pos, n_macro, mb)
    return torch.from_numpy(out).to(payload.device)


def read_vectors(payload: torch.Tensor, nbytes: torch.Tensor,
                 vstart: torch.Tensor, gop: int, n_macro: int, mb: int):
    """Each P-frame's (f % gop != 0) 2 * n_macro signed ``mb``-bit fields
    from its vector start bit (``vstart`` int64 [F], D2's) in the payload
    (uint8, byte count ``nbytes`` int64 [1]), zero past the count: int32
    [F, n_macro, 2] as (x, y), zero rows for I-frames.  One launch."""
    if not 1 <= mb <= 16:
        raise ValueError(f"vector fields of {mb} bits")
    if gop < 1:
        raise ValueError(f"gop must be at least 1, got {gop}")
    if payload.device.type == "cpu":
        return read_vectors_plain(payload, nbytes, vstart, gop, n_macro, mb)
    dev = payload.device
    build.require(payload, "payload", torch.uint8, 1, dev)
    build.require(nbytes, "nbytes", torch.int64, 1, dev)
    build.require(vstart, "vstart", torch.int64, 1, dev)
    n_frames = vstart.shape[0]
    out = torch.empty((n_frames, n_macro, 2), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        code = build.library().ie_read_vectors(
            payload.data_ptr(), nbytes.data_ptr(), vstart.data_ptr(),
            n_frames, gop, 2 * n_macro, mb, out.data_ptr(),
            build.stream_ptr(dev))
    build.check(code, "ie_read_vectors")
    read_vectors.launches += 1
    return out


read_vectors.launches = 0


# ---- D3: the block decode ----

def decode_blocks_plain(payload: torch.Tensor, nbytes: torch.Tensor,
                        offs: torch.Tensor, dbits: torch.Tensor,
                        counts: torch.Tensor, quant: torch.Tensor,
                        block_size: int, norm: str, h: int, w: int,
                        pred: torch.Tensor | None = None,
                        out: torch.Tensor | None = None):
    """The plain version of D3: the port's copies of the host extraction
    (models/image.py::blocks_from_records: coeffs_from_records and the
    exact inverse, ops/dct.py) and deblockify, in numpy on the host, then
    the clamp of the pixels, or of (double) pred + the residual, as
    models/video.py's P-frame path does (clamp_to_u8).  Returns uint8
    [h, w] (or [G, h, w]) on the payload's device."""
    from ..models.image import blocks_from_records  # see walk_offsets_plain

    bits = to_bits(_host_bytes(payload, nbytes))
    # Frames by records; a frame of no blocks (H or W of 0) has no record.
    n_frames = 1 if offs.dim() == 1 else offs.shape[0]
    rows = [r.cpu().numpy().reshape(n_frames, r.shape[-1])
            for r in (offs, dbits, counts)]
    q = quant.cpu().numpy().reshape(block_size, block_size)
    frames = [np.empty((0, h, w), np.uint8)]
    for g in range(n_frames):
        px = blocks_from_records(bits, rows[0][g], rows[1][g], rows[2][g], q,
                                 norm, block_size, residual=pred is not None)
        px = deblockify(px, h, w)
        if pred is not None:
            px = clamp_to_u8(pred[g].cpu().numpy().astype(np.float64) + px)
        frames.append(np.ascontiguousarray(px)[None])
    img = torch.from_numpy(np.concatenate(frames)).to(payload.device)
    if offs.dim() == 1:
        img = img[0]
    return img if out is None else out.copy_(img)


def decode_tables(block_size: int, norm: str, device):
    """(inverse weights f64 [K, K], inverse zig-zag int32 [K]) on
    ``device``, made once per device: izz[c] is the zig-zag position of
    row-major coefficient c."""
    zz = zigzag_order(block_size)
    izz = np.empty_like(zz)
    izz[zz] = np.arange(len(zz), dtype=np.int32)
    return (device_constant(_inv_weights(block_size, norm), device),
            device_constant(izz, device))


def decode_blocks(payload: torch.Tensor, nbytes: torch.Tensor,
                  offs: torch.Tensor, dbits: torch.Tensor,
                  counts: torch.Tensor, quant: torch.Tensor,
                  block_size: int, norm: str, h: int, w: int,
                  pred: torch.Tensor | None = None,
                  out: torch.Tensor | None = None):
    """D3: the [h, w] uint8 image of the records (offs int64, dbits int32,
    counts int32, one each per block in row-major block order) of the
    payload (uint8, byte count ``nbytes`` int64 [1]) under ``quant`` (f64
    [B*B], row-major).  Counts past B*B take B*B fields.

    Records [G, N] give G frames [G, h, w] in one launch; with ``pred`` (u8
    [G, h, w]) each pixel is clamp(pred + (inverse + 128)), a P-frame's.
    The records, ``pred`` and ``out`` (where the frames go; else a new
    tensor) may be views of every k-th frame (``x[k::gop]``) whose frames
    are each contiguous."""
    if block_size not in (4, 8):
        raise ValueError(f"block size must be 4 or 8, got {block_size}")
    if h % block_size or w % block_size:
        raise ValueError(f"image {h}x{w} is not a multiple of the "
                         f"{block_size}-pixel block")
    n_blocks = (h // block_size) * (w // block_size)
    if offs.dim() not in (1, 2) or offs.shape[-1] != n_blocks or any(
            r.shape != offs.shape for r in (dbits, counts)):
        raise ValueError(f"expected {n_blocks} records a frame for {h}x{w}")
    frames = offs.shape[:-1]
    if quant.shape != (block_size * block_size,):
        raise ValueError(f"quant: expected {block_size * block_size} "
                         f"entries, got {tuple(quant.shape)}")
    for name, x in (("pred", pred), ("out", out)):
        if x is not None and tuple(x.shape) != (*frames, h, w):
            raise ValueError(f"{name}: expected {(*frames, h, w)}, got "
                             f"{tuple(x.shape)}")
    if payload.device.type == "cpu":
        return decode_blocks_plain(payload, nbytes, offs, dbits, counts,
                                   quant, block_size, norm, h, w, pred, out)
    dev = payload.device
    build.require(payload, "payload", torch.uint8, 1, dev)
    build.require(nbytes, "nbytes", torch.int64, 1, dev)
    build.require(quant, "quant", torch.float64, 1, dev)
    if out is None:
        out = torch.empty((*frames, h, w), dtype=torch.uint8, device=dev)
    if offs.dim() == 1:  # one frame
        offs, dbits, counts = offs[None], dbits[None], counts[None]
        views = [x if x is None else x[None] for x in (pred, out)]
    else:
        views = [pred, out]
    for name, x, dt in (("offs", offs, torch.int64),
                        ("dbits", dbits, torch.int32),
                        ("counts", counts, torch.int32)):
        build.require_frames(x, name, dt, 2, dev)
    if dbits.stride(0) != offs.stride(0) or counts.stride(0) != \
            offs.stride(0):
        raise ValueError("offs, dbits and counts: frames at one stride")
    for name, x in zip(("pred", "out"), views):
        if x is not None:
            build.require_frames(x, name, torch.uint8, 3, dev)
            if x.data_ptr() % 8 or x.stride(0) % 8:
                raise ValueError(f"{name}: frames must start 8-byte "
                                 f"aligned")
    pred_v, out_v = views
    wi, izz = decode_tables(block_size, norm, dev)
    if n_blocks == 0 or offs.shape[0] == 0:
        return out
    lib = build.library()
    with torch.cuda.device(dev):
        code = lib.ie_decode_blocks(
            payload.data_ptr(), nbytes.data_ptr(), offs.data_ptr(),
            dbits.data_ptr(), counts.data_ptr(), n_blocks, offs.shape[0],
            offs.stride(0), quant.data_ptr(), wi.data_ptr(), izz.data_ptr(),
            block_size, w, None if pred_v is None else pred_v.data_ptr(),
            0 if pred_v is None else pred_v.stride(0), out_v.data_ptr(),
            out_v.stride(0), build.stream_ptr(dev))
    build.check(code, "ie_decode_blocks")
    decode_blocks.launches += 1
    return out


decode_blocks.launches = 0
