"""The plain two-level bitstream packer on torch tensors.

The counterpart of imageencoder_tpu/ops/device_pack.py's scatter path
(pack_blocks_device, device_pack.py:233-258), and the plain version of the
K2 and K4 kernels (ops/cuda_pack.py):

  level 1: each record's fields go MSB-first into a private register file
           of ``lw`` words (an exclusive cumsum of field widths gives each
           field's bit offset inside the record);
  level 2: an exclusive scan of record lengths, in int64, gives each
           record's start bit; its words are funnel-shifted by
           ``start & 31`` and added at word ``start >> 5``.  Records' bits
           never overlap, so the add equals an OR.

Stream words are u32.  torch has no shifts, ``index_add_`` or
``scatter_add_`` for ``uint32`` on the CPU, so this module computes on
int64 holding values in [0, 2**32) and masks explicitly; at its boundary a
word travels as an int32 tensor holding the same 32 bits (``as_int32`` /
``as_uint``).  Shift amounts are clamped below 32 where a wider shift
would be undefined on the card.

The numpy helpers at the top (header words, register-file words, word
serialization) are the port's copies of imageencoder_tpu/ops/
device_pack.py's; packed_words_bound is the port's own, sized from K1's
register file.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
MAX_FIELD_BITS = 16  # coefficients, counts, mvecs, Huffman codes all fit
HEADER_WORDS = 64  # host header prefix capacity (2048 bits)


def local_words(n_fields: int) -> int:
    """Register-file words per record: worst case every field at 16 bits."""
    return (n_fields * MAX_FIELD_BITS + 31) // 32


def packed_words_bound(n_records: int, lw: int) -> int:
    """Output words of a stream of n_records records of at most lw words
    each (K1's register file: a longer record is refused) after its
    header, in whole 16-byte vectors so that each row of a batch starts
    aligned.  K4 sizes its grid by the stream's words."""
    return -(-(n_records * lw + HEADER_WORDS) // 4) * 4


def header_to_words(header: bytes) -> np.ndarray:
    """A host-packed header as the u32 [HEADER_WORDS] stream prefix."""
    if len(header) > HEADER_WORDS * 4:
        raise ValueError(f"header of {len(header)} bytes exceeds "
                         f"{HEADER_WORDS} words")
    buf = np.zeros(HEADER_WORDS * 4, dtype=np.uint8)
    buf[:len(header)] = np.frombuffer(header, dtype=np.uint8)
    return buf.view(">u4").astype(np.uint32)


def words_to_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """Big-endian serialization of u32 words, trimmed to whole bytes."""
    nbytes = (int(total_bits) + 7) // 8
    nw = (nbytes + 3) // 4
    return np.asarray(words[:nw]).astype(">u4").tobytes()[:nbytes]


def bytes_to_words(data: bytes) -> np.ndarray:
    """The inverse of :func:`words_to_bytes`: bytes -> int32 bit patterns
    of the big-endian u32 words, the last one zero-padded."""
    buf = np.zeros(((len(data) + 3) // 4) * 4, dtype=np.uint8)
    buf[:len(data)] = np.frombuffer(data, dtype=np.uint8)
    return buf.view(">u4").astype(np.uint32).view(np.int32)


def as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor with the same 32 bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def as_uint(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2**32)."""
    return x.to(torch.int64) & MASK32


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device``.  To a card it goes through
    pinned memory by a copy that does not wait for the device (PyTorch's
    pinned-memory allocator keeps the block until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """Stream words (int32 bit patterns, any device) -> host uint32.  From
    a card one copy into pinned memory and a wait on its own event, not on
    the work queued after it."""
    if words.device.type == "cuda":
        host = torch.empty(words.shape, dtype=words.dtype, pin_memory=True)
        host.copy_(words, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        words = host
    return words.numpy().view(np.uint32)


def host_total(total_bits) -> int:
    """A stream's total bits as a host int.  Raises on -1, the total of an
    encode with a refused record (cuda_pack.pack_locals, pack_coeffs)."""
    total = int(total_bits)
    if total < 0:
        raise ValueError("a block record is longer than its register file "
                         "(K1 input outside its dtype's bound)")
    return total


def stream_bytes(words: torch.Tensor, total_bits: int) -> bytes:
    """The first ceil(total_bits / 8) stream bytes; copies only the words
    that hold them to the host."""
    nw = ((total_bits + 7) // 8 + 3) // 4
    return words_to_bytes(words_to_numpy(words[:nw]), total_bits)


def words_to_u8(words: torch.Tensor) -> torch.Tensor:
    """Stream words -> int64 bytes in stream order: each word's top byte
    first, whatever the host's endianness."""
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64,
                          device=words.device)
    return ((as_uint(words)[:, None] >> shifts) & 0xFF).reshape(-1)


def register_files(vals: torch.Tensor, nbits: torch.Tensor, lw: int):
    """Level 1: [N, F] fields -> (register files int64 [N, lw], record
    lengths int64 [N]).  Fields are at most 32 bits wide."""
    nb = nbits.to(torch.int64)
    n, _ = nb.shape
    off = torch.cumsum(nb, dim=1) - nb
    lens = nb.sum(dim=1)
    v = vals.to(torch.int64) & ((1 << nb) - 1)

    wi = off >> 5
    avail = 32 - (off & 31)
    fits = nb <= avail
    part1 = torch.where(fits, v << (avail - nb).clamp(0, 31),
                        v >> (nb - avail).clamp(0, 31))
    part1 = torch.where(nb > 0, part1, 0)
    spill = torch.where(fits, 0, nb - avail)
    part2 = torch.where(spill > 0, (v << (32 - spill).clamp(0, 31)) & MASK32,
                        0)

    # Columns lw and lw+1 catch zero-width fields at a record's very end.
    local = torch.zeros((n, lw + 2), dtype=torch.int64, device=nb.device)
    local.scatter_add_(1, wi.clamp(max=lw + 1), part1)
    local.scatter_add_(1, (wi + 1).clamp(max=lw + 1), part2)
    return local[:, :lw], lens


def merge_records(local: torch.Tensor, lens: torch.Tensor, start_bit: int,
                  n_words: int, prefix: torch.Tensor | None = None):
    """Level 2: concatenate register files into one stream at start_bit.

    local: int64 [N, lw] words in [0, 2**32); lens: [N] record bit lengths.
    ``prefix`` (int32 words) is OR'd into the first words: the header or
    dict bits that lie before start_bit.  Words past ``n_words`` are
    dropped.  Returns (words int32 [n_words], total_bits int64 0-d tensor,
    start_bit included).
    """
    n, lw = local.shape
    dev = local.device
    lens = lens.to(torch.int64)
    starts = start_bit + torch.cumsum(lens, dim=0) - lens
    total = start_bit + lens.sum()

    s = (starts & 31)[:, None]
    base = starts >> 5
    zcol = torch.zeros((n, 1), dtype=torch.int64, device=dev)
    cur = torch.cat([local, zcol], dim=1)
    prev = torch.cat([zcol, local], dim=1)
    lo = torch.where(s > 0, (prev << (32 - s).clamp(0, 31)) & MASK32, 0)
    shifted = (cur >> s) | lo                                  # [N, lw+1]

    idx = base[:, None] + torch.arange(lw + 1, device=dev)[None, :]
    idx = torch.where(idx < n_words, idx, n_words)  # slot n_words: dropped
    words = torch.zeros(n_words + 1, dtype=torch.int64, device=dev)
    words.index_add_(0, idx.reshape(-1), shifted.reshape(-1))
    words = words[:n_words]
    if prefix is not None:
        m = min(prefix.shape[0], n_words)
        words[:m] |= as_uint(prefix[:m])
    return as_int32(words), total


def pack_blocks(vals: torch.Tensor, nbits: torch.Tensor, start_bit: int,
                n_words: int, prefix: torch.Tensor | None = None):
    """Dense-layout pack of [N, F] fields (device_pack.pack_blocks_device
    with method="scatter"); returns (words int32 [n_words], total_bits)."""
    local, lens = register_files(vals, nbits, local_words(vals.shape[1]))
    return merge_records(local, lens, start_bit, n_words, prefix)
