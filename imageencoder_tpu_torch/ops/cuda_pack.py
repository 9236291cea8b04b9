"""K2 and K4: the bitstream packer, one kernel with two front ends.

The counterpart of imageencoder_tpu/ops/pallas_pack.py:

  * :func:`pack_locals` (K2, pack_locals_pallas) concatenates register
    files and bit lengths from the encode front end (ops/cuda_encode.py);
  * :func:`pack_records` (K4, pack_records_pallas) concatenates [N, F]
    field tensors of (value, nbits) pairs, fields at most 16 bits wide.

Both return (words int32 [n_words], total_bits int64 0-d tensor, start_bit
included); the words are the u32 stream, MSB-first, zero past the end.
``prefix`` words, the header or dict bits that lie before ``start_bit``,
are written into the output buffer before the kernel ORs the records in.
On a CUDA tensor the wrappers launch csrc/pack.cu; on a CPU tensor they run
the plain packer of ops/device_pack.py.  The total and every start stay on
the device: nothing waits on the host.
"""

from __future__ import annotations

import torch

from ..kernels import build
from . import device_pack


def _block_starts(lens: torch.Tensor, start_bit: int):
    """Absolute start bit of each kernel block of records, and the total:
    per-block sums of the record lengths through torch.cumsum in int64."""
    threads = build.library().ie_pack_threads()
    n = lens.shape[0]
    g = -(-n // threads)
    padded = torch.zeros(g * threads, dtype=torch.int64, device=lens.device)
    padded[:n] = lens
    sums = padded.view(g, threads).sum(dim=1)
    starts = start_bit + torch.cumsum(sums, dim=0) - sums
    return starts, start_bit + sums.sum()


def _output(n_words: int, prefix, device) -> torch.Tensor:
    out = torch.zeros(n_words, dtype=torch.int32, device=device)
    if prefix is not None:
        m = min(prefix.shape[0], n_words)
        out[:m] = prefix[:m]
    return out


def pack_locals_plain(local, lens, start_bit: int, n_words: int,
                      prefix=None):
    """The plain version of K2, on any device."""
    return device_pack.merge_records(device_pack.as_uint(local), lens,
                                     start_bit, n_words, prefix)


def pack_records_plain(vals, nbits, start_bit: int, n_words: int,
                       prefix=None):
    """The plain version of K4, on any device."""
    return device_pack.pack_blocks(vals, nbits, start_bit, n_words, prefix)


def pack_locals(local: torch.Tensor, lens: torch.Tensor, start_bit: int,
                n_words: int, prefix: torch.Tensor | None = None):
    """Pack register files int32 [N, lw] with bit lengths int32 [N]."""
    if local.device.type == "cpu":
        return pack_locals_plain(local, lens, start_bit, n_words, prefix)
    dev = local.device
    build.require(local, "local", torch.int32, 2, dev)
    build.require(lens, "lens", torch.int32, 1, dev)
    n, lw = local.shape
    if lens.shape[0] != n:
        raise ValueError(f"lens has {lens.shape[0]} records, local {n}")
    starts, total = _block_starts(lens, start_bit)
    out = _output(n_words, prefix, dev)
    with torch.cuda.device(dev):
        code = build.library().ie_pack_locals(
            local.data_ptr(), lens.data_ptr(), n, lw, starts.data_ptr(),
            out.data_ptr(), n_words, build.stream_ptr(dev))
    build.check(code, "ie_pack_locals")
    pack_locals.launches += 1
    return out, total


pack_locals.launches = 0


def pack_records(vals: torch.Tensor, nbits: torch.Tensor, start_bit: int,
                 n_words: int, prefix: torch.Tensor | None = None):
    """Pack [N, F] int32 fields (values, widths <= 16; width 0 = skip)."""
    if vals.device.type == "cpu":
        return pack_records_plain(vals, nbits, start_bit, n_words, prefix)
    dev = vals.device
    build.require(vals, "vals", torch.int32, 2, dev)
    build.require(nbits, "nbits", torch.int32, 2, dev)
    if nbits.shape != vals.shape:
        raise ValueError(f"nbits {tuple(nbits.shape)} != vals "
                         f"{tuple(vals.shape)}")
    n, f = vals.shape
    starts, total = _block_starts(nbits.sum(dim=1), start_bit)
    out = _output(n_words, prefix, dev)
    with torch.cuda.device(dev):
        code = build.library().ie_pack_records(
            vals.data_ptr(), nbits.data_ptr(), n, f, starts.data_ptr(),
            out.data_ptr(), n_words, build.stream_ptr(dev))
    build.check(code, "ie_pack_records")
    pack_records.launches += 1
    return out, total


pack_records.launches = 0
