"""Per-block RLE statistics and wire fields on torch tensors.

The counterpart of imageencoder_tpu/ops/rle.py, whose module docstring
defines the wire format.  That module picks numpy or jax.numpy by the
argument's type and treats a torch tensor as numpy, so the port carries
its own copy of the two functions.  The behaviours it must keep:

  * ``data_bits`` is at least ``ffs(length_full)`` and, because ``ffs(0)``
    is undefined in the reference, at least 1 (rle.py:59);
  * in RLE mode a block whose last zig-zag coefficient is nonzero and
    follows a zero drops that coefficient and its zero run (the
    trailing-strip quirk, rle.py:61-70);
  * without RLE a block writes all K coefficients and no count.

These are the plain versions of the statistics the K1 kernel
(csrc/encode.cu) computes per thread.
"""

from __future__ import annotations

import torch


def bit_length(x: torch.Tensor) -> torch.Tensor:
    """Bits in the binary form of non-negative integers (0 -> 0); exact
    below 2**53 through the float64 exponent."""
    return torch.frexp(x.to(torch.float64))[1].to(torch.int64)


def bits_needed(v: torch.Tensor) -> torch.Tensor:
    """Minimal signed two's-complement width of each value (utils/bits.py)."""
    v = v.to(torch.int64)
    return bit_length(torch.where(v >= 0, v, -v - 1)) + 1


def block_stats(coeffs_zz: torch.Tensor, use_rle: bool) -> dict:
    """Wire stats of [N, K] zig-zag coefficients: int64 [N] tensors
    ``data_bits``, ``count``, ``n_payload`` and ``total_bits``."""
    n, k = coeffs_zz.shape
    dev = coeffs_zz.device
    nz = coeffs_zz != 0
    pos = torch.arange(1, k + 1, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    length_full = torch.where(nz, pos, zero).amax(dim=1)
    max_bits = torch.where(nz, bits_needed(coeffs_zz), zero).amax(dim=1)
    data_bits = torch.clamp(torch.maximum(max_bits, bit_length(length_full)),
                            min=1)

    if use_rle:
        if k > 1:
            length_head = torch.where(nz[:, :k - 1], pos[:k - 1],
                                      zero).amax(dim=1)
        else:
            length_head = torch.zeros_like(length_full)
        gap = (k - 1) - length_head
        count = torch.where((length_full == k) & (gap > 0), length_head,
                            length_full)
        n_payload = count
        total_bits = 4 + data_bits + n_payload * data_bits
    else:
        count = length_full
        n_payload = torch.full_like(length_full, k)
        total_bits = 4 + n_payload * data_bits
    return {"data_bits": data_bits, "count": count, "n_payload": n_payload,
            "total_bits": total_bits}


def block_fields(coeffs_zz: torch.Tensor, stats: dict, use_rle: bool):
    """(values, nbits) int64 [N, K+2]: the 4-bit width, the count (RLE
    only) and the first n_payload coefficients, data_bits wide each.
    Unused slots have nbits 0."""
    n, k = coeffs_zz.shape
    dev = coeffs_zz.device
    data_bits = stats["data_bits"]
    vals = torch.zeros((n, k + 2), dtype=torch.int64, device=dev)
    nbits = torch.zeros((n, k + 2), dtype=torch.int64, device=dev)
    vals[:, 0] = data_bits
    nbits[:, 0] = 4
    if use_rle:
        vals[:, 1] = stats["count"]
        nbits[:, 1] = data_bits
    live = (torch.arange(k, device=dev)[None, :]
            < stats["n_payload"][:, None])
    vals[:, 2:] = torch.where(live, coeffs_zz.to(torch.int64), 0)
    nbits[:, 2:] = torch.where(live, data_bits[:, None], 0)
    return vals, nbits
