"""The Huffman dict table: the dict kernel's output, K4 pack_payload's input.

One int32 tensor of TABLE_WORDS words, laid out as csrc/dict_table.cuh
lays it out for the kernels (csrc/huffman.cu writes it, csrc/pack.cu reads
it):

    [CODE_W, CODE_W + 256)  each byte value's canonical code
    [CODE_L, CODE_L + 256)  its length in bits, 0 for a byte absent
    [DICT, DICT + 256)      the serialized dict, DICT_WORDS u32 stream
                            words (int32 bits), MSB first
    [META, TABLE_WORDS)     int64 fields, in META_FIELDS order

The fields: the dict's bits (the payload's start bit), the out total (dict
bits plus the payload's), the inner stream's bits (-1 for a refused
stream), the fallback flag (fewer than 2 byte values, or a coded stream not
smaller than the inner one), the bytes K4 codes (0 on the fallback), the
error word (the length limit failed) and the first byte K4 codes (0 from
the dict kernel; the sharded encode's stage 2 codes a window of a
segment's bytes, parallel/sharding.py).
"""

from __future__ import annotations

import numpy as np
import torch

DICT_WORDS = 256  # the dict takes at most 6,093 bits
CODE_W, CODE_L, DICT, META = 0, 256, 512, 768
META_FIELDS = ("dict_bits", "out_total", "inner_bits", "fallback", "nbytes",
               "error", "first_byte")
N_META = 8  # int64 fields, the last one unused
TABLE_WORDS = META + 2 * N_META


def meta(table: torch.Tensor) -> torch.Tensor:
    """The table's int64 fields, a view: int64 [N_META]."""
    return table[META:].view(torch.int64)


def make_table(code_w, code_l, dict_words, device, **fields) -> torch.Tensor:
    """A table from its parts (array-likes of 256 int32 each; the fields by
    name, 0 where not given) on ``device``."""
    unknown = set(fields) - set(META_FIELDS)
    if unknown:
        raise ValueError(f"unknown table fields {sorted(unknown)}")
    table = np.zeros(TABLE_WORDS, np.int32)
    for at, part in ((CODE_W, code_w), (CODE_L, code_l), (DICT, dict_words)):
        table[at:at + 256] = np.asarray(part).astype(np.int64).astype(np.int32)
    table[META:].view(np.int64)[:len(META_FIELDS)] = [
        int(fields.get(name, 0)) for name in META_FIELDS]
    return torch.from_numpy(table).to(device)


def fields(table: torch.Tensor) -> dict:
    """The table's fields as host ints, by name (reads the device)."""
    return dict(zip(META_FIELDS, meta(table).tolist()))
