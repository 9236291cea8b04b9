"""MSB-first bit packing on the host, in numpy.

The port's copy of what it uses from imageencoder_tpu/ops/bitpack.py: the
header writer (:class:`BitWriter`), the field packer behind it
(:func:`pack_fields`), the bit-granular splice of independently encoded
chunks (:func:`concat_bit_segments`), and on the way back the header
reader (:class:`BitReader`) and the field gather (:func:`read_fields`).
There is no native path.

Semantics of the reference writer (BitStream.cpp:61-77): values are
truncated to their field width, bits go MSB-first within each field and
each byte, and the padding bits of the last byte are zero.  The reader
reads zeros past the end (BitStream.cpp:14-28).
"""

from __future__ import annotations

import numpy as np


def pack_fields(values, nbits, pad_to_bytes: int | None = None):
    """Pack (value, nbits) fields MSB-first; zero-width fields are skipped.

    Returns (bytes, total bits).  With ``pad_to_bytes`` the output is
    zero-padded to at least that many bytes.
    """
    values = np.asarray(values, dtype=np.int64).ravel()
    nbits = np.asarray(nbits, dtype=np.int64).ravel()
    offsets = np.cumsum(nbits) - nbits
    total_bits = int(offsets[-1] + nbits[-1]) if len(nbits) else 0
    nbytes = (total_bits + 7) // 8
    if pad_to_bytes is not None:
        nbytes = max(nbytes, pad_to_bytes)
    bitbuf = np.zeros(nbytes * 8, dtype=np.uint8)
    uvals = values.view(np.uint64)
    for j in range(int(nbits.max()) if len(nbits) else 0):
        live = nbits > j
        shift = (nbits[live] - 1 - j).astype(np.uint64)
        bitbuf[offsets[live] + j] = (uvals[live] >> shift) & 1
    return np.packbits(bitbuf).tobytes(), total_bits


def to_bits(data) -> np.ndarray:
    """bytes -> uint8 bit vector, MSB-first in each byte."""
    return np.unpackbits(np.frombuffer(data, dtype=np.uint8))


def read_fields(bits: np.ndarray, offsets, nbits) -> np.ndarray:
    """Unsigned fields gathered from a bit vector: field i is the nbits[i]
    (at most 32) bits from offsets[i], MSB-first; bits past the end read
    as 0.  Returns uint32 [M]."""
    offsets = np.asarray(offsets, dtype=np.int64)
    nbits = np.asarray(nbits, dtype=np.int64)
    out = np.zeros(offsets.shape, dtype=np.uint32)
    max_w = int(nbits.max()) if len(nbits) else 0
    n = len(bits)
    for j in range(max_w):
        live = nbits > j
        pos = offsets[live] + j
        valid = pos < n
        bit = np.zeros(pos.shape, dtype=np.uint32)
        bit[valid] = bits[pos[valid]]
        shift = (nbits[live] - 1 - j).astype(np.uint32)
        out[live] |= bit << shift
    return out


def concat_bit_segments(segments) -> bytes:
    """Concatenate (bytes, nbits) bit strings at bit granularity: exactly
    nbits from the start of each, MSB-first, zero-padded to a byte."""
    total_bits = sum(nb for _, nb in segments)
    bitbuf = np.zeros(((total_bits + 7) // 8) * 8, dtype=np.uint8)
    pos = 0
    for data, nb in segments:
        bitbuf[pos:pos + nb] = np.unpackbits(
            np.frombuffer(data, dtype=np.uint8))[:nb]
        pos += nb
    return np.packbits(bitbuf).tobytes()


class BitWriter:
    """Sequential writer for headers: collects (value, nbits) fields and
    packs them on :meth:`getvalue` (util::BitStreamWriter semantics)."""

    def __init__(self) -> None:
        self.values: list[int] = []
        self.nbits: list[int] = []

    def put(self, nbits: int, value: int) -> None:
        self.values.append(int(value))
        self.nbits.append(int(nbits))

    def put_bit(self, bit: int) -> None:
        self.put(1, bit)

    @property
    def position(self) -> int:
        return int(sum(self.nbits))

    def getvalue(self) -> bytes:
        return pack_fields(self.values, self.nbits)[0]


class BitReader:
    """Sequential MSB-first reader of bytes (util::BitStreamReader): reads
    past the end return 0 bits.  A field is read from the bytes that hold
    it, not a bit at a time."""

    def __init__(self, data, position: int = 0) -> None:
        self.data = bytes(data)
        self.position = position

    def get(self, nbits: int) -> int:
        if nbits <= 0:
            return 0
        end = self.position + nbits
        first, last = self.position >> 3, (end + 7) >> 3
        window = self.data[first:last]  # short or empty past the end
        v = int.from_bytes(window, "big") << (8 * (last - first - len(window)))
        self.position = end
        return (v >> (8 * last - end)) & ((1 << nbits) - 1)

    def get_bit(self) -> int:
        return self.get(1)
