"""Device half of the whole-stream Huffman encoder.

The counterpart of imageencoder_tpu/ops/huffman.py's _device_stages,
huffman_encode_from_meta and huffman_encode_device.  The host half, the
canonical dict (``_dict_and_codes``) and the raw-copy fallback
(``_fallback``), is the JAX package's own code.  The inner stream stays on
the device: the host reads the histogram (in ``meta``) once, decides the
fallback-if-bigger from it, and then reads the final words once.
"""

from __future__ import annotations

import numpy as np
import torch

from imageencoder_tpu.ops.huffman import (MAX_CODE_LEN, _dict_and_codes,
                                          _fallback)

from . import cuda_kernels, cuda_pack
from .device_pack import host_total, stream_bytes, words_to_u8

DICT_WORDS = 256  # dict upper bound: ~6.1k bits for all 256 symbols


def payload_fields(words: torch.Tensor, nbytes: int, code_w: torch.Tensor,
                   code_l: torch.Tensor):
    """The Huffman payload as K4 records: each of the first ``nbytes``
    bytes replaced by its (code, length), 16 bytes per record; bytes past
    the stream get length 0.  Returns (vals, nbits) int32 [ceil(4W/16), 16].
    """
    data = words_to_u8(words)
    n_lanes = data.shape[0]
    idx = torch.arange(n_lanes, device=words.device)
    vals = code_w[data].to(torch.int32)
    nbits = torch.where(idx < nbytes, code_l[data], 0).to(torch.int32)
    rows = -(-n_lanes // 16)
    pad = rows * 16 - n_lanes
    vals = torch.nn.functional.pad(vals, (0, pad)).reshape(rows, 16)
    nbits = torch.nn.functional.pad(nbits, (0, pad)).reshape(rows, 16)
    return vals.contiguous(), nbits.contiguous()


def payload_words(n_word_lanes: int) -> int:
    """Output words of the payload pack for a W-word inner buffer."""
    return (4 * n_word_lanes * MAX_CODE_LEN) // 32 + DICT_WORDS + 8


def pack_payload(words: torch.Tensor, nbytes: int, code_w: torch.Tensor,
                 code_l: torch.Tensor, start_bit: int,
                 dict_words: torch.Tensor):
    """Replace each of the first ``nbytes`` bytes by its code and pack the
    codes after the dict (start_bit = dict bits), with the dict words in
    the first DICT_WORDS words (K4).

    Returns (words int32 [(4W * 15) // 32 + DICT_WORDS + 8], total_bits).
    """
    vals, nbits = payload_fields(words, nbytes, code_w, code_l)
    return cuda_pack.pack_records(vals, nbits, start_bit,
                                  payload_words(words.shape[0]),
                                  prefix=dict_words)


def bucket_words(words: torch.Tensor, inner_bytes: int) -> torch.Tensor:
    """Trim the worst-case pack buffer to a power-of-two bucket of words
    (imageencoder_tpu huffman.py:561-566): the payload pack's work scales
    with the buffer, not the stream."""
    need = (inner_bytes + 3) // 4
    bucket = 1024
    while bucket < need:
        bucket *= 2
    return words[:bucket] if bucket < words.shape[0] else words


def dict_tensors(built, device):
    """(code_w, code_l, dict_words, dict_bits) on ``device`` for a dict
    built by ``_dict_and_codes``: the per-byte codes and lengths, the
    serialized dict as DICT_WORDS stream words, and its length in bits."""
    w, code_words, lengths = built
    dict_stream = w.getvalue()
    dbuf = np.zeros(DICT_WORDS * 4, dtype=np.uint8)
    dbuf[:len(dict_stream)] = np.frombuffer(dict_stream, dtype=np.uint8)
    dict_words = torch.from_numpy(
        dbuf.view(">u4").astype(np.uint32).view(np.int32)).to(device)
    return (torch.as_tensor(code_words.astype(np.int64), device=device),
            torch.as_tensor(lengths.astype(np.int64), device=device),
            dict_words, w.position)


def _encode_with_dict(words: torch.Tensor, inner_bytes: int, built):
    """Pack the payload under a built dict; returns (out words, out_total)
    still on the device."""
    code_w, code_l, dict_words, dict_bits = dict_tensors(built, words.device)
    return pack_payload(words, inner_bytes, code_w, code_l, dict_bits,
                        dict_words)


def huffman_encode_from_meta(words: torch.Tensor, meta) -> bytes:
    """Final stream from the (words, meta) pair of
    ops/pipeline.make_encode_packed_hist, with meta already on the host
    (meta[0] total_bits, meta[1:] the byte histogram).

    The compressed size is dict_bits + freqs . code_lengths, known on the
    host before any packing, so the fallback-if-bigger is decided first;
    then the payload pack runs on the device and its words come back in
    one exact-size copy.
    """
    meta = np.asarray(meta)
    total_bits = host_total(meta[0])
    freqs = meta[1:]
    inner_bytes = (total_bits + 7) // 8
    built = _dict_and_codes(freqs)
    if built is None:
        return _fallback(stream_bytes(words, total_bits))
    w, _, lengths = built
    out_total = w.position + int(freqs.astype(np.int64) @ lengths)
    if inner_bytes < (out_total + 7) // 8:
        return _fallback(stream_bytes(words, total_bits))
    out, _ = _encode_with_dict(bucket_words(words, inner_bytes), inner_bytes,
                               built)
    return stream_bytes(out, out_total)


def huffman_encode_device(words: torch.Tensor, total_bits: int) -> bytes:
    """Huffman over a packed inner stream that has no histogram yet: runs
    K3 itself (one more round trip than :func:`huffman_encode_from_meta`).
    """
    inner_bytes = (int(total_bits) + 7) // 8
    words = bucket_words(words, inner_bytes)
    total = torch.tensor([int(total_bits)], dtype=torch.int64,
                         device=words.device)
    freqs = cuda_kernels.byte_histogram(words, total).cpu().numpy()
    built = _dict_and_codes(freqs)
    if built is None:
        return _fallback(stream_bytes(words, int(total_bits)))
    out, out_total = _encode_with_dict(words, inner_bytes, built)
    out_total = int(out_total)
    if inner_bytes < (out_total + 7) // 8:
        return _fallback(stream_bytes(words, int(total_bits)))
    return stream_bytes(out, out_total)
