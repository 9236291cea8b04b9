"""The port's image decode on the CPU: every copied host function against
its JAX-package original, and imageencoder_tpu_torch.decode_image(device=
"cpu") pixel for pixel against imageencoder_tpu.decode_image(backend=
"numpy"), the exact f64 engine.

The stream builders at the top (records that resync late or never, dicts
of one symbol or of equal lengths) are also the card tests' adversarial
inputs (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest

import torch

import imageencoder_tpu
from imageencoder_tpu.models import headers as jax_headers
from imageencoder_tpu.models import image as jax_image
from imageencoder_tpu.ops import bitpack as jax_bitpack
from imageencoder_tpu.ops import dct as jax_dct
from imageencoder_tpu.ops import huffman as jax_huffman
from imageencoder_tpu.utils import bits as jax_bits
from imageencoder_tpu.utils.quant import QuantMatrix
import imageencoder_tpu_torch
from imageencoder_tpu_torch import quant_from_numpy
from imageencoder_tpu_torch.models import headers
from imageencoder_tpu_torch.models import image as port_image
from imageencoder_tpu_torch.ops import bitpack, cuda_decode, dct, huffman
from imageencoder_tpu_torch.utils import bits
from imageencoder_tpu_torch.utils.exceptions import StreamFormatError

from test_torch_image import CASES, quant_for, smooth_image

# ---- stream builders (also used on the card) ----


def pack(values, nbits) -> bytes:
    return bitpack.pack_fields(np.asarray(values, np.int64),
                               np.asarray(nbits, np.int64))[0]


def record_stream(kind: str, n: int, seed: int, use_rle: bool = True,
                  k: int = 16, lead: int = 0):
    """(payload bytes, n records) of block records after ``lead`` zero
    bits.  Kinds: "zeros" (every b = 0: records 4 bits apart), "long"
    (b = 15 and count = k: 4 + 15 + 15k bits each, so speculative walkers
    stay out of phase), "random" (b in 0..15, counts in 0..k), "corrupt"
    (random, with counts past k on some records)."""
    rng = np.random.default_rng(seed)
    vals, nb = [0], [lead]
    for i in range(n):
        if kind == "zeros":
            b, cnt = 0, 0
        elif kind == "long":
            b, cnt = 15, k
        else:
            b = int(rng.integers(0, 16))
            cnt = int(rng.integers(0, k + 1))
            if kind == "corrupt" and (1 << b) > k + 1 and i % 7 == 3:
                cnt = int(rng.integers(k + 1, 1 << b))
        vals.append(b)
        nb.append(4)
        if use_rle:
            vals.append(cnt)
            nb.append(b)
        else:
            cnt = k
        vals += rng.integers(0, 1 << 15, cnt).tolist()
        nb += [b] * cnt
    return pack(vals, nb), n


def one_symbol_stream(symbol: int, code_len: int, payload_bits) -> bytes:
    """A Huffman stream whose dict holds one symbol, code 0 of
    ``code_len`` bits: [1][7-bit 1][4-bit len][8-bit sym][code][0], then
    ``payload_bits`` (0/1 ints).  Its tree is incomplete: every 1 bit is a
    bit with no child."""
    vals = [1, 1, code_len, symbol, 0, 0] + list(payload_bits)
    nb = [1, 7, 4, 8, code_len, 1] + [1] * len(payload_bits)
    return pack(vals, nb)


def equal_length_stream(n: int, seed: int) -> bytes:
    """A Huffman stream of 8 equally frequent symbols: every code is 3
    bits, so a walk that starts off the codeword grid never meets it."""
    rng = np.random.default_rng(seed)
    inner = bytes(np.repeat(np.arange(8, dtype=np.uint8) * 17,
                            n // 8)[rng.permutation(n // 8 * 8)])
    data = jax_huffman.huffman_encode(inner)
    assert data[0] & 0x80
    return data


def dict_stream(entries, payload: bytes = b"\x5a\xc3") -> bytes:
    """A Huffman stream with the given (symbol, word, length) entries, one
    group each, and a payload."""
    vals, nb = [], []
    for sym, word, ln in entries:
        vals += [1, 1, ln, sym, word]
        nb += [1, 7, 4, 8, ln]
    vals.append(0)
    nb.append(1)
    vals += list(payload)
    nb += [8] * len(payload)
    return pack(vals, nb)


def huffman_streams():
    """Named Huffman streams: port-encoded images, an equal-length dict,
    one-symbol dicts, and a stream whose padding decodes to symbols."""
    img = smooth_image(64, 96, 3)
    q = quant_from_numpy(quant_for(4).matrix)
    port_img = imageencoder_tpu_torch.encode_image(
        img, q, use_huffman=True, device="cpu")
    assert port_img[0] & 0x80
    rng = np.random.default_rng(5)
    # A two-symbol dict with code "0" for a symbol: the padding zeros
    # after the payload decode to extra copies of it.
    padded = jax_huffman.huffman_encode(bytes([7] * 31 + [9] * 3))
    return {
        "port image": port_img,
        "equal lengths": equal_length_stream(400, 1),
        "one symbol, code 0": one_symbol_stream(
            65, 1, rng.integers(0, 2, 301).tolist()),
        "one symbol, code 00": one_symbol_stream(
            66, 2, rng.integers(0, 2, 77).tolist()),
        "padding symbols": padded,
        "skewed bytes": jax_huffman.huffman_encode(bytes(np.minimum(
            rng.geometric(0.05, 3000), 255).astype(np.uint8))),
        "fifteen-bit codes": jax_huffman.huffman_encode(fifteen_bit_bytes()),
    }


def one_bit_bytes(n: int = 300_000) -> bytes:
    """n bytes of one symbol but for 1 in 64 random ones: its code is one
    bit, so a CTA of 128 chunks of 2048 bits decodes past 24 KB."""
    rng = np.random.default_rng(7)
    data = np.full(n, 42, np.uint8)
    some = rng.random(n) < 1 / 64
    data[some] = rng.integers(0, 256, int(some.sum()))
    return data.tobytes()


def fifteen_bit_bytes() -> bytes:
    """Symbol i 2**i times for i < 16, shuffled: codes of 1 to 15 bits,
    the longest the dict allows."""
    data = np.repeat(np.arange(16, dtype=np.uint8), 1 << np.arange(16))
    return np.random.default_rng(6).permutation(data).tobytes()


STREAMS = huffman_streams()


# ---- the copied host functions ----


def test_bit_reader_reads_equal_jax():
    rng = np.random.default_rng(0)
    data = bytes(rng.integers(0, 256, 40).astype(np.uint8))
    widths = rng.integers(0, 20, 30).tolist()
    got, want = bitpack.BitReader(data, 3), jax_bitpack.BitReader(data, 3)
    assert [got.get(w) for w in widths] == [want.get(w) for w in widths]
    assert got.position == want.position > 8 * len(data)  # read past end
    assert got.get_bit() == want.get_bit() == 0


def test_read_fields_and_shift_signed_equal_jax():
    rng = np.random.default_rng(1)
    data = bytes(rng.integers(0, 256, 64).astype(np.uint8))
    np.testing.assert_array_equal(bitpack.to_bits(data),
                                  jax_bitpack.to_bits(data))
    offs = rng.integers(0, 600, 200)  # past the 512 bits too
    nb = rng.integers(0, 33, 200)
    raw = bitpack.read_fields(bitpack.to_bits(data), offs, nb)
    np.testing.assert_array_equal(
        raw, jax_bitpack.read_fields(jax_bitpack.to_bits(data), offs, nb))
    widths = rng.integers(0, 16, 200)
    np.testing.assert_array_equal(bits.shift_signed(raw, widths),
                                  jax_bits.shift_signed(raw, widths))


@pytest.mark.parametrize("b,kind", [(4, "jpeg"), (8, "wide")])
def test_read_image_header_and_video_params_equal_jax(b, kind):
    q = quant_for(b).matrix.copy()
    if kind == "wide":
        q[0, 0], q[b - 1, b - 1] = 65535, 1
    writer = bitpack.BitWriter()
    writer.put_bit(0)
    headers.write_image_header(writer, quant_from_numpy(q), False, 4088,
                               12)
    headers.write_video_params(writer, headers.VideoParams(25, 4, 300))
    data = writer.getvalue()
    got, want = bitpack.BitReader(data, 1), jax_bitpack.BitReader(data, 1)
    gq, *grest = headers.read_image_header(got, b)
    wq, *wrest = jax_headers.read_image_header(want, b)
    np.testing.assert_array_equal(gq.matrix, wq.matrix)
    assert grest == wrest == [False, 4088, 12]
    assert vars(headers.read_video_params(got)) == vars(
        jax_headers.read_video_params(want))
    assert got.position == want.position == writer.position


@pytest.mark.parametrize("name", list(STREAMS))
def test_parse_dict_and_huffman_decode_equal_jax(name):
    data = STREAMS[name]
    entries, end = huffman.parse_dict_bytes(data)
    assert (entries, end) == jax_huffman.parse_dict_bytes(data)
    huffman.validate_dict_entries(entries)
    got = huffman.huffman_decode(data)
    assert got == jax_huffman.huffman_decode(data)
    # The kernel's table walks the same tree: the head decode of every
    # symbol equals the whole decode.
    table, max_len, min_len = huffman.decode_table(entries)
    assert min_len == min(ln for _, _, ln in entries)
    assert huffman.head_decode(data, end, table, max_len,
                               len(got) + 5) == got


def test_padding_decodes_to_symbols():
    data = STREAMS["padding symbols"]
    got = huffman.huffman_decode(data)
    assert len(got) > 34 and got[:34] == bytes([7] * 31 + [9] * 3)


@pytest.mark.parametrize("entries,ok", [
    ([(1, 0, 1), (2, 2, 2), (3, 3, 2)], True),
    ([(1, 0, 1)], True),  # one symbol: an incomplete tree is fine
    ([(1, 0, 0), (2, 1, 1)], False),  # a zero-length code
    ([(1, 1, 2), (2, 1, 2)], False),  # a duplicate code
    ([(1, 0, 1), (2, 1, 2)], False),  # "0" prefixes "01"
    ([(1, 1, 2), (2, 0, 1)], False),  # "01" extends "0"
])
def test_validate_dict_entries_equals_jax(entries, ok):
    if ok:
        huffman.validate_dict_entries(entries)
        jax_huffman.validate_dict_entries(entries)
        return
    with pytest.raises(StreamFormatError) as got:
        huffman.validate_dict_entries(entries)
    with pytest.raises(Exception) as want:
        jax_huffman.validate_dict_entries(entries)
    assert type(want.value).__name__ == type(got.value).__name__


@pytest.mark.parametrize("kind,use_rle,lead", [
    ("zeros", True, 3), ("long", True, 0), ("random", True, 5),
    ("random", False, 1), ("corrupt", True, 2)])
def test_walk_and_extract_equal_jax(kind, use_rle, lead):
    data, n = record_stream(kind, 60, 7, use_rle, lead=lead)
    for n_blocks in (n, n + 9):  # past the end: records of zeros
        got = port_image.walk_block_offsets(None, lead, n_blocks, use_rle,
                                            packed=data)
        want = jax_image.walk_block_offsets(None, lead, n_blocks, use_rle,
                                            packed=data)
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
        assert got[3] == want[3]
        coeffs, end = port_image.extract_block_coeffs(
            None, lead, n_blocks, use_rle, packed=data)
        wcoeffs, wend = jax_image.extract_block_coeffs(
            None, lead, n_blocks, use_rle, packed=data)
        np.testing.assert_array_equal(coeffs, wcoeffs)
        assert end == wend


@pytest.mark.parametrize("b,norm", [(4, "reference"), (8, "ortho")])
def test_inverse_transform_equals_jax(b, norm):
    rng = np.random.default_rng(b)
    coeffs = rng.integers(-300, 300, (50, b, b)).astype(np.int32)
    q = quant_for(b).matrix.astype(np.float64)
    px = dct.inverse_transform(coeffs, q, norm)
    want = jax_dct.inverse_transform(coeffs, q, norm)
    np.testing.assert_array_equal(px, want)  # bit for bit
    np.testing.assert_array_equal(dct.clamp_to_u8(px),
                                  jax_dct.clamp_to_u8(want))


# ---- decode_image against the exact host engine ----


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("h,w,use_rle,use_huffman,b,norm", CASES)
def test_decode_image_equals_host_engine(h, w, use_rle, use_huffman, b,
                                         norm, writer):
    img = smooth_image(h, w, h * w)
    quant = quant_for(b)
    if writer == "port":
        data = imageencoder_tpu_torch.encode_image(
            img, quant_from_numpy(quant.matrix), use_rle=use_rle,
            use_huffman=use_huffman, norm=norm, block_size=b, device="cpu")
    else:
        data = imageencoder_tpu.encode_image(
            img, quant, use_rle=use_rle, use_huffman=use_huffman, norm=norm,
            backend="numpy", block_size=b)
    got = imageencoder_tpu_torch.decode_image(data, norm=norm, block_size=b,
                                              device="cpu")
    want = imageencoder_tpu.decode_image(data, norm=norm, backend="numpy",
                                         block_size=b)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_image_of_the_fallback_stream():
    noise = np.random.default_rng(9).integers(0, 256, (32, 64), np.uint8)
    ones = QuantMatrix(np.ones((4, 4), np.uint32))
    data = imageencoder_tpu.encode_image(noise, ones, use_huffman=True,
                                         backend="numpy")
    assert not data[0] & 0x80  # stored raw after a 0 bit
    got = imageencoder_tpu_torch.decode_image(data, device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), imageencoder_tpu.decode_image(data, backend="numpy"))


def test_decode_image_of_a_truncated_stream():
    """Records past the end read zeros, on both sides."""
    img = smooth_image(32, 32, 4)
    data = imageencoder_tpu.encode_image(img, quant_for(4), use_rle=True,
                                         backend="numpy")[:120]
    got = imageencoder_tpu_torch.decode_image(data, device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), imageencoder_tpu.decode_image(data, backend="numpy"))


def test_empty_stream_raises():
    with pytest.raises(StreamFormatError, match="empty stream"):
        imageencoder_tpu_torch.decode_image(b"", device="cpu")


def test_stream_without_dict_raises_value_error():
    data = b"\x80\x00"  # the Huffman flag, then a group of 0 entries
    with pytest.raises(ValueError, match="without a dict"):
        imageencoder_tpu_torch.decode_image(data, device="cpu")
    with pytest.raises(ValueError, match="without a dict"):
        jax_huffman.huffman_decode(data)


def test_corrupt_dict_raises_stream_format_error():
    data = dict_stream([(1, 1, 2), (2, 1, 2)])  # a duplicate code
    with pytest.raises(StreamFormatError, match="duplicate"):
        imageencoder_tpu_torch.decode_image(data, device="cpu")
    with pytest.raises(Exception, match="duplicate"):
        imageencoder_tpu.decode_image(data, backend="numpy")


# ---- the wrappers' plain versions on CPU tensors ----


def _u8(data: bytes, tail: int = 0, fill: int = 0xFF) -> torch.Tensor:
    return torch.tensor(list(data) + [fill] * tail, dtype=torch.uint8)


def _count(n: int) -> torch.Tensor:
    return torch.tensor([n], dtype=torch.int64)


def d1_args(data: bytes, tail: int = 0):
    """D1's arguments for a Huffman stream: (stream, nbytes, start_bit,
    table int16, max_len, cap)."""
    entries, end = huffman.parse_dict_bytes(data)
    table, max_len, min_len = huffman.decode_table(entries)
    cap = cuda_decode.payload_capacity(8 * len(data) - end, min_len)
    return (_u8(data, tail), _count(len(data)), end,
            torch.from_numpy(table.view(np.int16)), max_len, cap)


@pytest.mark.parametrize("name", list(STREAMS))
def test_huffman_decode_wrapper_on_cpu(name):
    data = STREAMS[name]
    out, count = cuda_decode.huffman_decode(*d1_args(data, tail=9),
                                            chunk_bits=32)
    want = jax_huffman.huffman_decode(data)
    assert int(count) == len(want)
    assert out[:len(want)].numpy().tobytes() == want
    assert cuda_decode.huffman_decode.launches == 0  # the plain version


@pytest.mark.parametrize("kind,use_rle", [("random", True),
                                          ("random", False),
                                          ("corrupt", True)])
def test_walk_and_block_decode_wrappers_on_cpu(kind, use_rle):
    data, n = record_stream(kind, 48, 3, use_rle, lead=6)
    n_blocks = n + 16  # 64 blocks of an 8x128 image, the last past the end
    payload, nbytes = _u8(data, tail=40), _count(len(data))
    offs, dbits, counts, end = cuda_decode.walk_offsets(
        payload, nbytes, 6, n_blocks, use_rle, 4, chunk_bits=64)
    want = jax_image.walk_block_offsets(None, 6, n_blocks, use_rle,
                                        packed=data)
    for a, b in zip((offs, dbits, counts), want[:3]):
        np.testing.assert_array_equal(a.numpy(), b)
    assert int(end) == want[3]
    quant = torch.tensor(quant_for(4).matrix.ravel(), dtype=torch.float64)
    img = cuda_decode.decode_blocks(payload, nbytes, offs, dbits, counts,
                                    quant, 4, "reference", 8, 128)
    coeffs, _ = jax_image.extract_block_coeffs(None, 6, n_blocks, use_rle,
                                               packed=data)
    px = jax_dct.clamp_to_u8(jax_dct.inverse_transform(
        coeffs, quant_for(4).matrix.astype(np.float64), "reference"))
    np.testing.assert_array_equal(
        img.numpy(), px.reshape(2, 32, 4, 4).swapaxes(1, 2).reshape(8, 128))
