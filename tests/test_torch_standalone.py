"""The port stands alone: imageencoder_tpu_torch imports nothing of the JAX
package and keeps its own copy of the host code it needs.

  * with both ``jax`` and ``imageencoder_tpu`` blocked, a fresh process
    imports the port, encodes an image and a 40-frame video (raw and
    recon, Huffman on, so the chunked path runs) byte for byte as this
    process's ``backend="numpy"`` did, and decodes its image stream (and
    the stream without Huffman) to this process's
    ``decode_image(backend="numpy")`` pixels and its video streams to
    ``decode_video(backend="numpy")``'s frames;
  * every copied helper equals its JAX-package original: header bits,
    QuantMatrix serialization, zig-zag, the DCT tables bit for bit, the
    register-file bounds, search steps, motion-vector width, YUV420 split,
    the bit packers and the Huffman dict; and the decode's: the bit
    reader and field gather, sign extension, the header readers, the
    dict parse and validation, the Huffman decode, the offset walk, the
    extraction, the exact inverse, the clamp and deblockify; the video
    decode's header parse and frame walk (vectors included), the block
    decode with and without its P-frame residual form, and the YUV420
    assembly;
  * the port's Python Huffman tree build equals the JAX package's (native)
    code_lengths on seeded histograms with ties and with skew deep enough
    to need the 15-bit length limit.
"""

import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import imageencoder_tpu
from imageencoder_tpu.models import headers as jax_headers
from imageencoder_tpu.models import image as jax_image
from imageencoder_tpu.models import video as jax_video
from imageencoder_tpu.ops import bitpack as jax_bitpack
from imageencoder_tpu.ops import blockify as jax_blockify
from imageencoder_tpu.ops import dct as jax_dct
from imageencoder_tpu.ops import device_pack as jax_device_pack
from imageencoder_tpu.ops import huffman as jax_huffman
from imageencoder_tpu.ops import motion as jax_motion
from imageencoder_tpu.ops import pallas_encode as jax_pallas_encode
from imageencoder_tpu.ops import zigzag as jax_zigzag
from imageencoder_tpu.utils import bits as jax_bits
from imageencoder_tpu.utils import exceptions as jax_exceptions
from imageencoder_tpu.utils.quant import QuantMatrix
import imageencoder_tpu_torch
from imageencoder_tpu_torch.models import headers, image, video
from imageencoder_tpu_torch.ops import (bitpack, blockify, cuda_encode, dct,
                                        device_pack, huffman, motion, zigzag)
from imageencoder_tpu_torch.utils import bits, exceptions

from tests.test_torch_image import REPO, smooth_image
from tests.test_torch_video import bench_frames, yuv420

JPEG4 = np.array([[16, 11, 10, 16], [12, 12, 14, 19], [14, 13, 16, 24],
                  [14, 17, 22, 29]], np.uint32)


def test_port_encodes_with_jax_and_the_jax_package_blocked(tmp_path):
    img = smooth_image(48, 64, 5)
    w, h, n = 32, 32, 40
    data = yuv420(bench_frames(w, h, n, 11))
    quant = QuantMatrix(JPEG4)
    want = {
        "image": imageencoder_tpu.encode_image(img, quant, use_huffman=True,
                                               backend="numpy"),
        "image raw": imageencoder_tpu.encode_image(
            img, quant, use_huffman=False, backend="numpy"),
        **{mode: bytes(jax_video.encode_video(
            data, w, h, quant, True, 4, 8, use_huffman=True,
            backend="numpy", ref_mode=mode)) for mode in ("raw", "recon")},
    }
    pixels = {key: imageencoder_tpu.decode_image(want[key], backend="numpy")
              for key in ("image", "image raw")}
    pixels.update({mode: jax_video.decode_video(want[mode],
                                                backend="numpy")[0]
                   for mode in ("raw", "recon")})
    case = tmp_path / "case.pkl"
    case.write_bytes(pickle.dumps((img, data, quant.matrix, want, pixels)))
    code = textwrap.dedent(f"""
        import pickle, sys
        sys.modules["jax"] = None
        sys.modules["imageencoder_tpu"] = None
        import imageencoder_tpu_torch as port
        img, data, matrix, want, pixels = pickle.loads(
            open({str(case)!r}, "rb").read())
        q = port.quant_from_numpy(matrix)
        assert port.encode_image(img, q, use_huffman=True,
                                 device="cpu") == want["image"]
        for key in ("image", "image raw"):
            got = port.decode_image(want[key], device="cpu").numpy()
            assert (got == pixels[key]).all(), key
        for mode in ("raw", "recon"):
            got = port.encode_video(data, {w}, {h}, q, True, 4, 8,
                                    use_huffman=True, ref_mode=mode,
                                    device="cpu")
            assert got == want[mode], mode
            got = port.decode_video(want[mode], device="cpu")[0]
            assert got == pixels[mode], mode
        assert sys.modules["jax"] is None
        assert sys.modules["imageencoder_tpu"] is None
        assert not [m for m in sys.modules
                    if m.startswith(("jax.", "imageencoder_tpu."))]
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
    assert want["raw"][0] & 0x80 and want["recon"][0] & 0x80  # Huffman


def _header_bits(mod_headers, mod_bitpack, quant):
    writer = mod_bitpack.BitWriter()
    writer.put_bit(0)
    mod_headers.write_image_header(writer, quant, True, 1280, 720)
    mod_headers.write_video_params(writer,
                                   mod_headers.VideoParams(25, 4, 16))
    return writer.getvalue(), writer.position


def _quant_bits(mod_bitpack, quant):
    writer = mod_bitpack.BitWriter()
    quant.write(writer)
    return writer.getvalue(), writer.position, quant.max_bit_length()


def _dict_bits(mod, freqs):
    w, words, lengths = mod._dict_and_codes(freqs)
    return w.getvalue(), w.position, words.tolist(), lengths.tolist()


def _freqs(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 50, 256) * (rng.random(256) < 0.7)).astype(
        np.int64)


# name: (the port's value, the JAX package's), each a thunk.
HELPERS = {
    "image+video header": (
        lambda: _header_bits(headers, bitpack,
                             imageencoder_tpu_torch.quant_from_numpy(JPEG4)),
        lambda: _header_bits(jax_headers, jax_bitpack, QuantMatrix(JPEG4))),
    "quant serialization": (
        lambda: _quant_bits(bitpack, imageencoder_tpu_torch.quant_from_numpy(
            np.array([[1, 300, 7, 65535]] * 4))),
        lambda: _quant_bits(jax_bitpack, QuantMatrix(
            np.array([[1, 300, 7, 65535]] * 4, np.uint32)))),
    "zigzag 4, 8, 5": (
        lambda: [zigzag.zigzag_order(n).tolist() for n in (4, 8, 5)],
        lambda: [jax_zigzag.zigzag_order(n).tolist() for n in (4, 8, 5)]),
    "cos table": (
        lambda: [dct._cos_table(n).tobytes() for n in (4, 8)],
        lambda: [jax_dct._cos_table(n).tobytes() for n in (4, 8)]),
    "dct matrix": (
        lambda: [dct.dct_matrix(n, m).tobytes() for n in (4, 8)
                 for m in ("reference", "ortho")],
        lambda: [jax_dct.dct_matrix(n, m).tobytes() for n in (4, 8)
                 for m in ("reference", "ortho")]),
    "forward weights": (
        lambda: [b.tobytes() for n in (4, 8) for m in ("reference", "ortho")
                 for b in dct._fwd_weights(n, m)],
        lambda: [b.tobytes() for n in (4, 8) for m in ("reference", "ortho")
                 for b in jax_dct._fwd_weights(n, m)]),
    "inverse weights": (
        lambda: [dct._inv_weights(n, m).tobytes() for n in (4, 8)
                 for m in ("reference", "ortho")],
        lambda: [jax_dct._inv_weights(n, m).tobytes() for n in (4, 8)
                 for m in ("reference", "ortho")]),
    "register-file bounds": (
        lambda: [(f(n, m)) for f in (
            cuda_encode.coeff_bound_bits, cuda_encode.coeff_bound_bits_residual,
            cuda_encode.frontend_lw, cuda_encode.video_lw)
            for n in (4, 8) for m in ("reference", "ortho")]
        + [cuda_encode.lw_for_bits(n, db) for n in (4, 8) for db in (1, 12)],
        lambda: [(f(n, m)) for f in (
            jax_pallas_encode.coeff_bound_bits,
            jax_pallas_encode.coeff_bound_bits_residual,
            jax_pallas_encode.frontend_lw, jax_pallas_encode.video_lw)
            for n in (4, 8) for m in ("reference", "ortho")]
        + [jax_pallas_encode.lw_for_bits(n, db) for n in (4, 8)
           for db in (1, 12)]),
    "search steps and signs": (
        lambda: ([motion.search_steps(m) for m in (0, 1, 2, 16, 300)],
                 motion.MER_SIGNS.tolist(), motion.MACRO),
        lambda: ([jax_motion.search_steps(m) for m in (0, 1, 2, 16, 300)],
                 jax_motion.MER_SIGNS.tolist(), jax_motion.MACRO)),
    "mvec bits": (
        lambda: [video.mvec_bits(m) for m in (0, 1, 4, 16, 255, 32767)],
        lambda: [jax_video.mvec_bits(m) for m in (0, 1, 4, 16, 255, 32767)]),
    "yuv420 split": (
        lambda: video.split_yuv420(bytes(range(256)) * 19 + b"xy", 8,
                                   16).tobytes(),
        lambda: jax_video.split_yuv420(bytes(range(256)) * 19 + b"xy", 8,
                                       16).tobytes()),
    "header words and bounds": (
        lambda: (device_pack.header_to_words(b"\xab\xcd\xef").tolist(),
                 device_pack.packed_words_bound(
                     1000, device_pack.local_words(18)),
                 device_pack.local_words(3)),
        lambda: (jax_device_pack.header_to_words(b"\xab\xcd\xef").tolist(),
                 jax_device_pack.packed_words_bound(1000, 18),
                 jax_device_pack.local_words(3))),
    "words to bytes": (
        lambda: device_pack.words_to_bytes(
            np.array([0x01020304, 0xA0B0C0D0], np.uint32), 45),
        lambda: jax_device_pack.words_to_bytes(
            np.array([0x01020304, 0xA0B0C0D0], np.uint32), 45)),
    "pack fields": (
        lambda: bitpack.pack_fields([5, -1, 0x1234, 7], [3, 16, 13, 0],
                                    pad_to_bytes=9),
        lambda: jax_bitpack.pack_fields([5, -1, 0x1234, 7], [3, 16, 13, 0],
                                        pad_to_bytes=9)),
    "bit segments": (
        lambda: bitpack.concat_bit_segments([(b"\xff\x80", 9), (b"\x55", 5),
                                             (b"", 0), (b"\xc3\x3c", 16)]),
        lambda: jax_bitpack.concat_bit_segments(
            [(b"\xff\x80", 9), (b"\x55", 5), (b"", 0), (b"\xc3\x3c", 16)])),
    "huffman dict": (
        lambda: [_dict_bits(huffman, _freqs(s)) for s in range(4)],
        lambda: [_dict_bits(jax_huffman, _freqs(s)) for s in range(4)]),
    "huffman fallback": (
        lambda: huffman._fallback(bytes(range(200))),
        lambda: jax_huffman._fallback(bytes(range(200)))),
    "bit reader": (
        lambda: _reads(bitpack), lambda: _reads(jax_bitpack)),
    "read fields and shift signed": (
        lambda: _fields(bitpack, bits), lambda: _fields(jax_bitpack,
                                                        jax_bits)),
    "header readers": (
        lambda: _headers_back(headers, bitpack),
        lambda: _headers_back(jax_headers, jax_bitpack)),
    "dict parse, validation, decode": (
        lambda: _huffman_back(huffman), lambda: _huffman_back(jax_huffman)),
    "offset walk and extraction": (
        lambda: _walk(image), lambda: _walk(jax_image)),
    "exact inverse and clamp": (
        lambda: _inverse(dct, blockify), lambda: _inverse(jax_dct,
                                                          jax_blockify)),
    "stream errors": (
        lambda: _errors(exceptions), lambda: _errors(jax_exceptions)),
    "video header and frame walk": (
        lambda: _video_front(video.parse_video_stream),
        lambda: _video_front(jax_video.parse_video_stream)),
    "video header parse": (
        lambda: _video_header(video.parse_video_header),
        lambda: _video_header(jax_video._parse_video_header)),
    "frame walk from a bit": (
        lambda: _frame_walk(video.iter_parsed_frames, video),
        lambda: _frame_walk(jax_video._iter_parsed_frames, jax_video)),
    "block decode and its residual": (
        lambda: _block_decode(image), lambda: _block_decode(jax_image)),
    "yuv420 assembly": (
        lambda: video.assemble_yuv420(_y_planes(), 16, 8),
        lambda: jax_video._assemble_yuv420(_y_planes(), 16, 8)),
}


def _video_stream(huff: bool) -> bytes:
    return bytes(jax_video.encode_video(
        yuv420(bench_frames(32, 32, 7, 3)), 32, 32, QuantMatrix(JPEG4), True,
        3, 8, use_huffman=huff, backend="numpy"))


def _video_front(parse):
    out = []
    for huff in (True, False):
        (payload, q, rle, p, w, h, parsed) = parse(_video_stream(huff))
        out.append((bytes(payload), q.matrix.tolist(), rle,
                    (p.frame_count, p.gop, p.merange), w, h,
                    [(None if mv is None else mv.tolist(), start,
                      [r.tolist() for r in recs])
                     for mv, start, recs in parsed]))
    return out


def _video_header(parse):
    payload, q, rle, p, w, h, pos = parse(_video_stream(False))
    return (bytes(payload), q.matrix.tolist(), rle,
            (p.frame_count, p.gop, p.merange), w, h, pos)


def _frame_walk(walk, mod):
    """The walk from bit 5 of random bytes: vectors, start bits and
    records read from noise, past the end as well."""
    data = bytes(np.random.default_rng(6).integers(0, 256, 400)
                 .astype(np.uint8))
    params = mod.VideoParams(5, 3, 300) if mod is jax_video else \
        headers.VideoParams(5, 3, 300)
    return [(None if mv is None else mv.tolist(), start,
             [r.tolist() for r in recs])
            for mv, start, recs in walk(data, params, True, 32, 16, 5)]


def _block_decode(mod):
    data = bytes(np.random.default_rng(9).integers(0, 256, 300)
                 .astype(np.uint8))
    q = _quant_of(headers if mod is image else jax_headers)
    i, j = np.indices((8, 8))
    q8 = (1 + 2 * (i + j)).astype(np.uint32)
    q8 = (imageencoder_tpu_torch.quant_from_numpy(q8) if mod is image
          else QuantMatrix(q8))
    kw = {} if mod is image else {"backend": "numpy"}
    return [(px.tobytes(), end) for px, end in (
        mod.decode_blocks(None, 3, 40, q, True, packed=data, **kw),
        mod.decode_blocks(None, 3, 40, q, True, residual=True, packed=data,
                          **kw),
        mod.decode_blocks(jax_bitpack.to_bits(data), 11, 8, q8, False,
                          "ortho", block_size=8, residual=True, **kw))]


def _y_planes():
    return np.random.default_rng(2).integers(0, 256, (3, 8, 16), np.uint8)


def _reads(mod):
    data = bytes(range(7, 250, 13))
    reader = mod.BitReader(data, 5)
    return [reader.get(n) for n in (0, 1, 7, 15, 31, 3, 20)], reader.position


def _fields(mod, mod_bits):
    bitv = mod.to_bits(bytes(range(1, 200, 7)))
    raw = mod.read_fields(bitv, [0, 5, 33, 200, 220], [3, 15, 32, 9, 1])
    return (raw.tolist(),
            mod_bits.shift_signed(raw, [3, 15, 32, 9, 0]).tolist())


def _headers_back(mod, mod_bits):
    writer = mod_bits.BitWriter()
    writer.put_bit(0)
    mod.write_image_header(writer, _quant_of(mod), True, 1280, 720)
    mod.write_video_params(writer, mod.VideoParams(25, 4, 16))
    reader = mod_bits.BitReader(writer.getvalue(), 1)
    q, rle, w, h = mod.read_image_header(reader, 4)
    p = mod.read_video_params(reader)
    return (q.matrix.tolist(), rle, w, h, p.frame_count, p.gop, p.merange,
            reader.position)


def _quant_of(mod):
    if mod is headers:
        return imageencoder_tpu_torch.quant_from_numpy(JPEG4)
    return QuantMatrix(JPEG4)


def _huffman_back(mod):
    data = jax_huffman.huffman_encode(bytes(np.minimum(
        np.random.default_rng(3).geometric(0.1, 500), 255).astype(np.uint8)))
    entries, end = mod.parse_dict_bytes(data)
    mod.validate_dict_entries(entries)
    return entries, end, mod.huffman_decode(data)


def _walk(mod):
    rng = np.random.default_rng(8)
    data = bytes(rng.integers(0, 256, 300).astype(np.uint8))
    offs, dbits, counts, end = mod.walk_block_offsets(None, 3, 40, True,
                                                      packed=data)
    coeffs, _ = mod.extract_block_coeffs(None, 3, 40, True, packed=data)
    return (offs.tolist(), dbits.tolist(), counts.tolist(), end,
            coeffs.tolist())


def _inverse(mod, mod_blockify):
    coeffs = np.random.default_rng(4).integers(-99, 99, (8, 4, 4))
    px = mod.inverse_transform(coeffs, JPEG4.astype(np.float64))
    return (px.tobytes(), mod_blockify.deblockify(
        mod.clamp_to_u8(px), 8, 16).tobytes(),
        mod.idct2_exact(coeffs.astype(np.float64), "ortho").tobytes())


def _errors(mod):
    err = mod.StreamFormatError("empty stream")
    return (str(err), isinstance(err, ValueError),
            isinstance(err, mod.CodecError))


@pytest.mark.parametrize("name", list(HELPERS))
def test_copied_helper_equals_jax_original(name):
    port, original = HELPERS[name]
    assert port() == original()


def _histogram(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "ties":
        # Few distinct counts over many symbols: heap ties everywhere.
        return rng.choice([0, 1, 2, 3, 8], 256).astype(np.int64)
    if kind == "fibonacci":
        # Fibonacci counts give a tree as deep as its symbols: lengths far
        # past 15, folded back by the limit.
        f = np.zeros(256, np.int64)
        a, b = 1, 1
        for s in rng.permutation(256)[:30]:
            f[s] = a
            a, b = b, a + b
        return f
    if kind == "geometric":
        return np.floor(2.0 ** rng.uniform(0, 40, 256)).astype(np.int64)
    if kind == "two":
        f = np.zeros(256, np.int64)
        f[[3, 200]] = [1, 10 ** 9]
        return f
    return rng.integers(0, 10 ** 6, 256).astype(np.int64)


@pytest.mark.parametrize("kind,seed", [
    ("ties", 0), ("ties", 1), ("fibonacci", 2), ("fibonacci", 3),
    ("geometric", 4), ("geometric", 5), ("uniform", 6), ("two", 7)])
def test_code_lengths_equal_jax_package(kind, seed):
    freqs = _histogram(kind, seed)
    got = huffman.code_lengths(freqs)
    np.testing.assert_array_equal(got, jax_huffman.code_lengths(freqs))
    assert got.max() <= huffman.MAX_CODE_LEN
    if kind == "fibonacci":  # the limit had work to do
        assert huffman._code_lengths_tree(freqs).max() > huffman.MAX_CODE_LEN
    kraft = sum(2.0 ** -int(n) for n in got if n)
    assert kraft <= 1.0


def test_code_lengths_refuse_a_single_symbol():
    f = np.zeros(256, np.int64)
    f[9] = 5
    with pytest.raises(ValueError):
        huffman.code_lengths(f)
    assert huffman._dict_and_codes(f) is None


def test_serving_and_cli_import_and_run_with_both_packages_blocked(
        tmp_path):
    """models.batch and cli import, a batch encodes and ``python -m
    imageencoder_tpu_torch --help`` and a CPU image job run with jax and
    imageencoder_tpu blocked."""
    imgs = np.stack([smooth_image(32, 48, k) for k in range(3)])
    want = [imageencoder_tpu.encode_image(img, QuantMatrix(JPEG4),
                                          use_huffman=True, backend="numpy")
            for img in imgs]
    case = tmp_path / "case.pkl"
    case.write_bytes(pickle.dumps((imgs, want)))
    code = textwrap.dedent(f"""
        import pickle, runpy, sys
        sys.modules["jax"] = None
        sys.modules["imageencoder_tpu"] = None
        import imageencoder_tpu_torch.models.batch as batch
        import imageencoder_tpu_torch.cli as cli
        from imageencoder_tpu_torch import quant_from_numpy
        imgs, want = pickle.loads(open({str(case)!r}, "rb").read())
        q = quant_from_numpy({JPEG4.tolist()!r})
        assert batch.encode_image_batch(imgs, q, device="cpu") == want
        assert list(batch.encode_image_stream(imgs, q, device="cpu")) == want
        sys.argv = ["imageencoder_tpu_torch", "--help"]
        try:
            runpy.run_module("imageencoder_tpu_torch", run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        assert not [m for m in sys.modules
                    if m.startswith(("jax.", "imageencoder_tpu."))]
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
    assert "--device {cuda,cpu}" in res.stdout
    env_code = ("import sys; sys.modules['jax'] = None; "
                "sys.modules['imageencoder_tpu'] = None; import runpy; "
                "sys.argv = ['x', '--help']; "
                "runpy.run_module('imageencoder_tpu_torch', "
                "run_name='__main__')")
    res = subprocess.run([sys.executable, "-c", env_code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    res = subprocess.run([sys.executable, "-m", "imageencoder_tpu_torch",
                          "--help"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and "--checkpoint-dir" in res.stdout


def test_parallel_imports_and_runs_with_both_packages_blocked(tmp_path):
    """The parallel modules (mesh, sharding, distributed, dryrun) import
    with jax and imageencoder_tpu blocked, and in a world of one over gloo
    the sharded image encode (both Huffman stages), the sharded decode and
    the GOP-distributed encode give this process's backend="numpy"
    streams and pixels."""
    imgs = np.stack([smooth_image(64, 48, 40 + k) for k in range(2)])
    w, h = 32, 32
    data = yuv420(bench_frames(w, h, 5, 12))
    quant = QuantMatrix(JPEG4)
    want = [imageencoder_tpu.encode_image(img, quant, use_huffman=True,
                                          backend="numpy") for img in imgs]
    video = bytes(jax_video.encode_video(data, w, h, quant, True, 2, 4,
                                         backend="numpy"))
    pixels = imageencoder_tpu.decode_image(want[0], backend="numpy")
    case = tmp_path / "case.pkl"
    case.write_bytes(pickle.dumps((imgs, data, want, video, pixels)))
    code = textwrap.dedent(f"""
        import pickle, sys
        sys.modules["jax"] = None
        sys.modules["imageencoder_tpu"] = None
        import imageencoder_tpu_torch.parallel as par
        from imageencoder_tpu_torch.parallel import distributed, dryrun
        from imageencoder_tpu_torch import quant_from_numpy
        imgs, data, want, video, pixels = pickle.loads(
            open({str(case)!r}, "rb").read())
        q = quant_from_numpy({JPEG4.tolist()!r})
        distributed.initialize(device="cpu")
        mesh = par.make_mesh(device="cpu")
        for entropy in (False, True):
            assert par.encode_sharded_image_batch(
                imgs, q, mesh, device_entropy=entropy) == want
        got = par.decode_image_sharded(want[0], mesh).numpy()
        assert (got == pixels).all()
        segs = distributed.encode_gops(data, {w}, {h}, q, True, 2, 4,
                                       [0, 1, 2], device="cpu")
        segs = distributed.gather_segments(segs, 3)
        assert distributed.assemble(segs, 5, {w}, {h}, q, True, 2, 4,
                                    device="cpu") == video
        assert callable(dryrun.dryrun_multichip)
        assert not [m for m in sys.modules
                    if m.startswith(("jax.", "imageencoder_tpu."))]
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


@pytest.mark.parametrize("seed", range(4))
def test_bit_splice_equals_jax_original_on_random_segments(seed):
    """The port's byte-granular concat_bit_segments against the JAX
    package's bit-granular one: every phase, empty segments, bytes past a
    segment's bits (which must not leak), and a short segment refused."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        segs = []
        for _ in range(int(rng.integers(0, 7))):
            nb = int(rng.integers(0, 90))
            extra = int(rng.integers(0, 3))
            segs.append((rng.integers(0, 256, (nb + 7) // 8 + extra,
                                      dtype=np.uint8).tobytes(), nb))
        assert bitpack.concat_bit_segments(segs) == (
            jax_bitpack.concat_bit_segments(segs))
    with pytest.raises(ValueError):
        bitpack.concat_bit_segments([(b"\x01", 9)])


# ---- utils/debug.py and parallel/video_sharding.py ----

def _debug_cases():
    """(name, args) of every debug function on seeded inputs: blocks with
    negative coefficients, an all-zero block, 4x4 and 8x8, both norms, and
    a Huffman dict."""
    rng = np.random.default_rng(17)
    cases = []
    for b in (4, 8):
        blk = rng.integers(0, 256, (b, b)).astype(np.uint8)
        coeffs = rng.integers(-300, 300, (b, b)).astype(np.int32)
        coeffs[rng.random((b, b)) < 0.5] = 0
        q = rng.integers(1, 40, (b, b)).astype(np.float64)
        cases += [("format_matrix", (blk, "pixels")),
                  ("format_matrix", (coeffs,)),
                  ("format_matrix", (q, "quant")),
                  ("format_zigzag", (coeffs,)),
                  ("format_zigzag", (np.zeros((b, b), np.int32),)),
                  ("format_rle", (coeffs.reshape(-1),)),
                  ("format_rle", (np.zeros(b * b, np.int32),)),
                  ("format_rle", (np.array([-1] + [0] * (b * b - 2) + [5]),))]
        for norm in ("reference", "ortho"):
            cases.append(("dump_block_pipeline", (blk, q, norm)))
            cases.append(("dump_block_pipeline",
                          (np.full((b, b), 128, np.uint8), q, norm)))
    freqs = np.bincount(rng.integers(0, 40, 3000), minlength=256)
    _, cw, cl = jax_huffman._dict_and_codes(freqs)
    entries = [(s, int(cw[s]), int(cl[s])) for s in range(256) if cl[s]]
    cases.append(("format_huffman_dict", (entries,)))
    return cases


DEBUG_CASES = _debug_cases()


@pytest.mark.parametrize("k", range(len(DEBUG_CASES)),
                         ids=[f"{k}-{name}" for k, (name, _)
                              in enumerate(DEBUG_CASES)])
def test_debug_text_equals_jax_original(k):
    from imageencoder_tpu.utils import debug as jax_debug
    from imageencoder_tpu_torch.utils import debug

    name, args = DEBUG_CASES[k]
    assert getattr(debug, name)(*args) == getattr(jax_debug, name)(*args)


def test_bits_needed_equals_jax_original():
    from imageencoder_tpu_torch.utils import debug

    vals = np.arange(-2**15, 2**15)
    assert [debug.bits_needed(v) for v in vals[::97]] == list(
        jax_bits.bits_needed(vals[::97]))


def test_video_sharding_and_debug_run_with_both_packages_blocked(tmp_path):
    """parallel/video_sharding.py and utils/debug.py import with jax and
    imageencoder_tpu blocked; in a world of one over gloo the sharded video
    encode (raw and recon, Huffman on and off, and the distributed
    Huffman stage) gives this process's encode_video(backend="numpy")
    streams, the sharded decode its decode_video frames, and the debug
    dump its text."""
    from imageencoder_tpu.utils import debug as jax_debug

    w, h, gop = 32, 32, 2
    frames = bench_frames(w, h, 4, 13)
    data = yuv420(frames)
    quant = QuantMatrix(JPEG4)
    want = {(mode, huff): bytes(jax_video.encode_video(
        data, w, h, quant, True, gop, 8, use_huffman=huff, backend="numpy",
        ref_mode=mode)) for mode in ("raw", "recon") for huff in (True, False)}
    frames_out = jax_video.decode_video(want["raw", True], backend="numpy")[0]
    block = frames[1, :4, :4]
    dump = jax_debug.dump_block_pipeline(block, JPEG4.astype(np.float64))
    case = tmp_path / "case.pkl"
    case.write_bytes(pickle.dumps((frames, want, frames_out, block, dump)))
    code = textwrap.dedent(f"""
        import pickle, sys
        import numpy as np
        sys.modules["jax"] = None
        sys.modules["imageencoder_tpu"] = None
        import imageencoder_tpu_torch.parallel as par
        from imageencoder_tpu_torch.parallel import distributed
        from imageencoder_tpu_torch.parallel import video_sharding as vs
        from imageencoder_tpu_torch.utils import debug
        from imageencoder_tpu_torch import quant_from_numpy
        frames, want, frames_out, block, dump = pickle.loads(
            open({str(case)!r}, "rb").read())
        q = quant_from_numpy({JPEG4.tolist()!r})
        distributed.initialize(device="cpu")
        mesh = par.make_mesh(device="cpu")
        for (mode, huff), stream in want.items():
            assert par.encode_video_sharded(frames, q, mesh, True, {gop}, 8,
                                            use_huffman=huff,
                                            ref_mode=mode) == stream
        step = par.make_sharded_video_packed(mesh, {gop}, 8, 5)
        start = vs._header(q, True, {w}, {h}, len(frames), {gop}, 8,
                           True)[1]
        mvw, blw, bits, hist = step(frames, q.as_float(), start)
        assert par.encode_sharded_video_huffman(
            mvw, blw, bits, hist, {w}, {h}, q, True, {gop}, 8,
            mesh) == want["raw", True]
        assert par.decode_video_sharded(want["raw", True], mesh)[0] == (
            frames_out)
        assert debug.dump_block_pipeline(block, q.as_float()) == dump
        assert not [m for m in sys.modules
                    if m.startswith(("jax.", "imageencoder_tpu."))]
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
