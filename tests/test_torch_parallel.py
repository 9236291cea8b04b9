"""The port's sharded image encode and decode (imageencoder_tpu_torch
.parallel) in gloo worlds of CPU processes, against the JAX package's
sharded steps on its virtual 8-device mesh and against its exact engine,
at tolerance 0; and the fields API and the plain versions of the kernels
the sharded path adds (the windowed byte histogram, K2 with a start bit a
stream, K4 pack_payload over a byte window).

Each world is one module fixture: four processes, one torch thread each,
joined through a file store in a temporary directory, run every case's
job once (parallel/dryrun.py::spawn_world, with its own deadline); each
case is its own test over the results.  The JAX references run on
make_mesh(4, frame_axis) of the conftest's 8 virtual devices, on inputs
whose encode_image(backend="numpy") equals encode_image(backend="jax"):
the JAX package's transform is f32 off a TPU.  The streams are held
against the exact engine, encode_image(backend="numpy"), and the port's
one-device encode_image(device="cpu"), on frames large enough that each
is Huffman-coded alone, and on noise, which takes the fallback."""

import numpy as np
import pytest

import jax
import torch

import imageencoder_tpu
from imageencoder_tpu.ops import huffman as jax_huffman
from imageencoder_tpu.ops import pipeline as jax_pipeline
from imageencoder_tpu.models import image as jax_image
from imageencoder_tpu.ops.dct import dct_matrix
from imageencoder_tpu.parallel import make_mesh as jax_make_mesh
from imageencoder_tpu.parallel import sharding as jax_sharding
from imageencoder_tpu.utils.quant import QuantMatrix
import imageencoder_tpu_torch as port
from imageencoder_tpu_torch.models.image import encode_blocks
from imageencoder_tpu_torch.ops import (bitpack, cuda_kernels, cuda_pack,
                                        device_pack, dict_table, huffman,
                                        pipeline)
from imageencoder_tpu_torch.parallel import dryrun, mesh as port_mesh
from imageencoder_tpu_torch.parallel import sharding

from tests.test_torch_image import smooth_image

WORLDS = [(2, 2), (4, 1), (1, 4)]  # (frame, block) of a world of 4
START, HEADER = 37, b"\x12\x34\x50\x00\x00"
MODES = ["concat", "separate"]
Q13 = np.full((4, 4), 13.0, np.float32)


def smooth_frames(n: int, h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (n, h // 8, w // 8)).astype(np.float64)
    up = np.kron(base, np.ones((1, 8, 8)))
    return np.clip(up + rng.normal(0, 4, up.shape), 0, 255).astype(np.uint8)


FRAMES = smooth_frames(4, 32, 24, 3)  # seeds with no f32 tie
BIG = np.stack([smooth_image(64, 48, k) for k in range(4)])
NOISE = np.random.default_rng(26).integers(0, 256, (4, 32, 24), np.uint8)
ODD = smooth_frames(1, 36, 24, 5)[0]  # 9 block rows: no multiple of 4
QM = QuantMatrix(Q13.astype(np.uint32))
QP = port.quant_from_numpy(QM.matrix)
Q1 = port.quant_from_numpy(np.ones((4, 4), np.uint32))


def host_stream(img, **kw) -> bytes:
    return imageencoder_tpu.encode_image(img, QM, backend="numpy", **kw)


DECODE_STREAMS = [host_stream(BIG[0], use_huffman=True),
                  host_stream(ODD, use_huffman=True),
                  host_stream(ODD, use_huffman=False)]


# Stage 2's inputs: (frames, start bit, the header's bytes before it).
STAGE2 = ((FRAMES, START, HEADER), (BIG, START, HEADER), (NOISE, 8, b"\x00"))


def jobs(fa: int) -> list:
    """Every case's job: (name, kwargs)."""
    out = [("mesh", {})]
    out.append(("encode_step", {"frames": FRAMES, "quant": Q13}))
    for frames, start, header in STAGE2:
        for mode in MODES:
            out.append(("encode_packed", {"frames": frames, "quant": Q13,
                                          "start_bit": start, "mode": mode}))
            out.append(("huffman", {"frames": frames, "quant": Q13,
                                    "start_bit": start, "header": header,
                                    "mode": mode}))
    for kw in ({}, {"device_entropy": True}, {"use_huffman": False}):
        out.append(("image_batch", {"frames": BIG, "quant": QP, **kw}))
    for entropy in (False, True):  # noise under quant all ones: fallback
        out.append(("image_batch", {"frames": NOISE, "quant": Q1,
                                    "device_entropy": entropy}))
    for data in DECODE_STREAMS:
        out.append(("decode", {"data": data}))
    return [(name, dict(kw, frame_axis=fa)) for name, kw in out]


@pytest.fixture(scope="module", params=WORLDS,
                ids=[f"{f}x{b}" for f, b in WORLDS])
def world(request, tmp_path_factory):
    """(frame extent, each rank's results by job index)."""
    fa, _ = request.param
    work = tmp_path_factory.mktemp(f"world{fa}")
    ranks = dryrun.spawn_world(4, jobs(fa), workdir=work, timeout_s=240)
    return fa, ranks


def _matches(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return a is b
    return a == b


def result(world, name: str, **match):
    """Rank 0's result of the first job of ``name`` whose kwargs match."""
    fa, ranks = world
    for k, (job, kw) in enumerate(jobs(fa)):
        if job == name and all(_matches(kw.get(a), v)
                               for a, v in match.items()):
            return ranks[0][k]
    raise KeyError(name, match)


_JAX = {}


def jax_packed(fa: int, mode: str, frames=FRAMES, start=START):
    key = ("packed", fa, mode, id(frames), start)
    if key not in _JAX:
        step = jax_sharding.make_sharded_encode_packed(
            jax_make_mesh(4, frame_axis=fa), mode=mode)
        _JAX[key] = [np.asarray(x) for x in jax.block_until_ready(
            step(frames, Q13, np.int32(start)))]
    return _JAX[key]


def test_inputs_have_no_f32_ties():
    """The JAX package's f32 transform agrees with its exact engine on
    these inputs, so its sharded steps are a reference at tolerance 0."""
    for img in list(FRAMES) + [ODD]:
        for rle in (True, False):
            assert host_stream(img, use_rle=rle) == (
                imageencoder_tpu.encode_image(img, QM, use_rle=rle,
                                              backend="jax"))


def test_every_rank_returns_the_global_result(world):
    fa, ranks = world
    for r in range(1, 4):
        for k, (a, b) in enumerate(zip(ranks[0][1:], ranks[r][1:])):
            assert dryrun._same(a, b), (r, jobs(fa)[k + 1][0])


def test_mesh_is_row_major_over_the_ranks(world):
    fa, ranks = world
    sa = 4 // fa
    assert tuple(jax_make_mesh(4, frame_axis=fa).devices.shape) == (fa, sa)
    for r, got in enumerate(ranks):
        assert tuple(got[0]) == (fa, sa, r // sa, r % sa)


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_factorization_matches_jax(n):
    assert port_mesh.mesh_shape(n) == tuple(jax_make_mesh(n).devices.shape)


def test_encode_step_matches_jax(world):
    fa, _ = world
    vals, nbits, base = result(world, "encode_step")
    want = jax.block_until_ready(jax_sharding.make_sharded_encode_step(
        jax_make_mesh(4, frame_axis=fa))(FRAMES, Q13))
    for got, ref in zip((vals, nbits, base), want):
        assert np.array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("mode", MODES)
def test_encode_packed_matches_jax(world, mode):
    """The aligned words (the JAX package's [F, S, W] rounded up to whole
    16-byte vectors, zeros past it), the segments' bits and the
    histograms of their whole bytes."""
    fa, _ = world
    words, bits, hist = result(world, "encode_packed", frames=FRAMES,
                               mode=mode)
    jw, jb, jh = jax_packed(fa, mode)
    n = min(words.shape[2], jw.shape[2])
    assert np.array_equal(words.view(np.uint32)[:, :, :n], jw[:, :, :n])
    assert not words[:, :, n:].any() and not jw[:, :, n:].any()
    assert np.array_equal(bits, jb)
    assert np.array_equal(hist, jh)


@pytest.mark.parametrize("mode", MODES)
def test_host_splice_and_boundary_histogram_match_jax(world, mode):
    fa, _ = world
    words, bits, hist = result(world, "encode_packed", frames=FRAMES,
                               mode=mode)
    got = sharding.assemble_packed_stream(words, bits, START, HEADER, mode)
    want = jax_sharding.assemble_packed_stream(*jax_packed(fa, mode)[:2],
                                               START, HEADER, mode)
    assert got == want
    parts = [got] if mode == "concat" else got
    for k, (inner, _) in enumerate(parts):
        seg_bits = bits if mode == "concat" else bits[k]
        freqs = (hist.sum(axis=0) if mode == "concat" else hist[k])[:256]
        extra = sharding.boundary_byte_histogram(inner, seg_bits, START)
        assert np.array_equal(extra, jax_sharding.boundary_byte_histogram(
            inner, seg_bits, START))
        assert np.array_equal(freqs + extra, np.bincount(
            np.frombuffer(inner, np.uint8), minlength=256))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k", range(len(STAGE2)),
                         ids=["small", "large", "noise"])
def test_stage2_equals_huffman_encode(world, mode, k):
    """Stage 2 against the Huffman encode of the inner streams stage 1
    assembles: the small frames fall back alone and are coded together,
    the large ones are coded, the noise falls back."""
    frames, start, header = STAGE2[k]
    got = result(world, "huffman", frames=frames, mode=mode)
    got = [got] if mode == "concat" else list(got)
    words, bits, _ = result(world, "encode_packed", frames=frames, mode=mode)
    inners = sharding.assemble_packed_stream(words, bits, start, header,
                                             mode)
    inners = [inners[0]] if mode == "concat" else [x for x, _ in inners]
    assert got == [jax_huffman.huffman_encode(x) for x in inners]
    assert got == [huffman.huffman_encode(x, "cpu") for x in inners]
    coded = [bool(s[0] & 0x80) for s in got]
    want = {"small": mode == "concat", "large": True, "noise": False}
    assert coded == [want[("small", "large", "noise")[k]]] * len(got)


@pytest.mark.parametrize("kw", [{}, {"device_entropy": True},
                                {"use_huffman": False}],
                         ids=["stage1", "stage2", "no_huffman"])
def test_image_batch_equals_one_device(world, kw):
    got = result(world, "image_batch", frames=BIG, **kw)
    huff = kw.get("use_huffman", True)
    assert list(got) == [host_stream(img, use_huffman=huff) for img in BIG]
    assert list(got) == [port.encode_image(img, QP, use_huffman=huff,
                                           device="cpu") for img in BIG]
    assert all(bool(s[0] & 0x80) == huff for s in got)


@pytest.mark.parametrize("entropy", [False, True])
def test_image_batch_falls_back_per_stream(world, entropy):
    got = list(result(world, "image_batch", frames=NOISE,
                      device_entropy=entropy))
    want = [port.encode_image(img, Q1, use_huffman=True, device="cpu")
            for img in NOISE]
    assert got == want
    assert not any(s[0] & 0x80 for s in got)  # every stream falls back


@pytest.mark.parametrize("k", range(len(DECODE_STREAMS)),
                         ids=["huffman", "odd_rows", "odd_rows_raw"])
def test_decode_equals_host_engine(world, k):
    data = DECODE_STREAMS[k]
    got = result(world, "decode", data=data)
    assert np.array_equal(got, imageencoder_tpu.decode_image(
        data, backend="numpy"))


# ---- the fields API and the sharded path's kernels, plain versions ----

@pytest.mark.parametrize("use_rle", [True, False])
def test_fields_api_matches_jax(use_rle):
    img = FRAMES[1]
    got = pipeline.make_encode_fields(4, use_rle)(torch.from_numpy(img), Q13)
    want = jax_pipeline.make_encode_fields(4, use_rle)(img, Q13)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    cz = pipeline.transform_quantize(torch.from_numpy(img), Q13)
    dct_m = np.asarray(dct_matrix(4, "reference"), np.float32)
    assert np.array_equal(cz.numpy(), np.asarray(
        jax_pipeline.transform_quantize(img, Q13, dct_m, 4)))
    for a, b in zip(pipeline.fields_from_coeffs(cz, use_rle),
                    jax_pipeline.fields_from_coeffs(cz.numpy(), use_rle)):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("use_rle", [True, False])
def test_fields_from_blocks_and_encode_blocks_match_jax(use_rle):
    from imageencoder_tpu.ops.blockify import blockify

    blocks = blockify(FRAMES[2], 4)
    got = pipeline.make_encode_fields_from_blocks(4, use_rle)(
        torch.from_numpy(blocks), Q13)
    want = jax_pipeline.make_encode_fields_from_blocks(4, use_rle)(blocks,
                                                                   Q13)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    rng = np.random.default_rng(5)
    tiles = rng.integers(0, 256, (40, 4, 4), np.uint8)
    for a, b in zip(encode_blocks(tiles, QP, use_rle, device="cpu"),
                    jax_image.encode_blocks(tiles, QM, use_rle)):
        assert np.array_equal(a, b)


def test_byte_histogram_rows_counts_each_window():
    rng = np.random.default_rng(1)
    words = rng.integers(-2**31, 2**31, (5, 12), dtype=np.int64).astype(
        np.int32)
    lo = np.array([0, 3, 7, 20, 47])
    hi = np.array([48, 9, 7, 31, 48])
    got = cuda_kernels.byte_histogram_rows(
        torch.from_numpy(words), torch.from_numpy(lo), torch.from_numpy(hi))
    for r in range(5):
        data = words[r].view(np.uint32).astype(">u4").view(np.uint8)
        want = np.bincount(data[lo[r]:hi[r]], minlength=256)
        assert np.array_equal(got[r].numpy(), want)


@pytest.mark.parametrize("base,nbits", [(37, 100), (64, 64), (5, 3),
                                        (31, 200)])
def test_byte_histogram_rows_is_the_segment_histogram(base, nbits):
    """Stage 1's window, the bytes a segment covers whole, is the JAX
    package's _segment_byte_histogram of its aligned words."""
    rng = np.random.default_rng(base)
    words = rng.integers(0, 2**32, 12, dtype=np.uint64).astype(np.uint32)
    phase = base & 31
    got = cuda_kernels.byte_histogram_rows(
        torch.from_numpy(words.view(np.int32)[None]),
        torch.tensor([(phase + 7) >> 3]), torch.tensor([(phase + nbits) >> 3]))
    want = jax_sharding._segment_byte_histogram(np, words, base, nbits)
    assert np.array_equal(got[0].numpy(), want[:256])


def test_pack_segments_takes_a_start_a_segment():
    rng = np.random.default_rng(2)
    vals = torch.from_numpy(rng.integers(0, 2**16, (120, 6)))
    nbits = torch.from_numpy(rng.integers(0, 17, (120, 6)))
    local, lens = device_pack.register_files(vals, nbits, 3)
    local = device_pack.as_int32(local).view(3, 40, 3)
    lens = lens.to(torch.int32).view(3, 40)
    starts = torch.tensor([0, 13, 31])
    words, totals = cuda_pack.pack_segments(local, lens, starts, 240)
    for k in range(3):
        w, t = cuda_pack.pack_locals_plain(local[k], lens[k], int(starts[k]),
                                           240)
        assert torch.equal(words[k], w) and int(totals[k]) == int(t)


@pytest.mark.parametrize("first,nbytes,start", [(0, 40, 0), (3, 40, 13),
                                                (2, 17, 31), (5, 5, 7)])
def test_pack_payload_codes_a_byte_window(first, nbytes, start):
    """K4 pack_payload under a table naming the bytes [first, nbytes) and
    a start bit, its dict words zero: each byte's code in order from the
    start bit, as stage 2 writes a segment's owned bytes."""
    rng = np.random.default_rng(first + nbytes)
    words = rng.integers(-2**31, 2**31, 12).astype(np.int32)
    freqs = np.bincount(words.view(np.uint32).astype(">u4").view(np.uint8),
                        minlength=256) + 1
    _, cw, cl = huffman._dict_and_codes(freqs)
    table = dict_table.make_table(cw, cl, np.zeros(256), "cpu",
                                  dict_bits=start, nbytes=nbytes,
                                  first_byte=first)
    got, total = cuda_pack.pack_payload(torch.from_numpy(words), table, 64)
    data = words.view(np.uint32).astype(">u4").view(np.uint8)[first:nbytes]
    vals = np.concatenate([[0], cw[data].astype(np.int64)])
    nb = np.concatenate([[start], cl[data].astype(np.int64)])
    want = device_pack.bytes_to_words(bitpack.pack_fields(vals, nb)[0])
    assert int(total) == start + int(cl[data].sum())
    n = len(want)
    assert np.array_equal(got.numpy()[:n], want)
    assert not got.numpy()[n:].any()
