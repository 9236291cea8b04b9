"""K2 and K4 ports (imageencoder_tpu_torch/ops/cuda_pack.py) and the plain
packer (ops/device_pack.py) against the JAX package, on the CPU, where
the wrappers run their plain versions.

  * pack_locals on the TPU front end's own register files is bit-equal to
    pallas_pack.pack_locals_pallas(..., interpret=True), alone and with a
    video's vector records merged in as the JAX package merges them
    (pallas_encode.mvec_locals and interleave_video_locals); a record
    longer than its register file is refused;
  * pack_records is bit-equal to pack_records_pallas(..., interpret=True)
    and to device_pack.pack_blocks_device(method="scatter");
  * the Huffman payload pack equals huffman._device_stages().pack_payload,
    through K4's pack_payload front end (cuda_pack.pack_payload) under the
    dict table at stream ends inside a record and a word;
  * K2 and K4 pack_coeffs with the histogram (pack_locals_hist,
    pack_coeffs_hist) count what pipeline.stream_byte_histogram counts on
    the stream they write, ending inside a word or on a word boundary.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from imageencoder_tpu.ops.device_pack import (_local_words,
                                              pack_blocks_device,
                                              packed_words_bound)
from imageencoder_tpu.ops import pipeline as jax_pipeline
from imageencoder_tpu.ops.huffman import _device_stages, _dict_and_codes
from imageencoder_tpu.ops.pallas_encode import (encode_locals, frontend_lw,
                                                interleave_video_locals,
                                                mvec_locals)
from imageencoder_tpu.ops.pallas_pack import (pack_locals_pallas,
                                              pack_records_pallas)
from imageencoder_tpu_torch.ops import (cuda_encode, cuda_pack, device_pack,
                                        dict_table, huffman)

JPEG4 = np.array([[16, 11, 10, 16], [12, 12, 14, 19], [14, 13, 16, 24],
                  [14, 17, 22, 29]], np.float32)


def fields(n: int, f: int, seed: int):
    rng = np.random.default_rng(seed)
    nbits = rng.integers(0, 17, (n, f)).astype(np.int32)
    vals = rng.integers(-(2 ** 15), 2 ** 15, (n, f)).astype(np.int32)
    return vals, nbits


@pytest.fixture(scope="module")
def tpu_locals():
    """The TPU front end's register files for a 32x48 image, in both
    layouts: JAX's [rows_pad, n_pad] u32 and the port's [N, lw] + [N]."""
    img = (np.random.default_rng(4).integers(0, 256, (32, 48)) // 2
           + 64).astype(np.uint8)
    lw = frontend_lw(4, "reference")
    locs, n = encode_locals(jnp.asarray(img), JPEG4, 4, True, "reference",
                            interpret=True)
    host = np.asarray(locs)
    local = torch.from_numpy(host[:lw, :n].T.copy().view(np.int32))
    lens = torch.from_numpy(host[lw, :n].astype(np.int32))
    return locs, local, lens, lw, n


@pytest.mark.parametrize("start", [0, 37, 2047])
def test_pack_locals_matches_pallas(tpu_locals, start):
    locs, local, lens, lw, n = tpu_locals
    nw = packed_words_bound(n, 18)
    want_w, want_t = pack_locals_pallas(locs, lw, jnp.int32(start), nw,
                                        interpret=True)
    got_w, got_t = cuda_pack.pack_locals(local, lens, start, nw)
    assert got_w.dtype == torch.int32 and got_w.shape == (nw,)
    assert int(got_t) == int(want_t)
    np.testing.assert_array_equal(got_w.numpy().view(np.uint32),
                                  np.asarray(want_w))


@pytest.mark.parametrize("n_frames,gop,nb,start", [
    (2, 2, 6, 37), (4, 3, 6, 0), (4, 1, 6, 2047), (3, 4, 2, 64),
    (6, 2, 16, 95)])
def test_pack_locals_with_vectors_matches_pallas(tpu_locals, n_frames, gop,
                                                 nb, start):
    """The 96 block records as a video of n_frames frames, 5 vector
    records before each frame's blocks: gop 1 (no P-frame), a last GOP
    cut short, 16-bit components that fill the record's word."""
    locs, local, lens, lw, n = tpu_locals
    n_macro = 5
    rng = np.random.default_rng(n_frames + gop)
    mvec = rng.integers(-2 ** (nb - 1), 2 ** (nb - 1),
                        (n_frames, n_macro, 2)).astype(np.int32)
    is_i = np.arange(n_frames) % gop == 0
    ml = mvec_locals(jnp.asarray(mvec), jnp.asarray(is_i), nb,
                     locs.shape[0], lw)
    merged = interleave_video_locals(locs[:, :n], ml, n_frames)
    nw = packed_words_bound(n + n_frames * n_macro, 18)
    want_w, want_t = pack_locals_pallas(merged, lw, jnp.int32(start), nw,
                                        interpret=True)
    before = cuda_pack.pack_locals.launches
    got_w, got_t = cuda_pack.pack_locals(
        local, lens, start, nw, mvecs=torch.from_numpy(mvec[~is_i]),
        n_frames=n_frames, gop=gop, mvec_nbits=nb)
    assert cuda_pack.pack_locals.launches == before  # CPU: plain version
    assert int(got_t) == int(want_t)
    assert int(got_t) == (start + int(lens.sum())
                          + int((~is_i).sum()) * n_macro * 2 * nb)
    np.testing.assert_array_equal(got_w.numpy().view(np.uint32),
                                  np.asarray(want_w))


def test_pack_locals_refuses_and_checks_its_records(tpu_locals):
    _, local, lens, lw, n = tpu_locals
    long = lens.clone()
    long[7] = 32 * lw + 1  # as K1 leaves a record it refused
    _, total = cuda_pack.pack_locals(local, long, 0, 9 * n)
    assert int(total) == -1
    with pytest.raises(ValueError, match="register file"):
        device_pack.host_total(total)
    mvecs = torch.zeros((1, 5, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="P-frames"):
        cuda_pack.pack_locals(local, lens, 0, 9 * n, mvecs=mvecs,
                              n_frames=4, gop=2, mvec_nbits=6)
    with pytest.raises(ValueError, match="split"):
        cuda_pack.pack_locals(local, lens, 0, 9 * n,
                              mvecs=mvecs.expand(4, 5, 2), n_frames=5, gop=5,
                              mvec_nbits=6)
    with pytest.raises(ValueError, match="mvec_nbits"):
        cuda_pack.pack_locals(local, lens, 0, 9 * n, mvecs=mvecs,
                              n_frames=2, gop=2, mvec_nbits=17)
    with pytest.raises(ValueError, match="lens"):
        cuda_pack.pack_locals(local, lens[:-1], 0, 9 * n)


def test_pack_records_matches_pallas():
    vals, nbits = fields(300, 16, 1)
    nw = 300 * 9 + 70
    want_w, want_t = pack_records_pallas(jnp.asarray(vals),
                                         jnp.asarray(nbits), jnp.int32(37),
                                         nw, interpret=True)
    got_w, got_t = cuda_pack.pack_records(torch.from_numpy(vals),
                                          torch.from_numpy(nbits), 37, nw)
    assert int(got_t) == int(want_t)
    np.testing.assert_array_equal(got_w.numpy().view(np.uint32),
                                  np.asarray(want_w))


@pytest.mark.parametrize("n,f,start,nw", [
    (1, 3, 0, 20),
    (257, 18, 171, 257 * 9 + 70),
    (4101, 16, 2047, 4101 * 8 + 80),
    (500, 18, 5, 300),            # content past n_words is dropped
    (64, 16, 31, 64 * 8 + 2),
])
def test_pack_records_matches_scatter(n, f, start, nw):
    vals, nbits = fields(n, f, n + f)
    if n == 64:
        nbits[:] = 16  # every field at the 16-bit cap, all words full
    want_w, want_t = pack_blocks_device(jnp.asarray(vals),
                                        jnp.asarray(nbits),
                                        jnp.int32(start), nw,
                                        method="scatter")
    got_w, got_t = cuda_pack.pack_records(torch.from_numpy(vals),
                                          torch.from_numpy(nbits), start, nw)
    assert int(got_t) == int(want_t)
    np.testing.assert_array_equal(got_w.numpy().view(np.uint32),
                                  np.asarray(want_w))


def test_register_files_match_jax_level_one():
    """Level 1 on fields that straddle word edges at every bit offset."""
    vals, nbits = fields(200, 18, 9)
    nbits[:8] = [[16] * 18, [1] * 18, [15] * 18, [0] * 17 + [16],
                 [16] + [0] * 17, [31 % 17] * 18, [0] * 18, [8] * 18]
    want_local, want_bits = _local_words(jnp.asarray(vals),
                                         jnp.asarray(nbits))
    local, lens = device_pack.register_files(torch.from_numpy(vals),
                                             torch.from_numpy(nbits),
                                             device_pack.local_words(18))
    np.testing.assert_array_equal(local.numpy(),
                                  np.asarray(want_local).astype(np.int64))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want_bits))


def test_prefix_words_are_ored_in():
    vals, nbits = fields(40, 16, 2)
    prefix = torch.tensor([-1, 0x12345678, 0], dtype=torch.int32)
    start = 3 * 32 + 5
    plain_w, _ = cuda_pack.pack_records(torch.from_numpy(vals),
                                        torch.from_numpy(nbits), start, 400)
    got_w, _ = cuda_pack.pack_records(torch.from_numpy(vals),
                                      torch.from_numpy(nbits), start, 400,
                                      prefix=prefix)
    want = plain_w.clone()
    want[:3] |= prefix
    assert torch.equal(got_w, want)


def test_uint32_round_trip_through_int32():
    x = torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1],
                     dtype=torch.int64)
    y = device_pack.as_int32(x)
    assert y.dtype == torch.int32
    assert torch.equal(device_pack.as_uint(y), x)
    np.testing.assert_array_equal(device_pack.words_to_numpy(y),
                                  x.numpy().astype(np.uint32))


def jax_payload(freqs, nbytes: int):
    """The JAX package's dict for ``freqs`` as a dict table that codes
    ``nbytes`` bytes, and the dict arguments of its payload stage."""
    w, code_words, lengths = _dict_and_codes(freqs)
    stream = w.getvalue()
    buf = np.zeros(4 * dict_table.DICT_WORDS, np.uint8)
    buf[:len(stream)] = np.frombuffer(stream, np.uint8)
    dict_words = buf.view(">u4").astype(np.uint32)
    table = dict_table.make_table(code_words, lengths, dict_words, "cpu",
                                  dict_bits=w.position, nbytes=nbytes)
    return table, (jnp.asarray(code_words.astype(np.uint32)),
                   jnp.asarray(lengths.astype(np.int32)),
                   np.int32(w.position), jnp.asarray(dict_words))


def test_pack_payload_matches_device_stages():
    """The dict's plain version and K4's pack_payload (plain here) under
    its table equal the JAX package's dict and payload stage."""
    rng = np.random.default_rng(12)
    words = (rng.integers(0, 2 ** 32, 1024, dtype=np.uint64)
             & 0xF0F0FFFF).astype(np.uint32)
    nbytes = 1024 * 4 - 3
    data = words.astype(">u4").tobytes()[:nbytes]
    freqs = np.bincount(np.frombuffer(data, np.uint8), minlength=256)
    table = huffman.build_dict_plain(torch.from_numpy(freqs),
                                     torch.tensor(8 * nbytes - 2))
    assert dict_table.fields(table)["nbytes"] == nbytes
    want_table, dict_args = jax_payload(freqs, nbytes)
    assert torch.equal(table[:dict_table.META],
                       want_table[:dict_table.META])

    _, jax_pack_payload, _ = _device_stages()
    want_w, want_t = jax_pack_payload(jnp.asarray(words), np.int32(nbytes),
                                      *dict_args)
    got_w, got_t = cuda_pack.pack_payload(
        torch.from_numpy(words.view(np.int32)), table,
        huffman.payload_words(1024))
    assert int(got_t) == int(want_t) == dict_table.fields(table)["out_total"]
    np.testing.assert_array_equal(got_w.numpy().view(np.uint32),
                                  np.asarray(want_w))


@pytest.mark.parametrize("n_words,nbytes", [
    (1024, 1024 * 4), (1027, 4 * 1027 - 5), (600, 1), (64, 37)])
def test_pack_payload_front_end_matches_device_stages(n_words, nbytes):
    """K4's pack_payload (here its plain version) equals the JAX package's
    payload stage bit for bit, words past nbytes ignored, W not a multiple
    of the 4-word record; the byte count and the start bit come from the
    table."""
    rng = np.random.default_rng(n_words)
    words = (rng.integers(0, 2 ** 32, n_words, dtype=np.uint64)
             & 0x3F1FFFF7).astype(np.uint32)
    data = words.astype(">u4").tobytes()[:nbytes]
    freqs = np.bincount(np.frombuffer(data, np.uint8), minlength=256)
    freqs[[0, 7]] += 1  # at least two symbols
    table, dict_args = jax_payload(freqs, nbytes)

    _, jax_pack_payload, _ = _device_stages()
    want_w, want_t = jax_pack_payload(jnp.asarray(words), np.int32(nbytes),
                                      *dict_args)
    nw = huffman.payload_words(n_words)
    before = cuda_pack.pack_payload.launches
    got_w, got_t = cuda_pack.pack_payload(
        torch.from_numpy(words.view(np.int32)), table, nw)
    assert cuda_pack.pack_payload.launches == before  # CPU: plain version
    assert int(got_t) == int(want_t)
    np.testing.assert_array_equal(got_w.numpy().view(np.uint32),
                                  np.asarray(want_w))
    np.testing.assert_array_equal(
        cuda_pack.stream_words(got_w, got_t).numpy().view(np.uint32),
        np.asarray(want_w)[:(int(want_t) + 31) // 32])


def held_histogram(words, total, hist):
    """The packer's histogram against the JAX package's
    stream_byte_histogram of the stream it wrote."""
    want = np.asarray(jax_pipeline.stream_byte_histogram(
        jnp.asarray(words.numpy().view(np.uint32)), jnp.int32(int(total))))
    assert want[0] == int(total)
    assert hist.dtype == torch.int32 and hist.shape == (256,)
    np.testing.assert_array_equal(hist.numpy(), want[1:])


@pytest.mark.parametrize("end", ["inside a word", "on a word boundary"])
@pytest.mark.parametrize("with_vectors", [False, True])
def test_pack_locals_hist_matches_stream_byte_histogram(tpu_locals, end,
                                                        with_vectors):
    """K2 with its histogram (here its plain version) on the TPU front
    end's register files, alone and with a video's vector records."""
    _, local, lens, _, n = tpu_locals
    kwargs, bits = {}, int(lens.sum())
    if with_vectors:  # 4 frames of 24 blocks, 5 vectors each, gop 2
        mvecs = np.random.default_rng(5).integers(-32, 32, (2, 5, 2))
        kwargs = dict(mvecs=torch.from_numpy(mvecs.astype(np.int32)),
                      n_frames=4, gop=2, mvec_nbits=6)
        bits += 2 * 5 * 12
    start = 37 if end == "inside a word" else (32 - bits % 32) % 32 + 64
    if end == "inside a word" and (start + bits) % 32 == 0:
        start += 1
    nw = packed_words_bound(n + 20, 18)
    words, total, hist = cuda_pack.pack_locals_hist(local, lens, start, nw,
                                                    **kwargs)
    assert int(total) == start + bits
    assert (int(total) % 32 == 0) == (end == "on a word boundary")
    held_histogram(words, total, hist)


@pytest.mark.parametrize("b,start", [(4, 0), (4, 45), (8, 96)])
def test_pack_coeffs_hist_matches_stream_byte_histogram(b, start):
    """K4 pack_coeffs with its histogram (here its plain version) on a
    recon video's coefficients and vectors."""
    rng = np.random.default_rng(b + start)
    n, h, w, gop = 4, 32, 48, 3
    coeffs = (rng.integers(-60, 60, (n, h, w))
              * (rng.random((n, h, w)) < 0.25)).astype(np.int32)
    n_macro = (h // 16) * (w // 16)
    mvecs = rng.integers(-8, 9, (2, n_macro, 2)).astype(np.int32)
    lw = cuda_encode.video_lw(b, "reference")
    nw = packed_words_bound(n * (n_macro + h * w // (b * b)), b * b + 2)
    words, total, hist = cuda_pack.pack_coeffs_hist(
        torch.from_numpy(coeffs), torch.from_numpy(mvecs), gop, 6, b, True,
        lw, start, nw)
    assert int(total) > start
    held_histogram(words, total, hist)
