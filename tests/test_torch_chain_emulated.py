"""D1 (csrc/chain.cuh: walk, check, rounds, the table of entry offsets
and its scan where the rounds leave a break, stitch, emit) and D2 (walk,
check, stitch with its sweep, emit) run on the host through
tools/emulate_decode.py, which compiles the kernels' sources with g++
against a small emulation of CUDA, and held against the port's plain
versions: the chains' logic without a card.

Few cases, small streams: chunks of 32 bits put breaks in nearly every
chunk, so D1's rounds and table, D2's sweep and a video's jumps all run.
Skipped only where g++ is absent.
"""

import importlib.util
import pathlib
import shutil

import numpy as np
import pytest

from imageencoder_tpu_torch import QuantMatrix, encode_image, encode_video
from imageencoder_tpu_torch.models import image
from imageencoder_tpu_torch.ops import bitpack, cuda_decode, huffman

from test_torch_decode import (equal_length_stream,  # tests/ is on the path
                               fifteen_bit_bytes, one_bit_bytes)

TOOL = pathlib.Path(__file__).resolve().parent.parent / "tools" / \
    "emulate_decode.py"
JPEG4 = np.array([[16, 11, 10, 16], [12, 12, 14, 19], [14, 13, 16, 24],
                  [14, 17, 22, 29]])
ROUNDS = cuda_decode.CHAIN_ROUNDS


def stat(stats, name: str) -> int:
    return stats[cuda_decode.CHAIN_STATS.index(name)]


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """(the tool as a module, its library built in a temporary directory)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    spec = importlib.util.spec_from_file_location("emulate_decode", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, mod.build(tmp_path_factory.mktemp("emulate_decode"))


@pytest.fixture(scope="module")
def stream():
    """A 96x128 image's Huffman stream, RLE on, and its plan."""
    data = encode_image(smooth_image(), QuantMatrix(JPEG4), True, True,
                        "reference", 4, device="cpu")
    return data, image.parse_stream(data, 4)


def smooth_image():
    y, x = np.mgrid[0:96, 0:128].astype(np.float64)
    rng = np.random.default_rng(0)
    return np.clip(128 + 60 * np.sin(x / 9) * np.cos(y / 7)
                   + rng.normal(0, 6, x.shape), 0, 255).astype(np.uint8)


def stream8(use_rle: bool) -> bytes:
    """The image's stream in 8x8 blocks under a ramp quant."""
    q = QuantMatrix(1 + 2 * np.add.outer(range(8), range(8)))
    return encode_image(smooth_image(), q, use_rle, True, "ortho", 8,
                        device="cpu")


@pytest.mark.parametrize("rounds", [0, ROUNDS])
def test_d1_rounds_then_table_equal_plain(emu, stream, rounds):
    """D1 on the image's stream at chunks of 32 bits: the check leaves
    breaks, every round changes chunks and still leaves some, and the
    table settles them (with no round, all)."""
    mod, lib = emu
    ok, stats, _ = mod.d1(lib, stream[0], 32, rounds)
    assert ok
    assert stat(stats, "rounds_changed") == rounds
    assert stat(stats, "breaks_left") == 1


def test_d1_rounds_settle_without_the_table(emu):
    """D1 on the 8x8 stream at chunks of 32 bits: breaks that take more
    than one round, and no break left after them (no table)."""
    mod, lib = emu
    ok, stats, _ = mod.d1(lib, stream8(True), 32)
    assert ok
    assert 1 < stat(stats, "rounds_changed") <= ROUNDS
    assert stat(stats, "breaks_left") == 0


def test_d1_table_where_chains_never_resync(emu):
    """3-bit codes at chunks of 32 bits: no walker meets the codeword
    grid, every round changes chunks, chunks are walked whole from their
    true entry, and the table settles them."""
    mod, lib = emu
    data = equal_length_stream(400, 1)
    ok, stats, want = mod.d1(lib, data, 32)
    assert ok and want == huffman.huffman_decode(data)
    assert stat(stats, "rounds_changed") == ROUNDS
    assert stat(stats, "walked_whole") > 0
    assert stat(stats, "breaks_left") == 1


@pytest.mark.parametrize("chunk_bits", [32, 512])
def test_d1_fifteen_bit_codes(emu, chunk_bits):
    """Codes of up to 15 bits, the longest: every entry offset of the
    table's map but the ended state."""
    mod, lib = emu
    data = huffman.huffman_encode(fifteen_bit_bytes(), "cpu")
    assert huffman.decode_table(huffman.parse_dict_bytes(data)[0])[1] == 15
    ok, stats, _ = mod.d1(lib, data, chunk_bits, 0)
    assert ok and stat(stats, "rounds_changed") == 0


def test_d1_emit_past_its_shared_stage(emu):
    """One-bit codes at chunks of 2048 bits: a CTA's symbols overflow the
    emit's shared stage and each thread stores its own."""
    mod, lib = emu
    data = huffman.huffman_encode(one_bit_bytes(), "cpu")
    ok, stats, want = mod.d1(lib, data, 2048)
    assert ok and len(want) > 24576 + 300_000 // 2


@pytest.mark.parametrize("case", ["8x8 rle off", "4x4 rle on"])
def test_d2_sweep_equal_plain(emu, stream, case):
    """D2 on an image's records, 8x8 without RLE at chunks of 2048 bits and
    4x4 with RLE at chunks of 32: the check leaves breaks, and the sweep
    fixes them (D2 runs no round)."""
    mod, lib = emu
    if case == "8x8 rle off":
        data, b, use_rle, chunk_bits = stream8(False), 8, False, 2048
    else:
        data, b, use_rle, chunk_bits = stream[0], 4, True, 32
    plan = image.parse_stream(data, b)
    ok, stats, _ = mod.d2(lib, huffman.huffman_decode(data), plan["start"],
                          plan["n_blocks"], use_rle, b, chunk_bits)
    assert ok
    assert stat(stats, "rounds_changed") == 0 and stat(stats, "jumps") == 0
    assert stat(stats, "breaks_left") == 1
    assert stat(stats, "sweep_breaks") > 0 and stat(stats, "scan_turns") > 0


def test_d2_long_records_go_to_the_sweep(emu):
    """Records of 244 bits at chunks of 32: walkers stay out of phase for
    many chunks, and after each break the sweep walks a run of chunks
    again."""
    mod, lib = emu
    payload = mod.records("long", 200, 1, True, 16)
    ok, stats, _ = mod.d2(lib, payload, 3, 232, True, 4, 32)
    assert ok
    assert stat(stats, "sweep_breaks") > 0
    assert stat(stats, "sweep_rewalked") >= stat(stats, "sweep_breaks")
    assert stat(stats, "longest_run") > 1


def test_d2_no_break_no_sweep(emu, stream):
    """D2 on the 4x4 image at chunks of 2048 bits: the check leaves no
    break, so the stitch only scans (no sweep turn)."""
    mod, lib = emu
    data, plan = stream
    ok, stats, _ = mod.d2(lib, huffman.huffman_decode(data), plan["start"],
                          plan["n_blocks"], True, 4, 2048)
    assert ok
    assert stat(stats, "breaks_left") == 0 and stat(stats, "scan_turns") == 0
    assert stat(stats, "sweep_rewalked") == 0


def test_d2_video_jumps_equal_plain(emu):
    """D2 over a 6-frame 32x32 video at gop 4 (its P-frames' jumps: the
    sweep), then the vector read and D3, against
    decode_video(device="cpu")."""
    mod, lib = emu
    rng = np.random.default_rng(2)
    base = np.kron(rng.integers(0, 256, (4, 4)), np.ones((8, 8)))
    yuv = b"".join(np.clip(np.roll(base, (f, 2 * f), (0, 1))
                           + rng.normal(0, 3, base.shape), 0, 255)
                   .astype(np.uint8).tobytes() + bytes(512)
                   for f in range(6))
    data = encode_video(yuv, 32, 32, QuantMatrix(JPEG4), True, 4, 4,
                        use_huffman=False, device="cpu")
    ok, walk_ok, vec_ok, stats = mod.video_case(lib, data, 32)
    assert ok and walk_ok and vec_ok
    assert stat(stats, "rounds_changed") == 0 and stat(stats, "jumps") > 0


def valid_records(n: int, seed: int, k: int = 16) -> bytes:
    """3 lead bits, then n records as an RLE stream writes them: a 4-bit
    width b, a b-bit count of at most k, that many b-bit fields."""
    rng = np.random.default_rng(seed)
    vals, nb = [0], [3]
    for _ in range(n):
        b = int(rng.integers(0, 16))
        cnt = int(rng.integers(0, min(k, (1 << b) - 1) + 1))
        vals += [b, cnt] + rng.integers(0, 1 << b, cnt).tolist()
        nb += [4, b] + [b] * cnt
    return bitpack.pack_fields(vals, nb)[0]


def walked(payload: bytes, n: int, use_rle: bool, b: int, start: int = 3):
    """The records (offs, dbits, counts) of n blocks from ``start``, by the
    plain walk."""
    return image.walk_block_offsets(None, start, n, use_rle, b,
                                    packed=payload)[:3]


def widest_span(records, k: int) -> int:
    """Bits from the lowest record start to the highest field end of a
    warp's 32 consecutive records, the widest over the warps."""
    offs, dbits, counts = (np.asarray(r, np.int64) for r in records)
    ends = offs + np.minimum(counts, k) * dbits
    return max(int(ends[i:i + 32].max() - offs[i:i + 32].min())
               for i in range(0, len(offs), 32))


def span_capacity(b: int) -> int:
    """csrc/decode.cu's kSpanBits<b>: past it a warp reads its fields from
    device memory."""
    return 127 + 32 * 15 * b * b + 31 * (4 + 15)


D3_CASES = ["8x8 widest fields", "8x8 noise under quant ones",
            "blocks not a multiple of 32", "frame k of every gop",
            "cut short", "cut short, misaligned", "corrupt counts",
            "zero blocks", "zero frames"]


@pytest.mark.parametrize("case", D3_CASES)
def test_d3_staged_span_equals_plain(emu, case):
    """D3 stages each warp's span of the payload in shared memory (the
    widest a stream can give: 32 records of 64 15-bit fields fill the 8x8
    buffer), reads zero past the payload's byte count, leaves the warps of
    a partial last tile, takes the frame from the grid's y (frame k of
    every GOP lies far apart in the payload), and reads from device memory
    where a corrupt count puts a warp's records too far apart; each case
    equals the plain block decode."""
    mod, lib = emu
    rng = np.random.default_rng(D3_CASES.index(case))
    if case == "8x8 widest fields":  # b = 15, 64 fields: 979-bit records
        payload = mod.records("long", 40, 3, True, 64)
        recs = walked(payload, 40, True, 8)
        assert widest_span(recs, 64) > span_capacity(8) - 32 * 19 - 127
        assert mod.d3(lib, payload, recs, np.ones((8, 8)), 8, "reference",
                      40, 64) is not None
    elif case == "8x8 noise under quant ones":
        noise = rng.integers(0, 256, (40, 72), np.uint8)
        data = encode_image(noise, QuantMatrix(np.ones((8, 8))), False, False,
                            "reference", 8, device="cpu")
        plan = image.parse_stream(data, 8)
        recs = walked(data, plan["n_blocks"], False, 8, plan["start"])
        assert int(np.max(recs[1])) >= 10
        assert mod.d3(lib, data, recs, np.ones((8, 8)), 8, "reference", 40,
                      72) is not None
    elif case == "blocks not a multiple of 32":  # 35 blocks: 32 + 3
        payload = valid_records(35, 4)
        assert mod.d3(lib, payload, walked(payload, 35, True, 4), JPEG4, 4,
                      "reference", 20, 28) is not None
    elif case == "frame k of every gop":  # 8 frames of 35 blocks, gop 4
        payload = valid_records(280, 5)
        recs = [r.reshape(8, 35) for r in walked(payload, 280, True, 4)]
        for k in range(4):
            pred = (None if k == 0 else
                    rng.integers(0, 256, (2, 20, 28), np.uint8))
            assert mod.d3(lib, payload, [r[k:] for r in recs], JPEG4, 4,
                          "reference", 20, 28, pred, step=4) is not None
    elif case.startswith("cut short"):  # the last third reads zeros
        payload = valid_records(232, 6)
        recs = walked(payload, 232, True, 4)
        assert widest_span(recs, 16) <= span_capacity(4)
        cut = 2 * len(payload) // 3
        for nbytes in range(cut, cut + 16):  # the count at each 16-byte phase
            assert mod.d3(lib, payload[:nbytes], recs, JPEG4, 4, "reference",
                          32, 116, misalign=5 if "misaligned" in case else 0
                          ) is not None, nbytes
    elif case == "corrupt counts":
        payload = mod.records("corrupt", 232, 1, True, 16)
        recs = walked(payload, 232, True, 4)
        assert widest_span(recs, 16) > span_capacity(4)
        assert mod.d3(lib, payload, recs, JPEG4, 4, "reference", 32,
                      116) is not None
    elif case == "zero blocks":
        empty = [np.zeros(0, np.int64), np.zeros(0, np.int32),
                 np.zeros(0, np.int32)]
        got = mod.d3(lib, b"\x12\x34", empty, JPEG4, 4, "reference", 0, 16)
        assert got is not None and got.shape == (1, 0, 16)
    else:  # zero frames
        empty = [np.zeros((0, 35), np.int64), np.zeros((0, 35), np.int32),
                 np.zeros((0, 35), np.int32)]
        got = mod.d3(lib, b"\x12\x34", empty, JPEG4, 4, "reference", 20, 28)
        assert got is not None and got.shape == (0, 20, 28)
