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
from imageencoder_tpu_torch.ops import cuda_decode, huffman

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
