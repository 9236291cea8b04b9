"""The port's closed-loop (recon) video encode against the benchmark's plain
reference of it (benchmark/reference/recon.py), on the CPU, where every
kernel wrapper runs its plain version; and what the benchmark reads of
that encode.

  * encode_frames(..., ref_mode="recon", device="cpu") equals
    recon.encode_video_recon byte for byte: gop 1, 2, 4 and 6, merange 8,
    16 and 32, RLE and Huffman on and off, at 64x48 and 80x64, each clip
    long enough for two GOPs and a short last one;
  * decode_frames of such a stream equals codec.decode_video of the
    reference's Video, pixel for pixel;
  * on moving content the recon stream is not the raw one;
  * roofline_recon at the cell's shape: 13.19e9 f64 operations and
    387.9 us, bound by f64;
  * a traced encode nests the span ``recon`` under ``device video
    encode`` and counts ``recon_steps`` = gop - 1;
  * the readers of ``recon_ms.encode_video`` and ``recon_roofline`` on a
    synthetic run, and silent without their span or kernels;
  * the reference loads nothing of the port and nothing of JAX.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_recon_reference.py -q
"""

import json
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from benchmark import content, harness, roofline_recon
from benchmark import tracing as bench_tracing
from benchmark.reference import codec, recon
from imageencoder_tpu_torch import QuantMatrix, decode_frames
from imageencoder_tpu_torch.models.video import encode_frames
from imageencoder_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parent.parent
QUANT = [[16, 11, 10, 16], [12, 12, 14, 19], [14, 13, 16, 24],
         [14, 17, 22, 29]]
PORT_QUANT = QuantMatrix(np.array(QUANT, dtype=np.uint32))
CELL = "video_720p_gop6_me32_recon.encode_recon"


def clip(n: int, w: int, h: int, seed: int) -> torch.Tensor:
    return content.video_clips(1, n, h, w, seed=seed, device="cpu")[0]


def port(frames, w, h, gop, merange, rle=True, huff=True,
         ref_mode="recon") -> bytes:
    return encode_frames(frames, w, h, PORT_QUANT, rle, gop, merange, huff,
                         ref_mode=ref_mode, device="cpu")


def frame_count(gop: int, w: int) -> int:
    """Two GOPs and a short last one: at 64 wide one frame short of three
    GOPs, at 80 one frame past one (gop 1: three frames)."""
    if gop == 1:
        return 3
    return 2 * gop - 1 if w == 64 else gop + 1


@pytest.mark.parametrize("w,h", [(64, 48), (80, 64)])
@pytest.mark.parametrize("huff", [True, False])
@pytest.mark.parametrize("rle", [True, False])
@pytest.mark.parametrize("merange", [8, 16, 32])
@pytest.mark.parametrize("gop", [1, 2, 4, 6])
def test_recon_streams_equal_the_reference(gop, merange, rle, huff, w, h):
    n = frame_count(gop, w)
    frames = clip(n, w, h, seed=gop * 100 + merange)
    want = recon.encode_video_recon(frames, QUANT, rle, gop, merange, huff)
    assert port(frames, w, h, gop, merange, rle, huff) == want.data


@pytest.mark.parametrize("gop,merange", [(6, 32), (4, 16), (3, 8)])
def test_decode_of_a_recon_stream_equals_the_reference_decode(gop,
                                                              merange):
    frames = clip(2 * gop + 1, 64, 48, seed=7 + gop)
    video = recon.encode_video_recon(frames, QUANT, True, gop, merange)
    assert torch.equal(decode_frames(video.data, device="cpu"),
                       codec.decode_video(video, "cpu"))


def test_recon_stream_is_not_the_raw_one_on_moving_content():
    frames = clip(8, 64, 48, seed=21)
    got = port(frames, 64, 48, 6, 32)
    raw = port(frames, 64, 48, 6, 32, ref_mode="raw")
    assert got != raw
    assert raw == codec.encode_video(frames, QUANT, True, 6, 32).data
    video = recon.encode_video_recon(frames, QUANT, True, 6, 32)
    assert any(int(v.abs().sum()) for v in video.vectors.values())


def test_roofline_at_the_cells_shape():
    f64, ints = roofline_recon.ops(250, 720, 1280, 6, 32)
    assert roofline_recon.reconstructed_frames(250, 6) == 166
    assert f64 == 250 * 57_600 * 544 + 166 * 57_600 * 560
    assert f64 == pytest.approx(13.19e9, rel=1e-3)
    sads = 208 * 3600 * 5 * 9 * 256
    assert ints == sads / 4 + 208 * 921_600
    b = roofline_recon.video_encode_recon(250, 720, 1280, 6, 32, 50e6)
    assert b["by"] == "f64"
    assert b["least_s"] == pytest.approx(387.9e-6, rel=1e-3)
    assert roofline_recon.chain(250, 720, 1280, 6, 32)["least_s"] == \
        b["least_s"]
    # No reconstruction is read past a GOP's last frame or in a GOP of 1.
    assert roofline_recon.reconstructed_frames(7, 3) == 2
    assert roofline_recon.reconstructed_frames(9, 1) == 0


def tree(t: profiling.Trace) -> list:
    return [(label, t.records[p][0] if p >= 0 else None)
            for label, _, _, p in t.records]


@pytest.mark.parametrize("gop", [6, 1])
def test_traced_encode_nests_recon_and_counts_its_steps(gop):
    frames = clip(13, 64, 48, seed=5)
    plain = port(frames, 64, 48, gop, 32)
    with profiling.tracing("encode") as t:
        got = port(frames, 64, 48, gop, 32)
    assert got == plain
    assert tree(t) == [("device video encode", None),
                       ("recon", "device video encode"),
                       ("huffman", None), ("tobytes", "huffman")]
    for label, s, e, p in t.records:
        if p >= 0:
            assert t.records[p][1] <= s <= e <= t.records[p][2], label
    assert t.counters == {"encode_passes": 1, "recon_steps": gop - 1}


# ---- the benchmark's readers of the new span and kernels ----

# Two requests: (label, start s, end s).
SPANS = [("device video encode", 0.000, 0.004), ("recon", 0.001, 0.003),
         ("huffman", 0.004, 0.010), ("device video encode", 0.020, 0.023),
         ("recon", 0.020, 0.022)]
KERNELS = [("void quantize_image_kernel<short>(...)", 0.0010, 0.0012),
           ("void motion_search_kernel<false, 2>(...)", 0.0012, 0.0020),
           ("void recon_step_kernel<4>(...)", 0.0018, 0.0030),
           ("void pack_known_kernel<2>(...)", 0.0030, 0.0040),
           ("Memcpy DtoH (Device -> Pinned)", 0.0040, 0.0050),
           ("void recon_step_kernel<4>(...)", 0.0200, 0.0210),
           ("void motion_search_kernel<false, 2>(...)", 0.0500, 0.0600)]


def synthetic_run(entry: str, kernels=KERNELS) -> harness.Run:
    spans = bench_tracing.Spans()
    spans.records = list(SPANS)
    config = harness.load_json("configs", "video_720p_gop6_me32_recon")
    wl = types.SimpleNamespace(entry=entry, direction="encode",
                               config=config)
    ops = [(name, bench_tracing._device_kind(name), s, e)
           for name, s, e in kernels]
    profile = bench_tracing.Profile(ops, [], (0.0, 0.030), len(ops))
    return harness.Run(wl, 1.0, [0.01, 0.01], 0.02, spans=spans,
                       profile=profile, profiled=2)


def test_new_metrics_are_listed_for_the_new_cell_only():
    listed = {m["name"]: m for m in harness.spec()["per_layer"]}
    assert listed["recon_ms.encode_video"]["source"] == "program_span"
    assert listed["recon_roofline"]["source"] == "device_trace"
    for name in ("recon_ms.encode_video", "recon_roofline"):
        assert listed[name]["workloads"] == [CELL]
        assert listed[name]["moves"] == "encode_mpix_s"


def test_recon_ms_reads_the_span_a_request():
    read = harness.reader("recon_ms.encode_video")
    assert read(synthetic_run("encode_frames_recon")) == pytest.approx(2.0)
    assert read(synthetic_run("encode_frames")) is None


def test_recon_roofline_reads_the_chains_kernels_in_the_stretch():
    """The chain's kernels cover 1.0 .. 3.0 ms and 20 .. 21 ms of the
    30-ms stretch (the search at 50 ms lies past it, the pack and the copy
    are no chain kernel): 3 ms over 2 requests."""
    read = harness.reader("recon_roofline")
    least = roofline_recon.chain(250, 720, 1280, 6, 32)["least_s"]
    got = read(synthetic_run("encode_frames_recon"))
    assert got == pytest.approx(100.0 * least / 1.5e-3)
    assert read(synthetic_run("encode_frames")) is None


@pytest.mark.parametrize("name", ["recon_ms.encode_video",
                                  "recon_roofline"])
def test_new_readers_are_silent_without_what_they_read(name):
    """A program without the span (the parent of this change), or a
    profile without the chain's kernels, reads as nothing."""
    run = synthetic_run("encode_frames_recon", kernels=KERNELS[3:5])
    run.spans.records = [r for r in SPANS if r[0] != "recon"]
    assert harness.reader(name)(run) is None
    run.profile = None
    assert harness.reader(name)(run) is None


def test_reference_loads_nothing_of_the_port():
    code = ("import benchmark.reference.recon, benchmark.roofline_recon\n"
            "import sys, json\n"
            "print(json.dumps(sorted({n.split('.')[0] for n, m in "
            "sys.modules.items() if m is not None})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"imageencoder_tpu_torch", "imageencoder_tpu",
                        "jax", "jaxlib"}
