"""The port's spans and counters (utils/profiling.py) on the CPU: the span
tree of a long clip's encode, in chunks and in one pass, and of its
decode, each child inside its parent, the stream unchanged by tracing;
the encode's passes counted; the benchmark's span recorder
receiving every label; no clock read and no profiler range entered with
no trace active; the spans in a device trace's timeline; the report's
tree; and the benchmark's readers of the new spans."""

import json
import types

import numpy as np
import pytest

import torch

from benchmark import harness, tracing as bench_tracing
import imageencoder_tpu_torch as port
from imageencoder_tpu_torch.models import image, video
from imageencoder_tpu_torch.utils import profiling

W, H, N, GOP, MERANGE = 64, 48, 40, 4, 8  # two chunks of 32 and 8 frames
# on the CPU, whose passes take the JAX package's 32 frames
OLD = {"device video encode", "huffman", "parse", "upload", "device decode"}
NEW = {"wait", "tobytes", "splice", "restage", "dict", "staging"}


def frames() -> np.ndarray:
    rng = np.random.default_rng(3)
    base = np.kron(rng.integers(0, 256, (H // 8, W // 8)), np.ones((8, 8)))
    return np.stack([np.clip(np.roll(base, (f * 2, f * 3), (0, 1))
                             + rng.normal(0, 3, base.shape), 0, 255)
                     .astype(np.uint8) for f in range(N)])


QUANT = port.quant_from_numpy(np.array([[16, 11, 10, 16], [12, 12, 14, 19],
                                        [14, 13, 16, 24], [14, 17, 22, 29]]))


def encode() -> bytes:
    return video.encode_frames(frames(), W, H, QUANT, True, GOP, MERANGE,
                               use_huffman=True, device="cpu")


def decode(stream: bytes):
    return video.decode_frames(stream, device="cpu")


def tree(t: profiling.Trace) -> list:
    """(label, parent's label or None) of each record, in the order
    opened."""
    return [(label, t.records[p][0] if p >= 0 else None)
            for label, _, _, p in t.records]


def assert_nested(t: profiling.Trace) -> None:
    for label, s, e, p in t.records:
        assert e is not None and s <= e
        if p >= 0:
            _, ps, pe, _ = t.records[p]
            assert ps <= s and e <= pe, label


def test_span_tree_of_a_long_clip_encode():
    plain = encode()
    with profiling.tracing("encode") as t:
        got = encode()
    assert got == plain
    assert tree(t) == [("device video encode", None),
                       ("wait", "device video encode"),
                       ("tobytes", "device video encode"),
                       ("wait", "device video encode"),
                       ("tobytes", "device video encode"),
                       ("splice", None),
                       ("huffman", None),
                       ("restage", "huffman"),
                       ("tobytes", "huffman")]
    assert_nested(t)
    # Two passes; nothing crosses to or from a card on the CPU.
    assert t.counters == {"encode_passes": 2}


def test_span_tree_of_a_long_clip_encode_in_one_pass(monkeypatch):
    """The whole clip in one pass, its budget forced (a card's would take
    it so): no chunk's wait or cut, no splice, no restage.  On the CPU
    the Tail's lengths are read at once, so it waits on no event."""
    plain = encode()
    monkeypatch.setattr(video, "frames_per_pass", lambda *args, **kw: N)
    with profiling.tracing("encode") as t:
        got = encode()
    assert got == plain
    assert tree(t) == [("device video encode", None), ("huffman", None),
                       ("tobytes", "huffman")]
    assert_nested(t)
    assert t.counters == {"encode_passes": 1}


@pytest.mark.parametrize("budget,passes", [(4, 10), (12, 4), (32, 2),
                                           (40, 1), (64, 1)])
def test_encode_passes_counts_the_device_passes(monkeypatch, budget,
                                                passes):
    monkeypatch.setattr(video, "frames_per_pass",
                        lambda *args, **kw: budget)
    with profiling.tracing("encode") as t:
        encode()
    assert t.counters == {"encode_passes": passes}
    labels = [label for label, _, _, _ in t.records]
    assert labels.count("splice") == labels.count("restage") == (
        passes > 1)


def test_parse_spans_of_a_decode():
    stream = encode()
    with profiling.tracing("decode") as t:
        decode(stream)
    assert tree(t) == [("parse", None), ("dict", "parse"),
                       ("staging", "parse"), ("upload", None),
                       ("device decode", None)]
    assert_nested(t)
    # On the CPU the stream is staged in numpy: nothing pinned, nothing
    # copied up.
    assert t.counters == {}


@pytest.mark.cuda
def test_pinned_staging_counted_on_a_card():
    """On a card each decode stages its stream once in pinned memory,
    under ``staging`` within ``parse``, and counts that buffer's bytes;
    ``upload`` stays top-level and copies the same bytes up."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    stream = encode()
    img = port.encode_image(frames()[:8].reshape(8 * H, W), QUANT,
                            use_huffman=True, device="cpu")
    assert img[0] & 0x80 and stream[0] & 0x80  # both with a dict
    size = {data: image.parse_stream(data, video=data is stream)[
        "staging"].nbytes for data in (stream, img)}
    with profiling.tracing("decode") as t:
        video.decode_frames(stream, device="cuda")
        port.decode_image(img, device="cuda")
        video.decode_frames(stream, device="cuda")
    torch.cuda.synchronize()
    one = [("parse", None), ("dict", "parse"), ("staging", "parse"),
           ("upload", None), ("device decode", None)]
    assert tree(t) == one * 3
    assert_nested(t)
    staged = 2 * size[stream] + size[img]
    assert t.counters == {"bytes_staged_pinned": staged,
                          "bytes_up": staged}


def test_benchmark_spans_receive_every_label():
    spans = bench_tracing.Spans()
    with bench_tracing.program_spans(spans):
        decode(encode())
    labels = {label for label, _, _ in spans.records}
    assert labels == OLD | NEW
    assert all(s <= e for _, s, e in spans.records)


def test_no_trace_reads_no_clock_and_enters_no_range(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("read or entered with no trace active")

    plain = encode()
    monkeypatch.setattr(profiling, "_clock", refuse)
    monkeypatch.setattr(profiling, "record_function", refuse)
    assert profiling.current() is None
    assert profiling.stage("a") is profiling.stage("b")  # one shared idle
    profiling.count("bytes_up", 3)
    assert encode() == plain
    assert decode(plain).shape == (N, H, W)


def test_count_adds_to_the_active_trace_only():
    profiling.count("bytes_down", 5)
    with profiling.tracing("outer") as t:
        profiling.count("bytes_down", 5)
        profiling.count("bytes_down")
        profiling.count("bytes_up", 2)
        with profiling.tracing("inner") as inner:
            profiling.count("bytes_up", 7)
    assert t.counters == {"bytes_down": 6, "bytes_up": 2}
    assert inner.counters == {"bytes_up": 7}


def test_device_trace_holds_each_span_within_its_parent(tmp_path):
    with profiling.tracing("encode") as t:
        with profiling.device_trace(str(tmp_path / "trace")):
            decode(encode())
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    by_label: dict = {}
    for ev in events["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("name") in OLD | NEW:
            by_label.setdefault(ev["name"], []).append(ev)
    seen: dict = {}
    ranges = []
    for label, _, _, parent in t.records:  # a label's ranges in order
        evs = sorted(by_label[label], key=lambda ev: ev["ts"])
        ev = evs[seen.get(label, 0)]
        seen[label] = seen.get(label, 0) + 1
        ranges.append((ev["ts"], ev["ts"] + ev["dur"]))
        if parent >= 0:
            ps, pe = ranges[parent]
            assert ps <= ranges[-1][0] and ranges[-1][1] <= pe, label
    assert seen == {label: len(evs) for label, evs in by_label.items()}


def test_report_prints_a_tree_with_calls_and_counters(capsys):
    with profiling.tracing("encode", pixels=N * W * H) as t:
        encode()
        profiling.count("bytes_up", 12)
    t.report()
    tag = "[trace:encode] "
    lines = [line.split(tag, 1)[1] for line in
             capsys.readouterr().err.splitlines() if tag in line]
    assert [line.split(":")[0] for line in lines] == [
        "device video encode", "  wait", "  tobytes", "splice", "huffman",
        "  restage", "  tobytes", "encode_passes", "bytes_up", "total"]
    assert "(self " in lines[0] and lines[1].endswith(", 2 calls)")
    assert lines[3].endswith(", 1 call)")
    assert lines[7:9] == ["encode_passes: 2", "bytes_up: 12"]
    for depth, label, calls, total, own in t.tree():
        assert 0 <= own <= total and calls >= 1


# ---- the benchmark's readers of the new spans ----

ENCODE_CELL = {"splice_ms.encode_video", "restage_ms.encode_video",
               "wait_ms.encode", "waits.encode", "tobytes_ms.encode",
               "enqueue_ms.encode"}
DECODE_CELL = {"dict_ms.decode_video", "staging_ms.decode_video"}
# Two requests of 10 ms in each: (label, start s, end s).
SPANS = [("device video encode", 0.000, 0.004), ("wait", 0.001, 0.002),
         ("tobytes", 0.0015, 0.003), ("splice", 0.004, 0.006),
         ("huffman", 0.006, 0.010), ("restage", 0.006, 0.007),
         ("wait", 0.008, 0.009), ("tobytes", 0.009, 0.010),
         ("parse", 0.010, 0.014), ("dict", 0.010, 0.011),
         ("staging", 0.012, 0.0135), ("device video encode", 0.020, 0.023)]
WANT = {"splice_ms.encode_video": 1.0, "restage_ms.encode_video": 0.5,
        "wait_ms.encode": 1.0, "waits.encode": 1.0,
        "tobytes_ms.encode": 1.25,
        # (4 - the union 1..3 of its children) + 3 ms, over 2 requests
        "enqueue_ms.encode": 2.5,
        "dict_ms.decode_video": 0.5, "staging_ms.decode_video": 0.75}


def synthetic_run(entry: str, direction: str) -> harness.Run:
    spans = bench_tracing.Spans()
    spans.records = list(SPANS)
    wl = types.SimpleNamespace(entry=entry, direction=direction)
    return harness.Run(wl, 1.0, [0.01, 0.01], 0.02, spans=spans)


def test_new_metrics_are_the_ones_benchmark_json_lists():
    listed = {m["name"]: m for m in harness.spec()["per_layer"]}
    for name in ENCODE_CELL | DECODE_CELL:
        cell = "video_720p_gop4." + ("encode" if name in ENCODE_CELL
                                     else "decode")
        assert listed[name]["workloads"] == [cell]
        assert listed[name]["source"] == "program_span"


@pytest.mark.parametrize("name", sorted(ENCODE_CELL | DECODE_CELL))
def test_new_reader_reads_its_cell_only(name):
    read = harness.reader(name)
    enc = synthetic_run("encode_frames", "encode")
    dec = synthetic_run("decode_frames", "decode")
    mine, other = (enc, dec) if name in ENCODE_CELL else (dec, enc)
    assert read(mine) == pytest.approx(WANT[name])
    assert read(other) is None


@pytest.mark.parametrize("name", sorted((ENCODE_CELL | DECODE_CELL) - {
    "enqueue_ms.encode"}))
def test_new_reader_is_silent_without_its_spans(name):
    """A program without the span (the parent of this change) reads as
    nothing, and does not raise."""
    run = synthetic_run("encode_frames" if name in ENCODE_CELL
                        else "decode_frames",
                        "encode" if name in ENCODE_CELL else "decode")
    run.spans.records = [r for r in SPANS if r[0] in OLD]
    assert harness.reader(name)(run) is None
