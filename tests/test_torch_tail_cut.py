"""The tail's cut into bytes on the CPU (ops/huffman.py::cut_parts, which
Tail.result runs on its buffer), held byte for byte against tobytes() of
each part.

Where the parts take two slices of CUT_SLICE bytes or more and the
process may use two cores, their bytes objects are made uninitialised and
filled by memmove on several threads, a slice each that may cross from one
part into the next; else the cut is tobytes().  The cases take every size
around that threshold, one core alone, the two clips' stream sizes,
offsets off a 4-byte boundary, 16 parts of about 1.2 MB and a zero-length
part between large ones; and the counter ``bytes_cut_threaded``, results
that outlive their source, cuts from several threads at once and a whole
Tail over a wire past the threshold.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from imageencoder_tpu_torch.ops import cuda_pack, huffman
from imageencoder_tpu_torch.utils import profiling

MIB = 1 << 20
RAW, RECON = 46_729_792, 60_915_314  # the two clips' stream bytes
SIZES = [0, 1, 8 * MIB - 1, 8 * MIB, 8 * MIB + 1, RAW, RECON]


def layout(sizes, first: int = 3, gap: int = 5) -> list[tuple[int, int]]:
    """(offset, length) of parts laid one after another from ``first``,
    ``gap`` bytes apart: every offset off a 4-byte boundary."""
    parts, at = [], first
    for n in sizes:
        parts.append((at, n))
        at += n + gap
    return parts


CASES = {
    **{f"one part of {n}": layout([n]) for n in SIZES},
    "16 parts of about 1.2 MB": layout([1_200_000 + 7 * k
                                        for k in range(16)]),
    "an empty part between large ones": layout([9 * MIB + 1, 0,
                                                9 * MIB + 3]),
    "small parts around a large one": layout([1, 12 * MIB, 2, 0]),
}


@pytest.fixture(scope="module")
def source() -> np.ndarray:
    """Random bytes enough for the largest case."""
    n = max(at + m for parts in CASES.values() for at, m in parts[-1:])
    return np.frombuffer(np.random.default_rng(25).bytes(n + 64), np.uint8)


def plain(data: np.ndarray, parts) -> list[bytes]:
    return [data[at:at + n].tobytes() for at, n in parts]


def threaded(total: int) -> bool:
    """Whether cut_parts takes the threads for ``total`` bytes here."""
    return min(huffman.CUT_THREADS, len(os.sched_getaffinity(0)),
               total // huffman.CUT_SLICE) >= 2


@pytest.mark.parametrize("case", list(CASES))
def test_cut_equals_tobytes(source, case):
    """The cut of every case equals tobytes() of each part, as bytes; the
    counter takes the total past the threshold and is absent below it."""
    parts = CASES[case]
    total = sum(n for _, n in parts)
    with profiling.tracing("cut") as t:
        got = huffman.cut_parts(source, parts)
    assert all(type(b) is bytes for b in got)
    assert got == plain(source, parts)
    if threaded(total):
        assert t.counters == {"bytes_cut_threaded": total}
    else:
        assert "bytes_cut_threaded" not in t.counters


@pytest.mark.parametrize("slices", [1, 2, 3, 8, 17])
@pytest.mark.parametrize("case", ["16 parts of about 1.2 MB",
                                  "an empty part between large ones",
                                  "small parts around a large one"])
def test_threaded_cut_on_any_slice_count(source, case, slices):
    """Slices that start and end inside parts, more slices than parts and
    than threads, one slice: each equals tobytes()."""
    parts = CASES[case]
    got = huffman.cut_threaded(source, parts, slices)
    assert all(type(b) is bytes for b in got)
    assert got == plain(source, parts)


def test_one_core_cuts_on_one_thread(source, monkeypatch):
    """A process that may use one core takes tobytes() whatever the size:
    the bytes are the same and the counter stays absent."""
    monkeypatch.setattr(huffman.os, "sched_getaffinity", lambda pid: {0})
    parts = CASES[f"one part of {RECON}"]
    with profiling.tracing("cut") as t:
        got = huffman.cut_parts(source, parts)
    assert got == plain(source, parts)
    assert "bytes_cut_threaded" not in t.counters


def test_counter_sums_the_threaded_calls_only(source):
    big, small = CASES["an empty part between large ones"], layout([MIB])
    with profiling.tracing("cut") as t:
        huffman.cut_parts(source, big)
        huffman.cut_parts(source, small)
        huffman.cut_parts(source, big)
    assert t.counters == {"bytes_cut_threaded":
                          2 * sum(n for _, n in big)}


def random_bytes(parts, seed: int) -> np.ndarray:
    """A writable buffer of random bytes that holds ``parts``."""
    n = max(at + m for at, m in parts)
    return np.frombuffer(np.random.default_rng(seed).bytes(n + 3),
                         np.uint8).copy()


def test_results_outlive_their_source():
    parts = layout([RAW // 2, RAW // 2])
    data = random_bytes(parts, 1)
    want = plain(data, parts)
    got = huffman.cut_parts(data, parts)
    data[:] = 0x5A
    assert got == want


def test_threads_cutting_at_once_get_their_own_bytes():
    """Four Python threads cut their own buffers through the one pool,
    each several times, under a short switch interval."""
    parts = [layout([10 * MIB - k, 0, 1 + k]) for k in range(4)]
    bufs = [random_bytes(p, k) for k, p in enumerate(parts)]
    want = [plain(b, p) for b, p in zip(bufs, parts)]
    got = [[] for _ in bufs]

    def cut(k):
        for _ in range(3):
            got[k].append(huffman.cut_parts(bufs[k], parts[k]))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=cut, args=(k,)) for k in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert got == [[w] * 3 for w in want]


@pytest.mark.parametrize("parts,error", [
    ([(0, 9 * MIB), (9 * MIB, 2 * MIB)], "outside"),
    ([(-1, 9 * MIB)], "outside"),
])
def test_threaded_cut_refuses_parts_outside_the_buffer(parts, error):
    data = np.zeros(10 * MIB, np.uint8)
    with pytest.raises(ValueError, match=error):
        huffman.cut_parts(data, parts)


def test_threaded_cut_refuses_a_strided_buffer():
    data = np.zeros(20 * MIB, np.uint8)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        huffman.cut_parts(data, [(0, 9 * MIB)])


def test_tail_on_the_cpu_past_the_threshold_equals_its_plain_version():
    """Tail(...).finish() over three streams of a wire of about 12 MB,
    none of them a whole number of words: each stream is its words' plain
    wire bytes, and the counter takes them all."""
    width = MIB
    rng = np.random.default_rng(7)
    words = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (3, width))
                             .astype(np.int32))
    bits = [32 * width - 3, 32 * width - 70, 8 * 3 * MIB + 5]
    with profiling.tracing("tail") as t:
        got = huffman.Tail(words, torch.tensor(bits)).finish()
    want = [cuda_pack.wire_bytes(words[k], b).numpy().tobytes()
            for k, b in enumerate(bits)]
    assert all(type(b) is bytes for b in got)
    assert got == want
    assert t.counters["bytes_cut_threaded"] == sum(map(len, want))
