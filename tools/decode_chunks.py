#!/usr/bin/env python3
"""Time D1 (Huffman decode) and D2 (offset walk) at several chunk sizes.

    python3 tools/decode_chunks.py

Needs one CUDA card.  Encodes the seeded 4096x912 and 3840x2160 images of
chip_smoke.py on the card (Huffman on), then for each chunk size runs D1
on the stream and D2 on its payload, checks the output equal to the
default chunk size's, and prints per chunk size: the device time of each
of the four launches (walk, check, stitch, emit) from torch.profiler, the
live chunks and how many the true chain walked whole (each such chunk is
a step of the one-thread stitch).  Then the same for chip_smoke.py's
1280x720x25 raw video stream (gop 4, merange 16, Huffman on): D1 on the
stream and D2 over the whole video (walk_video, its 18 jumps in the
stitch).  The card's name and power limit come first.
"""

from __future__ import annotations

import pathlib
import re
import sys

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import imageencoder_tpu_torch as port  # noqa: E402
from imageencoder_tpu_torch.models.image import parse_stream, upload  # noqa
from imageencoder_tpu_torch.ops import cuda_decode  # noqa: E402
from imageencoder_tpu_torch.utils.device import gpu_identity  # noqa: E402

QUANT = [[16, 11, 10, 16], [12, 12, 14, 19], [14, 13, 16, 24],
         [14, 17, 22, 29]]
SHAPES = ((912, 4096), (2160, 3840))
VIDEO = (1280, 720, 25)
D1_CHUNKS = (256, 512, 1024, 2048)
D2_CHUNKS = (512, 1024, 2048, 4096)
REPS = 10


def synthetic(h: int, w: int, seed: int) -> np.ndarray:
    """chip_smoke.py's content: a smooth field plus noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    f = (128.0 + 60.0 * np.sin(x / 37.0) * np.cos(y / 23.0)
         + 30.0 * np.sin((x + y) / 91.0) + rng.normal(0.0, 6.0, (h, w)))
    return np.clip(np.rint(f), 0, 255).astype(np.uint8)


def device_us(fn) -> dict:
    """Device microseconds per call of fn() by kernel name."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            found = re.search(r"(\w+)_kernel", e.key)
            name = found.group(1) if found else e.key[:24]
            rows[name] = rows.get(name, 0.0) + e.self_device_time_total / REPS
    return rows


def sweep(label: str, fn, chunks, reference) -> None:
    for chunk in chunks:
        stats = torch.zeros(2, dtype=torch.int64, device="cuda")
        got = fn(chunk, stats)
        for a, b in zip(got, reference):
            n = a.shape[0] if a.dim() else 1
            if not torch.equal(a[:n], b[:n]):
                raise AssertionError(f"{label} at {chunk} bits differs")
        rows = device_us(lambda: fn(chunk, None))
        total = sum(rows.values())
        parts = ", ".join(f"{k} {v:.2f}" for k, v in sorted(rows.items()))
        live, whole = stats.tolist()
        print(f"{label} chunks of {chunk} bits: {total:.2f} us ({parts}); "
              f"{live} chunks, {whole} walked whole", flush=True)


def video_stream() -> bytes:
    """chip_smoke.py's 720p25 raw stream: 8x8 random blocks moving by
    (2, 3) pixels a frame plus noise of sigma 3, gop 4, merange 16."""
    w, h, n = VIDEO
    rng = np.random.default_rng(0)
    base = np.kron(rng.integers(0, 256, (h // 8, w // 8)), np.ones((8, 8)))
    yuv = b"".join(np.clip(np.roll(base, (f * 2, f * 3), (0, 1))
                           + rng.normal(0, 3, base.shape), 0, 255)
                   .astype(np.uint8).tobytes() + bytes([0x80]) * (w * h // 2)
                   for f in range(n))
    return port.encode_video(yuv, w, h, port.QuantMatrix(np.array(
        QUANT, np.uint32)), True, 4, 16, use_huffman=True, device="cuda")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("decode_chunks: needs a CUDA card")
    print(f"gpu: {gpu_identity()}", flush=True)
    quant = port.QuantMatrix(np.array(QUANT, np.uint32))
    dev = torch.device("cuda", 0)
    for i, (h, w) in enumerate(SHAPES):
        data = port.encode_image(synthetic(h, w, 2 + i), quant,
                                 use_huffman=True, device="cuda")
        plan = parse_stream(data)
        views = upload(plan, dev)
        d1_args = (views["stream"], views["nbytes"], plan["dict_end"],
                   views["table"], plan["max_len"], plan["cap"])
        payload, count = cuda_decode.huffman_decode(*d1_args)
        n_payload = int(count)
        d1_ref = (payload[:n_payload], count)

        def d1(chunk, stats):
            out, cnt = cuda_decode.huffman_decode(*d1_args, chunk_bits=chunk,
                                                  stats=stats)
            return out[:n_payload], cnt

        d2_args = (payload, count, plan["start"], plan["n_blocks"],
                   plan["use_rle"], 4)
        d2_ref = cuda_decode.walk_offsets(*d2_args)

        def d2(chunk, stats):
            return cuda_decode.walk_offsets(*d2_args, chunk_bits=chunk,
                                            stats=stats)

        print(f"{w}x{h}: {len(data)} stream bytes, {n_payload} payload "
              f"bytes, {plan['n_blocks']} records", flush=True)
        sweep(f"D1 {w}x{h}", d1, D1_CHUNKS, d1_ref)
        sweep(f"D2 {w}x{h}", d2, D2_CHUNKS, d2_ref)

    from imageencoder_tpu_torch.models.video import plan_video

    data = video_stream()
    plan = plan_video(data)
    views = upload(plan, dev)
    v1_args = (views["stream"], views["nbytes"], plan["dict_end"],
               views["table"], plan["max_len"], plan["cap"])
    payload, count = cuda_decode.huffman_decode(*v1_args)
    n_payload = int(count)

    def v1(chunk, stats):
        out, cnt = cuda_decode.huffman_decode(*v1_args, chunk_bits=chunk,
                                              stats=stats)
        return out[:n_payload], cnt

    params = plan["params"]
    v2_args = (payload, count, plan["start"], params.frame_count,
               plan["n_blocks"], params.gop, plan["vbits"], plan["use_rle"],
               4)

    def v2(chunk, stats):
        return cuda_decode.walk_video(*v2_args, chunk_bits=chunk,
                                      stats=stats)

    w, h, n = VIDEO
    label = f"{w}x{h}x{n}"
    print(f"{label}: {len(data)} stream bytes, {n_payload} payload bytes, "
          f"{n * plan['n_blocks']} records, {plan['vbits']} vector bits a "
          f"P-frame", flush=True)
    sweep(f"D1 {label}", v1, D1_CHUNKS, v1(cuda_decode.CHUNK_BITS_HUFFMAN,
                                           None))
    sweep(f"D2 video {label}", v2, D2_CHUNKS,
          v2(cuda_decode.CHUNK_BITS_WALK, None))


if __name__ == "__main__":
    main()
