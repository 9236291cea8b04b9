#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (imageencoder_tpu_torch) on one GPU.

    python3 chip_smoke.py

It needs one CUDA card (an H100: the kernels are built for sm_90a), nvcc,
and this checkout.  It imports only the port (and through it the JAX
package's jax-free host modules), never JAX and never the JAX package's
encoder or decoder.  Phases, each of which raises on failure:

  1. build the kernels in imageencoder_tpu_torch/csrc with nvcc;
  2. capture the arguments each kernel wrapper (K1 encode_locals, K2
     pack_locals, K3 byte_histogram, K4 pack_records) receives in one real
     encode_image call on a 4096x912 image (233,472 blocks), and hold each
     kernel against its plain PyTorch version on those CUDA tensors:
     bit-equal;
  3. drive the main path, encode_image(..., use_huffman=True,
     device="cuda"), on seeded 4096x912 and 3840x2160 images, plus
     use_huffman=False and a small noise image that takes the raw-copy
     fallback; every kernel's launch count over this phase must be at
     least 1;
  4. hold every stream from phase 3 against the port's plain path,
     encode_image(..., device="cpu"), byte for byte.  That path is the one
     tests/test_torch_image.py holds byte-equal to the JAX package's host
     engine, and tests/test_torch_cuda.py holds these very streams against
     that engine on the card;
  5. time the device encode, the Huffman stage, the whole encode_image and
     the host-to-device copy, inputs resident on the device;
  6. profile 10 encode_image calls and print the device time per call by
     operation: where the device time goes.

Kernel times: ``ms`` and ``plain_ms`` are device time per call from
torch.profiler (the kernel alone; everything the plain version runs);
``call_ms`` and ``plain_call_ms`` are CUDA-event times of back-to-back
calls, which include the wrappers' glue and launch overhead.

Output: the card's name and power limit on an early line, one JSON line
{"kernels": [...]} before the last, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time

sys.modules["jax"] = None  # any import of JAX fails loudly

QUANT = [[16, 11, 10, 16], [12, 12, 14, 19], [14, 13, 16, 24],
         [14, 17, 22, 29]]  # top-left of the JPEG luminance table
SHAPES = ((912, 4096), (2160, 3840))  # (H, W): ex4's geometry, 4K UHD
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SAMPLES = 110  # per end-to-end timing: p90 has 11 samples beyond it
PROFILE_CALLS = 10
KERNELS = {  # name: (wrapper's module, wrapper, plain version,
    #                 CUDA kernel symbol, source, the TPU kernel replaced)
    "K1 encode_locals": ("cuda_encode", "encode_locals",
                         "encode_locals_plain", "encode_locals_kernel",
                         "imageencoder_tpu_torch/csrc/encode.cu",
                         "imageencoder_tpu/ops/pallas_encode.py:130"),
    "K2 pack_locals": ("cuda_pack", "pack_locals", "pack_locals_plain",
                       "pack_locals_kernel",
                       "imageencoder_tpu_torch/csrc/pack.cu",
                       "imageencoder_tpu/ops/pallas_pack.py:256"),
    "K3 byte_histogram": ("cuda_kernels", "byte_histogram",
                          "byte_histogram_plain", "byte_histogram_kernel",
                          "imageencoder_tpu_torch/csrc/histogram.cu",
                          "imageencoder_tpu/ops/pallas_kernels.py:37"),
    "K4 pack_records": ("cuda_pack", "pack_records", "pack_records_plain",
                        "pack_records_kernel",
                        "imageencoder_tpu_torch/csrc/pack.cu",
                        "imageencoder_tpu/ops/pallas_pack.py:55"),
}


def synthetic(h: int, w: int, seed: int):
    """A smooth field plus noise, u8 [h, w]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    f = (128.0 + 60.0 * np.sin(x / 37.0) * np.cos(y / 23.0)
         + 30.0 * np.sin((x + y) / 91.0) + rng.normal(0.0, 6.0, (h, w)))
    return np.clip(np.rint(f), 0, 255).astype(np.uint8)


def module(name: str):
    import importlib

    return importlib.import_module(f"imageencoder_tpu_torch.ops.{name}")


@contextlib.contextmanager
def captured_calls():
    """Record the (args, kwargs) of every kernel-wrapper call made inside
    the block: the main path looks its wrappers up on their modules at
    each call, so a recording stand-in there sees the real inputs.  The
    wrappers are put back on exit."""
    calls = {name: [] for name in KERNELS}
    saved = []
    for name, (mod_name, attr, *_) in KERNELS.items():
        mod = module(mod_name)
        real = getattr(mod, attr)

        def record(*args, _real=real, _calls=calls[name], **kwargs):
            _calls.append((args, kwargs))
            return _real(*args, **kwargs)

        # A wrapper counts its launches on the name its module binds.
        record.launches = 0
        saved.append((mod, attr, real))
        setattr(mod, attr, record)
    try:
        yield calls
    finally:
        for mod, attr, real in saved:
            setattr(mod, attr, real)


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean CUDA-event milliseconds per call of fn() run back to back."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_rows(fn, reps: int):
    """(device microseconds per call by operation, host wall ms per call)
    of fn() under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = {}
    for e in prof.key_averages():
        # Device rows only: an aten op's row repeats its kernels' time.
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if t is None else t
        rows[e.key] = rows.get(e.key, 0.0) + us / reps
    return rows, wall_ms


def profiled_ms(fn, symbol: str | None = None, reps: int = 20) -> float:
    """Device milliseconds per call of fn() from torch.profiler: the
    kernels whose name contains ``symbol``, or all device work."""
    rows, _ = device_rows(fn, reps)
    us = sum(t for key, t in rows.items() if symbol is None or symbol in key)
    if us <= 0.0:
        raise AssertionError(f"the profiler saw no device time for "
                             f"{symbol or 'the call'}")
    return us / 1e3


def quantiles(samples) -> tuple[float, float]:
    """(median, p90) of a list of seconds, in milliseconds."""
    s = sorted(samples)
    return s[len(s) // 2] * 1e3, s[int(len(s) * 0.9)] * 1e3


def as_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def max_abs_err(a, b) -> int:
    """Largest |a - b| over int tensors of equal shape (0 when bit-equal)."""
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def tensor_bytes(xs) -> int:
    import torch

    return sum(x.numel() * x.element_size() for x in xs
               if isinstance(x, torch.Tensor) and x.dim() > 0)


def check_kernel(name: str, args: tuple, kwargs: dict) -> dict:
    """Hold one kernel against its plain version on the arguments the main
    path gave it, and time both."""
    import torch

    mod_name, attr, plain_attr, symbol, source, replaces = KERNELS[name]
    mod = module(mod_name)
    kernel, plain = getattr(mod, attr), getattr(mod, plain_attr)

    def kernel_call():
        return as_tuple(kernel(*args, **kwargs))

    def plain_call():
        return as_tuple(plain(*args, **kwargs))

    got, want = kernel_call(), plain_call()
    torch.cuda.synchronize()
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} outputs, plain "
                             f"{len(want)}")
    err = max(max_abs_err(a, b) for a, b in zip(got, want))
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version (max abs err {err})")
    # The bytes the kernel itself must move: its tensor inputs, and its
    # outputs up to the stream's end where the output is a stream.
    if name in ("K2 pack_locals", "K4 pack_records"):
        nbytes = tensor_bytes(args[:2]) + (int(got[1]) + 7) // 8
    elif name == "K3 byte_histogram":
        nbytes = (int(args[1]) + 7) // 8
    else:
        nbytes = tensor_bytes(args[:1]) + tensor_bytes(got)
    plain_call_ms = cuda_ms(plain_call)
    call_ms = (cuda_ms(kernel_call) + cuda_ms(kernel_call)) / 2
    plain_call_ms = (plain_call_ms + cuda_ms(plain_call)) / 2
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": 0, "max_abs_err": err,
           "ms": profiled_ms(kernel_call, symbol),
           "plain_ms": profiled_ms(plain_call),
           "call_ms": call_ms, "plain_call_ms": plain_call_ms,
           "bytes": nbytes, "hbm_floor_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    shapes = ", ".join(str(tuple(a.shape)) for a in args
                       if isinstance(a, torch.Tensor))
    print(f"{name} on {shapes}: bit-equal to plain; device {row['ms']:.4f} "
          f"ms (plain {row['plain_ms']:.4f} ms); per call {call_ms:.4f} ms "
          f"(plain {plain_call_ms:.4f} ms); HBM floor "
          f"{row['hbm_floor_ms']:.4f} ms for {nbytes} bytes", flush=True)
    return row


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs one GPU")

    import imageencoder_tpu_torch as port
    from imageencoder_tpu_torch.kernels import build
    from imageencoder_tpu_torch.models.image import stream_header
    from imageencoder_tpu_torch.ops.huffman import huffman_encode_from_meta
    from imageencoder_tpu_torch.ops.pipeline import make_encode_packed_hist
    from imageencoder_tpu_torch.utils.device import gpu_identity

    dev = torch.device("cuda", 0)
    print(f"gpu: {gpu_identity()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # ---- 1. build ----
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in build.BUILD_LOG.splitlines():
        if "Used" in line or "spill" in line or "Compiling" in line:
            print(f"  {line.strip()}")

    quant = port.QuantMatrix(np.array(QUANT, dtype=np.uint32))

    # ---- 2. each kernel against its plain version, main-path inputs ----
    images = [synthetic(h, w, 2 + i) for i, (h, w) in enumerate(SHAPES)]
    with captured_calls() as calls:
        port.encode_image(images[0], quant, use_rle=True, use_huffman=True,
                          device="cuda")
    rows = {}
    for name in KERNELS:
        if len(calls[name]) != 1:
            raise AssertionError(f"{name}: {len(calls[name])} calls in one "
                                 f"encode_image, expected 1")
        rows[name] = check_kernel(name, *calls[name][0])
    del calls

    # ---- 3. the main path ----
    # No full-size image compresses too little for the dict (the records'
    # headers skew the byte histogram), so the raw-copy fallback runs on a
    # small noise image.
    noise = np.random.default_rng(9).integers(0, 256, (128, 256),
                                              dtype=np.uint8)
    q_ones = port.QuantMatrix(np.ones((4, 4), dtype=np.uint32))
    cases = ([(im, quant, True) for im in images]
             + [(images[0], quant, False), (noise, q_ones, True)])
    wrappers = {name: getattr(module(mod_name), attr)
                for name, (mod_name, attr, *_) in KERNELS.items()}
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    streams = [port.encode_image(im, q, use_rle=True, use_huffman=huff,
                                 device="cuda") for im, q, huff in cases]
    for name, fn in wrappers.items():
        rows[name]["launches"] = fn.launches
        if fn.launches < 1:
            raise AssertionError(f"{name} was not launched on the main path")
    print("main-path launches: " + ", ".join(
        f"{name} {fn.launches}" for name, fn in wrappers.items()),
        flush=True)

    # ---- 4. every stream against the port's plain path on the host ----
    for (im, q, huff), got in zip(cases, streams):
        label = f"{im.shape[1]}x{im.shape[0]} huffman={huff}"
        t0 = time.perf_counter()
        want = port.encode_image(im, q, use_rle=True, use_huffman=huff,
                                 device="cpu")
        plain_s = time.perf_counter() - t0
        if got != want:
            raise AssertionError(f"{label}: the card's stream differs from "
                                 f"the plain path's ({len(got)} vs "
                                 f"{len(want)} bytes)")
        kind = ("fallback" if huff and not got[0] & 0x80 else
                "huffman" if huff else "raw")
        if huff and (kind == "fallback") != (im is noise):
            raise AssertionError(f"{label}: took the {kind} branch")
        print(f"{label}: {len(got)} bytes ({kind}), byte-identical to the "
              f"plain path on the host ({plain_s:.2f} s there)", flush=True)

    # ---- 5. timing: device encode, Huffman stage, encode_image, H2D ----
    for (hh, ww), im in zip(SHAPES, images):
        mpix = hh * ww / 1e6
        t = []
        for _ in range(SAMPLES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img_d = torch.from_numpy(im).to(dev)
            torch.cuda.synchronize()
            t.append(time.perf_counter() - t0)
        h2d = quantiles(t)

        sb, hdr = stream_header(quant, True, ww, hh, True, dev)
        qf = quant.as_float()
        enc = make_encode_packed_hist(4, True, "reference")
        words, meta = enc(img_d, qf, sb, hdr)
        meta = meta.cpu().numpy()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(SAMPLES)]
        for start, end in ev:
            start.record()
            enc(img_d, qf, sb, hdr)
            end.record()
        torch.cuda.synchronize()
        dev_enc = quantiles([s.elapsed_time(e) / 1e3 for s, e in ev])
        busy = profiled_ms(lambda: enc(img_d, qf, sb, hdr))

        t = []
        for _ in range(SAMPLES):
            t0 = time.perf_counter()
            huffman_encode_from_meta(words, meta)
            t.append(time.perf_counter() - t0)
        huff = quantiles(t)

        t = []
        for _ in range(SAMPLES):
            t0 = time.perf_counter()
            port.encode_image(img_d, quant, use_huffman=True, device="cuda")
            t.append(time.perf_counter() - t0)
        e2e = quantiles(t)
        print(f"{ww}x{hh}: device encode K1+K2+K3 median {dev_enc[0]:.4f} "
              f"ms, p90 {dev_enc[1]:.4f} ms (n={SAMPLES}; "
              f"{mpix / dev_enc[0] * 1e3:.1f} Mpix/s), of which device busy "
              f"{busy:.4f} ms; Huffman stage (huffman_encode_from_meta) "
              f"median {huff[0]:.3f} ms, p90 {huff[1]:.3f} ms; encode_image "
              f"with Huffman, image on device: median {e2e[0]:.3f} ms, p90 "
              f"{e2e[1]:.3f} ms (n={SAMPLES}; "
              f"{mpix / e2e[0] * 1e3:.1f} Mpix/s); H2D copy median "
              f"{h2d[0]:.3f} ms, p90 {h2d[1]:.3f} ms (n={SAMPLES})",
              flush=True)

    # ---- 6. where the device time of encode_image goes ----
    img_d = torch.from_numpy(images[0]).to(dev)
    by_op, wall_ms = device_rows(
        lambda: port.encode_image(img_d, quant, use_huffman=True,
                                  device="cuda"), PROFILE_CALLS)
    busy_us = sum(by_op.values())
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:12]
    print(f"profile of {PROFILE_CALLS} encode_image calls at "
          f"{SHAPES[0][1]}x{SHAPES[0][0]}: device busy {busy_us:.1f} us of "
          f"{wall_ms * 1e3:.1f} us wall per call; top device items per "
          f"call: " + "; ".join(f"{key[:60]} {us:.1f} us" for key, us in top),
          flush=True)

    print(json.dumps({"kernels": [rows[name] for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
