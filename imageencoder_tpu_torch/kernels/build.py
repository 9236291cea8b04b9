"""Build the CUDA kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` process, all started
together, and the objects link into one shared library with a plain C
interface: no PyTorch headers, so a build takes seconds.  The build runs at
first use, into ``imageencoder_tpu_torch/_build/`` (listed in
``.gitignore``), under a name keyed by a hash of the sources and flags, so
an edited source rebuilds and an unchanged one loads at once.  A failed
build raises; nothing falls back.

Every C entry point takes raw pointers and the CUDA stream as ``void*``
and returns the launch's ``cudaGetLastError()``; :func:`check` raises on a
nonzero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "--fmad=false",
                 "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_U64 = ctypes.c_ulonglong
SIGNATURES = {
    "ie_encode_locals": [_P, _I32, _I64, _I64, _I32, _P, _P, _P, _P, _I32,
                         _I32, _P, _P, _P, _P],
    # img, dtype, frames, img_stride, h, w, block_size, w, scale, quant,
    # recip, out, out_stride, lens, lens_stride, use_rle, stream
    "ie_quantize_image": [_P, _I32, _I64, _I64, _I64, _I64, _I32, _P, _P, _P,
                          _P, _P, _I64, _P, _I64, _I32, _P],
    # cur, cur_stride, pred, pred_stride, frames, h, w, block_size, w,
    # scale, quant, recip, wi, coeffs, coeffs_stride, recon, recon_stride,
    # lens, lens_stride, use_rle, stream
    "ie_recon_step": [_P, _I64, _P, _I64, _I64, _I64, _I64, _I32, _P, _P, _P,
                      _P, _P, _P, _I64, _P, _I64, _P, _I64, _I32, _P],
    "ie_motion_search": [_P, _P, _I64, _I32, _I32, _I32, _P, _P],
    # cur, cur_stride, ref, ref_stride, n_frames, h, w, merange, mvec,
    # mvec_stride, pred, pred_stride, stream
    "ie_search_predict": [_P, _I64, _P, _I64, _I64, _I32, _I32, _I32, _P,
                          _I64, _P, _I64, _P],
    "ie_search_residual": [_P, _I64, _I32, _I32, _I32, _I32, _P, _P, _P],
    # cur, cur_stride, ref, ref_stride, n_frames, h, w, row0, halo, h_glob,
    # merange, mvec, mvec_stride, pred, pred_stride, stream
    "ie_search_predict_stripe": [_P, _I64, _P, _I64, _I64, _I32, _I32, _I32,
                                 _I32, _I32, _I32, _P, _I64, _P, _I64, _P],
    # cur, ref, n_frames, h, w, row0, halo, h_glob, merange, f0, gop,
    # mvec, residual, stream
    "ie_search_residual_stripe": [_P, _P, _I64, _I32, _I32, _I32, _I32,
                                  _I32, _I32, _I64, _I32, _P, _P, _P],
    # ref, ref_stride, mvec, mvec_stride, n_frames, h, w, pred,
    # pred_stride, stream
    "ie_predict": [_P, _I64, _P, _I64, _I64, _I32, _I32, _P, _I64, _P],
    "ie_pack_locals": [_P, _P, _I64, _I32, _P, _I64, _I64, _I32, _I32, _I64,
                       _P, _I64, _P, _I64, _P, _P, _P, _P],
    # local, lens, n_blocks, lw, n_streams, start_bit, starts, prefix,
    # prefix_words, out, n_words, sums, total, hist, stream
    "ie_pack_locals_batch": [_P, _P, _I64, _I32, _I64, _I64, _P, _P, _I64,
                             _P, _I64, _P, _P, _P, _P],
    "ie_pack_locals_scratch": [_I64, _I32],
    # vals, nbits, n, f, start_bit, prefix, prefix_words, out, n_words,
    # sums, total, stream
    "ie_pack_records": [_P, _P, _I64, _I32, _I64, _P, _I64, _P, _I64, _P, _P,
                        _P],
    # vals, nbits, n, f, n_segments, starts, out, n_words, sums, total,
    # stream
    "ie_pack_records_segments": [_P, _P, _I64, _I32, _I64, _P, _P, _I64, _P,
                                 _P, _P],
    "ie_pack_records_scratch": [_I64],
    # words, n_in, table, out, n_words, sums, total, stream
    "ie_pack_payload": [_P, _I64, _P, _P, _I64, _P, _P, _P],
    # words, n_in, tables, n_streams, out, n_words, sums, total, stream
    "ie_pack_payload_batch": [_P, _I64, _P, _I64, _P, _I64, _P, _P, _P],
    "ie_pack_payload_scratch": [_I64],
    # coeffs, frames, h, w, block_size, lens, mvecs, n_macro, gop,
    # mvec_nbits, use_rle, lw, start_bit, prefix, prefix_words, out,
    # n_words, sums, total, hist, stream
    "ie_pack_coeffs": [_P, _I64, _I64, _I64, _I32, _P, _P, _I64, _I32, _I32,
                       _I32, _I32, _I64, _P, _I64, _P, _I64, _P, _P, _P, _P],
    "ie_pack_coeffs_scratch": [_I64, _I32],
    "ie_byte_histogram": [_P, _I64, _P, _P, _P],
    # words, n_words, n_rows, lo, hi, hist, stream
    "ie_byte_histogram_rows": [_P, _I64, _I64, _P, _P, _P, _P],
    # inner, inner_stride, inner_words, payload, payload_stride,
    # payload_words, tables, totals, n_streams, out, stream
    "ie_emit_wire": [_P, _I64, _I64, _P, _I64, _I64, _P, _P, _I64, _P, _P],
    "ie_huffman_dict": [_P, _P, _P, _P],
    "ie_huffman_dict_batch": [_P, _P, _P, _I64, _P],
    "ie_dict_table_words": [],
    "ie_div_sweep": [_P, _I64, _I64, _I32, _U64, _P, _P],
    # data, nbytes, start_bit, n_chunks, chunk_bits, table, max_len, out,
    # cap, count, scratch, rounds, stats, n_stats, stream
    "ie_huffman_decode": [_P, _P, _I64, _I64, _I32, _P, _I32, _P, _I64, _P,
                          _P, _I32, _P, _I32, _P],
    # data, nbytes, start_bit, n_chunks, chunk_bits, n_micro, n_frames,
    # gop, vbits, use_rle, block_size, offs, dbits, counts, end, vstart,
    # rstart, scratch, stats, n_stats, stream
    "ie_walk_video": [_P, _P, _I64, _I64, _I32, _I64, _I64, _I32, _I64, _I32,
                      _I32, _P, _P, _P, _P, _P, _P, _P, _P, _I32, _P],
    # n_chunks, chunk_bits, with_table
    "ie_chain_scratch_words": [_I64, _I32, _I32],
    # data, nbytes, vstart, n_frames, gop, n_fields, mb, out, stream
    "ie_read_vectors": [_P, _P, _P, _I64, _I32, _I64, _I32, _P, _P],
    # data, nbytes, offs, dbits, counts, n_blocks, n_frames, rec_stride,
    # quant, wi, izz, block_size, width, pred, pred_stride, img,
    # img_stride, stream
    "ie_decode_blocks": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _P, _P, _P,
                         _I32, _I64, _P, _I64, _P, _I64, _P],
}

_LOCK = threading.Lock()
_LIB = None
BUILD_LOG = ""  # ptxas resource report of the last build in this process


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def nvcc_path() -> str:
    """nvcc from CUDA_HOME (as PyTorch resolves it) or from PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel; returns their output, and raises with
    it if any failed.  Every process has ended when this returns."""
    procs = []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
        outs = [p.communicate()[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{out}"
              for cmd, p, out in zip(cmds, procs, outs) if p.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build() -> pathlib.Path:
    """Compile csrc/*.cu into the keyed shared library; returns its path."""
    global BUILD_LOG
    out = BUILD_DIR / f"libimageencoder_kernels_{_digest()}.so"
    if out.exists():
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        units = sorted(CSRC.glob("*.cu"))
        objs = [str(pathlib.Path(tmp) / f"{u.stem}.o") for u in units]
        logs = _run_all([[nvcc, *COMPILE_FLAGS, "-c", str(u), "-o", o]
                         for u, o in zip(units, objs)])
        lib = str(pathlib.Path(tmp) / "lib.so")
        logs += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)
    BUILD_LOG = "".join(logs)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ie_error_string.argtypes = [ctypes.c_int]
            lib.ie_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().ie_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def stream_ptr(device) -> int:
    """Raw handle of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require(t, name: str, dtype, ndim: int, device) -> None:
    """Check what a kernel takes before its launch: a contiguous CUDA
    tensor of the given dtype and rank on ``device``."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def require_frames(t, name: str, dtype, ndim: int, device) -> None:
    """As :func:`require`, but the first dimension may have any stride:
    each of its entries (a frame of pixels, a frame's records) must be
    contiguous, as a view ``x[k::step]`` of a contiguous tensor is."""
    require(t[:1], name, dtype, ndim, device)
    if t.stride(0) < 0:
        raise ValueError(f"{name}: negative stride")


def frame_stride(t, name: str, dtype, ndim: int, device,
                 align: int = 16) -> int:
    """Check a stack of frames that a kernel reads or writes frame by
    frame (:func:`require_frames`): the first frame ``align``-byte aligned
    and the others a multiple of ``align`` bytes apart, as frames of a
    contiguous stack and its views ``x[k::step]`` are.  Returns the frame
    stride in elements."""
    require_frames(t, name, dtype, ndim, device)
    require_aligned(t, name, align)
    if t.shape[0] > 1 and (t.stride(0) * t.element_size()) % align:
        raise ValueError(f"{name}: frames must start {align} bytes apart")
    return t.stride(0)


def require_aligned(t, name: str, align: int = 16) -> None:
    """Check that a kernel reading ``t`` in vectors may: its data starts
    at a multiple of ``align`` bytes (a fresh allocation does)."""
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data must start at a multiple of {align} "
                         f"bytes")
