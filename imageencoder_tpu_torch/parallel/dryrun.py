"""Multi-process runs of the sharded and GOP-distributed paths.

:func:`spawn_world` starts ``n`` Python processes, one rank each, joined
into one process group through a file store in a work directory (no port),
and runs the same list of jobs on every rank, SPMD: each job is a named
function of this module (:data:`JOBS`) with its keyword arguments, and
each rank's results come back as numpy arrays and bytes.  Every process
runs with one torch thread; every wait has a deadline, and on a failure or
a timeout every process is killed and the ranks' errors are raised.

:func:`dryrun_multichip` is the port's counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``: on the CPU over gloo it runs the
sharded image encode (both Huffman stages), the sharded decode and the
GOP-distributed video encode in a world of ``n`` ranks and holds each
against the one-device path.

    python -m imageencoder_tpu_torch.parallel.dryrun 4
"""

from __future__ import annotations

import datetime
import os
import pathlib
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PKG_ROOT = pathlib.Path(__file__).resolve().parents[2]
TIMEOUT_S = 300.0
MODULE = "imageencoder_tpu_torch.parallel.dryrun"


def _numpy(x):
    """Tensors (nested in tuples, lists and dicts) as numpy arrays."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    return x


class _Meshes:
    """A rank's CPU meshes, one for each frame extent a job asks for: a
    mesh's groups are made once, by every rank together."""

    def __init__(self):
        self.meshes = {}

    def __call__(self, frame_axis=None):
        from .mesh import make_mesh

        if frame_axis not in self.meshes:
            self.meshes[frame_axis] = make_mesh(None, frame_axis,
                                                device="cpu")
        return self.meshes[frame_axis]


def job_mesh(mesh):
    """This rank's (frame extent, block extent, frame index, block index)."""
    from .mesh import axis_index, axis_size

    return tuple(f(mesh, a) for f in (axis_size, axis_index)
                 for a in ("frame", "block"))


def job_encode_step(mesh, frames, quant, **kw):
    from .sharding import make_sharded_encode_step

    return make_sharded_encode_step(mesh, **kw)(frames, quant)


def job_encode_packed(mesh, frames, quant, start_bit, mode):
    from .sharding import make_sharded_encode_packed

    return make_sharded_encode_packed(mesh, mode=mode)(frames, quant,
                                                       start_bit)


def job_huffman(mesh, frames, quant, start_bit, header, mode):
    """Stage 1, then stage 2 on its output."""
    from .sharding import encode_sharded_huffman, make_sharded_encode_packed

    words, bits, hist = make_sharded_encode_packed(mesh, mode=mode)(
        frames, quant, start_bit)
    return encode_sharded_huffman(words, bits, hist, start_bit, header, mesh,
                                  mode=mode)


def job_image_batch(mesh, frames, quant, **kw):
    from .sharding import encode_sharded_image_batch

    return encode_sharded_image_batch(frames, quant, mesh, **kw)


def job_decode(mesh, data):
    from .sharding import decode_image_sharded

    return decode_image_sharded(data, mesh)


def job_video_step(mesh, frames, quant, gop, merange, **kw):
    from ..models.video import mvec_bits
    from .video_sharding import make_sharded_video_step

    return make_sharded_video_step(mesh, gop, merange, mvec_bits(merange),
                                   **kw)(frames, quant)


def job_video_packed(mesh, frames, quant, gop, merange, start_bit, **kw):
    from ..models.video import mvec_bits
    from .video_sharding import make_sharded_video_packed

    return make_sharded_video_packed(mesh, gop, merange, mvec_bits(merange),
                                     **kw)(frames, quant, start_bit)


def job_video_encode(mesh, frames, quant, frames_per_call=None, **kw):
    """encode_video_sharded; with ``frames_per_call``, in calls of at most
    that many frames a rank (MAX_FRAMES_PER_CALL for this job)."""
    from . import video_sharding

    saved = video_sharding.MAX_FRAMES_PER_CALL
    if frames_per_call:
        video_sharding.MAX_FRAMES_PER_CALL = frames_per_call
    try:
        return video_sharding.encode_video_sharded(frames, quant, mesh, **kw)
    finally:
        video_sharding.MAX_FRAMES_PER_CALL = saved


def job_video_huffman(mesh, frames, quant, gop, merange, ref_mode="raw"):
    """The packed step, then the distributed Huffman stage on its output."""
    from ..models.headers import VideoParams
    from ..models.video import mvec_bits, video_header
    from .video_sharding import (encode_sharded_video_huffman,
                                 make_sharded_video_packed)

    f, h, w = frames.shape
    start = video_header(quant, True, w, h, VideoParams(f, gop, merange),
                         True).position
    mvw, blw, bits, hist = make_sharded_video_packed(
        mesh, gop, merange, mvec_bits(merange), ref_mode=ref_mode)(
        frames, quant.as_float(), start)
    return encode_sharded_video_huffman(mvw, blw, bits, hist, w, h, quant,
                                        True, gop, merange, mesh)


def job_video_decode_step(mesh, coeffs, mvec, quant, h, w, gop, **kw):
    from .video_sharding import make_sharded_video_decode

    return make_sharded_video_decode(mesh, h, w, gop, **kw)(coeffs, mvec,
                                                            quant)


def job_video_decode(mesh, data, **kw):
    from .video_sharding import decode_video_sharded

    stream, params, size = decode_video_sharded(data, mesh, **kw)
    return stream, (params.frame_count, params.gop, params.merange), size


def job_raises(mesh, job, **kw):
    """Run a mesh job and return the type and message of what it raised
    (every rank raises alike, before any collective), or None."""
    try:
        JOBS[job](mesh, **kw)
    except Exception as e:  # noqa: BLE001 - reported to the caller
        return type(e).__name__, str(e)
    return None


def job_gops(data, width, height, quant, use_rle, gop, merange,
             ref_mode="raw", use_huffman=True, device="cpu"):
    """The GOP-distributed encode: this rank's GOPs, the segments gathered
    on every rank, the stream assembled.  Returns (stream, the GOPs
    missing from the gathered map)."""
    import torch.distributed as dist

    from ..models.video import split_yuv420
    from ..utils.checkpoint import gop_slices
    from .distributed import (assemble, encode_gops, gather_segments,
                              gop_assignment, missing_gops)

    n_frames = len(split_yuv420(data, width, height))
    n_gops = len(gop_slices(n_frames, gop))
    mine = gop_assignment(n_gops, dist.get_world_size(), dist.get_rank())
    segments = encode_gops(data, width, height, quant, use_rle, gop, merange,
                           mine, device=device, ref_mode=ref_mode)
    gathered = gather_segments(segments, n_gops)
    stream = assemble(gathered, n_frames, width, height, quant, use_rle, gop,
                      merange, use_huffman, device=device)
    return stream, missing_gops(gathered, n_frames, gop)


JOBS = {"mesh": job_mesh, "encode_step": job_encode_step,
        "encode_packed": job_encode_packed, "huffman": job_huffman,
        "image_batch": job_image_batch, "decode": job_decode,
        "video_step": job_video_step, "video_packed": job_video_packed,
        "video_encode": job_video_encode, "video_huffman": job_video_huffman,
        "video_decode": job_video_decode,
        "video_decode_step": job_video_decode_step, "raises": job_raises,
        "gops": job_gops}
MESH_JOBS = set(JOBS) - {"gops"}  # their first argument: the mesh


def _job(name: str):
    """A job by name: one of :data:`JOBS`, or "module:function" of a
    module the processes import (a caller's own job)."""
    if name in JOBS:
        return JOBS[name]
    import importlib

    mod, _, attr = name.partition(":")
    return getattr(importlib.import_module(mod), attr)


def _worker(workdir: str, rank: int, world: int) -> None:
    """One rank: join the group, run every job, write the results."""
    from .distributed import initialize

    torch.set_num_threads(1)
    work = pathlib.Path(workdir)
    jobs = pickle.loads((work / "jobs.pkl").read_bytes())
    timeout = datetime.timedelta(seconds=jobs["collective_timeout_s"])
    initialize(f"file://{work / 'store'}", world, rank, device="cpu",
               timeout=timeout)
    meshes, results = _Meshes(), []
    for name, kwargs in jobs["jobs"]:
        kwargs = dict(kwargs)
        frame_axis = kwargs.pop("frame_axis", None)
        args = (meshes(frame_axis),) if name in MESH_JOBS else ()
        results.append(_numpy(_job(name)(*args, **kwargs)))
    tmp = work / f"result_{rank}.tmp"
    tmp.write_bytes(pickle.dumps(results))
    os.replace(tmp, work / f"result_{rank}.pkl")
    # Every rank is done with the group; then leave without tearing it
    # down: gloo's teardown at exit now and then aborts a process
    # ("terminate called without an active exception").
    import torch.distributed as dist

    dist.barrier()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def spawn_world(n: int, jobs, workdir=None,
                timeout_s: float = TIMEOUT_S) -> list:
    """Run ``jobs`` ([(name, kwargs), ...], names of :data:`JOBS` or
    "module:function") on every rank of a gloo world of ``n`` processes;
    returns each rank's list of results.  A job of :data:`MESH_JOBS`
    takes the rank's mesh of the ``frame_axis`` its kwargs name (made
    once).  The processes start from this package's checkout.  Raises
    RuntimeError, with each failed
    rank's error output, if a rank fails or the world does not finish
    within ``timeout_s``; every process has ended when this returns."""
    with tempfile.TemporaryDirectory() as tmp:
        work = pathlib.Path(workdir or tmp)
        work.mkdir(parents=True, exist_ok=True)
        for old in work.glob("result_*"):
            old.unlink()
        store = work / "store"
        if store.exists():
            store.unlink()
        (work / "jobs.pkl").write_bytes(pickle.dumps({
            "jobs": list(jobs), "collective_timeout_s": timeout_s}))
        child_env = dict(os.environ)
        child_env["PYTHONPATH"] = os.pathsep.join(
            [str(PKG_ROOT)] + [p for p in child_env.get("PYTHONPATH",
                                                        "").split(os.pathsep)
                               if p])
        procs, logs = [], []
        try:
            for rank in range(n):
                log = open(work / f"rank_{rank}.log", "wb")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", MODULE, "--worker", str(work),
                     str(rank), str(n)], cwd=work, env=child_env,
                    stdout=log, stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout_s
            while True:
                codes = [p.poll() for p in procs]
                failed = [(r, f"exit code {c}") for r, c in enumerate(codes)
                          if c not in (None, 0)]
                if failed or None not in codes:
                    break
                if time.monotonic() > deadline:
                    failed = [(r, "timed out") for r, c in enumerate(codes)
                              if c is None]
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
        if failed:
            tails = []
            for rank in range(n):
                text = (work / f"rank_{rank}.log").read_bytes().decode(
                    errors="replace")
                tails.append(f"--- rank {rank} ---\n{text[-3000:]}")
            raise RuntimeError(f"a world of {n} failed: {failed}\n"
                               + "\n".join(tails))
        return [pickle.loads((work / f"result_{r}.pkl").read_bytes())
                for r in range(n)]


def _same(a, b) -> bool:
    """Results equal, arrays element for element."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return a == b


def dryrun_multichip(n: int = 4, timeout_s: float = TIMEOUT_S) -> dict:
    """The sharded and GOP-distributed paths in a gloo world of ``n`` CPU
    ranks, each held against the one-device path on the CPU: the sharded
    image encode (Huffman from stage 1, and the distributed stage 2), the
    sharded decode of its streams, the sharded video encode (raw and
    recon) and decode, and the GOP-distributed video encode.  Returns a
    summary; raises AssertionError on a difference."""
    import imageencoder_tpu_torch as port

    from .mesh import mesh_shape

    fa, sa = mesh_shape(n)
    rng = np.random.default_rng(n)
    base = rng.integers(0, 256, (2 * fa, 4, 6)).astype(np.float64)
    up = np.kron(base, np.ones((1, 4 * sa, 8)))
    frames = np.clip(up + rng.normal(0, 4, up.shape), 0, 255).astype(
        np.uint8)  # [2 * fa, 16 * sa, 48]
    quant = port.QuantMatrix(np.full((4, 4), 10, np.uint32))
    w, h, gop, merange = 48, 32, 2, 4
    video = np.clip(rng.normal(128, 40, (5, h, w)), 0, 255).astype(np.uint8)
    data = b"".join(f.tobytes() + bytes([128]) * (w * h // 2) for f in video)
    # The sharded video: two frames a chunk (a GOP), 16-row stripes.
    sharded = np.clip(rng.normal(128, 40, (2 * fa, 16 * sa, w)), 0,
                      255).astype(np.uint8)
    sdata = b"".join(f.tobytes() + bytes([128]) * (w * 8 * sa)
                     for f in sharded)
    want = [port.encode_image(im, quant, use_huffman=True, device="cpu")
            for im in frames]
    jobs = [("mesh", {}),
            ("image_batch", {"frames": frames, "quant": quant}),
            ("image_batch", {"frames": frames, "quant": quant,
                             "device_entropy": True}),
            ("decode", {"data": want[0]}),
            ("gops", {"data": data, "width": w, "height": h,
                      "quant": quant, "use_rle": True, "gop": gop,
                      "merange": merange})]
    jobs += [("video_encode", {"frames": sharded, "quant": quant,
                               "gop": gop, "merange": merange,
                               "ref_mode": mode})
             for mode in ("raw", "recon")]
    svideo = port.encode_video(sdata, w, 16 * sa, quant, True, gop, merange,
                               device="cpu")
    jobs.append(("video_decode", {"data": svideo}))
    ranks = spawn_world(n, jobs, timeout_s=timeout_s)
    for r, got in enumerate(ranks):
        if got[0][:2] != (fa, sa) or not all(
                _same(a, b) for a, b in zip(got[1:], ranks[0][1:])):
            raise AssertionError(f"rank {r} returned other global results "
                                 f"than rank 0")
    _, stage1, stage2, pixels, (stream, missing), raw, recon, decoded = (
        ranks[0])
    checks = {
        "image batch, stage 1": stage1 == want,
        "image batch, stage 2": stage2 == want,
        "decode": np.array_equal(
            pixels, port.decode_image(want[0], device="cpu").numpy()),
        "GOP encode": not missing and stream == port.encode_video(
            data, w, h, quant, True, gop, merange, device="cpu"),
        "sharded video raw": raw == svideo,
        "sharded video recon": recon == port.encode_video(
            sdata, w, 16 * sa, quant, True, gop, merange, ref_mode="recon",
            device="cpu"),
        "sharded video decode": decoded[0] == port.decode_video(
            svideo, device="cpu")[0],
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"a world of {n} differs from one device: {bad}")
    return {"world": n, "mesh": (fa, sa), "checks": sorted(checks)}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    else:
        print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4))
