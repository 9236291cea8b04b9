"""Multi-process orchestration: process groups and GOPs across processes.

The counterpart of imageencoder_tpu/parallel/distributed.py.  GOPs never
reference each other (every GOP opens with an I-frame), so a video encode
distributes as

    process p encodes GOPs {i : i % n_processes == p}   (no communication)
    -> each GOP's payload bits, from bit 0
    -> every process gathers every payload, splices them in GOP order
       behind the header and runs the Huffman stage

The only data that crosses processes is the packed payloads (host bytes,
small beside the pixels): :func:`gather_segments`, two fixed-shape
all-gathers on the default group.  Within a process the frames and blocks
shard over the ("frame", "block") mesh (parallel/sharding.py).

:func:`initialize` brings the default process group up with an explicit
backend: NCCL for ``cuda``, gloo for ``cpu``.  A GOP-distributed encode
whose processes share one card runs its group on gloo and its kernels on
the card (``encode_gops(..., device="cuda")``): NCCL takes one rank a
card.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from ..utils.checkpoint import (encode_gop_payload, gop_encoder, gop_slices,
                                splice_gops)
from ..models.image import BLOCK_SIZE
from ..models.video import check_video, split_yuv420
from ..ops.device_pack import to_device
from ..utils.device import resolve_device
from ..utils.quant import QuantMatrix

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
TIMEOUT = datetime.timedelta(seconds=300)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device="cuda",
               timeout: datetime.timedelta = TIMEOUT) -> None:
    """Initialize the default process group of ``num_processes`` (1 by
    default) with the backend of ``device``'s type (NCCL for a card, gloo
    for the CPU), this process as rank ``process_id``.

    ``coordinator_address`` is the group's rendezvous: "tcp://host:port",
    "host:port" or "file:///path" (a file store, which needs no port).  A
    world of one needs none.  Raises where the backend is not available
    (no NCCL, no card) or a group is already up."""
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no process group backend for device {device}")
    backend = BACKENDS[kind]
    available = (dist.is_available() and
                 (dist.is_nccl_available() if backend == "nccl"
                  else dist.is_gloo_available()))
    if not available:
        raise RuntimeError(f"torch.distributed has no {backend} backend "
                           f"here, which device {device} needs")
    if kind == "cuda":
        resolve_device(device)  # raises without a card
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialized")
    world = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    if not 0 <= rank < world:
        raise ValueError(f"process {rank} of a world of {world}")
    if coordinator_address is None:
        if world != 1:
            raise ValueError(f"a world of {world} processes needs a "
                             f"coordinator address")
        kwargs = {"store": dist.HashStore()}
    elif coordinator_address.startswith(("tcp://", "file://", "env://")):
        kwargs = {"init_method": coordinator_address}
    else:
        kwargs = {"init_method": f"tcp://{coordinator_address}"}
    if kind == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=timeout, **kwargs)


def check_backend(kind: str) -> None:
    """Raise unless the default group's backend is the one of a device of
    type ``kind``."""
    want, got = BACKENDS[kind], dist.get_backend()
    if got != want:
        raise RuntimeError(f"the default process group runs {got}; a "
                           f"{kind} mesh needs {want}")


def gop_assignment(n_gops: int, n_hosts: int, host: int) -> list[int]:
    """Round-robin GOP ownership (balanced to within one GOP)."""
    return list(range(host, n_gops, n_hosts))


def gather_segments(segments: dict, n_gops: int) -> dict:
    """Every process's GOP segments {gop id: (bytes, bits)}, gathered on
    every process of the default group (the identity without one, or in
    a world of one).  Every process calls it with its own map and the same
    ``n_gops`` and returns the complete map.

    Payloads differ in length, so two fixed-shape all-gathers move them:
    the first agrees on the longest payload, the second carries each
    process's [rows, 24 + cap] u8 rows of (gop id, bits, bytes, payload),
    -1 for an unused row.  The tensors lie on the CPU for gloo and on this
    process's card for NCCL."""
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    if n_proc <= 1:
        return dict(segments)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))

    def all_gather(arr: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(arr.reshape(-1)).to(dev)
        out = torch.empty(n_proc * x.numel(), dtype=x.dtype, device=dev)
        dist.all_gather_into_tensor(out, x)
        return out.cpu().numpy().reshape(n_proc, *arr.shape)

    rows = (n_gops + n_proc - 1) // n_proc
    if len(segments) > rows:
        raise ValueError(f"{len(segments)} segments on one process, at most "
                         f"{rows} fit its rows")
    local_cap = max((len(b) for b, _ in segments.values()), default=0)
    cap = int(all_gather(np.array([local_cap], np.int64)).max())

    buf = np.zeros((rows, 24 + cap), np.uint8)
    buf[:, :24] = np.array([-1, 0, 0], np.int64).view(np.uint8)  # unused
    for r, (gid, (payload, nbits)) in enumerate(sorted(segments.items())):
        buf[r, :24] = np.array([gid, nbits, len(payload)],
                               np.int64).view(np.uint8)
        buf[r, 24:24 + len(payload)] = np.frombuffer(payload, np.uint8)

    out: dict = {}
    for row in all_gather(buf).reshape(-1, 24 + cap):
        gid, nbits, nbytes = row[:24].copy().view(np.int64)
        if gid >= 0:
            out[int(gid)] = (row[24:24 + int(nbytes)].tobytes(), int(nbits))
    return out


def encode_gops(data: bytes, width: int, height: int, quant: QuantMatrix,
                use_rle: bool, gop: int, merange: int, gop_ids,
                norm: str = "reference", device="cuda",
                ref_mode: str = "raw",
                block_size: int = BLOCK_SIZE) -> dict:
    """This process's GOPs of the YUV420p video ``data``, each encoded on
    ``device`` from bit 0 (utils/checkpoint.py::encode_gop_payload):
    {gop id: (bytes, bits)}."""
    check_video(width, height, gop, ref_mode, block_size)
    dev = resolve_device(device)
    frames = split_yuv420(data, width, height)
    slices = gop_slices(len(frames), gop)
    fn = gop_encoder(gop, merange, block_size, use_rle, norm, ref_mode)
    out = {}
    for i in gop_ids:
        s, e = slices[i]
        out[i] = encode_gop_payload(fn, to_device(frames[s:e], dev), quant)
    return out


def missing_gops(segments: dict, n_frames: int, gop: int) -> list[int]:
    """The GOP ids absent or malformed in a gathered segment map (a failed
    or late process's share).  Re-encode them anywhere with
    encode_gops(..., gop_ids=missing): GOPs are independent."""
    n_gops = len(gop_slices(n_frames, gop))
    bad = []
    for i in range(n_gops):
        seg = segments.get(i)
        if (seg is None or len(seg) != 2 or not isinstance(seg[0], bytes)
                or int(seg[1]) > len(seg[0]) * 8
                or (int(seg[1]) == 0) != (len(seg[0]) == 0)):
            bad.append(i)
    return bad


def assemble(segments: dict, n_frames: int, width: int, height: int,
             quant: QuantMatrix, use_rle: bool, gop: int, merange: int,
             use_huffman: bool = True, device="cuda") -> bytes:
    """The stream from a complete segment map: the header, the GOP
    payloads in order, then with Huffman the Huffman stage on ``device``
    (utils/checkpoint.py::splice_gops).  Raises ValueError on an incomplete
    or inconsistent map: re-encode missing_gops(...) and retry."""
    bad = missing_gops(segments, n_frames, gop)
    if bad:
        raise ValueError(f"missing or malformed GOP segments: {bad}; "
                         f"re-encode them via encode_gops(gop_ids={bad})")
    return splice_gops([segments[i] for i in sorted(segments)], n_frames,
                       width, height, quant, use_rle, gop, merange,
                       use_huffman, resolve_device(device))
