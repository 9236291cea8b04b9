"""The ("frame", "block") device mesh over torch.distributed.

The counterpart of imageencoder_tpu/parallel/mesh.py.  The reference's only
parallelism is OpenMP threads over blocks inside one process; the codec's
mesh has two axes:

  * "frame": data parallelism over frames (every GOP opens with an I-frame,
    so GOPs are independent);
  * "block": spatial parallelism over a frame's block rows, each rank a
    horizontal stripe.

One rank of the world is one device.  The mesh is torch.distributed's
DeviceMesh over the default process group (parallel/distributed.py::
initialize), ranks laid out row-major: rank = frame index * block size +
block index.  The JAX package's collectives along an axis become these:
``axis_index`` is :func:`axis_index` (DeviceMesh.get_local_rank),
``all_gather`` and ``psum`` along an axis are :func:`all_gather` and
:func:`all_reduce` on ``mesh.get_group(axis)``, and ``ppermute`` to the
next or previous rank along an axis is :func:`shift`.  On the CPU the
groups are gloo's.  On a card they are NCCL's, one rank a card, or gloo's
where the ranks outnumber the cards, processes sharing a card (NCCL takes
one rank a card): there every collective stages its tensors through
pinned host memory, as gloo moves host tensors; the data and the kernels
stay on the card.  A mesh on the CPU over NCCL, or on cards over gloo
with a card for every rank, raises.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from . import distributed

AXES = ("frame", "block")


def mesh_shape(n_devices: int, frame_axis: int | None = None):
    """(frame, block) extents of a mesh of ``n_devices``: ``frame_axis``
    if given, else as close to square as possible with frame >= block."""
    if frame_axis is None:
        frame_axis = 1
        for f in range(math.isqrt(n_devices), 0, -1):
            if n_devices % f == 0:
                frame_axis = max(f, n_devices // f)
                break
    if frame_axis < 1 or n_devices % frame_axis:
        raise ValueError(f"a frame axis of {frame_axis} does not divide "
                         f"{n_devices} devices")
    return frame_axis, n_devices // frame_axis


def make_mesh(n_devices: int | None = None, frame_axis: int | None = None,
              device="cuda"):
    """The ("frame", "block") DeviceMesh over the world's ranks, one device
    each.  ``n_devices`` must be the world's size (by default it is);
    without an initialized process group a world of one is initialized
    first (NCCL on a card, gloo on the CPU).  Every rank calls it (its
    groups are made collectively); make it once and pass it on."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(f"a mesh of {n_devices} devices needs an "
                               f"initialized process group of that size "
                               f"(parallel.distributed.initialize)")
        distributed.initialize(device=dev.type)
    world = dist.get_world_size()
    # gloo on a card only where the ranks outnumber the cards: NCCL takes
    # one rank a card, so processes that share a card have no other.
    gloo = dist.get_backend() == "gloo" and (
        dev.type == "cpu" or world > torch.cuda.device_count())
    if not gloo:
        distributed.check_backend(dev.type)
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices in a world of "
                         f"{world} ranks")
    from torch.distributed.device_mesh import init_device_mesh

    # gloo's groups are host groups: a card's data over them is staged.
    mesh = init_device_mesh("cpu" if gloo else dev.type,
                            mesh_shape(n_devices, frame_axis),
                            mesh_dim_names=AXES)
    mesh.data_device_type = dev.type
    return mesh


def mesh_device(mesh) -> torch.device:
    """The device of this rank: its card (``cuda:<current>``) or the CPU."""
    kind = getattr(mesh, "data_device_type", mesh.device_type)
    if kind == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(kind)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(AXES.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's index along ``axis`` (jax.lax.axis_index)."""
    return mesh.get_local_rank(axis)


def _staged(x: torch.Tensor, group) -> bool:
    """Whether a collective of ``group`` moves ``x`` through host memory:
    a card's tensor over gloo."""
    return x.device.type != "cpu" and dist.get_backend(group) == "gloo"


def _host(x: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a card's tensor (the copy waits for it, as
    gloo reads it at once).  The copies back to the card do not wait:
    PyTorch's pinned-memory allocator keeps a block until its copy has
    run."""
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return out.copy_(x)


def all_gather(x: torch.Tensor, mesh, axis: str | None = None):
    """Every rank's ``x`` stacked in rank order along a new first
    dimension: the ranks of ``axis`` (jax.lax.all_gather), or of the whole
    mesh (rank-major: frame, then block) for ``axis=None``."""
    group = None if axis is None else mesh.get_group(axis)
    n = dist.get_world_size(group)
    flat = x.contiguous().reshape(-1)  # gloo takes flat tensors
    staged = _staged(x, group)
    if staged:
        flat = _host(flat)
    out = torch.empty(n * flat.numel(), dtype=x.dtype, device=flat.device,
                      pin_memory=staged)
    dist.all_gather_into_tensor(out, flat, group=group)
    return out.to(x.device, non_blocking=True).view(n, *x.shape)


def all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (jax.lax.psum)."""
    group = mesh.get_group(axis)
    if _staged(x, group):
        host = _host(x)
        dist.all_reduce(host, group=group)
        return host.to(x.device, non_blocking=True)
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x


def shift(x: torch.Tensor, mesh, axis: str, step: int,
          cyclic: bool) -> torch.Tensor:
    """``x`` sent to the rank ``step`` (+1 or -1) places along ``axis``;
    returns what arrived from the rank ``step`` places before
    (jax.lax.ppermute with pairs (i, i + step)): on a ring with
    ``cyclic``, else zeros at the end no rank sends to.  Point-to-point
    within ``mesh.get_group(axis)`` (batch_isend_irecv); a rank posts
    nothing to itself, so on an axis of one rank the ring returns ``x``
    and the open axis zeros."""
    if step not in (1, -1):
        raise ValueError(f"step must be 1 or -1, not {step}")
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)
    if n == 1:
        return x.clone() if cyclic else torch.zeros_like(x)
    group = mesh.get_group(axis)
    dst, src = i + step, i - step
    if cyclic:
        dst, src = dst % n, src % n
    staged = _staged(x, group)
    send = x.contiguous()
    if staged:  # gloo's point-to-point takes host tensors
        send = _host(send)
    recv = torch.zeros(send.shape, dtype=send.dtype, device=send.device,
                       pin_memory=staged)
    ops = []
    if 0 <= dst < n:
        ops.append(dist.P2POp(dist.isend, send,
                              dist.get_global_rank(group, dst), group))
    if 0 <= src < n:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, src), group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(x.device, non_blocking=True) if staged else recv
