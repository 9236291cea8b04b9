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
``axis_index`` is :func:`axis_index` (DeviceMesh.get_local_rank), and
``all_gather`` and ``psum`` along an axis are :func:`all_gather` and
:func:`all_reduce` on ``mesh.get_group(axis)``.  On a card the group is
NCCL's; on the CPU gloo's.  Nothing switches backend: a mesh asked for on
``cuda`` over a gloo group, or on the CPU over an NCCL one, raises.
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
    distributed.check_backend(dev.type)
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices in a world of "
                         f"{world} ranks")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, mesh_shape(n_devices, frame_axis),
                            mesh_dim_names=AXES)


def mesh_device(mesh) -> torch.device:
    """The device of this rank: its card (``cuda:<current>``) or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(AXES.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's index along ``axis`` (jax.lax.axis_index)."""
    return mesh.get_local_rank(axis)


def all_gather(x: torch.Tensor, mesh, axis: str | None = None):
    """Every rank's ``x`` stacked in rank order along a new first
    dimension: the ranks of ``axis`` (jax.lax.all_gather), or of the whole
    mesh (rank-major: frame, then block) for ``axis=None``."""
    group = None if axis is None else mesh.get_group(axis)
    n = dist.get_world_size(group)
    flat = x.contiguous().reshape(-1)  # gloo takes flat tensors
    out = torch.empty(n * flat.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, flat, group=group)
    return out.view(n, *x.shape)


def all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (jax.lax.psum)."""
    x = x.clone()
    dist.all_reduce(x, group=mesh.get_group(axis))
    return x
