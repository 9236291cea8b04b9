"""The plain versions of K6 (motion search) and K7 (prediction).

The counterparts of imageencoder_tpu/ops/video_pipeline.py::
sad_motion_search and ops/pallas_motion.py, on torch tensors of any
device.  The search is the JAX package's SAD-map formulation:

  * :func:`sad_maps_plain`: the zero-padded translation SAD maps, what the
    TPU kernel K6 computes, without its D8 row padding and 128-lane layout;
  * :func:`descend_plain`: the reference's 2D-log descent as lookups into
    those maps (video_pipeline.py:155-169, Block.cpp:268-339): MER_SIGNS
    order and search_steps(merange) levels; ``diff <= running`` accepts
    ties, so later candidates win; ``running`` starts each level at the
    previous level's best; a candidate p > 0 whose clamped (effective)
    offset is zero is skipped; candidates keep their unclamped offsets;
  * :func:`predict_plain`: the clamped 16 x 16 window copy
    (ops/motion.py::predict_image).

Every offset the descent can reach lies within +-(merange - 1), and a
clamped candidate's SAD is the map's at its effective offset
clip(pos + off, 0, dim - 16) - pos, which lies in the same range: so the
lookups never leave the maps, and the zero padding is never read.

Each takes a stripe of the frames as well (the sharded video encode,
parallel/video_sharding.py): cur holds rows row0 .. row0 + h - 1 of frames
h_glob rows tall, ref holds rows row0 - halo .. row0 + h + halo - 1 of the
reference (halo rows from the neighbouring stripes), and every position is
clamped in global rows, as video_sharding.py:377-382 and :401-405 clamp
it.  A whole frame is row0 = 0, halo = 0, h_glob = h.

The CUDA kernels (ops/cuda_motion.py) search directly instead of building
the maps.
"""

from __future__ import annotations

import numpy as np
import torch

# The port's copies of imageencoder_tpu/ops/motion.py's constants.
MACRO = 16  # dc::MacroBlockSize (Block.hpp:14)

# algo.cpp:90-100, as (x, y), in evaluation order.
MER_SIGNS = np.array([(0, 0), (1, 0), (1, 1), (0, 1), (-1, 1),
                      (-1, 0), (-1, -1), (0, -1), (1, -1)], dtype=np.int32)


def p_frames(n_frames: int, gop: int, f0: int = 0) -> list[int]:
    """Indices of a video's P-frames: every frame but each GOP's first; of
    a chunk of the video from global frame f0, the local indices f with
    (f0 + f) % gop != 0."""
    return [f for f in range(n_frames) if (f0 + f) % gop]


def search_steps(merange: int) -> list[int]:
    """Per-level step sizes: merange//2, //4, ... 1 (algo.cpp:119-139)."""
    steps = []
    m = int(merange) // 2
    while m > 0:
        steps.append(m)
        m //= 2
    return steps


def macro_origins(h: int, w: int, device):
    """Row-major macroblock top-left x and y, int64 [Nmb] each
    (ops/motion.py::macro_grid)."""
    by, bx = torch.meshgrid(torch.arange(0, h - MACRO + 1, MACRO,
                                         device=device),
                            torch.arange(0, w - MACRO + 1, MACRO,
                                         device=device), indexing="ij")
    return bx.reshape(-1), by.reshape(-1)


def sad_maps_plain(cur: torch.Tensor, ref: torch.Tensor, merange: int,
                   halo: int = 0) -> torch.Tensor:
    """cur u8 [F, H, W], ref u8 [F, H + 2 * halo, W] -> int32
    [F, D, D, H/16, W/16], D = 2m - 1: [f, dy + m - 1, dx + m - 1, by, bx]
    is the SAD of macroblock (by, bx) of cur[f] against ref[f] translated
    by (dy, dx), ref's row halo lying under cur's row 0; zero outside
    ref."""
    f, h, w = cur.shape
    pad = int(merange) - 1
    d = 2 * pad + 1
    nby, nbx = h // MACRO, w // MACRO
    c = cur.to(torch.int16)[:, None]
    refp = torch.nn.functional.pad(ref.to(torch.int16), (pad, pad, pad, pad))
    rows = []
    for dy in range(d):  # one dy at a time bounds the [F, D, H, W] diff
        y0 = halo + dy
        band = refp[:, y0:y0 + h].unfold(2, w, 1)          # [F, H, D, W]
        diff = (c - band.permute(0, 2, 1, 3)).abs()        # [F, D, H, W]
        rows.append(diff.reshape(f, d, nby, MACRO, nbx, MACRO)
                    .sum(dim=(3, 5), dtype=torch.int32))
    return torch.stack(rows, dim=1)


def descend_plain(maps: torch.Tensor, h: int, w: int, merange: int,
                  row0: int = 0, h_glob: int | None = None) -> torch.Tensor:
    """The reference descent over maps from :func:`sad_maps_plain` of the
    stripe of rows row0 .. row0 + h - 1 of frames h_glob rows tall (a
    whole frame by default): int32 [F, Nmb, 2] motion vectors as (x, y)."""
    f = maps.shape[0]
    dev = maps.device
    pad = int(merange) - 1
    h_glob = h if h_glob is None else h_glob
    bx, by = macro_origins(h, w, dev)
    by = by + row0
    n = bx.shape[0]
    flat = maps.reshape(f, maps.shape[1], maps.shape[2], n)
    fi = torch.arange(f, device=dev)[:, None]
    bi = torch.arange(n, device=dev)[None, :]
    offx = torch.zeros((f, n), dtype=torch.int64, device=dev)
    offy = torch.zeros_like(offx)
    best = torch.full((f, n), 2 ** 31 - 1, dtype=torch.int64, device=dev)
    for step in search_steps(merange):
        running, selx, sely = best, offx, offy
        for p, (sx, sy) in enumerate(MER_SIGNS.tolist()):
            cx, cy = offx + sx * step, offy + sy * step
            ex = (bx + cx).clamp(0, w - MACRO) - bx
            ey = (by + cy).clamp(0, h_glob - MACRO) - by
            diff = flat[fi, ey + pad, ex + pad, bi].to(torch.int64)
            acc = diff <= running
            if p > 0:
                acc &= (ex != 0) | (ey != 0)
            running = torch.where(acc, diff, running)
            selx = torch.where(acc, cx, selx)
            sely = torch.where(acc, cy, sely)
        offx, offy, best = selx, sely, running
    return torch.stack([offx, offy], dim=-1).to(torch.int32)


def motion_search_plain(cur: torch.Tensor, ref: torch.Tensor,
                        merange: int, row0: int = 0, halo: int = 0,
                        h_glob: int | None = None) -> torch.Tensor:
    """The plain version of K6: cur u8 [F, H, W] searched in ref u8
    [F, H + 2 * halo, W] (a stripe, see the module docstring; by default
    whole frames) -> int32 [F, Nmb, 2] (x, y); merange < 2 gives zero
    vectors."""
    f, h, w = cur.shape
    if not search_steps(merange):
        return torch.zeros((f, (h // MACRO) * (w // MACRO), 2),
                           dtype=torch.int32, device=cur.device)
    return descend_plain(sad_maps_plain(cur, ref, merange, halo), h, w,
                         merange, row0, h_glob)


def predict_plain(ref: torch.Tensor, mvec: torch.Tensor, row0: int = 0,
                  halo: int = 0, h_glob: int | None = None) -> torch.Tensor:
    """The plain version of K7: ref u8 [F, H + 2 * halo, W] (a stripe,
    see the module docstring; by default whole frames), mvec int32
    [F, Nmb, 2] -> u8 [F, H, W], every macroblock copied from its clamped
    window."""
    f, h, w = ref.shape
    h -= 2 * halo
    h_glob = h if h_glob is None else h_glob
    dev = ref.device
    bx, by = macro_origins(h, w, dev)
    px = (bx + mvec[..., 0]).clamp(0, w - MACRO)           # [F, Nmb]
    py = (by + row0 + mvec[..., 1]).clamp(0, h_glob - MACRO) - row0 + halo
    r = torch.arange(MACRO, device=dev)
    win = ref[torch.arange(f, device=dev)[:, None, None, None],
              (py[:, :, None, None] + r[:, None]),
              (px[:, :, None, None] + r)]                  # [F, Nmb, 16, 16]
    nby, nbx = h // MACRO, w // MACRO
    return (win.reshape(f, nby, nbx, MACRO, MACRO).permute(0, 1, 3, 2, 4)
            .reshape(f, h, w))
