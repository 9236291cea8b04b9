"""The codec's wire format, stated plainly in PyTorch: the benchmark's
reference.

It encodes images and raw-reference videos, and decodes a video from the
coefficients and vectors its encode wrote, on any torch device, with no
kernel, no cache and no batching across streams.  It imports nothing of
the program under test.  Every step is an element-wise tensor operation
in a fixed order, so the same inputs give the same bits on the CPU and
on a card.

The format (the reference ImageEncoder's, 4x4 blocks, norm "reference"):

  * a stream without Huffman leads with a 0 bit; then the header: a
    5-bit width w (the bit length of the largest quant entry), the 16
    quant entries w bits each, the RLE bit, width and height in 15 bits
    each; a video adds frame count, GOP and search range, 15 bits each;
  * then the blocks of each frame in row-major order (a P-frame's motion
    vectors first: x then y of each 16x16 macroblock, row-major, each
    ``mvec_bits`` wide); a block's record is a 4-bit width b, with RLE a
    b-bit count, then that many zig-zag coefficients b bits each (all 16
    without RLE); b covers every nonzero coefficient and the bit length of
    the last nonzero position, and is at least 1; with RLE a block whose
    last coefficient is nonzero after a zero drops it (the reference's
    trailing-strip quirk);
  * a coefficient is the f64 DCT of (sample - 128): acc = 0, then
    acc = acc + x[c] * W[c] for the 16 samples in row-major order, each a
    rounded multiply and a rounded add; times C(u)C(v); divided by the
    quant entry; rounded half away from zero.  W's cosines are the C
    library's cos of ((2i + 1)u) * (pi/2 / 4);
  * the inverse dequantizes (one multiply), sums y[k] * Winv[k] over the
    16 coefficients in row-major order, adds 128 (a P-frame then adds its
    prediction to that), clamps to [0, 255] and truncates;
  * a P-frame (every frame but each GOP's first) is predicted from the raw
    frame before it: each macroblock's vector comes from the reference's
    2D-log descent (steps merange/2, /4, ... 1; at each step the nine
    candidates in MER_SIGNS order around the step's start, a candidate
    taking the lead on a SAD no larger than the lead's; a candidate
    other than the first whose clamped window is the macroblock's own
    place is skipped), its window clamped into the frame; the residual
    cur - pred goes through the transform as samples do.

``dtype`` is the precision of the transforms: float64 is the format;
float32 is the benchmark's control, which must fail the comparison.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import torch

from . import huffman

B = 4  # block size
K = B * B
MACRO = 16
DIM_BITS = 15
MER_SIGNS = ((0, 0), (1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1),
             (0, -1), (1, -1))


# ---- tables ----

@lru_cache(maxsize=None)
def zigzag() -> tuple[int, ...]:
    """Row-major indices in zig-zag order: by x + y, and within a
    diagonal by y where x - y is odd, else by x."""
    cells = sorted(range(K), key=lambda i: (i % B + i // B,
                                            i // B if (i % B - i // B) & 1
                                            else i % B))
    return tuple(cells)


@lru_cache(maxsize=None)
def _tables() -> tuple[list, list, list]:
    """(forward weights [16][16] by (sample, coefficient), scales [16],
    inverse weights [16][16] by (coefficient, sample)), f64 Python
    floats, coefficients in row-major order."""
    factor = (math.pi / 2.0) / float(B)
    cos = [[math.cos(float((2 * i + 1) * u) * factor) for i in range(B)]
           for u in range(B)]
    c = [0.5] + [math.sqrt(0.5)] * (B - 1)
    fwd = [[cos[u][i] * cos[v][j] for u in range(B) for v in range(B)]
           for i in range(B) for j in range(B)]
    scale = [c[u] * c[v] for u in range(B) for v in range(B)]
    inv = [[((c[u] * c[v]) * cos[u][i]) * cos[v][j] for i in range(B)
            for j in range(B)] for u in range(B) for v in range(B)]
    return fwd, scale, inv


def _t(rows, dtype, device) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.float64).to(dtype).to(device)


# ---- blocks ----

def blocks(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> [..., N, 16]: row-major blocks of row-major
    samples."""
    *lead, h, w = img.shape
    x = img.reshape(*lead, h // B, B, w // B, B).transpose(-3, -2)
    return x.reshape(*lead, (h // B) * (w // B), K)


def unblocks(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The inverse of :func:`blocks`."""
    *lead, _, _ = x.shape
    y = x.reshape(*lead, h // B, w // B, B, B).transpose(-3, -2)
    return y.reshape(*lead, h, w)


def quantize(samples: torch.Tensor, quant, dtype=torch.float64):
    """Blocks of samples [N, 16] (u8 pixels or int16 residuals) -> int32
    [N, 16] quantized coefficients in row-major order."""
    fwd, scale, _ = _tables()
    dev = samples.device
    w, s = _t(fwd, dtype, dev), _t(scale, dtype, dev)
    q = _t([float(v) for row in quant for v in row], dtype, dev)
    x = samples.to(dtype) - 128.0
    acc = torch.zeros_like(x)
    for c in range(K):
        acc = acc + x[:, c:c + 1] * w[c]
    z = acc * s / q
    t = torch.trunc(z)
    d = z - t
    up = torch.where(z >= 0.0, t + 1.0, t - 1.0)
    return torch.where((d >= 0.5) | (d <= -0.5), up, t).to(torch.int32)


def inverse(coeffs: torch.Tensor, quant, dtype=torch.float64):
    """int32 [N, 16] row-major coefficients -> the inverse + 128 [N, 16]
    in ``dtype``, not yet clamped."""
    _, _, inv = _tables()
    dev = coeffs.device
    w = _t(inv, dtype, dev)
    q = _t([float(v) for row in quant for v in row], dtype, dev)
    y = coeffs.to(dtype) * q
    acc = torch.zeros_like(y)
    for k in range(K):
        acc = acc + y[:, k:k + 1] * w[k]
    return acc + 128.0


def to_u8(x: torch.Tensor) -> torch.Tensor:
    """Clamp to [0, 255] and truncate."""
    return torch.floor(x.clamp(0.0, 255.0)).to(torch.uint8)


# ---- records ----

def bit_length(v: torch.Tensor) -> torch.Tensor:
    """Bits of the binary form of non-negative integers below 2**53."""
    return torch.frexp(v.to(torch.float64))[1].to(torch.int64)


def records(coeffs: torch.Tensor, use_rle: bool):
    """Row-major coefficients int32 [N, 16] -> (values, widths) int64
    [N, 18] of each block's record fields, and the coefficients as the
    record carries them (those it drops are 0), row-major int32
    [N, 16]."""
    zz = coeffs[:, list(zigzag())].to(torch.int64)
    n = zz.shape[0]
    dev = zz.device
    nz = zz != 0
    pos = torch.arange(1, K + 1, device=dev)
    last = torch.where(nz, pos, 0).amax(dim=1)
    widths = bit_length(torch.where(zz >= 0, zz, -zz - 1)) + 1
    bits = torch.clamp(torch.maximum(torch.where(nz, widths, 0).amax(dim=1),
                                     bit_length(last)), min=1)
    vals = torch.zeros((n, K + 2), dtype=torch.int64, device=dev)
    nbits = torch.zeros_like(vals)
    vals[:, 0], nbits[:, 0] = bits, 4
    if use_rle:
        head = torch.where(nz[:, :K - 1], pos[:K - 1], 0).amax(dim=1)
        count = torch.where((last == K) & (head < K - 1), head, last)
        vals[:, 1], nbits[:, 1] = count, bits
    else:
        count = torch.full_like(last, K)
    live = torch.arange(K, device=dev)[None, :] < count[:, None]
    kept = torch.where(live, zz, 0)
    vals[:, 2:] = kept
    nbits[:, 2:] = torch.where(live, bits[:, None], 0)
    carried = torch.empty_like(kept)
    carried[:, list(zigzag())] = kept
    return vals, nbits, carried.to(torch.int32)


def pack(vals: torch.Tensor, nbits: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Fields (value, width up to 32) packed MSB-first, zero-width fields
    skipped, values cut to their width: (u8 bytes, the last zero-padded;
    length in bits)."""
    vals, nbits = vals.reshape(-1), nbits.reshape(-1).to(torch.int64)
    ends = torch.cumsum(nbits, 0)
    total = int(ends[-1]) if ends.numel() else 0
    offs = ends - nbits
    v = vals.to(torch.int64) & ((1 << nbits) - 1)
    window = v << (40 - (offs & 7) - nbits)  # 5 bytes hold any field
    at = offs >> 3
    n = (total + 7) // 8
    out = torch.zeros(n + 5, dtype=torch.int64, device=vals.device)
    for k in range(5):
        out.index_add_(0, at + k, (window >> (32 - 8 * k)) & 0xFF)
    return out[:n].to(torch.uint8), total


def _fields(pairs, device) -> tuple[torch.Tensor, torch.Tensor]:
    v = torch.tensor([p[0] for p in pairs], dtype=torch.int64)
    b = torch.tensor([p[1] for p in pairs], dtype=torch.int64)
    return v.to(device), b.to(device)


def header(quant, use_rle: bool, w: int, h: int, use_huffman: bool,
           video: tuple[int, int, int] | None = None) -> list:
    """The header's fields (see the module docstring)."""
    flat = [int(v) for row in quant for v in row]
    qw = max(v.bit_length() for v in flat)
    out = [] if use_huffman else [(0, 1)]
    out += [(qw, 5)] + [(v, qw) for v in flat]
    out += [(int(use_rle), 1), (w, DIM_BITS), (h, DIM_BITS)]
    if video is not None:
        out += [(x, DIM_BITS) for x in video]
    return out


def huffman_wrap(inner: torch.Tensor) -> bytes:
    """The final stream of inner bytes (see reference/huffman.py)."""
    dev = inner.device
    counts = torch.bincount(inner.to(torch.int64), minlength=256).tolist()
    built = huffman.code_table(counts)
    if built is not None:
        fields, codes, lengths = built
        coded = sum(c * ln for c, ln in zip(counts, lengths))
        dbits = sum(nb for _, nb in fields)
        if inner.numel() >= (dbits + coded + 7) // 8:
            idx = inner.to(torch.int64)
            dv, db = _fields(fields, dev)
            vals = torch.cat([dv, torch.tensor(codes, device=dev)[idx]])
            nbits = torch.cat([db, torch.tensor(lengths, device=dev)[idx]])
            return pack(vals, nbits)[0].cpu().numpy().tobytes()
    vals = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      inner.to(torch.int64)])
    nbits = torch.full_like(vals, 8)
    nbits[0] = 1
    return pack(vals, nbits)[0].cpu().numpy().tobytes()


def finish(vals: torch.Tensor, nbits: torch.Tensor,
           use_huffman: bool) -> bytes:
    inner, _ = pack(vals, nbits)
    if use_huffman:
        return huffman_wrap(inner)
    return inner.cpu().numpy().tobytes()


# ---- image ----

def encode_image(img: torch.Tensor, quant, use_rle: bool = True,
                 use_huffman: bool = True, dtype=torch.float64) -> bytes:
    """A u8 [H, W] image's stream."""
    h, w = img.shape
    vals, nbits, _ = records(quantize(blocks(img), quant, dtype), use_rle)
    hv, hb = _fields(header(quant, use_rle, w, h, use_huffman), img.device)
    return finish(torch.cat([hv, vals.reshape(-1)]),
                  torch.cat([hb, nbits.reshape(-1)]), use_huffman)


# ---- motion ----

def mvec_bits(merange: int) -> int:
    """The width of a vector field: the signed bit length of merange as
    an int16."""
    v = (merange + 2 ** 15) % 2 ** 16 - 2 ** 15
    return (v if v >= 0 else -v - 1).bit_length() + 1


def search_steps(merange: int) -> list[int]:
    out, m = [], merange // 2
    while m > 0:
        out.append(m)
        m //= 2
    return out


def _origins(h: int, w: int, device):
    by, bx = torch.meshgrid(torch.arange(0, h, MACRO, device=device),
                            torch.arange(0, w, MACRO, device=device),
                            indexing="ij")
    return bx.reshape(-1), by.reshape(-1)


def _windows(ref: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """ref [F, H, W], window corners [F, Nmb] -> [F, Nmb, 256]."""
    f, h, w = ref.shape
    r = torch.arange(MACRO, device=ref.device)
    grid = (r[:, None] * w + r[None, :]).reshape(-1)
    idx = (py * w + px)[:, :, None] + grid
    return torch.gather(ref.reshape(f, h * w), 1,
                        idx.reshape(f, -1)).reshape(f, -1, MACRO * MACRO)


def search(cur: torch.Tensor, ref: torch.Tensor, merange: int):
    """Vectors int32 [F, Nmb, 2] (x, y) of cur u8 [F, H, W] against ref,
    by the 2D-log descent (module docstring)."""
    f, h, w = cur.shape
    dev = cur.device
    bx, by = _origins(h, w, dev)
    n = bx.numel()
    zero = torch.zeros(f, n, dtype=torch.int64, device=dev)
    own = _windows(cur, zero + bx, zero + by).to(torch.int32)
    offx, offy = zero, zero
    best = torch.full((f, n), 2 ** 31 - 1, dtype=torch.int64, device=dev)
    for step in search_steps(merange):
        run, selx, sely = best, offx, offy
        for p, (sx, sy) in enumerate(MER_SIGNS):
            cx, cy = offx + sx * step, offy + sy * step
            px = (bx + cx).clamp(0, w - MACRO)
            py = (by + cy).clamp(0, h - MACRO)
            win = _windows(ref, px, py).to(torch.int32)
            sad = (own - win).abs().sum(dim=2).to(torch.int64)
            take = sad <= run
            if p:
                take &= (px != bx) | (py != by)
            run = torch.where(take, sad, run)
            selx = torch.where(take, cx, selx)
            sely = torch.where(take, cy, sely)
        offx, offy, best = selx, sely, run
    return torch.stack([offx, offy], dim=-1).to(torch.int32)


def predict(ref: torch.Tensor, mv: torch.Tensor) -> torch.Tensor:
    """Each macroblock's clamped window of ref u8 [F, H, W] under its
    vector: u8 [F, H, W]."""
    f, h, w = ref.shape
    bx, by = _origins(h, w, ref.device)
    px = (bx + mv[..., 0]).clamp(0, w - MACRO)
    py = (by + mv[..., 1]).clamp(0, h - MACRO)
    win = _windows(ref, px, py).reshape(f, h // MACRO, w // MACRO, MACRO,
                                        MACRO)
    return win.transpose(2, 3).reshape(f, h, w)


# ---- video ----

@dataclass
class Video:
    """A raw-reference video encode: the stream, and what its decode
    needs, kept on the host: the coefficients as the records carry them
    (int16 [F, N, 16], row-major) and each P-frame's vectors."""

    data: bytes
    coeffs: torch.Tensor
    vectors: dict
    shape: tuple
    gop: int
    quant: list


def encode_video(frames: torch.Tensor, quant, use_rle: bool, gop: int,
                 merange: int, use_huffman: bool = True,
                 dtype=torch.float64, chunk: int = 6) -> Video:
    """u8 [F, H, W] Y planes -> :class:`Video`; each P-frame predicted
    from the raw frame before it.  ``chunk`` frames go through the search
    at a time."""
    f, h, w = frames.shape
    dev = frames.device
    mb = mvec_bits(merange)
    p_frames = [i for i in range(f) if i % gop]
    vectors = {}
    samples = frames.to(torch.int16)
    for at in range(0, len(p_frames), chunk):
        idx = torch.tensor(p_frames[at:at + chunk], device=dev)
        mv = search(frames[idx], frames[idx - 1], merange)
        pred = predict(frames[idx - 1], mv)
        samples[idx] = frames[idx].to(torch.int16) - pred.to(torch.int16)
        for j, i in enumerate(p_frames[at:at + chunk]):
            vectors[i] = mv[j]
    parts_v, parts_b, carried = [], [], []
    hv, hb = _fields(header(quant, use_rle, w, h, use_huffman,
                            (f, gop, merange)), dev)
    parts_v.append(hv)
    parts_b.append(hb)
    for i in range(f):
        if i in vectors:
            parts_v.append(vectors[i].reshape(-1).to(torch.int64))
            parts_b.append(torch.full((vectors[i].numel(),), mb,
                                      dtype=torch.int64, device=dev))
        vals, nbits, kept = records(quantize(blocks(samples[i]), quant,
                                             dtype), use_rle)
        parts_v.append(vals.reshape(-1))
        parts_b.append(nbits.reshape(-1))
        carried.append(kept.to(torch.int16).cpu())
    data = finish(torch.cat(parts_v), torch.cat(parts_b), use_huffman)
    return Video(data, torch.stack(carried),
                 {i: v.cpu() for i, v in vectors.items()}, (f, h, w), gop,
                 quant)


def decode_video(video: Video, device, dtype=torch.float64) -> torch.Tensor:
    """The Y planes u8 [F, H, W] on ``device`` that a decode of
    ``video.data`` gives, with motion compensation: from the coefficients
    and vectors its records carry."""
    f, h, w = video.shape
    out = torch.empty((f, h, w), dtype=torch.uint8, device=device)
    for i in range(f):
        px = inverse(video.coeffs[i].to(device), video.quant, dtype)
        if i % video.gop:
            pred = predict(out[i - 1:i], video.vectors[i].to(device)[None])
            px = blocks(pred[0]).to(dtype) + px
        out[i] = unblocks(to_u8(px), h, w)
    return out
