"""The cells' inputs, made on the device from the seed in a few large
calls: the same seed gives the same pixels on the same device type.

Images follow the serving model of the codec's smoke test: in every run
of 16, 15 smooth fields plus Gaussian noise (sigma 6) and one image of
uniform noise; each smooth field has its own phases.  Videos follow the
JAX package's video timing (bench.py:225-251): 8x8 random blocks moving
(2, 3) pixels a frame, plus Gaussian noise of sigma 3, truncated to u8.
"""

from __future__ import annotations

import math

import torch


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one of the run's input streams."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + stream) % 2 ** 63)
    return g


def image_pool(n: int, h: int, w: int, seed: int, device,
               noise_every: int = 16) -> torch.Tensor:
    """u8 [n, h, w]: image i is uniform noise where i % noise_every is
    noise_every - 1, else a smooth field plus noise."""
    g = generator(seed, device, 1)
    phase = torch.rand((n, 3, 1, 1), generator=g, device=device) * (
        2 * math.pi)
    y = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    x = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    field = (128.0 + 60.0 * torch.sin(x / 37.0 + phase[:, 0])
             * torch.cos(y / 23.0 + phase[:, 1])
             + 30.0 * torch.sin((x + y) / 91.0 + phase[:, 2]))
    field += 6.0 * torch.randn((n, h, w), generator=g, device=device)
    out = field.round_().clamp_(0, 255).to(torch.uint8)
    noisy = torch.arange(n, device=device) % noise_every == noise_every - 1
    out[noisy] = torch.randint(0, 256, (int(noisy.sum()), h, w),
                               generator=g, device=device,
                               dtype=torch.uint8)
    return out


def video_clips(n: int, frames: int, h: int, w: int, seed: int,
                device) -> torch.Tensor:
    """u8 [n, frames, h, w] Y planes."""
    g = generator(seed, device, 2)
    base = torch.randint(0, 256, (n, h // 8, w // 8), generator=g,
                         device=device).to(torch.float32)
    base = base.repeat_interleave(8, 1).repeat_interleave(8, 2)
    out = torch.empty((n, frames, h, w), dtype=torch.uint8, device=device)
    for t in range(frames):
        moved = torch.roll(base, (2 * t, 3 * t), (1, 2))
        noise = 3.0 * torch.randn((n, h, w), generator=g, device=device)
        out[:, t] = (moved + noise).clamp_(0, 255).to(torch.uint8)
    return out
