"""Device resolution and the identity of the card a result was taken on."""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device) -> torch.device:
    """The explicit device of a public entry point.

    A CUDA device must exist: asking for one on a machine without a card
    raises instead of running on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def gpu_identity() -> str:
    """Name and power limit of the card(s), one line each, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip()
