"""Pixel-shuffle visual-token compression, 2×2 space-to-depth (port of
leopard_tpu/ops/pixel_shuffle.py).

The view/permute order is the JAX package's exactly (:22-32): checkpoint
parity depends on which neighbour lands in which feature slice.
"""

from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, scale_factor: int = 2) -> torch.Tensor:
    """x [B, S, D] with S a perfect square → [B, S/r², D·r²]."""
    b, s, d = x.shape
    side = int(round(s**0.5))
    if side * side != s:
        raise ValueError(f"seq {s} is not a perfect square")
    r = scale_factor
    # [B, H, W/r, D·r]: merge r consecutive W positions into features
    x = x.reshape(b, side, side // r, d * r)
    # → [B, W/r, H, D·r], then merge r consecutive H positions
    x = x.permute(0, 2, 1, 3).reshape(b, side // r, side // r, d * r * r)
    # permute back → [B, H/r, W/r, D·r²]
    x = x.permute(0, 2, 1, 3)
    return x.reshape(b, s // (r * r), d * r * r)
