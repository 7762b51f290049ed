"""Rotary position embeddings with Llama-3.1 frequency scaling (port of
leopard_tpu/ops/rotary.py).

The inverse-frequency table is numpy, as in the JAX package, so both build
bit-identical tables. The rotation uses the HF "half-rotation"
(non-interleaved) layout.
"""

from __future__ import annotations

import numpy as np
import torch

from leopard_tpu_torch.config import TextConfig


def llama31_scale_inv_freq(
    inv_freq: np.ndarray,
    factor: float = 8.0,
    low_freq_factor: float = 1.0,
    high_freq_factor: float = 4.0,
    original_max_position: int = 8192,
) -> np.ndarray:
    """Piecewise NTK-by-parts scaling used by Llama-3.1."""
    low_freq_wavelen = original_max_position / low_freq_factor
    high_freq_wavelen = original_max_position / high_freq_factor
    wavelen = 2.0 * np.pi / inv_freq
    scaled = np.where(wavelen > low_freq_wavelen, inv_freq / factor, inv_freq)
    smooth = (original_max_position / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor
    )
    smoothed = (1.0 - smooth) * scaled / factor + smooth * scaled
    is_medium = (wavelen <= low_freq_wavelen) & (wavelen >= high_freq_wavelen)
    return np.where(is_medium, smoothed, scaled).astype(np.float32)


def compute_inv_freq(cfg: TextConfig) -> np.ndarray:
    dim = cfg.head_dim
    inv_freq = 1.0 / (
        cfg.rope_theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim)
    )
    if cfg.rope_scaling == "llama3.1":
        inv_freq = llama31_scale_inv_freq(
            inv_freq,
            factor=cfg.rope_scaling_factor,
            low_freq_factor=cfg.rope_low_freq_factor,
            high_freq_factor=cfg.rope_high_freq_factor,
            original_max_position=cfg.rope_original_max_position,
        )
    elif cfg.rope_scaling == "linear":
        inv_freq = inv_freq / cfg.rope_scaling_factor
    return inv_freq.astype(np.float32)


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor):
    """positions [..., S] int → cos, sin [..., S, head_dim] float32, the
    half-dim angle table concatenated with itself (HF layout).

    The angles are fp32 products, as the JAX package forms them; cos and sin
    are taken in float64 and rounded once, so the tables are the correctly
    rounded values of those angles whatever the host's fp32 range reduction
    does at |angle| up to ~10^5."""
    angles = positions[..., None].float() * inv_freq  # [..., S, D/2]
    angles = torch.cat([angles, angles], dim=-1).double()
    return torch.cos(angles).float(), torch.sin(angles).float()


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D]; cos/sin [B, S, D]. Computed in fp32, cast back to
    x.dtype."""
    cos = cos[..., None, :]  # [B, S, 1, D]
    sin = sin[..., None, :]
    xf = x.float()
    return (xf * cos + rotate_half(xf) * sin).to(x.dtype)
