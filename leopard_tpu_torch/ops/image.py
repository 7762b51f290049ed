"""Image preprocessing on tensors: resize, normalize, crop (port of
leopard_tpu/ops/image.py).

Images are [N, 3, H, W] (the JAX layout), on any device; these are plain
PyTorch operations, no kernel of their own.

`resize_images` is `jax.image.resize` with its defaults (antialias on): a
separable resize through a weight matrix per axis, built as
jax/_src/image/scale.py::compute_weight_mat builds it (half-centred pixels;
when downsampling the kernel widened by the scale, a low-pass filter; each
output's weights normalized to sum 1; outputs whose sample falls outside the
input zero), then applied as two matrix products, over H and then W, in the
images' float dtype (float32 images in float64, so that no TF32 setting
lowers their precision). The kernels are JAX's: triangle for "linear", Keys
cubic (a = -0.5) for "cubic", Lanczos of radius 3 and 5; "nearest" takes the
input pixel floor((i + 0.5) · in / out). `F.interpolate` differs (a = -0.75
cubic, no antialiasing, no Lanczos), so it is not used.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

_METHODS = {"nearest": "nearest", "linear": "linear", "bilinear": "linear",
            "trilinear": "linear", "triangle": "linear", "cubic": "cubic",
            "bicubic": "cubic", "tricubic": "cubic", "lanczos3": "lanczos3",
            "lanczos5": "lanczos5"}


def _lanczos(radius: float, x: torch.Tensor) -> torch.Tensor:
    y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
    safe = torch.where(x != 0, math.pi ** 2 * x ** 2, torch.ones_like(x))
    out = torch.where(x > 1e-3, y / safe, torch.ones_like(x))
    return torch.where(x > radius, torch.zeros_like(x), out)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1 - x.abs(), min=0)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic,
            "lanczos3": lambda x: _lanczos(3.0, x), "lanczos5": lambda x: _lanczos(5.0, x)}


def _weight_matrix(in_size: int, out_size: int, method: str,
                   device=None) -> torch.Tensor:
    """[in_size, out_size] float32: output j = Σ_i input i · W[i, j]."""
    kernel = _KERNELS[method]
    scale = 1.0 if out_size == 0 else out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)  # antialias: widen the kernel when downsampling
    f32 = dict(dtype=torch.float32, device=device)
    sample = (torch.arange(out_size, **f32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, **f32)[:, None]).abs() / kernel_scale
    weights = kernel(x)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def _resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    for dim, n in zip((2, 3), size):
        m = x.shape[dim]
        if m == n:
            continue
        offsets = (torch.arange(n, dtype=torch.float32, device=x.device) + 0.5) * m / n
        x = x.index_select(dim, torch.floor(offsets).to(torch.int64))
    return x


def _resize(x: torch.Tensor, size: Tuple[int, int], method: str) -> torch.Tensor:
    if method not in _METHODS:
        raise ValueError(f'Unknown resize method "{method}"')
    method = _METHODS[method]
    if method == "nearest":
        return _resize_nearest(x, size)
    if not x.is_floating_point():
        x = x.float()
    # float32 images are contracted in float64 and rounded once: full
    # precision whatever the TF32 setting (jax.image.resize contracts at
    # Precision.HIGHEST)
    dtype = x.dtype
    work = torch.float64 if dtype == torch.float32 else dtype
    h, w = x.shape[2:]
    y = x.to(work)
    if h != size[0]:
        y = _weight_matrix(h, size[0], method, x.device).to(work).T @ y
    if w != size[1]:
        y = y @ _weight_matrix(w, size[1], method, x.device).to(work)
    return y.to(dtype)


def _to_unit(images: torch.Tensor) -> torch.Tensor:
    return images.float() / 255.0 if images.dtype == torch.uint8 else images


def resize_images(
    images: torch.Tensor,  # [N, 3, H, W] float in [0,1] or uint8
    size: Tuple[int, int],
    method: str = "bicubic",
) -> torch.Tensor:
    """uint8 scaled to [0, 1] in float32, then resized to `size` (H, W)."""
    return _resize(_to_unit(images), tuple(size), method)


def normalize_images(
    images: torch.Tensor,  # [N, 3, H, W] float in [0,1]
    mean,                  # [3]
    std,                   # [3]
) -> torch.Tensor:
    """(images - mean) / std per channel."""
    m, s = (_channel_vector(v, images.device) for v in (mean, std))
    return (images - m[None, :, None, None]) / s[None, :, None, None]


def _channel_vector(v, device) -> torch.Tensor:
    """v as a tensor on `device`; float64 as float32, as JAX holds it."""
    t = torch.as_tensor(v, device=device)
    return t.float() if t.dtype == torch.float64 else t


def center_crop(images: torch.Tensor, crop: Tuple[int, int]) -> torch.Tensor:
    """The central crop[0] × crop[1] window (top and left rounded down)."""
    _, _, h, w = images.shape
    if crop[0] > h or crop[1] > w:
        raise ValueError(f"crop {tuple(crop)} larger than the images' {(h, w)}")
    top = (h - crop[0]) // 2
    left = (w - crop[1]) // 2
    return images[:, :, top:top + crop[0], left:left + crop[1]]


def preprocess_on_device(
    images: torch.Tensor,            # [N, 3, H, W] uint8 or float
    size: Tuple[int, int] = (364, 364),
    mean: Sequence[float] = (0.5, 0.5, 0.5),
    std: Sequence[float] = (0.5, 0.5, 0.5),
    method: str = "bicubic",
) -> torch.Tensor:
    """uint8 tiles → normalized float tiles on the images' device: [0, 1],
    resize, clip to [0, 1], then mean/std (in float32)."""
    x = _resize(_to_unit(images), tuple(size), method)
    x = torch.clamp(x, 0.0, 1.0)
    return normalize_images(x, torch.tensor(mean, dtype=torch.float32),
                            torch.tensor(std, dtype=torch.float32))


def normalize_uint8_nhwc(
    images: torch.Tensor,            # [N, H, W, 3] uint8 (raw PIL layout)
    mean: Sequence[float],
    std: Sequence[float],
) -> torch.Tensor:
    """/255, mean/std normalize and NHWC → NCHW, in float32 on the images'
    device (uint8 crosses the host link: 4× fewer bytes than float32)."""
    m = torch.tensor(mean, dtype=torch.float32, device=images.device)
    s = torch.tensor(std, dtype=torch.float32, device=images.device)
    x = images.float() / 255.0
    x = (x - m) / s
    return x.permute(0, 3, 1, 2)
