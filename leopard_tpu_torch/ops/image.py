"""Device half of the uint8 image preprocessing (port of
leopard_tpu/ops/image.py:71-85)."""

from __future__ import annotations

from typing import Sequence

import torch


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
