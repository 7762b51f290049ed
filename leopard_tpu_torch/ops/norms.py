"""Normalization layers (port of leopard_tpu/ops/norms.py).

All statistics are computed in float32 regardless of input dtype; the result
is cast back to the input dtype.

`rms_norm` and `layer_norm` are what the models call. On a CUDA tensor they
launch the fused Triton kernels of `ops/fused_norms.py` (K3a/K3b) or raise;
on a CPU tensor they compute the plain versions below, `rms_norm_ref` and
`layer_norm_ref`, which are also the kernels' backward (recomputed, as the
JAX package's fused norms recompute through its plain norms).
"""

from __future__ import annotations

import torch


def rms_norm_ref(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def layer_norm_ref(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * weight.float() + bias.float()).to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    from leopard_tpu_torch.ops.fused_norms import fused_rms_norm

    return fused_rms_norm(x, weight, eps)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    from leopard_tpu_torch.ops.fused_norms import fused_layer_norm

    return fused_layer_norm(x, weight, bias, eps)
