"""Weight-only int8 / int4 quantization for serving (port of
leopard_tpu/ops/quant.py).

Decode reads every weight once per step, so storing the matmul weights in
fewer bits cuts the bytes read per token: int8 halves them, int4 halves them
again.

  - int8 is symmetric per output channel: w ≈ q · s, s = max|w_col| / 127,
    and x @ (q·s) == (x @ q) · s.
  - int4 is symmetric per (128-row input group, output channel), q ∈ [-7, 7]
    stored offset-binary (q + 8) in packed nibbles, "split-half": byte row i
    holds logical row i in its low nibble and row i + K/2 in its high one.

Quantized leaves keep the JAX package's layout and bytes, reduction dim K
first (`q` [K, N], `q4` [K/2, N]), so a tree quantized by the JAX package
loads without repacking. The port's own bf16 weights are [out, in] = [N, K],
so `quantize_int8` / `quantize_int4` transpose before packing.

`matmul` keeps the JAX dispatch one for one, with "on TPU" read as "on
CUDA": int4 at M ≤ 64 with group 128 on a CUDA tensor goes through K4
(ops/int4_matmul.py); every other int4 call unpacks the weight densely. The
dense path scales in fp32 and casts once to x's dtype, where the JAX package
scales in x's dtype (ADVICE r5: bf16 group scales lose precision).
"""

from __future__ import annotations

from typing import Dict, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from leopard_tpu_torch.models.params import QuantizedWeight
from leopard_tpu_torch.ops.int4_matmul import KERNEL_GROUP, int4_matmul

QUANT_KEYS = (
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "fc1", "fc2", "lm_head",
)
INT4_GROUP = 128
Weight = Union[torch.Tensor, QuantizedWeight]


def quantize_int8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., N, K] (port layout) → {"q": int8 [..., K, N], "s": f32 [..., 1, N]}."""
    wf = w.transpose(-1, -2).float()
    scale = (wf.abs().amax(dim=-2, keepdim=True) / 127.0).clamp(min=1e-8)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q.contiguous(), "s": scale.contiguous()}


def quantize_int4(w: torch.Tensor, group: int = INT4_GROUP) -> Dict[str, torch.Tensor]:
    """[..., N, K] (port layout) → {"q4": uint8 [..., K/2, N] split-half
    packed, "s": f32 [..., K/group, N]}. Needs K % (2·group) == 0."""
    wt = w.transpose(-1, -2)
    *lead, k, n = wt.shape
    if k % (2 * group):
        raise ValueError(f"K={k} is not a multiple of 2 x group {group}")
    wf = wt.float().reshape(*lead, k // group, group, n)
    s = (wf.abs().amax(dim=-2, keepdim=True) / 7.0).clamp(min=1e-8)
    q = (torch.clamp(torch.round(wf / s), -7, 7) + 8.0).to(torch.uint8).reshape(*lead, k, n)
    lo, hi = q[..., : k // 2, :], q[..., k // 2:, :]
    return {"q4": (lo | (hi << 4)).contiguous(),
            "s": s.reshape(*lead, k // group, n).contiguous()}


def _unpack_int4(q4: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Packed int4 → f32 [..., K, N] dequantized weights, (q − 8) · s in fp32.
    It materializes the whole weight: the CPU, prefill and plain path."""
    *lead, kh, n = q4.shape
    k = 2 * kh
    group = k // s.shape[-2]
    q = torch.cat([q4 & 15, q4 >> 4], dim=-2).to(torch.int8) - 8   # [..., K, N]
    wf = q.reshape(*lead, k // group, group, n).float() * s[..., :, None, :]
    return wf.reshape(*lead, k, n)


def is_quantized(w) -> bool:
    return isinstance(w, QuantizedWeight)


def use_int4_kernel(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor) -> bool:
    """The K4 tier (JAX quant.py:94-102): a CUDA tensor, M = prod(lead) ≤ 64,
    x of rank ≤ 3, an unstacked weight and group 128."""
    m = x.numel() // x.shape[-1]
    return (
        x.is_cuda and m <= 64 and x.dim() <= 3 and q4.dim() == 2
        and 2 * q4.shape[0] // s.shape[0] == KERNEL_GROUP
    )


def matmul(x: torch.Tensor, w: Weight) -> torch.Tensor:
    """x @ w for a plain weight ([out, in], as F.linear takes it) or a
    quantized one. Returns x's dtype."""
    if isinstance(w, torch.Tensor):
        return F.linear(x, w)
    if w.int4:
        q4, s = w.q4, w.s
        if use_int4_kernel(x, q4, s):
            # [..., K] in, [..., N] out, in x's dtype: one launch a call
            return int4_matmul(x, q4, s, out_dtype=x.dtype)
        # dense-dequant path: the CPU, prefill (M > 64) and non-128 groups
        return x @ _unpack_int4(q4, s).to(x.dtype)
    y = x @ w.q.to(x.dtype)
    return y * w.s.to(x.dtype)[..., 0, :]


def _quantize_leaf(w: torch.Tensor, mode: str) -> Dict[str, torch.Tensor]:
    if mode == "int8":
        return quantize_int8(w)
    # shrink the group until it divides the packed reduction dim; odd widths
    # fall back to int8. K4 takes only group 128; smaller groups take the
    # dense path
    g = INT4_GROUP
    while g >= 16 and w.shape[-1] % (2 * g):
        g //= 2
    return quantize_int4(w, group=g) if g >= 16 else quantize_int8(w)


@torch.no_grad()
def quantize_tree(module: nn.Module, keys: Sequence[str] = QUANT_KEYS,
                  mode: str = "int8") -> nn.Module:
    """Replace, in place, every weight of two or more dims whose leaf name is
    in `keys` by a QuantizedWeight. Returns the module. On a meta module it
    builds the quantized structure only (shapes, no data)."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"unknown quantize mode {mode!r}")
    keyset = set(keys)
    for sub in list(module.modules()):
        for name, p in list(sub.named_parameters(recurse=False)):
            if name in keyset and p.dim() >= 2:
                delattr(sub, name)
                sub.add_module(name, QuantizedWeight(_quantize_leaf(p.detach(), mode)))
    return module


@torch.no_grad()
def dequantize_tree(module: nn.Module, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Replace, in place, every QuantizedWeight by a plain weight of `dtype`
    in the port's layout [N, K], computed in fp32 and rounded once. Returns
    the module."""
    for sub in list(module.modules()):
        for name, w in list(sub.named_children()):
            if is_quantized(w):
                wf = _unpack_int4(w.q4, w.s) if w.int4 else w.q.float() * w.s
                delattr(sub, name)
                sub.register_parameter(name, nn.Parameter(
                    wf.to(dtype).transpose(-1, -2).contiguous(), requires_grad=False))
    return module
