"""Idefics2 connector: a SwiGLU modality projection, then the perceiver
resampler (port of leopard_tpu/models/perceiver.py; its numerics are HF's
Idefics2Connector's):

  - modality projection: vision hidden → text intermediate → text hidden,
    silu(x·W_gate) * (x·W_up) · W_down;
  - `num_layers` resampler layers: RMSNorm of the latents and of the
    context, GQA cross-attention of the latents over [context; latents],
    residual, RMSNorm, a SwiGLU MLP of width 4·hidden, residual; a final
    RMSNorm;
  - padded context rows (`context_seg` 0) are never attended; the latents
    always attend each other.

The attention is the dense `ops/attention.attention` with a mask, as in the
JAX package (no Pallas kernel there; head dim 96 is not one of K1's). A
masked context row still enters the product with weight exactly 0, so it
must be finite: 0·NaN is NaN. The norms go through `ops/norms.rms_norm`
(K3a on the card).

Under tensor parallelism (`self.par`, parallel/mesh.py::Parallel) the rules
give each rank its block of the resampler's heads (wq, wk, wv by columns,
wo by rows) and of its MLP's width (w_gate, w_up by columns, w_down by
rows), as models/siglip.py's layers; the modality projection and the
latents stay whole. The local head counts come from the weights' shapes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from leopard_tpu_torch.config import PerceiverConfig
from leopard_tpu_torch.models.params import Params, new_param, torch_dtype
from leopard_tpu_torch.ops.attention import attention
from leopard_tpu_torch.ops.norms import rms_norm
from leopard_tpu_torch.parallel.tensor_parallel import copy_to_tp, row_linear


def _swiglu(x: torch.Tensor, p: Params, par=None) -> torch.Tensor:
    x = copy_to_tp(x, par)
    return row_linear(F.silu(F.linear(x, p.w_gate)) * F.linear(x, p.w_up), p.w_down, None, par)


class PerceiverLayer(nn.Module):
    par = None  # parallel/mesh.py::Parallel, set by set_parallel

    def __init__(self, cfg: PerceiverConfig, *, dtype: torch.dtype, device=None):
        super().__init__()
        h = cfg.hidden_size
        qd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        kw = dict(dtype=dtype, device=device)
        self.latents_norm = new_param((h,), dtype, device)
        self.context_norm = new_param((h,), dtype, device)
        self.attn = Params({"wq": (qd, h), "wk": (kvd, h), "wv": (kvd, h), "wo": (h, qd)}, **kw)
        self.post_attn_norm = new_param((h,), dtype, device)
        self.mlp = Params({"w_gate": (4 * h, h), "w_up": (4 * h, h), "w_down": (h, 4 * h)}, **kw)

    def forward(self, lat: torch.Tensor, context: torch.Tensor, mask: torch.Tensor,
                cfg: PerceiverConfig) -> torch.Tensor:
        b, n, _ = lat.shape
        s = context.shape[1]
        a = self.attn
        lat_n = rms_norm(lat, self.latents_norm, cfg.rms_norm_eps)
        ctx_n = rms_norm(context, self.context_norm, cfg.rms_norm_eps)
        kv_in = torch.cat([ctx_n, lat_n], dim=1)  # [B, S + n, H]
        par = self.par
        q = F.linear(copy_to_tp(lat_n, par), a.wq).reshape(b, n, -1, cfg.head_dim)
        kv_in = copy_to_tp(kv_in, par)
        k = F.linear(kv_in, a.wk).reshape(b, s + n, -1, cfg.head_dim)
        v = F.linear(kv_in, a.wv).reshape(b, s + n, -1, cfg.head_dim)
        o = attention(q, k, v, mask=mask)
        lat = lat + row_linear(o.reshape(b, n, -1), a.wo, None, par)
        y = rms_norm(lat, self.post_attn_norm, cfg.rms_norm_eps)
        return lat + _swiglu(y, self.mlp, par)


class Perceiver(nn.Module):
    """The Idefics2 connector, parameters named as the JAX tree's
    `perceiver` subtree."""

    def __init__(self, cfg: PerceiverConfig, vision_hidden: int = 1152, device=None):
        super().__init__()
        self.cfg = cfg
        dt = torch_dtype(cfg.dtype)
        h, f = cfg.hidden_size, cfg.intermediate_size
        self.modality_proj = Params(
            {"w_gate": (f, vision_hidden), "w_up": (f, vision_hidden), "w_down": (h, f)},
            dtype=dt, device=device)
        self.latents = new_param((cfg.num_latents, h), dt, device)
        self.layers = nn.ModuleList(
            PerceiverLayer(cfg, dtype=dt, device=device) for _ in range(cfg.num_layers))
        self.final_norm = new_param((h,), dt, device)

    def forward(self, vision_features: torch.Tensor,
                context_seg: Optional[torch.Tensor] = None) -> torch.Tensor:
        """vision_features [B, S, vision_hidden], context_seg [B, S] (0 = a
        padded patch) → [B, num_latents, hidden]."""
        cfg = self.cfg
        context = _swiglu(vision_features.to(self.latents.dtype), self.modality_proj)
        b, s, h = context.shape
        n = cfg.num_latents
        lat = self.latents[None].expand(b, n, h)
        kv_valid = torch.ones((b, s + n), dtype=torch.bool, device=context.device)
        if context_seg is not None:
            kv_valid[:, :s] = context_seg != 0
        mask = kv_valid[:, None, None, :]  # every latent attends every valid row
        for layer in self.layers:
            lat = layer(lat, context, mask, cfg)
        return rms_norm(lat, self.final_norm, cfg.rms_norm_eps)
