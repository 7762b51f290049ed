"""SigLIP vision tower, LLaVA path (port of leopard_tpu/models/siglip.py).

Pre-LN layers with qkv bias, GELU-tanh MLP and a post-LN over the sequence;
the patchify conv is an unfold-matmul. Attention on a CUDA tensor goes
through the flash kernel, which masks the ragged 676-patch tail itself, so
the sequence is not padded to a block multiple as on the TPU. In training
the kernel's backward (K2) runs at head dim 72, and `remat="full"`
recomputes each layer in the backward.

Not in this slice: NaViT patch masks and position ids (the Idefics2 slice)
and the CLIP tower's options (class token, pre-LN, bias-free patchify,
quick-GELU, un-normed sequence output), which the constructor rejects.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from leopard_tpu_torch.config import VisionConfig
from leopard_tpu_torch.models.params import Params, new_param, torch_dtype
from leopard_tpu_torch.ops.attention import attention
from leopard_tpu_torch.ops.flash_attention import flash_attention
from leopard_tpu_torch.ops.norms import layer_norm
from leopard_tpu_torch.ops.remat import remat_wrap


def patchify(pixel_values: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, C, H, W] → [B, (H/p)·(W/p), C·p·p], feature index (c·p + kh)·p + kw,
    the flattening of a Conv2d(kernel=p, stride=p) weight [out, in, kh, kw]."""
    b, c, hh, ww = pixel_values.shape
    p = patch_size
    x = pixel_values.reshape(b, c, hh // p, p, ww // p, p)
    x = x.permute(0, 2, 4, 1, 3, 5)  # [B, H/p, W/p, C, p, p]
    return x.reshape(b, (hh // p) * (ww // p), c * p * p)


class SiglipLayer(nn.Module):
    def __init__(self, cfg: VisionConfig, *, dtype: torch.dtype, device=None):
        super().__init__()
        h, f = cfg.hidden_size, cfg.intermediate_size
        kw = dict(dtype=dtype, device=device)
        self.ln1 = Params({"scale": (h,), "bias": (h,)}, **kw)
        self.attn = Params({
            "wq": (h, h), "bq": (h,), "wk": (h, h), "bk": (h,),
            "wv": (h, h), "bv": (h,), "wo": (h, h), "bo": (h,),
        }, **kw)
        self.ln2 = Params({"scale": (h,), "bias": (h,)}, **kw)
        self.mlp = Params({"fc1": (f, h), "b1": (f,), "fc2": (h, f), "b2": (h,)}, **kw)

    def forward(self, x: torch.Tensor, cfg: VisionConfig, impl: str) -> torch.Tensor:
        b, s, _ = x.shape
        a = self.attn
        y = layer_norm(x, self.ln1.scale, self.ln1.bias, cfg.layer_norm_eps)
        heads = (b, s, cfg.num_heads, cfg.head_dim)
        q = F.linear(y, a.wq, a.bq).reshape(heads)
        k = F.linear(y, a.wk, a.bk).reshape(heads)
        v = F.linear(y, a.wv, a.bv).reshape(heads)
        if impl == "flash":
            o = flash_attention(q, k, v, causal=False)
        else:
            o = attention(q, k, v)
        x = x + F.linear(o.reshape(b, s, -1), a.wo, a.bo)
        y = layer_norm(x, self.ln2.scale, self.ln2.bias, cfg.layer_norm_eps)
        y = F.gelu(F.linear(y, self.mlp.fc1, self.mlp.b1), approximate="tanh")
        return x + F.linear(y, self.mlp.fc2, self.mlp.b2)


class SiglipVisionTower(nn.Module):
    def __init__(self, cfg: VisionConfig, device=None):
        super().__init__()
        if (cfg.use_class_token or cfg.pre_ln or not cfg.patch_bias
                or cfg.hidden_act != "gelu_pytorch_tanh" or not cfg.post_ln_sequence):
            raise NotImplementedError("the CLIP tower's options are not in the port yet")
        self.cfg = cfg
        dt = torch_dtype(cfg.dtype)
        h, p = cfg.hidden_size, cfg.patch_size
        self.patch_embed = Params({"kernel": (h, p * p * cfg.num_channels), "bias": (h,)},
                                  dtype=dt, device=device)
        self.pos_embed = new_param((cfg.patches_per_side**2, h), dt, device)
        self.layers = nn.ModuleList(
            SiglipLayer(cfg, dtype=dt, device=device) for _ in range(cfg.num_layers)
        )
        self.post_ln = Params({"scale": (h,), "bias": (h,)}, dtype=dt, device=device)

    def forward(self, pixel_values: torch.Tensor, remat=False) -> torch.Tensor:
        """pixel_values [B, 3, H, W] → [B, num_patches, hidden] post-LN
        features. `remat`: "none" | "full" per layer (ops/remat.py)."""
        cfg = self.cfg
        x = patchify(pixel_values.to(self.pos_embed.dtype), cfg.patch_size)
        x = F.linear(x, self.patch_embed.kernel, self.patch_embed.bias)
        x = x + self.pos_embed[: x.shape[1]]

        impl = cfg.attn_impl
        if impl == "auto":
            impl = "flash" if x.is_cuda else "dense"
        if impl not in ("flash", "dense"):
            raise NotImplementedError(f"vision attn_impl={impl!r} is not in the port")
        n_layers = cfg.num_layers
        if cfg.feature_layer != -1:  # stop early (LLaVA feature select, e.g. -2)
            n_layers = cfg.num_layers + 1 + cfg.feature_layer
        for layer in self.layers[:n_layers]:
            x = remat_wrap(layer, remat)(x, cfg, impl)
        return layer_norm(x, self.post_ln.scale, self.post_ln.bias, cfg.layer_norm_eps)
