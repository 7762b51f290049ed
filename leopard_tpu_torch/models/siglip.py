"""SigLIP vision tower of both families (port of leopard_tpu/models/siglip.py):
LLaVA's 364-px tiles and Idefics2's NaViT images of up to 980 px.

Pre-LN layers with qkv bias, GELU-tanh MLP and a post-LN over the sequence;
the patchify conv is an unfold-matmul. Attention on a CUDA tensor goes
through the flash kernel, which masks the ragged tail itself (676 or 4,900
patches), so the sequence is not padded to a block multiple as on the TPU.
In training the kernel's backward (K2) runs at head dim 72, and `remat`
("full", "attn", "selective"; ops/remat.py) recomputes each layer in the
backward.

NaViT (`patch_mask`): an image's real patches are the top-left rectangle of
the batch's patch grid, flattened row-major, so inside each row of the
sequence real and padding patches interleave. They get bucketized 2-D
position ids into the full patches_per_side² table, and the mask becomes
0/1 segment ids. The kernel takes the full segment mask, under which a
padding patch attends nothing: it comes out 0 from the kernel and a uniform
average from the dense path (the TPU path lets it attend the real patches).
Either is finite, and no caller reads it: the perceiver masks those rows.

Under tensor parallelism (`self.par`, parallel/mesh.py::Parallel) each rank
holds a block of heads and of the MLP's width: q/k/v and fc1 are
column-parallel, wo and fc2 row-parallel (parallel/tensor_parallel.py).

Not in the port: the CLIP tower's options (class token, pre-LN, bias-free
patchify, quick-GELU, un-normed sequence output), which the constructor
rejects.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from leopard_tpu_torch.config import VisionConfig
from leopard_tpu_torch.models.params import Params, new_param, torch_dtype
from leopard_tpu_torch.ops.attention import attention
from leopard_tpu_torch.ops.flash_attention import TileRanges, flash_attention, tile_ranges
from leopard_tpu_torch.ops.norms import layer_norm
from leopard_tpu_torch.ops.remat import remat_wrap, tag_attn_out
from leopard_tpu_torch.parallel.tensor_parallel import copy_to_tp, row_linear


def navit_position_ids(patch_mask: torch.Tensor, patches_per_side: int) -> torch.Tensor:
    """[B, nph, npw] bool (True = real patch) → [B, nph·npw] int64 ids into
    the patches_per_side² table (JAX siglip.py:93-117): row i of an image
    with n_h real rows takes bucket searchsorted(j/n for j in 1..n-1, i/n_h,
    side="right"), in fp32 as there, and columns alike; padding takes 0."""
    b, nph, npw = patch_mask.shape
    n = patches_per_side
    dev = patch_mask.device
    boundaries = torch.arange(1, n, dtype=torch.float32, device=dev) / n

    def buckets(count, length):
        pos = torch.arange(length, dtype=torch.float32, device=dev)[None, :]
        frac = pos / count.clamp(min=1).to(torch.float32)[:, None]
        return torch.bucketize(frac, boundaries, right=True)

    bucket_h = buckets(patch_mask[:, :, 0].sum(1), nph)
    bucket_w = buckets(patch_mask[:, 0, :].sum(1), npw)
    ids = bucket_h[:, :, None] * n + bucket_w[:, None, :]
    return torch.where(patch_mask, ids, 0).reshape(b, nph * npw)


def patchify(pixel_values: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, C, H, W] → [B, (H/p)·(W/p), C·p·p], feature index (c·p + kh)·p + kw,
    the flattening of a Conv2d(kernel=p, stride=p) weight [out, in, kh, kw]."""
    b, c, hh, ww = pixel_values.shape
    p = patch_size
    x = pixel_values.reshape(b, c, hh // p, p, ww // p, p)
    x = x.permute(0, 2, 4, 1, 3, 5)  # [B, H/p, W/p, C, p, p]
    return x.reshape(b, (hh // p) * (ww // p), c * p * p)


class SiglipLayer(nn.Module):
    par = None  # parallel/mesh.py::Parallel, set by set_parallel

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

    def forward(self, x: torch.Tensor, cfg: VisionConfig, impl: str,
                seg: Optional[torch.Tensor], ranges: Optional[TileRanges]) -> torch.Tensor:
        b, s, _ = x.shape
        a = self.attn
        par = self.par
        y = copy_to_tp(layer_norm(x, self.ln1.scale, self.ln1.bias, cfg.layer_norm_eps), par)
        heads = (b, s, -1, cfg.head_dim)  # this rank's heads
        q = F.linear(y, a.wq, a.bq).reshape(heads)
        k = F.linear(y, a.wk, a.bk).reshape(heads)
        v = F.linear(y, a.wv, a.bv).reshape(heads)
        if impl == "flash":
            o = flash_attention(q, k, v, causal=False, q_segment_ids=seg,
                                kv_segment_ids=seg, ranges=ranges)
        else:  # saved under "attn"/"selective", as K1's output is
            o = tag_attn_out(attention(q, k, v, q_segment_ids=seg, kv_segment_ids=seg))
        x = x + row_linear(o.reshape(b, s, -1), a.wo, a.bo, par)
        y = copy_to_tp(layer_norm(x, self.ln2.scale, self.ln2.bias, cfg.layer_norm_eps), par)
        y = F.gelu(F.linear(y, self.mlp.fc1, self.mlp.b1), approximate="tanh")
        return x + row_linear(y, self.mlp.fc2, self.mlp.b2, par)


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

    def forward(self, pixel_values: torch.Tensor, patch_mask: Optional[torch.Tensor] = None,
                remat=False) -> torch.Tensor:
        """pixel_values [B, 3, H, W] → [B, (H/p)·(W/p), hidden] post-LN
        features. `patch_mask` [B, H/p, W/p] bool: NaViT position ids and
        attention among real patches only. `remat`: "none" | "full" | "attn"
        | "selective" per layer (ops/remat.py)."""
        cfg = self.cfg
        x = patchify(pixel_values.to(self.pos_embed.dtype), cfg.patch_size)
        x = F.linear(x, self.patch_embed.kernel, self.patch_embed.bias)
        seg = None
        if patch_mask is None:
            x = x + self.pos_embed[: x.shape[1]]
        else:
            patch_mask = patch_mask.to(device=x.device, dtype=torch.bool)
            x = x + self.pos_embed[navit_position_ids(patch_mask, cfg.patches_per_side)]
            seg = patch_mask.reshape(x.shape[0], -1).to(torch.int32)

        impl = cfg.attn_impl
        if impl == "auto":
            impl = "flash" if x.is_cuda else "dense"
        if impl not in ("flash", "dense"):
            raise NotImplementedError(f"vision attn_impl={impl!r} is not in the port")
        ranges = None
        if impl == "flash":  # one set of tile ranges for every layer's K1 and K2
            s = x.shape[1]
            ranges = tile_ranges(seg, seg, sq=s, skv=s, causal=False, device=x.device)
        n_layers = cfg.num_layers
        if cfg.feature_layer != -1:  # stop early (LLaVA feature select, e.g. -2)
            n_layers = cfg.num_layers + 1 + cfg.feature_layer
        for layer in self.layers[:n_layers]:
            x = remat_wrap(layer, remat)(x, cfg, impl, seg, ranges)
        return layer_norm(x, self.post_ln.scale, self.post_ln.bias, cfg.layer_norm_eps)
