"""SigLIP vision tower of both families (port of leopard_tpu/models/siglip.py):
LLaVA's 364-px tiles and Idefics2's NaViT images of up to 980 px; and the
CLIP tower (clip-vit-large-patch14-336, `config.clip_vit_large_336`).

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

The CLIP options (JAX siglip.py:127-245), each a `VisionConfig` field:
  - `use_class_token`: a learned `class_embed` plus position row 0 is
    prepended to the patches, whose position ids start at 1 (under a
    `patch_mask` too: the NaViT ids plus one), and under a patch mask the
    class token takes segment 1; with `drop_class_token` its row is cut off
    after the last run layer. The sequence is then one longer than the
    patch grid (577 at 336 px), an odd length that K1 and K2 mask at the
    tail;
  - `pre_ln`: a LayerNorm (K3b on the card) before the first layer;
  - `patch_bias=False`: the patch embedding has no bias;
  - `hidden_act="quick_gelu"`: y·sigmoid(1.702·y) in the MLP;
  - `post_ln_sequence=False`: the sequence output is not normed (`post_ln`
    is still a parameter, as in the JAX tree and HF's CLIP, and unused).
`feature_layer` -2 runs all but the last layer: that layer's parameters get
no gradient, and the trainer's AdamW still decays them (zero gradients), as
the JAX trainer does.
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
        y = F.linear(y, self.mlp.fc1, self.mlp.b1)
        if cfg.hidden_act == "quick_gelu":
            y = y * torch.sigmoid(1.702 * y)
        else:
            y = F.gelu(y, approximate="tanh")
        return x + row_linear(y, self.mlp.fc2, self.mlp.b2, par)


class SiglipVisionTower(nn.Module):
    def __init__(self, cfg: VisionConfig, device=None):
        super().__init__()
        if cfg.hidden_act not in ("gelu_pytorch_tanh", "quick_gelu"):
            raise ValueError(f"vision hidden_act={cfg.hidden_act!r}: gelu_pytorch_tanh "
                             "or quick_gelu")
        self.cfg = cfg
        dt = torch_dtype(cfg.dtype)
        h, p = cfg.hidden_size, cfg.patch_size
        patch = {"kernel": (h, p * p * cfg.num_channels)}
        if cfg.patch_bias:
            patch["bias"] = (h,)
        self.patch_embed = Params(patch, dtype=dt, device=device)
        n_pos = cfg.patches_per_side**2 + (1 if cfg.use_class_token else 0)
        self.pos_embed = new_param((n_pos, h), dt, device)
        if cfg.use_class_token:
            self.class_embed = new_param((h,), dt, device)
        if cfg.pre_ln:
            self.pre_ln = Params({"scale": (h,), "bias": (h,)}, dtype=dt, device=device)
        self.layers = nn.ModuleList(
            SiglipLayer(cfg, dtype=dt, device=device) for _ in range(cfg.num_layers)
        )
        self.post_ln = Params({"scale": (h,), "bias": (h,)}, dtype=dt, device=device)

    def forward(self, pixel_values: torch.Tensor, patch_mask: Optional[torch.Tensor] = None,
                remat=False) -> torch.Tensor:
        """pixel_values [B, 3, H, W] → [B, (H/p)·(W/p), hidden] features
        (post-LN unless `post_ln_sequence` is off; the class token's row
        first unless dropped). `patch_mask` [B, H/p, W/p] bool: NaViT
        position ids and attention among real patches only. `remat`: "none"
        | "full" | "attn" | "selective" per layer (ops/remat.py)."""
        cfg = self.cfg
        x = patchify(pixel_values.to(self.pos_embed.dtype), cfg.patch_size)
        x = F.linear(x, self.patch_embed.kernel, getattr(self.patch_embed, "bias", None))
        b, n, h = x.shape
        first = 1 if cfg.use_class_token else 0  # position row 0 is the class token's
        seg = None
        if patch_mask is None:
            x = x + self.pos_embed[first:first + n]
        else:
            patch_mask = patch_mask.to(device=x.device, dtype=torch.bool)
            x = x + self.pos_embed[navit_position_ids(patch_mask, cfg.patches_per_side) + first]
            seg = patch_mask.reshape(b, -1).to(torch.int32)
        if cfg.use_class_token:
            cls = (self.class_embed + self.pos_embed[0]).to(x.dtype).expand(b, 1, h)
            x = torch.cat([cls, x], dim=1)
            if seg is not None:
                seg = torch.cat([seg.new_ones((b, 1)), seg], dim=1)
        if cfg.pre_ln:
            x = layer_norm(x, self.pre_ln.scale, self.pre_ln.bias, cfg.layer_norm_eps)

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
        if cfg.post_ln_sequence:
            x = layer_norm(x, self.post_ln.scale, self.post_ln.bias, cfg.layer_norm_eps)
        if cfg.use_class_token and cfg.drop_class_token:
            x = x[:, 1:]
        return x
