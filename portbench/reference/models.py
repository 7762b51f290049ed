"""The plain reference of both configurations' forward passes, in float32.

  - SigLIP (arXiv:2303.15343, HF SiglipVisionModel): a 14 × 14 patch
    convolution with bias, learned position embeddings, pre-LN layers
    (attention with q/k/v/o biases, an MLP with the tanh GELU), a final
    LayerNorm over the sequence. A LLaVA tile's patches take positions
    0 … 675 of the 26 × 26 table; an Idefics2 image of gh × gw real patches
    takes, for patch (i, j), the table row b(i/gh)·side + b(j/gw) with b(f)
    the number of fractions k/side, 1 ≤ k < side, at most f (HF Idefics2's
    bucketized NaViT positions), and attends only its own real patches.
  - Leopard-LLaVA's connector: each 2 × 2 block of a tile's 26 × 26 grid
    becomes one token, its four patches' features side by side in the order
    (0,0), (0,1), (1,0), (1,1); then Linear → exact GELU → Linear.
  - Idefics2's connector (HF Idefics2Connector): a SwiGLU projection of the
    real patches to the text width, then resampler layers in which
    RMS-normed latents attend [normed patches; normed latents] (grouped
    heads, no positions), and a SwiGLU MLP four times as wide; a final
    RMSNorm.
  - Mistral (arXiv:2310.06825): RMSNorm, grouped-query attention with
    rotary positions, causal and at most `sliding_window` positions back
    (the distance below the window), a SwiGLU MLP, a final RMSNorm and the
    untied head. Image features take the image tokens' places in order.
Weights are named as the benchmark draws them (the port's state-dict
names); the configuration comes from the configuration file.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.common import (
    Precision, Weights, attend, checkpointed, layer_norm, rms_norm, rope,
)


def _gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def tower_layer(w: Weights, i: int, x: torch.Tensor, vc: dict, prec: Precision) -> torch.Tensor:
    """One SigLIP layer over a batch of sequences x [B, N, H] that each
    attend all of their own rows."""
    p = f"vision.layers.{i}."
    h, heads, eps = vc["hidden_size"], vc["num_attention_heads"], vc["layer_norm_eps"]
    d = h // heads
    y = layer_norm(x, w(p + "ln1.scale"), w(p + "ln1.bias"), eps)
    q = prec.linear(y, w(p + "attn.wq"), w(p + "attn.bq"))
    k = prec.linear(y, w(p + "attn.wk"), w(p + "attn.bk"))
    v = prec.linear(y, w(p + "attn.wv"), w(p + "attn.bv"))
    b, n, _ = x.shape
    o = torch.stack([attend(q[j].reshape(n, heads, d), k[j].reshape(n, heads, d),
                            v[j].reshape(n, heads, d), causal=False, window=None, prec=prec)
                     for j in range(b)]).reshape(b, n, h)
    x = x + prec.linear(o, w(p + "attn.wo"), w(p + "attn.bo"))
    y = layer_norm(x, w(p + "ln2.scale"), w(p + "ln2.bias"), eps)
    y = _gelu_tanh(prec.linear(y, w(p + "mlp.fc1"), w(p + "mlp.b1")))
    return x + prec.linear(y, w(p + "mlp.fc2"), w(p + "mlp.b2"))


def _patches(w: Weights, pixels: torch.Tensor, vc: dict, prec: Precision) -> torch.Tensor:
    """pixels [B, 3, H, W] → [B, (H/p)(W/p), hidden], row-major patches."""
    h, p = vc["hidden_size"], vc["patch_size"]
    kernel = w("vision.patch_embed.kernel").reshape(h, 3, p, p)
    x = F.conv2d(prec.q(pixels), prec.q(kernel), w("vision.patch_embed.bias"), stride=p)
    return x.flatten(2).transpose(1, 2)


def _tower(w: Weights, x: torch.Tensor, vc: dict, prec: Precision) -> torch.Tensor:
    for i in range(vc["num_hidden_layers"]):
        x = checkpointed(lambda t, i=i: tower_layer(w, i, t, vc, prec), x)
    return layer_norm(x, w("vision.post_ln.scale"), w("vision.post_ln.bias"),
                      vc["layer_norm_eps"])


def llava_image_features(spec: dict, w: Weights, tiles_u8: torch.Tensor,
                         prec: Precision, block: int = 8) -> torch.Tensor:
    """uint8 tiles [C, T, T, 3] → the projected features [C·T'², text
    hidden], in crop order, in blocks of `block` tiles."""
    vc, any_ = spec["vision_config"], spec["anyres_config"]
    mean = torch.tensor(any_["image_mean"], device=tiles_u8.device)[None, :, None, None]
    std = torch.tensor(any_["image_std"], device=tiles_u8.device)[None, :, None, None]
    r = spec["projector_config"]["pixel_shuffle_factor"]
    side = vc["image_size"] // vc["patch_size"]
    outs = []
    for i in range(0, tiles_u8.shape[0], block):
        px = tiles_u8[i:i + block].float().permute(0, 3, 1, 2) / 255.0
        px = (px - mean) / std
        x = _patches(w, px, vc, prec) + w("vision.pos_embed")[: side * side]
        x = _tower(w, x, vc, prec)
        b, _, h = x.shape
        x = x.reshape(b, side // r, r, side // r, r, h).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, (side // r) ** 2, r * r * h)
        y = F.gelu(prec.linear(x, w("projector.fc1"), w("projector.b1")))
        outs.append(prec.linear(y, w("projector.fc2"), w("projector.b2")).reshape(-1, y.shape[-1]))
    return torch.cat(outs, dim=0)


def navit_positions(gh: int, gw: int, side: int, device) -> torch.Tensor:
    """Table rows of an image's gh × gw real patches, row-major."""
    bounds = np.arange(1, side, dtype=np.float32) / np.float32(side)

    def bucket(n):
        frac = np.arange(n, dtype=np.float32) / np.float32(n)
        return np.searchsorted(bounds, frac, side="right")

    ids = bucket(gh)[:, None] * side + bucket(gw)[None, :]
    return torch.from_numpy(ids.reshape(-1).astype(np.int64)).to(device)


def _swiglu(w: Weights, p: str, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    g = prec.linear(x, w(p + "w_gate"))
    u = prec.linear(x, w(p + "w_up"))
    return prec.linear(F.silu(g) * u, w(p + "w_down"))


def perceiver_layer(w: Weights, i: int, lat, context, pc: dict, prec: Precision):
    p = f"perceiver.layers.{i}."
    eps = pc["rms_norm_eps"]
    heads, kvh, d = pc["resampler_n_heads"], pc["num_key_value_heads"], pc["resampler_head_dim"]
    lat_n = rms_norm(lat, w(p + "latents_norm"), eps)
    ctx_n = rms_norm(context, w(p + "context_norm"), eps)
    kv = torch.cat([ctx_n, lat_n], dim=0)
    q = prec.linear(lat_n, w(p + "attn.wq")).reshape(lat.shape[0], heads, d)
    k = prec.linear(kv, w(p + "attn.wk")).reshape(kv.shape[0], kvh, d)
    v = prec.linear(kv, w(p + "attn.wv")).reshape(kv.shape[0], kvh, d)
    g = heads // kvh
    s = torch.einsum("qhd,khd->hqk", prec.q(q), prec.q(k.repeat_interleave(g, 1))) / math.sqrt(d)
    o = torch.einsum("hqk,khd->qhd", prec.q(torch.softmax(s, -1)),
                     prec.q(v.repeat_interleave(g, 1)))
    lat = lat + prec.linear(o.reshape(lat.shape[0], -1), w(p + "attn.wo"))
    y = rms_norm(lat, w(p + "post_attn_norm"), eps)
    return lat + _swiglu(w, p + "mlp.", y, prec)


def idefics2_image_features(spec: dict, w: Weights, pixels: torch.Tensor,
                            grids: List[tuple], prec: Precision) -> torch.Tensor:
    """Normalized images [N, 3, S, S] with real patch grids (gh, gw) →
    [N · latents, text hidden], image by image."""
    vc, pc = spec["vision_config"], spec["perceiver_config"]
    p = vc["patch_size"]
    side = vc["image_size"] // p
    outs = []
    for n, (gh, gw) in enumerate(grids):
        x = _patches(w, pixels[n:n + 1, :, : gh * p, : gw * p], vc, prec)
        x = x + w("vision.pos_embed")[navit_positions(gh, gw, side, x.device)]
        feats = _tower(w, x, vc, prec)[0]
        context = _swiglu(w, "perceiver.modality_proj.", feats, prec)
        lat = w("perceiver.latents")
        for i in range(pc["resampler_depth"]):
            lat = checkpointed(lambda a, c, i=i: perceiver_layer(w, i, a, c, pc, prec),
                               lat, context)
        outs.append(rms_norm(lat, w("perceiver.final_norm"), pc["rms_norm_eps"]))
    return torch.cat(outs, dim=0)


def decoder_layer(w: Weights, i: int, x, positions, seg_bounds, tc: dict, prec: Precision):
    """One Mistral layer over one row x [S, H]; `seg_bounds` the (start,
    end) of each sample, which attends only itself."""
    p = f"text.layers.{i}."
    heads, kvh = tc["num_attention_heads"], tc["num_key_value_heads"]
    d = tc.get("head_dim", tc["hidden_size"] // heads)
    s = x.shape[0]
    y = rms_norm(x, w(p + "input_norm"), tc["rms_norm_eps"])
    q = rope(prec.linear(y, w(p + "attn.wq")).reshape(s, heads, d), positions, tc["rope_theta"])
    k = rope(prec.linear(y, w(p + "attn.wk")).reshape(s, kvh, d), positions, tc["rope_theta"])
    v = prec.linear(y, w(p + "attn.wv")).reshape(s, kvh, d)
    o = torch.cat([attend(q[a:b], k[a:b], v[a:b], causal=True, window=tc.get("sliding_window"),
                          prec=prec) for a, b in seg_bounds], dim=0)
    x = x + prec.linear(o.reshape(s, heads * d), w(p + "attn.wo"))
    y = rms_norm(x, w(p + "post_attn_norm"), tc["rms_norm_eps"])
    return x + _swiglu(w, p + "mlp.", y, prec)


def decoder_hidden(spec: dict, w: Weights, tokens: torch.Tensor, image_at: torch.Tensor,
                   features: Optional[torch.Tensor], seg_bounds, prec: Precision,
                   head_dim: int) -> torch.Tensor:
    """One row: token ids [S], the image positions [S] bool taking
    `features` rows in order, samples at `seg_bounds` → the final-normed
    hidden states [S, H]."""
    tc = dict(spec["text_config"], head_dim=head_dim)
    x = w("text.embed_tokens")[tokens.long()]
    if features is not None:
        idx = torch.cumsum(image_at.long(), 0) - 1
        x = torch.where(image_at[:, None], features[idx.clamp(min=0)], x)
    positions = torch.cat([torch.arange(b - a, device=tokens.device) for a, b in seg_bounds])
    for i in range(tc["num_hidden_layers"]):
        x = checkpointed(lambda t, i=i: decoder_layer(w, i, t, positions, seg_bounds, tc, prec), x)
    return rms_norm(x, w("text.final_norm"), tc["rms_norm_eps"])


def head_logits(w: Weights, hidden: torch.Tensor, prec: Precision) -> torch.Tensor:
    return prec.linear(hidden, w("text.lm_head"))
