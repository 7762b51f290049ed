"""Dense GQA attention with the JAX package's mask semantics (port of
leopard_tpu/ops/attention.py:25-170), and its variant over an int8 KV cache.

  - causal or bidirectional;
  - grouped-query (q heads a multiple of kv heads, kv head = h // group);
  - segment ids, 0 = padding: a pair attends iff both ids are equal and
    non-zero;
  - sliding window: attend iff q_pos - k_pos < window;
  - NEG_INF = -1e30 rather than -inf, so fully-masked rows stay finite.

Scores and softmax are float32; the probabilities are cast to V's dtype
before the PV product, which accumulates in float32. This dense path is the
CPU path, the cached-decode path and the plain version the flash kernel is
held against (ops/flash_attention.py).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def make_attention_mask(
    q_len: int,
    kv_len: int,
    *,
    causal: bool = False,
    q_segment_ids: Optional[torch.Tensor] = None,   # [B, Sq] int; 0 = padding
    kv_segment_ids: Optional[torch.Tensor] = None,  # [B, Skv]
    sliding_window: Optional[int] = None,
    device=None,
    q_offset: int = 0,
) -> Optional[torch.Tensor]:
    """Boolean mask [B or 1, 1, Sq, Skv]; True = attend. `q_offset` shifts
    the query positions (q row i sits at i + q_offset, counted from kv row
    0): a block of a longer sequence, as a ring block."""
    if device is None and q_segment_ids is not None:
        device = q_segment_ids.device
    masks = []
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    if causal:
        masks.append((q_pos >= kv_pos)[None, None])
    if sliding_window is not None:
        masks.append((q_pos - kv_pos < sliding_window)[None, None])
    if q_segment_ids is not None and kv_segment_ids is not None:
        qs = q_segment_ids[:, :, None]
        ks = kv_segment_ids[:, None, :]
        masks.append(((qs == ks) & (qs != 0) & (ks != 0))[:, None])
    if not masks:
        return None
    mask = masks[0]
    for m in masks[1:]:
        mask = mask & m
    return mask


def attention(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,  # [B, Skv, Hkv, D]
    *,
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,          # [B|1, 1, Sq, Skv] bool
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Returns [B, Sq, Hq, D] in q.dtype."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"{hq} q heads not a multiple of {hkv} kv heads")
    group = hq // hkv
    if mask is None:
        mask = make_attention_mask(
            sq, skv, causal=causal,
            q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
            sliding_window=sliding_window, device=q.device,
        )
    qg = q.reshape(b, sq, hkv, group, d).float()
    # scores [B, Hkv, G, Sq, Skv]: bf16 inputs are exact in fp32, so this is
    # the bf16 product with fp32 accumulation
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * d**-0.5
    if mask is not None:  # [B|1, 1, Sq, Skv] → [B|1, 1, 1, Sq, Skv]
        scores = scores.masked_fill(~mask[:, :, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(), v.float()
    )
    return out.reshape(b, sq, hq, d).to(q.dtype)


def attention_quant_kv(
    q: torch.Tensor,    # [B, Sq, Hq, D]
    k_q: torch.Tensor,  # [B, Skv, Hkv, D] int8
    k_s: torch.Tensor,  # [B, Skv, Hkv] f32 per-token-per-head scale
    v_q: torch.Tensor,  # [B, Skv, Hkv, D] int8
    v_s: torch.Tensor,  # [B, Skv, Hkv] f32
    *,
    mask: Optional[torch.Tensor] = None,          # [B|1, 1|Hq, Sq, Skv] bool
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention over an int8 KV cache (port of attention.py:132-170). The
    scales fold into the math, so no dequantized copy of the cache is formed:
      scores = (q · k_int8) · k_scale[kv],   out = (probs · v_scale[kv]) @ v_int8.
    q and the probabilities are rounded to bf16 as in the JAX package, whose
    products take bf16 operands; int8 and bf16 values are exact in fp32, so
    the fp32 products here are those products with fp32 accumulation."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k_q.shape
    group = hq // hkv
    if scale is None:
        scale = d**-0.5
    qg = q.reshape(b, sq, hkv, group, d).to(torch.bfloat16).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_q.float())
    # k scale: [B, Skv, Hkv] → [B, Hkv, 1, 1, Skv]
    scores = scores * (scale * k_s.transpose(1, 2)[:, :, None, None, :])
    if mask is not None:
        m = mask[:, :, None] if mask.shape[1] == 1 else mask.reshape(
            mask.shape[0], hkv, group, sq, skv)
        scores = scores.masked_fill(~m, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = probs * v_s.transpose(1, 2)[:, :, None, None, :]
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(torch.bfloat16).float(), v_q.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)
