"""Blockwise attention in kv chunks with an online softmax (port of
leopard_tpu/ops/chunked_attention.py): `chunked_attention` (:22-103), the
memory-bounded tier of an uncached forward, `chunked_continuation_attention`
(:106-200) over a KV cache, and the chunk picker
(leopard_tpu/models/decoder.py:40-54).

`chunked_attention` is the decoder's `attn_impl="chunked"`: the keys and
values are read one chunk at a time with running (max, denominator,
weighted sum) in fp32, so the scores held at once are [B, Hq, Sq, chunk];
with `remat` each chunk's step runs under `torch.utils.checkpoint`, so the
backward keeps only the running state between chunks and recomputes each
chunk's scores (the JAX package's `jax.checkpoint` of the scan body). A
query with no key (a padding row) comes out as the mean of V, as in the
JAX package: the masked scores are -1e30, never -inf. It is XLA code in the
JAX package, not a Pallas kernel, so plain PyTorch is its port; on the card
"auto" takes the flash kernel and "chunked" is a forced option.

`chunked_continuation_attention`: S new queries attend over the whole
cache, which already holds their own keys and values, one kv chunk at a
time, so the scores held at once are [B, Hq, S, chunk] rather than
[B, Hq, S, S_max]. The cache's invariant
slot == absolute position makes causality a compare, q_position >= slot;
a slot takes part only where its segment id is non-zero. This is plain
PyTorch on every device: it is plain JAX in the JAX package too, outside
any Pallas kernel, and the flash kernel (K1) cannot stand in for it, since
K1's causal mask counts query and key positions both from 0.

Arithmetic as in the JAX package: the products take operands in the
compute dtype (the cache's float dtype, or bf16 for an int8 cache) and
accumulate in fp32. Here the operands are rounded to that dtype and the
products run in fp32, which gives those products (bf16 and int8 values are
exact in fp32). An int8 cache's per-token-per-head scales fold into the
scores (k) and into the probabilities (v) per chunk, so no dequantized copy
of the cache is formed.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

NEG_INF = -1e30


def pick_chunk(s: int, target: int) -> int:
    """Largest chunk ≤ target that divides s. When s is a multiple of 128
    the chunk is kept a multiple of 128 too (an odd bucket such as 8,320
    would otherwise get an 832-wide chunk)."""
    c = min(target, s)
    if s % 128 == 0 and c >= 128:
        c -= c % 128
        while s % c:
            c -= 128
        return c
    while s % c:
        c -= 1
    return c


def _chunk_step(m, l, acc, qg, kb, vb, mask, scale):
    """One chunk's online-softmax update of (m, l, acc) [B, Hkv, G, Sq(, D)]
    from its k/v [B, bk, Hkv, D] and its mask [B, Sq, bk]."""
    scores = torch.einsum("bhgqd,bkhd->bhgqk", qg, kb.float()) * scale
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    p = torch.exp(scores - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bhgqk,bkhd->bhgqd", p.to(vb.dtype).float(), vb.float())
    return m_new, l_new, acc_new


def chunked_attention(
    q: torch.Tensor,            # [B, Sq, Hq, D]
    k: torch.Tensor,            # [B, Skv, Hkv, D]
    v: torch.Tensor,            # [B, Skv, Hkv, D]
    *,
    causal: bool = True,
    q_segment_ids: Optional[torch.Tensor] = None,   # [B, Sq]; 0 = padding
    kv_segment_ids: Optional[torch.Tensor] = None,  # [B, Skv]
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
    chunk_size: int = 512,
    remat: bool = True,
) -> torch.Tensor:
    """Returns [B, Sq, Hq, D] in q.dtype: softmax(scale · QKᵀ + mask) V with
    the JAX package's mask (segments equal and non-zero, causal, q − kv <
    window), one kv chunk of `chunk_size` at a time (Skv a multiple of it).
    The scores are fp32 from q and k as given; the probabilities are
    rounded to V's dtype before their product with V, as in the JAX
    package."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"{hq} q heads not a multiple of {hkv} kv heads")
    group = hq // hkv
    if scale is None:
        scale = d**-0.5
    bk = min(chunk_size, skv)
    if skv % bk:
        raise ValueError(f"kv length {skv} not divisible by chunk {bk}")
    if q_segment_ids is None:
        q_segment_ids = torch.ones((b, sq), dtype=torch.int32, device=q.device)
    if kv_segment_ids is None:
        kv_segment_ids = torch.ones((b, skv), dtype=torch.int32, device=q.device)
    qg = q.reshape(b, sq, hkv, group, d).permute(0, 2, 3, 1, 4).float()  # [B,Hkv,G,Sq,D]
    q_pos = torch.arange(sq, device=q.device)
    q_live = (q_segment_ids != 0)[:, :, None]
    m = torch.full((b, hkv, group, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, group, sq, d), dtype=torch.float32, device=q.device)
    for start in range(0, skv, bk):
        sl = slice(start, start + bk)
        kv_seg = kv_segment_ids[:, sl]
        mask = (q_segment_ids[:, :, None] == kv_seg[:, None, :]) & q_live & (
            kv_seg != 0)[:, None, :]
        kv_pos = torch.arange(start, start + bk, device=q.device)
        rel = q_pos[:, None] - kv_pos[None, :]
        if causal:
            mask = mask & (rel >= 0)[None]
        if sliding_window is not None:
            mask = mask & (rel < sliding_window)[None]
        args = (m, l, acc, qg, k[:, sl], v[:, sl], mask, scale)
        if remat and torch.is_grad_enabled():
            m, l, acc = torch.utils.checkpoint.checkpoint(_chunk_step, *args,
                                                          use_reentrant=False)
        else:
            m, l, acc = _chunk_step(*args)
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


def chunked_continuation_attention(
    q: torch.Tensor,            # [B, Sq, Hq, D], the new tokens' queries
    k: torch.Tensor,            # [B, Skv, Hkv, D] cache keys (float or int8)
    v: torch.Tensor,            # [B, Skv, Hkv, D] cache values
    kv_valid: torch.Tensor,     # [B, Skv] slot validity (seg != 0)
    q_positions: torch.Tensor,  # [B, Sq] absolute positions
    *,
    k_scale: Optional[torch.Tensor] = None,  # [B, Skv, Hkv] f32 (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
    chunk_size: int = 512,
) -> torch.Tensor:
    """Returns [B, Sq, Hq, D] in q.dtype."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"{hq} q heads not a multiple of {hkv} kv heads")
    group = hq // hkv
    if scale is None:
        scale = d**-0.5
    bk = min(chunk_size, skv)
    if skv % bk:
        raise ValueError(f"cache length {skv} not divisible by chunk {bk}")
    quant = k.dtype == torch.int8
    if quant and (k_scale is None or v_scale is None):
        raise ValueError("an int8 cache needs k_scale and v_scale")
    compute_dt = torch.bfloat16 if quant else k.dtype

    # [B, Hkv, G, Sq, D]
    qg = q.reshape(b, sq, hkv, group, d).permute(0, 2, 3, 1, 4).to(compute_dt).float()
    valid = kv_valid != 0
    m = torch.full((b, hkv, group, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, group, sq, d), dtype=torch.float32, device=q.device)
    for start in range(0, skv, bk):
        sl = slice(start, start + bk)
        kb = k[:, sl].to(compute_dt).float().permute(0, 2, 3, 1)[:, :, None]  # [B,Hkv,1,D,bk]
        scores = torch.matmul(qg, kb)                                          # [B,Hkv,G,Sq,bk]
        if quant:
            scores.mul_(scale * k_scale[:, sl].transpose(1, 2)[:, :, None, None, :])
        else:
            scores.mul_(scale)
        kv_pos = torch.arange(start, start + bk, device=q.device)
        rel = q_positions[:, :, None] - kv_pos[None, None, :]                  # [B,Sq,bk]
        mask = valid[:, None, sl] & (rel >= 0)
        if sliding_window is not None:
            mask = mask & (rel < sliding_window)
        scores.masked_fill_(~mask[:, None, None], NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = scores.sub_(m_new[..., None]).exp_()
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        if quant:
            p.mul_(v_scale[:, sl].transpose(1, 2)[:, :, None, None, :])
        vb = v[:, sl].to(compute_dt).float().permute(0, 2, 1, 3)[:, :, None]  # [B,Hkv,1,bk,D]
        acc = acc * alpha[..., None] + torch.matmul(p.to(compute_dt).float(), vb)
        m = m_new
        del scores, p
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)
