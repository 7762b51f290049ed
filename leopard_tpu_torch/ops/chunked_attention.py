"""Continuation attention over a KV cache in kv chunks with an online
softmax (port of leopard_tpu/ops/chunked_attention.py:106-200), and the
chunk picker (leopard_tpu/models/decoder.py:40-54).

S new queries attend over the whole cache, which already holds their own
keys and values, one kv chunk at a time, so the scores held at once are
[B, Hq, S, chunk] rather than [B, Hq, S, S_max]. The cache's invariant
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
