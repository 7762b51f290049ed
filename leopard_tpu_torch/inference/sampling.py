"""Token sampling: greedy, temperature, top-k, top-p and repetition penalty
(port of leopard_tpu/inference/sampling.py). Random draws take an explicit
`torch.Generator` on the logits' device."""

from __future__ import annotations

from typing import Optional

import torch

from leopard_tpu_torch.config import GenerateConfig

NEG_INF = -1e30


def apply_repetition_penalty(
    logits: torch.Tensor,        # [B, V] fp32
    prev_tokens: torch.Tensor,   # [B, S] int (pad slots allowed)
    prev_mask: torch.Tensor,     # [B, S] bool, True at real tokens
    penalty: float,
) -> torch.Tensor:
    """CTRL-style: divide positive and multiply negative logits of seen
    tokens by `penalty`."""
    if penalty == 1.0:
        return logits
    idx = torch.where(prev_mask, prev_tokens, 0).long()
    seen = torch.zeros_like(logits, dtype=torch.bool).scatter_(1, idx, True)
    # masked slots were sent to column 0: it counts only for a real token 0
    seen[:, 0] = ((prev_tokens == 0) & prev_mask).any(dim=1)
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def top_p_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set of tokens whose cumulative
    probability exceeds p (the top token always survives)."""
    if p <= 0.0 or p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p
    threshold = torch.where(
        keep_sorted, sorted_logits, torch.full_like(sorted_logits, float("inf"))
    ).min(dim=-1, keepdim=True).values
    return torch.where(logits < threshold, torch.full_like(logits, NEG_INF), logits)


def sample(
    logits: torch.Tensor,                     # [B, V] fp32
    generator: Optional[torch.Generator],
    cfg: GenerateConfig,
    prev_tokens: Optional[torch.Tensor] = None,
    prev_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns sampled token ids [B] int32."""
    if cfg.repetition_penalty != 1.0 and prev_tokens is not None:
        logits = apply_repetition_penalty(
            logits, prev_tokens, prev_mask, cfg.repetition_penalty
        )
    if cfg.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if cfg.temperature != 1.0:
        logits = logits / cfg.temperature
    logits = top_k_filter(logits, cfg.top_k)
    logits = top_p_filter(logits, cfg.top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
