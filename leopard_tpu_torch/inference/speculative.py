"""Prompt-lookup speculative decoding: n-gram drafts verified in one
forward (port of leopard_tpu/inference/speculative.py:60-242).

Each round drafts k tokens by continuing the most recent earlier occurrence
of the last `ngram` tokens of a row's history (prompt + generated), runs
one forward over the last emitted token and the k drafts through the
decoder's dense continuation tier, and keeps the drafts the model itself
would have emitted greedily, plus its own next token. In exact arithmetic
the output equals plain greedy decoding; in bf16 the verify forward (width
k + 1) and a decode step (width 1) round differently, so on the card
greedy picks may flip where the top-2 logit margin is below that noise
(random weights have margins near it).

The loop runs on the host in Python, one round per iteration, like the
engine's `_decode`; the bookkeeping stays on the device. Rollback is
metadata only: the rejected slots of a verify block get seg 0 and the
row's index rewinds, so the next round overwrites them. Greedy only.
"""

from __future__ import annotations

import dataclasses

import torch

from leopard_tpu_torch.config import GenerateConfig
from leopard_tpu_torch.models.decoder import KVCache


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """ngram: match length of the history lookup; draft: tokens proposed
    per round (each verify forward runs draft + 1 positions)."""

    ngram: int = 2
    draft: int = 7


def _propose(hist: torch.Tensor, total: torch.Tensor, ngram: int, k: int) -> torch.Tensor:
    """Draft k tokens per row: the tokens after the most recent strictly
    earlier occurrence of the row's last `ngram` tokens, or the last token
    repeated where there is none. hist [B, Hs] int, total [B] valid lengths.
    Returns [B, k]."""
    b, hs = hist.shape
    dev = hist.device
    j = torch.arange(ngram, device=dev)[None, :]
    key = hist.gather(1, (total[:, None].long() - ngram + j).clamp(min=0))  # [B, g]
    n_win = hs - ngram
    m = torch.ones((b, n_win), dtype=torch.bool, device=dev)
    for g in range(ngram):
        m = m & (hist[:, g: g + n_win] == key[:, g: g + 1])
    idx = torch.arange(n_win, device=dev)[None, :]
    valid = (idx < (total - ngram)[:, None]) & (total >= ngram + 1)[:, None]
    istar = torch.where(m & valid, idx, -1).amax(dim=1)  # [B]
    found = istar >= 0
    src = torch.where(found, istar + ngram, 0)[:, None] + torch.arange(k, device=dev)[None, :]
    draft = hist.gather(1, src.clamp(0, hs - 1))
    return torch.where(found[:, None], draft, key[:, -1:])


def _put(buf: torch.Tensor, start: torch.Tensor, vals: torch.Tensor, n: torch.Tensor):
    """buf[r, start[r] + i] = vals[r, i] for i < n[r]; returns a new buffer."""
    w = vals.shape[1]
    i = torch.arange(w, device=buf.device)[None, :]
    tgt = torch.where(i < n[:, None], start[:, None].long() + i, buf.shape[1])
    out = torch.cat([buf, buf.new_zeros((buf.shape[0], 1))], dim=1)  # column of the dropped
    return out.scatter_(1, tgt, vals.to(buf.dtype))[:, :-1]


def _spec_decode(model, gen_cfg: GenerateConfig, first_logits, hist0, hist_len,
                 cache: KVCache, max_new_tokens: int, ngram: int, k: int):
    """Greedy speculative decode loop. Returns (gen_buf, gen_mask, lp_buf,
    rounds): the engine's `_decode` buffers and the number of verify
    forwards run. A row's buffer may run past its eos (the whole accepted
    block is recorded); the engine trims at the first eos."""
    b = first_logits.shape[0]
    dev = first_logits.device
    eos = torch.tensor(gen_cfg.eos_token_ids, dtype=torch.int32, device=dev)
    kj = torch.arange(k + 1, device=dev)[None, :]
    gen_buf = torch.zeros((b, max_new_tokens), dtype=torch.int32, device=dev)
    gen_mask = torch.zeros((b, max_new_tokens), dtype=torch.bool, device=dev)
    lp_buf = torch.zeros((b, max_new_tokens), dtype=torch.float32, device=dev)
    n_gen = torch.zeros((b,), dtype=torch.int32, device=dev)
    hist = hist0.clone()

    def emit(toks, lps, n_emit):
        nonlocal gen_buf, gen_mask, lp_buf, hist, n_gen
        gen_buf = _put(gen_buf, n_gen, toks, n_emit)
        gen_mask = _put(gen_mask, n_gen, torch.ones_like(toks, dtype=torch.bool), n_emit)
        lp_buf = _put(lp_buf, n_gen, lps, n_emit)
        hist = _put(hist, hist_len + n_gen, toks, n_emit)
        n_gen = n_gen + n_emit

    # the first token comes from the prefill logits; its KV is written by
    # the first verify forward, whose first position it is
    tok0 = first_logits.argmax(dim=-1).to(torch.int32)
    lp0 = torch.log_softmax(first_logits.float(), dim=-1).gather(1, tok0[:, None].long())
    emit(tok0[:, None], lp0, torch.ones((b,), dtype=torch.int32, device=dev))
    done = (tok0[:, None] == eos[None, :]).any(dim=1) | (max_new_tokens <= 1)
    t_last = tok0
    rounds = 0
    while rounds + 1 < max_new_tokens and not bool(done.all()):
        rounds += 1
        old_index = cache.index
        draft = _propose(hist, hist_len + n_gen, ngram, k)              # [B, k]
        tokens = torch.cat([t_last[:, None], draft], dim=1)
        seg = (~done).to(torch.int32)[:, None].expand(b, k + 1).contiguous()
        logits, cache = model(tokens, segment_ids=seg, cache=cache)     # [B, k+1, V]
        next_tok = logits.argmax(dim=-1).to(torch.int32)
        logp = torch.log_softmax(logits.float(), dim=-1)
        ok = next_tok[:, :k] == draft
        n_acc = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)     # [B] 0..k
        # emitted: the accepted drafts, then the model's own next token
        emit_toks = torch.where(kj < n_acc[:, None],
                                torch.cat([draft, draft[:, -1:]], dim=1), next_tok)
        emit_lps = logp.gather(2, emit_toks[:, :, None].long())[..., 0]
        budget_left = max_new_tokens - n_gen
        n_emit = torch.where(done, 0, torch.minimum(n_acc + 1, budget_left)).to(torch.int32)
        emit(emit_toks, emit_lps, n_emit)
        # rollback, metadata only: keep the last token and the accepted
        # drafts, give the rest of the written block seg 0, rewind the index
        spos = torch.arange(cache.seg.shape[1], device=dev)[None, :]
        written = (spos >= old_index[:, None]) & (spos < old_index[:, None] + k + 1)
        cache.seg = torch.where(written & (spos >= (old_index + n_emit)[:, None]), 0, cache.seg)
        cache.index = old_index + n_emit
        hit_eos = ((emit_toks[:, :, None] == eos[None, None, :])
                   & (kj < n_emit[:, None])[:, :, None]).any(dim=(1, 2))
        done = done | hit_eos | (n_gen >= max_new_tokens)
        t_last = emit_toks.gather(1, (n_emit.long() - 1).clamp(min=0)[:, None])[:, 0]
    return gen_buf, gen_mask, lp_buf, rounds
