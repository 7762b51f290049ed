"""Tensor parallelism over the "model" axis, on local shards (Megatron's
column- and row-parallel arithmetic).

The JAX package lets GSPMD insert these collectives from the rules table.
DTensor does the same in PyTorch, but its sharding propagation on the
six-axis mesh did not finish its first operator (a mean, in 40 s on the
CPU), so the port's forward runs on the local shards that the rules give
each rank and says where the collectives go:

  - a column-parallel product (q/k/v, gate/up, fc1) takes its input through
    `copy_to_tp`: the identity forward, a sum of the input's gradients over
    the model group backward;
  - a row-parallel product (wo, w_down, fc2) gives partial sums that
    `reduce_from_tp` adds over the model group; its bias is added after
    (`row_linear`);
  - the embedding table and the head are vocab-parallel: each rank holds a
    contiguous block of vocabulary rows (`vocab_parallel_embedding`,
    `vocab_parallel_logz`, `gather_from_tp` for serving's full logits).

With `par` None or a model axis of one, every function here is the plain
arithmetic.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F


def _tp(par) -> bool:
    return par is not None and par.tp_size > 1


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.rank, ctx.size = rank, size
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.size, dim=-1)[ctx.rank].contiguous(), None, None, None


def copy_to_tp(x: torch.Tensor, par) -> torch.Tensor:
    return _CopyToTP.apply(x, par.tp_group) if _tp(par) else x


def reduce_from_tp(x: torch.Tensor, par) -> torch.Tensor:
    return _ReduceFromTP.apply(x, par.tp_group) if _tp(par) else x


def gather_from_tp(x: torch.Tensor, par) -> torch.Tensor:
    """Concatenate each rank's last-dim block (e.g. its vocab columns)."""
    return _GatherFromTP.apply(x, par.tp_group, par.tp_rank, par.tp_size) if _tp(par) else x


def row_linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], par) -> torch.Tensor:
    """A row-parallel F.linear: the partial products summed over the model
    group, then the (replicated) bias."""
    if not _tp(par):
        return F.linear(x, w, b)
    y = reduce_from_tp(F.linear(x, w), par)
    return y if b is None else y + b


def vocab_parallel_embedding(tokens: torch.Tensor, table: torch.Tensor, par) -> torch.Tensor:
    """Embedding lookup in this rank's block of vocabulary rows; the other
    ranks' tokens give 0 here and their rows arrive by the sum."""
    if not _tp(par):
        return F.embedding(tokens, table)
    n = table.shape[0]
    local = tokens - par.tp_rank * n
    inside = (local >= 0) & (local < n)
    e = F.embedding(local.clamp(0, n - 1), table) * inside[..., None].to(table.dtype)
    return reduce_from_tp(e, par)


def vocab_parallel_logz(logits: torch.Tensor, targets: torch.Tensor, par):
    """(logsumexp over the whole vocabulary, the target's logit), both
    [...], from this rank's vocab columns of fp32 logits [..., V/tp]."""
    if not _tp(par):
        logz = torch.logsumexp(logits, dim=-1)
        idx = targets.long().clamp(0, logits.shape[-1] - 1)[..., None]
        return logz, logits.gather(-1, idx)[..., 0]
    n = logits.shape[-1]
    m = logits.detach().amax(dim=-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=par.tp_group)
    sum_exp = reduce_from_tp((logits - m[..., None]).exp().sum(dim=-1), par)
    local = targets.long() - par.tp_rank * n
    inside = (local >= 0) & (local < n)
    true = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0] * inside
    return m + sum_exp.log(), reduce_from_tp(true, par)
