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
    `vocab_parallel_logz`, `gather_from_tp` for serving's full logits); a
    vocabulary that the model group does not divide (Mistral's 32,003) is
    cut in blocks of ceil(V / tp), the last one shorter, as DTensor and
    GSPMD cut an uneven dim.

The MoE layer's expert parallelism over the "expert" axis (ops/moe.py)
uses the same kind of functions over the expert group:

  - `split_to_ep` takes this rank's contiguous slice of the token rows (the
    ranks of an expert group hold the same rows): its backward all-gathers
    the slices' gradients, so every rank's layers before it see the whole
    gradient; `gather_from_ep` is its inverse, an all-gather of the slices
    whose backward takes this rank's slice back;
  - `all_to_all_ep` sends row blocks of given sizes to each rank of the
    group (`dist.all_to_all_single`); its backward is the same exchange
    with the sizes swapped;
  - `copy_to_ep` / `reduce_from_ep` are `copy_to_tp` / `reduce_from_tp`
    over the expert group (the capacity path's sum of partial combines).

With `par` None or a model axis of one, every function here is the plain
arithmetic, and so is every `*_ep` function at an expert axis of one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F


def _tp(par) -> bool:
    return par is not None and par.tp_size > 1


def _ep(par) -> bool:
    return par is not None and par.ep_size > 1


class _Copy(torch.autograd.Function):
    """The identity forward, a sum over `group` backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    """A sum over `group` forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """Each rank's last-dim block, `block` wide (the last may be narrower:
    padded for the gather), concatenated and cut to `total`."""

    @staticmethod
    def forward(ctx, x, group, rank, size, block, total):
        ctx.rank, ctx.block, ctx.n = rank, block, x.shape[-1]
        x = F.pad(x, (0, block - x.shape[-1])) if x.shape[-1] < block else x
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)[..., :total]

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.block
        return g[..., lo:lo + ctx.n].contiguous(), None, None, None, None, None


class _SplitRows(torch.autograd.Function):
    """This rank's contiguous block of rows forward, an all-gather of the
    blocks' gradients backward."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.group, ctx.size = group, size
        n = x.shape[0] // size
        return x[rank * n:(rank + 1) * n].clone()

    @staticmethod
    def backward(ctx, g):
        parts = [torch.empty_like(g) for _ in range(ctx.size)]
        dist.all_gather(parts, g.contiguous(), group=ctx.group)
        return torch.cat(parts), None, None, None


class _GatherRows(torch.autograd.Function):
    """Every rank's block of rows, concatenated in rank order, forward;
    this rank's block of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.rank, ctx.size = rank, size
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.size)[ctx.rank].contiguous(), None, None, None


class _AllToAll(torch.autograd.Function):
    """Rows [sum(in_splits), ...] out in blocks of `in_splits` (block i to
    rank i), rows [sum(out_splits), ...] in (block i from rank i)."""

    @staticmethod
    def forward(ctx, x, group, in_splits, out_splits):
        ctx.group, ctx.in_splits, ctx.out_splits = group, in_splits, out_splits
        out = x.new_empty((sum(out_splits), *x.shape[1:]))
        dist.all_to_all_single(out, x.contiguous(), list(out_splits), list(in_splits),
                               group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        gx = g.new_empty((sum(ctx.in_splits), *g.shape[1:]))
        dist.all_to_all_single(gx, g.contiguous(), list(ctx.in_splits), list(ctx.out_splits),
                               group=ctx.group)
        return gx, None, None, None


def copy_to_tp(x: torch.Tensor, par) -> torch.Tensor:
    return _Copy.apply(x, par.tp_group) if _tp(par) else x


def reduce_from_tp(x: torch.Tensor, par) -> torch.Tensor:
    return _Reduce.apply(x, par.tp_group) if _tp(par) else x


def copy_to_ep(x: torch.Tensor, par) -> torch.Tensor:
    return _Copy.apply(x, par.ep_group) if _ep(par) else x


def reduce_from_ep(x: torch.Tensor, par) -> torch.Tensor:
    return _Reduce.apply(x, par.ep_group) if _ep(par) else x


def split_to_ep(x: torch.Tensor, par) -> torch.Tensor:
    """This rank's 1/ep block of the rows of `x` (its first dim)."""
    return _SplitRows.apply(x, par.ep_group, par.ep_rank, par.ep_size) if _ep(par) else x


def gather_from_ep(x: torch.Tensor, par) -> torch.Tensor:
    """Every expert rank's rows of `x`, in expert-coordinate order."""
    return _GatherRows.apply(x, par.ep_group, par.ep_rank, par.ep_size) if _ep(par) else x


def all_to_all_ep(x: torch.Tensor, group, in_splits, out_splits) -> torch.Tensor:
    """The rows of `x` exchanged over `group` by the block sizes given
    (`dist.all_to_all_single`), differentiable; integer rows (ids) pass
    through the same call."""
    return _AllToAll.apply(x, group, tuple(in_splits), tuple(out_splits))


def vocab_block(par, vocab: int) -> int:
    """The rows of every rank's vocabulary block but the last: the rules cut
    a vocabulary of `vocab` rows in blocks of ceil(vocab / tp), so the last
    block may be shorter (32,003 over 2 ranks: 16,002 and 16,001)."""
    return -(-vocab // par.tp_size)


def gather_from_tp(x: torch.Tensor, par, total: int) -> torch.Tensor:
    """Concatenate each rank's last-dim block of a dim `total` wide (its
    vocab columns), cut as `vocab_block` says."""
    if not _tp(par):
        return x
    return _GatherFromTP.apply(x, par.tp_group, par.tp_rank, par.tp_size,
                               vocab_block(par, total), total)


def row_linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], par) -> torch.Tensor:
    """A row-parallel F.linear: the partial products summed over the model
    group, then the (replicated) bias."""
    if not _tp(par):
        return F.linear(x, w, b)
    y = reduce_from_tp(F.linear(x, w), par)
    return y if b is None else y + b


def vocab_parallel_embedding(tokens: torch.Tensor, table: torch.Tensor, par,
                             vocab: int) -> torch.Tensor:
    """Embedding lookup in this rank's block of vocabulary rows; the other
    ranks' tokens give 0 here and their rows arrive by the sum. `vocab`:
    the whole table's rows (see vocab_block)."""
    if not _tp(par):
        return F.embedding(tokens, table)
    n = table.shape[0]
    local = tokens - par.tp_rank * vocab_block(par, vocab)
    inside = (local >= 0) & (local < n)
    e = F.embedding(local.clamp(0, n - 1), table) * inside[..., None].to(table.dtype)
    return reduce_from_tp(e, par)


def vocab_parallel_logz(logits: torch.Tensor, targets: torch.Tensor, par, vocab: int):
    """(logsumexp over the whole vocabulary, the target's logit), both
    [...], from this rank's vocab columns of fp32 logits [..., V/tp];
    `vocab` the whole vocabulary (see vocab_block)."""
    if not _tp(par):
        logz = torch.logsumexp(logits, dim=-1)
        idx = targets.long().clamp(0, logits.shape[-1] - 1)[..., None]
        return logz, logits.gather(-1, idx)[..., 0]
    n = logits.shape[-1]
    m = logits.detach().amax(dim=-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=par.tp_group)
    sum_exp = reduce_from_tp((logits - m[..., None]).exp().sum(dim=-1), par)
    local = targets.long() - par.tp_rank * vocab_block(par, vocab)
    inside = (local >= 0) & (local < n)
    true = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0] * inside
    return m + sum_exp.log(), reduce_from_tp(true, par)
