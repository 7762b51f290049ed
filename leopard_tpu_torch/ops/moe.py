"""Mixture-of-Experts layer: a top-k router, then capacity or dropless
dispatch to the experts (port of leopard_tpu/ops/moe.py, its single-device
paths).

Weights are in the port's [out, in] layout (models/params.py): the router
`w` [E, H] (fp32 at init; the trainer's compute copy rounds it to the
compute dtype, as the JAX `cast_for_compute` does) and the experts
`w_gate`, `w_up` [E, F, H] and `w_down` [E, H, F]. The JAX tree keeps them
[H, E], [E, H, F] and [E, F, H]; convert/from_jax.py swaps the last two axes.

The semantics are the JAX package's, step for step:
  - the router runs in fp32 (the tokens cast to fp32 times the weight cast
    to fp32); softmax over every expert, then top-k, then the selected
    probabilities renormalized;
  - the load-balancing loss reads the renormalized probabilities; the
    z-loss is the mean squared logsumexp of the router logits;
  - capacity: C = int(max(1, cf · T · k / E)) in Python floats, T counting
    padded positions too; an assignment's position in its expert is a
    cumsum over the token-major, then slot, flattening, so the same tokens
    drop; `fraction_dropped` = 1 − the kept share;
  - dropless: a stable sort of the T·k assignments by expert id, the three
    expert matmuls over each expert's contiguous rows, and a scatter-add of
    the gated outputs; `fraction_dropped` is 0.

Two choices differ from the JAX lowering, not its results:
  - the capacity path scatters the kept tokens into [E, C, H] and gathers
    the outputs back, where JAX builds a [T, E, C] one-hot dispatch and
    combines by einsum (at 16,384 tokens, 4 experts and cf 1.25 its
    [T, k, E, C] one-hot holds 1.34 G elements);
  - dropless runs one matmul per expert over its slice of the sorted rows,
    where JAX runs `jax.lax.ragged_dot`. The slices' bounds come from the
    group sizes, read on the host once a layer: a device-to-host sync each
    layer of each forward, decode steps included. A grouped-GEMM kernel
    waits for a profile that names it.

Every expert matmul is a batched product (`torch.bmm`), so the "selective"
recompute policy (ops/remat.py), which saves the outputs of `aten.mm`,
recomputes them, as the JAX policy `dots_with_no_batch_dims_saveable`
recomputes the batched einsums and `ragged_dot`; the router's product is an
`aten.mm` and stays saved.

Under a device mesh (`par`, parallel/mesh.py::Parallel) each rank routes its
own tokens: those of its (data, fsdp) rows and, under the ring, its seq
shard. Three things follow the JAX package, which computes over the global
batch:

  - the statistics are global: the per-expert counts are summed over the
    token axes (data, fsdp, seq) before they weight this rank's probability
    sums, so the per-rank aux terms add up to the global aux loss and carry
    its gradient; the z-loss is each rank's sum over the global token count;
    `fraction_dropped` is the global dropped count over T_global · k;
  - capacity: C counts the global T, and an assignment's position in its
    expert is the cumsum over the global token-major order (the expert ids
    all-gathered over the token axes; under the ring the sequence in the
    ring's layout, as JAX runs its layer stack), so one rank's tokens can
    drop another's; under `expert > 1` each rank runs its own experts on every
    token it holds and the partial outputs are summed over the expert group;
  - dropless under `expert > 1` in training is JAX's
    `_dropless_dispatch_ep`: each expert rank dispatches the contiguous
    1/ep slice of its tokens (JAX shards the tokens over data, fsdp, seq
    and expert), sorts its T·k/ep assignments by expert (stable),
    exchanges the per-expert counts (one all-gather, one host read of the
    [ep, E] matrix a layer, kept for the backward), moves the rows to the
    ranks that hold their experts by
    an all-to-all, runs its local experts, sends the rows back and combines.
    Two transports (`moe_ep_ragged_a2a`): dense buckets of C rows per
    (source, destination) pair, JAX's C, the rows past C dropped and
    counted; or exactly the routed rows, with the split sizes from the
    matrix, dropping nothing. The outputs are all-gathered over the expert
    group, since the layers around the MoE compute the same rows on every
    expert rank.
  - serving (`par.ep_replicated`): every rank of the expert group holds the
    whole batch, as in JAX's engine, whose MoE layer runs the
    single-device dispatch on expert-sharded banks; both modes keep the
    single-device dispatch's positions and drops, each expert rank runs its
    own experts, and the outputs are summed over the expert group.

Under `model > 1` the experts are column-split (gate, up) and row-split
(down) over the model group; each expert's output rows are summed over the
model group before they are gated (JAX `psum` in `_dropless_dispatch_ep`),
so the gates', and so the router's, gradients are whole on every rank, and
the router reads the layer input before `copy_to_tp`, so its gradient path
is not summed over the model group.

The expert-parallel body is written once, in stages (`ep_route`,
`ep_pack`, `ep_experts`, `ep_unpack`, `ep_combine`), and driven by
`dispatch_ep` over a transport: `CollectiveEP` runs one rank of a process
group, `MemoryEP` runs every rank of a virtual group in one process with
the exchanges in memory (the smoke drives ep = 2 and 4 on one card that
way).

Padding rows (segment id 0) are routed and counted like any other row, as
in the JAX package: the layer sees no segment ids, T counts every position,
and the router's statistics (aux, z, the capacity positions and the dropped
count) include those rows. What a padding row holds is left unspecified by
the reference: its attention reads no key, and its own flash kernel calls
such a query's output "uniform garbage — callers must discard/ignore them"
(leopard_tpu/ops/pallas/flash_attention.py:121-124). So the statistics over
padding rows depend on the attention tier: the dense tier gives such a query
V's mean in both packages, and there the aux, z and dropped count equal the
JAX package's (tests/test_torch_moe_padding.py); K1 gives it 0, as the
port's ring does, where the JAX ring and dense tier give V's mean. Rows
that hold tokens route identically in every tier.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    dropless: bool = False
    aux_loss_coef: float = 1e-2
    z_loss_coef: float = 1e-3
    # the expert-parallel transport (JAX ops/moe.py:40-56): C per (source,
    # destination) pair from this factor, <= 0 the worst case (no drops);
    # or the ragged transport, exactly the routed rows
    ep_capacity_factor: float = 0.0
    ep_ragged_a2a: bool = False


def router_top_k(logits: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [T, E] fp32 → (probabilities of the selected experts [T, k],
    their ids [T, k]): softmax over every expert, then top-k."""
    return torch.topk(torch.softmax(logits, dim=-1), top_k, dim=-1)


def _shards(par) -> int:
    return 1 if par is None else par.token_shards


def load_balancing_loss(probs: torch.Tensor, expert_ids: torch.Tensor,
                        num_experts: int, par=None) -> torch.Tensor:
    """Switch-style: E · Σ_e (share of the T·k assignments to e) · (sum of
    the probabilities routed to e / T). Under a mesh, T and the shares are
    global and the probability sums this rank's: the ranks' terms add up to
    the global loss."""
    t, k = expert_ids.shape
    onehot = F.one_hot(expert_ids, num_experts).to(probs.dtype)   # [T, k, E]
    counts = onehot.sum(dim=(0, 1))
    n = _shards(par)
    if n > 1:
        counts = par.sum_over_tokens(counts.detach().clone())
    tokens_per_expert = counts / (t * n * k)
    prob_per_expert = (onehot * probs[..., None]).sum(dim=(0, 1)) / (t * n)
    return num_experts * (tokens_per_expert * prob_per_expert).sum()


def z_loss(logits: torch.Tensor, par=None) -> torch.Tensor:
    """The mean squared logsumexp; under a mesh this rank's share of the
    global mean."""
    sq = torch.logsumexp(logits, dim=-1).square()
    n = _shards(par)
    return sq.mean() if n == 1 else sq.sum() / (sq.numel() * n)


def _expert_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., n, in] × w [..., out, in]ᵀ as a batched product, never
    `aten.mm` (see the module docstring)."""
    if x.dim() == 2:
        return torch.bmm(x[None], w.transpose(-1, -2)[None])[0]
    return torch.bmm(x, w.transpose(-1, -2))


def _experts(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """SwiGLU expert(s): x [(E,) n, H] → [(E,) n, H]."""
    return _expert_mm(F.silu(_expert_mm(x, w_gate)) * _expert_mm(x, w_up), w_down)


def _grouped(x_sorted: torch.Tensor, experts: Dict[str, torch.Tensor],
             sizes: Sequence[int]) -> torch.Tensor:
    """Each expert j on its contiguous `sizes[j]` rows of `x_sorted`."""
    parts, start = [], 0
    for j, n in enumerate(sizes):
        if n:
            parts.append(_experts(x_sorted[start:start + n], experts["w_gate"][j],
                                  experts["w_up"][j], experts["w_down"][j]))
        start += n
    return torch.cat(parts) if parts else x_sorted[:0]


def _dropless_dispatch(experts: Dict[str, torch.Tensor], xt: torch.Tensor,
                       top_p: torch.Tensor, top_i: torch.Tensor, par=None) -> torch.Tensor:
    """Sort the T·k assignments by expert (stable), run each expert on its
    contiguous rows, scatter-add the gated outputs back to their tokens.
    Under tensor parallelism the rows are summed over the model group
    before the gates. With `experts` this rank's block of an expert group
    that holds the same tokens (serving, `par.ep_replicated`), the rank runs
    its experts' rows and the sorted rows are summed over the expert group
    before the gates: each row is another rank's zero, so the sum is the
    single-device dispatch's, bit for bit."""
    from leopard_tpu_torch.parallel.tensor_parallel import (
        copy_to_tp, reduce_from_ep, reduce_from_tp,
    )

    t, h = xt.shape
    k = top_i.shape[1]
    e_local = experts["w_gate"].shape[0]
    ep = 1 if par is None else par.ep_size
    e_flat = top_i.reshape(t * k)
    sort_idx = torch.sort(e_flat, stable=True).indices
    tok_idx = sort_idx // k
    x_sorted = copy_to_tp(xt, par)[tok_idx]                        # [T·k, H]
    # the one host read of the layer: each expert's row count
    sizes = torch.bincount(e_flat, minlength=e_local * ep).tolist()
    first = par.ep_rank * e_local if ep > 1 else 0
    lo, hi = sum(sizes[:first]), sum(sizes[:first + e_local])   # this rank's experts' rows
    y_sorted = _grouped(x_sorted[lo:hi], experts, sizes[first:first + e_local])
    if hi > lo:  # the same on every rank of the model group: one routing
        y_sorted = reduce_from_tp(y_sorted, par)
    if ep > 1:  # the other ranks' experts' rows, zero here, come by the sum
        y_sorted = reduce_from_ep(F.pad(y_sorted, (0, 0, lo, t * k - hi)), par)  # [T·k, H]
    gates = top_p.reshape(t * k)[sort_idx].to(y_sorted.dtype)
    out = torch.zeros((t, h), dtype=y_sorted.dtype, device=xt.device)
    return out.index_add(0, tok_idx, y_sorted * gates[:, None])


def _global_positions(top_i: torch.Tensor, num_experts: int, par, rows: int) -> torch.Tensor:
    """Each of this rank's assignments' position in its expert [T, k], a
    cumsum over the global token-major, then slot, order: the expert ids
    all-gathered over seq, fsdp and data, the cumsum taken, this rank's
    entries kept. Under the ring the sequence order is the ranks' shards
    one after another: JAX runs the whole layer stack on the sequence in
    the ring's layout (decoder.py:575-590), zig-zag included, so that is
    the order its cumsum counts in."""
    import torch.distributed as dist

    t, k = top_i.shape
    ids = top_i.reshape(rows, t // rows, k)
    for dim, (group, size) in zip((1, 0, 0), par.token_groups()):  # seq, fsdp, data
        if size > 1:
            parts = [torch.empty_like(ids) for _ in range(size)]
            dist.all_gather(parts, ids.contiguous(), group=group)
            ids = torch.cat(parts, dim=dim)
    flat = F.one_hot(ids.reshape(-1), num_experts)
    pos = ((torch.cumsum(flat, dim=0) * flat).amax(dim=-1) - 1).reshape(ids.shape)
    lo = (par.dp_rank * par.fsdp_size + par.fsdp_rank) * rows
    s = t // rows
    return pos[lo:lo + rows, par.cp_rank * s:(par.cp_rank + 1) * s].reshape(t, k)


def _capacity_dispatch(experts: Dict[str, torch.Tensor], xt: torch.Tensor,
                       top_p: torch.Tensor, top_i: torch.Tensor, capacity: int,
                       pos: Optional[torch.Tensor] = None, par=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each expert takes its first `capacity` assignments in token-major,
    slot order; the rest are dropped (gate 0). `pos` gives the positions
    (the global ones under a mesh); `experts` may be this rank's block of
    the expert axis, whose outputs are then summed over the expert group.
    Returns (out [T, H], keep [T, k])."""
    from leopard_tpu_torch.parallel.tensor_parallel import (
        copy_to_ep, copy_to_tp, reduce_from_ep, reduce_from_tp,
    )

    t, h = xt.shape
    k = top_i.shape[1]
    e_local = experts["w_gate"].shape[0]
    e = e_local if par is None else e_local * par.ep_size
    if pos is None:
        flat = F.one_hot(top_i.reshape(t * k), e)                  # [T·k, E]
        pos = ((torch.cumsum(flat, dim=0) * flat).amax(dim=-1) - 1).reshape(t, k)
    keep = pos < capacity
    gates = torch.where(keep, top_p, 0.0).to(xt.dtype)
    pos_clip = pos.clamp(max=capacity - 1)
    first = 0 if par is None else par.ep_rank * e_local
    local_i = top_i - first
    mine = keep & (local_i >= 0) & (local_i < e_local)
    local_clip = local_i.clamp(0, e_local - 1)
    xe = copy_to_ep(copy_to_tp(xt, par), par)
    expert_in = xt.new_zeros((e_local, capacity, h))
    kept = mine.reshape(-1)
    tok = torch.arange(t, device=xt.device).repeat_interleave(k)
    expert_in[local_i.reshape(-1)[kept], pos.reshape(-1)[kept]] = xe[tok[kept]]
    expert_out = _experts(expert_in, experts["w_gate"], experts["w_up"],
                          experts["w_down"])                       # [E_local, C, H]
    y = expert_out[local_clip, pos_clip]                           # [T, k, H]
    if e_local != e:
        y = torch.where(mine[..., None], y, 0.0)
    y = reduce_from_ep(reduce_from_tp(y, par), par)
    # JAX's combine einsum: exact products of the gate (in x's dtype) and
    # the output, summed in fp32, rounded once
    out = (y.float() * gates.float()[..., None]).sum(dim=1)
    return out.to(xt.dtype), keep


# ---------------------------------------------------------------- expert parallelism


def ep_capacity(tk_local: int, ep: int, cap_factor: float) -> int:
    """The dense transport's rows per (source, destination) pair, JAX's
    formula: ceil(int(cf · T_local·k) / ep) capped at T_local·k, rounded up
    to a multiple of 8 and at least 8; T_local·k (no drop) for cf <= 0."""
    if cap_factor and cap_factor > 0:
        cap = min(tk_local, -(-int(cap_factor * tk_local) // ep))
        return max(8, -(-cap // 8) * 8)
    return tk_local


class EPPlan:
    """What every rank of an expert group knows once the per-expert counts
    are exchanged: `counts[src][e]` rows that rank src routes to expert e
    (host ints, the layer's one read). `cap` None is the ragged transport."""

    def __init__(self, counts: List[List[int]], cap: Optional[int]):
        self.counts, self.cap = counts, cap
        self.ep = len(counts)
        self.e_local = len(counts[0]) // self.ep

    def send(self, src: int) -> List[int]:
        """Rows src routes to each destination rank."""
        c, el = self.counts[src], self.e_local
        return [sum(c[d * el:(d + 1) * el]) for d in range(self.ep)]

    def kept(self, src: int, dst: int) -> List[int]:
        """Rows src sends to each of dst's experts: the dense transport keeps
        the first C of the destination's rows, in expert order."""
        rows = self.counts[src][dst * self.e_local:(dst + 1) * self.e_local]
        if self.cap is None:
            return rows
        out, room = [], self.cap
        for n in rows:
            out.append(min(n, room))
            room -= out[-1]
        return out

    def in_splits(self, src: int) -> List[int]:
        return [self.cap] * self.ep if self.cap is not None else self.send(src)

    def out_splits(self, dst: int) -> List[int]:
        return ([self.cap] * self.ep if self.cap is not None
                else [self.send(i)[dst] for i in range(self.ep)])

    def received(self, dst: int) -> List[int]:
        """Rows dst's experts receive, per local expert."""
        return [sum(col) for col in zip(*(self.kept(i, dst) for i in range(self.ep)))]

    @property
    def dropped(self) -> int:
        """Rows the dense transport drops over the whole group."""
        if self.cap is None:
            return 0
        return sum(max(n - self.cap, 0) for i in range(self.ep) for n in self.send(i))


def ep_route(xt: torch.Tensor, top_i: torch.Tensor):
    """Stage 1 of a rank: its T·k assignments sorted by global expert id
    (stable), so they are contiguous by destination rank. Returns
    (sorted ids [T·k], sort permutation [T·k], sorted rows [T·k, H])."""
    k = top_i.shape[1]
    sort_eid, sort_idx = torch.sort(top_i.reshape(-1), stable=True)
    return sort_eid, sort_idx, xt[sort_idx // k]


def ep_pack(plan: EPPlan, src: int, sort_eid, x_sorted, e: int):
    """Stage 2: the rows (and their expert ids) to send. Dense: [ep·C]
    buckets, bucket d the first C rows for rank d, the rest zero rows with
    id `e`; returns also each bucket row's source row, `tk` where empty.
    Ragged: the sorted rows themselves."""
    if plan.cap is None:
        return x_sorted, sort_eid, None
    tk = x_sorted.shape[0]
    dev = x_sorted.device
    send = torch.tensor(plan.send(src), device=dev)
    off = torch.cumsum(send, 0) - send
    c_iota = torch.arange(plan.cap, device=dev)[None, :]
    valid = c_iota < send.clamp(max=plan.cap)[:, None]                 # [ep, C]
    take = (off[:, None] + c_iota).clamp(max=max(tk - 1, 0)).reshape(-1)
    v = valid.reshape(-1)
    x_send = torch.where(v[:, None], x_sorted[take], 0.0)
    id_send = torch.where(v, sort_eid[take], e)
    return x_send, id_send, torch.where(v, take, tk)


def ep_experts(plan: EPPlan, dst: int, x_recv, id_recv, experts: Dict[str, torch.Tensor],
               par=None):
    """Stage 3: rank dst's experts on the rows it received, re-sorted by
    expert id (stable; padding, id E, last), summed over the model group,
    back in received order (zero rows for padding)."""
    from leopard_tpu_torch.parallel.tensor_parallel import copy_to_tp, reduce_from_tp

    sizes = plan.received(dst)
    n = sum(sizes)
    perm = torch.sort(id_recv, stable=True).indices[:n]
    y = reduce_from_tp(_grouped(copy_to_tp(x_recv, par)[perm], experts, sizes), par)
    return x_recv.new_zeros((x_recv.shape[0], y.shape[1]), dtype=y.dtype).index_copy(0, perm, y)


def ep_unpack(y_back: torch.Tensor, src_row: Optional[torch.Tensor], tk: int) -> torch.Tensor:
    """Stage 4: the returned rows in the sender's sorted order [T·k, H];
    the dense transport's dropped rows are zero."""
    if src_row is None:
        return y_back
    return y_back.new_zeros((tk + 1, y_back.shape[1])).index_add(0, src_row, y_back)[:tk]


def ep_combine(y_sorted, top_p, sort_idx, k: int) -> torch.Tensor:
    """Stage 5: the gated rows scatter-added to their tokens [T, H]."""
    tk, h = y_sorted.shape
    gates = top_p.reshape(tk)[sort_idx].to(y_sorted.dtype)
    out = y_sorted.new_zeros((tk // k, h))
    return out.index_add(0, sort_idx // k, y_sorted * gates[:, None])


class CollectiveEP:
    """One rank of an expert group of processes."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.n, self.local = group, size, (rank,)

    def gather(self, counts: Dict[int, torch.Tensor]) -> torch.Tensor:
        import torch.distributed as dist

        (mine,) = counts.values()
        parts = [torch.empty_like(mine) for _ in range(self.n)]
        dist.all_gather(parts, mine.contiguous(), group=self.group)
        return torch.stack(parts)

    def all_to_all(self, xs, in_splits, out_splits):
        from leopard_tpu_torch.parallel.tensor_parallel import all_to_all_ep

        return {r: all_to_all_ep(xs[r], self.group, in_splits[r], out_splits[r])
                for r in self.local}


class MemoryEP:
    """Every rank of a virtual expert group of `n`, in this process: the
    exchanges are slices and concatenations in memory."""

    def __init__(self, n: int):
        self.n, self.local = n, tuple(range(n))

    def gather(self, counts: Dict[int, torch.Tensor]) -> torch.Tensor:
        return torch.stack([counts[r] for r in range(self.n)])

    def all_to_all(self, xs, in_splits, out_splits):
        parts = {r: xs[r].split(list(in_splits[r])) for r in self.local}
        out = {d: torch.cat([parts[i][d] for i in self.local]) for d in self.local}
        for d in self.local:
            assert out[d].shape[0] == sum(out_splits[d]), "the splits disagree"
        return out


def dispatch_ep(transport, experts: Dict[int, Dict[str, torch.Tensor]], xs, top_ps, top_is,
                num_experts: int, cap: Optional[int], par=None):
    """The expert-parallel dispatch of every rank the transport runs here
    (one of a process group, or all of a virtual one): rank r's tokens
    `xs[r]` [T_r, H] with their gates and expert ids [T_r, k], its experts
    `experts[r]` (the block r · E/ep onwards). `cap` None is the ragged
    transport. Returns ({r: out [T_r, H]}, the group's dropped rows)."""
    local = transport.local
    k = next(iter(top_is.values())).shape[1]
    routes = {r: ep_route(xs[r], top_is[r]) for r in local}
    counts = transport.gather({r: torch.bincount(top_is[r].reshape(-1), minlength=num_experts)
                               for r in local})
    plan = EPPlan(counts.tolist(), cap)  # the layer's one host read
    packed = {r: ep_pack(plan, r, routes[r][0], routes[r][2], num_experts) for r in local}
    ins = {r: plan.in_splits(r) for r in local}
    outs = {r: plan.out_splits(r) for r in local}
    x_recv = transport.all_to_all({r: p[0] for r, p in packed.items()}, ins, outs)
    id_recv = transport.all_to_all({r: p[1] for r, p in packed.items()}, ins, outs)
    y = {r: ep_experts(plan, r, x_recv[r], id_recv[r], experts[r], par) for r in local}
    y_back = transport.all_to_all(y, outs, ins)
    out = {}
    for r in local:
        y_sorted = ep_unpack(y_back[r], packed[r][2], routes[r][2].shape[0])
        out[r] = ep_combine(y_sorted, top_ps[r], routes[r][1], k)
    return out, plan.dropped


def _dispatch_ep_mesh(experts, xt, top_p, top_i, cfg: MoEConfig, par, t_global: int):
    """This rank's part of the mesh's expert-parallel dropless dispatch
    (JAX `_dropless_dispatch_ep`). Returns (out [T, H], the dropped rows of
    this rank's expert group)."""
    from leopard_tpu_torch.parallel.tensor_parallel import gather_from_ep, split_to_ep

    e, k, ep = cfg.num_experts, cfg.top_k, par.ep_size
    n_shards = par.token_shards * ep
    axes = ("data", "fsdp", "seq", "expert")
    if t_global % n_shards:
        raise ValueError(f"B·S = {t_global} tokens must divide over the {n_shards} token "
                         f"shards (mesh axes {axes}) for expert-parallel dispatch")
    if e % ep:
        raise ValueError(f"{e} experts must divide over expert-axis size {ep}")
    t = xt.shape[0]
    cap = None if cfg.ep_ragged_a2a else ep_capacity((t // ep) * k, ep, cfg.ep_capacity_factor)
    lo = par.ep_rank * (t // ep)
    me = par.ep_rank
    out, dropped = dispatch_ep(
        CollectiveEP(par.ep_group, ep, me), {me: experts}, {me: split_to_ep(xt, par)},
        {me: split_to_ep(top_p, par)}, {me: top_i[lo:lo + t // ep]}, e, cap, par)
    return gather_from_ep(out[me], par), dropped


def moe_layer(router_w: torch.Tensor, experts: Dict[str, torch.Tensor], cfg: MoEConfig,
              x: torch.Tensor, par=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, H] → (output [B, S, H] in x's dtype, {aux_loss, z_loss,
    fraction_dropped}), the losses already scaled by their coefficients.
    Under a mesh (`par`; `experts` this rank's shards) aux_loss and z_loss
    are this rank's terms of the global losses, and fraction_dropped is the
    global share."""
    b, s, h = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.top_k
    n = _shards(par)
    t_global = t * n
    xt = x.reshape(t, h)

    logits = xt.float() @ router_w.float().t()                    # [T, E]
    top_p, top_i = router_top_k(logits, k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    aux = {"aux_loss": cfg.aux_loss_coef * load_balancing_loss(top_p, top_i, e, par),
           "z_loss": cfg.z_loss_coef * z_loss(logits, par)}

    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.dropless and par is not None and par.ep_size > 1 and not par.ep_replicated:
        out, dropped = _dispatch_ep_mesh(experts, xt, top_p, top_i, cfg, par, t_global)
        count = par.sum_over_tokens(zero + dropped)
        aux["fraction_dropped"] = count / (t_global * k)
    elif cfg.dropless:
        out = _dropless_dispatch(experts, xt, top_p, top_i, par)
        aux["fraction_dropped"] = zero
    else:
        capacity = int(max(1, cfg.capacity_factor * t_global * k / e))
        pos = None if n == 1 else _global_positions(top_i, e, par, b)
        out, keep = _capacity_dispatch(experts, xt, top_p, top_i, capacity, pos, par)
        if n == 1:
            aux["fraction_dropped"] = 1.0 - keep.float().mean()
        else:  # JAX's 1 − mean(keep) over the global batch
            aux["fraction_dropped"] = 1.0 - par.sum_over_tokens(keep.float().sum()) / (
                t_global * k)
    return out.reshape(b, s, h).to(x.dtype), aux
