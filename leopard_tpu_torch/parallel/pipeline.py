"""Pipeline parallelism over the "stage" axis (port of
leopard_tpu/parallel/pipeline.py).

The JAX package runs a pipeline as one SPMD program: the stage layers are
sharded over the "stage" mesh axis, microbatches stream through a
`lax.scan`, and a `ppermute` at the end of each tick moves activations up
and gradients down. The port runs one process per stage, so every stage
rank executes the same tick arithmetic and the exchange between neighbours
is explicit:

  - `schedule_1f1b(n, v, M)`: for each tick and stage, the forward and the
    backward it runs, each a (microbatch, chunk) or None, from the JAX
    formulas (`num_ticks`, `buffer_slots`, `forward_at`, `backward_at`);
  - `pipeline_1f1b`: the 1F1B schedule, interleaved when v > 1, with the
    loss head fused into the last stage's forward tick and the backward
    recomputing each stage forward from a ring buffer of saved inputs;
  - `pipeline_apply`: the GPipe forward;
  - `split_stages` / `merge_stages` and their interleaved forms: which
    layers each (chunk, stage) holds, and back.

The exchange is a parameter, as the ring's rotation is in
context_parallel.py: `P2PStages` sends to the neighbouring stage ranks by
`dist.batch_isend_irecv` (production), and `MemoryStages` runs n virtual
stages in one process (a check). A transport has:

  - `n`, the stage count, and `local`, the stages this process runs;
  - `exchange(up, down, want_act, want_grad, like)`: at the end of a tick,
    each local stage d sends `up[d]` to stage d + 1 and `down[d]` to stage
    d - 1 (both mod n: the n - 1 → 0 activation hop is the chunk c → c + 1
    hand-off, the 0 → n - 1 gradient hop chunk c → c - 1); it returns,
    per local stage, what its predecessor sent up and its successor sent
    down where `want_act` / `want_grad` ask for it (else None). Every
    stage rank knows the schedule, so sends and receives pair up without
    messages about them;
  - `reduce(t)`: `t` summed over the stages (in place).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Step = Optional[Tuple[int, int]]   # (microbatch, chunk), or None: no work this tick


# ---- the schedule (JAX pipeline.py:139-144, 198-205, 259-270) ----

def num_ticks(n: int, v: int, m_total: int) -> int:
    """Ticks of the schedule: the last is the backward of microbatch
    M − 1 = q·n + r at global stage 0, q·v·n + (2v − 2)·n + r + 2(n − 1);
    v·M + v·n + n − 2 ticks when n divides M."""
    q_last, r_last = divmod(m_total - 1, n)
    return q_last * v * n + (2 * v - 2) * n + r_last + 2 * (n - 1) + 1


def buffer_slots(n: int, v: int) -> int:
    """Saved stage inputs a stage keeps for its recompute: 2vn − 1."""
    return max(2 * v * n - 1, 1)


def slot_key(m: int, c: int, n: int, v: int) -> int:
    """u = q·v·n + c·n + r for microbatch m = q·n + r in chunk c: the index
    by which stage d runs that forward at tick u + d."""
    q, r = divmod(m, n)
    return (q * v + c) * n + r


def forward_at(t: int, d: int, n: int, v: int, m_total: int) -> Step:
    """The forward that stage d runs at tick t: u = t − d decodes as
    u = q·v·n + c·n + r, microbatch q·n + r in chunk c."""
    u = t - d
    if u < 0:
        return None
    uq, ur = divmod(u, n)
    m = (uq // v) * n + ur
    return (m, uq % v) if m < m_total else None


def backward_at(t: int, d: int, n: int, v: int, m_total: int) -> Step:
    """The backward that stage d runs at tick t: wb = t − 2(n − 1) + d
    decodes as wb = q·v·n + (2v − 2 − c)·n + r (the chunks in reverse)."""
    wb = t - 2 * (n - 1) + d
    if wb < 0:
        return None
    wq, wr = divmod(wb, n)
    c = (2 * v - 2 - wq) % v
    q = (wq - (2 * v - 2 - c)) // v
    m = q * n + wr
    return (m, c) if q >= 0 and m < m_total else None


def schedule_1f1b(n: int, v: int, m_total: int) -> List[List[Tuple[Step, Step]]]:
    """[tick][stage] → (forward, backward). At v = 1, plain 1F1B: the
    forward of microbatch m at stage s on tick m + s, its backward on tick
    m + 2(n − 1) − s."""
    return [[(forward_at(t, d, n, v, m_total), backward_at(t, d, n, v, m_total))
             for d in range(n)] for t in range(num_ticks(n, v, m_total))]


def _first(d: int, c: int) -> bool:
    """Global stage 0: reads the microbatch stream, writes d_xs."""
    return d == 0 and c == 0


def _last(d: int, c: int, n: int, v: int) -> bool:
    """The last global stage: feeds the loss head."""
    return d == n - 1 and c == v - 1


# ---- the transports ----

class MemoryStages:
    """n virtual stages in one process: stage d at tick t reads what stage
    d − 1 (or d + 1) handed over at the end of tick t − 1. Each exchange
    also checks that every hand-off has exactly one reader, which the P2P
    transport relies on. A check of the schedule and of its arithmetic on
    one device, never a production path: the stages run one after another."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"need at least one stage, not {n}")
        self.n = n
        self.local = tuple(range(n))

    def exchange(self, up, down, want_act, want_grad, like):
        n = self.n
        for what, sent, want, hop in (("activation", up, want_act, 1),
                                      ("gradient", down, want_grad, -1)):
            senders = {(d + hop) % n for d, x in sent.items() if x is not None}
            readers = {d for d in self.local if want[d]}
            if senders != readers:
                raise RuntimeError(f"pipeline schedule: {what}s sent to stages {sorted(senders)} "
                                   f"but read by {sorted(readers)}")
        acts = {d: up[(d - 1) % n] if want_act[d] else None for d in self.local}
        grads = {d: down[(d + 1) % n] if want_grad[d] else None for d in self.local}
        return acts, grads

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        return t   # every stage's contribution is already in the one process's sum


class P2PStages:
    """This rank's stage of the mesh's "stage" group: activations go to
    the next stage rank and gradients to the previous one, both rings
    wrapping around, by `dist.batch_isend_irecv` (tag 0 activations, tag 1
    gradients, posted in that order on both sides: at n = 2 both go to the
    same peer). The constructor runs one all-reduce over the group, since
    NCCL wants the first collective of a group to involve all its ranks,
    and a tick's exchange may involve only some."""

    def __init__(self, group, stage: int, ranks: Sequence[int]):
        self.group = group
        self.n = len(ranks)
        self.stage = stage
        self.local = (stage,)
        self.next = ranks[(stage + 1) % self.n]
        self.prev = ranks[(stage - 1) % self.n]
        dist.all_reduce(torch.zeros(1, device=_group_device(group)), group=group)

    @staticmethod
    def of(mesh) -> "P2PStages":
        from leopard_tpu_torch.parallel.mesh import STAGE_AXIS, axis_coord, axis_group, axis_size

        group = axis_group(mesh, STAGE_AXIS)
        n = axis_size(mesh, STAGE_AXIS)
        return P2PStages(group, axis_coord(mesh, STAGE_AXIS),
                         [dist.get_global_rank(group, i) for i in range(n)])

    def exchange(self, up, down, want_act, want_grad, like):
        d = self.stage
        ops, act, grad = [], None, None
        if up.get(d) is not None:
            ops.append(dist.P2POp(dist.isend, up[d].contiguous(), self.next, self.group, 0))
        if down.get(d) is not None:
            ops.append(dist.P2POp(dist.isend, down[d].contiguous(), self.prev, self.group, 1))
        if want_act[d]:
            act = torch.empty(like.shape, dtype=like.dtype, device=like.device)
            ops.append(dist.P2POp(dist.irecv, act, self.prev, self.group, 0))
        if want_grad[d]:
            grad = torch.empty(like.shape, dtype=like.dtype, device=like.device)
            ops.append(dist.P2POp(dist.irecv, grad, self.next, self.group, 1))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return {d: act}, {d: grad}

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, group=self.group)
        return t


def _group_device(group) -> torch.device:
    backend = dist.get_backend(group)
    return torch.device("cuda", torch.cuda.current_device()) if backend == "nccl" \
        else torch.device("cpu")


# ---- the schedules ----

def _leaves(params) -> Dict[str, torch.Tensor]:
    """The differentiable tensors of a chunk or of the head: a module's
    parameters or a dict's tensors, those that require grad."""
    items = params.named_parameters() if isinstance(params, torch.nn.Module) else params.items()
    return {k: p for k, p in items if p.requires_grad}


def _zeros32(leaves: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in leaves.items()}


def _vjp(fn: Callable, x: torch.Tensor, leaves: Mapping[str, torch.Tensor], seed=None):
    """Run fn(x) under autograd and differentiate its output (the first
    item of a tuple) against `seed`: (fn's output detached, d input,
    {name: d leaf} for the leaves it reached)."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        out = fn(x)
    first = out[0] if isinstance(out, tuple) else out
    grads = torch.autograd.grad(first, [x, *leaves.values()], grad_outputs=seed,
                                allow_unused=True)
    out = tuple(o.detach() for o in out) if isinstance(out, tuple) else out.detach()
    return out, grads[0], {k: g for k, g in zip(leaves, grads[1:]) if g is not None}


def pipeline_1f1b(
    layer_fn: Callable,        # (chunk params, x [mb, ...], aux of the microbatch) → y
    head_fn: Callable,         # (head params, y, aux of the microbatch) → (nll_sum, w_sum)
    stage_params: Mapping[int, Sequence],   # local stage d → its v chunks (c = 0..v-1)
    head_params: Mapping[str, torch.Tensor],
    xs: torch.Tensor,          # [M, mb, ...] global stage 0's inputs
    aux: Sequence[Mapping],    # one dict of constants per microbatch
    stages,                    # MemoryStages or P2PStages
    v_chunks: int = 1,
    seq_group=None,            # the CP group when layer_fn runs on sequence shards
) -> dict:
    """The 1F1B schedule with the loss head fused (JAX pipeline.py:83-347).

    Each tick, each local stage runs at most one forward and one backward:
      - forward of (m, c): under no_grad, from the stream (global stage 0)
        or from what the previous stage handed over; its input is saved in
        a ring buffer of `buffer_slots` slots keyed by `slot_key`;
      - at the last global stage the head runs on that output under
        autograd, its (nll, w) summed, its gradient accumulated, and its dy
        seeds the same tick's backward;
      - backward of (m, c): the stage forward recomputed from the saved
        input under autograd, then `torch.autograd.grad` with the incoming
        gradient (JAX's `jax.vjp` recompute).
    A chunk is a module (its parameters) or a dict of tensors; gradients
    are taken for the tensors that require grad and accumulated in fp32.

    Returns {nll_sum, w_sum, d_stage {d: [{name: grad} per chunk]}, d_head,
    d_xs [M, mb, ...]}: the loss sums and d_head summed over the stages and,
    with `seq_group`, over the sequence shards; d_xs (global stage 0's input
    gradients) over the stages only, so it stays sequence-sharded; d_stage
    over the sequence shards only. nll_sum is unnormalized: the caller
    divides by the total weight."""
    n, v, m_total = stages.n, v_chunks, len(xs)
    slots = buffer_slots(n, v)
    local = stages.local
    chunk_leaves = {d: [_leaves(ch) for ch in stage_params[d]] for d in local}
    for d in local:
        if len(stage_params[d]) != v:
            raise ValueError(f"stage {d} holds {len(stage_params[d])} chunks, not v = {v}")
    head_leaves = _leaves(head_params)
    d_stage = {d: [_zeros32(lv) for lv in chunk_leaves[d]] for d in local}
    d_head = _zeros32(head_leaves)
    f32 = dict(dtype=torch.float32, device=xs.device)
    nll, w = torch.zeros((), **f32), torch.zeros((), **f32)
    d_xs = torch.zeros_like(xs)
    saved = {d: [None] * slots for d in local}
    acts = {d: None for d in local}
    grads = {d: None for d in local}
    ticks = num_ticks(n, v, m_total)
    for t in range(ticks):
        up, down = {}, {}
        for d in local:
            dy = None
            fwd = forward_at(t, d, n, v, m_total)
            if fwd is not None:
                m, c = fwd
                x = xs[m] if _first(d, c) else acts[d]
                with torch.no_grad():
                    y = layer_fn(stage_params[d][c], x, aux[m])
                saved[d][slot_key(m, c, n, v) % slots] = (m, c, x)
                if _last(d, c, n, v):   # the fused head; its dy seeds this tick's backward
                    (nll_m, w_m), dy, g_head = _vjp(
                        lambda y_, a=aux[m]: head_fn(head_params, y_, a), y, head_leaves)
                    nll, w = nll + nll_m.float(), w + w_m.float()
                    for k, g in g_head.items():
                        d_head[k] += g.float()
                else:
                    up[d] = y
            bwd = backward_at(t, d, n, v, m_total)
            if bwd is not None:
                m, c = bwd
                sm, sc, x = saved[d][slot_key(m, c, n, v) % slots]
                if (sm, sc) != (m, c):
                    raise RuntimeError(f"stage {d}, tick {t}: the saved input of microbatch {m} "
                                       f"chunk {c} was overwritten by ({sm}, {sc})")
                seed = dy if _last(d, c, n, v) else grads[d]
                _, dx, g_p = _vjp(lambda x_, p=stage_params[d][c], a=aux[m]: layer_fn(p, x_, a),
                                  x, chunk_leaves[d][c], seed)
                for k, g in g_p.items():
                    d_stage[d][c][k] += g.float()
                if _first(d, c):
                    d_xs[m] = dx
                else:
                    down[d] = dx
        if t + 1 < ticks:
            want_act, want_grad = {}, {}
            for d in local:
                f, b = forward_at(t + 1, d, n, v, m_total), backward_at(t + 1, d, n, v, m_total)
                want_act[d] = f is not None and not _first(d, f[1])
                want_grad[d] = b is not None and not _last(d, b[1], n, v)
            acts, grads = stages.exchange(up, down, want_act, want_grad, xs[0])
    nll, w = stages.reduce(nll), stages.reduce(w)
    d_head = {k: stages.reduce(g) for k, g in d_head.items()}
    d_xs = stages.reduce(d_xs)
    if seq_group is not None:
        for tensor in (nll, w, *d_head.values(),
                       *(g for d in local for ch in d_stage[d] for g in ch.values())):
            dist.all_reduce(tensor, group=seq_group)
    return {"nll_sum": nll, "w_sum": w, "d_stage": d_stage, "d_head": d_head, "d_xs": d_xs}


def pipeline_apply(
    layer_fn: Callable,                 # (stage params, x [mb, ...]) → y
    stage_params: Mapping[int, object],  # local stage d → its params
    microbatches: torch.Tensor,         # [M, mb, ...]
    stages,
) -> torch.Tensor:
    """The GPipe forward (JAX pipeline.py:27-80): microbatch m enters stage
    0 at tick m and leaves stage n − 1 at tick m + n − 1. Returns the last
    stage's outputs [M, mb, ...] on every stage rank. With MemoryStages the
    result is differentiable; P2PStages' hops are not."""
    n, m_total = stages.n, len(microbatches)
    outs = [None] * m_total
    acts = {d: None for d in stages.local}
    ticks = m_total + n - 1
    for t in range(ticks):
        up = {}
        for d in stages.local:
            m = t - d
            if 0 <= m < m_total:
                y = layer_fn(stage_params[d], microbatches[m] if d == 0 else acts[d])
                if d == n - 1:
                    outs[m] = y
                else:
                    up[d] = y
        if t + 1 < ticks:
            want = {d: d > 0 and 0 <= t + 1 - d < m_total for d in stages.local}
            acts, _ = stages.exchange(up, {}, want, {d: False for d in stages.local},
                                      microbatches[0])
    if n - 1 in stages.local:
        out = torch.stack(outs)
    else:
        out = torch.zeros_like(microbatches)
    return stages.reduce(out)


# ---- stage splitting (JAX pipeline.py:350-384) ----

def split_stages(items, n_stages: int) -> list:
    """[L, ...] → n_stages pieces of L/n_stages along the first axis: a
    list, range, ModuleList or tensor is cut, a dict of them piecewise."""
    if isinstance(items, Mapping):
        per = {k: split_stages(x, n_stages) for k, x in items.items()}
        return [{k: per[k][s] for k in items} for s in range(n_stages)]
    total = len(items)
    if total % n_stages:
        raise ValueError(f"{total} layers not divisible by {n_stages} stages")
    size = total // n_stages
    return [items[s * size:(s + 1) * size] for s in range(n_stages)]


def merge_stages(pieces: Sequence) -> object:
    """Inverse of split_stages: the pieces concatenated in order."""
    first = pieces[0]
    if isinstance(first, Mapping):
        return {k: merge_stages([p[k] for p in pieces]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.cat(list(pieces))
    return [x for p in pieces for x in p]


def split_stages_interleaved(items, n_devices: int, v_chunks: int) -> list:
    """[L, ...] → [v][n] pieces of L/(v·n): piece [c][d] holds the layers of
    global stage c·n + d, so stage d holds v non-contiguous blocks (Megatron's
    interleaved virtual-pipeline assignment)."""
    flat = split_stages(items, n_devices * v_chunks)
    return [flat[c * n_devices:(c + 1) * n_devices] for c in range(v_chunks)]


def merge_stages_interleaved(chunked: Sequence[Sequence]) -> object:
    """Inverse of split_stages_interleaved: [v][n] pieces → [L, ...]."""
    return merge_stages([p for row in chunked for p in row])
