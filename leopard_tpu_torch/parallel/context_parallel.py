"""Context parallelism: ring attention over the "seq" axis (port of
leopard_tpu/parallel/context_parallel.py).

Each rank of the seq group holds a shard of the sequence. Its queries meet
every rank's keys and values as these rotate around the ring: at step t,
rank r holds the KV of rank (r - t) mod n. The JAX package computes each
block with a plain fp32 einsum inside an online softmax. On a GPU, CP runs
each block through the flash kernels:

  - forward: each block goes through K1 with its logsumexp, and the blocks
    of one query row merge in fp32 by their lse values;
  - backward: each block goes through K2 with the merged out and lse; dq
    accumulates locally, and dk/dv accumulate in an fp32 buffer that
    travels with the KV and arrives home after n hops.

On a CPU tensor each block is the plain version of the same (out, lse) and
gradients, dense in fp32. A block reads the window in global positions: its
q chunk lies `offset` positions after its kv chunk, and K1/K2 take that q −
kv offset (ops/flash_attention.py), so Mistral's window runs on the card as
on the CPU (JAX context_parallel.py:95-98 masks q_pos − k_pos < window in
every block). A block wholly outside the window is not run, as a block
wholly in the future is not; a partial one leaves some rows with no key,
whose (out, lse) = (0, -1e30) merge away.

Layouts (the sequence split into chunks; rank r holds):
  - "zigzag" (causal): chunks r and 2n − 1 − r of 2n, so every rank does the
    same work: 2n + 1 blocks a pass, about half the contiguous layout's
    masked work (the JAX package's balanced schedule);
  - "contiguous": chunk r of n; a causal pass skips the n − 1 − r blocks
    that lie wholly in the future.

A block pairs one q chunk with one kv chunk: "diag" (the same chunk: causal
inside), or "full" (a kv chunk wholly in the q chunk's past, or any pair
when not causal).

The rotation is a parameter of the per-rank bodies (`ring_forward`,
`ring_backward`): `P2PRing` moves shards between processes by
`dist.batch_isend_irecv`; `MemoryRing` reads the other ranks' shards from
memory, so that one process can run n virtual ranks and hold the block
arithmetic against one kernel call over the whole sequence. That is a
check, never a production path.

The JAX package's `ring_attention_local` (the pipeline's PP × CP
composition: a contiguous ring on local shards inside the pipeline's
shard_map) is `ring_attention(..., layout="contiguous")` here, which is
process-local already: training/pp.py runs it in every stage's layers over
the stage rank's seq group.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from leopard_tpu_torch.ops.attention import NEG_INF

LAYOUTS = ("zigzag", "contiguous")


def zigzag_indices(s: int, n: int):
    """The zig-zag layout for n CP ranks (the JAX function, copied): S in
    2n chunks of c = S/(2n); rank d holds chunks (d, 2n-1-d). Returns
    (perm, inv): x_zigzag = x[perm], x = x_zigzag[inv]."""
    c = s // (2 * n)
    perm = np.concatenate([
        np.r_[d * c:(d + 1) * c, (2 * n - 1 - d) * c:(2 * n - d) * c] for d in range(n)
    ])
    return perm, np.argsort(perm)


def pick_layout(s: int, n: int, causal: bool = True, layout: str = "zigzag") -> str:
    """The layout a ring of n takes at length s: zig-zag where it applies
    (causal, S a multiple of 2n, n > 1), else contiguous (S a multiple of
    n), as the JAX `ring_attention` falls back."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, not {layout!r}")
    if layout == "zigzag" and causal and n > 1 and s % (2 * n) == 0:
        return "zigzag"
    if s % n:
        raise ValueError(f"sequence of {s} does not split over {n} ranks")
    return "contiguous"


def local_positions(s: int, n: int, rank: int, layout: str) -> torch.Tensor:
    """The global positions that `rank` holds, in its local order."""
    if layout == "zigzag":
        perm, _ = zigzag_indices(s, n)
        c2 = s // n
        return torch.from_numpy(perm[rank * c2:(rank + 1) * c2].copy())
    c = s // n
    return torch.arange(rank * c, (rank + 1) * c)


def _chunks(n: int, rank: int, s_local: int, layout: str) -> List[Tuple[int, int, int]]:
    """(global chunk index, local start, length) of the chunks `rank` holds."""
    if layout == "zigzag":
        c = s_local // 2
        return [(rank, 0, c), (2 * n - 1 - rank, c, c)]
    return [(rank, 0, s_local)]


def schedule(n: int, rank: int, src: int, s_local: int, layout: str, causal: bool,
             window: Optional[int] = None):
    """The blocks of one ring step: [(q start, kv start, length, kind,
    q − kv offset)], kind "diag" or "full"; blocks wholly in the future
    are left out, and with a window those wholly before it (every pair at
    q − kv ≥ window: offset − (length − 1) ≥ window)."""
    out = []
    for qc, qs, ln in _chunks(n, rank, s_local, layout):
        for kc, ks, _ in _chunks(n, src, s_local, layout):
            if causal and kc > qc:
                continue
            offset = (qc - kc) * ln
            if window is not None and offset - (ln - 1) >= window:
                continue
            kind = "diag" if causal and kc == qc else "full"
            out.append((qs, ks, ln, kind, offset))
    return out


def ring_blocks(n: int, layout: str, causal: bool = True, window: Optional[int] = None,
                s: Optional[int] = None) -> int:
    """Blocks of one ring pass over all n ranks (K1 launches forward, K2
    backward): zig-zag n(2n + 1), 2n + 1 on every rank; contiguous causal
    n(n + 1)/2, r + 1 on rank r; n² when not causal. With a window, the
    blocks `schedule` keeps at sequence length `s`."""
    if window is not None:
        if s is None:
            raise ValueError("a windowed ring's blocks depend on the length: pass s")
        return sum(len(schedule(n, r, (r - t) % n, s // n, layout, causal, window))
                   for r in range(n) for t in range(n))
    if layout == "zigzag":
        return n * (2 * n + 1)
    return n * (n + 1) // 2 if causal else n * n


# ---- one block: (out, lse) forward, (dq, dk, dv) backward ----

def _block_mask(q_seg, kv_seg, sq, skv, causal, window, offset, device):
    """[B|1, 1, 1, Sq, Skv] bool: which pairs of the block attend, in local
    coordinates shifted by the block's q − kv offset."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    kj = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (qi >= kj)
    if window is not None:
        mask = mask & (qi - kj < window)
    mask = mask[None]
    if q_seg is not None:
        mask = mask & ((q_seg[:, :, None] == kv_seg[:, None, :]) & (q_seg != 0)[:, :, None]
                       & (kv_seg != 0)[:, None, :])
    return mask[:, None, None]


def _plain_fwd(q, k, v, mask):
    """Dense fp32 (out [B, Sq, Hq, D], lse [B, Hq, Sq]); a row with no
    attended pair gets out 0 and lse -1e30, as K1 gives it."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * d**-0.5
    s = s.masked_fill(~mask, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    lse = torch.where(mask.any(-1), lse, NEG_INF)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float()).reshape(b, sq, hq, d)
    return out, lse.reshape(b, hq, sq)


def _plain_bwd(q, k, v, mask, out, lse, dout):
    """K2's formulas, dense in fp32: (dq, dk, dv) fp32."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * d**-0.5
    p = torch.where(mask, torch.exp(s - lse.float().reshape(b, hkv, g, sq, 1)), 0.0)
    do = dout.float().reshape(b, sq, hkv, g, d)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).reshape(b, hkv, g, sq, 1)
    ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", do, v.float()) - delta) * d**-0.5
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()).reshape(b, sq, hq, d)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    return dq, dk, dv


def block_forward(q, k, v, q_seg, kv_seg, kind, window, offset):
    """One block's (out, lse [B, Hq, Sq] fp32): K1 on a CUDA tensor, the
    plain version on a CPU tensor."""
    if q.device.type == "cpu":
        mask = _block_mask(q_seg, kv_seg, q.shape[1], k.shape[1], kind == "diag", window,
                           offset, q.device)
        return _plain_fwd(q, k, v, mask)
    from leopard_tpu_torch.ops import flash_attention as fa

    return fa._launch(q, k, v, causal=kind == "diag", q_segment_ids=q_seg,
                      kv_segment_ids=kv_seg, sliding_window=window, with_lse=True,
                      q_offset=offset)


def block_backward(q, k, v, q_seg, kv_seg, out, lse, dout, kind, window, offset):
    """One block's (dq, dk, dv) from the merged out and lse: K2 on a CUDA
    tensor (bf16), the plain version on a CPU tensor (fp32)."""
    if q.device.type == "cpu":
        mask = _block_mask(q_seg, kv_seg, q.shape[1], k.shape[1], kind == "diag", window,
                           offset, q.device)
        return _plain_bwd(q, k, v, mask, out, lse, dout)
    from leopard_tpu_torch.ops import flash_attention as fa

    return fa._launch_bwd(q, k, v, q_seg, kv_seg, out, lse.contiguous(), dout,
                          causal=kind == "diag", sliding_window=window, q_offset=offset)


# ---- the rotations ----

class MemoryRing:
    """n virtual ranks in one process: rank r's step t reads the shards of
    rank (r - t) mod n from memory, and gradient contributions are added
    into fp32 buffers by owner. `view(r)` is rank r's rotation; rank r's
    dk/dv (`dk[r]`, `dv[r]`) are whole once every rank's backward ran."""

    def __init__(self, ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                 segs: Optional[Sequence[torch.Tensor]] = None):
        self.ks, self.vs = list(ks), list(vs)
        self.segs = list(segs) if segs is not None else [None] * len(ks)
        self.n = len(ks)
        self.dk = [torch.zeros(k.shape, dtype=torch.float32, device=k.device) for k in ks]
        self.dv = [torch.zeros(v.shape, dtype=torch.float32, device=v.device) for v in vs]

    def view(self, rank: int) -> "_MemoryView":
        return _MemoryView(self, rank)


class _MemoryView:
    def __init__(self, ring: MemoryRing, rank: int):
        self.ring, self.rank = ring, rank

    def kv(self, t: int):
        src = (self.rank - t) % self.ring.n
        return self.ring.ks[src], self.ring.vs[src], self.ring.segs[src]

    def add_grads(self, t: int, dk: torch.Tensor, dv: torch.Tensor) -> None:
        src = (self.rank - t) % self.ring.n
        self.ring.dk[src] += dk
        self.ring.dv[src] += dv

    def grads(self):
        return self.ring.dk[self.rank], self.ring.dv[self.rank]


class P2PRing:
    """The KV rotation between processes: at step t ≥ 1 this rank receives
    the shards its predecessor held at step t − 1 and sends on its own, by
    `dist.batch_isend_irecv` (each step's exchange is started as the
    previous step's blocks begin). The fp32 dk/dv buffer of the KV it holds
    travels the same way, one hop after each step's contributions are
    added, and after n hops this rank holds its own."""

    def __init__(self, k, v, seg, group, rank: int, ranks: Sequence[int]):
        self.n = len(ranks)
        self.group = group
        self.next = ranks[(rank + 1) % self.n]
        self.prev = ranks[(rank - 1) % self.n]
        self.cur = [t for t in (k, v, seg) if t is not None]
        self.has_seg = seg is not None
        self._pending = None
        self._acc = None

    def _exchange(self, tensors):
        bufs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in tensors]
        ops = ([dist.P2POp(dist.isend, t.contiguous(), self.next, self.group) for t in tensors]
               + [dist.P2POp(dist.irecv, b, self.prev, self.group) for b in bufs])
        return dist.batch_isend_irecv(ops), bufs

    def kv(self, t: int):
        if t > 0:
            reqs, bufs = self._pending
            for r in reqs:
                r.wait()
            self.cur = bufs
        self._pending = self._exchange(self.cur) if t < self.n - 1 else None
        k, v, *seg = self.cur
        return k, v, seg[0] if self.has_seg else None

    def add_grads(self, t: int, dk, dv) -> None:
        if self._acc is not None:  # the buffer of this step's KV, from the previous rank
            reqs, bufs = self._acc
            for r in reqs:
                r.wait()
            dk, dv = bufs[0] + dk, bufs[1] + dv
        self._acc = self._exchange([dk.float(), dv.float()]) if self.n > 1 else (
            (), [dk.float(), dv.float()])

    def grads(self):
        reqs, bufs = self._acc
        for r in reqs:
            r.wait()
        return bufs[0], bufs[1]


# ---- the per-rank bodies ----

def _merge(acc, lse_acc, out_b, lse_b):
    """Fold one block's (out, lse) into a running fp32 (out, lse). A row
    with no key in a block comes with lse -1e30 (or -inf) and out 0; the lse
    is clamped at -1e30 first, so that two such blocks merge to a finite
    (0, about -1e30), never exp(-inf - -inf) = NaN."""
    lse_b = lse_b.float().clamp(min=NEG_INF)
    if acc is None:
        return out_b.float(), lse_b
    new = torch.logaddexp(lse_acc, lse_b)
    w_old = torch.exp(lse_acc - new).transpose(1, 2)[..., None]
    w_new = torch.exp(lse_b - new).transpose(1, 2)[..., None]
    return acc * w_old + out_b.float() * w_new, new


def ring_forward(q, seg, ring, *, rank: int, n: int, layout: str, causal: bool = True,
                 window: Optional[int] = None):
    """Rank `rank`'s forward over its local q [B, S/n, Hq, D] (in the
    layout's order) and segment ids [B, S/n] or None; `ring.kv(t)` gives the
    KV (and segment ids) of rank (rank − t) mod n. Returns (out in q's
    dtype, lse [B, Hq, S/n] fp32)."""
    s_local = q.shape[1]
    rows = [None] * len(_chunks(n, rank, s_local, layout))
    starts = [c[1] for c in _chunks(n, rank, s_local, layout)]
    for t in range(n):
        k, v, kv_seg = ring.kv(t)
        src = (rank - t) % n
        for qs, ks, ln, kind, off in schedule(n, rank, src, s_local, layout, causal, window):
            o, lse = block_forward(
                q[:, qs:qs + ln], k[:, ks:ks + ln], v[:, ks:ks + ln],
                None if seg is None else seg[:, qs:qs + ln],
                None if kv_seg is None else kv_seg[:, ks:ks + ln], kind, window, off)
            i = starts.index(qs)
            rows[i] = _merge(*(rows[i] or (None, None)), o, lse)
    out = torch.cat([r[0] for r in rows], dim=1)
    lse = torch.cat([r[1] for r in rows], dim=2)
    return out.to(q.dtype), lse.contiguous()


def ring_backward(q, seg, out, lse, dout, ring, *, rank: int, n: int, layout: str,
                  causal: bool = True, window: Optional[int] = None):
    """Rank `rank`'s backward: dq [B, S/n, Hq, D] in q's dtype; each step's
    dk/dv contributions go to `ring.add_grads`, and `ring.grads()` gives
    this rank's own once the ring has gone round."""
    s_local = q.shape[1]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for t in range(n):
        k, v, kv_seg = ring.kv(t)
        src = (rank - t) % n
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for qs, ks, ln, kind, off in schedule(n, rank, src, s_local, layout, causal, window):
            qr, kr = slice(qs, qs + ln), slice(ks, ks + ln)
            g = block_backward(
                q[:, qr], k[:, kr], v[:, kr], None if seg is None else seg[:, qr],
                None if kv_seg is None else kv_seg[:, kr], out[:, qr], lse[:, :, qr],
                dout[:, qr], kind, window, off)
            dq[:, qr] += g[0].float()
            dk[:, kr] += g[1].float()
            dv[:, kr] += g[2].float()
        ring.add_grads(t, dk, dv)
    return dq.to(q.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg, par, layout, causal, window):
        ctx.par, ctx.layout, ctx.causal, ctx.window = par, layout, causal, window
        ring = P2PRing(k, v, seg, par.cp_group, par.cp_rank, par.cp_ranks)
        out, lse = ring_forward(q, seg, ring, rank=par.cp_rank, n=par.cp_size, layout=layout,
                                causal=causal, window=window)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg, out, lse = ctx.saved_tensors
        par = ctx.par
        ring = P2PRing(k, v, seg, par.cp_group, par.cp_rank, par.cp_ranks)
        dq = ring_backward(q, seg, out, lse, dout.contiguous(), ring, rank=par.cp_rank,
                           n=par.cp_size, layout=ctx.layout, causal=ctx.causal,
                           window=ctx.window)
        dk, dv = ring.grads()
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None


def ring_attention(q, k, v, par, *, causal: bool = True, segment_ids=None,
                   sliding_window: Optional[int] = None, layout: str = "zigzag"):
    """Ring attention over the seq group of `par` (mesh.Parallel). q
    [B, S/n, Hq, D] and k/v [B, S/n, Hkv, D] are this rank's shards in
    `layout`'s order (the layout `pick_layout` gives for the whole length;
    `local_positions` says which positions they are), segment_ids its
    [B, S/n] or None. Returns this rank's [B, S/n, Hq, D], differentiable
    (K2 per block in the backward)."""
    return _RingAttention.apply(q, k, v, segment_ids, par, layout, causal, sliding_window)


class _GatherSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par, layout):
        ctx.par = par
        n, s_local = par.cp_size, x.shape[1]
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=par.cp_group)
        s = n * s_local
        order = torch.cat([local_positions(s, n, r, layout) for r in range(n)])
        ctx.inv = torch.argsort(order).to(x.device)
        ctx.idx = local_positions(s, n, par.cp_rank, layout).to(x.device)
        return torch.cat(parts, dim=1)[:, ctx.inv]

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.idx], None, None


def gather_sequence(x: torch.Tensor, par, layout: str) -> torch.Tensor:
    """Every rank's [B, S/n, ...] shard of the seq group → the whole
    [B, S, ...] in the natural order, on every rank (the backward keeps
    this rank's positions: the caller's use of the whole is replicated)."""
    if par.cp_size == 1:
        return x
    return _GatherSequence.apply(x, par, layout)
