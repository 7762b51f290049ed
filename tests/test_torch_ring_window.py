"""The windowed ring: the q − kv offset of K1/K2 (ops/flash_attention.py)
and the ring's window in global positions (parallel/context_parallel.py),
on the CPU, where the kernels' plain versions run.

  - `tile_ranges(..., offset=)` against ranges read off the ring's dense
    `_block_mask` at the same offset: equal without segments, covering
    every attended pair with them, for offsets wholly inside, partly inside
    and wholly outside the window, causal and not;
  - the plain K1/K2 versions with an offset (`flash_attention_ref`,
    `flash_attention_lse_ref`, `flash_attention_bwd_ref`, and the autograd
    operator with its trailing offset) against dense attention under the
    same mask: out and lse on the rows that attend a key, dq/dk/dv
    everywhere;
  - the per-rank ring bodies with a window at n = 2 and 4 over `MemoryRing`
    against JAX `ring_attention(..., sliding_window=)` and its VJP, fp32 at
    1e-5, with `schedule` skipping the blocks wholly outside the window and
    the blocks run counted against `ring_blocks(..., window=)`;
  - `_merge` stays finite for a row that several blocks leave without a key;
  - the kernel branch of a ring block hands K1/K2 its offset and window.
"""

import numpy as np
import pytest
import torch

from leopard_tpu_torch.ops import flash_attention as fa
from leopard_tpu_torch.ops.attention import attention, make_attention_mask
from leopard_tpu_torch.parallel import context_parallel as cp

from test_torch_context_parallel import memory_ring, qkv

ATOL = 1e-5
BLOCK = 8  # tile rows for the range checks: several tiles a block
# (q − kv offset, window) for a block of 32 rows: inside (every pair within
# the window), partly inside, wholly outside (offset − 31 >= window)
OFFSETS = {"inside": (16, 64), "partial": (32, 24), "outside": (64, 24),
           "diagonal": (0, 12)}


def seg_rows(n):
    """Two rows: two segments; one segment then padding."""
    return torch.tensor([[1] * (n // 2) + [2] * (n - n // 2),
                         [1] * (3 * n // 4) + [0] * (n - 3 * n // 4)], dtype=torch.int32)


def ranges_from_mask(mask, block):
    """(kv_of_q, q_of_kv) read off a dense [B, Sq, Skv] mask: each tile's
    [first, last + 1) of the other side's rows it attends, (0, 0) for none."""
    def per_tile(m):
        b, n, other = m.shape
        out = torch.zeros((b, -(-n // block), 2), dtype=torch.int32)
        for t in range(out.shape[1]):
            hit = m[:, t * block:(t + 1) * block].any(1)
            for r in range(b):
                idx = torch.nonzero(hit[r]).flatten()
                if len(idx):
                    out[r, t] = torch.tensor([int(idx[0]), int(idx[-1]) + 1])
        return out
    return per_tile(mask), per_tile(mask.transpose(1, 2))


@pytest.mark.parametrize("segments", [False, True], ids=["band", "segments"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("case", list(OFFSETS))
def test_tile_ranges_with_offset_match_the_block_mask(case, causal, segments):
    off, window = OFFSETS[case]
    n = 32
    seg = seg_rows(n) if segments else None
    mask = cp._block_mask(seg, seg, n, n, causal, window, off, "cpu")[:, 0, 0]
    if seg is None:
        mask = mask.expand(2, n, n)
    got = fa.tile_ranges(seg, seg, sq=n, skv=n, causal=causal, window=window, block=BLOCK,
                         offset=off)
    want_kv, want_q = ranges_from_mask(mask, BLOCK)
    got_kv, got_q = got.kv_of_q.expand(2, -1, -1), got.q_of_kv.expand(2, -1, -1)
    if case == "outside":
        assert not mask.any()
    if not segments:  # the band alone: the ranges are exact
        assert torch.equal(got_kv, want_kv) and torch.equal(got_q, want_q)
        return
    for g, w in ((got_kv, want_kv), (got_q, want_q)):  # segments: they cover every pair
        empty = w[..., 1] == 0
        assert ((g[..., 0] <= w[..., 0]) & (g[..., 1] >= w[..., 1]) | empty).all()


def _dense(q, k, v, mask):
    """Dense attention under `mask` [B|1, Sq, Skv] through autograd."""
    return attention(q, k, v, mask=mask[:, None])


@pytest.mark.parametrize("segments", [False, True], ids=["band", "segments"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("case", ["inside", "partial", "diagonal"])
def test_plain_kernels_with_offset_match_the_dense_mask(case, causal, segments):
    off, window = OFFSETS[case]
    n = 32
    rng = np.random.RandomState(len(case) + 2 * causal + segments)
    q, k, v, do = (torch.from_numpy(rng.randn(2, n, h, 8).astype(np.float32))
                   for h in (4, 2, 2, 4))
    seg = seg_rows(n) if segments else None
    kw = dict(causal=causal, q_segment_ids=seg, kv_segment_ids=seg, sliding_window=window,
              q_offset=off)
    mask = make_attention_mask(n, n, causal=causal, q_segment_ids=seg, kv_segment_ids=seg,
                               sliding_window=window, q_offset=off)[:, 0]
    if mask.shape[0] == 1:
        mask = mask.expand(2, n, n)
    assert torch.equal(mask, cp._block_mask(seg, seg, n, n, causal, window, off,
                                            "cpu")[:, 0, 0].expand(2, n, n))
    rows = mask.any(-1)
    out_want, lse_want = cp._plain_fwd(q, k, v, mask[:, None, None])
    out = fa.flash_attention_ref(q, k, v, **kw)
    lse = fa.flash_attention_lse_ref(q, k, v, **kw)
    np.testing.assert_allclose(out[rows].numpy(), out_want[rows].numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.transpose(1, 2)[rows].numpy(),
                               lse_want.transpose(1, 2)[rows].numpy(), atol=ATOL, rtol=1e-6)
    do = do * rows[:, :, None, None]
    grads = fa.flash_attention_bwd_ref(q, k, v, seg, seg, out_want, lse_want, do,
                                       causal=causal, sliding_window=window, q_offset=off)
    for name, got, want in zip(("dq", "dk", "dv"), grads,
                               cp._plain_bwd(q, k, v, mask[:, None, None], out_want, lse_want,
                                             do)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0, err_msg=name)
    # the autograd operator, its offset a trailing argument
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*leaves, **kw).backward(do)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    _dense(*ref, mask).backward(do)
    for name, a, b in zip(("dq", "dk", "dv"), leaves, ref):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=ATOL, rtol=0,
                                   err_msg=name)


# name: (causal, segments, window, layout, s): windows shorter than a chunk,
# across a few chunks, and a non-causal (contiguous) ring
RING_CASES = {
    "short": (True, False, 6, "zigzag", 64),
    "segments_short": (True, True, 6, "zigzag", 64),
    "across": (True, False, 20, "zigzag", 64),
    "segments_across": (True, True, 20, "zigzag", 64),
    "contiguous": (True, False, 20, "contiguous", 64),
    "noncausal": (False, False, 20, "zigzag", 64),
}
RING_RUNS = [(c, n) for c in RING_CASES for n in (2, 4)]


@pytest.fixture
def counted_blocks(monkeypatch):
    """Counts of the ring's block calls (the K1/K2 launches on the card)."""
    counts = {"fwd": 0, "bwd": 0}
    real_f, real_b = cp.block_forward, cp.block_backward

    def fwd(*a):
        counts["fwd"] += 1
        return real_f(*a)

    def bwd(*a):
        counts["bwd"] += 1
        return real_b(*a)

    monkeypatch.setattr(cp, "block_forward", fwd)
    monkeypatch.setattr(cp, "block_backward", bwd)
    return counts


@pytest.mark.parametrize("case,n", RING_RUNS, ids=[f"{c}-n{n}" for c, n in RING_RUNS])
def test_windowed_ring_bodies_match_jax(case, n, counted_blocks):
    import jax
    import jax.numpy as jnp

    from leopard_tpu.config import MeshConfig
    from leopard_tpu.parallel.context_parallel import ring_attention
    from leopard_tpu.parallel.mesh import build_mesh

    causal, with_seg, window, layout, s = RING_CASES[case]
    q, k, v, do = qkv(s=s, seed=3 * n + len(case))
    seg = None
    if with_seg:
        seg = seg_rows(s).numpy()
    valid = np.ones(q.shape[:2], bool) if seg is None else seg != 0
    do = do * valid[:, :, None, None]
    mesh = build_mesh(MeshConfig(seq=n, model=8 // n))

    def f(q, k, v):
        return ring_attention(q, k, v, mesh, causal=causal, sliding_window=window,
                              segment_ids=None if seg is None else jnp.asarray(seg),
                              layout=layout)

    @jax.jit
    def out_and_grads(q, k, v, do):
        out, vjp = jax.vjp(f, q, k, v)
        return (out, *vjp(do))

    wants = [np.asarray(a) for a in out_and_grads(*map(jnp.asarray, (q, k, v, do)))]
    gots = memory_ring(q, k, v, do, seg, n, causal, window, layout)
    np.testing.assert_allclose(gots[0][valid], wants[0][valid], atol=ATOL, rtol=0)
    for name, got, want in zip(("dq", "dk", "dv"), gots[1:], wants[1:]):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=name)
    used = cp.pick_layout(s, n, causal, layout)
    blocks = cp.ring_blocks(n, used, causal, window=window, s=s)
    assert counted_blocks == {"fwd": blocks, "bwd": blocks}
    assert blocks <= cp.ring_blocks(n, used, causal)
    if case in ("short", "segments_short"):  # the window took blocks away
        assert blocks < cp.ring_blocks(n, used, causal)


@pytest.mark.parametrize("n", [2, 4])
def test_schedule_skips_blocks_wholly_outside_the_window(n):
    """Every block the schedule drops has no pair inside the window, and
    every block it keeps has one; at n = 4 over 16,384 tokens and Mistral's
    4,096, chunks of 2,048: offsets 0 (diagonal), 2,048 (wholly inside),
    4,096 (partly inside) stay, 6,144 and beyond go."""
    s, window = 16384, 4096
    layout = cp.pick_layout(s, n)
    for r in range(n):
        for t in range(n):
            src = (r - t) % n
            every = cp.schedule(n, r, src, s // n, layout, True)
            kept = cp.schedule(n, r, src, s // n, layout, True, window)
            for blk in every:
                _, _, ln, kind, off = blk
                inside = off - (ln - 1) < window
                assert (blk in kept) == inside
    offsets = {off for r in range(n) for t in range(n)
               for *_, off in cp.schedule(n, r, (r - t) % n, s // n, layout, True, window)}
    assert offsets == ({0, 4096} if n == 2 else {0, 2048, 4096})
    assert cp.ring_blocks(n, layout, window=window, s=s) == (7 if n == 2 else 21)
    with pytest.raises(ValueError, match="pass s"):
        cp.ring_blocks(n, layout, window=window)


@pytest.mark.parametrize("lse_fill", [-1e30, float("-inf")], ids=["neg1e30", "neginf"])
def test_merge_stays_finite_for_rows_without_keys(lse_fill):
    """Row 0 has a key in neither block, row 1 in the second only."""
    out_a = torch.zeros((1, 2, 1, 4))
    lse_a = torch.full((1, 1, 2), lse_fill)
    out_b = torch.stack([torch.zeros(4), torch.arange(4.0)])[None, :, None]
    lse_b = torch.tensor([[[lse_fill, 0.5]]])
    acc, lse = cp._merge(None, None, out_a, lse_a)
    acc, lse = cp._merge(acc, lse, out_b, lse_b)
    assert torch.isfinite(acc).all() and torch.isfinite(lse).all()
    assert torch.equal(acc[0, 0], torch.zeros(1, 4))
    torch.testing.assert_close(acc[0, 1, 0], torch.arange(4.0))
    torch.testing.assert_close(lse[0, 0, 1], torch.tensor(0.5))


@pytest.mark.parametrize("kind,offset", [("diag", 0), ("full", 2048)])
def test_kernel_branch_takes_the_block_offset(monkeypatch, kind, offset):
    """Off the CPU a ring block is one K1 launch and one K2 launch that take
    the block's q − kv offset and window, causal on the diagonal alone (the
    block on "meta" stands for one on the card; the launches are recorded)."""
    seen = []

    def launch(q, k, v, **kw):
        seen.append(("K1", kw))
        return torch.empty_like(q), torch.empty(q.shape[0], q.shape[2], q.shape[1],
                                                device=q.device)

    def launch_bwd(q, k, v, *a, **kw):
        seen.append(("K2", kw))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    monkeypatch.setattr(fa, "_launch", launch)
    monkeypatch.setattr(fa, "_launch_bwd", launch_bwd)
    q = torch.empty((1, 64, 4, 16), device="meta")
    k = torch.empty((1, 64, 2, 16), device="meta")
    out, lse = cp.block_forward(q, k, k, None, None, kind, 4096, offset)
    cp.block_backward(q, k, k, None, None, out, lse, q, kind, 4096, offset)
    assert [name for name, _ in seen] == ["K1", "K2"]
    for _, kw in seen:
        assert kw["q_offset"] == offset and kw["sliding_window"] == 4096
        assert kw["causal"] == (kind == "diag")
