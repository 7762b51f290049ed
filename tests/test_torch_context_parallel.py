"""Ring attention (parallel/context_parallel.py) against the JAX package's
`ring_attention` and against dense attention.

  - the per-rank bodies, run as n = 4 virtual ranks in this process with
    `MemoryRing` (each rank's step reads the other shards from memory):
    output and gradients against JAX `ring_attention` (and its VJP) on the
    JAX package's 8-device CPU mesh (seq=4, model=2), for the causal,
    segment, window, segment + window, contiguous and non-causal cases;
  - the zig-zag schedule's block work against the contiguous ring's
    (JAX `test_zigzag_halves_attention_flops`);
  - one world of 4 on gloo with the real P2P rotation, through autograd:
    output and gradients against dense attention on the whole sequence.

Rows whose segment id is 0 attend nothing: the port gives them 0 (as K1),
the JAX ring a uniform average, so outputs are compared on the other rows
and the output gradient there is 0. fp32 on both sides: atol 2e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

from leopard_tpu_torch.parallel import context_parallel as cp

from test_torch_mesh import init_worker, run_world

ATOL = 2e-5
CASES = {
    # name: (causal, segments, window, layout)
    "causal": (True, False, None, "zigzag"),
    "segments": (True, True, None, "zigzag"),
    "window5": (True, False, 5, "zigzag"),
    "segments_window9": (True, True, 9, "zigzag"),
    "contiguous": (True, False, None, "contiguous"),
    "noncausal": (False, False, None, "zigzag"),
}


def qkv(b=2, s=32, hq=4, hkv=2, d=8, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, hq, d).astype(np.float32), rng.randn(b, s, hkv, d).astype(np.float32),
            rng.randn(b, s, hkv, d).astype(np.float32), rng.randn(b, s, hq, d).astype(np.float32))


def segments(s=32):
    return np.array([[1] * (s // 2) + [2] * (s // 2), [1] * (3 * s // 4) + [0] * (s // 4)],
                    np.int32)


@pytest.mark.parametrize("s,n", [(32, 4), (48, 3)])
def test_zigzag_indices_match_jax(s, n):
    from leopard_tpu.parallel.context_parallel import zigzag_indices as jzz

    for got, want in zip(cp.zigzag_indices(s, n), jzz(s, n)):
        np.testing.assert_array_equal(got, want)
    idx = torch.cat([cp.local_positions(s, n, r, "zigzag") for r in range(n)])
    np.testing.assert_array_equal(idx.numpy(), jzz(s, n)[0])


def memory_ring(q, k, v, do, seg, n, causal, window, layout):
    """The per-rank bodies of n virtual ranks: (out, dq, dk, dv) whole."""
    s = q.shape[1]
    layout = cp.pick_layout(s, n, causal, layout)
    idx = [cp.local_positions(s, n, r, layout) for r in range(n)]
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    seg_t = None if seg is None else torch.from_numpy(seg)
    ring = cp.MemoryRing([t[1][:, i] for i in idx], [t[2][:, i] for i in idx],
                         None if seg_t is None else [seg_t[:, i] for i in idx])
    out, dq = torch.zeros_like(t[0]), torch.zeros_like(t[0])
    dk, dv = torch.zeros_like(t[1]), torch.zeros_like(t[2])
    kw = dict(n=n, layout=layout, causal=causal, window=window)
    for r, i in enumerate(idx):
        q_r, s_r = t[0][:, i], None if seg_t is None else seg_t[:, i]
        o, lse = cp.ring_forward(q_r, s_r, ring.view(r), rank=r, **kw)
        out[:, i] = o
        dq[:, i] = cp.ring_backward(q_r, s_r, o, lse, t[3][:, i], ring.view(r), rank=r, **kw)
    for r, i in enumerate(idx):
        dk[:, i], dv[:, i] = ring.dk[r], ring.dv[r]
    return out.numpy(), dq.numpy(), dk.numpy(), dv.numpy()


RUNS = [(case, 4) for case in CASES] + [("causal", 2), ("segments_window9", 2)]


@pytest.mark.parametrize("case,n", RUNS, ids=[f"{c}-n{n}" for c, n in RUNS])
def test_ring_bodies_match_jax_ring(case, n):
    import jax
    import jax.numpy as jnp

    from leopard_tpu.config import MeshConfig
    from leopard_tpu.parallel.context_parallel import ring_attention
    from leopard_tpu.parallel.mesh import build_mesh

    causal, with_seg, window, layout = CASES[case]
    q, k, v, do = qkv(seed=len(case) + n)
    seg = segments() if with_seg else None
    valid = np.ones(q.shape[:2], bool) if seg is None else seg != 0
    do = do * valid[:, :, None, None]
    mesh = build_mesh(MeshConfig(seq=n, model=8 // n))

    def f(q, k, v):
        return ring_attention(q, k, v, mesh, causal=causal, sliding_window=window,
                              segment_ids=None if seg is None else jnp.asarray(seg),
                              layout=layout)

    @jax.jit  # an eager shard_map runs its ring op by op, ~20x slower
    def out_and_grads(q, k, v, do):
        out, vjp = jax.vjp(f, q, k, v)
        return (out, *vjp(do))

    wants = [np.asarray(a) for a in out_and_grads(*map(jnp.asarray, (q, k, v, do)))]
    gots = memory_ring(q, k, v, do, seg, n, causal, window, layout)
    np.testing.assert_allclose(gots[0][valid], wants[0][valid], atol=ATOL, rtol=0)
    for name, got, want in zip(("dq", "dk", "dv"), gots[1:], wants[1:]):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
def test_zigzag_halves_block_work(n):
    """Zig-zag: 2n + 1 blocks of c = S/2n a rank, n(2n+1)c² in all, against
    the masked contiguous ring's n² blocks of (S/n)² (the JAX ring's work):
    (2n+1)/(4n) of it."""
    s = 1024
    c = s // (2 * n)
    zz = [cp.schedule(n, r, (r - t) % n, 2 * c, "zigzag", True)
          for r in range(n) for t in range(n)]
    per_rank = [sum(len(zz[r * n + t]) for t in range(n)) for r in range(n)]
    assert per_rank == [2 * n + 1] * n and sum(per_rank) == cp.ring_blocks(n, "zigzag")
    work_zz = sum(ln * ln for steps in zz for _, _, ln, _, _ in steps)
    assert work_zz == n * (2 * n + 1) * c * c
    assert work_zz < 0.75 * s * s
    ct = [b for r in range(n) for t in range(n)
          for b in cp.schedule(n, r, (r - t) % n, s // n, "contiguous", True)]
    assert len(ct) == cp.ring_blocks(n, "contiguous")  # blocks wholly in the future skipped


def test_pick_layout_falls_back_as_jax():
    assert cp.pick_layout(32, 4) == "zigzag"
    assert cp.pick_layout(36, 4) == "contiguous"  # 36 % 8 != 0: JAX's fallback
    assert cp.pick_layout(32, 4, causal=False) == "contiguous"
    assert cp.pick_layout(32, 1) == "contiguous"
    with pytest.raises(ValueError):
        cp.pick_layout(30, 4)


def _p2p_worker(rank, world, store, path, out_path):
    import torch.distributed as dist

    from leopard_tpu_torch.parallel.mesh import Parallel

    mesh = init_worker(rank, world, store, dict(seq=world))
    par = Parallel.of(mesh)
    data = np.load(path)
    s = data["q"].shape[1]
    layout = cp.pick_layout(s, world)
    i = cp.local_positions(s, world, rank, layout)
    q, k, v = (torch.from_numpy(data[n][:, i]).requires_grad_() for n in ("q", "k", "v"))
    seg = torch.from_numpy(data["seg"][:, i])
    out = cp.ring_attention(q, k, v, par, causal=True, segment_ids=seg, layout=layout)
    out.backward(torch.from_numpy(data["do"][:, i]))
    np.savez(f"{out_path}{rank}.npz", idx=i.numpy(), out=out.detach().numpy(),
             dq=q.grad.numpy(), dk=k.grad.numpy(), dv=v.grad.numpy())
    dist.destroy_process_group()


def test_ring_over_gloo_matches_dense(tmp_path):
    from leopard_tpu_torch.ops.flash_attention import flash_attention_ref

    q, k, v, do = qkv(s=32, seed=11)
    seg = segments()
    valid = seg != 0
    do = do * valid[:, :, None, None]
    path = str(tmp_path / "in.npz")
    np.savez(path, q=q, k=k, v=v, do=do, seg=seg)
    run_world(_p2p_worker, 4, tmp_path, path, str(tmp_path / "out"))

    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    seg_t = torch.from_numpy(seg)
    want = flash_attention_ref(*t, causal=True, q_segment_ids=seg_t, kv_segment_ids=seg_t)
    want.backward(torch.from_numpy(do))
    got = {n: np.zeros_like(a) for n, a in (("out", q), ("dq", q), ("dk", k), ("dv", v))}
    for r in range(4):
        part = np.load(str(tmp_path / f"out{r}.npz"))
        for n in got:
            got[n][:, part["idx"]] = part[n]
    np.testing.assert_allclose(got["out"][valid], want.detach().numpy()[valid], atol=ATOL, rtol=0)
    for n, ref in (("dq", t[0]), ("dk", t[1]), ("dv", t[2])):
        np.testing.assert_allclose(got[n], ref.grad.numpy(), atol=ATOL, rtol=0, err_msg=n)


def _decoder_worker(rank, world, store, path, out):
    """The tiny decoder's logits under (seq=2, model=2) with attn_impl="ring"
    (the whole sequence in, logits gathered back in order), per case."""
    import torch.distributed as dist

    from leopard_tpu_torch import config as tcfgs
    from leopard_tpu_torch.models.decoder import Decoder
    from leopard_tpu_torch.parallel.mesh import Parallel, set_parallel
    from leopard_tpu_torch.parallel.sharding import tp_local_model

    mesh = init_worker(rank, world, store, dict(seq=2, model=2))
    data = np.load(path)
    results = {}
    for case in ("plain", "window6", "contiguous"):
        cfg = tcfgs.tiny_vlm().text
        cfg = dataclasses.replace(cfg, attn_impl="ring",
                                  sliding_window=6 if case == "window6" else None)
        full = Decoder(cfg)
        full.load_state_dict({k[5:]: torch.from_numpy(data[k]) for k in data.files
                              if k.startswith("text/")})
        full.cfg = cfg
        local = set_parallel(tp_local_model(full, mesh), Parallel.of(mesh))
        ids = torch.from_numpy(data["ids18" if case == "contiguous" else "ids"])
        with torch.no_grad():
            logits, _ = local(ids)
        results[case] = logits.numpy()
    if rank == 0:
        np.savez(out, **results)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def decoder_ring(tmp_path_factory):
    """JAX's dense decoder and the port's ring decoder on the same weights."""
    import jax
    import jax.numpy as jnp

    from leopard_tpu import config as cfgs
    from leopard_tpu.models import decoder as jdecoder
    from leopard_tpu.models import vlm as jvlm
    from leopard_tpu_torch import config as tcfgs
    from leopard_tpu_torch.convert.from_jax import state_dict_from_jax

    tmp = tmp_path_factory.mktemp("decoder_ring")
    jcfg = cfgs.tiny_vlm()
    params = jax.device_get(jvlm.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.RandomState(5)
    ids, ids18 = rng.randint(1, 100, (2, 16)).astype(np.int32), rng.randint(
        1, 100, (2, 18)).astype(np.int32)
    want = {}
    for case, tokens, window in (("plain", ids, None), ("window6", ids, 6),
                                 ("contiguous", ids18, None)):
        dcfg = dataclasses.replace(jcfg.text, attn_impl="dense", sliding_window=window)
        want[case] = np.asarray(jdecoder.forward(params["text"], dcfg, jnp.asarray(tokens))[0])
    sd = state_dict_from_jax(params, tcfgs.tiny_vlm())
    path, out = str(tmp / "in.npz"), str(tmp / "out.npz")
    np.savez(path, ids=ids, ids18=ids18,
             **{f"text/{k[5:]}": v.numpy() for k, v in sd.items() if k.startswith("text.")})
    run_world(_decoder_worker, 4, tmp, path, out)
    return want, np.load(out)


@pytest.mark.parametrize("case", ["plain", "window6", "contiguous"])
def test_decoder_ring_matches_jax_dense(decoder_ring, case):
    """JAX test_decoder_with_ring_attention_matches_dense and
    test_decoder_ring_respects_sliding_window, and a length (18) where the
    zig-zag layout does not apply (18 % 4 != 0): the contiguous ring."""
    want, got = decoder_ring
    np.testing.assert_allclose(got[case], want[case], rtol=3e-4, atol=3e-4)
