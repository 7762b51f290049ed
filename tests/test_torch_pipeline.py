"""The pipeline (parallel/pipeline.py) against the JAX package's.

  - the schedule as a pure function, for (n, v, M) in (2, 1, 2), (4, 1, 6),
    (4, 2, 8), (2, 2, 5): every (microbatch, chunk) runs its forward and its
    backward once on every stage, each forward one tick after its
    predecessor stage's, each backward one tick after its successor's (the
    last global stage's on its forward's tick), saved inputs in flight at
    most 2vn - 1 and never overwritten before their backward, and the tick
    count JAX's formula;
  - `pipeline_1f1b` and `pipeline_apply` with `MemoryStages` (n virtual
    stages in this process) on JAX tests/test_pipeline.py's toy stack
    (tanh(x @ w + b)), against JAX `pipeline_1f1b` / `pipeline_apply` on
    the 8-device CPU mesh: fp32, rtol 1e-5 (atol 1e-6 on gradients), v 1-3,
    M not a multiple of n;
  - `P2PStages` over gloo at n = 2 and n = 4: the same results as
    `MemoryStages` in the same process, bit for bit.
"""

import numpy as np
import pytest
import torch

from leopard_tpu_torch.parallel import pipeline as pp

from test_torch_mesh import init_worker, run_world

SCHEDULES = [(2, 1, 2), (4, 1, 6), (4, 2, 8), (2, 2, 5)]
RTOL, ATOL = 1e-5, 1e-6


def jax_ticks(n, v, m_total):
    """JAX pipeline.py:139-143, as written there."""
    q_last, r_last = (m_total - 1) // n, (m_total - 1) % n
    return q_last * v * n + (2 * v - 2) * n + r_last + 2 * (n - 1) + 1


@pytest.mark.parametrize("n,v,m_total", SCHEDULES)
def test_schedule(n, v, m_total):
    sched = pp.schedule_1f1b(n, v, m_total)
    assert len(sched) == jax_ticks(n, v, m_total) == pp.num_ticks(n, v, m_total)
    if m_total % n == 0:
        assert len(sched) == v * m_total + v * n + n - 2
    fwd_at, bwd_at = {}, {}
    for t, row in enumerate(sched):
        assert len(row) == n
        for d, (f, b) in enumerate(row):
            for seen, step in ((fwd_at, f), (bwd_at, b)):
                if step is not None:
                    assert (d, *step) not in seen, (t, d, step)
                    seen[(d, *step)] = t
    work = {(d, m, c) for d in range(n) for m in range(m_total) for c in range(v)}
    assert set(fwd_at) == work and set(bwd_at) == work
    for d, m, c in work:
        if v == 1:
            assert fwd_at[(d, m, c)] == m + d and bwd_at[(d, m, c)] == m + 2 * (n - 1) - d
        if (d, c) != (0, 0):   # the predecessor: stage d - 1, or stage n - 1 of chunk c - 1
            prev = (d - 1, m, c) if d else (n - 1, m, c - 1)
            assert fwd_at[(d, m, c)] == fwd_at[prev] + 1
        if (d, c) == (n - 1, v - 1):
            assert bwd_at[(d, m, c)] == fwd_at[(d, m, c)]
        else:   # the successor: stage d + 1, or stage 0 of chunk c + 1
            succ = (d + 1, m, c) if d < n - 1 else (0, m, c + 1)
            assert bwd_at[(d, m, c)] == bwd_at[succ] + 1
    slots = pp.buffer_slots(n, v)
    assert slots == 2 * v * n - 1
    for d in range(n):
        in_flight, held = set(), {}
        for t, row in enumerate(sched):
            f, b = row[d]
            if f is not None:
                in_flight.add(f)
                slot = pp.slot_key(*f, n, v) % slots
                assert slot not in held, (d, t, f, held[slot])   # never overwritten while needed
                held[slot] = f
            assert len(in_flight) <= slots
            if b is not None:
                in_flight.remove(b)
                del held[pp.slot_key(*b, n, v) % slots]
        assert not in_flight


def toy_stage(p, x, aux=None):
    """JAX test_pipeline.py's `_stage_fn`: tanh(x @ w + b) over the stage's layers."""
    for w, b in zip(p["w"], p["b"]):
        x = torch.tanh(x @ w + b)
    return x


def toy_head(hp, y, aux):
    err = y @ hp["w"] - aux["t"]
    return (err * err).sum(), torch.tensor(float(err.numel()))


def toy_inputs(n, v, m_total, layers, seed):
    from test_pipeline import _mlp_stack

    params = {k: np.array(x) for k, x in _mlp_stack(l=layers, seed=seed).items()}
    rng = np.random.RandomState(seed + 1)
    xs = rng.randn(m_total, 2, 16).astype(np.float32)
    tgt = rng.randn(m_total, 2, 16).astype(np.float32)
    head = (rng.randn(16, 16) * 0.2).astype(np.float32)
    return params, xs, tgt, head


def run_1f1b(stages, params, xs, tgt, head, v):
    """The port's pipeline_1f1b on the local stages of `stages`; the
    staged parameters leaf for leaf ([v][n] pieces of each)."""
    n = stages.n
    staged = pp.split_stages_interleaved(
        {k: torch.from_numpy(x).requires_grad_(True) for k, x in params.items()}, n, v)
    stage_params = {d: [staged[c][d] for c in range(v)] for d in stages.local}
    hp = {"w": torch.from_numpy(head).requires_grad_(True)}
    aux = [{"t": torch.from_numpy(t)} for t in tgt]
    return pp.pipeline_1f1b(toy_stage, toy_head, stage_params, hp, torch.from_numpy(xs), aux,
                            stages, v_chunks=v)


@pytest.mark.parametrize("n,v,m_total", [(4, 1, 6), (4, 2, 8), (2, 3, 5)])
def test_1f1b_memory_matches_jax(n, v, m_total):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from leopard_tpu.parallel.pipeline import (
        merge_stages_interleaved, pipeline_1f1b, split_stages_interleaved,
    )
    from test_pipeline import _stage_fn

    params, xs, tgt, head = toy_inputs(n, v, m_total, layers=2 * n * v, seed=7 + n + v)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("stage",))
    staged = split_stages_interleaved({k: jnp.asarray(x) for k, x in params.items()}, n, v)
    if v == 1:
        staged = jax.tree_util.tree_map(lambda p: p[0], staged)

    def head_fn(hp, y, aux_mb):
        err = y @ hp["w"] - aux_mb["t"]
        return jnp.sum(err * err), jnp.sum(jnp.ones_like(err))

    want = pipeline_1f1b(lambda sp, x, a: _stage_fn(sp, x), head_fn, staged,
                         {"w": jnp.asarray(head)}, jnp.asarray(xs), {"t": jnp.asarray(tgt)},
                         mesh, axis="stage", v_chunks=v)
    got = run_1f1b(pp.MemoryStages(n), params, xs, tgt, head, v)

    np.testing.assert_allclose(float(got["nll_sum"]), float(want["nll_sum"]), rtol=RTOL)
    assert float(got["w_sum"]) == float(want["w_sum"]) == xs.size
    d_stage = want["d_stage"] if v > 1 else jax.tree_util.tree_map(lambda g: g[None],
                                                                    want["d_stage"])
    merged = merge_stages_interleaved(d_stage)
    mine = pp.merge_stages_interleaved([[got["d_stage"][d][c] for d in range(n)]
                                        for c in range(v)])
    for k in params:
        np.testing.assert_allclose(mine[k].numpy(), np.asarray(merged[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(got["d_head"]["w"].numpy(), np.asarray(want["d_head"]["w"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["d_xs"].numpy(), np.asarray(want["d_xs"]), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("n,m_total", [(4, 6), (2, 3)])
def test_apply_memory_matches_jax(n, m_total):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from leopard_tpu.parallel.pipeline import pipeline_apply, split_stages
    from test_pipeline import _stage_fn

    params, xs, _, _ = toy_inputs(n, 1, m_total, layers=2 * n, seed=n)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("stage",))
    want = pipeline_apply(_stage_fn, split_stages({k: jnp.asarray(x) for k, x in params.items()},
                                                  n), jnp.asarray(xs), mesh, axis="stage")
    staged = pp.split_stages({k: torch.from_numpy(x) for k, x in params.items()}, n)
    got = pp.pipeline_apply(toy_stage, dict(enumerate(staged)), torch.from_numpy(xs),
                            pp.MemoryStages(n))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_split_and_merge_stages():
    layers = list(range(8))
    assert pp.split_stages(layers, 4) == [[0, 1], [2, 3], [4, 5], [6, 7]]
    inter = pp.split_stages_interleaved(layers, 2, 2)   # [c][d]: global stage c·n + d
    assert inter == [[[0, 1], [2, 3]], [[4, 5], [6, 7]]]
    assert pp.merge_stages_interleaved(inter) == layers
    t = torch.arange(24.0).reshape(6, 4)
    assert torch.equal(pp.merge_stages(pp.split_stages({"a": t}, 3))["a"], t)
    with pytest.raises(ValueError):
        pp.split_stages(layers, 3)


def test_memory_stages_refuse_an_unread_hand_off():
    stages = pp.MemoryStages(2)
    x = torch.zeros(1)
    with pytest.raises(RuntimeError, match="activations sent to stages"):
        stages.exchange({0: x}, {}, {0: False, 1: False}, {0: False, 1: False}, x)


P2P_CASES = ((2, 2, 5), (4, 2, 6))   # (n, v, M)


def _p2p_worker(rank, world, store, path, out):
    import torch.distributed as dist

    mesh = init_worker(rank, world, store, dict(stage=world))
    stages = pp.P2PStages.of(mesh)
    data = np.load(path)
    d, n = stages.stage, world
    for _, v, m_total in (c for c in P2P_CASES if c[0] == n):
        params = {k: data[f"{n}/p/{k}"] for k in ("w", "b")}
        xs, tgt, head = (data[f"{n}/{k}"] for k in ("xs", "tgt", "head"))
        got = run_1f1b(stages, params, xs, tgt, head, v)
        ref = run_1f1b(pp.MemoryStages(n), params, xs, tgt, head, v)
        for k in ("nll_sum", "w_sum", "d_xs"):
            assert torch.equal(got[k], ref[k]), k
        assert torch.equal(got["d_head"]["w"], ref["d_head"]["w"])
        for c in range(v):
            for k in params:
                assert torch.equal(got["d_stage"][d][c][k], ref["d_stage"][d][c][k]), (d, c, k)
        staged = pp.split_stages({k: torch.from_numpy(x) for k, x in params.items()}, n)
        fwd = pp.pipeline_apply(toy_stage, {d: staged[d]}, torch.from_numpy(xs), stages)
        fwd_ref = pp.pipeline_apply(toy_stage, dict(enumerate(staged)), torch.from_numpy(xs),
                                    pp.MemoryStages(n))
        assert torch.equal(fwd, fwd_ref)
    if rank == 0:
        with open(out, "w") as f:
            f.write("ok")
    dist.destroy_process_group()


@pytest.mark.parametrize("n", [2, 4])
def test_p2p_stages_equal_memory_stages(tmp_path, n):
    arrays = {}
    for _, v, m_total in (c for c in P2P_CASES if c[0] == n):
        params, xs, tgt, head = toy_inputs(n, v, m_total, layers=2 * n * v, seed=3 + n)
        arrays.update({f"{n}/p/{k}": x for k, x in params.items()})
        arrays.update({f"{n}/xs": xs, f"{n}/tgt": tgt, f"{n}/head": head})
    path, out = str(tmp_path / "in.npz"), tmp_path / "ok"
    np.savez(path, **arrays)
    run_world(_p2p_worker, n, tmp_path, path, str(out))
    assert out.read_text() == "ok"
