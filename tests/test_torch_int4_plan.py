"""The int4 matmul's (K4) host side on the CPU: the planner that splits K
across blocks, and the per-weight checks made once when a weight's plan is
built. The kernel itself is tested on the card (test_torch_int4_cuda.py)."""

import pytest
import torch

from leopard_tpu_torch.ops import int4_matmul as tk4
from leopard_tpu_torch.ops import quant as tquant

# Leopard-LLaVA-8B's decode matmuls (K, N): wq/wo, wk/wv, gate/up, down, lm_head
SHAPES_8B = {"wq_wo": (4096, 4096), "wk_wv": (4096, 1024), "gate_up": (4096, 14336),
             "down": (14336, 4096), "lm_head": (4096, 128256)}


@pytest.mark.parametrize("name", list(SHAPES_8B))
def test_plan_covers_every_group_pair_and_tile_once(name):
    """Blocks are (column tile, split); split i takes group pairs
    [i · per, min((i + 1) · per, K / 256)). Every (group pair, tile) is
    covered by exactly one block, for every M the kernel takes."""
    k, n = SHAPES_8B[name]
    pairs, tiles = k // 256, n // tk4.BLOCK_N
    for m in range(1, tk4.MAX_M + 1):
        splits, per = tk4.plan_splits(m, k, n)
        seen = torch.zeros((pairs, tiles), dtype=torch.int32)
        for tile in range(tiles):
            for split in range(splits):
                lo, hi = split * per, min(pairs, (split + 1) * per)
                assert hi > lo, (m, split)  # no block without work
                seen[lo:hi, tile] += 1
        assert bool((seen == 1).all()), m


@pytest.mark.parametrize("name", list(SHAPES_8B))
def test_split_count_satisfies_the_c_entry(name):
    """csrc/int4_matmul.cu::leopard_int4_matmul refuses splits < 1, splits > 8,
    per < 1, (splits - 1) · per >= K / 256, splits · per < K / 256, and a
    split call with more column tiles than the workspace has counters; the
    planner never asks for those. A split call fits one wave (two blocks an
    SM for M <= 16, else one), and rounding K to whole group pairs loses at
    most half of the splits wanted."""
    k, n = SHAPES_8B[name]
    pairs, tiles = k // 256, n // tk4.BLOCK_N
    for m in range(1, tk4.MAX_M + 1):
        splits, per = tk4.plan_splits(m, k, n)
        assert 1 <= splits <= tk4.MAX_SPLITS and per >= 1
        assert (splits - 1) * per < pairs <= splits * per
        slots = tk4.SMS * (2 if m <= 16 else 1)
        want = max(1, min(pairs, tk4.MAX_SPLITS, slots // tiles))
        assert 2 * splits >= want, (m, splits)
        assert splits == 1 or tiles * splits <= slots, (m, splits)
        assert splits == 1 or tiles <= tk4.SPLIT_COUNTERS, (m, splits)


def test_plan_at_decode_splits_only_narrow_matrices():
    """At M = 2: lm_head (1,002 tiles) and gate/up are not split or split
    little; wk/wv (8 tiles) and wq/wo (32) take the most splits, 8."""
    assert tk4.plan_splits(2, *SHAPES_8B["lm_head"]) == (1, 16)
    assert tk4.plan_splits(2, *SHAPES_8B["gate_up"]) == (2, 8)
    assert tk4.plan_splits(2, *SHAPES_8B["wk_wv"]) == (8, 2)
    assert tk4.plan_splits(2, *SHAPES_8B["wq_wo"]) == (8, 2)
    assert tk4.plan_splits(2, *SHAPES_8B["down"]) == (8, 7)


def _weight(k=512, n=256):
    q = tquant.quantize_int4(torch.randn(n, k))
    return q["q4"], q["s"]


def _misaligned(t: torch.Tensor, offset_bytes: int) -> torch.Tensor:
    """A contiguous copy of t whose data starts `offset_bytes` past an
    aligned address."""
    step = offset_bytes // t.element_size()
    buf = torch.empty(t.numel() + step, dtype=t.dtype)
    out = buf[step:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == offset_bytes % 16
    return out


def test_validate_weight_takes_a_packed_weight():
    q4, s = _weight(512, 256)
    assert tk4.validate_weight(q4, s) == (512, 256)


@pytest.mark.parametrize("case", [
    "q4_int8", "s_f16", "q4_rank3", "q4_not_contiguous", "s_not_contiguous",
    "q4_misaligned", "s_misaligned", "group64", "k_not_256", "n_not_128", "n_mismatch"])
def test_validate_weight_refuses(case):
    q4, s = _weight(512, 256)
    if case == "q4_int8":
        q4 = q4.to(torch.int8)
    elif case == "s_f16":
        s = s.half()
    elif case == "q4_rank3":
        q4 = q4[None]
    elif case == "q4_not_contiguous":
        q4 = torch.cat([q4, q4], dim=1)[:, ::2]
    elif case == "s_not_contiguous":
        s = torch.cat([s, s], dim=1)[:, ::2]
    elif case == "q4_misaligned":
        q4 = _misaligned(q4, 8)
    elif case == "s_misaligned":
        s = _misaligned(s, 4)
    elif case == "group64":
        q4, s = (tquant.quantize_int4(torch.randn(256, 512), group=64)[key] for key in ("q4", "s"))
    elif case == "k_not_256":
        q4, s = q4[:64].contiguous(), s[:1].contiguous()  # K = 128, one group
    elif case == "n_not_128":
        q4, s = _weight(512, 192)
    elif case == "n_mismatch":
        s = s[:, :128].contiguous()
    with pytest.raises(ValueError):
        tk4.validate_weight(q4, s)


def test_int4_matmul_on_cpu_rounds_the_f32_result_once():
    """out_dtype=bfloat16 is the f32 result rounded once, on the CPU as on
    the card; other output types are refused."""
    q4, s = _weight(512, 256)
    x = torch.randn(3, 512)
    f32 = tk4.int4_matmul(x, q4, s)
    bf16 = tk4.int4_matmul(x, q4, s, out_dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, f32.to(torch.bfloat16))
    with pytest.raises(ValueError):
        tk4.int4_matmul(x, q4, s, out_dtype=torch.float16)


def test_matmul_returns_x_dtype_through_the_kernel_tier(monkeypatch):
    """quant.matmul asks the kernel tier for x's dtype (one launch on the
    card, no cast after it): here the tier's plain version, x in bf16."""
    q4, s = _weight(512, 256)
    monkeypatch.setattr(tquant, "use_int4_kernel", lambda x, q4, s: True)
    x = torch.randn(2, 1, 512).to(torch.bfloat16)
    y = tquant.matmul(x, tquant.QuantizedWeight({"q4": q4, "s": s}))
    assert y.dtype == torch.bfloat16 and y.shape == (2, 1, 256)
    assert torch.equal(y[:, 0], tk4.int4_matmul_ref(x[:, 0], q4, s).to(torch.bfloat16))
