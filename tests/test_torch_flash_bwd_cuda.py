"""The Hopper flash backward (K2) and K1's lse output against their plain
versions, on the card, over the training path's shapes and masks.

These tests need an NVIDIA GPU and skip elsewhere. The file imports no JAX,
so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_bwd_cuda.py

Tolerance rtol = atol = 2e-2 on the bf16 gradients: the kernel rounds P and
dS to bf16 before its products and its outputs to bf16, the plain version
keeps fp32 to the end.
"""

import pytest
import torch

from leopard_tpu_torch.ops import flash_attention as tflash

TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def packed_segments(b, s, lengths, device):
    """Rows packing samples of the given lengths (ids 1, 2, ...), then 0; a
    row may instead give (id, count) runs, for ids that recur."""
    seg = torch.zeros((b, s), dtype=torch.int32)
    for r, row in enumerate(lengths):
        start = 0
        for sid, n in enumerate(row, start=1):
            if isinstance(n, tuple):
                sid, n = n
            seg[r, start:start + n] = sid
            start += n
    return seg.to(device)


CASES = {
    # name: (b, sq, skv, hq, hkv, d, causal, window, packed lengths or None)
    "decoder_packed_gqa_d128": (2, 700, 700, 8, 2, 128, True, None, ((300, 336), (500, 130))),
    "tower_ragged_d72": (3, 676, 676, 4, 4, 72, False, None, None),
    "d64_window": (1, 333, 333, 4, 2, 64, True, 50, None),
    "d16_cross_len": (2, 70, 130, 2, 1, 16, False, None, None),
    "decoder_causal_long": (1, 1100, 1100, 4, 1, 128, True, None, None),
    # ids that recur (1, 2, 1, 0) in one row: the tile ranges only widen
    "recurring_ids_d128": (1, 300, 300, 4, 2, 128, True, None,
                           (((1, 70), (2, 90), (1, 60), (0, 80)),)),
    "recurring_ids_noncausal_d72": (2, 260, 260, 2, 2, 72, False, None,
                                    (((1, 40), (2, 100), (1, 60), (0, 60)),
                                     ((2, 130), (1, 130)))),
    "s70_shorter_than_a_tile_d128": (1, 70, 70, 4, 1, 128, True, None, None),
    "s129_just_over_a_tile_d72": (2, 129, 129, 2, 2, 72, False, None, None),
    "s676_d16": (2, 676, 676, 2, 1, 16, False, None, None),
    "window_starts_mid_tile_d128": (1, 500, 500, 4, 2, 128, True, 100, None),
    # row 1 is padding from row 120: whole q and kv tiles of it are skipped
    "padding_tiles_d64": (2, 400, 400, 4, 4, 64, True, None, ((400,), (120,))),
    **{f"packed_d{d}": (2, 300, 300, 4, 2, d, True, None, ((130, 100), (40, 200, 60)))
       for d in (16, 64, 72, 128)},
}


def _inputs(case, device, seed=0):
    b, sq, skv, hq, hkv, d, causal, window, lengths = CASES[case]
    g = torch.Generator(device=device).manual_seed(seed)
    dt = torch.bfloat16
    q = torch.randn((b, sq, hq, d), generator=g, device=device).to(dt)
    k = torch.randn((b, skv, hkv, d), generator=g, device=device).to(dt)
    v = torch.randn((b, skv, hkv, d), generator=g, device=device).to(dt)
    dout = torch.randn((b, sq, hq, d), generator=g, device=device).to(dt)
    seg = None if lengths is None else packed_segments(b, sq, lengths, device)
    if seg is not None:
        dout = dout * (seg != 0)[:, :, None, None].to(dt)
    return q, k, v, dout, seg, dict(causal=causal, sliding_window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_backward_matches_plain_on_card(cuda, case):
    q, k, v, dout, seg, kw = _inputs(case, cuda)
    out, lse = tflash._launch(q, k, v, q_segment_ids=seg, kv_segment_ids=seg, with_lse=True, **kw)
    before = tflash.flash_attention_bwd.launches
    got = tflash.flash_attention_bwd(q, k, v, seg, seg, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert tflash.flash_attention_bwd.launches == before + 1
    want = tflash.flash_attention_bwd_ref(q, k, v, seg, seg, out, lse, dout, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a.float(), b.float(), **TOL, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_lse_matches_plain_on_card(cuda, case):
    q, k, v, _, seg, kw = _inputs(case, cuda)
    _, lse = tflash._launch(q, k, v, q_segment_ids=seg, kv_segment_ids=seg, with_lse=True, **kw)
    want = tflash.flash_attention_lse_ref(q, k, v, q_segment_ids=seg, kv_segment_ids=seg, **kw)
    valid = torch.ones(lse.shape, dtype=torch.bool, device=cuda)
    if seg is not None:
        valid = (seg != 0)[:, None, :].expand(lse.shape)
    # the bf16 products accumulate in fp32 on both sides: the lse agrees to fp32 noise
    torch.testing.assert_close(lse[valid], want[valid], rtol=1e-4, atol=1e-3)
    assert bool((lse[~valid] < -1e29).all())


@pytest.mark.cuda
def test_backward_repeats_bit_for_bit(cuda):
    """No atomics: two runs give the same bits."""
    q, k, v, dout, seg, kw = _inputs("decoder_packed_gqa_d128", cuda)
    out, lse = tflash._launch(q, k, v, q_segment_ids=seg, kv_segment_ids=seg, with_lse=True, **kw)
    first = tflash.flash_attention_bwd(q, k, v, seg, seg, out, lse, dout, **kw)
    second = tflash.flash_attention_bwd(q, k, v, seg, seg, out, lse, dout, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_autograd_through_kernels_matches_dense(cuda):
    """flash_attention under autograd (K1 with lse, then K2) against the
    dense attention's autograd in fp32 on the same bf16 inputs."""
    from leopard_tpu_torch.ops.attention import attention

    q, k, v, dout, seg, kw = _inputs("decoder_packed_gqa_d128", cuda, seed=1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n1, n2 = tflash.flash_attention.launches, tflash.flash_attention_bwd.launches
    out = tflash.flash_attention(*leaves, q_segment_ids=seg, kv_segment_ids=seg, **kw)
    got = torch.autograd.grad(out, leaves, dout)
    assert (tflash.flash_attention.launches - n1, tflash.flash_attention_bwd.launches - n2) == (1, 1)
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        attention(*ref, q_segment_ids=seg, kv_segment_ids=seg, **kw), ref, dout.float())
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.float(), b, **TOL, msg=name)


@pytest.mark.cuda
def test_skipped_rows_get_exact_zeros_on_card(cuda):
    """dq, dk and dv come from torch.empty: every padding row, including
    those of q and kv tiles whose range is empty, must be written as exact
    zeros."""
    q, k, v, dout, seg, kw = _inputs("padding_tiles_d64", cuda)
    out, lse = tflash._launch(q, k, v, q_segment_ids=seg, kv_segment_ids=seg, with_lse=True, **kw)
    dq, dk, dv = tflash.flash_attention_bwd(q, k, v, seg, seg, out, lse, dout, **kw)
    pad = seg == 0
    for name, t in (("dq", dq), ("dk", dk), ("dv", dv)):
        assert bool((t[pad] == 0).all()), name


@pytest.mark.cuda
def test_cache_views_on_card(cuda):
    """k and v as the two halves of one [B, S, 2 Hkv, D] buffer, as the
    decoder's cache views are: read in place, no copy."""
    q, _, _, dout, seg, kw = _inputs("decoder_packed_gqa_d128", cuda)
    b, s, _, d = q.shape
    g = torch.Generator(device=cuda).manual_seed(5)
    layer_kv = torch.randn((b, s + 40, 4, d), generator=g, device=cuda).to(torch.bfloat16)
    k, v = layer_kv[:, :s, :2], layer_kv[:, :s, 2:]
    before = tflash.flash_attention.copies
    out, lse = tflash._launch(q, k, v, q_segment_ids=seg, kv_segment_ids=seg, with_lse=True, **kw)
    got = tflash.flash_attention_bwd(q, k, v, seg, seg, out, lse, dout, **kw)
    assert tflash.flash_attention.copies == before
    want = tflash.flash_attention_bwd_ref(q, k, v, seg, seg, out, lse, dout, **kw)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.float(), w.float(), **TOL, msg=name)
