"""The Hopper flash-attention kernel against its plain version, on the card.

These tests need an NVIDIA GPU and skip elsewhere. The file imports no JAX,
so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_cuda.py
"""

import pytest
import torch

from leopard_tpu_torch.ops import flash_attention as tflash


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CARD_CASES = {
    # name: (b, sq, skv, hq, hkv, d, causal, segments, window); segments is
    # None, valid lengths per row (right padding), or per row (id, count) runs
    "vision_ragged_d72": (3, 676, 676, 4, 4, 72, False, None, None),
    "decoder_gqa_d128_padded": (2, 300, 300, 8, 2, 128, True, (300, 171), None),
    "d64_window": (1, 200, 200, 4, 2, 64, True, None, 50),
    "d16_cross_len": (2, 70, 130, 2, 1, 16, False, None, None),
    "decoder_long_causal": (1, 1100, 1100, 4, 1, 128, True, None, None),
    # ids that recur (1, 2, 1, 0) in one row: the tile ranges only widen
    "recurring_ids_d128": (1, 300, 300, 4, 2, 128, True,
                           (((1, 70), (2, 90), (1, 60), (0, 80)),), None),
    "recurring_ids_noncausal_d72": (2, 260, 260, 2, 2, 72, False,
                                    (((1, 40), (2, 100), (1, 60), (0, 60)),
                                     ((2, 130), (1, 130))), None),
    "s70_shorter_than_a_tile_d128": (1, 70, 70, 4, 1, 128, True, None, None),
    "s129_just_over_a_tile_d72": (2, 129, 129, 2, 2, 72, False, None, None),
    "window_starts_mid_tile_d128": (1, 500, 500, 4, 2, 128, True, None, 100),
    "padding_tiles_d64": (2, 400, 400, 4, 4, 64, True, (400, 120), None),
    **{f"packed_d{d}": (2, 300, 300, 4, 2, d, True, (((1, 130), (2, 100), (0, 70)),
                                                      ((1, 40), (2, 200), (3, 60))), None)
       for d in (16, 64, 72, 128)},
}


def segment_ids(spec, b, s, device):
    """[b, s] int32 ids from a CARD_CASES segment spec, or None."""
    if spec is None:
        return None
    if isinstance(spec[0], int):  # valid lengths, then padding
        return (torch.arange(s, device=device)[None]
                < torch.tensor(spec, device=device)[:, None]).int()
    seg = torch.zeros((b, s), dtype=torch.int32)
    for r, runs in enumerate(spec):
        start = 0
        for sid, n in runs:
            seg[r, start:start + n] = sid
            start += n
    return seg.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES), ids=list(CARD_CASES))
def test_kernel_matches_plain_on_card(cuda, case):
    dtype = torch.bfloat16
    b, sq, skv, hq, hkv, d, causal, spec, window = CARD_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, sq, hq, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, skv, hkv, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, skv, hkv, d), generator=g, device=cuda).to(dtype)
    seg = segment_ids(spec, b, sq, cuda)
    kw = dict(causal=causal, q_segment_ids=seg, kv_segment_ids=seg, sliding_window=window)
    before = tflash.flash_attention.launches
    got = tflash.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tflash.flash_attention.launches == before + 1
    want = tflash.flash_attention_ref(q, k, v, **kw)
    valid = torch.ones((b, sq), dtype=torch.bool, device=cuda) if seg is None else seg.bool()
    # one bf16 output rounding (2^-8 relative) on each side, and P rounded
    # to bf16 against the running max in the kernel, the final one in plain
    torch.testing.assert_close(got[valid].float(), want[valid].float(), rtol=1e-2, atol=1e-2)
    assert torch.isfinite(got).all()


@pytest.mark.cuda
def test_unsupported_head_dim_raises_on_card(cuda):
    q = torch.zeros((1, 8, 2, 96), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 96"):
        tflash.flash_attention(q, q, q)


@pytest.mark.cuda
def test_float32_raises_on_card(cuda):
    q = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        tflash.flash_attention(q, q, q)


@pytest.mark.cuda
def test_strided_inputs_on_card(cuda):
    """q/k/v as views of one packed buffer whose row stride (940 elements) and
    base offsets are not 16-byte multiples, which TMA cannot address: the
    wrapper copies each of the three and counts the copies."""
    g = torch.Generator(device=cuda).manual_seed(1)
    buf = torch.randn((2, 130, 12 * 72 + 76), generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = (buf[:, :, 4 + i * 288: 4 + (i + 1) * 288].unflatten(-1, (4, 72)) for i in range(3))
    before = tflash.flash_attention.copies
    got = tflash.flash_attention(q, k, v, causal=False)
    assert tflash.flash_attention.copies == before + 3
    want = tflash.flash_attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
def test_cache_views_on_card(cuda):
    """The decoder's cache views: k and v as the two halves of one
    [B, S, 2 Hkv, D] buffer (layer_kv[:, :, :hkv], layer_kv[:, :, hkv:]),
    read in place by TMA, without a copy."""
    g = torch.Generator(device=cuda).manual_seed(2)
    b, s, hq, hkv, d = 2, 300, 8, 2, 128
    q = torch.randn((b, s, hq, d), generator=g, device=cuda).to(torch.bfloat16)
    layer_kv = torch.randn((b, s + 60, 2 * hkv, d), generator=g, device=cuda).to(torch.bfloat16)
    k, v = layer_kv[:, :s, :hkv], layer_kv[:, :s, hkv:]
    seg = segment_ids((300, 211), b, s, cuda)
    kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
    before = tflash.flash_attention.copies
    got = tflash.flash_attention(q, k, v, **kw)
    assert tflash.flash_attention.copies == before
    want = tflash.flash_attention_ref(q, k, v, **kw)
    valid = seg.bool()
    torch.testing.assert_close(got[valid].float(), want[valid].float(), rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
def test_padding_rows_are_exact_zeros_on_card(cuda):
    """Rows of a q tile that is all padding (its kv range is empty, so the
    kernel skips every kv tile) and padding rows of a mixed tile: output
    exactly 0 and lse about -1e30, which the backward relies on."""
    b, sq, skv, hq, hkv, d, causal, spec, window = CARD_CASES["padding_tiles_d64"]
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((b, sq, hq, d), generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn((b, skv, hkv, d), generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn((b, skv, hkv, d), generator=g, device=cuda).to(torch.bfloat16)
    seg = segment_ids(spec, b, sq, cuda)
    out, lse = tflash._launch(q, k, v, causal=causal, q_segment_ids=seg, kv_segment_ids=seg,
                              sliding_window=window, with_lse=True)
    pad = seg == 0
    assert bool((out[pad] == 0).all())
    assert bool((lse.transpose(1, 2)[pad] < -1e29).all())
