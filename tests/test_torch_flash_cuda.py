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
    # name: (b, sq, skv, hq, hkv, d, causal, lengths or None, window)
    "vision_ragged_d72": (3, 676, 676, 4, 4, 72, False, None, None),
    "decoder_gqa_d128_padded": (2, 300, 300, 8, 2, 128, True, (300, 171), None),
    "d64_window": (1, 200, 200, 4, 2, 64, True, None, 50),
    "d16_cross_len": (2, 70, 130, 2, 1, 16, False, None, None),
    "decoder_long_causal": (1, 1100, 1100, 4, 1, 128, True, None, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES), ids=list(CARD_CASES))
def test_kernel_matches_plain_on_card(cuda, case):
    dtype = torch.bfloat16
    b, sq, skv, hq, hkv, d, causal, lengths, window = CARD_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, sq, hq, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, skv, hkv, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, skv, hkv, d), generator=g, device=cuda).to(dtype)
    seg = None
    if lengths is not None:
        seg = (torch.arange(sq, device=cuda)[None] < torch.tensor(lengths, device=cuda)[:, None]).int()
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
    base offsets are not 16-byte multiples: the kernel reads through strides
    with scalar loads there."""
    g = torch.Generator(device=cuda).manual_seed(1)
    buf = torch.randn((2, 130, 12 * 72 + 76), generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = (buf[:, :, 4 + i * 288: 4 + (i + 1) * 288].unflatten(-1, (4, 72)) for i in range(3))
    got = tflash.flash_attention(q, k, v, causal=False)
    want = tflash.flash_attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)
