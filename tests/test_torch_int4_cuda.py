"""The Hopper int4 matmul kernel (K4) against its plain version, on the card.

These tests need an NVIDIA GPU and skip elsewhere. The file imports no JAX,
so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_int4_cuda.py
"""

import pytest
import torch

from leopard_tpu_torch.models.params import QuantizedWeight
from leopard_tpu_torch.ops import int4_matmul as tk4
from leopard_tpu_torch.ops import quant as tquant


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(m, k, n, dtype, device, seed=0, group=128):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=device).to(dtype)
    w = torch.randn((n, k), generator=g, device=device) * k**-0.5  # port layout [N, K]
    q = tquant.quantize_int4(w, group=group)
    return x, q["q4"], q["s"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [128, 384, 1024])
@pytest.mark.parametrize("k", [256, 512, 14336])
@pytest.mark.parametrize("m", [1, 3, 17, 64])
def test_kernel_matches_plain_on_card(cuda, m, k, n, dtype):
    x, q4, s = _operands(m, k, n, dtype, cuda, seed=m + k + n)
    before = tk4.int4_matmul.launches
    got = tk4.int4_matmul(x, q4, s)
    torch.cuda.synchronize()
    assert tk4.int4_matmul.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, n)
    want = tk4.int4_matmul_ref(x, q4, s)
    # outputs have std ~1; the plain version rounds each weight to bf16
    # (2^-9 relative), the kernel keeps it in fp32, and the sums run in
    # another order
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
    assert torch.isfinite(got).all()


@pytest.mark.cuda
def test_kernel_is_deterministic_on_card(cuda):
    x, q4, s = _operands(2, 4096, 1024, torch.bfloat16, cuda)  # K split across blocks
    a = tk4.int4_matmul(x, q4, s)
    b = tk4.int4_matmul(x, q4, s)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_matmul_takes_the_kernel_tier_on_card(cuda):
    x, q4, s = _operands(2, 512, 256, torch.bfloat16, cuda)
    w = QuantizedWeight({"q4": q4, "s": s})
    before = tk4.int4_matmul.launches
    y = tquant.matmul(x[:, None], w)  # [B, 1, K], a decode step
    assert tk4.int4_matmul.launches == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == (2, 1, 256)
    xp = torch.randn((65, 512), device=cuda, dtype=torch.bfloat16)  # M > 64: dense path
    tquant.matmul(xp, w)
    assert tk4.int4_matmul.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["m65", "group64", "n_not_128"])
def test_unsupported_shapes_raise_on_card(cuda, case):
    shape = {"m65": (65, 256, 128), "group64": (2, 256, 128), "n_not_128": (2, 256, 192)}[case]
    x, q4, s = _operands(*shape, torch.bfloat16, cuda,
                         group=64 if case == "group64" else 128)
    before = tk4.int4_matmul.launches
    with pytest.raises(ValueError):
        tk4.int4_matmul(x, q4, s)
    assert tk4.int4_matmul.launches == before
