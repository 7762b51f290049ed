"""The Triton fused norms (K3a/K3b) against their plain versions, on the
card, at the training and serving path's shapes.

These tests need an NVIDIA GPU and skip elsewhere. The file imports no JAX,
so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_norms_cuda.py

Tolerance: bf16 outputs rtol = atol = 1.6e-2 (one bf16 rounding, 2^-8
relative, of values up to ~4 on each side, in another order); fp32 outputs
rtol = atol = 1e-5 (fp32 statistics summed in another order).
"""

import pytest
import torch

from leopard_tpu_torch.ops import fused_norms
from leopard_tpu_torch.ops import norms

TOL = {torch.bfloat16: dict(rtol=1.6e-2, atol=1.6e-2), torch.float32: dict(rtol=1e-5, atol=1e-5)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Triton kernel has no CPU mode")
    return torch.device("cuda")


CASES = {
    # name: (kind, x shape)
    "rms_decoder_train_rows": ("rms", (2, 4096, 4096)),
    "rms_decode_rows": ("rms", (2, 1, 4096)),
    "rms_odd_width": ("rms", (5, 72)),
    "ln_tower_rows": ("ln", (16, 676, 1152)),
    "ln_odd_width": ("ln", (7, 100)),
}


def _inputs(kind, shape, dtype, device):
    g = torch.Generator(device=device).manual_seed(0)
    x = (torch.randn(shape, generator=g, device=device) * 2 + 0.5).to(dtype)
    params = [torch.randn(shape[-1], generator=g, device=device).to(dtype)
              for _ in range(1 if kind == "rms" else 2)]
    return x, params


def _fns(kind):
    if kind == "rms":
        return fused_norms.fused_rms_norm, norms.rms_norm_ref
    return fused_norms.fused_layer_norm, norms.layer_norm_ref


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_forward_matches_plain_on_card(cuda, case, dtype):
    kind, shape = CASES[case]
    x, params = _inputs(kind, shape, dtype, cuda)
    fused, ref = _fns(kind)
    before = fused.launches
    got = fused(x, *params)
    torch.cuda.synchronize()
    assert fused.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), ref(x, *params).float(), **TOL[dtype])


@pytest.mark.cuda
def test_strided_rows_on_card(cuda):
    """Rows of a wider buffer (row stride 1,200, not the width)."""
    buf = torch.randn((64, 1200), device=cuda).to(torch.bfloat16)
    x = buf[:, 10:1162]
    w, b = torch.randn(1152, device=cuda).bfloat16(), torch.randn(1152, device=cuda).bfloat16()
    torch.testing.assert_close(fused_norms.fused_layer_norm(x, w, b).float(),
                               norms.layer_norm_ref(x, w, b).float(), **TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_autograd_matches_plain_on_card(cuda, kind):
    """The kernel forward with the plain version's VJP as its backward
    against plain autograd, in fp32."""
    x, params = _inputs(kind, (3, 33, 256), torch.float32, cuda)
    fused, ref = _fns(kind)
    g = torch.randn(x.shape, device=cuda)
    a = [t.clone().requires_grad_() for t in (x, *params)]
    b = [t.clone().requires_grad_() for t in (x, *params)]
    got = torch.autograd.grad(fused(*a), a, g)
    want = torch.autograd.grad(ref(*b), b, g)
    for u, w in zip(got, want):
        torch.testing.assert_close(u, w, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_models_route_norms_through_the_kernels(cuda):
    """ops/norms.py sends CUDA tensors to the kernels."""
    x, (w,) = _inputs("rms", (4, 64), torch.bfloat16, cuda)
    before = fused_norms.fused_rms_norm.launches
    norms.rms_norm(x, w)
    assert fused_norms.fused_rms_norm.launches == before + 1
