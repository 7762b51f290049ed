"""The fused norms, K3a (Triton) and K3b (CUDA, csrc/layer_norm.cu), against
their plain versions, on the card, at the training and serving path's
shapes, and K3b on its other routes: rows that do not fill the last block,
one row and none, a misaligned row-strided view, the scalar loads of odd
views and the three-pass kernel at the widest row.

These tests need an NVIDIA GPU and skip elsewhere. The file imports no JAX,
so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_norms_cuda.py

Tolerance: bf16 outputs rtol = atol = 1.6e-2 (one bf16 rounding, 2^-8
relative, of values up to ~4 on each side, in another order); fp16 outputs
rtol = atol = 2e-3 (the same for fp16's 2^-11); fp32 outputs rtol = atol =
1e-5 (fp32 statistics summed in another order).
"""

import pytest
import torch

from leopard_tpu_torch.ops import fused_norms
from leopard_tpu_torch.ops import norms

TOL = {torch.bfloat16: dict(rtol=1.6e-2, atol=1.6e-2), torch.float16: dict(rtol=2e-3, atol=2e-3),
       torch.float32: dict(rtol=1e-5, atol=1e-5)}
DTYPES = [torch.bfloat16, torch.float16, torch.float32]
DTYPE_IDS = ["bf16", "fp16", "fp32"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Triton and CUDA kernels have no CPU mode")
    return torch.device("cuda")


CASES = {
    # name: (kind, x shape)
    "rms_decoder_train_rows": ("rms", (2, 4096, 4096)),
    "rms_decode_rows": ("rms", (2, 1, 4096)),
    "rms_odd_width": ("rms", (5, 72)),
    "ln_tower_rows": ("ln", (16, 676, 1152)),
    "ln_odd_width": ("ln", (7, 100)),
    # K3b at the path's rows: 2 requests x 16 tiles (serving), 8 Idefics2
    # images, the CLIP tower's 8 tiles of 577 (width 1,024)
    "ln_serve_rows": ("ln", (32, 676, 1152)),
    "ln_navit_rows": ("ln", (8, 4900, 1152)),
    "ln_clip_rows": ("ln", (8, 577, 1024)),
    # rows that leave the last block of 4 warps part empty; one row; none
    "ln_ragged_rows": ("ln", (4 * 133 + 3, 1152)),
    "ln_one_row": ("ln", (1, 1152)),
    "ln_no_rows": ("ln", (0, 1152)),
    # odd widths 72 and 1,000 on the ring path (16-byte vectors; 100 above,
    # rows of 200 bytes in bf16, which the bulk copy cannot read, takes the
    # three-pass kernel), and the widest row, on the three-pass kernel
    "ln_width_72": ("ln", (9, 72)),
    "ln_width_1000": ("ln", (5, 1000)),
    "ln_max_width": ("ln", (6, fused_norms.MAX_WIDTH)),
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
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_forward_matches_plain_on_card(cuda, case, dtype):
    kind, shape = CASES[case]
    x, params = _inputs(kind, shape, dtype, cuda)
    fused, ref = _fns(kind)
    before = fused.launches
    got = fused(x, *params)
    torch.cuda.synchronize()
    assert fused.launches == before + (x.numel() > 0)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), ref(x, *params).float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_strided_rows_on_card(cuda, dtype):
    """Rows of a wider buffer (row stride 1,200, not the width), starting 10
    elements in: read in place, at the width its base and stride allow."""
    buf = torch.randn((64, 1200), device=cuda).to(dtype)
    x = buf[:, 10:1162]
    w, b = torch.randn(1152, device=cuda).to(dtype), torch.randn(1152, device=cuda).to(dtype)
    assert fused_norms._rows(x, (w, b)).data_ptr() == x.data_ptr()
    torch.testing.assert_close(fused_norms.fused_layer_norm(x, w, b).float(),
                               norms.layer_norm_ref(x, w, b).float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("width", [100, 72, 1000])
def test_scalar_loads_on_card(cuda, width, dtype):
    """Views that start one element into a buffer one element wider than
    the row: no load wider than an element fits them."""
    buf = torch.randn((37, width + 1), device=cuda).to(dtype)
    x = buf[:, 1:]
    w, b = torch.randn(width, device=cuda).to(dtype), torch.randn(width, device=cuda).to(dtype)
    size = x.element_size()
    assert fused_norms.vector_bytes(width * size, x.data_ptr(), (width + 1) * size) == size
    torch.testing.assert_close(fused_norms.fused_layer_norm(x, w, b).float(),
                               norms.layer_norm_ref(x, w, b).float(), **TOL[dtype])


@pytest.mark.cuda
def test_mixed_parameter_dtype_on_card(cuda):
    """bf16 rows with fp32 scale and bias (the three-pass kernel reads any
    of the three parameter dtypes)."""
    x, _ = _inputs("ln", (33, 1152), torch.bfloat16, cuda)
    w, b = torch.randn(1152, device=cuda), torch.randn(1152, device=cuda)
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
