"""Fused RMSNorm and LayerNorm: Triton kernels for Hopper (K3a/K3b) and
their plain versions.

Port of the TPU kernels leopard_tpu/ops/pallas/norms.py (`fused_rms_norm` /
`_rms_kernel`, `fused_layer_norm` / `_ln_kernel`): one program per row reads
the row once, takes its statistics in fp32, and writes the normalized row in
x's dtype. What bounds them on the H100: bytes, one read of x and one write
of y per row (no tensor-core work, a reduction per row); the design keeps the
whole row in registers so that x is read from device memory only once. The
eager plain version makes about six passes over the row in fp32.

  - on a CUDA tensor `fused_rms_norm` / `fused_layer_norm` launch the kernel
    or raise; there is no fallback;
  - on a CPU tensor they compute the plain versions (ops/norms.py);
  - the backward recomputes through the plain versions, as the JAX package's
    `_rms_bwd` / `_ln_bwd` do (norms.py:78-81,112-115).

`triton` is imported, and the kernels are compiled, at the first launch, never
when this module is imported. Triton's cache goes to build/triton unless
TRITON_CACHE_DIR says otherwise. `fused_rms_norm.launches` and
`fused_layer_norm.launches` count launches.
"""

from __future__ import annotations

import os

import torch

from leopard_tpu_torch.ops._build import BUILD_DIR
from leopard_tpu_torch.ops.norms import layer_norm_ref, rms_norm_ref

MAX_WIDTH = 16384  # one row lives in registers: 64 KB of fp32 over 16 warps

tl = None  # triton.language, bound at the first launch
_kernels_cache = None


def _kernels():
    """Compile-ready Triton kernels (rms, ln), defined at the first call."""
    global tl, _kernels_cache
    if _kernels_cache is not None:
        return _kernels_cache
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def rms_kernel(x_ptr, w_ptr, o_ptr, x_stride, o_stride, n_cols, eps,
                   BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        mask = cols < n_cols
        x = tl.load(x_ptr + row * x_stride + cols, mask=mask, other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=0) / n_cols
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        y = x * tl.rsqrt(var + eps) * w
        tl.store(o_ptr + row * o_stride + cols, y.to(o_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def ln_kernel(x_ptr, w_ptr, b_ptr, o_ptr, x_stride, o_stride, n_cols, eps,
                  BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        mask = cols < n_cols
        x = tl.load(x_ptr + row * x_stride + cols, mask=mask, other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=0) / n_cols
        xc = tl.where(mask, x - mean, 0.0)
        var = tl.sum(xc * xc, axis=0) / n_cols
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        b = tl.load(b_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        y = xc * tl.rsqrt(var + eps) * w + b
        tl.store(o_ptr + row * o_stride + cols, y.to(o_ptr.dtype.element_ty), mask=mask)

    _kernels_cache = (triton.next_power_of_2, rms_kernel, ln_kernel)
    return _kernels_cache


def _rows(x: torch.Tensor, params) -> torch.Tensor:
    """x as [rows, H] with a unit column stride; checks the parameters."""
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"fused norms take bf16, fp16 or fp32, not {x.dtype}")
    h = x.shape[-1]
    if h > MAX_WIDTH:
        raise ValueError(f"row width {h} above the kernel's {MAX_WIDTH}")
    for p in params:
        if p.device != x.device or p.shape != (h,) or p.stride(0) != 1:
            raise ValueError(f"parameter {tuple(p.shape)} on {p.device} does not fit x "
                             f"{tuple(x.shape)} on {x.device}")
    x2 = x.reshape(-1, h)
    return x2 if x2.stride(-1) == 1 else x2.contiguous()


def _launch(kind: str, x: torch.Tensor, params, eps: float) -> torch.Tensor:
    next_pow2, rms_kernel, ln_kernel = _kernels()
    x2 = _rows(x, params)
    out = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    rows, h = x2.shape
    if rows:
        block = next_pow2(h)
        kernel = rms_kernel if kind == "rms" else ln_kernel
        with torch.cuda.device(x.device):
            kernel[(rows,)](x2, *params, out, x2.stride(0), out.stride(0), h, float(eps),
                            BLOCK=block, num_warps=min(max(block // 256, 1), 16))
        (fused_rms_norm if kind == "rms" else fused_layer_norm).launches += 1
    return out.reshape(x.shape)


class _FusedNorm(torch.autograd.Function):
    """Forward: the kernel. Backward: the VJP of the plain version."""

    @staticmethod
    def forward(ctx, kind, eps, x, *params):
        ctx.kind, ctx.eps = kind, eps
        ctx.save_for_backward(x, *params)
        return _launch(kind, x, params, eps)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        ref = rms_norm_ref if ctx.kind == "rms" else layer_norm_ref
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (x, *params)]
            grads = torch.autograd.grad(ref(*inputs, ctx.eps), inputs, g)
        return (None, None, *grads)


def _fused(kind: str, x: torch.Tensor, params, eps: float) -> torch.Tensor:
    if x.device.type == "cpu":
        ref = rms_norm_ref if kind == "rms" else layer_norm_ref
        return ref(x, *params, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused norms run on cuda or cpu, not {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        return _FusedNorm.apply(kind, eps, x, *params)
    return _launch(kind, x, params, eps)


def fused_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x [..., H] → same shape and dtype; statistics in fp32."""
    return _fused("rms", x, (weight,), eps)


def fused_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """x [..., H] → same shape and dtype; statistics in fp32."""
    return _fused("ln", x, (weight, bias), eps)


fused_rms_norm.launches = 0
fused_layer_norm.launches = 0
