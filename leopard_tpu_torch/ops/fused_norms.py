"""Fused RMSNorm and LayerNorm for Hopper (K3a in Triton, K3b in CUDA C++)
and their plain versions.

Ports of the TPU kernels leopard_tpu/ops/pallas/norms.py (`fused_rms_norm` /
`_rms_kernel`, `fused_layer_norm` / `_ln_kernel`): each reads a row once,
takes its statistics in fp32, and writes the normalized row in x's dtype.
What bounds both on the H100: bytes, one read of x and one write of y per
row (a few operations an element, no tensor-core work). The eager plain
version makes about six passes over the row in fp32.

  - K3a, `fused_rms_norm`: the Triton `rms_kernel` below, one program a
    row holding the row in registers. It reaches 0.81-0.89 of the byte
    bound at the decoder's rows.
  - K3b, `fused_layer_norm`: csrc/layer_norm.cu, built by ops/_build.py and
    called through ctypes. A warp a row, the row in registers, each
    lane's sums in fp32 and the 32 lanes' added by warp shuffles in fp64;
    persistent blocks, w and b in registers once a warp, and the next rows
    in flight in a ring of shared-memory slots that bulk copies fill. The vector width comes from
    `vector_bytes`; a view the ring cannot read (a misaligned base or row
    stride, odd widths) takes the kernel's three-pass path in place, never
    a copy.
  - On a CUDA tensor the wrappers launch their kernel or raise; there is no
    fallback. On a CPU tensor they compute the plain versions
    (ops/norms.py).
  - The backward recomputes through the plain versions, as the JAX
    package's `_rms_bwd` / `_ln_bwd` do (norms.py:78-81,112-115).

Nothing is compiled or imported for a kernel when this module is imported:
`triton` at K3a's first launch (its cache in build/triton unless
TRITON_CACHE_DIR says otherwise), the K3b library at K3b's first launch.
`fused_rms_norm.launches` and `fused_layer_norm.launches` count launches.
"""

from __future__ import annotations

import ctypes
import os

import torch

from leopard_tpu_torch.ops._build import BUILD_DIR
from leopard_tpu_torch.ops.norms import layer_norm_ref, rms_norm_ref

MAX_WIDTH = 16384  # K3a holds a row in registers: 64 KB of fp32 over 16 warps
LN_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}  # csrc/layer_norm.cu

tl = None  # triton.language, bound at the first launch
_kernels_cache = None


def _kernels():
    """The compile-ready Triton kernel (rms), defined at the first call."""
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

    _kernels_cache = (triton.next_power_of_2, rms_kernel)
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


def vector_bytes(row_bytes: int, *offsets: int) -> int:
    """The width in bytes of K3b's loads and stores: 16 where it divides the
    row's bytes and every offset (base addresses, row strides in bytes) and
    16-byte vectors split the row evenly over a warp's 32 lanes; else 8
    where 8-byte vectors do (1,152 bf16: 288 of them, 9 a lane); else the
    widest power of two, 16 at most, that divides them all (4, or 2, a
    single bf16 element, for a view that starts off the 8-byte grid)."""
    width = 16
    for n in (row_bytes, *offsets):
        while n % width:
            width //= 2
    if width == 16 and (row_bytes // 16) % 32 and not (row_bytes // 8) % 32:
        width = 8
    return width


_lib = None


def _library():
    """K3b's library, built and bound at first use."""
    global _lib
    if _lib is None:
        from leopard_tpu_torch.ops._build import load_library

        lib = load_library("layer_norm")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # x w b out rows h x_stride out_stride eps dtype w_dtype b_dtype vec_bytes device stream
        lib.leopard_layer_norm.argtypes = [p, p, p, p, ll, i, ll, ll, ctypes.c_float, i, i, i,
                                           i, i, p]
        lib.leopard_layer_norm.restype = i
        lib.leopard_layer_norm_error_string.argtypes = [i]
        lib.leopard_layer_norm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch_ln(x2: torch.Tensor, w: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
               eps: float) -> None:
    if w.dtype not in LN_DTYPES or b.dtype not in LN_DTYPES:
        raise ValueError(f"K3b takes bf16, fp16 or fp32 parameters, not {w.dtype}, {b.dtype}")
    lib = _library()
    rows, h = x2.shape
    size = x2.element_size()
    strides = (x2.stride(0) * size, out.stride(0) * size) if rows > 1 else ()
    vec = vector_bytes(h * size, x2.data_ptr(), out.data_ptr(), *strides)
    rc = lib.leopard_layer_norm(x2.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), rows,
                                h, x2.stride(0), out.stride(0), eps, LN_DTYPES[x2.dtype],
                                LN_DTYPES[w.dtype], LN_DTYPES[b.dtype], vec, x2.get_device(),
                                torch.cuda.current_stream(x2.device).cuda_stream)
    if rc != 0:
        msg = lib.leopard_layer_norm_error_string(rc).decode()
        raise RuntimeError(f"layer_norm kernel launch failed: {msg} ({rc})")


def _launch(kind: str, x: torch.Tensor, params, eps: float) -> torch.Tensor:
    x2 = _rows(x, params)
    out = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    rows, h = x2.shape
    if rows:
        if kind == "rms":
            next_pow2, rms_kernel = _kernels()
            block = next_pow2(h)
            with torch.cuda.device(x.device):
                rms_kernel[(rows,)](x2, *params, out, x2.stride(0), out.stride(0), h,
                                    float(eps), BLOCK=block,
                                    num_warps=min(max(block // 256, 1), 16))
            fused_rms_norm.launches += 1
        else:
            _launch_ln(x2, *params, out, eps)
            fused_layer_norm.launches += 1
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
