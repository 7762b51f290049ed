"""Flash attention: the Hopper kernels (csrc/flash_attention.cu, the forward
K1; csrc/flash_attention_bwd.cu, the backward K2) and their plain versions.

Port of the TPU kernels leopard_tpu/ops/pallas/flash_attention.py
(_flash_forward / _flash_kernel; _flash_backward with its dq and dk/dv
kernels; the `_flash` custom_vjp). `flash_attention` takes the JAX layout,
q [B, Sq, Hq, D] and k/v [B, Skv, Hkv, D]:

  - on a CUDA tensor it launches the kernels or raises; there is no fallback;
  - on a CPU tensor it computes the plain versions, `flash_attention_ref` and
    `flash_attention_bwd_ref`, dense fp32 math with the same semantics
    (ops/attention.py).

When autograd needs it (grad enabled and an input that requires grad),
`flash_attention` is a `torch.autograd.Function`: the forward also writes
the per-row logsumexp, [B, Hq, Sq] fp32, and the backward is K2 (on the CPU,
the plain versions of both). Otherwise the forward writes no lse, as
serving needs none.

Masking is the full segment mask (q_seg == kv_seg, both non-zero). On a
right-padded batch it gives the valid rows the same result as the TPU
kernel's `kv_only_mask`, and it is the mask packed training rows need.
Fully-masked rows (padding queries) are don't-care in the forward: the
kernel returns 0 there and the plain version a uniform average, so callers
compare and use valid rows only. Their gradients are exactly 0 in both
backward versions, which exponentiate only where the mask lets a pair
through.

`flash_attention.launches` counts K1 launches and
`flash_attention_bwd.launches` K2 launches (one a backward: its dq and dk/dv
kernels), so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from leopard_tpu_torch.ops.attention import NEG_INF, attention, make_attention_mask

SUPPORTED_HEAD_DIMS = (16, 64, 72, 128)


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """The kernel's plain version: dense attention with the same masks."""
    q_segment_ids, kv_segment_ids = _fill_segments(q, k, q_segment_ids, kv_segment_ids)
    return attention(
        q, k, v, causal=causal,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        sliding_window=sliding_window,
    )


def _scores_and_mask(q, k, q_seg, kv_seg, causal, sliding_window):
    """Dense scaled scores [B, Hkv, G, Sq, Skv] fp32 and the mask
    [B|1, 1, 1, Sq, Skv] (None: every pair attends)."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    qg = q.reshape(b, sq, hkv, hq // hkv, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * d**-0.5
    mask = make_attention_mask(
        sq, skv, causal=causal, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
        sliding_window=sliding_window, device=q.device,
    )
    return s, None if mask is None else mask[:, :, None]


def flash_attention_lse_ref(q, k, v, *, causal=True, q_segment_ids=None,
                            kv_segment_ids=None, sliding_window=None) -> torch.Tensor:
    """The plain version of K1's lse output: logsumexp over the masked,
    scaled scores, [B, Hq, Sq] fp32 (about -1e30 on a fully-masked row)."""
    q_seg, kv_seg = _fill_segments(q, k, q_segment_ids, kv_segment_ids)
    s, mask = _scores_and_mask(q, k, q_seg, kv_seg, causal, sliding_window)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    b, sq, hq, _ = q.shape
    return torch.logsumexp(s, dim=-1).reshape(b, hq, sq)


def flash_attention_bwd_ref(q, k, v, q_segment_ids, kv_segment_ids, out, lse, dout, *,
                            causal=True, sliding_window=None):
    """K2's plain version: the same formulas, dense, in fp32.

    P = where(mask, exp(scale·QKᵀ − lse), 0); delta = rowsum(dO·O);
    dS = P·(dO·Vᵀ − delta)·scale; dQ = dS·K, dK = dSᵀ·Q, dV = Pᵀ·dO, the
    last two summed over each GQA group. Returns (dq, dk, dv) in the dtypes
    of q, k and v."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    q_seg, kv_seg = _fill_segments(q, k, q_segment_ids, kv_segment_ids)
    s, mask = _scores_and_mask(q, k, q_seg, kv_seg, causal, sliding_window)
    p = torch.exp(s - lse.float().reshape(b, hkv, g, sq, 1))
    if mask is not None:
        p = torch.where(mask, p, 0.0)  # a select: masked pairs never reach exp's value
    do = dout.float().reshape(b, sq, hkv, g, d)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do)
    delta = _delta(out, dout).reshape(b, hkv, g, sq, 1)
    ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", do, v.float()) - delta) * d**-0.5
    del p
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()).reshape(b, sq, hq, d)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, q.reshape(b, sq, hkv, g, d).float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _delta(out, dout) -> torch.Tensor:
    """rowsum(dO·O) in fp32 as [B, Hq, Sq], computed outside the kernels as
    the JAX package computes it outside its own (flash_attention.py:464-467)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Returns [B, Sq, Hq, D] in q.dtype; scores are scaled by D^-0.5."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if sliding_window is not None and sliding_window <= 0:
        raise ValueError(f"sliding_window must be positive, got {sliding_window}")
    kw = dict(causal=causal, q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
              sliding_window=sliding_window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, q_segment_ids, kv_segment_ids, causal,
                                     sliding_window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, **kw)
    return _launch(q, k, v, **kw)[0]


def flash_attention_bwd(q, k, v, q_segment_ids, kv_segment_ids, out, lse, dout, *,
                        causal=True, sliding_window=None):
    """Gradients (dq, dk, dv) of `flash_attention` from its output and lse:
    K2 on a CUDA tensor, the plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, q_segment_ids, kv_segment_ids, out, lse,
                                       dout, causal=causal, sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, not {q.device}")
    return _launch_bwd(q, k, v, q_segment_ids, kv_segment_ids, out, lse, dout,
                       causal=causal, sliding_window=sliding_window)


flash_attention.launches = 0
flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The `_flash` custom_vjp of the JAX package: the forward saves its
    output and lse, the backward is K2."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal, sliding_window):
        kw = dict(causal=causal, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                  sliding_window=sliding_window)
        if q.device.type == "cpu":
            out = flash_attention_ref(q, k, v, **kw)
            lse = flash_attention_lse_ref(q, k, v, **kw)
        else:
            out, lse = _launch(q, k, v, with_lse=True, **kw)
        ctx.causal, ctx.sliding_window = causal, sliding_window
        ctx.save_for_backward(q, k, v, q_seg, kv_seg, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_seg, kv_seg, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, q_seg, kv_seg, out, lse, dout,
                                         causal=ctx.causal, sliding_window=ctx.sliding_window)
        return dq, dk, dv, None, None, None, None


def _fill_segments(q, k, q_seg, kv_seg):
    """One segment row given without the other: the missing one is all 1."""
    if q_seg is None and kv_seg is not None:
        q_seg = torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
    if kv_seg is None and q_seg is not None:
        kv_seg = torch.ones(k.shape[:2], dtype=torch.int32, device=k.device)
    return q_seg, kv_seg


def _check(q, k, v, *others):
    b, sq, hq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if hq % k.shape[2]:
        raise ValueError(f"{hq} q heads not a multiple of {k.shape[2]} kv heads")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in the kernel's {SUPPORTED_HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v), *others):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} is {t.dtype}: the kernel takes bfloat16")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a contiguous head dim (stride {t.stride(3)})")


_ARGTYPES = {
    # q k v o lse q_seg kv_seg, B Sq Skv Hq Hkv D, strides, scale causal window stream
    "flash_attention": ("leopard_flash_attention_fwd", 7),
    # q k v dout lse delta dq dk dv q_seg kv_seg, then as above
    "flash_attention_bwd": ("leopard_flash_attention_bwd", 11),
}


def _library(name: str):
    """The loaded kernel library and its entry point, built at first use."""
    from leopard_tpu_torch.ops._build import load_library

    lib = load_library(name)
    entry, n_ptrs = _ARGTYPES[name]
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [
            *[p] * n_ptrs, i, i, i, i, i, i,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i, i, p,
        ]
        fn.restype = ctypes.c_int
        lib.leopard_cuda_error_string.argtypes = [i]
        lib.leopard_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _segments(q, k, q_segment_ids, kv_segment_ids):
    """Both segment rows as contiguous int32 on q's device, or both None."""
    b, sq = q.shape[:2]
    skv = k.shape[1]
    q_seg, kv_seg = _fill_segments(q, k, q_segment_ids, kv_segment_ids)
    if q_seg is None:
        return None, None
    q_seg = q_seg.to(device=q.device, dtype=torch.int32).contiguous()
    kv_seg = kv_seg.to(device=q.device, dtype=torch.int32).contiguous()
    if q_seg.shape != (b, sq) or kv_seg.shape != (b, skv):
        raise ValueError(f"segment ids {tuple(q_seg.shape)}, {tuple(kv_seg.shape)} do not fit")
    return q_seg, kv_seg


def _call(name, fn, lib, device, *args):
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        msg = lib.leopard_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")


def _launch(q, k, v, *, causal, q_segment_ids, kv_segment_ids, sliding_window,
            with_lse=False):
    """K1: (out, lse [B, Hq, Sq] fp32 or None)."""
    _check(q, k, v)
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    q_seg, kv_seg = _segments(q, k, q_segment_ids, kv_segment_ids)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if with_lse else None
    strides = (ctypes.c_longlong * 14)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        q_seg.stride(0) if q_seg is not None else 0,
        kv_seg.stride(0) if kv_seg is not None else 0,
    )
    lib, fn = _library("flash_attention")
    _call("flash_attention", fn, lib, q.device,
          q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
          lse.data_ptr() if lse is not None else None,
          q_seg.data_ptr() if q_seg is not None else None,
          kv_seg.data_ptr() if kv_seg is not None else None,
          b, sq, skv, hq, hkv, d, strides, float(d**-0.5), int(causal),
          int(sliding_window or 0))
    flash_attention.launches += 1
    return out, lse


def _launch_bwd(q, k, v, q_segment_ids, kv_segment_ids, out, lse, dout, *, causal,
                sliding_window):
    """K2: (dq, dk, dv) in bf16."""
    _check(q, k, v, ("out", out), ("dout", dout))
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} / dout {tuple(dout.shape)} do not fit q")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous fp32 [B, Hq, Sq], got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    q_seg, kv_seg = _segments(q, k, q_segment_ids, kv_segment_ids)
    delta = _delta(out, dout)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    strides = (ctypes.c_longlong * 23)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *dout.stride()[:3],
        *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
        q_seg.stride(0) if q_seg is not None else 0,
        kv_seg.stride(0) if kv_seg is not None else 0,
    )
    lib, fn = _library("flash_attention_bwd")
    _call("flash_attention_bwd", fn, lib, q.device,
          q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
          lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
          q_seg.data_ptr() if q_seg is not None else None,
          kv_seg.data_ptr() if kv_seg is not None else None,
          b, sq, skv, hq, hkv, d, strides, float(d**-0.5), int(causal),
          int(sliding_window or 0))
    flash_attention_bwd.launches += 1
    return dq, dk, dv
