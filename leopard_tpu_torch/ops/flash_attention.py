"""Flash-attention forward: the Hopper kernel (csrc/flash_attention.cu) and
its plain version.

Port of the TPU kernel leopard_tpu/ops/pallas/flash_attention.py
(_flash_forward / _flash_kernel). `flash_attention` takes the JAX layout,
q [B, Sq, Hq, D] and k/v [B, Skv, Hkv, D]:

  - on a CUDA tensor it launches the kernel or raises; there is no fallback;
  - on a CPU tensor it computes `flash_attention_ref`, dense fp32 math with
    the same semantics (ops/attention.py).

Masking is the full segment mask (q_seg == kv_seg, both non-zero). On a
right-padded batch it gives the valid rows the same result as the TPU
kernel's `kv_only_mask`. Fully-masked rows (padding queries) are don't-care:
the kernel returns 0 there and the plain version a uniform average, so
callers compare and use valid rows only.

`flash_attention.launches` counts kernel launches, so a run can show that
its path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from leopard_tpu_torch.ops.attention import attention

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
    if q.device.type == "cpu":
        return flash_attention_ref(
            q, k, v, causal=causal, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, sliding_window=sliding_window,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return _launch(
        q, k, v, causal=causal, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, sliding_window=sliding_window,
    )


flash_attention.launches = 0


def _fill_segments(q, k, q_seg, kv_seg):
    """One segment row given without the other: the missing one is all 1."""
    if q_seg is None and kv_seg is not None:
        q_seg = torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
    if kv_seg is None and q_seg is not None:
        kv_seg = torch.ones(k.shape[:2], dtype=torch.int32, device=k.device)
    return q_seg, kv_seg


def _check(q, k, v):
    b, sq, hq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if hq % k.shape[2]:
        raise ValueError(f"{hq} q heads not a multiple of {k.shape[2]} kv heads")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in the kernel's {SUPPORTED_HEAD_DIMS}")
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the kernel takes bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a contiguous head dim (stride {t.stride(3)})")


def _library():
    from leopard_tpu_torch.ops._build import load_library

    lib = load_library("flash_attention")
    fn = lib.leopard_flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [
            p, p, p, p, p, p,             # q k v o q_seg kv_seg
            i, i, i, i, i, i,             # B Sq Skv Hq Hkv D
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_float, i, i, p,      # scale causal window stream
        ]
        fn.restype = ctypes.c_int
        lib.leopard_cuda_error_string.argtypes = [i]
        lib.leopard_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, k, v, *, causal, q_segment_ids, kv_segment_ids, sliding_window):
    _check(q, k, v)
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    q_seg, kv_seg = _fill_segments(q, k, q_segment_ids, kv_segment_ids)
    if q_seg is not None:
        q_seg = q_seg.to(device=q.device, dtype=torch.int32).contiguous()
        kv_seg = kv_seg.to(device=q.device, dtype=torch.int32).contiguous()
        if q_seg.shape != (b, sq) or kv_seg.shape != (b, skv):
            raise ValueError(f"segment ids {tuple(q_seg.shape)}, {tuple(kv_seg.shape)} do not fit")
    if sliding_window is not None and sliding_window <= 0:
        raise ValueError(f"sliding_window must be positive, got {sliding_window}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 14)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        q_seg.stride(0) if q_seg is not None else 0,
        kv_seg.stride(0) if kv_seg is not None else 0,
    )
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.leopard_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q_seg.data_ptr() if q_seg is not None else None,
            kv_seg.data_ptr() if kv_seg is not None else None,
            b, sq, skv, hq, hkv, d, strides,
            float(d**-0.5), int(causal),
            int(sliding_window or 0), stream,
        )
    if rc != 0:
        msg = lib.leopard_cuda_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} ({rc})")
    flash_attention.launches += 1
    return out
