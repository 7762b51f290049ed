"""int4 weight matmul for decode: the Hopper kernel (csrc/int4_matmul.cu) and
its plain version.

Port of the TPU kernel leopard_tpu/ops/pallas/int4_matmul.py (int4_matmul /
_kernel): x [M, K] (cast to bf16) times a split-half packed int4 weight
q4 uint8 [K/2, N] with f32 scales s [K/128, N] per (128-row group, column),
giving f32 [M, N]. Byte (i, n) of q4 holds logical row i in its low nibble and
row i + K/2 in its high nibble, offset-binary (q + 8, q ∈ [-7, 7]).

  - on a CUDA tensor `int4_matmul` launches the kernel or raises; there is no
    fallback;
  - on a CPU tensor it computes `int4_matmul_ref`: x to bf16, the weight as
    (q − 8) · s in fp32 rounded once to bf16, fp32 accumulation.

`int4_matmul.launches` counts kernel launches, so a run can show that its
path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

KERNEL_GROUP = 128
MAX_M = 64
BLOCK_N = 128          # output columns per block (csrc/int4_matmul.cu)
TARGET_BLOCKS = 264    # two blocks per SM on the H100's 132 (measured best of 132-1,056)


def int4_matmul_ref(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: f32 [M, N]."""
    from leopard_tpu_torch.ops.quant import _unpack_int4

    w = _unpack_int4(q4, s).to(torch.bfloat16).float()
    return x.to(torch.bfloat16).float() @ w


def int4_matmul(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [M, K] float × packed int4 [K/2, N] → f32 [M, N]."""
    if x.device.type == "cpu":
        return int4_matmul_ref(x, q4, s)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul runs on cuda or cpu, not {x.device}")
    return _launch(x, q4, s)


int4_matmul.launches = 0


def _check(x, q4, s):
    if x.dim() != 2 or q4.dim() != 2 or s.dim() != 2:
        raise ValueError(f"ranks {x.dim()}, {q4.dim()}, {s.dim()}: x, q4 and s are 2-D")
    m, k = x.shape
    kh, n = q4.shape
    if 2 * kh != k or s.shape[1] != n:
        raise ValueError(f"q4 {tuple(q4.shape)} and s {tuple(s.shape)} do not fit x {tuple(x.shape)}")
    if s.shape[0] * KERNEL_GROUP != k:
        raise ValueError(f"group {k // max(s.shape[0], 1)}: the kernel takes group {KERNEL_GROUP}")
    if not 1 <= m <= MAX_M:
        raise ValueError(f"M={m}: the kernel takes 1 <= M <= {MAX_M}")
    if k % 256 or n % BLOCK_N:
        raise ValueError(f"K={k}, N={n}: the kernel needs K % 256 == 0 and N % {BLOCK_N} == 0")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x dtype {x.dtype}: the kernel takes bfloat16 or float32")
    if q4.dtype != torch.uint8 or s.dtype != torch.float32:
        raise ValueError(f"q4 {q4.dtype}, s {s.dtype}: the kernel takes uint8 and float32")
    for name, t in (("q4", q4), ("s", s)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # the kernel reads q4 in 8-byte and s in 16-byte vectors
    if q4.data_ptr() % 8 or s.data_ptr() % 16:
        raise ValueError("q4 must be 8-byte and s 16-byte aligned")


def _splits(m: int, k: int, n: int) -> tuple[int, int]:
    """(K splits, 128-row groups per split): enough blocks to fill the card
    when N/128 alone is too few (wk/wv: N = 1,024 gives 8)."""
    mt = min(8, 1 << (m - 1).bit_length())
    tiles = (n // BLOCK_N) * (-(-m // mt))
    groups = k // 256  # groups of 128 packed rows
    want = min(groups, -(-TARGET_BLOCKS // tiles))
    per = -(-groups // want)
    return -(-groups // per), per


def _library():
    from leopard_tpu_torch.ops._build import load_library

    lib = load_library("int4_matmul")
    fn = lib.leopard_int4_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p]  # x q4 s out partial M K N splits per stream
        fn.restype = ctypes.c_int
        lib.leopard_int4_error_string.argtypes = [i]
        lib.leopard_int4_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, q4, s):
    _check(x, q4, s)
    m, k = x.shape
    n = q4.shape[1]
    xb = x.to(torch.bfloat16).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    splits, per = _splits(m, k, n)
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.leopard_int4_matmul(
            xb.data_ptr(), q4.data_ptr(), s.data_ptr(), out.data_ptr(),
            partial.data_ptr() if partial is not None else None,
            m, k, n, splits, per, stream,
        )
    if rc != 0:
        msg = lib.leopard_int4_error_string(rc).decode()
        raise RuntimeError(f"int4_matmul kernel launch failed: {msg} ({rc})")
    int4_matmul.launches += 1
    return out
