"""int4 weight matmul for decode: the Hopper kernel (csrc/int4_matmul.cu) and
its plain version.

Port of the TPU kernel leopard_tpu/ops/pallas/int4_matmul.py (int4_matmul /
_kernel): x [M, K] (cast to bf16; the port also takes [..., K], M rows in
all) times a split-half packed int4 weight q4 uint8 [K/2, N] with f32
scales s [K/128, N] per (128-row group, column), giving f32 [M, N] (or
bf16, the f32 result rounded once, when asked). Byte
(i, n) of q4 holds logical row i in its low nibble and row i + K/2 in its
high nibble, offset-binary (q + 8, q ∈ [-7, 7]).

  - on a CUDA tensor `int4_matmul` launches the kernel or raises; there is no
    fallback;
  - on a CPU tensor it computes `int4_matmul_ref`: x to bf16, the weight as
    (q − 8) · s in fp32 rounded once to bf16, fp32 accumulation.

A call costs one launch and little host time: the weight is checked once,
and its plan (the tensor map the kernel loads it through and the K split of
every M) is cached under the weight's pointer, shape, stride and dtype, so
another weight never finds a stale plan. A call checks x's shape and
device, allocates the output, and makes one ctypes call on the current
stream. A K split is summed inside the launch, through a workspace kept
per (device, stream): its counters stay zero between calls, and calls on
one stream never overlap.

`int4_matmul.launches` counts kernel launches, so a run can show that its
path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

KERNEL_GROUP = 128
MAX_M = 64
BLOCK_N = 128     # output columns per block (csrc/int4_matmul.cu)
MAX_SPLITS = 8    # K ranges a column tile is split into (csrc/int4_matmul.cu)
SPLIT_COUNTERS = 256  # int32 counters at a workspace's start (csrc/int4_matmul.cu)
SMS = 132         # streaming multiprocessors of an H100 SXM
MAX_PLANS = 1024  # cached weight plans; the oldest goes first
OUT_DTYPES = (torch.float32, torch.bfloat16)


def int4_matmul_ref(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: f32 [M, N]."""
    from leopard_tpu_torch.ops.quant import _unpack_int4

    w = _unpack_int4(q4, s).to(torch.bfloat16).float()
    return x.to(torch.bfloat16).float() @ w


def int4_matmul(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x [..., K] float × packed int4 [K/2, N] → [..., N] in `out_dtype`
    (f32, or bf16 rounded once from the f32 result)."""
    if x.is_cuda:
        return _launch(x, q4, s, out_dtype)
    if x.device.type != "cpu":
        raise ValueError(f"int4_matmul runs on cuda or cpu, not {x.device}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype {out_dtype}: float32 or bfloat16")
    return int4_matmul_ref(x, q4, s).to(out_dtype)


int4_matmul.launches = 0


def validate_weight(q4: torch.Tensor, s: torch.Tensor) -> tuple[int, int]:
    """(K, N) of a weight the kernel takes; raises ValueError on anything
    else. Checked once per weight, when its plan is made."""
    if q4.dim() != 2 or s.dim() != 2:
        raise ValueError(f"ranks {q4.dim()}, {s.dim()}: q4 and s are 2-D")
    if q4.dtype != torch.uint8 or s.dtype != torch.float32:
        raise ValueError(f"q4 {q4.dtype}, s {s.dtype}: the kernel takes uint8 and float32")
    kh, n = q4.shape
    k = 2 * kh
    if s.shape[1] != n:
        raise ValueError(f"q4 {tuple(q4.shape)} and s {tuple(s.shape)} differ in N")
    if s.shape[0] * KERNEL_GROUP != k:
        raise ValueError(f"{s.shape[0]} scale groups for K={k}: the kernel takes group "
                         f"{KERNEL_GROUP}")
    if k == 0 or n == 0 or k % (2 * KERNEL_GROUP) or n % BLOCK_N:
        raise ValueError(f"K={k}, N={n}: the kernel needs K % 256 == 0 and N % {BLOCK_N} == 0")
    if s.device != q4.device:
        raise ValueError(f"q4 on {q4.device}, s on {s.device}")
    for name, t in (("q4", q4), ("s", s)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        # TMA and bulk copies read from 16-byte aligned addresses
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return k, n


def plan_splits(m: int, k: int, n: int) -> tuple[int, int]:
    """(K splits, group pairs per split) of a call. Blocks of 128 columns ×
    a K range; the card holds two a SM where they fit (M ≤ 16), else one.
    Where N / 128 alone leaves SMs idle (wk/wv: N = 1,024 makes 8 tiles),
    K is split into up to 8 ranges of whole group pairs, as many as one
    wave of blocks holds (so a split call has at most 132 tiles, within
    the workspace's counters). Split i covers group pairs
    [i · per, min((i + 1) · per, K / 256)); every range is non-empty."""
    tiles = n // BLOCK_N
    pairs = k // (2 * KERNEL_GROUP)
    slots = SMS * (2 if m <= 16 else 1)
    want = max(1, min(pairs, MAX_SPLITS, slots // tiles))
    per = -(-pairs // want)
    return -(-pairs // per), per


class _PlanStruct(ctypes.Structure):
    """csrc/int4_matmul.cu's HostPlan."""

    _fields_ = [("wmap", ctypes.c_ubyte * 128), ("s", ctypes.c_void_p), ("k", ctypes.c_int),
                ("n", ctypes.c_int), ("device", ctypes.c_int), ("pad", ctypes.c_int)]


class _Plan:
    """One weight's launch plan: the C side's HostPlan (its tensor map) and
    the (splits, per) of every M."""

    __slots__ = ("struct", "address", "k", "n", "device", "torch_device", "splits")

    def __init__(self, q4, s, lib):
        self.k, self.n = validate_weight(q4, s)
        if not q4.is_cuda:
            raise ValueError(f"the weight is on {q4.device}; the kernel needs it on the card")
        self.device = q4.get_device()
        self.torch_device = q4.device
        self.struct = _PlanStruct()
        self.address = ctypes.addressof(self.struct)
        rc = lib.leopard_int4_plan(q4.data_ptr(), s.data_ptr(), self.k, self.n, self.device,
                                   self.address)
        if rc != 0:
            raise RuntimeError(f"int4_matmul plan failed: "
                               f"{lib.leopard_int4_error_string(rc).decode()} ({rc})")
        self.splits = [None] + [plan_splits(m, self.k, self.n) for m in range(1, MAX_M + 1)]


_plans: dict[tuple, _Plan] = {}
_workspaces: dict[tuple[int, int], torch.Tensor] = {}
_lib = None


def _library():
    """The kernel's library, built and bound at first use."""
    global _lib
    if _lib is None:
        from leopard_tpu_torch.ops._build import load_library

        lib = load_library("int4_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.leopard_int4_plan.argtypes = [p, p, i, i, i, p]  # q4 s K N device plan
        lib.leopard_int4_plan.restype = i
        # plan x out workspace M splits per out_bf16 stream
        lib.leopard_int4_matmul.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.leopard_int4_matmul.restype = i
        lib.leopard_int4_error_string.argtypes = [i]
        lib.leopard_int4_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _plan(q4, s) -> _Plan:
    key = (q4.data_ptr(), q4.shape, q4.stride(), q4.dtype,
           s.data_ptr(), s.shape, s.stride(), s.dtype)
    plan = _plans.get(key)
    if plan is None:
        plan = _Plan(q4, s, _library())
        if len(_plans) >= MAX_PLANS:
            del _plans[next(iter(_plans))]
        _plans[key] = plan
    return plan


def _workspace(plan: _Plan, stream: int, floats: int) -> int:
    """The address of the (device, stream)'s split workspace, grown to hold
    `floats` fp32 partials after its zeroed counters."""
    ws = _workspaces.get((plan.device, stream))
    if ws is None or ws.numel() < SPLIT_COUNTERS + floats:
        ws = torch.zeros(SPLIT_COUNTERS + floats, dtype=torch.float32, device=plan.torch_device)
        _workspaces[(plan.device, stream)] = ws
    return ws.data_ptr()


def _launch(x, q4, s, out_dtype):
    plan = _plan(q4, s)
    if x.dim() < 1 or x.shape[-1] != plan.k:
        raise ValueError(f"x {tuple(x.shape)} does not fit q4 {tuple(q4.shape)}")
    m = x.numel() // plan.k
    if not 1 <= m <= MAX_M:
        raise ValueError(f"M={m}: the kernel takes 1 <= M <= {MAX_M}")
    if x.get_device() != plan.device:
        raise ValueError(f"x on {x.device}, the weight on {plan.torch_device}")
    if x.dtype != torch.bfloat16:
        if x.dtype != torch.float32:
            raise ValueError(f"x dtype {x.dtype}: the kernel takes bfloat16 or float32")
        x = x.to(torch.bfloat16)
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype {out_dtype}: float32 or bfloat16")
    splits, per = plan.splits[m]
    out = torch.empty(x.shape[:-1] + (plan.n,), dtype=out_dtype, device=plan.torch_device)
    stream = torch._C._cuda_getCurrentRawStream(plan.device)
    workspace = _workspace(plan, stream, splits * m * plan.n) if splits > 1 else None
    rc = _lib.leopard_int4_matmul(plan.address, x.data_ptr(), out.data_ptr(), workspace, m,
                                  splits, per, out_dtype == torch.bfloat16, stream)
    if rc != 0:
        msg = _lib.leopard_int4_error_string(rc).decode()
        raise RuntimeError(f"int4_matmul kernel launch failed: {msg} ({rc})")
    int4_matmul.launches += 1
    return out
