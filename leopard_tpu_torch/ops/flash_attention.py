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
`flash_attention` calls the operator `torch.ops.leopard.flash_attention_fwd`
(a `torch.library.custom_op`), whose forward also writes the per-row
logsumexp, [B, Hq, Sq] fp32, and whose backward, registered with it, is K2
(on the CPU, the plain versions of both). Being an operator, the forward is
seen by the dispatcher, so a selective-checkpoint policy can save its
output and lse and skip K1 in the recompute (ops/remat.py, the counterpart
of the JAX package's tags inside `_flash_fwd`). Otherwise the forward writes
no lse, as serving needs none.

Masking is the full segment mask (q_seg == kv_seg, both non-zero). On a
right-padded batch it gives the valid rows the same result as the TPU
kernel's `kv_only_mask`, and it is the mask packed training rows need.
Fully-masked rows (padding queries) are don't-care in the forward: the
kernel returns 0 there and the plain version a uniform average, so callers
compare and use valid rows only. Their gradients are exactly 0 in both
backward versions, which exponentiate only where the mask lets a pair
through.

`flash_attention.launches` counts K1 launches and
`flash_attention_bwd.launches` K2 launches (one a backward: its delta, dq
and dk/dv kernels), so a run can show that its path went through the
kernels. The kernels read their inputs by TMA, which needs a 16-byte aligned
base and b, s, h strides that are multiples of 8 elements; an input that is
not so is copied first, and `flash_attention.copies` counts those copies.

Both kernels skip tiles by one rule, `tile_ranges`: the kv rows each tile
of TILE q rows can attend (the forward and dq kernels), and the q rows each
tile of TILE kv rows is attended by (the dk/dv kernel), from the segment ids
cut to the causal band and the window. A caller that passes the same ids to
many calls (the decoder, to each of its layers) computes them once and
passes them as `ranges`; otherwise each call computes its own, and an
autograd call keeps its forward's for the backward.

A call may take a q − kv offset (`q_offset`, the kernels' `offset`): q row i
then sits at position i + q_offset counted from kv row 0, and the causal
band and the window are read in those positions. It is 0 but for a block of
a ring (parallel/context_parallel.py), whose q chunk lies `q_offset`
positions after its kv chunk: the windowed ring runs through the kernels by
it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from leopard_tpu_torch.ops.attention import NEG_INF, attention, make_attention_mask

SUPPORTED_HEAD_DIMS = (16, 64, 72, 128)
# rows per block of both kernels and per segment-id block; the kernels check
# that these agree with theirs (csrc/flash_common.cuh kTile, kUid)
TILE = 128
UID_BLOCK = 64


class TileRanges(NamedTuple):
    """What the kernels skip by, int32 on the segments' device:
    kv_of_q [B or 1, ceil(Sq / block), 2] the kv rows [lo, hi) that each
    tile of `block` q rows attends; q_of_kv [B or 1, ceil(Skv / block), 2]
    the q rows that attend each tile of `block` kv rows ((0, 0) for none);
    q_uid / kv_uid [B, ceil(S / UID_BLOCK)] each UID_BLOCK-row block's
    segment id where all its rows carry one non-zero id, else -1 (None
    without segments)."""
    kv_of_q: torch.Tensor
    q_of_kv: torch.Tensor
    q_uid: Optional[torch.Tensor]
    kv_uid: Optional[torch.Tensor]


def tile_ranges(q_seg, kv_seg, *, sq, skv, causal, window=None, block=TILE,
                device="cpu", offset=0) -> TileRanges:
    """The tile-skipping rule of K1 and K2. A q tile's kv range spans, over
    its non-padding rows, the first to the last kv position of each row's
    segment id, cut to the causal band (kv < the tile's last row + 1) and
    the window (kv > the tile's first row - window); a kv tile's q range
    the same way round. Every pair the mask lets through lies in both
    ranges of its tiles, for any ids (an id that recurs, as in 1, 2, 1, only
    widens the range). Without segments the ranges are the band alone,
    computed once per shape, offset and band. `offset` is the call's q − kv
    offset: the band and the window are cut in positions q + offset."""
    if q_seg is None:
        return _band_ranges(sq, skv, causal, window or 0, offset, block, torch.device(device))
    q_first, q_last = _spans(q_seg, kv_seg)
    k_first, k_last = _spans(kv_seg, q_seg)
    return TileRanges(_per_tile(q_first, q_last, skv, block, causal, window, True, offset),
                      _per_tile(k_first, k_last, sq, block, causal, window, False, offset),
                      uniform_ids(q_seg), uniform_ids(kv_seg))


@functools.lru_cache(maxsize=64)
def _band_ranges(sq, skv, causal, window, offset, block, device):
    def every(n, n_other):  # each row spans the whole other side
        return (torch.zeros((1, n), dtype=torch.int32, device=device),
                torch.full((1, n), n_other - 1, dtype=torch.int32, device=device))

    # cached for every later call: made as normal tensors even when the first
    # call runs under inference mode (a generate), since a train step's K1
    # saves them for K2 and autograd refuses to save inference tensors
    with torch.inference_mode(False):
        return TileRanges(_per_tile(*every(sq, skv), skv, block, causal, window, True, offset),
                          _per_tile(*every(skv, sq), sq, block, causal, window, False, offset),
                          None, None)


def _spans(a_seg, b_seg):
    """For each position of a_seg: the first and last position in b_seg of
    its id, or (len(b), -1) where the id is 0 or absent from b_seg. Ids in
    1..len(b) get a bin each; any other id shares one bin whose span covers
    all such ids together, which only widens their ranges. Scatters and
    gathers only, so nothing waits on the device."""
    bsz, n = b_seg.shape
    other = n + 1

    def bins(seg):
        return torch.where((seg >= 1) & (seg <= n), seg, other).masked_fill(seg == 0, 0).long()

    pos = torch.arange(n, dtype=torch.int32, device=b_seg.device).expand(bsz, n)
    first = torch.full((bsz, n + 2), n, dtype=torch.int32, device=b_seg.device)
    last = torch.full((bsz, n + 2), -1, dtype=torch.int32, device=b_seg.device)
    b_bins = bins(b_seg)
    first.scatter_reduce_(1, b_bins, pos, "amin")
    last.scatter_reduce_(1, b_bins, pos, "amax")
    first[:, 0], last[:, 0] = n, -1  # padding attends nothing
    a_bins = bins(a_seg)
    return first.gather(1, a_bins), last.gather(1, a_bins)


def _per_tile(first, last, n_other, block, causal, window, q_tiles, offset=0):
    """[B, tiles, 2] int32 ranges of rows of the other side per tile of
    `block` rows: the union of the rows' spans, cut to the band, q rows at
    positions shifted by `offset`."""
    b, n = first.shape
    tiles = -(-n // block)
    pad = tiles * block - n
    lo = F.pad(first, (0, pad), value=n_other).view(b, tiles, block).amin(-1)
    hi = F.pad(last, (0, pad), value=-1).view(b, tiles, block).amax(-1) + 1
    start = torch.arange(tiles, device=first.device) * block
    end = (start + block).clamp(max=n)  # one past the tile's last row
    if q_tiles:  # the other side is kv: kv <= q + offset, q + offset - kv < window
        if causal:
            hi = torch.minimum(hi, end + offset)
        if window:
            lo = torch.maximum(lo, start + offset - window + 1)
    else:  # the other side is q: q + offset >= kv, q + offset < kv + window
        if causal:
            lo = torch.maximum(lo, start - offset)
        if window:
            hi = torch.minimum(hi, end - 1 + window - offset)
    lo, hi = lo.clamp(min=0), hi.clamp(max=n_other)
    empty = hi <= lo
    return torch.stack([lo.masked_fill(empty, 0), hi.masked_fill(empty, 0)], -1).to(
        torch.int32).contiguous()


def uniform_ids(seg, block=UID_BLOCK):
    """[B, ceil(S / block)] int32: each block's segment id where all its
    rows carry one positive id, else -1 (mixed, padding or the ragged end)."""
    b, n = seg.shape
    tiles = -(-n // block)
    v = F.pad(seg, (0, tiles * block - n), value=0).view(b, tiles, block)
    lo, hi = v.amin(-1), v.amax(-1)
    return torch.where((lo == hi) & (lo > 0), lo, -1).to(torch.int32).contiguous()


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """The kernel's plain version: dense attention with the same masks."""
    q_segment_ids, kv_segment_ids = _fill_segments(q, k, q_segment_ids, kv_segment_ids)
    mask = make_attention_mask(
        q.shape[1], k.shape[1], causal=causal, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, sliding_window=sliding_window, device=q.device,
        q_offset=q_offset)
    return attention(q, k, v, mask=mask)


def _scores_and_mask(q, k, q_seg, kv_seg, causal, sliding_window, q_offset=0):
    """Dense scaled scores [B, Hkv, G, Sq, Skv] fp32 and the mask
    [B|1, 1, 1, Sq, Skv] (None: every pair attends)."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    qg = q.reshape(b, sq, hkv, hq // hkv, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * d**-0.5
    mask = make_attention_mask(
        sq, skv, causal=causal, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
        sliding_window=sliding_window, device=q.device, q_offset=q_offset,
    )
    return s, None if mask is None else mask[:, :, None]


def flash_attention_lse_ref(q, k, v, *, causal=True, q_segment_ids=None,
                            kv_segment_ids=None, sliding_window=None,
                            q_offset=0) -> torch.Tensor:
    """The plain version of K1's lse output: logsumexp over the masked,
    scaled scores, [B, Hq, Sq] fp32 (about -1e30 on a fully-masked row)."""
    q_seg, kv_seg = _fill_segments(q, k, q_segment_ids, kv_segment_ids)
    s, mask = _scores_and_mask(q, k, q_seg, kv_seg, causal, sliding_window, q_offset)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    b, sq, hq, _ = q.shape
    return torch.logsumexp(s, dim=-1).reshape(b, hq, sq)


def flash_attention_bwd_ref(q, k, v, q_segment_ids, kv_segment_ids, out, lse, dout, *,
                            causal=True, sliding_window=None, q_offset=0):
    """K2's plain version: the same formulas, dense, in fp32.

    P = where(mask, exp(scale·QKᵀ − lse), 0); delta = rowsum(dO·O);
    dS = P·(dO·Vᵀ − delta)·scale; dQ = dS·K, dK = dSᵀ·Q, dV = Pᵀ·dO, the
    last two summed over each GQA group. Returns (dq, dk, dv) in the dtypes
    of q, k and v."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    q_seg, kv_seg = _fill_segments(q, k, q_segment_ids, kv_segment_ids)
    s, mask = _scores_and_mask(q, k, q_seg, kv_seg, causal, sliding_window, q_offset)
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
    """rowsum(dO·O) in fp32 as [B, Hq, Sq] for the plain version, as the JAX
    package computes it outside its kernels (flash_attention.py:464-467); on
    the card K2's first kernel computes it."""
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
    ranges: Optional[TileRanges] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Returns [B, Sq, Hq, D] in q.dtype; scores are scaled by D^-0.5.
    `ranges`: `tile_ranges` of these segment ids, shapes, causal flag,
    window and offset, from a caller that reuses them across calls;
    computed here when None. The plain version needs none. `q_offset`: the
    q − kv offset (module docstring)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if sliding_window is not None and sliding_window <= 0:
        raise ValueError(f"sliding_window must be positive, got {sliding_window}")
    kw = dict(causal=causal, q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
              sliding_window=sliding_window, q_offset=q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        rng = (None,) * len(TileRanges._fields)
        if q.device.type == "cuda":  # the ranges K1 runs by, saved for K2
            rng = _ranges(q, k, ranges, causal, sliding_window,
                          *_segments(q, k, q_segment_ids, kv_segment_ids), q_offset)
        return torch.ops.leopard.flash_attention_fwd(
            q, k, v, q_segment_ids, kv_segment_ids, causal, sliding_window or 0, *rng,
            q_offset)[0]
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, **kw)
    return _launch(q, k, v, ranges=ranges, **kw)[0]


def flash_attention_bwd(q, k, v, q_segment_ids, kv_segment_ids, out, lse, dout, *,
                        causal=True, sliding_window=None, ranges=None, q_offset=0):
    """Gradients (dq, dk, dv) of `flash_attention` from its output and lse:
    K2 on a CUDA tensor, the plain version on a CPU tensor. `ranges` and
    `q_offset` as in `flash_attention`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, q_segment_ids, kv_segment_ids, out, lse,
                                       dout, causal=causal, sliding_window=sliding_window,
                                       q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, not {q.device}")
    return _launch_bwd(q, k, v, q_segment_ids, kv_segment_ids, out, lse, dout,
                       causal=causal, sliding_window=sliding_window, ranges=ranges,
                       q_offset=q_offset)


flash_attention.launches = 0
flash_attention.copies = 0
flash_attention_bwd.launches = 0


@torch.library.custom_op("leopard::flash_attention_fwd", mutates_args=())
def _flash_fwd_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_seg: Optional[torch.Tensor],
    kv_seg: Optional[torch.Tensor], causal: bool, window: int,
    kv_of_q: Optional[torch.Tensor], q_of_kv: Optional[torch.Tensor],
    q_uid: Optional[torch.Tensor], kv_uid: Optional[torch.Tensor], offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The `_flash` custom_vjp's forward rule of the JAX package: (out, lse).
    K1 on a CUDA tensor, with the tile ranges the caller checked; the plain
    versions on a CPU tensor. `window` 0 means none; `offset` is the q − kv
    offset."""
    kw = dict(causal=causal, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
              sliding_window=window or None, q_offset=offset)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, **kw), flash_attention_lse_ref(q, k, v, **kw)
    return _launch(q, k, v, with_lse=True,
                   ranges=TileRanges(kv_of_q, q_of_kv, q_uid, kv_uid), **kw)


def _flash_setup_context(ctx, inputs, output):
    q, k, v, q_seg, kv_seg, causal, window, *ranges = inputs
    ranges, offset = ranges[:4], (ranges[4] if len(ranges) > 4 else 0)
    ctx.causal, ctx.window, ctx.offset = causal, window or None, offset
    # saved, the segment ids are checked for in-place changes before the
    # backward, which reads ranges made from them
    ctx.save_for_backward(q, k, v, q_seg, kv_seg, *output, *ranges)


def _flash_backward(ctx, dout, _dlse):
    q, k, v, q_seg, kv_seg, out, lse, *ranges = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(
        q, k, v, q_seg, kv_seg, out, lse, dout, causal=ctx.causal,
        sliding_window=ctx.window, q_offset=ctx.offset,
        ranges=None if ranges[0] is None else TileRanges(*ranges))
    return dq, dk, dv, *(None,) * 9


torch.library.register_autograd("leopard::flash_attention_fwd", _flash_backward,
                                setup_context=_flash_setup_context)


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
    if k.shape[1] == 0:
        raise ValueError("the kernel needs at least one kv row")


def _tma_ready(t):
    """t itself where TMA can address it (a 16-byte aligned base, b, s, h
    strides that are multiples of 8 elements), else a contiguous copy,
    counted in flash_attention.copies."""
    if t.data_ptr() % 16 == 0 and all(
            st % 8 == 0 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1):
        return t
    flash_attention.copies += 1
    return t.clone(memory_format=torch.contiguous_format)


def _strides(t):
    """The b, s, h strides, with those of size-1 dims (never stepped) set to
    8 elements, which TMA takes."""
    return [st if n > 1 else 8 for st, n in zip(t.stride()[:3], t.shape[:3])]


_ARGTYPES = {
    # q k v o lse q_seg kv_seg ranges q_uid kv_uid, B Sq Skv Hq Hkv D block
    # uid_block, strides, scale causal window offset stream
    "flash_attention": ("leopard_flash_attention_fwd", 10),
    # q k v out dout lse delta dq dk dv q_seg kv_seg kv_ranges q_ranges q_uid
    # kv_uid, then as above
    "flash_attention_bwd": ("leopard_flash_attention_bwd", 16),
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
            *[p] * n_ptrs, *[i] * 8,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i, i, i, p,
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


def _ptr(t):
    return None if t is None else t.data_ptr()


def _batch_stride(t):
    """The batch stride of an optional [B, ...] array; 0 where one row
    serves every batch row (the band ranges without segments)."""
    return 0 if t is None or t.shape[0] == 1 else t.stride(0)


def _ranges(q, k, ranges, causal, window, q_seg, kv_seg, offset=0) -> TileRanges:
    """The tile ranges of one call on the int32 segments of `_segments`:
    `tile_ranges` of them when `ranges` is None, else `ranges` once they fit
    the call, since the kernels index them unchecked."""
    b, sq = q.shape[:2]
    skv = k.shape[1]
    if ranges is None:
        return tile_ranges(q_seg, kv_seg, sq=sq, skv=skv, causal=causal, window=window,
                           device=q.device, offset=offset)
    rows = ranges.kv_of_q.shape[0]
    fits = [rows in (1, b), ranges.kv_of_q.shape == (rows, -(-sq // TILE), 2),
            ranges.q_of_kv.shape == (rows, -(-skv // TILE), 2)]
    if q_seg is None:
        fits += [ranges.q_uid is None, ranges.kv_uid is None]
    else:
        fits += [uid is not None and uid.shape == (b, -(-n // UID_BLOCK))
                 for uid, n in ((ranges.q_uid, sq), (ranges.kv_uid, skv))]
    fits += [t.dtype == torch.int32 and t.device == q.device and t.is_contiguous()
             for t in ranges if t is not None]
    if not all(fits):
        raise ValueError("ranges do not fit this call: pass tile_ranges of its segment ids, "
                         f"shapes, causal flag and window (q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, segments {q_seg is not None})")
    return ranges


def _launch(q, k, v, *, causal, q_segment_ids, kv_segment_ids, sliding_window,
            with_lse=False, ranges=None, q_offset=0):
    """K1: (out, lse [B, Hq, Sq] fp32 or None)."""
    _check(q, k, v)
    q, k, v = (_tma_ready(t) for t in (q, k, v))
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    q_seg, kv_seg = _segments(q, k, q_segment_ids, kv_segment_ids)
    rng = _ranges(q, k, ranges, causal, sliding_window, q_seg, kv_seg, q_offset)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if with_lse else None
    strides = (ctypes.c_longlong * 17)(
        *_strides(q), *_strides(k), *_strides(v), *out.stride()[:3],
        *(_batch_stride(t) for t in (q_seg, kv_seg, rng.kv_of_q, rng.q_uid, rng.kv_uid)))
    lib, fn = _library("flash_attention")
    _call("flash_attention", fn, lib, q.device,
          q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(lse),
          _ptr(q_seg), _ptr(kv_seg), _ptr(rng.kv_of_q), _ptr(rng.q_uid), _ptr(rng.kv_uid),
          b, sq, skv, hq, hkv, d, TILE, UID_BLOCK, strides, float(d**-0.5), int(causal),
          int(sliding_window or 0), int(q_offset))
    flash_attention.launches += 1
    return out, lse


def _launch_bwd(q, k, v, q_segment_ids, kv_segment_ids, out, lse, dout, *, causal,
                sliding_window, ranges=None, q_offset=0):
    """K2: (dq, dk, dv) in bf16."""
    _check(q, k, v, ("out", out), ("dout", dout))
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} / dout {tuple(dout.shape)} do not fit q")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous fp32 [B, Hq, Sq], got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    q, k, v, out, dout = (_tma_ready(t) for t in (q, k, v, out, dout))
    q_seg, kv_seg = _segments(q, k, q_segment_ids, kv_segment_ids)
    rng = _ranges(q, k, ranges, causal, sliding_window, q_seg, kv_seg, q_offset)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    strides = (ctypes.c_longlong * 30)(
        *_strides(q), *_strides(k), *_strides(v), *_strides(out), *_strides(dout),
        *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
        *(_batch_stride(t) for t in (q_seg, kv_seg, rng.kv_of_q, rng.q_of_kv, rng.q_uid,
                                    rng.kv_uid)))
    lib, fn = _library("flash_attention_bwd")
    _call("flash_attention_bwd", fn, lib, q.device,
          q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
          lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
          _ptr(q_seg), _ptr(kv_seg), _ptr(rng.kv_of_q), _ptr(rng.q_of_kv), _ptr(rng.q_uid),
          _ptr(rng.kv_uid), b, sq, skv, hq, hkv, d, TILE, UID_BLOCK, strides,
          float(d**-0.5), int(causal), int(sliding_window or 0), int(q_offset))
    flash_attention_bwd.launches += 1
    return dq, dk, dv
