"""Plain PyTorch building blocks of the reference, in float32.

Nothing here imports the program: the reference works from the benchmark's
inputs, the seeded weights (by state-dict name) and the configuration file.
Each block follows the published description of its model family; a
`Precision` object lets the lower-precision control run the same code with
every matrix product's operands rounded to fp8 (e4m3, one scale a tensor,
the gradient passed straight through the rounding).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

FP8_MAX = 448.0  # the largest e4m3 value


@contextlib.contextmanager
def exact_fp32():
    """float32 products in float32 inside: no TF32 on the card."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Precision:
    """float32 throughout, or (`fp8=True`) every product's operands rounded
    to e4m3 first."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return t
        scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        r = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return t + (r - t).detach()

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)


class Weights:
    """The seeded weights by name, each read in float32 when used; with
    `params` the float32 leaves that training updates take their place."""

    def __init__(self, tensors: dict, params: Optional[dict] = None):
        self.tensors = tensors
        self.params = params

    def __call__(self, name: str) -> torch.Tensor:
        if self.params is not None:
            return self.params[name]
        return self.tensors[name].float()


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, H, D] rotated by positions [S] (non-interleaved halves)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d))
    ang = positions.to(torch.float64)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    half = d // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def _attend_block(q, k, v, allowed, prec: Precision):
    """q [Q, Hq, D], k/v [K, Hkv, D], allowed [Q, K] bool or None."""
    hq, hkv, d = q.shape[1], k.shape[1], q.shape[2]
    g = hq // hkv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("qhd,khd->hqk", prec.q(q), prec.q(k)) / math.sqrt(d)
    if allowed is not None:
        s = s.masked_fill(~allowed[None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,khd->qhd", prec.q(p), prec.q(v))


def attend(q, k, v, *, causal: bool, window: Optional[int], prec: Precision,
           block: int = 1024) -> torch.Tensor:
    """Attention of one sequence with itself (q [S, Hq, D], k/v [S, Hkv, D]):
    all pairs, or causal at most `window` back; in blocks of `block`
    queries, each recomputed in the backward."""
    s = q.shape[0]
    outs = []
    for i in range(0, s, block):
        j = min(s, i + block)
        lo = 0
        if causal and window is not None:
            lo = max(0, i - window + 1)
        hi = j if causal else s
        allowed = None
        if causal:
            qi = torch.arange(i, j, device=q.device)[:, None]
            ki = torch.arange(lo, hi, device=q.device)[None, :]
            allowed = ki <= qi
            if window is not None:
                allowed = allowed & (qi - ki < window)
        args = (q[i:j], k[lo:hi], v[lo:hi], allowed, prec)
        if torch.is_grad_enabled() and q.requires_grad:
            outs.append(torch.utils.checkpoint.checkpoint(_attend_block, *args,
                                                          use_reentrant=False))
        else:
            outs.append(_attend_block(*args))
    return torch.cat(outs, dim=0)


def checkpointed(fn, *args):
    """fn(*args), its activations recomputed in the backward when training."""
    if torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)
