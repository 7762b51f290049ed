"""Operations and bytes of the work a cell's inputs need, counted from the
shapes the benchmark made (real tiles, real patches, real tokens; never the
buckets' padding).

  - A matrix product of an [n, k] input by a [k, m] weight is 2·n·k·m
    operations.
  - Attention counts attended pairs only: a tile's or a NaViT image's real
    patches attend each other; a decoder token attends the tokens of its own
    sample at most `window` back, itself included. Per pair and head the
    forward is 4·d operations (QKᵀ and PV); the backward 10·d (the
    recomputed QKᵀ, dP, dV, dQ, dK); the model's operations, for MFU, take
    8·d for the backward (no recomputation).
  - An attention call's bytes are each of q, k, v and o read or written
    once in bf16; its backward's, q, k, v, o and dO read and dQ, dK, dV
    written once.
  - The MFU of a training step is 3 × its forward operations (the
    backward's two products for every forward one), the recomputation that
    a remat policy adds not counted.
"""

from __future__ import annotations

from typing import Iterable, Optional

from portbench.modelcfg import matmul_params
from portbench.yardstick.peaks import BF16_FLOPS, HBM_BYTES

BF16 = 2


def causal_pairs(n: int, window: Optional[int]) -> int:
    """Σ over n positions of the positions each attends: itself and those
    before it, at most `window` in all."""
    if window is None or n <= window:
        return n * (n + 1) // 2
    return window * (window + 1) // 2 + (n - window) * window


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES)


class Work:
    """Running totals: model operations (`flops`) and, for the attention
    kernels, the bound summed call by call (`attn_bound_s`)."""

    def __init__(self):
        self.flops = 0.0
        self.attn_bound_s = 0.0

    def attn_call(self, flops: float, nbytes: float, calls: int = 1) -> None:
        self.attn_bound_s += calls * bound_s(flops, nbytes)


def _tower(cfg, work: Work, patches: Iterable[int], train: bool) -> float:
    """The vision tower over images of the given real patch counts, each a
    separate attention block; its forward operations."""
    v = cfg.vision
    mp = matmul_params(cfg)
    patches = list(patches)
    n = sum(patches)
    pairs = sum(x * x for x in patches)
    fwd = 2.0 * n * (mp["patch"] + v.num_layers * mp["tower_layer"])
    attn_fwd = 4.0 * v.hidden_size * pairs
    work.attn_call(attn_fwd, 4 * n * v.hidden_size * BF16, calls=v.num_layers)
    if train:
        work.attn_call(2.5 * attn_fwd, 8 * n * v.hidden_size * BF16, calls=v.num_layers)
    return fwd + v.num_layers * attn_fwd


def _decoder(cfg, work: Work, segments: Iterable[int], head_rows: int, train: bool) -> float:
    """The decoder over samples of the given lengths, the head over
    `head_rows` positions; its forward operations."""
    t = cfg.text
    mp = matmul_params(cfg)
    segments = list(segments)
    n = sum(segments)
    pairs = sum(causal_pairs(s, t.sliding_window) for s in segments)
    qd, kvd = t.num_heads * t.head_dim, t.num_kv_heads * t.head_dim
    attn_fwd = 4.0 * t.head_dim * t.num_heads * pairs
    work.attn_call(attn_fwd, (2 * qd + 2 * kvd) * n * BF16, calls=t.num_layers)
    if train:
        work.attn_call(2.5 * attn_fwd, (4 * qd + 4 * kvd) * n * BF16, calls=t.num_layers)
    return (2.0 * n * t.num_layers * mp["text_layer"] + 2.0 * head_rows * mp["head"]
            + t.num_layers * attn_fwd)


def _perceiver(cfg, patches: Iterable[int]) -> float:
    p = cfg.perceiver
    mp = matmul_params(cfg)
    lat = p.num_latents
    fwd = 0.0
    for n in patches:
        fwd += 2.0 * n * mp["modality"]
        per_layer = (2.0 * lat * (mp["perceiver_q"] + mp["perceiver_o"] + mp["perceiver_mlp"])
                     + 2.0 * (n + lat) * mp["perceiver_kv"]
                     + 4.0 * p.head_dim * p.num_heads * lat * (n + lat))
        fwd += p.num_layers * per_layer
    return fwd


def llava_prefill(cfg, work: Work, crops: int, tokens: int) -> None:
    """One LLaVA request's prefill: the tower over its crops, the projector,
    the decoder over its prompt, the head at its last position."""
    per_tile = (cfg.vision.image_size // cfg.vision.patch_size) ** 2
    fwd = _tower(cfg, work, [per_tile] * crops, train=False)
    fwd += 2.0 * crops * cfg.anyres.tokens_per_tile * matmul_params(cfg)["projector"]
    fwd += _decoder(cfg, work, [tokens], head_rows=1, train=False)
    work.flops += fwd


def train_step(cfg, work: Work, stats: dict) -> None:
    """One training step on a batch of `stats` (traffic/generate.py): the
    tower and perceiver over each image's real patches, the decoder and the
    head over every real token; model operations are 3 × the forward."""
    fwd = 0.0
    patches = stats["image_patches"]
    if patches:
        fwd += _tower(cfg, work, patches, train=True)
        if cfg.perceiver is not None:
            fwd += _perceiver(cfg, patches)
    segments = [s for row in stats["segments"] for s in row]
    fwd += _decoder(cfg, work, segments, head_rows=sum(segments), train=True)
    work.flops += 3.0 * fwd
