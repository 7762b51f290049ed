"""The plain reference of the training step: the forward of
reference/models.py, the weighted next-token cross-entropy, the gradients by
autograd, and optax's chain(clip_by_global_norm, adamw) written out, in
float32, on the benchmark's batches.

The loss is Σ w·(logsumexp − target logit) / Σ w over positions t that
predict token t + 1, with w the batch's loss weight at t + 1, zero where
that token is an image token or padding. AdamW: m ← β₁m + (1−β₁)g,
v ← β₂v + (1−β₂)g², p ← p − lr·(m/(1−β₁ᵗ)) / (√(v/(1−β₂ᵗ)) + ε); the gradients are first
scaled by clip/‖g‖ when their global norm ‖g‖ reaches `grad_clip`.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from portbench.reference.common import Precision, Weights
from portbench.reference.models import decoder_hidden, head_logits, idefics2_image_features


def _bounds(seg_row: torch.Tensor):
    """(start, end) of each sample of a row, and the end of its real
    tokens (segment ids count the samples from 1; 0 is padding)."""
    seg = seg_row.tolist()
    out, start = [], 0
    for i in range(1, len(seg) + 1):
        if i == len(seg) or seg[i] != seg[start]:
            if seg[start] != 0:
                out.append((start, i))
            start = i
    return out


def loss_of(spec: dict, w: Weights, batch: dict, grids: List[tuple], prec: Precision,
            head_dim: int, rows: Optional[List[int]] = None, chunk: int = 1024):
    """The weighted cross-entropy of the batch, over `rows` (all by
    default)."""
    tokens, seg, lw = batch["tokens"], batch["segment_ids"], batch["loss_weights"]
    image_id = spec["image_token_id"] if "image_token_id" in spec else spec["assumed"]["image_token_id"]
    feats = None
    if batch.get("images") is not None:
        feats = idefics2_image_features(spec, w, batch["images"].float(), grids, prec)
    rows = list(range(tokens.shape[0])) if rows is None else rows
    nll = torch.zeros((), device=tokens.device)
    total = torch.zeros((), device=tokens.device)
    feat_at = torch.cumsum((tokens == image_id).sum(1), 0) - (tokens == image_id).sum(1)
    for r in rows:
        bounds = _bounds(seg[r])
        end = bounds[-1][1]
        at = tokens[r, :end] == image_id
        f = None
        if feats is not None and bool(at.any()):
            f = feats[int(feat_at[r]): int(feat_at[r]) + int(at.sum())]
        hidden = decoder_hidden(spec, w, tokens[r, :end], at, f, bounds, prec, head_dim)
        targets = tokens[r, 1:end]
        weights = (lw[r, 1:end].float() * (targets != image_id) * (seg[r, 1:end] != 0))
        for i in range(0, end - 1, chunk):
            j = min(end - 1, i + chunk)

            def piece(h, t, wt):
                logits = head_logits(w, h, prec)
                lz = torch.logsumexp(logits, -1)
                return ((lz - logits.gather(-1, t.long()[:, None])[:, 0]) * wt).sum()

            nll = nll + torch.utils.checkpoint.checkpoint(
                piece, hidden[i:j], targets[i:j], weights[i:j], use_reentrant=False)
        total = total + weights.sum()
    return nll / total.clamp(min=1e-8)


def train(spec: dict, tensors: dict, batches: List[dict], grids: List[List[tuple]],
          opt: dict, head_dim: int, prec: Precision, half_batch: bool = False,
          bf16_compute: bool = False) -> dict:
    """Three (len(batches)) steps from the seeded weights: each step's loss,
    each leaf's clipped gradient norm and raw gradient norm at the first
    step, and each leaf's change after the last. `half_batch`: the fault
    of a loss over the first half of the rows only. `bf16_compute`: each
    step's forward and gradients on the float32 masters rounded to bfloat16
    (and read in float32), the update applied to the masters, as a
    training step with a bfloat16 compute copy does."""
    params = {k: t.float().clone().requires_grad_(True) for k, t in tensors.items()}
    w = Weights(tensors, params)
    mu = {k: torch.zeros_like(p) for k, p in params.items()}
    nu = {k: torch.zeros_like(p) for k, p in params.items()}
    b1, b2, eps, lr = opt["beta1"], opt["beta2"], opt["eps"], opt["lr"]
    clip = opt["grad_clip"]
    if opt.get("weight_decay", 0.0):
        raise ValueError("the reference's AdamW takes no weight decay")
    losses, grad1, raw1, gnorms = [], None, None, []
    for step, batch in enumerate(batches, start=1):
        rows = None
        if half_batch:
            rows = list(range(max(1, batch["tokens"].shape[0] // 2)))
        live = params
        if bf16_compute:
            live = {k: p.detach().to(torch.bfloat16).float().requires_grad_(True)
                    for k, p in params.items()}
            w.params = live
        loss = loss_of(spec, w, batch, grids[step - 1], prec, head_dim, rows=rows)
        for p in live.values():
            p.grad = None
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                     for k, p in live.items()}
            gnorm = torch.stack([g.norm() for g in grads.values()]).norm()
            gnorms.append(round(float(gnorm), 5))
            scale = clip / gnorm if clip > 0 and float(gnorm) >= clip else None
            if step == 1:
                raw1 = {k: float(g.norm()) for k, g in grads.items()}
            for k, p in params.items():
                g = grads[k] if scale is None else grads[k] * scale
                mu[k].mul_(b1).add_(g, alpha=1 - b1)
                nu[k].mul_(b2).add_(g * g, alpha=1 - b2)
                u = (mu[k] / (1 - b1 ** step)) / ((nu[k] / (1 - b2 ** step)).sqrt() + eps)
                p.add_(u, alpha=-lr)
            if step == 1:
                grad1 = {k: float(m.norm()) / (1 - b1) for k, m in mu.items()}
    with torch.no_grad():
        change = {k: float((p - tensors[k].float()).norm()) for k, p in params.items()}
    return {"losses": losses, "grad1": grad1, "raw_grad1": raw1, "change": change,
            "gnorm": gnorms}
