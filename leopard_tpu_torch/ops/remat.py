"""Recompute (remat) policies for the layer loops (port of
leopard_tpu/ops/remat.py).

  - "none" (or False/None): save every intermediate;
  - "full" (or True): per-layer full recompute, ≙ the reference's
    `--recompute-granularity full --recompute-num-layers 1`: only layer
    inputs are saved, and each layer's forward re-runs in the backward
    (`torch.utils.checkpoint`, non-reentrant), flash kernels included.

The JAX package's "selective" and "attn" policies save named residuals
(matmul outputs, the flash kernel's output and lse); they are not in the
port yet and raise.
"""

from __future__ import annotations

from typing import Callable, Union

import torch.utils.checkpoint


def remat_wrap(fn: Callable, mode: Union[bool, str, None]) -> Callable:
    """`fn` under the recompute policy `mode`."""
    if not mode or mode == "none":
        return fn
    if mode is True or mode == "full":
        def wrapped(*args, **kwargs):
            return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False, **kwargs)

        return wrapped
    if mode in ("selective", "attn"):
        raise NotImplementedError(f"remat={mode!r} is not in the port yet")
    raise ValueError(f"unknown remat mode: {mode!r}")
