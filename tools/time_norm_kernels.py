#!/usr/bin/env python3
"""Time the LayerNorm kernel K3b of one or more checkouts of the port, in
turns, in one process on one CUDA card.

    git archive <parent> | tar -x -C archive/      # a git-ignored directory
    python3 tools/time_norm_kernels.py archive . . archive

Each argument is the root of a checkout holding `leopard_tpu_torch/`; the
package is imported from each root in turn (its modules dropped from
`sys.modules` between roots, its kernels built into that root's `build/`).
K3b (`fused_layer_norm`) is timed in bf16 at the rows chip_smoke.py's
phase 3 gives it (its `k3b_shapes`, of this checkout), on the same seeded
inputs, with the L2 cache flushed
before each launch (median of 10 launches by CUDA events, after a
warm-up); `F.layer_norm` is timed once beside each shape, and the host
time of one wrapper call (µs, the device kept ahead: chip_smoke.host_us).
Prints one line per root and shape with the time, its share of the byte
bound, the host µs and its largest difference from the plain version and
from the first root's output, the card's name and power limit, and last a
JSON object with every number.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402  (the repo root, for its shapes and timers)
from tools import checkout_timing as timing  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("time_norm_kernels: no CUDA device", file=sys.stderr)
        return 1
    roots = timing.roots()
    device = torch.device("cuda")
    card = timing.card()
    flush = timing.flush_buffer(device)
    shapes = smoke.k3b_shapes()  # in this checkout's smoke
    results, first, library = [], {}, {}
    for i, root in enumerate(roots):
        fused_norms, norms = timing.import_port(root, "ops.fused_norms", "ops.norms")
        for name, (rows, h, eps) in shapes.items():
            g = torch.Generator(device=device).manual_seed(smoke.SEED)
            x = (torch.randn((rows, h), generator=g, device=device) * 2 + 0.5).to(torch.bfloat16)
            w, b = (torch.randn(h, generator=g, device=device).to(torch.bfloat16)
                    for _ in range(2))
            got = fused_norms.fused_layer_norm(x, w, b, eps)
            plain_err = (got.float() - norms.layer_norm_ref(x, w, b, eps).float()).abs().max()
            diff = (got.float() - first[name]).abs().max().item() if i else 0.0
            first.setdefault(name, got.float())
            ms = smoke.cuda_ms(lambda: fused_norms.fused_layer_norm(x, w, b, eps), flush=flush)
            if name not in library:
                library[name] = smoke.cuda_ms(lambda: F.layer_norm(x, (h,), w, b, eps),
                                              flush=flush)
            host_us = smoke.host_us(lambda: fused_norms.fused_layer_norm(x, w, b, eps))
            bound_ms = smoke.nbytes(x, w, b, got) / smoke.PEAK_BYTES_S * 1e3
            results.append({"root": str(root), "shape": name, "rows": rows, "width": h,
                            "ms": ms, "bound_ms": bound_ms, "bound_share": bound_ms / ms,
                            "library_ms": library[name], "host_us": host_us,
                            "max_abs_err": plain_err.item(), "max_diff_vs_first": diff})
            print(f"{root.name or root}: K3b {name} [{rows}, {h}] bf16: {ms:.4f} ms "
                  f"({bound_ms / ms:.3f} of the bound {bound_ms:.4f}), F.layer_norm "
                  f"{library[name]:.4f} ms, host {host_us:.1f} µs a call, max |err| vs plain "
                  f"{plain_err.item():.4g}, vs {roots[0].name or roots[0]} {diff:.4g} [{card}]",
                  flush=True)
            del x, got
    print(card)
    print(json.dumps({"card": card, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
