#!/usr/bin/env python3
"""Time the flash-attention kernels K1 (forward) and K2 (backward) of one or
more checkouts of the port, in turns, in one process on one CUDA card.

    git archive <parent> | tar -x -C archive/      # a git-ignored directory
    python3 tools/time_flash_kernels.py archive . . archive

Each argument is the root of a checkout holding `leopard_tpu_torch/`; the
package is imported from each root in turn (its modules dropped from
`sys.modules` between roots, its kernels built into that root's `build/`),
and K1 and K2 are timed at the shapes of chip_smoke.py's phase 3 (its
K1_SHAPES and k2_shapes, of this checkout) on its seeded inputs, with the
tile ranges computed once and passed in, as the decoder does, where the
checkout's kernels take them. Prints one line per root and shape, the card's
name and power limit, and last a JSON object with every time in ms (median
of 10 launches by CUDA events, after a warm-up) and each root's largest
difference from the first root's outputs.
"""

from __future__ import annotations

import inspect
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402  (the repo root, for its shapes)
from tools import checkout_timing as timing  # noqa: E402


def time_one(fa, kind, q, k, v, dout, seg, causal):
    """(ms, outputs) of K1 or K2 at one shape."""
    kw = dict(causal=causal, q_segment_ids=seg, kv_segment_ids=seg, sliding_window=None)
    if "ranges" in inspect.signature(fa.flash_attention).parameters:
        kw["ranges"] = fa.tile_ranges(seg, seg, sq=q.shape[1], skv=k.shape[1], causal=causal,
                                      device=q.device)
    if kind == "K1":
        return (smoke.cuda_ms(lambda: fa.flash_attention(q, k, v, **kw)),
                [fa.flash_attention(q, k, v, **kw)])
    out, lse = fa._launch(q, k, v, with_lse=True, **kw)
    bkw = {key: kw[key] for key in ("causal", "sliding_window", "ranges") if key in kw}
    return (smoke.cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, seg, seg, out, lse, dout,
                                                         **bkw)),
            fa.flash_attention_bwd(q, k, v, seg, seg, out, lse, dout, **bkw))


def main() -> int:
    if not torch.cuda.is_available():
        print("time_flash_kernels: no CUDA device", file=sys.stderr)
        return 1
    roots = timing.roots()
    device = torch.device("cuda")
    card = timing.card()
    results, first = [], {}
    for i, root in enumerate(roots):
        fa, config = timing.import_port(root, "ops.flash_attention", "config")
        full = config.leopard_llava_8b()
        shapes = [("K1", name, kw) for name, kw in smoke.K1_SHAPES.items()]
        shapes += [("K2", name, kw) for name, kw in smoke.k2_shapes(full.text, full.vision).items()]
        for kind, name, kw in shapes:
            key = f"{kind} {name}"
            q, k, v, dout, seg = smoke.attn_inputs(kw["b"], kw["s"], kw["hq"], kw["hkv"],
                                                   kw["d"], kw["rows"], device)
            ms, got = time_one(fa, kind, q, k, v, dout, seg, kw["causal"])
            valid = (torch.ones(q.shape[:2], dtype=torch.bool, device=device) if seg is None
                     else seg != 0)
            got = [t[valid].float() for t in got]
            diff = max((a - w).abs().max().item() for a, w in zip(got, first[key])) if i else 0.0
            first.setdefault(key, got)
            results.append({"root": str(root), "shape": key, "ms": ms, "max_diff_vs_first": diff})
            print(f"{root.name or root}: {key}: {ms:.4f} ms, max |diff| vs {roots[0].name} "
                  f"{diff:.6g} [{card}]", flush=True)
            del q, k, v, dout, got
            torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"card": card, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
