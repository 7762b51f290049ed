#!/usr/bin/env python3
"""Time the int4 matmul K4 of one or more checkouts of the port, in turns, in
one process on one CUDA card.

    git archive <parent> | tar -x -C archive/      # a git-ignored directory
    python3 tools/time_int4_kernels.py archive . . archive

Each argument is the root of a checkout holding `leopard_tpu_torch/`; the
package is imported from each root in turn (its modules dropped from
`sys.modules` between roots, its kernel built into that root's `build/`).
K4 is timed at chip_smoke.py's phase-3 shapes (the five 8B decode matmuls
of its K4_SHAPES at M = 2, and gate_up at M = 64) on seeded inputs, with
cold L2 (a 1 GiB read before each launch), and the host time of the
decoder's call (quant.matmul on a [M, 1, K] bf16 x) is taken with the
device kept ahead. Prints one line per root and shape, each root's time
per 8B decode step (32 x (2 wq_wo + 2 wk_wv + 2 gate_up + down) +
lm_head) beside the bound, the card's name and power limit, and last a JSON
object with every number and each root's largest difference from the first
root's outputs. It also times, the same way, one launch of a one-element
add: the floor that any launch measured so pays (the kernel's start after
the flush, and the events around it).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402  (the repo root, for its shapes and timers)

N_LAYERS = 32  # Leopard-LLaVA-8B's text depth


def import_port(root: Path):
    """The root's int4 matmul, quant and params modules."""
    for name in [m for m in sys.modules if m.split(".")[0] == "leopard_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    try:
        from leopard_tpu_torch.models import params
        from leopard_tpu_torch.ops import int4_matmul as tk4
        from leopard_tpu_torch.ops import quant
    finally:
        sys.path.remove(str(root))
    return tk4, quant, params


def main() -> int:
    if not torch.cuda.is_available():
        print("time_int4_kernels: no CUDA device", file=sys.stderr)
        return 1
    roots = [Path(a).resolve() for a in sys.argv[1:]] or [Path(".").resolve()]
    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    shapes = {name: (2, k, n) for name, (k, n, _) in smoke.K4_SHAPES.items()}
    shapes["gate_up_m64"] = (64, 4096, 14336)
    calls = {name: N_LAYERS * per + (name == "lm_head")
             for name, (_, _, per) in smoke.K4_SHAPES.items()}
    bound_ms = sum(calls[name] * (k // 2 * n + k // 128 * n * 4 + m * k * 2 + m * n * 4)
                   for name, (m, k, n) in shapes.items() if name in calls) / smoke.PEAK_BYTES_S * 1e3
    # inputs once, packed by the first root's quantizer (every root packs the
    # same bytes: the JAX package's layout)
    _, quant, _ = import_port(roots[0])
    inputs = {}
    for name, (m, k, n) in shapes.items():
        g = torch.Generator(device=device).manual_seed(smoke.SEED)
        x = torch.randn((m, k), generator=g, device=device, dtype=torch.bfloat16)
        w = torch.randn((n, k), generator=g, device=device, dtype=torch.bfloat16) * k**-0.5
        q = quant.quantize_int4(w)
        inputs[name] = (x, q["q4"], q["s"])
        del w
    flush = torch.empty(2**30 // 4, dtype=torch.float32, device=device)
    one = torch.zeros(1, device=device)
    floor_ms = smoke.cuda_ms(lambda: one.add_(1.0), flush=flush)
    print(f"floor: one launch of a one-element add {floor_ms:.4f} ms [{card}]", flush=True)
    results, first = [{"shape": "floor_one_element_add", "ms": floor_ms}], {}
    for i, root in enumerate(roots):
        tk4, quant, params = import_port(root)
        step = {"ms": 0.0, "host_us": 0.0}
        for name, (x, q4, s) in inputs.items():
            ms = smoke.cuda_ms(lambda: tk4.int4_matmul(x, q4, s), flush=flush)
            x3, qw = x[:, None], params.QuantizedWeight({"q4": q4, "s": s})
            host = smoke.host_us(lambda: quant.matmul(x3, qw))
            got = tk4.int4_matmul(x, q4, s).float()
            diff = (got - first[name]).abs().max().item() if i else 0.0
            first.setdefault(name, got)
            if name in calls:
                step["ms"] += calls[name] * ms
                step["host_us"] += calls[name] * host
            results.append({"root": str(root), "shape": name, "m_k_n": shapes[name], "ms": ms,
                            "host_us": host, "max_diff_vs_first": diff})
            print(f"{root.name or root}: K4 {name} {shapes[name]}: {ms:.4f} ms, host "
                  f"{host:.2f} us/call, max |diff| vs {roots[0].name} {diff:.6g} [{card}]",
                  flush=True)
        results.append({"root": str(root), "shape": "per_decode_step", "ms": step["ms"],
                        "host_us": step["host_us"], "bound_ms": bound_ms})
        print(f"{root.name or root}: K4 per 8B decode step: {step['ms']:.4f} ms "
              f"({bound_ms / step['ms']:.3f} of the {bound_ms:.4f} ms bound), host "
              f"{step['host_us'] / 1e3:.3f} ms [{card}]", flush=True)
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"card": card, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
