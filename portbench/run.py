"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json, portbench/ and the
port, leopard_tpu_torch/. The run builds the model on the card with weights
drawn from the seed, warms the cell's shapes (set-up, `setup_s`), measures
for `--seconds`, then checks what the window produced against the plain
reference. The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1` `breakdown`,
and last `checks`, each compared number beside its limit; the same numbers
end standard error. It exits non-zero, printing no result, without a CUDA
device, or when JAX or the JAX package was loaded by the time the window
closed.

The port's kernels build into build/ at the root of the checkout (nvcc's
libraries, and Triton's cache in build/triton), so only a checkout's first
run compiles.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")

    import torch

    from portbench.harness import ForbiddenImport, Run, execute

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    run = Run(root, args.workload, args.seed, args.seconds, bool(args.trace),
              t_start=T_START)
    if torch.cuda.device_count() < run.cell["chips"]:
        print(f"portbench: the cell needs {run.cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    try:
        out = execute(run)
    except ForbiddenImport as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    for name, v in run.diagnostics.items():
        print(f"reading {name}: {v!r} (not compared)", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
