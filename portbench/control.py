"""The readings that a cell's limits are set from, on the chip at the cell's
own size: the program's sound runs over many seeds, its lower-precision
control, and the faults a check must catch. The benchmark's own runs never
run this.

    python3 -m portbench.control --workload <name> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--witness-seeds 7,8] [--seconds 3]

For every `--seeds` seed, one run of the cell in this process (a short
window; the same set-up, timed path and check as a benchmark run) prints its
compared numbers: the lower readings. For every `--control-seeds` seed:
  - a serving cell runs again with the program's int8 weights
    (`Engine(quantize="int8")`), the nearest precision below the bf16 that
    the configuration states, and prints its numbers against the reference;
  - a training cell runs the plain reference in the program's place with
    fp8 (e4m3) operands in every product, and the fault of a loss taken
    over half of the batch's rows, each against the float32 reference
    (a state left unchanged reads 1 on `change_gap` and needs no run).
For every `--witness-seeds` seed of a training cell, one run of the cell,
then the reference again with its weights rounded to bfloat16 from its
float32 masters at every step (`bf16_compute`): the program against that
witness, and the witness against the float32 reference, each with the
steps' global gradient norms. It shows how much of the program's gap to the
float32 reference its bfloat16 compute copy explains.
Each line is JSON: {"seed", "what", "numbers", "beside"}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="readings for a cell's limits")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")

    import torch

    from portbench.harness import Run, execute

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2

    def emit(seed, what, numbers, beside=None):
        print(json.dumps({"seed": seed, "what": what, "numbers": numbers, "beside": beside}),
              flush=True)

    for seed in _seeds(args.seeds):
        run = Run(root, args.workload, seed, args.seconds, False)
        execute(run)
        emit(seed, "program", run.numbers, run.diagnostics)
    for seed in _seeds(args.control_seeds):
        run = Run(root, args.workload, seed, args.seconds, False)
        if run.traffic["kind"] == "train":
            for what, readings in train_control(run).items():
                emit(seed, what, *readings)
        else:
            run.variant = "int8"
            execute(run)
            emit(seed, "int8 program", run.numbers, run.diagnostics)
    for seed in _seeds(args.witness_seeds):
        run = Run(root, args.workload, seed, args.seconds, False)
        execute(run)
        emit(seed, "program", run.numbers, run.diagnostics)
        for what, readings in train_witness(run).items():
            emit(seed, what, *readings)
    return 0


def train_witness(run) -> dict:
    """{what: (compared, beside)}: the program (`run` after its execution)
    against the reference with bfloat16 compute weights, and that reference
    against the float32 one; `beside` also holds the worst leaf's change gap
    and each side's gradient norms by step."""
    from portbench.drivers.train import numbers, reference
    from portbench.traffic.generate import train_batches

    batches = train_batches(run.traffic, run.cfg, run.seed, run.device)
    batches = batches[:run.traffic["reference_steps"]]
    for b in batches:
        b["grids"] = b.pop("stats")["grids"]
    prog, ref = run.data["prog"], run.data["ref"]
    wit = reference(run, batches, bf16_compute=True)
    out = {}
    for what, a, b in (("program vs bf16-compute reference", prog, wit),
                       ("bf16-compute reference vs float32 reference", wit, ref)):
        compared, beside = numbers(a, b)
        out[what] = (compared, dict(beside, gnorm=a["gnorm"], gnorm_against=b["gnorm"]))
    return out


def train_control(run) -> dict:
    """{what: (compared, beside)} of the reference put in the program's
    place with fp8 operands, and of the fault of a loss over half of the
    rows, each against the float32 reference, on the cell's first
    batches."""
    from portbench.drivers.train import numbers, reference
    from portbench.traffic.generate import train_batches

    n = run.traffic["reference_steps"]
    batches = train_batches(run.traffic, run.cfg, run.seed, run.device)[:n]
    for b in batches:
        b["grids"] = b.pop("stats")["grids"]
    ref = reference(run, batches)
    return {what: numbers(reference(run, batches, **kw), ref)
            for what, kw in (("fp8 reference", {"fp8": True}),
                             ("half batch", {"half_batch": True}))}

if __name__ == "__main__":
    sys.exit(main())
