"""The train step's share of the card's bf16 peak: 3 × the forward
operations of the steps (real patches and tokens, yardstick/flops.py) over
their wall time and 989 TF/s; the steps after the traced part of the
window, where there are any. In %."""

from portbench.yardstick import flops
from portbench.yardstick.peaks import BF16_FLOPS


def read(run):
    if run.device != "cuda":
        return None
    steps = run.data["steps"]
    steps = [s for s in steps if not s[2]] or steps
    work = flops.Work()
    for stats, _, _ in steps:
        flops.train_step(run.cfg, work, stats)
    return 100.0 * work.flops / (sum(s[1] for s in steps) * BF16_FLOPS)
