"""The whole prefill's share of the card's bf16 peak: the model operations
of the requests (their real tiles and prompt tokens, yardstick/flops.py)
over their times to first token and 989 TF/s; the requests after the traced
part of the window, where there are any. In %."""

from portbench.yardstick import flops
from portbench.yardstick.peaks import BF16_FLOPS


def read(run):
    if run.device != "cuda":
        return None
    reqs = run.data["requests"]
    reqs = [r for r in reqs if not r[3]] or reqs
    work = flops.Work()
    for crops, tokens, _, _ in reqs:
        flops.llava_prefill(run.cfg, work, crops, tokens)
    return 100.0 * work.flops / (sum(r[2] for r in reqs) * BF16_FLOPS)
