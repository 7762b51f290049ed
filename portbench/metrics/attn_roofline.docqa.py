"""K1's share of its roofline over the traced requests: the bound of the
attention the requests' real tiles and prompts need (yardstick/flops.py),
summed call by call, over the device time of the kernels that K1's name rule
(yardstick/kernels.py) gives. In %."""

from portbench.yardstick import flops, kernels


def read(run):
    t = run.tracer
    if not t.traced:
        return None
    k1 = t.kernel_s(lambda n: bool(kernels.K1.search(n)))
    if k1 <= 0:
        return None
    work = flops.Work()
    for crops, tokens, _, traced in run.data["requests"]:
        if traced:
            flops.llava_prefill(run.cfg, work, crops, tokens)
    return 100.0 * work.attn_bound_s / k1
