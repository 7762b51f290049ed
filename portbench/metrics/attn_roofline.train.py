"""K1 and K2's share of their roofline over the traced steps: the bound of
the attention the steps' real patches and tokens need, forward and backward
(yardstick/flops.py), summed call by call, over the device time of the
kernels that the name rule of K1 and K2 (yardstick/kernels.py) gives. In %."""

from portbench.yardstick import flops, kernels


def read(run):
    t = run.tracer
    if not t.traced:
        return None
    k = t.kernel_s(kernels.attention_kernel)
    if k <= 0:
        return None
    work = flops.Work()
    for stats, _, traced in run.data["steps"]:
        if traced:
            flops.train_step(run.cfg, work, stats)
    return 100.0 * work.attn_bound_s / k
