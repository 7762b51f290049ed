"""The time on the card a step of the fp32 masters and AdamW, read from the
program's spans: the stream time of `train.cast` (masters to the compute
copy), `train.grads` (its gradients to fp32), `train.norm` (the global norm
and the step's host reads) and `train.adamw`, idle included, over the
steps, one `train.cast` span each. None where the program records no such
spans."""

PHASES = ("train.cast", "train.grads", "train.norm", "train.adamw")


def read(run):
    try:
        from leopard_tpu_torch.utils.timers import span_totals
    except ImportError:
        return None
    t = span_totals()
    spans = [t.get(name) for name in PHASES]
    if any(s is None or s["stream_ms"] is None for s in spans):
        return None
    return sum(s["stream_ms"] for s in spans) / t["train.cast"]["n"]
