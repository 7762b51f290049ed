"""The fp32 cross-entropy's time on the card a step, read from the program's
spans: the stream time of the `train.loss` spans, from the loss's first
chunk to its input's gradient (forward, recompute and backward, idle
included), over the steps, one `train.cast` span each. None where the
program records no such spans."""


def read(run):
    try:
        from leopard_tpu_torch.utils.timers import span_totals
    except ImportError:
        return None
    t = span_totals()
    loss, cast = t.get("train.loss"), t.get("train.cast")
    if loss is None or cast is None or loss["stream_ms"] is None:
        return None
    return loss["stream_ms"] / cast["n"]
