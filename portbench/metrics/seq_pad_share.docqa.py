"""The share of the sequence buckets' slots that hold padding, read from the
program's counts: 100 · (1 − real prompt tokens / rows × bucket) over the
`engine.pack` spans. In %. None where the program records no such spans."""


def read(run):
    try:
        from leopard_tpu_torch.utils.timers import span_totals
    except ImportError:
        return None
    pack = span_totals().get("engine.pack")
    if pack is None or not pack["counts"].get("slots"):
        return None
    c = pack["counts"]
    return 100.0 * (1.0 - c["tokens"] / c["slots"])
