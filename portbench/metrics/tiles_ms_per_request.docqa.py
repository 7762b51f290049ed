"""The host's time a request in the serving entry's tile step, read from the
program's spans: the host time of the `engine.tiles` spans (padding the
tiles to their bucket and the pageable copy to the card) over the requests,
one `engine.pack` span each. None where the program records no such spans."""


def read(run):
    try:
        from leopard_tpu_torch.utils.timers import span_totals
    except ImportError:
        return None
    t = span_totals()
    tiles, pack = t.get("engine.tiles"), t.get("engine.pack")
    if tiles is None or pack is None:
        return None
    return tiles["host_ms"] / pack["n"]
