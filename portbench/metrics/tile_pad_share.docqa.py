"""The share of the tile buckets' slots that hold padding tiles, read from
the program's counts: 100 · (1 − real tiles / bucket slots) over the
`engine.tiles` spans. In %. None where the program records no such spans."""


def read(run):
    try:
        from leopard_tpu_torch.utils.timers import span_totals
    except ImportError:
        return None
    tiles = span_totals().get("engine.tiles")
    if tiles is None or not tiles["counts"].get("tile_slots"):
        return None
    c = tiles["counts"]
    return 100.0 * (1.0 - c["tiles"] / c["tile_slots"])
