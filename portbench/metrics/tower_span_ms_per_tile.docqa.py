"""The vision tower's time on the card a real tile, read from the program's
spans: the stream time of the `model.tower` spans (CUDA events at each span's
open and close: normalisation, SigLIP, pixel shuffle and projector, the
bucket's padding tiles included) over the real tiles the `engine.tiles`
spans counted. Unlike `tower_ms_per_tile.docqa`, the host's padding and the
tiles' copy lie outside. None where the program records no such spans."""


def read(run):
    try:
        from leopard_tpu_torch.utils.timers import span_totals
    except ImportError:
        return None
    t = span_totals()
    tower, tiles = t.get("model.tower"), t.get("engine.tiles")
    if tower is None or tiles is None or tower["stream_ms"] is None:
        return None
    n = tiles["counts"].get("tiles", 0)
    return tower["stream_ms"] / n if n else None
