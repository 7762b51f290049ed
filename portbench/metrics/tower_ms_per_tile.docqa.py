"""The vision tower's device time a real tile: CUDA events around each
`Engine.encode_images` call of the window, summed, over the tiles the calls
were given (not the bucket's padding)."""


def read(run):
    tiles = run.data.get("tower_tiles")
    if not tiles or run.device != "cuda":
        return None
    return run.data["tower_ms"] / tiles
