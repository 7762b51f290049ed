"""The anyres tile arithmetic, frozen here so that the traffic does not move
when the program's copy does.

A copy of `allocate_patches`, `select_best_resolution` and `plan_tile_grid`
from leopard_tpu_torch/data/anyres.py (itself the Leopard method's), on
(width, height) pairs only: no pixels, no PIL. A request's crops are, per
image, its grid's tiles plus the resized original.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


def allocate_patches(image_sizes: Sequence[Tuple[int, int]], tile_size: int,
                     tile_budget: int) -> List[int]:
    counts = []
    for w, h in image_sizes:
        n = round(w / tile_size) * round(h / tile_size)
        counts.append(0 if n == 1 else n)
    total = sum(counts)
    if total <= tile_budget:
        return counts
    scale = tile_budget / total
    scaled = [int(n * scale) for n in counts]
    while sum(scaled) > tile_budget:
        excess = sum(scaled) - tile_budget
        for i in range(len(scaled)):
            if scaled[i] > 0:
                scaled[i] -= 1
                excess -= 1
            if excess == 0:
                break
    return scaled


def select_best_resolution(original_size: Tuple[int, int], num_tiles: int,
                           tile_size: int) -> Optional[Tuple[int, int]]:
    if num_tiles == 0:
        return None
    ow, oh = original_size
    best = None
    max_effective = 0
    min_wasted = float("inf")
    for rows in range(1, num_tiles + 1):
        for cols in range(1, num_tiles + 1):
            if rows * cols > num_tiles or (rows == 1 and cols == 1):
                continue
            height = rows * tile_size
            width = cols * tile_size
            scale = min(width / ow, height / oh)
            dw, dh = int(ow * scale), int(oh * scale)
            effective = min(dw * dh, ow * oh)
            wasted = width * height - effective
            if effective > max_effective or (
                effective == max_effective and wasted < min_wasted
            ):
                max_effective = effective
                min_wasted = wasted
                best = (width, height)
    if best == (tile_size, tile_size):
        return None
    return best


def tiles_per_image(image_sizes: Sequence[Tuple[int, int]], tile_size: int,
                    total_budget: int) -> List[int]:
    """Each image's grid tiles under the global budget (the original crop not
    counted): plan_tile_grid, then the grid's tile count."""
    budget = total_budget - len(image_sizes)
    if budget <= 0:
        return [0] * len(image_sizes)
    counts = allocate_patches(image_sizes, tile_size, budget)
    grids = [select_best_resolution(sz, n, tile_size) for sz, n in zip(image_sizes, counts)]
    return [0 if g is None else (g[0] // tile_size) * (g[1] // tile_size) for g in grids]
