"""Adaptive high-resolution ("anyres") multi-image tiling, the Leopard method
(port of leopard_tpu/data/anyres.py, function for function).

Host code over PIL images and numpy arrays; the outputs are byte-identical to
the JAX package's on the same images. The global tile budget is
`total_budget - n_images` (one slot reserved per original image). PIL is
imported inside the functions that touch pixels, so that importing this
module (as the server does) needs no Pillow.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

import numpy as np

if TYPE_CHECKING:
    from PIL import Image


def allocate_patches(
    image_sizes: Sequence[Tuple[int, int]],
    tile_size: int = 364,
    tile_budget: int = 50,
) -> List[int]:
    """Distribute a global tile budget across images in proportion to the
    tiles each would need at native resolution.

    image_sizes are PIL `(width, height)` pairs; an image that rounds to a
    single tile gets 0 (only its resized original). Python's banker's
    rounding, as in the reference; an excess after scaling is trimmed one
    tile at a time, round-robin over the images that still have tiles.
    """
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


def select_best_resolution(
    original_size: Tuple[int, int],
    num_tiles: int,
    tile_size: int = 364,
) -> Optional[Tuple[int, int]]:
    """The (width, height) tile grid of at most num_tiles tiles that
    maximizes the effective resolution, then minimizes the wasted area, for
    this image's aspect ratio. None when the image gets no grid (num_tiles
    == 0, or the best grid is a single tile)."""
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


def resize_and_pad(
    image: "Image.Image", target_resolution: Optional[Tuple[int, int]]
) -> Optional["Image.Image"]:
    """Aspect-preserving resize (PIL's default resample) onto a black canvas
    of target (width, height), centered; ceil on the dimension that is not
    filled, as in the reference."""
    if target_resolution is None:
        return None
    from PIL import Image

    ow, oh = image.size
    tw, th = target_resolution
    scale_w, scale_h = tw / ow, th / oh
    if scale_w < scale_h:
        nw, nh = tw, min(math.ceil(oh * scale_w), th)
    else:
        nh, nw = th, min(math.ceil(ow * scale_h), tw)
    resized = image.resize((nw, nh))
    canvas = Image.new("RGB", (tw, th), (0, 0, 0))
    canvas.paste(resized, ((tw - nw) // 2, (th - nh) // 2))
    return canvas


def expand2square(
    image: "Image.Image", background_color: Tuple[int, int, int]
) -> "Image.Image":
    """Pad to a square with a background color (the 'pad' aspect mode)."""
    from PIL import Image

    w, h = image.size
    if w == h:
        return image
    side = max(w, h)
    canvas = Image.new(image.mode, (side, side), background_color)
    canvas.paste(image, ((side - w) // 2, (side - h) // 2))
    return canvas


def divide_to_patches(image: "Image.Image", tile_size: int) -> List["Image.Image"]:
    """Row-major tile_size×tile_size crops."""
    tiles = []
    w, h = image.size
    for top in range(0, h, tile_size):
        for left in range(0, w, tile_size):
            tiles.append(image.crop((left, top, left + tile_size, top + tile_size)))
    return tiles


@dataclass
class TiledImages:
    """Result of anyres tiling for one sample."""

    tiles: List["Image.Image"]        # flat: [img0 tiles..., img0 orig, img1 tiles..., ...]
    tiles_per_image: List[int]        # tile count per image (excluding the original)

    @property
    def num_images(self) -> int:
        return len(self.tiles_per_image)

    @property
    def total_crops(self) -> int:
        return len(self.tiles)


def plan_tile_grid(
    image_sizes: Sequence[Tuple[int, int]],
    tile_size: int = 364,
    total_budget: int = 50,
) -> List[Optional[Tuple[int, int]]]:
    """The planning half of tile_images: it needs only (width, height)
    pairs, so tile counts and prompts can be built before any pixel is
    decoded."""
    budget = total_budget - len(image_sizes)
    if budget <= 0:
        return [None] * len(image_sizes)
    counts = allocate_patches(image_sizes, tile_size, budget)
    return [
        select_best_resolution(sz, n, tile_size)
        for sz, n in zip(image_sizes, counts)
    ]


def tiles_per_image_from_plan(
    resolutions: Sequence[Optional[Tuple[int, int]]], tile_size: int
) -> List[int]:
    return [
        0 if r is None else (r[0] // tile_size) * (r[1] // tile_size)
        for r in resolutions
    ]


def tile_images(
    images: Sequence["Image.Image"],
    tile_size: int = 364,
    total_budget: int = 50,
    order: str = "train",
    resolutions: Optional[Sequence[Optional[Tuple[int, int]]]] = None,
) -> TiledImages:
    """The anyres pipeline for one multi-image sample.

    Budget = total_budget − n_images; when it is not positive every image
    contributes only its original. Per image the crops are [tiles...,
    original] for order="train" and [original, tiles...] for order="eval".
    `resolutions` takes a precomputed plan_tile_grid result.
    """
    assert order in ("train", "eval")
    images = [im.convert("RGB") if im.mode != "RGB" else im for im in images]
    if resolutions is None:
        resolutions = plan_tile_grid(
            [im.size for im in images], tile_size, total_budget
        )
    padded = [resize_and_pad(im, res) for im, res in zip(images, resolutions)]
    grids = [divide_to_patches(im, tile_size) if im is not None else [] for im in padded]
    out: List["Image.Image"] = []
    per_image = []
    for orig, tiles in zip(images, grids):
        if order == "train":
            out.extend(tiles)
            out.append(orig)
        else:
            out.append(orig)
            out.extend(tiles)
        per_image.append(len(tiles))
    return TiledImages(tiles=out, tiles_per_image=per_image)


def _resized(im: "Image.Image", tile_size: int, resample) -> "Image.Image":
    from PIL import Image

    if im.size != (tile_size, tile_size):
        im = im.resize((tile_size, tile_size),
                       resample=Image.BICUBIC if resample is None else resample)
    return im.convert("RGB")


def preprocess_tiles_uint8(
    tiles: Sequence["Image.Image"],
    tile_size: int = 364,
    resample=None,
) -> np.ndarray:
    """Resize each crop to tile_size² (bicubic unless `resample` says
    otherwise) and return [N, tile_size, tile_size, 3] uint8, NHWC as PIL
    holds it. `Engine.encode_images` normalizes these on the device."""
    out = np.empty((len(tiles), tile_size, tile_size, 3), dtype=np.uint8)
    for i, im in enumerate(tiles):
        out[i] = np.asarray(_resized(im, tile_size, resample), dtype=np.uint8)
    return out


def preprocess_tiles(
    tiles: Sequence["Image.Image"],
    tile_size: int = 364,
    mean: Sequence[float] = (0.5, 0.5, 0.5),
    std: Sequence[float] = (0.5, 0.5, 0.5),
    resample=None,
) -> np.ndarray:
    """SigLIP-style preprocessing on the host: resize each crop to
    tile_size², scale to [0, 1], normalize. Returns [N, 3, tile_size,
    tile_size] float32 (NCHW)."""
    mean = np.asarray(mean, dtype=np.float32).reshape(3, 1, 1)
    std = np.asarray(std, dtype=np.float32).reshape(3, 1, 1)
    out = np.empty((len(tiles), 3, tile_size, tile_size), dtype=np.float32)
    for i, im in enumerate(tiles):
        arr = np.asarray(_resized(im, tile_size, resample), dtype=np.float32) / 255.0
        out[i] = (arr.transpose(2, 0, 1) - mean) / std
    return out
