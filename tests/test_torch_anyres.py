"""The port's anyres tiling (`leopard_tpu_torch/data/anyres.py`) against the
JAX package's module, function by function: the same plans, tile counts
and crops, and pixels byte for byte (uint8 tiles) or bit for bit (float
tiles), on seeded image sizes and budgets plus the hand-derived cases of
tests/test_anyres.py (banker's rounding, the round-robin trim)."""

import numpy as np
import pytest
from PIL import Image

from leopard_tpu.data import anyres as jref
from leopard_tpu_torch.data import anyres


def _noise(w, h, seed, mode="RGB"):
    px = np.random.RandomState(seed).randint(0, 256, (h, w, 3), dtype=np.uint8)
    return Image.fromarray(px).convert(mode)


def _sizes(seed, n):
    rng = np.random.RandomState(seed)
    return [(int(rng.randint(40, 2000)), int(rng.randint(40, 2000))) for _ in range(n)]


def _same_images(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.size == y.size and x.mode == y.mode
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("sizes,budget,want", [
    ([(728, 364), (364, 364)], 50, [2, 0]),
    ([(500, 400)], 50, [0]),
    ([(546, 364)], 50, [2]),        # 1.5 rounds to 2 (even)
    ([(910, 364)], 50, [2]),        # 2.5 rounds to 2 (even)
    ([(728, 728), (728, 728)], 5, [2, 2]),
    ([(728, 728)] * 3, 10, [3, 3, 3]),   # the trim cases
    ([(728, 728)] * 3, 7, [2, 2, 2]),
    ([(728, 728)] * 3, 5, [1, 1, 1]),
    ([(1820, 364), (364, 1820), (1092, 1092)], 6, [1, 1, 2]),
])
def test_torch_allocate_patches_cases(sizes, budget, want):
    got = anyres.allocate_patches(sizes, 364, budget)
    assert got == jref.allocate_patches(sizes, 364, budget) == want


@pytest.mark.parametrize("seed", range(6))
def test_torch_planning_matches_jax_seeded(seed):
    rng = np.random.RandomState(100 + seed)
    sizes = _sizes(seed, int(rng.randint(1, 7)))
    tile, total = int(rng.choice([56, 364])), int(rng.randint(2, 60))
    assert anyres.allocate_patches(sizes, tile, total) == jref.allocate_patches(sizes, tile, total)
    for sz in sizes:
        for n in range(0, 10):
            assert (anyres.select_best_resolution(sz, n, tile)
                    == jref.select_best_resolution(sz, n, tile))
    plan = anyres.plan_tile_grid(sizes, tile, total)
    assert plan == jref.plan_tile_grid(sizes, tile, total)
    assert (anyres.tiles_per_image_from_plan(plan, tile)
            == jref.tiles_per_image_from_plan(plan, tile))


@pytest.mark.parametrize("order", ["train", "eval"])
@pytest.mark.parametrize("seed", range(3))
def test_torch_tile_images_byte_identical(order, seed):
    rng = np.random.RandomState(200 + seed)
    sizes = _sizes(seed + 50, int(rng.randint(1, 4)))
    tile = int(rng.choice([56, 112]))
    # a non-RGB image goes through the same conversion
    images = [_noise(w, h, seed * 10 + i, mode="L" if i == 1 else "RGB")
              for i, (w, h) in enumerate(sizes)]
    got = anyres.tile_images(images, tile_size=tile, total_budget=12, order=order)
    want = jref.tile_images(images, tile_size=tile, total_budget=12, order=order)
    assert got.tiles_per_image == want.tiles_per_image
    assert got.num_images == want.num_images and got.total_crops == want.total_crops
    _same_images(got.tiles, want.tiles)
    # a precomputed plan gives the same crops
    plan = anyres.plan_tile_grid([im.size for im in images], tile, 12)
    _same_images(anyres.tile_images(images, tile, 12, order, resolutions=plan).tiles, got.tiles)
    px = anyres.preprocess_tiles_uint8(got.tiles, tile_size=tile)
    jpx = jref.preprocess_tiles_uint8(want.tiles, tile_size=tile)
    assert px.dtype == jpx.dtype == np.uint8 and px.shape == (got.total_crops, tile, tile, 3)
    np.testing.assert_array_equal(px, jpx)
    fl = anyres.preprocess_tiles(got.tiles, tile_size=tile, mean=(0.4, 0.5, 0.6),
                                 std=(0.2, 0.3, 0.4))
    jfl = jref.preprocess_tiles(want.tiles, tile_size=tile, mean=(0.4, 0.5, 0.6),
                                std=(0.2, 0.3, 0.4))
    assert fl.dtype == jfl.dtype == np.float32
    np.testing.assert_array_equal(fl, jfl)


def test_torch_tile_images_budget_exhausted():
    imgs = [_noise(728, 728, 3)] * 50
    got = anyres.tile_images(imgs, tile_size=364, total_budget=50)
    assert got.tiles_per_image == jref.tile_images(imgs, 364, 50).tiles_per_image == [0] * 50


@pytest.mark.parametrize("size,target", [((200, 100), (364, 364)), ((300, 700), (728, 1092)),
                                         ((1000, 999), (364, 728))])
def test_torch_resize_pad_divide_expand(size, target):
    img = _noise(*size, seed=7)
    got = anyres.resize_and_pad(img, target)
    _same_images([got], [jref.resize_and_pad(img, target)])
    assert anyres.resize_and_pad(img, None) is None
    _same_images(anyres.divide_to_patches(got, 364), jref.divide_to_patches(got, 364))
    _same_images([anyres.expand2square(img, (1, 2, 3))], [jref.expand2square(img, (1, 2, 3))])


def test_torch_preprocess_with_another_resample():
    tiles = [_noise(90, 70, 1), _noise(56, 56, 2)]
    for resample in (Image.BILINEAR, Image.NEAREST):
        np.testing.assert_array_equal(
            anyres.preprocess_tiles_uint8(tiles, 56, resample=resample),
            jref.preprocess_tiles_uint8(tiles, 56, resample=resample))
