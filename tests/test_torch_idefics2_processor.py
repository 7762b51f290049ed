"""The port's Idefics2 processor (leopard_tpu_torch/data/idefics2_processor.py)
against the JAX package's: the resize rule, the preprocessed pixels and
masks byte for byte, and the SFT answer mask, on seeded noise images of the
sizes a server sees (larger than 980 px, square, landscape, portrait, below
the 378-px shortest edge, and one exactly at 980 × 980)."""

import numpy as np
import pytest
from PIL import Image

from leopard_tpu.data import idefics2_processor as jproc
from leopard_tpu_torch.data import idefics2_processor as tproc


def _noise(w, h, seed):
    rng = np.random.RandomState(seed)
    return Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8))


@pytest.mark.parametrize("size", [(980, 980), (1400, 700), (700, 1400), (200, 400),
                                  (3000, 100), (50, 50), (378, 377), (981, 5), (1, 1),
                                  (640, 480)])
def test_resize_rule_matches_jax(size):
    assert tproc.resize_for_navit(size) == jproc.resize_for_navit(size)
    assert tproc.resize_for_navit(size, 100, 200) == jproc.resize_for_navit(size, 100, 200)


BATCHES = {
    "full_980_and_others": [(980, 980), (1400, 700), (300, 900), (200, 400)],
    "landscape_only": [(1200, 500), (800, 600)],
    "one_small": [(60, 40)],
    "ragged_patch_edges": [(993, 411), (415, 987), (379, 379)],
}


@pytest.mark.parametrize("name", list(BATCHES))
def test_preprocess_matches_jax_byte_for_byte(name):
    images = [_noise(w, h, seed=i) for i, (w, h) in enumerate(BATCHES[name])]
    got = tproc.preprocess_idefics2(images)
    want = jproc.preprocess_idefics2(images)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    pixels, mask, patch_mask = got
    assert pixels.shape[2] % 14 == 0 and pixels.shape[3] % 14 == 0
    # a real patch holds a real pixel; padding is zero and masked
    assert not pixels[~np.broadcast_to(mask[:, None], pixels.shape)].any()
    assert patch_mask.shape == (len(images), pixels.shape[2] // 14, pixels.shape[3] // 14)


def test_preprocess_patch_mask_is_a_top_left_rectangle():
    images = [_noise(980, 980, 0), _noise(1400, 700, 1), _noise(300, 900, 2)]
    _, _, patch_mask = tproc.preprocess_idefics2(images)
    for m in patch_mask:
        rows, cols = m[:, 0].sum(), m[0].sum()
        want = np.zeros_like(m)
        want[:rows, :cols] = True
        np.testing.assert_array_equal(m, want)
    assert patch_mask[0].all() and patch_mask.shape[1:] == (70, 70)


def test_preprocess_options_match_jax():
    images = [_noise(500, 300, 3), _noise(120, 260, 4)]
    kw = dict(shortest_edge=112, longest_edge=224, patch_size=16, mean=(0.5, 0.5, 0.5),
              std=(0.25, 0.5, 1.0))
    for g, w in zip(tproc.preprocess_idefics2(images, **kw),
                    jproc.preprocess_idefics2(images, **kw)):
        assert g.tobytes() == w.tobytes()


EOU = 32002


@pytest.mark.parametrize("ids", [
    [5, 6, 7, EOU, 1, 2, 3, 4, 5, 6, 9, 9, EOU],
    [5, EOU, 0, 0, 0, 0, 0, 0, 8, 8],
    [EOU, 1, 2, 3, 4, 5, 6, 7, EOU, 9, EOU, 1, 2, 3, 4, 5, 6, 7, 8, EOU],
    [1, 2, 3],
    [EOU, EOU],
    [9, 9, 9, 9, EOU, 1, 2],
])
def test_answer_loss_mask_matches_jax(ids):
    ids = np.asarray(ids)
    got = tproc.answer_loss_mask(ids, EOU)
    want = jproc.answer_loss_mask(ids, EOU)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tproc.answer_loss_mask(ids, EOU, 2),
                                  jproc.answer_loss_mask(ids, EOU, 2))
