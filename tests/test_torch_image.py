"""The port's image functions (leopard_tpu_torch/ops/image.py) against the
JAX package's (leopard_tpu/ops/image.py) on the CPU, on seeded numpy
inputs: `resize_images` by every method `jax.image.resize` accepts, down
and up, from uint8 and from float32; `normalize_images`; `center_crop`; and
`preprocess_on_device`.

Tolerance for float32 outputs: atol 2e-6 on values in [0, 1], divided by
the std after the normalization, which scales them by 1 / std. Both sides
build the weight matrices from the same float32 formulas, but XLA's fused
elementwise code (its own sin, FMAs) rounds some weights an ulp apart, and
each pixel sums up to 2 × 11 taps (Lanczos-5 at a 2× downsample), with
negative lobes, in another order: 1.25e-6 at most over these cases
(Lanczos-5 upsampling), 1.8e-7 for linear. The nearest method and the
crop move pixels without arithmetic and are compared exactly, but for the
uint8 scale: the port divides by 255 as the JAX source says, XLA
multiplies by 1/255, one float32 rounding apart (rtol 2^-23).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leopard_tpu.ops import image as jimage
from leopard_tpu_torch.ops import image as timage

torch.set_num_threads(2)
ATOL = 2e-6
METHODS = ["nearest", "linear", "bilinear", "trilinear", "triangle", "cubic", "bicubic",
           "tricubic", "lanczos3", "lanczos5"]
SIZES = {"down": (16, 13), "up": (70, 58), "down_up": (23, 40), "same": (37, 29)}


def _images(dtype, shape=(2, 3, 37, 29), seed=0):
    rng = np.random.RandomState(seed)
    if dtype == "uint8":
        return rng.randint(0, 256, shape).astype(np.uint8)
    return rng.rand(*shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("size", list(SIZES), ids=list(SIZES))
@pytest.mark.parametrize("method", METHODS)
def test_resize_images_matches_jax(method, size, dtype):
    a = _images(dtype)
    want = np.asarray(jimage.resize_images(jnp.asarray(a), SIZES[size], method))
    got = timage.resize_images(torch.from_numpy(a), SIZES[size], method).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    if method == "nearest" and dtype == "float32":
        np.testing.assert_array_equal(got, want)
    elif method == "nearest":
        np.testing.assert_allclose(got, want, rtol=2**-23, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_resize_refuses_what_jax_refuses():
    a = _images("float32")
    with pytest.raises(ValueError):
        jimage.resize_images(jnp.asarray(a), (8, 8), "area")
    with pytest.raises(ValueError):
        timage.resize_images(torch.from_numpy(a), (8, 8), "area")


def test_normalize_images_matches_jax():
    a = _images("float32")
    mean = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
    std = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
    want = np.asarray(jimage.normalize_images(jnp.asarray(a), jnp.asarray(mean),
                                              jnp.asarray(std)))
    got = timage.normalize_images(torch.from_numpy(a), torch.from_numpy(mean),
                                  torch.from_numpy(std)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("crop", [(32, 24), (37, 29), (1, 1), (20, 29)])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_center_crop_exact(crop, dtype):
    a = _images(dtype)
    want = np.asarray(jimage.center_crop(jnp.asarray(a), crop))
    got = timage.center_crop(torch.from_numpy(a), crop).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["bicubic", "lanczos5", "nearest"])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_preprocess_on_device_matches_jax(dtype, method):
    a = _images(dtype, shape=(2, 3, 64, 48), seed=1)
    kw = dict(size=(56, 40), mean=(0.5, 0.4, 0.3), std=(0.2, 0.25, 0.3), method=method)
    want = np.asarray(jimage.preprocess_on_device(jnp.asarray(a), **kw))
    got = timage.preprocess_on_device(torch.from_numpy(a), **kw).numpy()
    assert got.shape == want.shape == (2, 3, 56, 40) and got.dtype == np.float32
    # (x - mean) / std scales a [0, 1] difference by up to 1 / 0.2
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL / 0.2)


def test_preprocess_on_device_range():
    """Bicubic overshoots past [0, 1] at a black-white edge; the clip keeps
    the normalized output in [(0 - 0.5) / 0.5, (1 - 0.5) / 0.5], as JAX's."""
    a = np.zeros((1, 3, 20, 20), np.uint8)
    a[..., 10:] = 255
    want = np.asarray(jimage.preprocess_on_device(jnp.asarray(a), size=(47, 47)))
    got = timage.preprocess_on_device(torch.from_numpy(a), size=(47, 47)).numpy()
    unclipped = timage.resize_images(torch.from_numpy(a), (47, 47)).numpy()
    assert unclipped.min() < 0 and unclipped.max() > 1
    assert got.min() == -1.0 and got.max() == 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * ATOL)
    white = np.full((1, 3, 20, 20), 255, np.uint8)
    np.testing.assert_allclose(
        timage.preprocess_on_device(torch.from_numpy(white), size=(28, 28)).numpy(), 1.0,
        atol=1e-5)
