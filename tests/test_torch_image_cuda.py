"""The port's image functions (leopard_tpu_torch/ops/image.py) on the card
against the same calls on the CPU, with TF32 matmuls switched on: the
resize contracts float32 images at full precision whatever that setting.

These tests need an NVIDIA GPU and skip elsewhere. The file imports no JAX,
so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_image_cuda.py

Tolerance: rtol = atol = 1e-5 on values in [0, 1] (up to 2.2 after the
normalization): float32 products summed in another order. A TF32
contraction (10-bit mantissas) would miss it by two orders of magnitude.
"""

import numpy as np
import pytest
import torch

from leopard_tpu_torch.ops import image

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture
def tf32_on():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["bilinear", "bicubic", "lanczos3", "lanczos5"])
@pytest.mark.parametrize("size", [(96, 80), (300, 260)], ids=["down", "up"])
def test_resize_full_fp32_under_tf32(cuda, tf32_on, method, size):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((2, 3, 160, 130), dtype=np.float32))
    got = image.resize_images(x.to(cuda), size, method)
    torch.testing.assert_close(got.cpu(), image.resize_images(x, size, method), **TOL)


@pytest.mark.cuda
def test_preprocess_full_fp32_under_tf32(cuda, tf32_on):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(0, 256, (2, 3, 448, 336), dtype=np.uint8))
    mean, std = (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)
    got = image.preprocess_on_device(x.to(cuda), (364, 364), mean, std)
    assert got.dtype == torch.float32 and got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), image.preprocess_on_device(x, (364, 364), mean, std),
                               **TOL)
