"""The NaViT path of the port's SigLIP tower (leopard_tpu_torch/models/siglip.py)
against the JAX package's:

  - `navit_position_ids` against JAX's, on named grids and on every grid up
    to 70 × 70 under the 70-side table of Leopard-Idefics2, where fractions
    land exactly on boundaries (35 of 70); exactly equal, and equal to the
    integer rule that tests/test_torch_idefics2.py gives the jitted JAX
    tower;
  - the tower with patch masks against `siglip.forward` (eager, dense
    attention, as tests/test_idefics2.py runs it) at head dim 72: images of
    mixed aspect ratios and an all-zero image from the tile bucket, valid
    rows at 1e-4, every row finite, through the port's dense and flash
    (its plain version on the CPU) attention;
  - K1's plain version against the JAX kernel in Pallas interpret mode at
    the interleaved segment ids of a patch mask, with the sequence padded
    to a block multiple on the JAX side as siglip.py does (kv-only and full
    segment masks), valid rows at 1e-4; and the tile ranges the kernel
    skips by, which must cover every pair such a mask lets through.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leopard_tpu import config as cfgs
from leopard_tpu.models import siglip as jsiglip
from leopard_tpu_torch.convert.from_jax import state_dict_from_jax
from leopard_tpu_torch.models import siglip as tsiglip
from leopard_tpu_torch.ops import flash_attention as tflash
from leopard_tpu_torch.ops.attention import make_attention_mask
from tests.test_torch_idefics2 import exact_position_ids, navit_images

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


def _mask(grids, nph, npw):
    m = np.zeros((len(grids), nph, npw), bool)
    for i, (r, c) in enumerate(grids):
        m[i, :r, :c] = True
    return m


GRIDS = {
    "full_980": (70, [(70, 70)]),
    "half_rows_35_of_70": (70, [(70, 70), (35, 70), (70, 35)]),
    "ragged": (70, [(70, 50), (51, 70), (27, 69), (1, 1)]),
    "tiny_table": (6, [(6, 6), (3, 6), (5, 2), (1, 6)]),
    "with_padding_image": (6, [(6, 4), (0, 0)]),
}


@pytest.mark.parametrize("name", list(GRIDS))
def test_position_ids_match_jax(name):
    n, grids = GRIDS[name]
    m = _mask(grids, max(r for r, _ in grids) or 1, max(c for _, c in grids) or 1)
    want = np.asarray(jsiglip.navit_position_ids(jnp.asarray(m), n))
    got = tsiglip.navit_position_ids(torch.from_numpy(m), n)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.max() < n * n


@pytest.mark.parametrize("n", [6, 70])
def test_position_ids_on_every_grid(n):
    """Every (rows, cols) up to n × n, with rows and cols running opposite
    ways so that each count meets the other side's: the port, eager JAX and
    the integer rule agree id for id."""
    grids = [(r, c) for r in range(1, n + 1) for c in (r, n + 1 - r)]
    m = _mask(grids, n, n)
    want = np.asarray(jsiglip.navit_position_ids(jnp.asarray(m), n))
    np.testing.assert_array_equal(tsiglip.navit_position_ids(torch.from_numpy(m), n).numpy(),
                                  want)
    np.testing.assert_array_equal(np.asarray(exact_position_ids(jnp.asarray(m), n)), want)
    # a full image maps its rows and columns onto the table one to one
    full = grids.index((n, 1)) - 1
    np.testing.assert_array_equal(want[full], np.arange(n * n))


def _tower_cfg(impl):
    return cfgs.VisionConfig(hidden_size=144, intermediate_size=256, num_layers=2, num_heads=2,
                             image_size=84, patch_size=14, layer_norm_eps=1e-6,
                             dtype="float32", attn_impl=impl)


@pytest.fixture(scope="module")
def tower_params():
    import jax

    return jax.device_get(jsiglip.init_params(_tower_cfg("dense"), jax.random.PRNGKey(3)))


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_tower_with_patch_masks_matches_jax(tower_params, impl):
    """Wide, tall and full images plus an all-zero one on a 6 × 6 grid."""
    cfg = _tower_cfg(impl)
    tower = tsiglip.SiglipVisionTower(cfg)
    state = state_dict_from_jax({"vision": tower_params}, cfg)
    tower.load_state_dict({k[len("vision."):]: v for k, v in state.items()}, strict=True)
    pixels, mask = navit_images([(6, 6), (3, 6), (6, 2), (0, 0)], seed=4)
    want = np.asarray(jsiglip.forward(tower_params, dataclasses.replace(cfg, attn_impl="dense"),
                                      jnp.asarray(pixels), jnp.asarray(mask)))
    with torch.no_grad():
        got = tower(torch.from_numpy(pixels), torch.from_numpy(mask)).numpy()
    assert got.shape == (4, 36, 144) and np.isfinite(got).all()
    valid = mask.reshape(4, -1)
    np.testing.assert_allclose(got[valid], want[valid], **TOL)
    if impl == "dense":  # the same rule as the JAX dense path on padding rows too
        np.testing.assert_allclose(got, want, **TOL)
    # without a mask every patch is real: the same ids as the plain 6 × 6 grid
    with torch.no_grad():
        full = tower(torch.from_numpy(pixels[:1]), torch.ones((1, 6, 6), dtype=torch.bool))
        plain = tower(torch.from_numpy(pixels[:1]))
    np.testing.assert_allclose(full.numpy(), plain.numpy(), **TOL)


def _navit_segments():
    """Segment ids of a 2-image batch on a 5 × 7 grid (35 patches, no block
    divides it): a 3 × 4 image and an all-zero one."""
    return _mask([(3, 4), (0, 0)], 5, 7).reshape(2, -1).astype(np.int32)


@pytest.fixture
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("kv_only_mask", [True, False], ids=["kv_only", "full_seg"])
def test_k1_plain_version_matches_jax_at_interleaved_segments(interpret_mode, kv_only_mask):
    from leopard_tpu.ops.pallas.flash_attention import flash_attention as jflash

    seg = _navit_segments()
    b, s = seg.shape
    s_pad = 40
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(b, s, 2, 72).astype(np.float32) for _ in range(3))
    pad = ((0, 0), (0, s_pad - s), (0, 0), (0, 0))
    seg_pad = np.pad(seg, ((0, 0), (0, s_pad - s)))
    want = np.asarray(jflash(
        jnp.asarray(np.pad(q, pad)), jnp.asarray(np.pad(k, pad)), jnp.asarray(np.pad(v, pad)),
        causal=False, q_segment_ids=jnp.asarray(seg_pad), kv_segment_ids=jnp.asarray(seg_pad),
        block_q=8, block_k=8, kv_only_mask=kv_only_mask))[:, :s]
    t = torch.from_numpy(seg)
    got = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 causal=False, q_segment_ids=t, kv_segment_ids=t).numpy()
    assert np.isfinite(got).all()
    valid = seg != 0
    np.testing.assert_allclose(got[valid], want[valid], **TOL)


@pytest.mark.parametrize("block", [8, 16])
def test_tile_ranges_cover_interleaved_segments(block):
    """Every pair the mask lets through lies in its q tile's kv range and
    its kv tile's q range; a tile of padding rows alone gets (0, 0); blocks
    that mix real and padding patches carry uid -1."""
    seg = torch.from_numpy(_mask([(4, 5), (5, 2), (0, 0)], 5, 7).reshape(3, -1).astype(np.int32))
    s = seg.shape[1]
    r = tflash.tile_ranges(seg, seg, sq=s, skv=s, causal=False, block=block)
    mask = make_attention_mask(s, s, q_segment_ids=seg, kv_segment_ids=seg)[:, 0]
    for bi, qi, ki in torch.nonzero(mask).tolist():
        lo, hi = r.kv_of_q[bi, qi // block].tolist()
        assert lo <= ki < hi
        lo, hi = r.q_of_kv[bi, ki // block].tolist()
        assert lo <= qi < hi
    assert (r.kv_of_q[2] == 0).all() and (r.q_of_kv[2] == 0).all()
    assert (r.q_uid[:2] == -1).any() and (r.q_uid[2] == -1).all()
