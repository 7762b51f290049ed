"""MoE router statistics over padding rows (ops/moe.py's docstring).

The reference leaves what a padding row (segment id 0) holds unspecified:
its attention reads no key, and the router counts the row like any other.
In the dense attention tier both packages give such a query V's mean, so
there the router's statistics over a batch with padded rows are defined,
and the port's aux loss, z loss and dropped count equal the JAX package's,
for the capacity path (which drops) and dropless, on rows padded by half
and by a few positions. float32 on the CPU, the JAX init's weights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leopard_tpu import config as jcfgs
from leopard_tpu.models import decoder as jdecoder
from leopard_tpu.models import vlm as jvlm
from leopard_tpu_torch import config as tcfgs
from leopard_tpu_torch.convert.from_jax import state_dict_from_jax
from leopard_tpu_torch.models import vlm as tvlm
from leopard_tpu_torch.ops.attention import attention, make_attention_mask

MODES = {"capacity": dict(moe_dropless=False, moe_capacity_factor=1.0),
         "dropless": dict(moe_dropless=True)}
PADDING = {"half": (16, 3), "tail": (29, 30)}   # the valid lengths of the two rows of 32


def moe_cfg(mod, mode):
    cfg = mod.tiny_vlm()
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_experts=4, moe_top_k=2, attn_impl="dense", **MODES[mode]))


def test_dense_tier_gives_a_padding_query_the_mean_of_v():
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 8, h, 4).astype(np.float32)) for h in (2, 2, 2))
    seg = torch.tensor([[1] * 5 + [0] * 3])
    mask = make_attention_mask(8, 8, causal=True, q_segment_ids=seg, kv_segment_ids=seg)
    out = attention(q, k, v, mask=mask)
    for row in (5, 6, 7):
        torch.testing.assert_close(out[0, row], v[0].mean(0), atol=1e-6, rtol=0)


@pytest.mark.parametrize("padding", list(PADDING))
@pytest.mark.parametrize("mode", list(MODES))
def test_router_statistics_over_padding_rows_match_jax(mode, padding):
    jcfg, tcfg = moe_cfg(jcfgs, mode), moe_cfg(tcfgs, mode)
    params = jax.device_get(jvlm.init_params(jcfg, jax.random.PRNGKey(3)))
    model = tvlm.LeopardVLM(tcfg)
    model.load_state_dict(state_dict_from_jax(params, tcfg), strict=True)
    rng = np.random.RandomState(len(mode) + len(padding))
    tokens = rng.randint(1, 500, (2, 32)).astype(np.int32)
    seg = np.zeros((2, 32), np.int32)
    for r, n in enumerate(PADDING[padding]):
        seg[r, :n] = 1
    tokens[seg == 0] = 0
    assert model.text._attn_impl(32, None, False) == "dense"
    _, _, jaux = jdecoder.forward(params["text"], jcfg.text, jnp.asarray(tokens),
                                  segment_ids=jnp.asarray(seg), return_aux=True)
    with torch.no_grad():
        _, _, taux = model.text(torch.from_numpy(tokens).long(),
                                segment_ids=torch.from_numpy(seg), return_aux=True)
    for name in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    slots = 2 * 32 * tcfg.text.moe_top_k  # T · k, padding rows counted
    dropped = float(taux["fraction_dropped"]) * slots
    assert round(dropped) == round(float(jaux["fraction_dropped"]) * slots)
    assert abs(dropped - round(dropped)) < 1e-3
    assert (dropped > 0) == (mode == "capacity")
