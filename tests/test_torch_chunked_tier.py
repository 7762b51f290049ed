"""The blockwise `chunked` attention tier (ops/chunked_attention.py::
chunked_attention, models/decoder.py's attn_impl="chunked") against the JAX
package's `chunked_attention` and its decoder at attn_impl="chunked", fp32
on the CPU:

  - forward and gradients (JAX's VJP) with the causal band, segments with
    padding, and a sliding window shorter than a chunk and longer than one,
    with and without the per-chunk recompute, at 1e-5;
  - a query with no key (a padding row) comes out as V's mean on both sides;
  - the tiny decoder at attn_impl="chunked" with Mistral's window, packed
    segments and a padding tail: logits against JAX's, and the gradients of
    its parameters against the flash tier's (the plain K1/K2 versions);
  - the per-chunk recompute keeps the chunk's scores out of the saved
    tensors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leopard_tpu.ops.chunked_attention import chunked_attention as jchunked
from leopard_tpu_torch.ops.chunked_attention import chunked_attention, pick_chunk

ATOL = 1e-5
# name: (causal, segments, window, chunk)
CASES = {
    "causal": (True, False, None, 8),
    "segments": (True, True, None, 8),
    "window_short": (True, True, 5, 16),
    "window_long": (True, False, 20, 8),
    "noncausal_segments": (False, True, None, 8),
    "one_chunk": (True, True, 7, 32),
}


def inputs(seed, b=2, s=32, hq=4, hkv=2, d=8):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(b, s, h, d).astype(np.float32) for h in (hq, hkv, hkv, hq))
    seg = np.array([[1] * 12 + [2] * 20, [1] * 22 + [0] * 10], np.int32)
    return q, k, v, do, seg


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("case", list(CASES))
def test_chunked_attention_matches_jax(case, remat):
    causal, with_seg, window, chunk = CASES[case]
    q, k, v, do, seg = inputs(len(case))
    seg = seg if with_seg else None
    kw = dict(causal=causal, sliding_window=window, chunk_size=chunk)

    def f(q, k, v):
        s = None if seg is None else jnp.asarray(seg)
        return jchunked(q, k, v, q_segment_ids=s, kv_segment_ids=s, remat=remat, **kw)

    out, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    wants = [np.asarray(out), *map(np.asarray, vjp(jnp.asarray(do)))]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    s_t = None if seg is None else torch.from_numpy(seg)
    got = chunked_attention(*leaves, q_segment_ids=s_t, kv_segment_ids=s_t, remat=remat, **kw)
    got.backward(torch.from_numpy(do))
    # every row, padding rows too: both sides give a query with no key V's mean
    np.testing.assert_allclose(got.detach().numpy(), wants[0], atol=ATOL, rtol=0)
    for name, t, want in zip(("dq", "dk", "dv"), leaves, wants[1:]):
        np.testing.assert_allclose(t.grad.numpy(), want, atol=ATOL, rtol=0, err_msg=name)


def test_a_row_without_keys_is_the_mean_of_v():
    q, k, v, _, seg = inputs(1)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    s_t = torch.from_numpy(seg)
    out = chunked_attention(*t, q_segment_ids=s_t, kv_segment_ids=s_t, chunk_size=8)
    mean = t[2][1].mean(0)  # row 1's padding queries: every kv of the row, averaged
    for head in range(4):
        torch.testing.assert_close(out[1, 25, head], mean[head // 2], atol=1e-6, rtol=0)


def test_pick_chunk_is_jaxs():
    from leopard_tpu.models.decoder import _pick_chunk

    for s in (64, 96, 100, 512, 8320, 4096, 48):
        for target in (16, 512, 1024):
            assert pick_chunk(s, target) == _pick_chunk(s, target), (s, target)


def _cfgs(window=6, chunk=8):
    from leopard_tpu import config as cfgs
    from leopard_tpu_torch import config as tcfgs

    def text(mod, impl):
        t = mod.tiny_vlm().text
        return dataclasses.replace(t, attn_impl=impl, sliding_window=window,
                                   attn_chunk_size=chunk, long_seq_threshold=8)
    return text(cfgs, "chunked"), text(tcfgs, "chunked"), text(tcfgs, "flash")


@pytest.fixture(scope="module")
def decoder_pair():
    from leopard_tpu import config as cfgs
    from leopard_tpu.models import vlm as jvlm
    from leopard_tpu_torch import config as tcfgs
    from leopard_tpu_torch.convert.from_jax import state_dict_from_jax

    params = jax.device_get(jvlm.init_params(cfgs.tiny_vlm(), jax.random.PRNGKey(2)))
    sd = state_dict_from_jax(params, tcfgs.tiny_vlm())
    text = {k[5:]: v for k, v in sd.items() if k.startswith("text.")}
    rng = np.random.RandomState(9)
    tokens = rng.randint(1, 500, (2, 32)).astype(np.int32)
    seg = np.array([[1] * 14 + [2] * 18, [1] * 27 + [0] * 5], np.int32)
    positions = np.concatenate([np.r_[0:14, 0:18][None], np.r_[0:32][None]]).astype(np.int32)
    return params["text"], text, tokens, seg, positions


def _port_decoder(cfg, text):
    from leopard_tpu_torch.models.decoder import Decoder

    dec = Decoder(cfg)
    dec.load_state_dict(text)
    return dec


def test_decoder_chunked_tier_matches_jax(decoder_pair):
    from leopard_tpu.models import decoder as jdecoder

    jtext, text, tokens, seg, positions = decoder_pair
    jcfg, tcfg, _ = _cfgs()
    want = np.asarray(jdecoder.forward(jtext, jcfg, jnp.asarray(tokens),
                                       segment_ids=jnp.asarray(seg),
                                       positions=jnp.asarray(positions))[0])
    dec = _port_decoder(tcfg, text)
    assert dec._attn_impl(32, None, False) == "chunked"
    with torch.no_grad():
        got, _ = dec(torch.from_numpy(tokens), segment_ids=torch.from_numpy(seg),
                     positions=torch.from_numpy(positions))
    valid = seg != 0
    np.testing.assert_allclose(got.numpy()[valid], want[valid], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("remat", ["full", "attn"])
def test_decoder_chunked_gradients_equal_the_flash_tiers(decoder_pair, remat):
    """The same loss through the chunked tier and the flash tier (its plain
    versions on the CPU): every parameter's gradient within 1e-5 of the
    largest."""
    _, text, tokens, seg, positions = decoder_pair
    _, ccfg, fcfg = _cfgs()
    grads = []
    w = torch.from_numpy((seg != 0).astype(np.float32))
    for cfg in (ccfg, fcfg):
        dec = _port_decoder(cfg, text)
        hidden, _ = dec(torch.from_numpy(tokens), segment_ids=torch.from_numpy(seg),
                        positions=torch.from_numpy(positions), return_hidden=True, remat=remat)
        (hidden.square().mean(-1) * w).sum().backward()
        grads.append({k: p.grad.clone() for k, p in dec.named_parameters()
                      if p.grad is not None})  # lm_head takes none from the hidden states
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) > 10
    scale = max(g.abs().max().item() for g in grads[1].values())
    for k, g in grads[1].items():
        torch.testing.assert_close(grads[0][k], g, atol=1e-5 * scale, rtol=0, msg=k)


def test_chunk_recompute_keeps_scores_out_of_the_saved_tensors():
    """With remat the backward keeps the running state a chunk, never the
    chunk's [B, Hkv, G, Sq, chunk] scores; without it, it does."""
    q, k, v, _, seg = inputs(3, s=64)
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    scores_shape = (2, 2, 2, 64, 16)

    def saved(remat):
        shapes = []

        def pack(x):
            shapes.append(tuple(x.shape))
            return x

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            chunked_attention(*t, chunk_size=16, remat=remat)
        return shapes

    assert scores_shape not in saved(True)
    assert scores_shape in saved(False)
