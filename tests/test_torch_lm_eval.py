"""The port's lm-eval adaptor (leopard_tpu_torch/evaluation/lm_eval_adapter.py)
against the JAX package's `LeopardLM`, on the same weights (the JAX init
moved by `state_dict_from_jax`), float32 on the CPU, at tiny_vlm with a
1,024-token vocabulary (the character tokenizer's ids stay in range):

  - `loglikelihood`: summed logprobs to 1e-4 relative (fp32 logits on both
    sides, sums in another order), the greedy flags equal;
  - `loglikelihood_rolling`, over-length texts clamped to `max_len` as
    there;
  - `generate_until`: the same text;
  - contexts above `long_seq_threshold` (lowered to 32): the port's decoder
    takes its flash tier (the kernel's plain version on the CPU), shown by
    a spy, with the same scores.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from leopard_tpu import config as cfgs
from leopard_tpu.evaluation.lm_eval_adapter import LeopardLM as JaxLM
from leopard_tpu.models import vlm as jvlm
from leopard_tpu_torch import config as tcfgs
from leopard_tpu_torch.convert.from_jax import state_dict_from_jax
from leopard_tpu_torch.evaluation.lm_eval_adapter import LeopardLM
from leopard_tpu_torch.models import decoder as tdecoder
from leopard_tpu_torch.models import vlm as tvlm
from tests.test_chat import FakeTokenizer

torch.set_num_threads(2)
RTOL = 1e-4


class Tok(FakeTokenizer):
    eos_token_id = 10

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


class Request:
    """What lm-eval passes: an object whose `.args` holds the arguments."""

    def __init__(self, *args):
        self.args = args


def _cfg(mod, threshold=None):
    cfg = mod.tiny_vlm(vocab_size=1024)
    if threshold is not None:
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(
            cfg.text, long_seq_threshold=threshold))
    return cfg


@pytest.fixture(scope="module")
def params():
    return jax.device_get(jvlm.init_params(_cfg(cfgs), jax.random.PRNGKey(0)))


def _pair(params, threshold=None, max_len=4096):
    jcfg, tcfg = _cfg(cfgs, threshold), _cfg(tcfgs, threshold)
    model = tvlm.LeopardVLM(tcfg)
    model.load_state_dict(state_dict_from_jax(params, tcfg), strict=True)
    return (JaxLM(jcfg, params, Tok(), max_len=max_len),
            LeopardLM(tcfg, model, Tok(), max_len=max_len))


def _text(seed, n):
    rng = np.random.RandomState(seed)
    return "".join(chr(c) for c in rng.randint(97, 123, size=n))


REQUESTS = [("ab", "cd"), (_text(0, 9), _text(1, 3)), (_text(2, 20), " " + _text(3, 6)),
            ("", "x"), (_text(4, 5), "")]


def _assert_scores(got, want):
    assert len(got) == len(want)
    for (g, gflag), (w, wflag) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL)
        assert gflag == wflag


def test_loglikelihood_matches_jax(params):
    jlm, tlm = _pair(params)
    want = jlm.loglikelihood(REQUESTS)
    _assert_scores(tlm.loglikelihood(REQUESTS), want)
    _assert_scores(tlm.loglikelihood([Request(*r) for r in REQUESTS]), want)
    assert all(np.isfinite(s) and s <= 0 for s, _ in want)


def test_greedy_flag_is_true_for_the_argmax_continuation(params):
    """A continuation of the model's own greedy tokens gets the flag (and a
    random one, in the test above, does not)."""
    jlm, tlm = _pair(params)
    ctx = _text(5, 12)
    ids = Tok()(ctx)["input_ids"]
    cont = []
    for _ in range(3):
        lp = tlm._logprobs(np.asarray([ids + cont], np.int32),
                           np.ones((1, len(ids) + len(cont)), np.int32))
        cont.append(int(lp[-1].argmax()))
    got, want = tlm._score(ids, cont), jlm._score(ids, cont)
    assert got[1] and want[1]
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL)


def test_loglikelihood_rolling_matches_jax(params):
    jlm, tlm = _pair(params, max_len=16)
    texts = [(_text(6, 10),), (_text(7, 64),), _text(8, 3)]  # tuple or plain text
    got, want = tlm.loglikelihood_rolling(texts), jlm.loglikelihood_rolling(texts)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    kept = Tok()(texts[1][0])["input_ids"][-16:]
    np.testing.assert_allclose(got[1], tlm._score(kept[:1], kept[1:])[0], rtol=1e-6)


def test_generate_until_matches_jax(params):
    jlm, tlm = _pair(params)
    reqs = [(_text(9, 15), {"max_gen_toks": 5}), (_text(10, 7), {"until": ["q"],
                                                                  "max_gen_toks": 4})]
    got = tlm.generate_until(reqs)
    assert got == jlm.generate_until(reqs)
    assert len(got[0].split()) == 5


def test_long_context_takes_the_flash_tier(params, monkeypatch):
    jlm, tlm = _pair(params, threshold=32)
    calls = []
    real = tdecoder.flash_attention

    def spy(q, *args, **kw):
        calls.append(tuple(q.shape))
        return real(q, *args, **kw)

    monkeypatch.setattr(tdecoder, "flash_attention", spy)
    reqs = [(_text(11, 60), _text(12, 5)), (_text(13, 30), _text(14, 9)), ("ab", "cd")]
    _assert_scores(tlm.loglikelihood(reqs), jlm.loglikelihood(reqs))
    layers = _cfg(tcfgs).text.num_layers
    # padded to a multiple of 8: 65 → 72, 39 → 40; the short one stays dense
    assert calls == [(1, 72, 4, 16)] * layers + [(1, 40, 4, 16)] * layers
