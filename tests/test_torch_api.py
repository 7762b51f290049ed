"""The port's text-level API (`inference/api.py`) against the JAX package's:
`generate_and_post_process` and `Predictor.predict_file` on the same
prompts give identical texts and tokens, logprobs within 1e-4. The weights
are the JAX init moved by `state_dict_from_jax`, float32 on the CPU."""

import json

import jax
import numpy as np
import torch

from leopard_tpu.config import GenerateConfig as JaxGenerateConfig
from leopard_tpu.inference import api as japi
from leopard_tpu.inference.engine import Engine as JaxEngine
from leopard_tpu.models import vlm as jvlm
from leopard_tpu_torch.config import GenerateConfig
from leopard_tpu_torch.convert.from_jax import state_dict_from_jax
from leopard_tpu_torch.inference import api
from leopard_tpu_torch.inference.engine import Engine
from leopard_tpu_torch.models import vlm as tvlm
from tests.test_eval_e2e import DecodingFakeTokenizer, _tiny_cfg

torch.set_num_threads(2)
CFG = _tiny_cfg()
TOK = DecodingFakeTokenizer()
GEN = dict(max_new_tokens=5, greedy=True, eos_token_ids=(999999,))
PROMPTS = ["hello there", "a longer prompt about documents", "short", "charts and slides"]


def _engines():
    params = jax.device_get(jvlm.init_params(CFG, jax.random.PRNGKey(0)))
    model = tvlm.LeopardVLM(CFG)
    model.load_state_dict(state_dict_from_jax(params, CFG), strict=True)
    return JaxEngine(CFG, params, seq_buckets=(32,)), Engine(CFG, model, seq_buckets=(32,))


def test_torch_api_matches_jax(tmp_path):
    jeng, teng = _engines()
    got = api.generate_and_post_process(teng, TOK, PROMPTS[:3], GenerateConfig(**GEN))
    want = japi.generate_and_post_process(jeng, TOK, PROMPTS[:3], JaxGenerateConfig(**GEN))
    assert got.texts == want.texts
    assert [t.tolist() for t in got.tokens] == [t.tolist() for t in want.tokens]
    for g, w in zip(got.logprobs, want.logprobs):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    no_lp = api.generate_and_post_process(teng, TOK, PROMPTS[:1], GenerateConfig(**GEN),
                                          return_logprobs=False)
    assert no_lp.logprobs == [] and no_lp.texts == got.texts[:1]

    src = tmp_path / "in.jsonl"
    src.write_text("".join(json.dumps({"prompt": p}) + "\n" for p in PROMPTS) + "\n")
    outs = {}
    for name, mod, eng, cfg in (("port", api, teng, GenerateConfig(**GEN)),
                                ("jax", japi, jeng, JaxGenerateConfig(**GEN))):
        path = tmp_path / f"{name}.jsonl"
        mod.Predictor(eng, TOK, cfg).predict_file(str(src), str(path), batch_size=2)
        outs[name] = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(outs["port"]) == len(PROMPTS)
    for g, w in zip(outs["port"], outs["jax"]):
        assert g["prompt"] == w["prompt"] and g["output"] == w["output"]
        np.testing.assert_allclose(g["logprob"], w["logprob"], rtol=1e-4, atol=1e-4)
    # each line is generate_and_post_process on its batch of 2
    direct = [api.generate_and_post_process(teng, TOK, PROMPTS[i:i + 2], GenerateConfig(**GEN))
              for i in (0, 2)]
    assert [r["output"] for r in outs["port"]] == [t for d in direct for t in d.texts]
