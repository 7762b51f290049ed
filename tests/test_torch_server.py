"""The port's `GenerationServer` against the JAX package's on the same
payloads: text, base64 PNG images through the port's anyres tiling and chat
rendering, per-prompt budgets, a cached system-prompt prefix, chat turns,
session LRU and continuous mode (mirrors tests/test_server.py, its nine
cases). Added: a chat turn whose generate raises leaves its session as it
was, and one HTTP round trip on 127.0.0.1. Greedy tokens must be identical
to the JAX server's, logprobs within 1e-4; the weights are the JAX init
moved by `state_dict_from_jax`, float32 on the CPU.
"""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from leopard_tpu.inference.continuous import ContinuousEngine as JaxContinuousEngine
from leopard_tpu.inference.engine import Engine as JaxEngine
from leopard_tpu.inference.server import GenerationServer as JaxGenerationServer
from leopard_tpu.models import vlm as jvlm
from leopard_tpu_torch.config import GenerateConfig
from leopard_tpu_torch.convert.from_jax import state_dict_from_jax
from leopard_tpu_torch.inference.continuous import ContinuousEngine
from leopard_tpu_torch.inference.engine import Engine
from leopard_tpu_torch.inference.server import GenerationServer
from leopard_tpu_torch.models import vlm as tvlm
from tests.test_eval_e2e import DecodingFakeTokenizer, _tiny_cfg

torch.set_num_threads(2)
CFG = _tiny_cfg()  # the llama-3 vocab: prompt specials must be in range
TOK = DecodingFakeTokenizer()
BASE = {"greedy": True, "eos_token_ids": [999999]}
CONT = dict(slots=2, cache_len=512, max_new_cap=8, segment_steps=2)


def _b64_png(w=90, h=70, color=(10, 20, 30)) -> str:
    buf = io.BytesIO()
    Image.new("RGB", (w, h), color).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _noise_png(w, h, seed) -> str:
    px = np.random.RandomState(seed).randint(0, 256, (h, w, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


@pytest.fixture(scope="module")
def engines():
    params = jax.device_get(jvlm.init_params(CFG, jax.random.PRNGKey(0)))
    model = tvlm.LeopardVLM(CFG)
    model.load_state_dict(state_dict_from_jax(params, CFG), strict=True)
    return JaxEngine(CFG, params), Engine(CFG, model)


def _servers(engines, continuous=False, prefix_text=None, **kw):
    jeng, teng = engines
    jkw, tkw = dict(kw), dict(kw)
    if continuous:
        jkw["continuous"] = JaxContinuousEngine(jeng, **CONT)
        tkw["continuous"] = ContinuousEngine(teng, **CONT)
    if prefix_text is not None:
        ids = _ids(prefix_text)
        jkw["prefix"], tkw["prefix"] = jeng.build_prefix(ids), teng.build_prefix(ids)
    return JaxGenerationServer(jeng, TOK, **jkw), GenerationServer(teng, TOK, **tkw)


def _ids(text):
    return np.asarray(TOK(text, add_special_tokens=True)["input_ids"], np.int32)


def _same(got, want):
    assert got["tokens"] == want["tokens"]
    assert got["text"] == want["text"]
    assert len(got["logprobs"]) == len(want["logprobs"])
    for g, w in zip(got["logprobs"], want["logprobs"]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_torch_text_only_matches_engine(engines):
    jsrv, tsrv = _servers(engines)
    payload = {"prompts": ["hello there", "shorter"], "max_new_tokens": 4, **BASE}
    out = tsrv.handle_generate(payload)
    _same(out, jsrv.handle_generate(payload))
    ref = engines[1].generate([_ids(p) for p in payload["prompts"]],
                              gen_cfg=GenerateConfig(max_new_tokens=4, eos_token_ids=(999999,)))
    assert out["tokens"] == [t.tolist() for t in ref.tokens]
    assert len(out["logprobs"][0]) == len(out["tokens"][0])


def test_torch_multimodal_request_matches_jax(engines):
    jsrv, tsrv = _servers(engines)
    payload = {
        "prompts": ["look at <image> and <image>?", "text only row"],
        "images": [[_b64_png(), _noise_png(120, 60, 1)], []],
        "max_new_tokens": 3,
        **BASE,
    }
    out1 = tsrv.handle_generate(payload)
    assert out1 == tsrv.handle_generate(payload)
    assert all(len(t) == 3 for t in out1["tokens"])
    _same(out1, jsrv.handle_generate(payload))
    # the rows themselves: ids and uint8 tiles byte for byte
    from leopard_tpu.inference.server import _decode_images

    pil = _decode_images(payload["images"][0])
    ids, px, mask = tsrv._prepare_row(payload["prompts"][0], pil)
    jids, jpx, jmask = jsrv._prepare_row(payload["prompts"][0], pil)
    np.testing.assert_array_equal(ids, jids)
    assert px.dtype == jpx.dtype == np.uint8 and mask is None and jmask is None
    np.testing.assert_array_equal(px, jpx)


def test_torch_per_prompt_budget_list_trims_rows(engines):
    jsrv, tsrv = _servers(engines)
    payload = {"prompts": ["aaa", "bbb"], "max_new_tokens": [2, 5], **BASE}
    out = tsrv.handle_generate(payload)
    _same(out, jsrv.handle_generate(payload))
    assert [len(t) for t in out["tokens"]] == [2, 5]
    assert [len(l) for l in out["logprobs"]] == [2, 5]


def test_torch_budget_list_length_mismatch_rejected(engines):
    _, tsrv = _servers(engines)
    with pytest.raises(ValueError, match="one entry per prompt"):
        tsrv.handle_generate({"prompts": ["aaa", "bbb"], "max_new_tokens": [2], **BASE})


def test_torch_continuous_rejects_repetition_penalty_payload(engines):
    _, tsrv = _servers(engines, continuous=True)
    with pytest.raises(ValueError, match="repetition_penalty"):
        tsrv.handle_generate({"prompts": ["aaa"], "max_new_tokens": 2,
                              "repetition_penalty": 1.3, **BASE})


def test_torch_server_prefix_matches_inline_system_prompt(engines):
    # a server holding a cached system prompt answers as if the prompt were
    # put before every request, in both modes
    sysprompt = "you are a helpful assistant"
    payload = {"prompts": ["hello there", "tell me more"], "max_new_tokens": 4, **BASE}
    want = engines[1].generate(
        [np.concatenate([_ids(sysprompt), _ids(p)]) for p in payload["prompts"]],
        gen_cfg=GenerateConfig(max_new_tokens=4, eos_token_ids=(999999,)))
    for continuous in (False, True):
        jsrv, tsrv = _servers(engines, continuous=continuous, prefix_text=sysprompt)
        got = tsrv.handle_generate(payload)
        assert got["tokens"] == [t.tolist() for t in want.tokens]
        _same(got, jsrv.handle_generate(payload))


def _chat_turns(jsrv, tsrv, prompts, sid="s1"):
    chat = {"session_id": sid, "max_new_tokens": 4, **BASE}
    out = []
    for p in prompts:
        got = tsrv.handle_chat({**chat, "prompt": p})
        assert got == jsrv.handle_chat({**chat, "prompt": p})
        out.append(got)
    return out


def test_torch_chat_session_matches_concatenated_conversation(engines):
    jsrv, tsrv = _servers(engines)
    gen = GenerateConfig(max_new_tokens=4, eos_token_ids=(999999,))
    r1, = _chat_turns(jsrv, tsrv, ["hello there"])
    for prompt in ("and then what", "ok"):
        history = tsrv._sessions["s1"].tokens
        r, = _chat_turns(jsrv, tsrv, [prompt])
        want = engines[1].generate([np.concatenate([history, _ids(prompt)])], gen_cfg=gen)
        assert r["tokens"] == want.tokens[0].tolist()
        assert r["context_tokens"] == len(tsrv._sessions["s1"].tokens)
    assert tsrv.handle_chat({"session_id": "s1", "reset": True}) == {"status": "reset"}
    assert "s1" not in tsrv._sessions
    jsrv.handle_chat({"session_id": "s1", "reset": True})
    r1b, = _chat_turns(jsrv, tsrv, ["hello there"])
    assert r1b == r1


def test_torch_chat_sessions_evict_lru(engines):
    _, tsrv = _servers(engines)
    tsrv.max_sessions = 2
    base = {"max_new_tokens": 2, "prompt": "hi", **BASE}
    for sid in ("a", "b", "a", "c"):   # "a" refreshed, so "c" evicts "b"
        tsrv.handle_chat({**base, "session_id": sid})
    assert list(tsrv._sessions) == ["a", "c"]


def test_torch_continuous_mode_matches_plain_greedy(engines):
    jsrv, tsrv = _servers(engines, continuous=True)
    payload = {"prompts": ["the quick brown", "fox jumps", "over lazy"],
               "max_new_tokens": [4, 6, 3], **BASE}
    out_c = tsrv.handle_generate(payload)
    assert out_c == jsrv.handle_generate(payload)
    assert out_c["tokens"] == _servers(engines)[1].handle_generate(payload)["tokens"]


def test_torch_chat_turn_that_raises_keeps_the_session(engines, monkeypatch):
    jsrv, tsrv = _servers(engines)
    _chat_turns(jsrv, tsrv, ["hello there"])
    session = tsrv._sessions["s1"]
    kept = (session.length, session.tokens.copy(), session.cache.kv.clone())

    def fail(*a, **kw):
        raise RuntimeError("device lost")

    monkeypatch.setattr(tsrv.engine, "generate", fail)
    with pytest.raises(RuntimeError, match="device lost"):
        tsrv.handle_chat({"session_id": "s1", "prompt": "and then what",
                          "max_new_tokens": 4, **BASE})
    monkeypatch.undo()
    assert tsrv._sessions["s1"] is session
    assert session.length == kept[0] and np.array_equal(session.tokens, kept[1])
    assert torch.equal(session.cache.kv, kept[2])
    # the conversation goes on as if the failed turn never happened
    _chat_turns(jsrv, tsrv, ["and then what"])


def test_torch_http_round_trip(engines):
    _, tsrv = _servers(engines)
    tsrv.host, tsrv.port = "127.0.0.1", 0
    httpd = tsrv.http_server()
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def call(path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        with urllib.request.urlopen(urllib.request.Request(url + path, data=data),
                                    timeout=60) as r:
            return r.status, json.loads(r.read())

    try:
        assert call("/health") == (200, {"status": "ok"})
        payload = {"prompts": ["hello there"], "max_new_tokens": 3, **BASE}
        status, out = call("/api/generate", payload)
        assert status == 200
        assert out == json.loads(json.dumps(_servers(engines)[1].handle_generate(payload)))
        chat = {"session_id": "h", "prompt": "hi", "max_new_tokens": 2, **BASE}
        status, out = call("/api/chat", chat)
        assert status == 200 and out["context_tokens"] == tsrv._sessions["h"].length
        with pytest.raises(urllib.error.HTTPError) as err:
            call("/api/generate", {"prompts": ["a", "b"], "max_new_tokens": [1]})
        assert err.value.code == 500
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
