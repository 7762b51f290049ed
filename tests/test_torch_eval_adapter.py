"""The port's eval adapters (leopard_tpu_torch/evaluation/adapter.py) and
batched loop against the JAX package's, on seeded noise PNGs, greedy, on
the CPU in float32:

  - LeopardLlavaEvalAdapter at tiny_vlm with the Llama-3 vocabulary (with a
    small vocab the eval prompt's special ids fall out of range and a parity
    check passes vacuously; tests/test_eval_e2e.py:38-46): prompts and
    pixels of `prepare` byte for byte, the responses of
    `run_benchmark_batched` (with the prefetch thread) token for token, and
    the scored details, `group_acc`, `merge_shard_files` and
    `merge_all_bench_results` exactly;
  - the port's batched loop equal to its serial one and to its eager
    (no prefetch) path; prefix caching equal to plain decoding; the prefix
    store bounded (LRU) with the tokens of the unbounded store;
  - LeopardIdefics2EvalAdapter at tests/test_torch_idefics2.py's tiny
    config: rows of wide and tall images in one batch, re-padded across
    samples, token for token against JAX and against the port's serial
    loop. The jitted JAX tower takes the eager position-id rule
    (`exact_position_ids`, see tests/test_torch_idefics2.py).

Weights are the JAX init moved by `state_dict_from_jax`.
"""

import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from leopard_tpu import config as cfgs
from leopard_tpu.data import idefics2_processor as jproc
from leopard_tpu.evaluation import adapter as jadapter
from leopard_tpu.evaluation import harness as jharness
from leopard_tpu.evaluation import metrics as jmetrics
from leopard_tpu.models import vlm as jvlm
from leopard_tpu_torch import config as tcfgs
from leopard_tpu_torch.convert.from_jax import state_dict_from_jax
from leopard_tpu_torch.data import idefics2_processor as tproc
from leopard_tpu_torch.evaluation import adapter as tadapter
from leopard_tpu_torch.evaluation import harness as tharness
from leopard_tpu_torch.evaluation import loaders as tloaders
from leopard_tpu_torch.evaluation import metrics as tmetrics
from leopard_tpu_torch.models import vlm as tvlm
from tests.test_eval_e2e import DecodingFakeTokenizer
from tests.test_torch_idefics2 import CharTokenizer, exact_position_ids, tiny_idefics2
from tests.test_torch_idefics2 import init_params as idefics2_params

torch.set_num_threads(2)
VOCAB = 128256
NO_EOS = (999999,)
TOK = DecodingFakeTokenizer()


def _reseed():
    jmetrics._rng.seed(42)
    tmetrics._rng.seed(42)


def _port_model(params, cfg):
    model = tvlm.LeopardVLM(cfg)
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def llava():
    jcfg, tcfg = cfgs.tiny_vlm(vocab_size=VOCAB), tcfgs.tiny_vlm(vocab_size=VOCAB)
    params = jax.device_get(jvlm.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, params, _port_model(params, tcfg)


def noise_png(path, rng, w, h):
    Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(path)
    return str(path)


def eval_rows(tmp_path, n=6, seed=0, lead=None):
    """Rows of 1-3 seeded noise PNGs of mixed sizes, open-ended and
    multiple-choice; `lead(i)` puts text before one image of a fixed size
    (a per-batch prompt header; rows keep their order in the sort)."""
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        k = 1 + (i % 3 if lead is None else 0)
        size = rng.randint(40, 200, 2) if lead is None else (64, 48)  # one tile bucket
        paths = [noise_png(tmp_path / f"r{seed}_{i}_{j}.png", rng, *size) for j in range(k)]
        mc = i % 2 == 1
        rows.append({
            "images_path": paths,
            "question": (lead(i) if lead else "") + "<image>" * k + f" what is shown in {i}?",
            "options": ["cat", "dog", "fish"] if mc else None,
            "concated_options": tmetrics.option_block(["cat", "dog", "fish"]) if mc else None,
            "answers": "B" if mc else ["noise"],
            "ques_type": "multiple-choice" if mc else "open-ended",
        })
    return rows


def _gen(mod, n=4):
    return mod.GenerateConfig(max_new_tokens=n, greedy=True, eos_token_ids=NO_EOS)


def test_llava_adapter_matches_jax(llava, tmp_path):
    jcfg, tcfg, params, model = llava
    rows = eval_rows(tmp_path)
    ja = jadapter.LeopardLlavaEvalAdapter(jcfg, params, TOK, gen_cfg=_gen(cfgs))
    ta = tadapter.LeopardLlavaEvalAdapter(tcfg, model, TOK, gen_cfg=_gen(tcfgs))
    for row in rows:
        instr = tharness.get_instruction("direct", row["ques_type"])
        jp, tp = ja.prepare(row, instr), ta.prepare(row, instr)
        np.testing.assert_array_equal(tp.prompt, jp.prompt)
        assert tp.pixels.dtype == np.uint8 and tp.pixels.tobytes() == jp.pixels.tobytes()
    _reseed()
    want = jharness.run_benchmark_batched(rows, ja, "docvqa", batch_size=2)
    stats = []
    got = tharness.run_benchmark_batched(rows, ta, "docvqa", batch_size=2, stats=stats)
    assert got == want and len({d["raw"] for d in got}) > 1
    assert sorted(i for s in stats for i in s["indices"]) == list(range(len(rows)))
    assert [len(s["indices"]) for s in stats] == [2, 2, 2]
    assert all(s["wait_s"] >= 0 for s in stats)
    assert sum(s["n_tiles"] for s in stats) == sum(
        ta.plan(r, "").n_tiles for r in rows)
    assert tharness.group_acc(got) == jharness.group_acc(want)
    # the shard files of both packages merge to the same reports and files
    out = {}
    for name, h, details in (("t", tharness, got), ("j", jharness, want)):
        d = tmp_path / f"merge_{name}"
        d.mkdir()
        tloaders.write_jsonl(str(d / "0_direct_docvqa_shard_details.jsonl"), details[:4])
        tloaders.write_jsonl(str(d / "1_direct_docvqa_shard_details.jsonl"), details[4:])
        out[name] = (h.merge_shard_files(str(d), "docvqa", "direct"),
                     h.merge_all_bench_results(str(d)),
                     {f: (d / f).read_text() for f in sorted(os.listdir(d))})
    assert out["t"] == out["j"]


def test_llava_host_preprocess_matches_jax(llava, tmp_path):
    """device_preprocess=False: fp32 pixels normalized on the host, in both
    packages; the same responses as the uint8 path."""
    jcfg, tcfg, params, model = llava
    rows = eval_rows(tmp_path, n=2, seed=3)
    ja = jadapter.LeopardLlavaEvalAdapter(jcfg, params, TOK, gen_cfg=_gen(cfgs),
                                          device_preprocess=False)
    ta = tadapter.LeopardLlavaEvalAdapter(tcfg, model, TOK, gen_cfg=_gen(tcfgs),
                                          device_preprocess=False)
    tu = tadapter.LeopardLlavaEvalAdapter(tcfg, model, TOK, gen_cfg=_gen(tcfgs))
    for row in rows:
        jp, tp = ja.prepare(row, ""), ta.prepare(row, "")
        assert tp.pixels.dtype == np.float32 and tp.pixels.tobytes() == jp.pixels.tobytes()
        assert ta(row, "") == ja(row, "") == tu(row, "")


def test_batched_equals_serial_and_eager(llava, tmp_path):
    _, tcfg, _, model = llava
    rows = eval_rows(tmp_path, n=5, seed=1)
    ta = tadapter.LeopardLlavaEvalAdapter(tcfg, model, TOK, gen_cfg=_gen(tcfgs))
    _reseed()
    serial = tharness.run_benchmark(rows, ta, "mpdocvqa")
    for prefetch in (True, False):
        _reseed()
        got = tharness.run_benchmark_batched(rows, ta, "mpdocvqa", batch_size=2,
                                             prefetch=prefetch)
        assert got == serial


def test_prefetch_error_reaches_the_caller(llava, tmp_path):
    _, tcfg, _, model = llava
    rows = eval_rows(tmp_path, n=4, seed=2)
    ta = tadapter.LeopardLlavaEvalAdapter(tcfg, model, TOK, gen_cfg=_gen(tcfgs, 1))
    real = ta.materialize
    seen = []

    def failing(plan):
        seen.append(plan)
        if len(seen) == 3:
            raise OSError("unreadable image")
        return real(plan)

    ta.materialize = failing
    with pytest.raises(OSError, match="unreadable image"):
        tharness.run_benchmark_batched(rows, ta, "docvqa", batch_size=2)


def _cached(tcfg, model, max_prefixes=tadapter.MAX_PREFIXES):
    ta = tadapter.LeopardLlavaEvalAdapter(tcfg, model, TOK, gen_cfg=_gen(tcfgs),
                                          prefix_caching=True)
    ta._prefixes = tadapter._PrefixStore(max_prefixes)
    ta.prefix_min_len = 2     # tiny prompts: engage on short common prefixes
    ta.prefix_quantum = 2
    return ta


def test_prefix_caching_matches_plain_and_jax(llava, tmp_path):
    jcfg, tcfg, params, model = llava
    rows = eval_rows(tmp_path, n=4, seed=4)
    plain = tadapter.LeopardLlavaEvalAdapter(tcfg, model, TOK, gen_cfg=_gen(tcfgs))
    _reseed()
    want = tharness.run_benchmark_batched(rows, plain, "docvqa", batch_size=2)
    cached = _cached(tcfg, model)
    _reseed()
    assert tharness.run_benchmark_batched(rows, cached, "docvqa", batch_size=2) == want
    assert cached._prefixes.built >= 1, "prefix caching never engaged"
    jcached = jadapter.LeopardLlavaEvalAdapter(jcfg, params, TOK, gen_cfg=_gen(cfgs),
                                               prefix_caching=True)
    jcached.prefix_min_len = jcached.prefix_quantum = 2
    _reseed()
    assert jharness.run_benchmark_batched(rows, jcached, "docvqa", batch_size=2) == want


def test_prefix_store_is_bounded(llava, tmp_path):
    """Three batches with three different headers: a store of one entry
    evicts two and builds them again on a second pass; its tokens are those
    of the unbounded store and of plain decoding."""
    _, tcfg, _, model = llava
    heads = ["First batch here. ", "Second one, look: ", "And a third: "]
    rows = eval_rows(tmp_path, n=6, seed=5, lead=lambda i: heads[i // 2])
    plain = tadapter.LeopardLlavaEvalAdapter(tcfg, model, TOK, gen_cfg=_gen(tcfgs))
    want = [d["raw"] for d in tharness.run_benchmark_batched(rows, plain, "docvqa",
                                                             batch_size=2)]
    wide, narrow = _cached(tcfg, model), _cached(tcfg, model, 1)
    for _ in range(2):
        for ta in (wide, narrow):
            got = tharness.run_benchmark_batched(rows, ta, "docvqa", batch_size=2)
            assert [d["raw"] for d in got] == want
    assert (len(wide._prefixes), wide._prefixes.built, wide._prefixes.evicted) == (3, 3, 0)
    assert (len(narrow._prefixes), narrow._prefixes.built, narrow._prefixes.evicted) == (1, 6, 5)


class _Idefics2Tok(CharTokenizer):
    def convert_tokens_to_ids(self, tok):
        return 450 if tok == "<end_of_utterance>" else None


@pytest.fixture(scope="module")
def idefics2():
    from leopard_tpu.models import siglip as jsiglip

    real = jsiglip.navit_position_ids
    jsiglip.navit_position_ids = exact_position_ids
    jcfg, tcfg = tiny_idefics2(cfgs), tiny_idefics2(tcfgs)
    params = idefics2_params(jcfg)
    yield jcfg, tcfg, params, _port_model(params, tcfg)
    jsiglip.navit_position_ids = real


def _idefics2_adapters(idefics2):
    jcfg, tcfg, params, model = idefics2
    tok = _Idefics2Tok()
    ja = jadapter.LeopardIdefics2EvalAdapter(jcfg, params, tok, gen_cfg=_gen(cfgs, 3))
    ta = tadapter.LeopardIdefics2EvalAdapter(tcfg, model, tok, gen_cfg=_gen(tcfgs, 3))
    ja._preprocess = functools.partial(jproc.preprocess_idefics2, shortest_edge=42,
                                       longest_edge=84)
    ta._preprocess = functools.partial(tproc.preprocess_idefics2, shortest_edge=42,
                                       longest_edge=84)
    return ja, ta


def test_idefics2_repads_across_samples_as_jax(idefics2, tmp_path):
    ja, ta = _idefics2_adapters(idefics2)
    rng = np.random.RandomState(6)
    rows = []
    for i, sizes in enumerate([[(90, 50)], [(50, 90), (60, 60)], [(84, 30)], [(30, 84)]]):
        paths = [noise_png(tmp_path / f"v{i}_{j}.png", rng, w, h) for j, (w, h) in
                 enumerate(sizes)]
        rows.append({"images_path": paths, "question": "<image>" * len(paths) + f" q{i}?",
                     "options": None, "answers": ["x"], "ques_type": "open-ended"})
    prepared = [ta.prepare(r, "") for r in rows]
    for r, tp in zip(rows, prepared):
        jp = ja.prepare(r, "")
        np.testing.assert_array_equal(tp.prompt, jp.prompt)
        assert tp.pixels.tobytes() == jp.pixels.tobytes()
        np.testing.assert_array_equal(tp.patch_mask, jp.patch_mask)
    # the batch's samples have different grids, padded to the largest
    pixels, mask = tadapter.repad_navit([(p.pixels, p.patch_mask) for p in prepared[:2]])
    (h0, w0), (h1, w1) = (p.pixels.shape[2:] for p in prepared[:2])
    assert h0 < h1 and w0 > w1  # a wide sample and a tall one
    assert pixels.shape == (3, 3, h1, w0) and mask.shape == (3, h1 // 14, w0 // 14)
    assert mask[0].sum() == prepared[0].patch_mask.sum() and not mask[0, h0 // 14:].any()
    assert (pixels[0, :, h0:] == 0).all() and (pixels[1:, :, :, w1:] == 0).all()
    _reseed()
    serial = tharness.run_benchmark(rows, ta, "slidevqa")
    _reseed()
    got = tharness.run_benchmark_batched(rows, ta, "slidevqa", batch_size=2)
    _reseed()
    want = jharness.run_benchmark_batched(rows, ja, "slidevqa", batch_size=2)
    assert got == want == serial
    assert all(len(d["raw"].split()) == 3 for d in got)


def test_idefics2_default_eos(idefics2):
    _, tcfg, _, model = idefics2
    ta = tadapter.LeopardIdefics2EvalAdapter(tcfg, model, _Idefics2Tok())
    assert ta.gen_cfg.eos_token_ids == (2, 450) and ta.gen_cfg.max_new_tokens == 128
    assert dataclasses.replace(ta.gen_cfg, max_new_tokens=4).greedy
