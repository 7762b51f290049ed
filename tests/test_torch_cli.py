"""The port's entry points (leopard_tpu_torch/cli/*) driven end to end on the
CPU (`--device cpu`) at tiny_vlm widths with the Llama-3 vocabulary, from an
HF checkpoint written by the JAX package's own export:

  - generate: the tokens of `Engine.generate` and of beam search in the JAX
    package on the same checkpoint and the same processor output;
  - train_leopard_idefics2: two --tiny steps from a manifest of PNGs, step
    1's loss against a direct train step on the batch builder's first
    batch; a resumed run takes the unbroken run's third batch and loss;
  - train_leopard_llava: two steps from a manifest; step 1's loss against
    the JAX `make_train_step` on the loader's first batch (rtol 1e-5, as
    tests/test_torch_train_step.py); a run resumed from a saved checkpoint
    takes the uninterrupted run's next batch and loss; `main` through a
    `tokenizer.json` written here, as a user would run it;
  - convert_checkpoint, both directions, for leopard_llava, llama,
    leopard_idefics2 and mistral: the port's file holds the JAX export's
    tensors (for Idefics2 with the head at HF's `lm_head.weight`);
  - serve: /health and one /api/generate over HTTP; with --arch
    leopard_idefics2, one request of two PNGs against `Engine.generate` on
    the server's own `_prepare_row` output;
  - run_eval: two shards and a merge over an MP-DocVQA folder in its raw
    layout and two prepared `eval_<name>.jsonl` sets, each shard file equal
    to the harness called directly on the same model, the merged
    `all_bench_results.json` equal to a one-shard run's; --prefix-caching
    and --spec give the plain run's responses; --arch leopard_idefics2
    --quantize int4 is refused before anything is read, by run_eval and
    by serve;
  - without a GPU, each CLI refuses to run unless given --device cpu.
"""

import io
import json
import os
import threading
import urllib.request
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from leopard_tpu import config as cfgs
from leopard_tpu.convert import hf as jhf
from leopard_tpu.data import dataset as jds
from leopard_tpu.data.processor import LeopardProcessor as JProcessor
from leopard_tpu.inference import beam as jbeam
from leopard_tpu.inference.engine import Engine as JEngine
from leopard_tpu.models import vlm as jvlm
from leopard_tpu.training import trainer as jtrainer
from leopard_tpu_torch import config as tcfgs
from leopard_tpu_torch.cli import (
    convert_checkpoint,
    generate,
    run_eval,
    serve,
    train_leopard_idefics2,
    train_leopard_llava,
)
from leopard_tpu_torch.convert import hf as thf
from leopard_tpu_torch.data import dataset as tds
from leopard_tpu_torch.data import idefics2_batches as tib
from tests.test_chat import FakeTokenizer
from tests.test_torch_idefics2 import CharTokenizer
from tests.test_torch_idefics2 import init_params as idefics2_params
from tests.test_torch_idefics2 import tiny_idefics2
from tests.test_torch_idefics2_train import EouTokenizer, write_rows

torch.set_num_threads(2)
VOCAB = 128256
SETS = ["--set", f"text.vocab_size={VOCAB}", "--set", f"image_token_id={VOCAB - 1}"]


class Tok(FakeTokenizer):
    eos_token_id = 128009

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


TOK = Tok()


def cfg_pair():
    return cfgs.tiny_vlm(vocab_size=VOCAB), tcfgs.tiny_vlm(vocab_size=VOCAB)


def noise_png(path, rng, w, h):
    Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(path)
    return str(path)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """An HF checkpoint of seeded JAX params (the JAX export, fp32, one
    safetensors file), two PNGs and a manifest of 6 samples of 1-2 images."""
    from safetensors.numpy import save_file

    root = tmp_path_factory.mktemp("cli")
    jcfg, _ = cfg_pair()
    params = jax.device_get(jvlm.init_params(jcfg, jax.random.PRNGKey(0)))
    sd = jhf.export_leopard_llava(params, jcfg)
    (root / "hf").mkdir()
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()},
              str(root / "hf" / "model.safetensors"))
    rng = np.random.RandomState(0)
    pngs = [noise_png(root / "a.png", rng, 150, 60), noise_png(root / "b.png", rng, 40, 130)]
    (root / "imgs").mkdir()
    rows = []
    for i in range(6):
        names = []
        for j in range(1 + i % 2):
            w, h = rng.randint(30, 160, size=2)
            names.append(os.path.basename(noise_png(root / "imgs" / f"{i}_{j}.png", rng, w, h)))
        rows.append({"conversations": [
            {"from": "human", "value": "<image> " * len(names) + f"what is shown in {i}?"},
            {"from": "gpt", "value": f"a picture number {i}, mostly noise"}], "images": names})
    (root / "data.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    return {"root": root, "hf": str(root / "hf"), "pngs": pngs, "params": params, "sd": sd,
            "manifest": str(root / "data.jsonl"), "images": str(root / "imgs")}


QUESTION = "<image> and <image>: which one is wider?"


def test_generate_matches_jax(workdir):
    jcfg, tcfg = cfg_pair()
    argv = ["--checkpoint", workdir["hf"], "--question", QUESTION, "--images", *workdir["pngs"],
            "--max-new-tokens", "6", "--device", "cpu"]
    with redirect_stdout(io.StringIO()) as out:
        got = generate.generate(generate.parse_args(argv), tokenizer=TOK, cfg=tcfg)
        got_beam = generate.generate(generate.parse_args(argv + ["--beam", "2"]),
                                     tokenizer=TOK, cfg=tcfg)
    assert out.getvalue().splitlines()[0] == TOK.decode(got.tolist())

    images = [Image.open(p).convert("RGB") for p in workdir["pngs"]]
    prompt, pixels = JProcessor(jcfg, TOK, layout="eval").process_eval(QUESTION, images)
    gen_cfg = cfgs.GenerateConfig(max_new_tokens=6, greedy=True, eos_token_ids=(128001, 128009))
    engine = JEngine(jcfg, jhf.convert_leopard_llava(jhf.load_hf_state_dict(workdir["hf"]), jcfg),
                     gen_cfg)
    want = engine.generate([prompt], images=pixels, gen_cfg=gen_cfg).tokens[0]
    np.testing.assert_array_equal(got, want)
    want_beam = jbeam.beam_search(engine, prompt, images=pixels, beam_width=2, max_new_tokens=6)
    np.testing.assert_array_equal(got_beam, want_beam)


def train_argv(workdir, ckpt_dir, steps, tokenizer="unused"):
    return ["--manifest", workdir["manifest"], "--image-folder", workdir["images"],
            "--tokenizer", tokenizer, "--init-from", workdir["hf"], "--checkpoint-dir",
            str(ckpt_dir), "--seq-len", "256", "--global-batch-size", "2", "--train-steps",
            str(steps), "--lr", "1e-3", "--device", "cpu", "--tiny", *SETS]


def metrics(ckpt_dir):
    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def run_train(workdir, ckpt_dir, steps, monkeypatch, **overrides):
    """train_main with the test tokenizer; returns (state, the batches it
    collated)."""
    seen = []
    real = tds.collate

    def record(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(tds, "collate", record)
    with redirect_stdout(io.StringIO()):
        state = train_leopard_llava.train_main(
            train_leopard_llava.parse_args(train_argv(workdir, ckpt_dir, steps)), tokenizer=TOK,
            **overrides)
    monkeypatch.setattr(tds, "collate", real)
    return state, seen


def test_train_two_steps_match_jax(workdir, tmp_path, monkeypatch):
    state, batches = run_train(workdir, tmp_path / "run", 2, monkeypatch)
    assert state.step == 2 and len(batches) == 2
    rows = metrics(tmp_path / "run")
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["tokens_in_loss"] > 0 for r in rows)

    jcfg, _ = cfg_pair()
    loader = jds.TrainDataLoader(jds.JsonlSftDataset(workdir["manifest"], workdir["images"]),
                                 JProcessor(jcfg, TOK), batch_size=2, seq_len=256,
                                 state=jds.DataState(seed=1234))
    first = next(iter(loader))
    for k, v in first.as_dict().items():
        np.testing.assert_array_equal(batches[0].as_dict()[k], v, err_msg=k)
    jtc = cfgs.TrainConfig(seq_len=256, global_batch_size=2, train_steps=2,
                           optimizer=cfgs.OptimizerConfig(lr=1e-3, decay_steps=2))
    params = jhf.convert_leopard_llava(jhf.load_hf_state_dict(workdir["hf"]), jcfg)
    jstate = jtrainer.create_train_state(params, jtc)
    _, jmetrics = jax.jit(jtrainer.make_train_step(jcfg, jtc))(
        jstate, {k: jnp.asarray(v) for k, v in first.as_dict().items()})
    np.testing.assert_allclose(rows[0]["loss"], float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(rows[0]["tokens_in_loss"], float(jmetrics["tokens_in_loss"]))


def test_train_resume_takes_the_next_batch(workdir, tmp_path, monkeypatch):
    """Two steps saving after each, then a run to step 3 from that directory,
    against three uninterrupted steps: the resumed run restores step, params,
    optimizer and data position, so its one batch and its loss are the
    uninterrupted run's third."""
    run_train(workdir, tmp_path / "a", 2, monkeypatch, save_interval=1)
    saved = json.loads((tmp_path / "a" / "2" / "data_state.json").read_text())
    assert saved["epoch"] == 0 and saved["cursor"] > 0
    state, resumed = run_train(workdir, tmp_path / "a", 3, monkeypatch)
    assert state.step == 3 and len(resumed) == 1
    _, whole = run_train(workdir, tmp_path / "b", 3, monkeypatch)
    for k, v in whole[2].as_dict().items():
        np.testing.assert_array_equal(resumed[0].as_dict()[k], v, err_msg=k)
    np.testing.assert_allclose(metrics(tmp_path / "a")[-1]["loss"],
                               metrics(tmp_path / "b")[-1]["loss"], rtol=1e-6)


def write_tokenizer(directory):
    """A character-level tokenizer.json with the Llama-3 special tokens at
    their ids, written without the network."""
    specials = {"<|begin_of_text|>": 128000, "<|end_of_text|>": 128001,
                "<|start_header_id|>": 128006, "<|end_header_id|>": 128007, "<|eot_id|>": 128009}
    specials.update({f"<|reserved_special_token_{k}|>": 128010 + k - 5 for k in range(5, 251)})
    vocab = {chr(i): i for i in range(32, 127)}
    vocab.update({"\n": 10, **specials})
    doc = {"version": "1.0", "truncation": None, "padding": None, "normalizer": None,
           "added_tokens": [{"id": i, "content": s, "single_word": False, "lstrip": False,
                             "rstrip": False, "normalized": False, "special": True}
                            for s, i in specials.items()],
           "pre_tokenizer": {"type": "Split", "pattern": {"Regex": "[\\s\\S]"},
                             "behavior": "Isolated", "invert": False},
           "post_processor": None, "decoder": None,
           "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"}}
    directory.mkdir()
    (directory / "tokenizer.json").write_text(json.dumps(doc))
    (directory / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<|begin_of_text|>",
        "eos_token": "<|eot_id|>"}))
    return str(directory)


def test_train_main_with_tokenizer_file(workdir, tmp_path):
    tok_dir = write_tokenizer(tmp_path / "tok")
    with redirect_stdout(io.StringIO()) as out:
        train_leopard_llava.main(train_argv(workdir, tmp_path / "run", 1, tokenizer=tok_dir))
    assert "done at step 1" in out.getvalue()
    (row,) = metrics(tmp_path / "run")
    assert np.isfinite(row["loss"]) and row["tokens_in_loss"] > 0


@pytest.mark.parametrize("arch", ["leopard_llava", "llama"])
def test_convert_both_directions(workdir, tmp_path, arch):
    from safetensors import safe_open
    from safetensors.numpy import save_file

    jcfg, tcfg = cfg_pair()
    src = workdir["hf"]
    want = workdir["sd"]
    if arch == "llama":
        want = jhf.export_decoder(workdir["params"]["text"], jcfg.text, "model.")
        src = str(tmp_path / "llama")
        os.makedirs(src)
        save_file({k: np.ascontiguousarray(v) for k, v in want.items()},
                  os.path.join(src, "model.safetensors"))
    native, out = str(tmp_path / "native"), str(tmp_path / "out")
    with redirect_stdout(io.StringIO()):
        convert_checkpoint.convert(convert_checkpoint.parse_args(
            ["--direction", "hf2native", "--arch", arch, "--input", src, "--output", native,
             "--device", "cpu"]), cfg=tcfg)
        convert_checkpoint.convert(convert_checkpoint.parse_args(
            ["--direction", "native2hf", "--arch", arch, "--input", native, "--output", out,
             "--device", "cpu"]), cfg=tcfg)
    assert json.loads((tmp_path / "native" / "0" / "config.json").read_text()) == {"arch": arch}
    # a decoder alone gets its HF config.json (the whole VLM's is not written)
    hf_config = os.path.join(out, "config.json")
    assert os.path.exists(hf_config) == (arch == "llama")
    if arch == "llama":
        assert json.loads(open(hf_config).read()) == thf.hf_decoder_config(tcfg.text)
    with safe_open(os.path.join(out, "model.safetensors"), framework="np") as f:
        assert set(f.keys()) == set(want)
        for k, v in want.items():
            got = f.get_tensor(k)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, v, err_msg=k)


def test_serve_answers_over_http(workdir):
    _, tcfg = cfg_pair()
    args = serve.parse_args(["--checkpoint", workdir["hf"], "--host", "127.0.0.1", "--port", "0",
                             "--device", "cpu"])
    server = serve.build_server(args, tokenizer=TOK, cfg=tcfg)
    httpd = server.http_server()
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            assert (r.status, json.loads(r.read())) == (200, {"status": "ok"})
        payload = {"prompts": ["hello there"], "max_new_tokens": 4, "greedy": True,
                   "eos_token_ids": [999999]}
        req = urllib.request.Request(url + "/api/generate", data=json.dumps(payload).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            status, out = r.status, json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    ids = np.asarray(TOK("hello there", add_special_tokens=True)["input_ids"], np.int32)
    want = server.engine.generate([ids], gen_cfg=tcfgs.GenerateConfig(
        max_new_tokens=4, eos_token_ids=(999999,))).tokens[0]
    assert status == 200 and out["tokens"] == [want.tolist()]


def test_serve_flags_exclusive():
    base = ["--checkpoint", "unused"]
    for extra in (["--spec", "3", "--continuous"], ["--spec", "3", "--system-prompt", "hi"]):
        with pytest.raises(SystemExit), redirect_stdout(io.StringIO()):
            serve.parse_args(base + extra)


@pytest.fixture(scope="module")
def idefics2_dir(tmp_path_factory):
    """An Idefics2 HF checkpoint (fp32, one safetensors file) of seeded JAX
    params of the tiny Idefics2 VLM, from the JAX export with its head at
    HF's key, and the JAX params and export."""
    from safetensors.numpy import save_file

    root = tmp_path_factory.mktemp("idefics2")
    jcfg = tiny_idefics2(cfgs)
    params = idefics2_params(jcfg)
    sd = jhf.export_leopard_idefics2(params, jcfg)
    sd["lm_head.weight"] = sd.pop("model.text_lm_head.weight")
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()},
              str(root / "model.safetensors"))
    return {"hf": str(root), "params": params, "sd": sd}


def idefics2_train_argv(idefics2_dir, manifest, ckpt_dir, steps):
    return ["--manifest", str(manifest), "--image-folder", str(manifest.parent),
            "--tokenizer", "unused", "--init-from", idefics2_dir["hf"], "--checkpoint-dir",
            str(ckpt_dir), "--seq-len", "96", "--global-batch-size", "2", "--train-steps",
            str(steps), "--lr", "1e-3", "--device", "cpu", "--tiny"]


@pytest.fixture(scope="module")
def idefics2_manifest(tmp_path_factory):
    """5 rows of 1-2 seeded PNGs (27 × 27 and 27 × 36 patches once resized)
    and a two-turn Idefics2 chat."""
    root = tmp_path_factory.mktemp("idefics2_manifest")
    rows = write_rows(root, [(((40, 30), (30, 30)), 5, 12), (((60, 60),), 0, 20),
                             (((30, 30),), 3, 9), (((25, 25), (35, 35)), 2, 15),
                             (((35, 35),), 7, 11)], seed=3)
    (root / "data.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    return root / "data.jsonl"


def run_idefics2_train(idefics2_dir, manifest, ckpt_dir, steps, monkeypatch, **overrides):
    """train_leopard_idefics2's train_main with the test tokenizer; returns
    (state, the batches it built)."""
    seen = []
    real = tib.idefics2_batch

    def record(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(tib, "idefics2_batch", record)
    with redirect_stdout(io.StringIO()) as out:
        state = train_leopard_idefics2.train_main(train_leopard_idefics2.parse_args(
            idefics2_train_argv(idefics2_dir, manifest, ckpt_dir, steps)),
            tokenizer=EouTokenizer(), **overrides)
    monkeypatch.setattr(tib, "idefics2_batch", real)
    return state, seen, out.getvalue()


def test_train_idefics2_first_loss_equals_a_direct_step(idefics2_dir, idefics2_manifest,
                                                        tmp_path, monkeypatch):
    """`train_leopard_idefics2 --tiny --device cpu` from a manifest of PNGs,
    2 steps: its first loss equals a train step of the port on the same
    first batch and the checkpoint's weights."""
    from leopard_tpu_torch.convert.hf import load_leopard_idefics2
    from leopard_tpu_torch.training import trainer

    state, batches, _ = run_idefics2_train(idefics2_dir, idefics2_manifest, tmp_path / "run", 2,
                                           monkeypatch)
    rows = metrics(tmp_path / "run")
    assert state.step == 2 and [r["step"] for r in rows] == [1, 2] and len(batches) == 2
    assert all(np.isfinite(r["loss"]) and r["tokens_in_loss"] > 0 for r in rows)
    assert [b["patch_mask"].shape[0] for b in batches] == [3, 3]
    cfg = tcfgs.tiny_idefics2()
    tc = tcfgs.TrainConfig(seq_len=96, global_batch_size=2, train_steps=2,
                           optimizer=tcfgs.OptimizerConfig(lr=1e-3, decay_steps=2))
    model = load_leopard_idefics2(idefics2_dir["hf"], cfg, "cpu")
    _, want = trainer.make_train_step(cfg, tc)(
        trainer.create_train_state(model, tc),
        {k: torch.from_numpy(v) for k, v in batches[0].items()})
    np.testing.assert_allclose(rows[0]["loss"], float(want["loss"]), rtol=1e-6)
    np.testing.assert_allclose(rows[0]["tokens_in_loss"], float(want["tokens_in_loss"]))


def test_train_idefics2_resumes_at_the_next_rows(idefics2_dir, idefics2_manifest, tmp_path,
                                                 monkeypatch):
    """Two steps saving after each, then a run to step 3 from that directory,
    against three unbroken steps: the resumed run restores params and
    optimizer and starts its batches at row 2 × 2, so its one batch and its
    loss are the unbroken run's third."""
    run_idefics2_train(idefics2_dir, idefics2_manifest, tmp_path / "a", 2, monkeypatch,
                       save_interval=1)
    state, resumed, out = run_idefics2_train(idefics2_dir, idefics2_manifest, tmp_path / "a", 3,
                                             monkeypatch)
    assert "resumed from step 2" in out and state.step == 3 and len(resumed) == 1
    _, whole, _ = run_idefics2_train(idefics2_dir, idefics2_manifest, tmp_path / "b", 3,
                                     monkeypatch)
    for k, v in whole[2].items():
        np.testing.assert_array_equal(resumed[0][k], v, err_msg=k)
    np.testing.assert_allclose(metrics(tmp_path / "a")[-1]["loss"],
                               metrics(tmp_path / "b")[-1]["loss"], rtol=1e-6)


def test_serve_refuses_idefics2_int4(idefics2_dir):
    """The combination is accepted now (the test keeps its name): `serve
    --arch leopard_idefics2 --quantize int4` builds a server whose head is
    held padded to 32,128 columns (models/params.py::QuantizedWeight), and
    its engine answers a text request inside the 32,003-token vocab."""
    tcfg = tiny_idefics2(tcfgs)
    args = serve.parse_args(["--checkpoint", idefics2_dir["hf"], "--arch", "leopard_idefics2",
                             "--quantize", "int4", "--device", "cpu"])
    assert args.quantize == "int4"
    server = serve.build_server(args, tokenizer=CharTokenizer(), cfg=tcfg)
    head = server.engine.model.text.lm_head
    assert head.int4 and head.q4.shape[-1] == 32128 and head.n == tcfg.text.vocab_size
    res = server.engine.generate([np.arange(1, 40, dtype=np.int32)],
                                 gen_cfg=tcfgs.GenerateConfig(max_new_tokens=4,
                                                              eos_token_ids=(999999,)))
    assert len(res.tokens[0]) == 4
    assert np.all((res.tokens[0] >= 0) & (res.tokens[0] < tcfg.text.vocab_size))


@pytest.mark.parametrize("arch", ["leopard_idefics2", "mistral"])
def test_convert_idefics2_both_directions(idefics2_dir, tmp_path, arch):
    from safetensors import safe_open
    from safetensors.numpy import save_file

    jcfg, tcfg = tiny_idefics2(cfgs), tiny_idefics2(tcfgs)
    src, want = idefics2_dir["hf"], idefics2_dir["sd"]
    if arch == "mistral":
        want = jhf.export_decoder(idefics2_dir["params"]["text"], jcfg.text, "model.")
        src = str(tmp_path / "mistral")
        os.makedirs(src)
        save_file({k: np.ascontiguousarray(v) for k, v in want.items()},
                  os.path.join(src, "model.safetensors"))
    native, out = str(tmp_path / "native"), str(tmp_path / "out")
    with redirect_stdout(io.StringIO()):
        for direction, i, o in (("hf2native", src, native), ("native2hf", native, out)):
            convert_checkpoint.convert(convert_checkpoint.parse_args(
                ["--direction", direction, "--arch", arch, "--input", i, "--output", o,
                 "--device", "cpu"]), cfg=tcfg)
    assert json.loads((tmp_path / "native" / "0" / "config.json").read_text()) == {"arch": arch}
    if arch == "mistral":
        hf_config = json.loads(open(os.path.join(out, "config.json")).read())
        assert hf_config["model_type"] == "mistral" and hf_config["sliding_window"] == 16
    with safe_open(os.path.join(out, "model.safetensors"), framework="np") as f:
        assert set(f.keys()) == set(want)
        for k, v in want.items():
            got = f.get_tensor(k)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, v, err_msg=k)


def test_serve_idefics2_answers_an_image_request(idefics2_dir):
    """`serve --arch leopard_idefics2 --device cpu`: one request of two
    PNGs over HTTP, against Engine.generate on the server's own
    `_prepare_row` output."""
    import base64

    from leopard_tpu_torch.inference.server import _decode_images

    tcfg, tok = tiny_idefics2(tcfgs), CharTokenizer()
    args = serve.parse_args(["--checkpoint", idefics2_dir["hf"], "--arch", "leopard_idefics2",
                             "--host", "127.0.0.1", "--port", "0", "--device", "cpu"])
    server = serve.build_server(args, tokenizer=tok, cfg=tcfg)
    assert server.engine.model.cfg.architecture == "leopard_idefics2"
    rng = np.random.RandomState(7)
    pngs = []
    for w, h in ((150, 60), (40, 130)):
        buf = io.BytesIO()
        Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, format="PNG")
        pngs.append(base64.b64encode(buf.getvalue()).decode())
    text = "<image> and <image>: which one is wider?"
    httpd = server.http_server()
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        payload = {"prompts": [text], "images": [pngs], "max_new_tokens": 4, "greedy": True,
                   "eos_token_ids": [999999]}
        req = urllib.request.Request(url + "/api/generate", data=json.dumps(payload).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            status, out = r.status, json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    ids, pixels, mask = server._prepare_row(text, _decode_images(pngs))
    assert pixels.dtype == np.float32 and mask.dtype == bool and mask.shape[0] == 2
    want = server.engine.generate([ids], images=pixels, patch_mask=mask,
                                  gen_cfg=tcfgs.GenerateConfig(max_new_tokens=4,
                                                               eos_token_ids=(999999,)))
    assert status == 200 and out["tokens"] == [want.tokens[0].tolist()]


def write_eval_sets(root, rng):
    """MP-DocVQA in its raw layout (val.json, images/<page>.jpg: 3 questions
    of 1-2 pages) and prepared eval_mmmu.jsonl (multiple-choice) and
    eval_visualwebbench.jsonl (captioning and webqa) of 1-2 PNGs each."""
    from leopard_tpu_torch.evaluation.loaders import write_jsonl
    from leopard_tpu_torch.evaluation.metrics import option_block

    doc = root / "mpdocvqa"
    (doc / "images").mkdir(parents=True)
    data = []
    for i in range(3):
        pages = [f"d{i}_p{j}" for j in range(1 + i % 2)]
        for page in pages:
            w, h = rng.randint(40, 160, size=2)
            Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(
                doc / "images" / f"{page}.jpg")
        data.append({"page_ids": pages, "question": f"what is on page {i}?",
                     "answers": ["noise", "nothing"]})
    (doc / "val.json").write_text(json.dumps({"data": data}))
    for name, kinds in (("mmmu", ["multiple-choice"] * 3),
                        ("visualwebbench", ["captioning", "webqa", "webqa"])):
        (root / name).mkdir()
        rows = []
        for i, kind in enumerate(kinds):
            paths = [noise_png(root / name / f"{i}_{j}.png", rng, *rng.randint(40, 160, size=2))
                     for j in range(1 + i % 2)]
            opts = ["red", "green", "blue"] if kind == "multiple-choice" else None
            rows.append({"images_path": paths, "question": "<image>" * len(paths) + f" q{i}",
                         "options": opts, "concated_options": option_block(opts) if opts else None,
                         "answers": "B" if opts else ["a noisy picture"], "ques_type": kind})
        write_jsonl(str(root / name / f"eval_{name}.jsonl"), rows)


EVAL_SETS = ["mpdocvqa", "mmmu", "visualwebbench"]


def eval_argv(workdir, data_root, result_dir, *extra):
    return ["--checkpoint", workdir["hf"], "--data-root", str(data_root), "--datasets",
            *EVAL_SETS, "--result-dir", str(result_dir), "--batch-size", "2",
            "--max-new-tokens", "4", "--device", "cpu", *extra]


def _fresh_rng():
    """What a new process has: the multiple-choice parser's generator at
    its seed."""
    from leopard_tpu_torch.evaluation import metrics

    metrics._rng.seed(42)


def _cli_eval(workdir, data_root, result_dir, *extra):
    _fresh_rng()
    with redirect_stdout(io.StringIO()):
        return run_eval.run_eval(run_eval.parse_args(eval_argv(workdir, data_root, result_dir,
                                                               *extra)),
                                 tokenizer=TOK, cfg=cfg_pair()[1])


def _details(result_dir, name):
    with open(os.path.join(result_dir, name)) as f:
        return [json.loads(line) for line in f]


def test_run_eval_shards_and_merge(workdir, tmp_path):
    from leopard_tpu_torch.convert.hf import load_leopard_llava
    from leopard_tpu_torch.evaluation import harness
    from leopard_tpu_torch.evaluation.adapter import LeopardLlavaEvalAdapter
    from leopard_tpu_torch.evaluation.loaders import load_benchmark

    write_eval_sets(tmp_path / "data", np.random.RandomState(3))
    two, one = tmp_path / "two", tmp_path / "one"
    assert _cli_eval(workdir, tmp_path / "data", two, "--num-shards", "2", "--shard", "1") is None
    merged = _cli_eval(workdir, tmp_path / "data", two, "--num-shards", "2", "--shard", "0")
    assert _cli_eval(workdir, tmp_path / "data", one) is not None
    assert set(merged) == {f"{d}_direct" for d in EVAL_SETS}
    # each shard file is the harness called directly on the shard's rows
    tcfg = cfg_pair()[1]
    adapter = LeopardLlavaEvalAdapter(
        tcfg, load_leopard_llava(workdir["hf"], tcfg, "cpu"), TOK,
        gen_cfg=tcfgs.GenerateConfig(max_new_tokens=4, greedy=True,
                                     eos_token_ids=(128001, 128009)))
    for shard in (1, 0):
        _fresh_rng()
        for d in EVAL_SETS:
            want = harness.run_benchmark_batched(
                load_benchmark(d, str(tmp_path / "data" / d)), adapter, d, shard=shard,
                num_shards=2, batch_size=2)
            assert _details(two, f"{shard}_direct_{d}_shard_details.jsonl") == want
    # the merge equals the one-shard run where no score draws from the
    # multiple-choice generator (each shard's process draws from its own)
    for d in EVAL_SETS:
        a, b = _details(two, f"{d}_direct_details.jsonl"), _details(one, f"{d}_direct_details.jsonl")
        assert [x["raw"] for x in a] == [x["raw"] for x in b]
        if d != "mmmu":
            assert a == b and merged[f"{d}_direct"] == json.loads(
                (one / "all_bench_results.json").read_text())[f"{d}_direct"]
    assert json.loads((two / "all_bench_results.json").read_text()) == merged


@pytest.mark.parametrize("extra", [["--prefix-caching"], ["--spec", "3"]],
                         ids=["prefix_caching", "spec"])
def test_run_eval_serving_options_keep_the_tokens(workdir, tmp_path, extra):
    write_eval_sets(tmp_path / "data", np.random.RandomState(4))
    _cli_eval(workdir, tmp_path / "data", tmp_path / "plain")
    _cli_eval(workdir, tmp_path / "data", tmp_path / "opt", *extra)
    for d in EVAL_SETS:
        assert (_details(tmp_path / "opt", f"{d}_direct_details.jsonl")
                == _details(tmp_path / "plain", f"{d}_direct_details.jsonl"))


def test_run_eval_refuses_idefics2_int4():
    """The combination is accepted now (the test keeps its name): int4
    Leopard-Idefics2 parses, as int8 does; the padded head serves it
    (test_serve_refuses_idefics2_int4 builds one)."""
    for mode in ("int8", "int4"):
        args = run_eval.parse_args(["--arch", "leopard_idefics2", "--quantize", mode,
                                    "--checkpoint", "c", "--data-root", "d"])
        assert (args.arch, args.quantize) == ("leopard_idefics2", mode)


@pytest.mark.parametrize("name", ["generate", "serve", "train", "train_idefics2", "convert",
                                  "run_eval"])
def test_refuses_without_gpu(workdir, tmp_path, name, monkeypatch):
    """With no card and no --device cpu, each CLI exits with an error before
    it reads anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {
        "generate": (generate.main, ["--checkpoint", workdir["hf"], "--question", "hi"]),
        "serve": (serve.main, ["--checkpoint", workdir["hf"]]),
        "train": (train_leopard_llava.main,
                  train_argv(workdir, tmp_path / "t", 1)[:-len(SETS) - 3] + ["--tiny"]),
        "train_idefics2": (train_leopard_idefics2.main,
                           ["--manifest", workdir["manifest"], "--tokenizer", "unused",
                            "--checkpoint-dir", str(tmp_path / "t"), "--tiny"]),
        "convert": (convert_checkpoint.main, ["--direction", "hf2native", "--input",
                                              workdir["hf"], "--output", str(tmp_path / "n")]),
        "run_eval": (run_eval.main, ["--checkpoint", workdir["hf"], "--data-root",
                                     str(tmp_path), "--result-dir", str(tmp_path / "n")]),
    }
    main, args = argv[name]
    assert "--device" not in args
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(args)
    assert not (tmp_path / "t").exists() and not (tmp_path / "n").exists()
