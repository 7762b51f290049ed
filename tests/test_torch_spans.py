"""Program spans (`utils/timers.py::span`) in the serving prefill and the
train step, and the benchmark's readers of them.

On the CPU at toy widths (`tiny_vlm`, `tiny_idefics2`, weights from the
port's own `init_params`): with no profiler running nothing is recorded and
`record_function` is never called; under a CPU `torch.profiler` one
`Engine.prefill` records its seven serving spans once each, with the
request's counts, and each appears among the profiler's user annotations on
the same clock; a chunked prefill adds one splice, decoder and head a chunk;
a train step records each `train.*` span once and leaves the loss, the
masters and the moments bit-equal to the step run untraced; the training
loop's profiler window holds its own spans alone, in its trace too; the
private profiler flag the spans read is pinned, and without it spans record
nothing; the six readers of `portbench/metrics/` read hand-made records. The file imports no JAX, so its card test also runs where
JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from leopard_tpu_torch import config as cfgs
from leopard_tpu_torch.inference.engine import Engine
from leopard_tpu_torch.models import vlm as tvlm
from leopard_tpu_torch.training import trainer
from leopard_tpu_torch.utils import timers
from leopard_tpu_torch.utils.timers import NO_SPAN, SpanRecord, span, span_totals

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
SERVE = ["engine.pack", "engine.cache", "engine.tiles", "model.tower", "model.splice",
         "model.decoder", "model.head"]
TRAIN = ["train.cast", "train.loss", "train.backward", "train.grads", "train.norm",
         "train.adamw"]
CLOCK_NS = 5_000_000  # a record's host start against its profiler event, on a shared CPU
CLOCK_TRIES = 3  # a loaded CPU can deschedule the thread inside a span's open


@pytest.fixture(scope="module")
def llava():
    cfg = cfgs.tiny_vlm()
    return cfg, tvlm.init_params(cfg, torch.Generator().manual_seed(0)).eval()


@pytest.fixture(scope="module")
def idefics2():
    cfg = cfgs.tiny_idefics2()
    return cfg, tvlm.init_params(cfg, torch.Generator().manual_seed(1))


def _request(cfg, tiles, text, seed=0):
    rng = np.random.RandomState(seed)
    prompt = np.concatenate([
        [1], np.full(tiles * cfg.anyres.tokens_per_tile, cfg.image_token_id),
        rng.randint(3, 200, text)]).astype(np.int32)
    images = rng.randn(tiles, 3, cfg.vision.image_size, cfg.vision.image_size)
    return prompt, images.astype(np.float32)


def _traced(fn):
    """fn() under a CPU profiler, its spans alone: (its result, the user
    annotations {name: [start ns, ...]})."""
    timers.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    marks = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            marks.setdefault(e.name(), []).append(e.start_ns())
    return out, marks


def _train_setup(cfg, model):
    opt = cfgs.OptimizerConfig(lr=1e-2, warmup_steps=0, schedule="constant", grad_clip=1.0)
    train_cfg = cfgs.TrainConfig(seq_len=24, remat="full", loss_chunk=8, optimizer=opt)
    rng = np.random.RandomState(3)
    lat = cfg.perceiver.num_latents
    tokens = rng.randint(3, 200, (2, 24))
    tokens[:, 2:2 + lat] = cfg.image_token_id  # one image a row
    side = cfg.vision.image_size // cfg.vision.patch_size
    mask = np.zeros((2, side, side), bool)
    mask[0, :4, :5], mask[1, :6, :3] = True, True
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int32)),
             "loss_weights": torch.ones(2, 24),
             "segment_ids": torch.ones(2, 24, dtype=torch.int32),
             "images": torch.from_numpy(rng.randn(2, 3, 84, 84).astype(np.float32)),
             "patch_mask": torch.from_numpy(mask)}
    step = trainer.make_train_step(cfg, train_cfg, model=model)
    return train_cfg, step, batch


def test_span_off_path_records_nothing(llava, idefics2, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    timers.clear_spans()
    assert span("engine.pack", rows=1) is NO_SPAN
    cfg, model = llava
    prompt, images = _request(cfg, 3, 9)
    Engine(cfg, model, seq_buckets=(16, 32), tile_buckets=(1, 2, 4)).prefill(
        [prompt], images=images)
    cfg2, model2 = idefics2
    train_cfg, step, batch = _train_setup(cfg2, model2)
    step(trainer.create_train_state(model2, train_cfg), batch)
    assert timers.SPANS == [] and span_totals() == {}


def test_serving_spans_once_each(llava):
    cfg, model = llava
    eng = Engine(cfg, model, seq_buckets=(16, 32), tile_buckets=(1, 2, 4))
    prompt, images = _request(cfg, 3, 9)  # 1 + 12 + 9 = 22 tokens, 3 tiles
    eng.prefill([prompt], images=images)  # warm, untraced
    offsets = []
    for _ in range(CLOCK_TRIES):
        _, marks = _traced(lambda: eng.prefill([prompt], images=images))
        recs = timers.SPANS
        assert [r.name for r in recs] == SERVE
        assert all(r.t1_ns >= r.t0_ns for r in recs)
        assert all(len(marks[r.name]) == 1 for r in recs)  # in the profiler's trace
        offsets.append(max(abs(marks[r.name][0] - r.t0_ns) for r in recs))
        if offsets[-1] < CLOCK_NS:
            break
    assert min(offsets) < CLOCK_NS, offsets  # on the profiler's clock
    by = {r.name: r.counts for r in recs}
    assert by.pop("engine.pack") == {"tokens": 22, "slots": 32}
    assert by.pop("engine.tiles") == {"tiles": 3, "tile_slots": 4}
    assert all(c == {} for c in by.values())
    t = span_totals()
    assert set(t) == set(SERVE) and all(v["n"] == 1 and v["stream_ms"] is None
                                        for v in t.values())


def test_chunked_prefill_spans_a_chunk(llava):
    cfg, model = llava
    eng = Engine(cfg, model, seq_buckets=(16, 32), tile_buckets=(1, 2))
    prompt, images = _request(cfg, 1, 65)  # 70 tokens: three chunks of 32
    _traced(lambda: eng.prefill([prompt], images=images))
    names = [r.name for r in timers.SPANS]
    assert names == SERVE[:4] + SERVE[4:] * 3
    assert timers.SPANS[0].counts == {"tokens": 70, "slots": 96}


def test_train_step_spans_bit_equal(idefics2):
    cfg, model = idefics2
    train_cfg, step, batch = _train_setup(cfg, model)
    plain, traced = (trainer.create_train_state(model, train_cfg) for _ in range(2))
    plain, m_plain = step(plain, batch)
    (traced, m_traced), marks = _traced(lambda: step(traced, batch))
    assert torch.equal(m_plain["loss"], m_traced["loss"])
    for a, b in ((plain.params, traced.params), (plain.opt_state.mu, traced.opt_state.mu),
                 (plain.opt_state.nu, traced.opt_state.nu)):
        assert all(torch.equal(a[k], b[k]) for k in a)
    recs = [r for r in timers.SPANS if r.name.startswith("train.")]
    assert sorted(r.name for r in recs) == sorted(TRAIN)
    assert recs[0].name == "train.cast"  # opens the step: the readers count steps by it
    assert all(r.counts == {} for r in recs)
    assert all(name in marks for name in TRAIN)
    for name in ("model.tower", "model.splice", "model.decoder", "model.head"):
        assert [r.name for r in timers.SPANS].count(name) == 1


def test_profile_window_holds_its_own_spans(idefics2, tmp_path):
    from leopard_tpu_torch.training.loop import train

    cfg, model = idefics2
    train_cfg, step, batch = _train_setup(cfg, model)
    train_cfg = dataclasses.replace(train_cfg, train_steps=3, save_interval=0, eval_interval=0,
                                    check_param_hash_interval=0)
    timers.SPANS[:] = [SpanRecord("stale", 1, 2)]  # an earlier session's
    train(cfg, train_cfg, trainer.create_train_state(model, train_cfg), step,
          iter([batch] * 3), profile_steps=(1, 2), profile_dir=str(tmp_path))
    names = [r.name for r in timers.SPANS]
    assert "stale" not in names and names.count("train.cast") == 1  # the window's one step
    trace = "".join(p.read_text() for p in tmp_path.rglob("*.json"))
    assert all(f'"{name}"' in trace for name in TRAIN)  # in its TensorBoard trace


def test_span_totals_sum_by_name():
    timers.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with span("outer", rows=2):
            with span("inner"):
                pass
        with span("outer", rows=1):
            pass
    first, inner, second = timers.SPANS
    t = span_totals()
    assert t["outer"]["n"] == 2 and t["outer"]["counts"] == {"rows": 3}
    assert t["inner"]["n"] == 1 and t["inner"]["counts"] == {}
    whole = sum(r.t1_ns - r.t0_ns for r in (first, second))
    assert t["outer"]["host_ms"] == pytest.approx(whole / 1e6)
    assert inner.t0_ns >= first.t0_ns and inner.t1_ns <= first.t1_ns


def test_profiler_flag_pinned():
    """The spans' switch is torch's private `_is_profiler_enabled`: pinned
    here, so that a torch without it fails this test and not the port."""
    flag = torch.autograd.profiler
    assert flag._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert flag._is_profiler_enabled is True
        assert span("a") is not NO_SPAN
    assert flag._is_profiler_enabled is False


def test_span_off_without_the_flag():
    timers.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        saved = torch.autograd.profiler._is_profiler_enabled
        del torch.autograd.profiler._is_profiler_enabled
        try:
            assert span("a", n=1) is NO_SPAN  # no spans, and no error
        finally:
            torch.autograd.profiler._is_profiler_enabled = saved
    assert timers.SPANS == []


# ---------------------------------------------------------------- readers --


@dataclasses.dataclass
class FakeEvent:
    at_ms: float

    def elapsed_time(self, other):
        return other.at_ms - self.at_ms


def _rec(name, t0_ms, t1_ms, stream=None, **counts):
    events = [FakeEvent(0.0), FakeEvent(stream)] if stream is not None else []
    return SpanRecord(name, int(t0_ms * 1e6), int(t1_ms * 1e6), events, counts)


SERVE_RECS = [
    _rec("engine.pack", 0, 1, tokens=60, slots=100),
    _rec("engine.tiles", 1, 4, tiles=5, tile_slots=8),
    _rec("model.tower", 4, 5, stream=10.0),
    _rec("engine.pack", 10, 11, tokens=70, slots=100),
    _rec("engine.tiles", 11, 12, tiles=3, tile_slots=4),
    _rec("model.tower", 12, 13, stream=6.0),
]
TRAIN_RECS = [
    _rec(name, 0, 1, stream=float(i + 1))
    for _ in range(2) for i, name in enumerate(TRAIN)
]
READERS = {  # name: (records, the reading, the span whose loss makes it None)
    "tower_span_ms_per_tile.docqa": (SERVE_RECS, 16.0 / 8, "model.tower"),
    "tiles_ms_per_request.docqa": (SERVE_RECS, 4.0 / 2, "engine.tiles"),
    "tile_pad_share.docqa": (SERVE_RECS, 100 * (1 - 8 / 12), "engine.tiles"),
    "seq_pad_share.docqa": (SERVE_RECS, 100 * (1 - 130 / 200), "engine.pack"),
    "ce_ms_per_step.train": (TRAIN_RECS, 2 * 2.0 / 2, "train.loss"),
    "optimizer_ms_per_step.train": (TRAIN_RECS, 2 * (1 + 4 + 5 + 6) / 2, "train.adamw"),
}


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), REPO / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_readers(name, monkeypatch):
    recs, want, needed = READERS[name]
    read = _reader(name)
    monkeypatch.setattr(timers, "SPANS", list(recs))
    assert read(None) == pytest.approx(want)
    monkeypatch.setattr(timers, "SPANS", [r for r in recs if r.name != needed])
    assert read(None) is None
    monkeypatch.setattr(timers, "SPANS", [])
    assert read(None) is None


# ------------------------------------------------------------------- card --


@pytest.mark.cuda
def test_span_clock_and_stream_on_card():
    """One traced request on the card: every span's host start within 50 µs
    of its profiler event, and stream time for each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the spans' CUDA events")
    cfg = cfgs.tiny_vlm()  # in bf16, its tower at head dim 16: what K1 takes
    cfg = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, num_heads=2, dtype="bfloat16"),
        text=dataclasses.replace(cfg.text, dtype="bfloat16"),
        projector=dataclasses.replace(cfg.projector, dtype="bfloat16"))
    model = tvlm.init_params(cfg, torch.Generator("cuda").manual_seed(0)).eval()
    eng = Engine(cfg, model, seq_buckets=(16, 32), tile_buckets=(1, 2, 4))
    prompt, images = _request(cfg, 3, 9)
    eng.prefill([prompt], images=images)
    timers.clear_spans()

    def twice():
        for _ in range(2):
            eng.prefill([prompt], images=images)
        torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        twice()
    marks = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.device_type() == torch.autograd.DeviceType.CPU:
            marks.setdefault(e.name(), []).append(e.start_ns())
    second = timers.SPANS[len(SERVE):]  # the warm request
    assert [r.name for r in second] == SERVE
    for r in second:
        assert min(abs(s - r.t0_ns) for s in marks[r.name]) < 50_000, r.name
    t = span_totals()
    assert all(t[name]["stream_ms"] is not None and t[name]["n"] == 2 for name in SERVE)
