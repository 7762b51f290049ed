"""Every cell's loop end to end on the CPU at toy widths, through the port's
plain kernel versions; the result line; the faults the check must catch;
the lower-precision controls; a cell added by new files alone."""

from __future__ import annotations

import hashlib
import json
import shutil

import pytest
import torch

from portbench.harness import Run, execute

SEED = 2**31 + 12345  # past 32 signed bits, as a run's seed may be
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_cell(root, workload, trace=False, seconds=0.5, variant=None):
    run = Run(root, workload, SEED, seconds, trace, device="cpu")
    run.variant = variant
    return run, execute(run)


@pytest.mark.parametrize("workload", ["tiny_llava.docqa", "tiny_idefics2.train"])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_end_to_end(tiny_root, workload, trace):
    run, out = run_cell(tiny_root, workload, trace)
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["device"]["platform"] == "cpu"
    names = {m["name"] for m in run.metric_entries(trace)}
    if not trace:  # end-to-end metrics come from the host clock, on any device
        assert set(out["metrics"]) == names and "setup_s" in names
    else:  # a CPU run reads no device metric
        assert set(out["metrics"]) <= names
        assert not any(k in out["metrics"] for k in names if "roofline" in k or "mfu" in k)
    json.dumps(out)


def test_same_seed_same_inputs(tiny_root):
    from portbench.traffic.generate import serving_requests, train_batches

    run = Run(tiny_root, "tiny_llava.docqa", SEED, 0.1, False, device="cpu")
    a, b = (serving_requests(run.traffic, run.cfg, SEED) for _ in range(2))
    assert all((x["prompt"] == y["prompt"]).all() and (x["tiles"] == y["tiles"]).all()
               for x, y in zip(a, b))
    c = serving_requests(run.traffic, run.cfg, SEED + 1)
    assert sorted(x["tokens"] for x in a) == sorted(x["tokens"] for x in c)
    tr = Run(tiny_root, "tiny_idefics2.train", SEED, 0.1, False, device="cpu")
    b1, b2 = (train_batches(tr.traffic, tr.cfg, SEED, "cpu") for _ in range(2))
    assert all(torch.equal(x["images"], y["images"]) and torch.equal(x["tokens"], y["tokens"])
               for x, y in zip(b1, b2))


# ------------------------------------------------------------------ faults --

def test_fault_altered_first_token(tiny_root, monkeypatch):
    """A token altered where it is produced: the engine's first-step logits
    put another token first."""
    from leopard_tpu_torch.inference.engine import Engine

    real = Engine.prefill

    def altered(self, *a, **kw):
        logits, cache = real(self, *a, **kw)
        logits = logits.clone()
        logits[:, (logits.argmax(-1) + 1) % logits.shape[-1]] += 1e3
        return logits, cache

    monkeypatch.setattr(Engine, "prefill", altered)
    _, out = run_cell(tiny_root, "tiny_llava.docqa")
    assert out["correct"] is False and out["checks"]["kl"]["value"] > 1e-3


def test_fault_state_unchanged(tiny_root, monkeypatch):
    """A step that returns its state unchanged."""
    from leopard_tpu_torch.training import trainer

    monkeypatch.setattr(trainer, "apply_gradients",
                        lambda opt, state, grads, loss, metrics, frozen=(): (
                            state, dict(metrics, nan_step=False)))
    _, out = run_cell(tiny_root, "tiny_idefics2.train")
    assert out["correct"] is False and out["checks"]["change_gap"]["value"] > 0.5


def test_fault_half_batch(tiny_root, monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from leopard_tpu_torch.training import trainer

    real = trainer.vlm_loss

    def half(model, cfg, batch, *a, **kw):
        rows = batch["tokens"].shape[0] // 2
        n_img = int((batch["tokens"][:rows] == cfg.image_token_id).sum()) // cfg.perceiver.num_latents
        cut = {k: (v[:rows] if k in ("tokens", "segment_ids", "positions", "loss_weights")
                   else v[:n_img] if k in ("images", "patch_mask") else v)
               for k, v in batch.items()}
        return real(model, cfg, cut, *a, **kw)

    monkeypatch.setattr(trainer, "vlm_loss", half)
    _, out = run_cell(tiny_root, "tiny_idefics2.train")
    assert out["correct"] is False


# ---------------------------------------------------------------- controls --

def test_control_int8_serving_fails(tiny_root):
    _, out = run_cell(tiny_root, "tiny_llava.docqa", variant="int8")
    assert out["correct"] is False


def test_control_fp8_reference_fails(tiny_root):
    from portbench.control import train_control

    run = Run(tiny_root, "tiny_idefics2.train", SEED, 0.1, False, device="cpu")
    for what, (compared, _) in train_control(run).items():
        assert any(v > run.limits[k] for k, v in compared.items()), (what, compared)


# ----------------------------------------------------------- data-driven --

def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_cell_traffic_and_metric_added_by_files(tiny_root):
    """A later change adds a configuration, a traffic mix of a known kind, a
    per-layer metric and a cell as new files and entries: no file that is
    there changes."""
    pb = tiny_root / "portbench"
    spec_path = tiny_root / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    before = {p: d for p, d in _digests(tiny_root).items() if p != spec_path}
    shutil.copy(pb / "configs" / "tiny_llava.json", pb / "configs" / "tiny_llava_b.json")
    traffic = json.loads((pb / "traffic" / "tiny_docqa.json").read_text())
    traffic.update(design_seed=99, documents=traffic["documents"][:1])
    (pb / "traffic" / "tiny_two_images.json").write_text(json.dumps(traffic))
    (pb / "metrics" / "ttft_p50_ms.tiny.py").write_text(
        "import numpy as np\n\n\ndef read(run):\n"
        "    return float(np.median(run.data['ttft_s'])) * 1e3\n")
    (pb / "limits" / "tiny_llava_b.two_images.json").write_text(
        json.dumps({"limits": {"kl": 1e-6}}))
    spec["configs"].append({"name": "tiny_llava_b", "source": "test",
                            "file": "portbench/configs/tiny_llava_b.json", "reduced": [],
                            "why": "added"})
    spec["workloads"].append({"name": "tiny_llava_b.two_images", "config": "tiny_llava_b",
                              "traffic": "tiny_two_images", "chips": 1, "why": "added"})
    for m in spec["end_to_end"]:
        if m["name"] in ("ttft_p90_ms",):
            m["workloads"].append("tiny_llava_b.two_images")
    spec["per_layer"].append({"name": "ttft_p50_ms.tiny", "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "serving entry",
                              "moves": "ttft_p90_ms", "workloads": ["tiny_llava_b.two_images"]})
    spec_path.write_text(json.dumps(spec))
    _, out = run_cell(tiny_root, "tiny_llava_b.two_images", trace=True)
    assert out["correct"] is True and out["metrics"]["ttft_p50_ms.tiny"]["value"] > 0
    after = _digests(tiny_root)
    assert all(after[p] == d for p, d in before.items())


def test_check_sample_covers_every_bucket_pair():
    """The longest request, then one of every group the window served."""
    from portbench.drivers import check_sample

    groups = [0, 0, 0, 1, 1, 2, 0, 0, 2, 3]
    sizes = [5, 9, 1, 2, 3, 4, 6, 7, 8, 1]
    for seed in (1, 2**31 + 5):
        pick = check_sample(seed, list(range(10)), groups, sizes, 2)
        assert pick[0] == 1 and {groups[i] for i in pick} == {0, 1, 2, 3}
        assert len(set(pick)) == len(pick)
