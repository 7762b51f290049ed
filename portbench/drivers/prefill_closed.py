"""A closed loop of one client into `Engine.prefill`: time to first token.

Each request of the mix's replay set (traffic/generate.py::serving_requests)
is handed to `Engine.prefill` as its prompt and its uint8 tiles, and its
first greedy token id is read on the host; the next request follows at once.
A request's time to first token runs from the call to that id. The set is
served in the run's order, over and over, until `--seconds` have passed;
the request that is open then finishes inside the window.

Set-up: the model on the device with the seed's weights, the engine, and
one prefill at each (tile bucket, sequence bucket) pair the set uses.
With `--trace 1` the first `trace_seconds` of the window are traced, the
tower's calls timed by CUDA events.

Checked: a sample of the window's requests, drawn from the seed: the
longest, one of every (tile bucket, sequence bucket) pair the window
served, and others up to the mix's `check_requests`; the reference
recomputes each from its tiles and prompt and gives its logits at the last
position. Compared: `kl`, the largest
KL(reference ‖ program) of the first token's distributions. Reported beside
it: the widest gap by which a served token's reference logit lies below the
reference's best (`token_gap`) and the largest logit error in units of the
reference logits' RMS (`logit_err`); neither separates the program from its
int8 control by the factor a limit needs (PERF.md).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import weights
from portbench.drivers import check_sample
from portbench.traffic.generate import serving_requests


class TowerClock:
    """CUDA events around each `encode_images` call of the engine."""

    def __init__(self, engine, tracer, cuda: bool):
        self.pairs, self.tiles = [], 0
        inner = engine.encode_images

        def timed(pixel_values, patch_mask=None):
            with tracer.span("tower"):
                if not cuda:
                    return inner(pixel_values, patch_mask)
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                out = inner(pixel_values, patch_mask)
                b.record()
                self.pairs.append((a, b))
                self.tiles += int(pixel_values.shape[0])
                return out

        engine.encode_images = timed

    def total_ms(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def reference_last_logits(run, tensors, req) -> torch.Tensor:
    """The reference's logits [V] at the prompt's last position."""
    from portbench.reference.common import Precision, Weights, exact_fp32
    from portbench.reference.models import decoder_hidden, head_logits, llava_image_features

    prec = Precision()
    w = Weights(tensors)
    with torch.no_grad(), exact_fp32():
        dev = run.device
        tiles = torch.from_numpy(req["tiles"]).to(dev)
        feats = llava_image_features(run.cfg_json, w, tiles, prec)
        tokens = torch.from_numpy(req["prompt"]).to(dev)
        at = tokens == run.cfg.image_token_id
        hidden = decoder_hidden(run.cfg_json, w, tokens, at, feats, [(0, len(tokens))], prec,
                                run.cfg.text.head_dim)
        return head_logits(w, hidden[-1:], prec)[0]


def readings(prog_logits: torch.Tensor, token: int, ref: torch.Tensor) -> dict:
    """One request's readings: `kl` KL(reference ‖ program) of the next
    token's distributions; `token_gap` the served token's reference logit
    below the reference's best; `logit_err` max |program − reference| over
    the vocabulary in units of the reference logits' RMS."""
    ref = ref.double()
    prog = prog_logits.double().to(ref.device)
    lp_ref, lp_prog = torch.log_softmax(ref, -1), torch.log_softmax(prog, -1)
    return {"kl": float((lp_ref.exp() * (lp_ref - lp_prog)).sum()),
            "token_gap": float(ref.max() - ref[token]),
            "logit_err": float((prog - ref).abs().max() / ref.square().mean().sqrt())}


def run(run) -> None:
    from leopard_tpu_torch.inference.engine import Engine

    cfg, tr = run.cfg, run.traffic
    cuda = run.device == "cuda"
    reqs = serving_requests(tr, cfg, run.seed)
    model = weights.build_model(cfg, run.seed, run.device)
    eng = Engine(cfg, model, quantize=run.variant)

    def first_token(req):
        logits, cache = eng.prefill([req["prompt"]], images=req["tiles"])
        del cache
        return logits, int(logits[0].argmax())

    def buckets(req):
        return (eng._bucket(req["crops"], eng.tile_buckets),
                eng._bucket(req["tokens"], eng.seq_buckets))

    seen = set()
    for req in reqs:  # warm-up: each (tile bucket, sequence bucket) pair once
        if buckets(req) not in seen:
            seen.add(buckets(req))
            first_token(req)
    run.setup_done()

    clock = TowerClock(eng, run.tracer, cuda) if run.trace else None
    ttft, done = [], []
    run.tracer.start()
    t0 = time.perf_counter()
    end = t0 + run.seconds
    i = 0
    while True:
        req = reqs[i % len(reqs)]
        i += 1
        traced = run.tracer.active
        t = time.perf_counter()
        with run.tracer.span("prefill"):
            logits, tok = first_token(req)
        ttft.append(time.perf_counter() - t)
        done.append({"req": req, "logits": logits[0], "token": tok, "traced": traced})
        now = time.perf_counter()
        if traced and now - t0 >= tr.get("trace_seconds", run.seconds):
            end += run.tracer.stop()
        if time.perf_counter() >= end:
            break
    run.window_closed()
    run.attempted = len(done)
    run.failed = sum(1 for d in done if not bool(torch.isfinite(d["logits"]).all()))
    run.e2e["ttft_p90_ms"] = float(np.percentile(np.asarray(ttft) * 1e3, 90))
    run.data.update(
        ttft_s=ttft,
        requests=[(d["req"]["crops"], d["req"]["tokens"], s, d["traced"])
                  for d, s in zip(done, ttft)])
    if clock is not None:
        run.data["tower_ms"], run.data["tower_tiles"] = clock.total_ms(), clock.tiles

    pick = check_sample(run.seed, [d["req"]["design"] for d in done],
                        [buckets(d["req"]) for d in done],
                        [d["req"]["tokens"] for d in done], tr["check_requests"])
    sample = [(done[i]["req"], done[i]["logits"].float().cpu(), done[i]["token"]) for i in pick]
    del eng, model, done, logits
    run.free()
    tensors = weights.draw(weights.shapes_of(cfg), run.seed, run.device)
    worst: dict = {}
    for req, prog, tok in sample:
        for k, v in readings(prog, tok, reference_last_logits(run, tensors, req)).items():
            worst[k] = max(worst.get(k, 0.0), v)
    run.numbers = {"kl": worst.pop("kl")}
    run.diagnostics = worst
