"""Training steps through `make_train_step`: tokens a second.

The mix's batches (traffic/generate.py::train_batches) are made at set-up
from the seed and live on the device, so the host's batch builder stays off
the timed path. Set-up builds one train state from the seed's weights and
the step from `make_train_step` with the mix's recompute policy, loss chunk
and optimizer, and drives that step through its first `reference_steps`
steps on the first batches, which all differ (these steps are the warm-up:
every batch has the same shape). The window then runs the same step on the
next batches, each step ended by a synchronize, until `--seconds` have
passed; the open step finishes inside it. `train_tok_s` is the real tokens
of the window's steps over the window's wall time.

Checked, against the plain reference run on the same first batches from the
same weights; a leaf's gap is |program − reference| over the larger of the
leaf's reference and the median leaf's:
  - `grad_gap`: the worst leaf's gap of the norm of the first gradient as
    the optimizer got it (its first moment after one step over 1 − β₁);
  - `change_gap`: the median leaf's gap of the norm of its change after the
    set-up steps. The worst leaf's gap swings from seed to seed: the
    bfloat16 compute copy rounds AdamW's first updates of the float32
    masters away in most elements, and a leaf of small gradients turns
    that into direction. A reference whose compute weights are rounded so
    (`control.py --witness-seeds`) agrees with the program (PERF.md).
Reported beside them: the set-up steps' largest relative loss gap and the
worst leaf's change gap. Leaves whose reference gradient is under a
thousandth of the median leaf's are left out: AdamW moves them by
round-off alone.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import weights
from portbench.traffic.generate import train_batches

SMALL_GRAD = 1e-3  # a leaf's gradient under this share of the median leaf's is round-off


def _configs(run):
    from leopard_tpu_torch.config import OptimizerConfig, TrainConfig

    t = run.traffic["train"]
    opt = OptimizerConfig(warmup_steps=0, **t["optimizer"])
    return TrainConfig(seq_len=run.traffic["row_tokens"], remat=t["remat"],
                       loss_chunk=t["loss_chunk"], optimizer=opt), t["optimizer"]


def leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    """Each kept leaf's |prog − ref| / max(ref, the median kept leaf's ref)."""
    med = float(np.median([ref[k] for k in keep]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}


def numbers(prog: dict, ref: dict, log=None):
    """(the compared numbers, the readings reported beside them): the worst
    leaf's first-gradient gap and the median leaf's change gap compared;
    the losses' largest relative gap and the worst leaf's change gap
    beside. `log(text)` is told which leaf is worst."""
    raw = ref["raw_grad1"]
    med = float(np.median([g for g in raw.values() if g > 0]))
    keep = [k for k, g in raw.items() if g >= SMALL_GRAD * med]
    grad = leaf_gaps(prog["grad1"], ref["grad1"], keep)
    change = leaf_gaps(prog["change"], ref["change"], keep)
    g_worst, c_worst = max(grad, key=grad.get), max(change, key=change.get)
    if log is not None:
        log(f"worst leaves: gradient {g_worst} {grad[g_worst]:.4g}, change {c_worst} "
            f"{change[c_worst]:.4g}; {len(keep)} of {len(raw)} leaves; gradient norms "
            f"program {prog.get('gnorm')} reference {ref.get('gnorm')}")
    compared = {"grad_gap": grad[g_worst], "change_gap": float(np.median(list(change.values())))}
    beside = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
              "change_worst_gap": change[c_worst]}
    return compared, beside


def reference(run, batches, half_batch: bool = False, fp8: bool = False,
              bf16_compute: bool = False) -> dict:
    """The plain reference's readings on `batches` from the seed's weights."""
    from portbench.reference.common import Precision, exact_fp32
    from portbench.reference.train import train

    tensors = weights.draw(weights.shapes_of(run.cfg), run.seed, run.device)
    grids = [[tuple(g) for g in b["grids"]] for b in batches]
    with exact_fp32():
        return train(run.cfg_json, tensors, batches, grids, run.traffic["train"]["optimizer"],
                     run.cfg.text.head_dim, Precision(fp8=fp8), half_batch=half_batch,
                     bf16_compute=bf16_compute)


def spans(run, model) -> None:
    """Spans around the model's forward and its tower, in a traced run."""
    for name, attr in (("forward", "forward"), ("tower", "encode_images")):
        inner = getattr(model, attr)

        def wrapped(*a, _inner=inner, _name=name, **kw):
            with run.tracer.span(_name):
                return _inner(*a, **kw)

        setattr(model, attr, wrapped)


def run(run) -> None:
    from leopard_tpu_torch.training.trainer import create_train_state, make_train_step

    cfg, tr = run.cfg, run.traffic
    n_ref = tr["reference_steps"]
    batches = train_batches(tr, cfg, run.seed, run.device)
    stats = [b.pop("stats") for b in batches]
    train_cfg, opt = _configs(run)
    model = weights.build_model(cfg, run.seed, run.device, requires_grad=True)
    state = create_train_state(model, train_cfg)
    step = make_train_step(cfg, train_cfg, model=model)
    b1 = opt["beta1"]

    prog = {"losses": []}
    for i in range(n_ref):
        state, m = step(state, batches[i])
        prog["losses"].append(float(m["loss"]))
        prog.setdefault("gnorm", []).append(round(float(m.get("grad_norm", float("nan"))), 5))
        if i == 0:
            prog["grad1"] = {k: float(v.norm()) / (1 - b1)
                             for k, v in state.opt_state.mu.items()}
    init = weights.draw(weights.shapes_of(cfg), run.seed, run.device)
    with torch.no_grad():
        prog["change"] = {k: float((p - init[k].float()).norm()) for k, p in state.params.items()}
    del init
    run.setup_done()

    if run.trace:
        spans(run, model)
    done, tokens, nan_steps = [], 0, 0
    run.tracer.start()
    t0 = time.perf_counter()
    end = t0 + run.seconds
    while True:
        i = n_ref + len(done) % max(1, len(batches) - n_ref)
        traced = run.tracer.active
        t = time.perf_counter()
        with run.tracer.span("step"):
            state, m = step(state, batches[i])
            run.sync()
        done.append((stats[i], time.perf_counter() - t, traced))
        nan_steps += bool(m["nan_step"])
        tokens += stats[i]["real_tokens"]
        if traced and sum(d[2] for d in done) >= tr.get("trace_steps", 1 << 30):
            end += run.tracer.stop()
        if time.perf_counter() >= end:
            break
    window = time.perf_counter() - t0 - run.tracer.stop_s
    run.window_closed()
    run.attempted, run.failed = len(done), nan_steps
    run.e2e["train_tok_s"] = tokens / window
    run.data["steps"] = done

    ref_batches = [dict(batches[i], grids=stats[i]["grids"]) for i in range(n_ref)]
    del state, step, model, m, batches
    run.free()
    ref = reference(run, ref_batches)
    run.data.update(prog=prog, ref=ref)
    run.numbers, run.diagnostics = numbers(
        prog, ref, log=lambda t: print(t, file=sys.stderr, flush=True))
