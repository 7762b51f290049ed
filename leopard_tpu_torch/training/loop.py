"""The training loop: orchestration, observability, failure handling (port of
leopard_tpu/training/loop.py).

A step loop with timers, metrics logging, eval and save intervals, SIGTERM
checkpoint-and-exit, exit-on-duration, NaN-step counting, a parameter hash,
a batch-size ramp, and a profiler window. The JAX package traces with
`jax.profiler`; here `torch.profiler` records the window (CPU and, on a card,
CUDA activity) and writes a chrome trace into `profile_dir`, which carries
the step's program spans (`train.*`, `model.*`; utils/timers.py::span).
`data_state` is any object with `to_dict()` (the data pipeline is not in the
port yet).

Under a device mesh every rank runs the loop; the caller gives the logger
to the primary alone, and `CheckpointManager.save` gathers on every rank and
writes on the primary.
"""

from __future__ import annotations

import hashlib
import os
import signal
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from leopard_tpu_torch.config import TrainConfig, VLMConfig
from leopard_tpu_torch.training.checkpoint import CheckpointManager
from leopard_tpu_torch.training.trainer import TrainState
from leopard_tpu_torch.utils.timers import (
    MetricsLogger, StepTimeTracker, Timers, clear_spans, sync,
)

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_PROFILE_DIR = os.path.join(PACKAGE_ROOT, "build", "profile")


class SignalState:
    """SIGTERM → checkpoint-and-exit."""

    def __init__(self):
        self.triggered = False

    def install(self):
        def handler(signum, frame):
            self.triggered = True

        signal.signal(signal.SIGTERM, handler)
        return self


class BatchRamp:
    """Global-batch-size ramp-up: the batch starts at `start` and grows by
    `increment` at equal sample intervals until it reaches
    `global_batch_size` after `ramp_samples` consumed samples."""

    def __init__(self, start: int, increment: int, ramp_samples: int,
                 global_batch_size: int):
        if increment <= 0 or start > global_batch_size:
            raise ValueError("the ramp needs increment > 0 and start <= global_batch_size")
        if (global_batch_size - start) % increment:
            raise ValueError("ramp span must be a multiple of the increment")
        self.start = start
        self.increment = increment
        self.global_batch_size = global_batch_size
        n_steps = (global_batch_size - start) // increment
        self.samples_per_increment = ramp_samples // n_steps if n_steps else ramp_samples

    def batch_size(self, consumed_samples: int) -> int:
        if self.samples_per_increment <= 0:
            return self.global_batch_size
        steps = consumed_samples // self.samples_per_increment
        return min(self.global_batch_size, self.start + steps * self.increment)

    def consumed_samples_at(self, step: int) -> int:
        """Samples consumed after `step` ramped steps, so that a resume
        continues the ramp where it left off."""
        consumed = 0
        for _ in range(step):
            consumed += self.batch_size(consumed)
        return consumed


def param_hash(params) -> str:
    """sha256 of every parameter's bytes in name order (a host copy; use
    sparingly)."""
    h = hashlib.sha256()
    for name in sorted(params):
        t = params[name]
        if type(t).__name__ == "DTensor":  # whole, gathered on every rank
            t = t.full_tensor()
        t = t.detach().to("cpu").contiguous()
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _profiler(profile_dir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    return torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(profile_dir),
    )


def train(
    cfg: VLMConfig,
    train_cfg: TrainConfig,
    state: TrainState,
    step_fn: Callable,                      # train_step(state, batch)
    batches: Iterable,                      # yields dict batches, or batch_size -> batch
    data_state=None,                        # any object with to_dict()
    ckpt: Optional[CheckpointManager] = None,
    logger: Optional[MetricsLogger] = None,
    eval_fn: Optional[Callable[[TrainState], dict]] = None,
    profile_steps: Optional[tuple[int, int]] = None,
    profile_dir: str = DEFAULT_PROFILE_DIR,
) -> TrainState:
    timers = Timers()
    tracker = StepTimeTracker()
    signals = SignalState().install()
    start_time = time.time()
    nan_iters = 0
    ramp = None
    if train_cfg.rampup_batch_size is not None:
        if not callable(batches):
            raise ValueError("rampup_batch_size needs `batches` as a callable batch_size -> batch")
        ramp = BatchRamp(*train_cfg.rampup_batch_size,
                         global_batch_size=train_cfg.global_batch_size)
    if not callable(batches):
        next_batch = iter(batches).__next__
        fetch = lambda bs: next_batch()  # noqa: E731
    else:
        fetch = batches
    device = next(iter(state.params.values())).device
    prof = None

    step = int(state.step)
    consumed_samples = (
        ramp.consumed_samples_at(step) if ramp else step * train_cfg.global_batch_size
    )
    while step < train_cfg.train_steps:
        if profile_steps and step == profile_steps[0]:
            clear_spans()  # the window's spans alone, not an earlier session's
            prof = _profiler(profile_dir)
            prof.start()

        cur_bs = ramp.batch_size(consumed_samples) if ramp else train_cfg.global_batch_size
        with timers("data"):
            batch = fetch(cur_bs)
            if hasattr(batch, "as_dict"):
                batch = batch.as_dict()
        consumed_samples += cur_bs

        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        sync(device)
        step_time = time.perf_counter() - t0
        tracker.record(step_time)
        step = int(state.step)

        if prof is not None and step == profile_steps[1]:
            sync(device)
            prof.stop()
            prof = None

        if bool(metrics.get("nan_step", False)):
            nan_iters += 1

        if logger and step % train_cfg.log_interval == 0:
            row = {
                "loss": metrics["loss"],
                "grad_norm": metrics["grad_norm"],
                "tokens_in_loss": metrics["tokens_in_loss"],
                "step_time": step_time,
                "data_time": timers.elapsed("data", reset=True),
                "nan_iters": nan_iters,
                "batch_size": cur_bs,
                "consumed_samples": consumed_samples,
            }
            row.update(tracker.report())
            logger.log(step, row)

        if train_cfg.check_param_hash_interval and step % train_cfg.check_param_hash_interval == 0:
            digest = param_hash(state.params)  # a collective under a mesh
            if logger:
                logger.log(step, {"param_hash": digest})

        if eval_fn and train_cfg.eval_interval and step % train_cfg.eval_interval == 0:
            eval_metrics = eval_fn(state)
            if logger and eval_metrics:
                logger.log(step, {f"eval/{k}": v for k, v in eval_metrics.items()})

        should_save = ckpt is not None and train_cfg.save_interval and step % train_cfg.save_interval == 0
        exit_now = signals.triggered or (
            train_cfg.exit_duration_mins
            and (time.time() - start_time) / 60 > train_cfg.exit_duration_mins
        )
        if ckpt is not None and (should_save or exit_now):
            ckpt.save(step, state, data_state=data_state.to_dict() if data_state else None)
        if exit_now:
            break

    if prof is not None:
        prof.stop()
    if ckpt is not None:
        ckpt.wait_until_finished()
    return state


def evaluate_loss(
    state: TrainState,
    loss_fn: Callable,                # (params, batch) → (loss, aux)
    batches: Iterable,
    max_batches: int = 50,
) -> dict:
    """Validation loss and perplexity."""
    losses = []
    with torch.no_grad():
        for i, batch in enumerate(batches):
            if i >= max_batches:
                break
            if hasattr(batch, "as_dict"):
                batch = batch.as_dict()
            loss, _ = loss_fn(state.params, batch)
            losses.append(float(loss))
    if not losses:
        return {}
    mean = float(np.mean(losses))
    return {"loss": mean, "ppl": float(np.exp(min(mean, 20.0)))}
