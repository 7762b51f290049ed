"""Epoch-based finetuning loop (port of leopard_tpu/training/finetune.py): a
fixed number of epochs over a finite dataset with per-epoch eval,
best-checkpoint tracking and early stopping, over the same train step as the
step-based loop (training/loop.py)."""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional

import numpy as np

from leopard_tpu_torch.config import TrainConfig, VLMConfig
from leopard_tpu_torch.training.checkpoint import CheckpointManager
from leopard_tpu_torch.training.trainer import TrainState
from leopard_tpu_torch.utils.timers import MetricsLogger


def finetune(
    cfg: VLMConfig,
    train_cfg: TrainConfig,
    state: TrainState,
    step_fn: Callable,
    epoch_batches: Callable[[int], Iterable],   # epoch → iterable of batches
    num_epochs: int,
    eval_fn: Optional[Callable[[TrainState], dict]] = None,
    ckpt: Optional[CheckpointManager] = None,
    logger: Optional[MetricsLogger] = None,
    early_stop_patience: int = 0,   # epochs without eval-loss improvement
) -> TrainState:
    best_eval = float("inf")
    stale_epochs = 0
    for epoch in range(num_epochs):
        t0 = time.time()
        losses = []
        for batch in epoch_batches(epoch):
            if hasattr(batch, "as_dict"):
                batch = batch.as_dict()
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            if logger and int(state.step) % train_cfg.log_interval == 0:
                logger.log(int(state.step), {
                    "epoch": epoch, "loss": metrics["loss"],
                    "grad_norm": metrics["grad_norm"],
                })
        epoch_loss = float(np.mean(losses)) if losses else float("nan")
        row = {"epoch": epoch, "epoch_loss": epoch_loss, "epoch_time": time.time() - t0}

        if eval_fn is not None:
            eval_metrics = eval_fn(state)
            row.update({f"eval/{k}": v for k, v in eval_metrics.items()})
            eval_loss = eval_metrics.get("loss", epoch_loss)
            if eval_loss < best_eval:
                best_eval = eval_loss
                stale_epochs = 0
                if ckpt is not None:
                    ckpt.save(int(state.step), state)
            else:
                stale_epochs += 1
        elif ckpt is not None:
            ckpt.save(int(state.step), state)

        if logger:
            logger.log(int(state.step), row)
        if early_stop_patience and stale_epochs >= early_stop_patience:
            break

    if ckpt is not None:
        ckpt.wait_until_finished()
    return state
