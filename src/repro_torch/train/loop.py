"""The training loop, the port of ``repro.train.loop``: auto-resume,
async checkpoints, a straggler watchdog, optional int8 gradient
compression and microbatch accumulation, on one device.

``loss_fn(params, batch)`` returns a scalar tensor; ``params`` is a
module or a tree of tensors, and is trained in place (``tree.trainable``
makes its leaves require grad). Gradients come from
``torch.autograd.grad`` on the parameters, never from ``.grad``: with
several microbatches each one's gradients are added into float32
buffers, as the reference's scan adds them into float32 zeros, and not
in the parameters' bf16.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch.obs import trace
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.compression import compress_decompress, init_error_feedback
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state
from repro_torch.train.tree import copy_into, leaves, like, trainable

log = logging.getLogger("repro_torch.train")


@dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str | None = None
    keep_checkpoints: int = 3
    log_every: int = 10
    # straggler watchdog: warn when a step exceeds factor x EMA
    watchdog_factor: float = 3.0
    grad_compression: bool = False
    num_microbatches: int = 1


def microbatch(batch: dict, i: int, n: int) -> dict:
    """The ``i``-th of ``n`` equal slices of the leading axis of every
    array (tensor or numpy) in ``batch``; other values as they are."""
    def cut(x):
        if isinstance(x, (torch.Tensor, np.ndarray)):
            size = x.shape[0] // n
            return x[i * size:(i + 1) * size]
        return x

    return {key: cut(x) for key, x in batch.items()}


def value_and_grads(loss_fn: Callable, params, batch, num_microbatches: int = 1):
    """``(loss, grads)``: ``loss_fn(params, batch)`` (detached) and the
    gradient of each leaf of ``params`` (``tree.leaves`` order), which
    must require grad. With ``num_microbatches`` > 1, the means over
    equal slices of the batch's leading axis, the gradients summed in
    float32."""
    if num_microbatches == 1:
        loss = loss_fn(params, batch)
        return loss.detach(), list(torch.autograd.grad(loss, leaves(params)))
    loss_acc = None
    grad_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves(params)]
    for i in range(num_microbatches):
        loss, grads = value_and_grads(loss_fn, params,
                                      microbatch(batch, i, num_microbatches))
        loss_acc = loss.float() if loss_acc is None else loss_acc + loss
        for acc, g in zip(grad_acc, grads):
            acc.add_(g)
    scale = 1.0 / num_microbatches
    return loss_acc * scale, [g * scale for g in grad_acc]


def make_train_step(
    loss_fn: Callable,
    opt_cfg: AdamWConfig,
    *,
    num_microbatches: int = 1,
    grad_compression: bool = False,
):
    """Build a ``(params, opt_state, ef, batch) -> (params, opt_state, ef,
    metrics)`` step with optional gradient accumulation over
    ``num_microbatches`` slices of the batch's leading axis (the loss and
    the gradients are their means; ``value_and_grads``)."""

    def step(params, opt_state, ef, batch):
        trainable(params)
        loss, grads = value_and_grads(loss_fn, params, batch, num_microbatches)
        grads = like(params, grads)
        if grad_compression:
            grads, ef = compress_decompress(grads, ef)
        params, opt_state, metrics = adamw_update(grads, opt_state, params, opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, ef, metrics

    return step


class StragglerWatchdog:
    """EMA step-time monitor. On a real fleet this feeds the coordinator's
    slow-host eviction; here it records and warns."""

    def __init__(self, factor: float = 3.0, alpha: float = 0.2):
        self.factor = factor
        self.alpha = alpha
        self.ema: float | None = None
        self.slow_steps: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        slow = self.ema is not None and dt > self.factor * self.ema
        if slow:
            self.slow_steps.append((step, dt))
            log.warning("straggler: step %d took %.3fs (ema %.3fs)", step, dt, self.ema)
        self.ema = dt if self.ema is None else (1 - self.alpha) * self.ema + self.alpha * dt
        return slow


def train(
    params,
    loss_fn: Callable,
    data_iter: Iterator[Any],
    opt_cfg: AdamWConfig,
    loop_cfg: LoopConfig,
) -> tuple[Any, dict]:
    """Run the loop; auto-resumes from the newest checkpoint if present.
    ``params`` is trained in place and returned."""
    opt_state = init_opt_state(params, opt_cfg)
    ef = init_error_feedback(params) if loop_cfg.grad_compression else None
    step_fn = make_train_step(
        loss_fn,
        opt_cfg,
        num_microbatches=loop_cfg.num_microbatches,
        grad_compression=loop_cfg.grad_compression,
    )

    mgr = None
    start_step = 0
    if loop_cfg.checkpoint_dir:
        mgr = CheckpointManager(loop_cfg.checkpoint_dir, keep=loop_cfg.keep_checkpoints)
        latest = mgr.latest_step()
        if latest is not None:
            state = {"params": params, "opt_state": opt_state}
            copy_into(state, mgr.restore(latest, state))
            start_step = latest
            log.info("resumed from checkpoint step %d", latest)

    watchdog = StragglerWatchdog(loop_cfg.watchdog_factor)
    history: list[dict] = []
    for step in range(start_step, loop_cfg.total_steps):
        batch = next(data_iter)
        # timer=True: the span times (and waits for the card, device=True)
        # even with tracing off -- the straggler watchdog needs dt always.
        with trace.span("train.step", device=True, timer=True, step=step) as sp:
            params, opt_state, ef, metrics = step_fn(params, opt_state, ef, batch)
            sp.block_on(metrics["loss"])
        dt = sp.duration
        # The span's close already waited for the card; reading the
        # scalar afterwards is free.
        loss = float(metrics["loss"])  # repro-lint: disable=host-sync
        watchdog.observe(step, dt)
        if step % loop_cfg.log_every == 0:
            log.info("step %d loss %.4f (%.3fs)", step, loss, dt)
        history.append({"step": step, "loss": loss, "dt": dt})
        if mgr and (step + 1) % loop_cfg.checkpoint_every == 0:
            mgr.save(step + 1, {"params": params, "opt_state": opt_state})
    if mgr:
        mgr.save(loop_cfg.total_steps, {"params": params, "opt_state": opt_state},
                 blocking=True)
    return params, {
        "history": history,
        "slow_steps": watchdog.slow_steps,
        "final_loss": history[-1]["loss"] if history else None,
    }
