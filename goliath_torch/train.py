"""Training harness (port of the JAX package's train.py).

One train step (forward -> ModularLoss -> backward -> NaN/Inf gradient
scrub -> global-norm clip 1.0 -> Adam update, the last three inside
``goliath_torch.optim.ChainedOptimizer``), wrapped by a host-side loop with
loss-explosion detection and rollback to the last checkpoint, periodic
scalar/image logging, and ``.pt`` checkpoints (``latest`` +
``{iteration:06d}.pt``). Resuming and rolling back read the port's
checkpoints or the JAX package's orbax ones
(``goliath_torch.convert.load_checkpoint``).

The loss scalar is read with a one-step lag, so the explosion check does
not make the host wait for the step it has just queued on the card; a
rollback therefore happens at most one step late, which the checkpoint
granularity makes irrelevant. PyTorch updates parameters in place, so the
step that ran while the explosion was detected is undone by the same
reload.
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from goliath_torch.convert import load_checkpoint, opt_state_from_jax
from goliath_torch.test import to_device

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# checkpointing (.pt files)
# ---------------------------------------------------------------------------


def save_checkpoint(ckpt_dir: str, state: Dict[str, Any],
                    iteration: Optional[int] = None) -> None:
    """Writes ckpt_dir/{iteration:06d}.pt and updates ckpt_dir/latest.

    ``state`` holds the model's ``state_dict`` under "model" and the
    optimizer's under "optimizer"."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"{iteration:06d}.pt" if iteration is not None else "final.pt"
    state = dict(state)
    if iteration is not None:
        state["iteration"] = iteration
    torch.save(state, os.path.join(ckpt_dir, name))
    with open(os.path.join(ckpt_dir, "latest"), "w") as f:
        f.write(name)


def has_checkpoint(ckpt_dir: str) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, "latest"))


def _train_state(model, optimizer) -> Dict[str, Any]:
    return {"model": model.module.state_dict(),
            "optimizer": optimizer.state_dict()}


def restore_train_state(model, optimizer, restored: Mapping[str, Any]) -> int:
    """Load a checkpoint's model and optimizer state in place (what
    ``load_checkpoint`` read: the port's train state, or the JAX package's
    with Adam's moments under ``adam``); returns its iteration (0 when it
    has none)."""
    model.module.load_state_dict(restored["model"], strict=True)
    if "adam" in restored:
        opt_state_from_jax(optimizer, model.module, **restored["adam"])
    else:
        optimizer.load_state_dict(restored["optimizer"])
    return int(restored.get("iteration", 0))


# ---------------------------------------------------------------------------
# logging
# ---------------------------------------------------------------------------


class SummaryWriterish:
    """Scalars to ``scalars.jsonl``; scalars and images also to TensorBoard
    where ``torch.utils.tensorboard`` can be imported."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # the tensorboard package is optional
            self._tb = None
        else:
            self._tb = SummaryWriter(log_dir=log_dir)

    def add_scalar(self, tag: str, value: float, global_step: int) -> None:
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(global_step)}
        ) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, global_step=global_step)

    def add_image(self, tag: str, img: np.ndarray, global_step: int) -> None:
        if self._tb is not None:
            self._tb.add_image(tag, img, global_step=global_step)

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def process_losses(loss_dict: Mapping[str, Any]) -> Dict[str, float]:
    return {k: float(v.detach().float().mean()) for k, v in loss_dict.items()
            if v.numel() == 1 or v.dim() <= 1}


# ---------------------------------------------------------------------------
# train step + loop
# ---------------------------------------------------------------------------


def make_train_step(model, loss_fn, optimizer) -> Callable:
    """Returns step(batch, iteration) -> (total, loss dict), which updates
    the model's parameters and the optimizer's state in place. The training
    draws (encoder noise, backlit direction) come from the model's
    generator unless the batch carries ``noise`` / ``light_dir``."""

    def step(batch: Dict[str, torch.Tensor], iteration: int
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        optimizer.zero_grad()
        preds = model.apply(batch, train=True)
        total, ldict = loss_fn(preds, batch, iteration)
        total.backward()
        optimizer.step()
        return total.detach(), {k: v.detach() for k, v in ldict.items()}

    return step


def train(
    model,
    loss_fn,
    optimizer,
    train_data: Iterator,
    config: Mapping[str, Any],
    train_writer: Optional[SummaryWriterish] = None,
    summary_fn: Optional[Callable] = None,
    batch_filter_fn: Optional[Callable] = None,
    saving_enabled: bool = True,
    logging_enabled: bool = True,
    summary_enabled: bool = True,
    iteration: int = 0,
) -> Tuple[int, Dict[str, float]]:
    """Host loop around the train step. The model and the optimizer are
    updated in place. Returns (iteration, losses of the last step)."""
    tcfg = config["train"]
    ckpt_dir = tcfg.get("ckpt_dir", "checkpoints")
    device = model.device
    step_fn = make_train_step(model, loss_fn, optimizer)

    loss_history: deque = deque(maxlen=32)
    pending = None  # (iteration, loss on the device) for the lagged check
    ldict: Dict[str, torch.Tensor] = {}

    # train.profile = {dir, start_step, n_steps}: a torch.profiler trace of
    # that window; steps per second are always tracked and logged as
    # Perf/steps_per_sec
    pcfg = tcfg.get("profile") or {}
    prof_start = int(pcfg.get("start_step", -1))
    prof_n = int(pcfg.get("n_steps", 5))
    prof = None
    t_window = time.time()
    it_window = iteration

    def stop_profile():
        prof.stop()
        prof_dir = pcfg.get("dir", "profile")
        os.makedirs(prof_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(prof_dir, "trace.json"))

    for batch in train_data:
        if batch is None:
            logger.info("skipping empty batch")
            continue
        if batch_filter_fn is not None:
            batch = batch_filter_fn(batch)
        tb = to_device(batch, device)

        if prof_start >= 0 and iteration == prof_start and prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        if prof is not None and iteration >= prof_start + prof_n:
            stop_profile()
            prof = None
            prof_start = -1

        total, ldict = step_fn(tb, iteration)

        # lagged explosion check on the *previous* step's loss
        exploded = False
        if pending is not None:
            prev_it, prev_loss = pending
            prev_val = float(prev_loss)
            mean_hist = (sum(loss_history) / len(loss_history)
                         if loss_history else np.inf)
            if not np.isfinite(prev_val) or prev_val > 10 * mean_hist:
                exploded = True
                logger.info(
                    f"explosion detected: iter={prev_it}: loss={prev_val}")
            else:
                loss_history.append(prev_val)
        pending = (iteration, total)

        if exploded and has_checkpoint(ckpt_dir):
            # resume from the checkpointed iteration so schedule-gated
            # losses re-run the rolled-back steps
            iteration = restore_train_state(
                model, optimizer, load_checkpoint(ckpt_dir,
                                                  map_location=device))
            loss_history.clear()
            pending = None
            continue

        if logging_enabled and iteration % tcfg["log_every_n_steps"] == 0:
            _ld = process_losses(ldict)
            loss_str = " ".join(f"{k}={v:.4f}" for k, v in _ld.items())
            logger.info(f"iter={iteration}: {loss_str}")
            now = time.time()
            if iteration > it_window and now > t_window:
                sps = (iteration - it_window) / (now - t_window)
                logger.info(f"perf: {sps:.3f} steps/s")
                if train_writer is not None:
                    train_writer.add_scalar("Perf/steps_per_sec", sps,
                                            iteration)
            t_window, it_window = now, iteration
            if train_writer is not None:
                for name, value in _ld.items():
                    train_writer.add_scalar(f"Losses/{name}", value, iteration)
                train_writer.flush()

        if (summary_enabled and summary_fn is not None
                and train_writer is not None
                and iteration % tcfg["summary_every_n_steps"] == 0):
            with torch.no_grad():
                preds = model.apply(tb, train=False)
            for name, value in summary_fn(preds, tb).items():
                img = np.asarray(value)
                if img.ndim == 4:
                    img = img[0]
                train_writer.add_image(f"Images/{name}", img, iteration)

        if saving_enabled and iteration % tcfg["ckpt_every_n_steps"] == 0:
            save_checkpoint(ckpt_dir, _train_state(model, optimizer),
                            iteration=iteration)

        iteration += 1
        if iteration >= tcfg["n_max_iters"]:
            logger.info(f"reached max iters ({tcfg['n_max_iters']})")
            break

    if prof is not None:
        stop_profile()
    if saving_enabled:
        save_checkpoint(ckpt_dir, _train_state(model, optimizer),
                        iteration=iteration)
    return iteration, process_losses(ldict)
