"""Shared pieces of the port's training drivers (vosk_tts_tpu/train/
driver_common.py): the batch on the device, the epoch loop with its log
lines and ``STATE_{step}.pt`` saves, resume from the latest full state, and
the metrics line of the log."""

from __future__ import annotations

import logging
import time

import torch

from ..utils import checkpoint as ckpt

log = logging.getLogger("vosk_tts_tpu_torch.train")


def to_device(batch: dict, device) -> dict:
    """A collated numpy batch as tensors on ``device`` (ids and lengths int64)."""
    out = {}
    for k, a in batch.items():
        t = torch.from_numpy(a)
        out[k] = (t.long() if k in ("x", "sid") else t).to(device, non_blocking=True)
    return out


def save_state(model_dir: str, state, epoch: int) -> None:
    """``STATE_{step}.pt``: the whole training state and the epoch."""
    ckpt.save_full_state(model_dir, "STATE", state.step, {**state.state_dict(), "epoch": epoch})
    log.info("saved checkpoint at step %d", state.step)


def train_loop(*, model_dir: str, state, step_fn, batcher, epochs: int, device,
               start_epoch: int = 0, log_interval: int = 100, save_interval: int = 1000,
               max_steps: int | None = None, generator=None, save=save_state, set_lr=None,
               after_step=None) -> dict:
    """The epoch loop of every driver: ``set_lr(state, epoch)`` at each
    epoch's start where given; for each batch of ``batcher.epoch(epoch)``
    one ``step_fn(state, batch, generator=)`` (which advances
    ``state.step``), then ``after_step(state)`` where given, a log line every
    ``log_interval`` steps and ``save(model_dir, state, epoch)`` every
    ``save_interval``; a final save at the end, or once ``state.step``
    reaches ``max_steps`` (with the epoch it was in). Returns the last
    step's metrics as floats (empty where no step ran)."""
    cut = max_steps is not None and state.step >= max_steps
    epoch, metrics = start_epoch, {}
    for epoch in range(start_epoch, epochs):
        if cut:
            break
        if set_lr is not None:
            set_lr(state, epoch)
        t_epoch = time.time()
        for batch in batcher.epoch(epoch):
            metrics = step_fn(state, to_device(batch, device), generator=generator)
            if after_step is not None:
                after_step(state)
            if state.step % log_interval == 0:
                log.info("epoch %d step %d %s", epoch, state.step, format_metrics(metrics))
            if state.step % save_interval == 0:
                save(model_dir, state, epoch)
            cut = max_steps is not None and state.step >= max_steps
            if cut:
                break
        log.info("epoch %d done in %.1f s", epoch, time.time() - t_epoch)
        if cut:
            break
    else:
        epoch = epochs
    save(model_dir, state, epoch)
    return format_metrics(metrics) if metrics else {}


def resume_state(model_dir: str, state) -> int | None:
    """Load the latest ``STATE_*.pt`` of ``model_dir`` into ``state`` (a
    TrainState); returns the epoch to start from, or None where there is no
    checkpoint."""
    saved = ckpt.load_full_state(model_dir, "STATE", map_location=next(
        iter(state.params.values())).device)
    if saved is None:
        return None
    state.load_state_dict(saved)
    log.info("resumed from step %d epoch %d", state.step, saved["epoch"])
    return int(saved["epoch"])


def format_metrics(metrics: dict) -> dict:
    """Host floats of a step's metrics (one synchronisation)."""
    values = torch.stack([v.float() for v in metrics.values()]).cpu().tolist()
    return {k: round(v, 4) for k, v in zip(metrics, values)}
