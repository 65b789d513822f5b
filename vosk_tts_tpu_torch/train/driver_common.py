"""Shared pieces of the port's training drivers (vosk_tts_tpu/train/
driver_common.py): the batch on the device, resume from the latest full
state, and the metrics line of the log."""

from __future__ import annotations

import logging

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
