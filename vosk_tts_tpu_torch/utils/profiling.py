"""Tracing and timing on the card (vosk_tts_tpu/utils/profiling.py).

  * ``trace(log_dir)``: a context manager around ``torch.profiler`` over the
    CPU and (where present) CUDA activities, writing a Chrome trace file of
    the host and device timeline under ``log_dir``;
  * ``StageTimer``: named wall-clock stages, synchronised with the card
    before the clock reads where ``sync=`` is given, with audio seconds per
    second and RTF;
  * ``device_timeit``: per-iteration time of a carry -> carry function from
    the slope between two iteration counts (CUDA events on the card, the
    host clock for CPU tensors);
  * ``device_stats()``: the caching allocator's bytes in use and peak, per
    CUDA device.
"""

from __future__ import annotations

import contextlib
import logging
import os
import statistics
import time

import torch

log = logging.getLogger("vosk_tts_tpu_torch.profiling")


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; writes ``log_dir/trace_<pid>_<ns>.json`` (a
    Chrome trace, which TensorBoard and Perfetto open) when it ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    return []


def _synchronize(sync) -> None:
    """Wait for ``sync``: a CUDA stream, or a tensor (or nested lists,
    tuples and dicts of them) whose devices are synchronised."""
    if isinstance(sync, torch.cuda.Stream):
        sync.synchronize()
        return
    for dev in {t.device for t in _tensors(sync) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulates wall-clock per named stage; reports RTF-style summaries."""

    def __init__(self, sample_rate: int = 22050):
        self.sample_rate = sample_rate
        self.stages: dict[str, float] = {}
        self.samples = 0

    @contextlib.contextmanager
    def stage(self, name: str, *, sync=None):
        """Time the block; with ``sync`` (a tensor or a stream) the card
        finishes its work on it before the clock reads."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync)
            self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

    def add_audio(self, n_samples: int):
        self.samples += n_samples

    def report(self) -> dict:
        total = sum(self.stages.values())
        audio_sec = self.samples / self.sample_rate
        out = {
            "stages_sec": dict(self.stages),
            "total_sec": total,
            "audio_sec": audio_sec,
            "rtf": total / audio_sec if audio_sec else None,
            "audio_sec_per_sec": audio_sec / total if total else None,
        }
        log.info("profile: %s", out)
        return out


def device_timeit(fn, carry0, *, n1: int = 4, n2: int = 20, reps: int = 5):
    """Per-iteration time of ``fn`` (carry -> carry; a tensor or nested
    lists, tuples and dicts of tensors), without autograd.

    Runs ``fn`` n1 times, then n2 times, each run from ``carry0`` with its
    final carry reduced to one scalar (the sum of its leaves in f32), so
    that every iteration is needed; times each run between CUDA events
    where the carry lies on the card, else by the host clock; and takes the
    slope (t2 - t1) / (n2 - n1) of the medians over ``reps``, which cancels
    the fixed cost of a run. One run of each count warms up first.

    Returns (seconds_per_iteration, t_n1_median, t_n2_median), in seconds.
    """
    on_card = any(t.is_cuda for t in _tensors(carry0))

    def run(n):
        c = carry0
        for _ in range(n):
            c = fn(c)
        return sum(t.float().sum() for t in _tensors(c))

    def timed(n):
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            float(run(n))
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        float(run(n))
        return time.perf_counter() - t0

    with torch.no_grad():
        float(run(n1))
        float(run(n2))
        t1s, t2s = [], []
        for _ in range(reps):
            t1s.append(timed(n1))
            t2s.append(timed(n2))
    t1, t2 = statistics.median(t1s), statistics.median(t2s)
    return (t2 - t1) / (n2 - n1), t1, t2


def device_stats() -> list[dict]:
    """One dict per CUDA device (none without CUDA): ``bytes_in_use`` and
    ``peak_bytes_in_use`` of the caching allocator (torch.cuda.memory_stats)."""
    out = []
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        s = torch.cuda.memory_stats(i)
        out.append({"device": f"cuda:{i}", "bytes_in_use": s.get("allocated_bytes.all.current", 0),
                    "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0)})
    return out
