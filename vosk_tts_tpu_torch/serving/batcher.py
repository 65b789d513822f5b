"""Dynamic request batcher: batched synthesis for every bundle kind the port
loads (plain ``vits2`` and ``multistream_v1/v2/v3``), the port of
vosk_tts_tpu/serving/batcher.py.

Concurrent requests are collected for up to ``max_wait_ms``, padded into
one batch at the text bucket of the longest, and synthesized in one pass on
the model's device by a worker thread; each caller's future gets its own
trimmed int16 waveform. The geometry is the JAX package's, so that both
packages run the same shapes: the batch is padded to a power of two capped
at ``max_batch`` (pad rows have ``x_lengths = 1`` and zero ids), and the
duration-adaptive split runs pass one once, then decodes in at most two
groups by predicted frames (``split_decode_groups``), each group padded to
a power of two by repeating its first row.

Per-request knobs (speech rate, noise, duration noise) ride as (B, 1, 1)
tensors, so co-batched requests keep their own: a request at rate 2.0
batched with one at 1.0 comes back twice as fast.

Threads: ``torch.inference_mode`` and the current CUDA device are
per-thread state, so the worker enters both itself, and so does
``submit_text`` around the BERT front of multistream bundles, which runs in
the caller's thread. One ``torch.Generator`` on the model's device draws
every batch's noise and is used by the worker thread only. An exception in
a batch is set on every future of that batch; nothing retries, and nothing
falls back to the CPU.

This module imports neither grpc nor protobuf.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import api
from ..api import (FRAMES_PER_TOKEN, MS_FRAMES_CAP, MS_FRAMES_PER_TOKEN, TEXT_BUCKETS,
                   audio_float_to_int16, pick_frame_bucket, pick_gen_frames,
                   pick_ms_frame_bucket)


def split_decode_groups(preds, text_bucket: int, *, multistream: bool = False):
    """Partition a mixed batch into at most TWO decode groups by predicted
    frame count, so a short utterance co-batched with a long one does not
    pay the long one's frame bucket.

    ``preds``: per-item predicted frames. Returns a list of ``(indices,
    frame_bucket, gen_frames)``; the split point minimizes the total decoded
    generator frames (items x gen per group), and a split is taken only
    when it reduces that cost. ``multistream``: the StableTTS frame-bucket
    picker (mel frames, 48 a token cap); the ODE runs at the full bucket, so
    gen is always None and the cost is the bucket."""
    n = len(preds)
    order = sorted(range(n), key=lambda i: preds[i])

    def group_cost(idx):
        mx = max(preds[i] for i in idx)
        if multistream:
            fb = pick_ms_frame_bucket(int(mx), text_bucket)
            return fb, fb, None
        fb = pick_frame_bucket(int(mx), text_bucket)
        gen = pick_gen_frames(int(mx), fb)
        return fb if gen is None else gen, fb, gen

    best = None
    for cut in range(1, n):  # split the sorted order into [:cut] / [cut:]
        g1, g2 = order[:cut], order[cut:]
        c1, fb1, gen1 = group_cost(g1)
        c2, fb2, gen2 = group_cost(g2)
        if fb1 == fb2 and gen1 == gen2:
            continue
        cost = len(g1) * c1 + len(g2) * c2
        if best is None or cost < best[0]:
            best = (cost, [(g1, fb1, gen1), (g2, fb2, gen2)])
    c_all, fb_all, gen_all = group_cost(order)
    if best is not None and best[0] < n * c_all:
        return best[1]
    return [(order, fb_all, gen_all)]


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


@dataclass
class _Item:
    # plain bundles: ids; multistream bundles: tuples/bert/extras
    ids: list | None
    tuples: np.ndarray | None
    bert: np.ndarray | None
    extras: np.ndarray | None
    sid: int
    speech_rate: float
    noise_level: float
    duration_noise_level: float
    future: Future = field(default_factory=Future)

    @property
    def length(self) -> int:
        return len(self.ids) if self.ids is not None else len(self.tuples)


class BatchSynthesizer:
    """Batches text requests onto the model's device. ``submit_text`` and
    ``submit`` are thread-safe; ``close`` stops the worker."""

    def __init__(self, model, max_batch: int = 8, max_wait_ms: float = 5.0):
        self.model = model
        self.multistream = model.model_type in api.MULTISTREAM_TYPES
        # the device the weights live on, with its index (model.device may be
        # a bare "cuda", which each thread would read as its current device)
        self.device = (model.matcha if self.multistream else model.synthesizer).device
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self._q: queue.Queue = queue.Queue()
        self._cache = {}
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(0)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def _on_device(self):
        """inference_mode and the model's CUDA device for the calling thread."""
        ctx = contextlib.ExitStack()
        ctx.enter_context(torch.inference_mode())
        if self.device.type == "cuda":
            ctx.enter_context(torch.cuda.device(self.device))
        return ctx

    def submit_text(self, text: str, sid=0, speech_rate=None, noise_level=None,
                    duration_noise_level=None) -> Future:
        """Encode per the bundle's model_type (Synth.synth_audio's dispatch;
        for multistream bundles the BERT front runs here, in the caller's
        thread) and queue for batched synthesis."""
        inference = self.model.config.get("inference", {})
        if speech_rate in (None, 0.0):
            speech_rate = inference.get("speech_rate", 1.0)
        noise_level = inference.get("noise_level", 0.8) if noise_level is None else noise_level
        duration_noise_level = (inference.get("duration_noise_level", 0.8)
                                if duration_noise_level is None else duration_noise_level)
        if self.multistream:
            with self._on_device():
                tuples, embs, extras = api.encode_multistream(self.model, text)
            item = _Item(None, np.asarray(tuples, np.int64),
                         None if embs is None else np.asarray(embs, np.float32),
                         None if extras is None else np.asarray(extras, np.float32),
                         int(sid or 0), speech_rate, noise_level, duration_noise_level)
        else:
            item = _Item(list(api.encode_plain(self.model, text)), None, None, None,
                         int(sid or 0), speech_rate, noise_level, duration_noise_level)
        self._q.put(item)
        return item.future

    def submit(self, ids, sid=0, speech_rate=1.0, noise_level=0.8,
               duration_noise_level=0.8) -> Future:
        """Pre-encoded plain-id submission (for direct callers)."""
        item = _Item(list(ids), None, None, None, int(sid or 0), speech_rate, noise_level,
                     duration_noise_level)
        self._q.put(item)
        return item.future

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)

    # ------------------------------------------------------------------
    @property
    def _n_timesteps(self) -> int:
        return int(self.model.config.get("inference", {}).get("n_timesteps", 10))

    def _runner(self, bucket: int, max_frames: int | None = None):
        if self.multistream:
            key = ("ms", bucket)
            if key not in self._cache:
                cap = min(bucket * MS_FRAMES_PER_TOKEN, MS_FRAMES_CAP)
                self._cache[key] = api.make_multistream_runner(self.model, cap, self._n_timesteps)
        else:
            if max_frames is None:
                max_frames = bucket * FRAMES_PER_TOKEN
            key = (bucket, max_frames)
            if key not in self._cache:
                self._cache[key] = api.make_vits2_runner(self.model, max_frames)
        return self._cache[key]

    def _encode_runner(self):
        if "encode" not in self._cache:
            self._cache["encode"] = api.make_vits2_encode_runner(self.model)
        return self._cache["encode"]

    def _decode_runner(self, bucket: int, max_frames: int, gen_frames: int | None = None):
        key = ("decode", bucket, max_frames, gen_frames)
        if key not in self._cache:
            self._cache[key] = api.make_vits2_decode_runner(self.model, max_frames, gen_frames)
        return self._cache[key]

    def _ms_encode_runner(self):
        if "ms_encode" not in self._cache:
            self._cache["ms_encode"] = api.make_multistream_encode_runner(self.model)
        return self._cache["ms_encode"]

    def _ms_decode_runner(self, bucket: int, max_frames: int):
        key = ("ms_decode", bucket, max_frames)
        if key not in self._cache:
            self._cache[key] = api.make_multistream_decode_runner(
                self.model, max_frames, self._n_timesteps)
        return self._cache[key]

    def _loop(self):
        with self._on_device():
            while not self._stop.is_set():
                try:
                    first = self._q.get(timeout=0.1)
                except queue.Empty:
                    continue
                items = [first]
                deadline = time.perf_counter() + self.max_wait
                while len(items) < self.max_batch:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    try:
                        items.append(self._q.get(timeout=remaining))
                    except queue.Empty:
                        break
                try:
                    self._run_batch(items)
                except Exception as e:  # surface the error to every waiter
                    for it in items:
                        if not it.future.done():
                            it.future.set_exception(e)

    # ------------------------------------------------------------------
    def _batch_geometry(self, items):
        """(text bucket of the longest item, batch rows: a power of two
        capped at max_batch, never fewer than the items)."""
        longest = max(it.length for it in items)
        bucket = next((b for b in TEXT_BUCKETS if b >= longest), TEXT_BUCKETS[-1])
        bsz = _pow2(len(items))
        return bucket, min(max(bsz, len(items)), max(self.max_batch, len(items)))

    def _scales(self, items, bsz):
        """Per-item knobs as (B, 1, 1) f32 tensors on the device: noise,
        1 / speech rate, duration noise (pad rows: 0.8, 1, 0.8)."""
        noise = np.full((bsz, 1, 1), 0.8, np.float32)
        inv_rate = np.ones((bsz, 1, 1), np.float32)
        dur_noise = np.full((bsz, 1, 1), 0.8, np.float32)
        for i, it in enumerate(items):
            noise[i] = it.noise_level
            inv_rate[i] = 1.0 / it.speech_rate
            dur_noise[i] = it.duration_noise_level
        return tuple(torch.as_tensor(a, device=self.device) for a in (noise, inv_rate, dur_noise))

    def _decode_groups(self, items, enc, bucket, decode):
        """Split the batch by pass one's predicted frames and decode each
        group: ``decode(rows, frame_bucket, gen_frames)`` gets the group's
        row indices (padded to a power of two by repeating the first) and
        returns (wav (rows, samples), lengths in samples); each group's
        wav and lengths come to the host once."""
        preds = enc["pred_frames"][: len(items)].cpu().numpy()
        groups = split_decode_groups([int(p) for p in preds], bucket,
                                     multistream=self.multistream)
        for idx, fb, gen in groups:
            rows = torch.as_tensor(idx + [idx[0]] * (_pow2(len(idx)) - len(idx)),
                                   dtype=torch.int64, device=self.device)
            wav, lengths = decode(rows, fb, gen)
            wavs, lengths = wav[: len(idx)].cpu().numpy(), lengths[: len(idx)].cpu().numpy()
            for j, i in enumerate(idx):
                items[i].future.set_result(audio_float_to_int16(wavs[j, : lengths[j]]))

    def _run_batch(self, items):
        bucket, bsz = self._batch_geometry(items)
        noise, inv_rate, dur_noise = self._scales(items, bsz)
        rng = self._generator
        dev = self.device
        adaptive = os.environ.get("VOSK_TTS_ADAPTIVE", "1") != "0"
        sid = np.zeros((bsz,), np.int64)
        x_lengths = np.ones((bsz,), np.int32)

        if self.multistream:
            hop = self.model.config.get("hop_length", 256)
            x = np.zeros((bsz, 5, bucket), np.int64)
            bert = np.zeros((bsz, bucket, self.model.model_config.bert_dim), np.float32)
            pde = np.zeros((bsz, bucket), np.float32)
            for i, it in enumerate(items):
                t = min(len(it.tuples), bucket)
                x[i, :, :t] = it.tuples[:t].T
                x_lengths[i] = t
                sid[i] = it.sid
                if it.bert is not None:
                    bert[i, :t] = it.bert[:t]
                if it.extras is not None:
                    pde[i, :t] = it.extras[:t]
            x, x_lengths, sid, bert, pde = (torch.as_tensor(a, device=dev)
                                            for a in (x, x_lengths, sid, bert, pde))
            if not adaptive:
                wav, mel_lengths = self._runner(bucket)(x, x_lengths, sid, bert, pde, rng,
                                                        noise, inv_rate, dur_noise)
                self._set_results(items, wav, mel_lengths * hop)
                return
            # duration-adaptive split: the text and duration encoders once,
            # then the CFM ODE + vocoder at the smallest frame bucket each
            # group needs
            enc = self._ms_encode_runner()(x, x_lengths, sid, bert, pde, inv_rate)

            def decode(rows, fb, _gen):
                wav, mel_lengths = self._ms_decode_runner(bucket, fb)(
                    {k: v.index_select(0, rows) for k, v in enc.items()},
                    sid.index_select(0, rows), rng, noise.index_select(0, rows))
                return wav, mel_lengths * hop

            self._decode_groups(items, enc, bucket, decode)
            return

        x = np.zeros((bsz, bucket), np.int64)
        for i, it in enumerate(items):
            ids = it.ids[:bucket]
            x[i, : len(ids)] = ids
            x_lengths[i] = len(ids)
            sid[i] = it.sid
        x, x_lengths, sid = (torch.as_tensor(a, device=dev) for a in (x, x_lengths, sid))
        if not adaptive:
            out = self._runner(bucket, bucket * FRAMES_PER_TOKEN)(x, x_lengths, sid, rng, noise,
                                                                  inv_rate, dur_noise)
            self._set_results(items, out["wav"][..., 0], out["wav_lengths"])
            return
        # duration-adaptive split: encoder + SDP once; only the predicted
        # frame counts come to the host, then pass one's outputs feed the
        # decode pass at the smallest bucket, in at most two groups
        enc = self._encode_runner()(x, x_lengths, sid, rng, inv_rate, dur_noise)

        def decode(rows, fb, gen):
            out = self._decode_runner(bucket, fb, gen)(
                {k: v.index_select(0, rows) for k, v in enc.items()},
                sid.index_select(0, rows), rng, noise.index_select(0, rows))
            return out["wav"][..., 0], out["wav_lengths"]

        self._decode_groups(items, enc, bucket, decode)

    @staticmethod
    def _set_results(items, wav, lengths):
        wavs, lengths = wav[: len(items)].cpu().numpy(), lengths[: len(items)].cpu().numpy()
        for i, it in enumerate(items):
            it.future.set_result(audio_float_to_int16(wavs[i, : lengths[i]]))
