"""Training data (vosk_tts_tpu/train/data.py): host-side numpy.

* metadata lines ``path|sid|text|cleaned`` (multi-speaker), ``path|sid|text``
  or ``path|text`` (sid 0);
* text modes: aligned (underscore-joined pre-aligned phones) or g2p (the
  rules of the port's ``text`` frontend); blanks interspersed optionally;
* the log-mel by the port's ``ops.stft.mel_spectrogram`` on the CPU,
  cached as ``.mel.npy`` beside the wav;
* length-bucketed batches with an epoch-seeded shuffle, each padded to a
  (text bucket, frame bucket) shape class, as in the JAX package (same
  buckets, so both see the same shapes).
"""

from __future__ import annotations

import os
import re
import wave as wave_mod
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..ops.commons import intersperse
from ..ops.stft import mel_spectrogram
from ..text import convert, plain_symbol_map

MIN_TEXT_LEN, MAX_TEXT_LEN = 1, 350
MAX_WAV_VALUE = 32768.0
TEXT_BUCKETS = (64, 128, 192, 256, 384, 512, 704)
FRAME_BUCKETS = (128, 256, 384, 512, 768, 1024)
# frame-length boundaries of the batcher's buckets (utterances outside are dropped)
BOUNDARIES = (32, 300, 400, 500, 600, 700, 800, 900, 1000)


@dataclass
class DataConfig:
    metadata: str = ""
    sampling_rate: int = 22050
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mel_channels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: float | None = None
    add_blank: bool = True
    text_mode: str = "aligned"  # aligned | g2p


_SPLIT = re.compile(r'([,.?!;:"() ])')


def text_to_ids_aligned(text: str, id_map: dict) -> list:
    """Words are underscore-joined phone strings."""
    phones = ["^"]
    for word in _SPLIT.split(text):
        if word == "":
            continue
        phones.extend(word.split("_") if "_" in word else [word])
    phones.append("$")
    return [id_map[p] for p in phones]


def text_to_ids_g2p(text: str, id_map: dict) -> list:
    phones = ["^"]
    for word in _SPLIT.split(text.lower()):
        if word == "":
            continue
        if _SPLIT.match(word) or word == "-":
            phones.append(word)
        else:
            phones.extend(convert(word).split())
    phones.append("$")
    return [id_map[p] for p in phones]


def load_wav(path: str) -> tuple[np.ndarray, int]:
    with wave_mod.open(path, "rb") as f:
        sr = f.getframerate()
        data = np.frombuffer(f.readframes(f.getnframes()), dtype=np.int16).astype(np.float32)
    return data, sr


class TTSDataset:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.id_map = plain_symbol_map()
        self.items, self.lengths = [], []
        with open(cfg.metadata, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("|")
                if len(parts) >= 4:
                    path, sid, text, cleaned = parts[0], int(parts[1]), parts[2], parts[3]
                elif len(parts) == 3:
                    path, sid, text, cleaned = parts[0], int(parts[1]), parts[2], parts[2]
                else:
                    path, sid, text, cleaned = parts[0], 0, parts[1], parts[1]
                if not MIN_TEXT_LEN <= len(text) <= MAX_TEXT_LEN:
                    continue
                wav_path = path if path.endswith(".wav") else path + ".wav"
                self.items.append((wav_path, sid, text, cleaned))
                try:  # frames estimated from the file size
                    self.lengths.append(os.path.getsize(wav_path) // (2 * cfg.hop_length))
                except OSError:
                    self.lengths.append(0)

    def __len__(self):
        return len(self.items)

    def text_ids(self, idx: int) -> list:
        _, _, text, cleaned = self.items[idx]
        if self.cfg.text_mode == "aligned":
            ids = text_to_ids_aligned(cleaned, self.id_map)
        else:
            ids = text_to_ids_g2p(text, self.id_map)
        return intersperse(ids, 0) if self.cfg.add_blank else ids

    def mel(self, idx: int) -> np.ndarray:
        """(frames, n_mel), cached as .mel.npy next to the wav."""
        cache = self.items[idx][0][:-4] + ".mel.npy"
        if os.path.exists(cache):
            return np.load(cache)
        c = self.cfg
        with torch.no_grad():
            m = mel_spectrogram(torch.from_numpy(self.audio(idx)[None]), c.filter_length,
                                c.n_mel_channels, c.sampling_rate, c.hop_length, c.win_length,
                                c.mel_fmin, c.mel_fmax)[0].numpy()
        try:
            np.save(cache, m)
        except OSError:
            pass
        return m

    def audio(self, idx: int) -> np.ndarray:
        data, sr = load_wav(self.items[idx][0])
        if sr != self.cfg.sampling_rate:
            raise ValueError(f"{self.items[idx][0]}: {sr} != {self.cfg.sampling_rate}")
        return data / MAX_WAV_VALUE

    def example(self, idx: int):
        return self.text_ids(idx), self.mel(idx), self.audio(idx), self.items[idx][1]


def _bucket_of(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


class BucketBatcher:
    """Length-bucketed, epoch-shuffled batches of numpy arrays padded to
    shape classes, sharded by host as the JAX package's: each bucket is
    padded to a multiple of the global batch (``batch_size`` x
    ``num_hosts``, the per-rank batch x the ranks), then host ``host_id``
    takes every ``num_hosts``-th item of it; every host draws the same
    permutations, so an epoch's batches are the same global batches on
    every host."""

    def __init__(self, dataset: TTSDataset, batch_size: int, *, host_id: int = 0,
                 num_hosts: int = 1):
        self.ds = dataset
        self.batch_size = batch_size
        self.host_id, self.num_hosts = host_id, num_hosts
        self.buckets: dict = {}
        for i, ln in enumerate(dataset.lengths):
            for lo, hi in zip(BOUNDARIES[:-1], BOUNDARIES[1:]):
                if lo < ln <= hi:
                    self.buckets.setdefault(hi, []).append(i)
                    break

    def num_batches(self) -> int:
        gbs = self.batch_size * self.num_hosts
        return sum((len(idxs) + (-len(idxs)) % gbs) // gbs for idxs in self.buckets.values())

    def epoch(self, epoch: int):
        rng = np.random.default_rng(1234 + epoch)
        batches = []
        bs, gbs = self.batch_size, self.batch_size * self.num_hosts
        for _, idxs in sorted(self.buckets.items()):
            order = [idxs[i] for i in rng.permutation(len(idxs))]
            rem = (gbs - len(order) % gbs) % gbs  # pad to a multiple of the global batch
            order = order + (order * (rem // max(len(order), 1)) + order[: rem % max(len(order), 1)])
            order = order[self.host_id::self.num_hosts]
            for j in range(len(order) // bs):
                batches.append(order[j * bs: (j + 1) * bs])
        for i in rng.permutation(len(batches)):
            yield self.collate(batches[i])

    def collate(self, idxs) -> dict:
        cfg = self.ds.cfg
        examples = [self.ds.example(i) for i in idxs]
        tx = _bucket_of(max(len(e[0]) for e in examples), TEXT_BUCKETS)
        tf = _bucket_of(max(e[1].shape[0] for e in examples), FRAME_BUCKETS)
        ts = tf * cfg.hop_length
        b = len(examples)
        out = {
            "x": np.zeros((b, tx), np.int32),
            "x_lengths": np.zeros((b,), np.int32),
            "mel": np.zeros((b, tf, cfg.n_mel_channels), np.float32),
            "mel_lengths": np.zeros((b,), np.int32),
            "wav": np.zeros((b, ts), np.float32),
            "sid": np.zeros((b,), np.int32),
        }
        for i, (ids, mel, audio, sid) in enumerate(examples):
            ids = ids[:tx]
            out["x"][i, : len(ids)] = ids
            out["x_lengths"][i] = len(ids)
            nf = min(mel.shape[0], tf)
            out["mel"][i, :nf] = mel[:nf]
            out["mel_lengths"][i] = nf
            ns = min(len(audio), ts)
            out["wav"][i, :ns] = audio[:ns]
            out["sid"][i] = sid
        return out
