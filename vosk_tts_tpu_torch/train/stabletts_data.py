"""StableTTS/Matcha training data (vosk_tts_tpu/train/stabletts_data.py),
host-side numpy:

* metadata lines ``path|spk|text|aligned`` or ``path|text|aligned``
  (speaker 0); the wav is ``wav_dir/path`` (``.wav`` appended if missing);
* the 5-stream phone encoding of the pre-aligned text (words are
  underscore-joined phones) by the port's ``g2p_multistream(aligned=True)``,
  with a ``bert_fn(text) -> (n_words + 2, bert_dim)`` row per phone's word
  (zeros without one);
* the log-mel by the port's ``ops.stft.mel_spectrogram`` on the CPU,
  normalised by the dataset statistics and cached as ``.melnorm.npy``;
* kaldi ``.lab`` durations beside each wav (a line's last field, frames);
* batches padded to (text bucket, frame bucket) shape classes as in the
  JAX package (same buckets), the durations clipped into the frame bucket.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..ops.stft import mel_spectrogram
from ..text import g2p_multistream, multistream_symbol_map
from .data import MAX_WAV_VALUE, _bucket_of, load_wav
from .gpt_sovits_data import ShuffleBatcher

TEXT_BUCKETS = (64, 128, 192, 256, 384, 512)
FRAME_BUCKETS = (128, 256, 384, 512, 768, 1024)  # multiples of 4 (fix_len_compatibility)


@dataclass
class StableDataConfig:
    metadata: str = ""
    wav_dir: str = ""
    n_spks: int = 128
    sampling_rate: int = 22050
    n_fft: int = 1024
    n_mels: int = 80
    hop_length: int = 256
    win_length: int = 1024
    f_min: float = 0.0
    f_max: float | None = 8000.0
    mel_mean: float = -5.806578636169434  # configs/data/ru.yaml
    mel_std: float = 2.454238176345825
    load_durations: bool = True
    bert_dim: int = 768


def parse_lab(path: str) -> list[int]:
    """A kaldi label file -> the durations in frames, one a phone (the last
    field of each non-empty line)."""
    with open(path, encoding="utf-8") as f:
        return [int(items[-1]) for items in (line.split() for line in f) if items]


class StableTTSDataset:
    def __init__(self, cfg: StableDataConfig, bert_fn: Callable[[str], np.ndarray] | None = None):
        self.cfg = cfg
        self.bert_fn = bert_fn
        self.id_map = multistream_symbol_map()
        self.items, self.lengths = [], []  # lengths: frames estimated from the file size
        with open(cfg.metadata, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("|")
                if len(parts) >= 4:
                    path, spk, text, aligned = parts[0], int(parts[1]), parts[2], parts[3]
                elif len(parts) == 3:
                    path, spk, text, aligned = parts[0], 0, parts[1], parts[2]
                else:
                    continue
                wav_path = os.path.join(cfg.wav_dir, path) if cfg.wav_dir else path
                if not wav_path.endswith(".wav"):
                    wav_path += ".wav"
                self.items.append((wav_path, spk, text, aligned))
                try:
                    self.lengths.append(os.path.getsize(wav_path) // (2 * cfg.hop_length))
                except OSError:
                    self.lengths.append(0)

    def __len__(self):
        return len(self.items)

    def text_streams(self, idx: int):
        """(T, 5) int32 streams and (T, bert_dim) BERT rows."""
        _, _, text, aligned = self.items[idx]
        rows = np.asarray(self.bert_fn(text), np.float32) if self.bert_fn is not None else None
        tuples, embs, _ = g2p_multistream(aligned, {}, self.id_map, bert_embeddings=rows,
                                          aligned=True)
        x = np.asarray(tuples, np.int32)
        bert = (np.asarray(embs, np.float32) if embs is not None
                else np.zeros((x.shape[0], self.cfg.bert_dim), np.float32))
        return x, bert

    def mel(self, idx: int) -> np.ndarray:
        """(frames, n_mels), normalised by the dataset statistics."""
        wav_path = self.items[idx][0]
        cache = wav_path[:-4] + ".melnorm.npy"
        if os.path.exists(cache):
            return np.load(cache)
        data, sr = load_wav(wav_path)
        c = self.cfg
        if sr != c.sampling_rate:
            raise ValueError(f"{wav_path}: {sr} != {c.sampling_rate}")
        with torch.no_grad():
            m = mel_spectrogram(torch.from_numpy(data[None] / MAX_WAV_VALUE), c.n_fft, c.n_mels,
                                c.sampling_rate, c.hop_length, c.win_length, c.f_min,
                                c.f_max)[0].numpy()
        m = (m - c.mel_mean) / c.mel_std
        try:
            np.save(cache, m)
        except OSError:
            pass
        return m

    def durations(self, idx: int) -> list[int] | None:
        if not self.cfg.load_durations:
            return None
        return parse_lab(self.items[idx][0][:-4] + ".lab")

    def example(self, idx: int):
        x, bert = self.text_streams(idx)
        return x, bert, self.mel(idx), self.durations(idx), self.items[idx][1]


class StableBatcher(ShuffleBatcher):
    """Length-sorted, epoch-shuffled batches (ShuffleBatcher's) of
    shape-class arrays for train/stabletts_train.make_train_step."""

    def collate(self, idxs, rng=None) -> dict:
        cfg = self.ds.cfg
        examples = [self.ds.example(i) for i in idxs]
        tx = _bucket_of(max(e[0].shape[0] for e in examples), TEXT_BUCKETS)
        tf = _bucket_of(max(e[2].shape[0] for e in examples), FRAME_BUCKETS)
        b = len(examples)
        out = {
            "x": np.zeros((b, 5, tx), np.int32),
            "x_lengths": np.zeros((b,), np.int32),
            "mel": np.zeros((b, tf, cfg.n_mels), np.float32),
            "mel_lengths": np.zeros((b,), np.int32),
            "bert": np.zeros((b, tx, cfg.bert_dim), np.float32),
            "durations": np.zeros((b, tx), np.int32),
            "sid": np.zeros((b,), np.int32),
        }
        for i, (x, bert, mel, durs, spk) in enumerate(examples):
            t = min(x.shape[0], tx)
            out["x"][i, :, :t] = x[:t].T
            out["x_lengths"][i] = t
            nf = min(mel.shape[0], tf)
            out["mel"][i, :nf] = mel[:nf]
            out["mel_lengths"][i] = nf
            out["bert"][i, :t] = bert[:t]
            if durs is not None:
                # the cumulative durations clipped into the frame bucket, so
                # that the alignment stays inside the mel's mask
                d = np.asarray(durs[:t], np.int32)
                cum = np.cumsum(d)
                d = np.where(cum <= nf, d, np.maximum(nf - (cum - d), 0))
                out["durations"][i, : len(d)] = d
            out["sid"][i] = spk
        return out
