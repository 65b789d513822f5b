"""QuickVC training data (vosk_tts_tpu/train/vc_data.py), host-side numpy.

Per utterance (one wav path a line of the file list): the ContentVec
features of its ``.cv.npy`` sidecar (50 Hz, one row a spectrogram frame),
the linear spectrogram by the port's ``ops.stft.spectrogram`` (cached as
``.spec.npy``), the log-mel for the speaker encoder, and the waveform,
all cut to the shorter of the features and the spectrogram. A batch is one
random ``max_speclen``-frame window of each (the reference's
rand_spec_segments), its starts drawn from the batcher's generator.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.stft import mel_spectrogram, spectrogram
from .data import MAX_WAV_VALUE, load_wav


@dataclass
class VCDataConfig:
    file_list: str = ""
    sampling_rate: int = 16000
    filter_length: int = 1280
    hop_length: int = 320
    win_length: int = 1280
    n_mel_channels: int = 80
    max_speclen: int = 512


class VCDataset:
    def __init__(self, cfg: VCDataConfig):
        self.cfg = cfg
        with open(cfg.file_list, encoding="utf-8") as f:
            self.paths = [line.split("|")[0].strip() for line in f if line.strip()]
        self.lengths = []  # frames estimated from the file size
        for p in self.paths:
            try:
                self.lengths.append(os.path.getsize(p) // (2 * cfg.hop_length))
            except OSError:
                self.lengths.append(0)

    def __len__(self):
        return len(self.paths)

    def example(self, idx: int):
        """(c (n, ssl_dim), spec (n, F), mel (n, n_mel), audio (n * hop,))."""
        cfg = self.cfg
        path = self.paths[idx]
        wav, sr = load_wav(path)
        if sr != cfg.sampling_rate:
            raise ValueError(f"{path}: {sr} != {cfg.sampling_rate}")
        audio = wav / MAX_WAV_VALUE
        y = torch.from_numpy(audio[None])
        spec_cache = path[:-4] + ".spec.npy"
        if os.path.exists(spec_cache):
            spec = np.load(spec_cache)
        else:
            with torch.no_grad():
                spec = spectrogram(y, cfg.filter_length, cfg.hop_length, cfg.win_length)[0].numpy()
            try:
                np.save(spec_cache, spec)
            except OSError:
                pass
        c = np.load(path[:-4] + ".cv.npy")
        n = min(len(spec), len(c))
        with torch.no_grad():
            mel = mel_spectrogram(y, cfg.filter_length, cfg.n_mel_channels, cfg.sampling_rate,
                                  cfg.hop_length, cfg.win_length, 0.0, None)[0].numpy()
        return c[:n], spec[:n], mel[:n], audio[: n * cfg.hop_length]

    def collate(self, idxs, rng: np.random.Generator) -> dict:
        """One window of min(max_speclen, the shortest utterance's frames - 1)
        frames from each utterance, at a start drawn from ``rng``."""
        cfg = self.cfg
        examples = [self.example(i) for i in idxs]
        seg = min(cfg.max_speclen, min(e[1].shape[0] for e in examples) - 1)
        b = len(examples)
        out = {
            "c": np.zeros((b, seg, examples[0][0].shape[1]), np.float32),
            "spec": np.zeros((b, seg, examples[0][1].shape[1]), np.float32),
            "mel": np.zeros((b, seg, cfg.n_mel_channels), np.float32),
            "wav": np.zeros((b, seg * cfg.hop_length), np.float32),
        }
        for i, (c, spec, mel, audio) in enumerate(examples):
            start = int(rng.integers(0, max(spec.shape[0] - seg, 1)))
            out["c"][i] = c[start: start + seg]
            out["spec"][i] = spec[start: start + seg]
            out["mel"][i] = mel[start: start + seg]
            out["wav"][i] = audio[start * cfg.hop_length: (start + seg) * cfg.hop_length]
        return out
