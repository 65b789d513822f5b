"""GPT-SoVITS training data (vosk_tts_tpu/train/gpt_sovits_data.py),
host-side numpy, and the batcher the VC driver shares.

Stage 1 (text -> semantic codes, the reference's Text2SemanticDataset):
``semantic.tsv`` lines ``name\tcode code ...`` (25 Hz codes); metadata lines
``path|spk|text|aligned`` (underscore-joined phones); the reference's three
filters (codes over ``max_sec * hz``, phones over ``max_sec * hz / 2.5``,
a phone rate outside [min_ps_ratio, max_ps_ratio] a second); per-phone
BERT rows from ``<name>.bert.npy`` where present, else zeros; codes padded
with EOS.

Stage 2 (codes -> waveform, the reference's TextAudioSpeakerLoader): the
same metadata; wavs at the S2 rate; the linear spectrogram by the port's
``ops.stft.spectrogram`` (cached as ``.spec.npy``); SSL features from
``<name>.ssl.npy`` (50 Hz), their last row repeated up to the spectrogram's
frames and cut there; wavs over 20 s dropped.

Both pad a batch to a (text, codes or frames) bucket, as the JAX package
does, so both see the same shapes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.stft import spectrogram
from ..text import plain_symbol_map
from .data import MAX_WAV_VALUE, _bucket_of, load_wav, text_to_ids_aligned

SEED = 1234  # the epoch's generator is default_rng(SEED + epoch)
HZ = 25  # codes a second
MIN_PS_RATIO, MAX_PS_RATIO = 3.0, 25.0  # phones a second a row may have (dataset.py:116-131)
MAX_WAV_SEC = 20.0  # longer S2 wavs are dropped (data_utils.py:67-69)
TEXT_BUCKETS = (32, 64, 128, 256, 512)
SEM_BUCKETS = (64, 128, 256, 512, 1024)  # S1 codes
FRAME_BUCKETS = (64, 128, 256, 512, 1024)  # S2 spectrogram frames


def read_metadata(path: str) -> list[tuple[str, int, str, str]]:
    """``path|spk|text|aligned`` rows (metadata-phones-ids.csv)."""
    rows = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("|")
            if len(parts) >= 4:
                rows.append((parts[0], int(parts[1]), parts[2], parts[3]))
    return rows


def read_semantic_tsv(path: str) -> dict[str, list[int]]:
    """``name\tcodes`` rows (semantic.tsv; ar/data/dataset.py:78-80)."""
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            items = line.strip().split("\t")
            if len(items) == 2:
                out[items[0]] = [int(t) for t in items[1].split(" ")]
    return out


def _item_name(path: str) -> str:
    name = os.path.basename(path)
    return name[:-4] if name.endswith(".wav") else name


@dataclass
class S1DataConfig:
    metadata: str = ""
    semantic: str = ""
    wav_dir: str = ""  # where the .bert.npy sidecars are
    bert_dim: int = 1024
    max_sec: int = 100
    pad_val: int = 1024  # EOS


class S1Dataset:
    """(name, phone ids, codes) of each metadata row with codes that passes
    the filters."""

    def __init__(self, cfg: S1DataConfig):
        self.cfg = cfg
        id_map = plain_symbol_map()
        semantic = read_semantic_tsv(cfg.semantic)
        self.items = []
        for path, _spk, _text, aligned in read_metadata(cfg.metadata):
            name = _item_name(path)
            if name not in semantic:
                continue
            sem = semantic[name]
            phones = text_to_ids_aligned(aligned, id_map)
            if len(sem) > cfg.max_sec * HZ or len(phones) > cfg.max_sec * HZ / 2.5:
                continue
            if not MIN_PS_RATIO <= len(phones) / (len(sem) / HZ) <= MAX_PS_RATIO:
                continue
            self.items.append((name, phones, sem))

    def __len__(self):
        return len(self.items)

    def example(self, idx: int):
        """(phone ids, codes, BERT rows (n_phones, bert_dim) or None)."""
        name, phones, sem = self.items[idx]
        bert_path = os.path.join(self.cfg.wav_dir, name + ".bert.npy")
        bert = np.load(bert_path) if os.path.exists(bert_path) else None
        if bert is not None and bert.shape[0] != len(phones):
            raise ValueError(f"{name}: bert rows {bert.shape[0]} != phones {len(phones)}")
        return phones, sem, bert

    def collate(self, idxs, rng=None) -> dict:
        """x (B, Tx) int32, x_lengths, y (B, Ty) int32 padded with EOS,
        y_lengths, bert (B, Tx, bert_dim) (zero rows where a row has none);
        Tx and Ty the buckets of the longest. ``rng`` is not read."""
        cfg = self.cfg
        examples = [self.example(i) for i in idxs]
        tx = _bucket_of(max(len(e[0]) for e in examples), TEXT_BUCKETS)
        ty = _bucket_of(max(len(e[1]) for e in examples), SEM_BUCKETS)
        b = len(examples)
        out = {"x": np.zeros((b, tx), np.int32), "x_lengths": np.zeros((b,), np.int32),
               "y": np.full((b, ty), cfg.pad_val, np.int32), "y_lengths": np.zeros((b,), np.int32),
               "bert": np.zeros((b, tx, cfg.bert_dim), np.float32)}
        for i, (phones, sem, bert) in enumerate(examples):
            t, n = min(len(phones), tx), min(len(sem), ty)
            out["x"][i, :t] = phones[:t]
            out["x_lengths"][i] = t
            out["y"][i, :n] = sem[:n]
            out["y_lengths"][i] = n
            if bert is not None:
                out["bert"][i, :t] = bert[:t]
        return out


@dataclass
class S2DataConfig:
    metadata: str = ""
    wav_dir: str = ""
    sampling_rate: int = 32000
    filter_length: int = 2048
    hop_length: int = 640
    win_length: int = 2048
    ssl_dim: int = 768


class S2Dataset:
    """The metadata's wavs of at most MAX_WAV_SEC (by file size), with their
    frame counts estimated from the size as ``lengths``."""

    def __init__(self, cfg: S2DataConfig):
        self.cfg = cfg
        self.id_map = plain_symbol_map()
        self.items, self.lengths = [], []
        for path, spk, _text, aligned in read_metadata(cfg.metadata):
            wav_path = os.path.join(cfg.wav_dir, path) if cfg.wav_dir else path
            try:
                size = os.path.getsize(wav_path)
            except OSError:
                continue
            if size / cfg.sampling_rate / 2 > MAX_WAV_SEC:
                continue
            self.items.append((wav_path, spk, aligned))
            self.lengths.append(size // (2 * cfg.hop_length))

    def __len__(self):
        return len(self.items)

    def example(self, idx: int):
        """(ssl (n, ssl_dim), spec (n, F), audio (n * hop,), phone ids)."""
        cfg = self.cfg
        wav_path, _spk, aligned = self.items[idx]
        wav, sr = load_wav(wav_path)
        if sr != cfg.sampling_rate:
            raise ValueError(f"{wav_path}: {sr} != {cfg.sampling_rate}")
        audio = wav / MAX_WAV_VALUE
        spec_cache = wav_path[:-4] + ".spec.npy"
        if os.path.exists(spec_cache):
            spec = np.load(spec_cache)
        else:
            with torch.no_grad():
                spec = spectrogram(torch.from_numpy(audio[None]), cfg.filter_length,
                                   cfg.hop_length, cfg.win_length)[0].numpy()
            try:
                np.save(spec_cache, spec)
            except OSError:
                pass
        ssl = np.load(wav_path[:-4] + ".ssl.npy")
        n = spec.shape[0]
        if ssl.shape[0] < n:  # the last row repeated (data_utils.py:91-92)
            ssl = np.concatenate([ssl, np.repeat(ssl[-1:], n - ssl.shape[0], axis=0)])
        return ssl[:n], spec, audio[: n * cfg.hop_length], text_to_ids_aligned(aligned,
                                                                                 self.id_map)

    def collate(self, idxs, rng=None) -> dict:
        """ssl (B, Tf, ssl_dim), spec (B, Tf, F), spec_lengths, text (B, Tt)
        int32, text_lengths, wav (B, Tf * hop); Tf and Tt the buckets of the
        longest. ``rng`` is not read."""
        cfg = self.cfg
        examples = [self.example(i) for i in idxs]
        tx = _bucket_of(max(len(e[3]) for e in examples), TEXT_BUCKETS)
        tf = _bucket_of(max(e[1].shape[0] for e in examples), FRAME_BUCKETS)
        b = len(examples)
        out = {"ssl": np.zeros((b, tf, cfg.ssl_dim), np.float32),
               "spec": np.zeros((b, tf, cfg.filter_length // 2 + 1), np.float32),
               "spec_lengths": np.zeros((b,), np.int32), "text": np.zeros((b, tx), np.int32),
               "text_lengths": np.zeros((b,), np.int32),
               "wav": np.zeros((b, tf * cfg.hop_length), np.float32)}
        for i, (ssl, spec, audio, text) in enumerate(examples):
            nf = min(spec.shape[0], tf)
            out["ssl"][i, :nf] = ssl[:nf]
            out["spec"][i, :nf] = spec[:nf]
            out["spec_lengths"][i] = nf
            t = min(len(text), tx)
            out["text"][i, :t] = text[:t]
            out["text_lengths"][i] = t
            ns = min(len(audio), tf * cfg.hop_length)
            out["wav"][i, :ns] = audio[:ns]
        return out


class ShuffleBatcher:
    """Epoch-seeded, host-sharded batches: the dataset's items sorted by
    ``dataset.lengths`` (where it has them), padded to a multiple of the
    global batch (``batch_size`` x ``num_hosts``) by repeating the first
    items, cut into consecutive global groups, the groups shuffled by
    ``default_rng(SEED + epoch)``; host ``host_id`` takes every
    ``num_hosts``-th item of each group. ``dataset.collate(idxs, rng)``
    makes each batch from that epoch's generator, after the shuffle's draw
    (the VC windows read it; the GPT-SoVITS datasets do not), so the batches
    equal the JAX package's for the same seed and hosts."""

    def __init__(self, dataset, batch_size: int, *, host_id: int = 0, num_hosts: int = 1):
        self.ds = dataset
        self.batch_size = batch_size
        self.host_id, self.num_hosts = host_id, num_hosts
        self.order = list(range(len(dataset)))
        lengths = getattr(dataset, "lengths", None)
        if lengths:
            self.order.sort(key=lambda i: lengths[i])

    def num_batches(self) -> int:
        gbs = self.batch_size * self.num_hosts
        return max(len(self.order) // gbs, 1) if self.order else 0

    def epoch(self, epoch: int):
        rng = np.random.default_rng(SEED + epoch)
        gbs = self.batch_size * self.num_hosts
        order = self.order + self.order[: (gbs - len(self.order) % gbs) % gbs]
        groups = [order[j * gbs: (j + 1) * gbs] for j in range(len(order) // gbs)]
        for i in rng.permutation(len(groups)):
            yield self.collate(groups[i][self.host_id::self.num_hosts], rng)

    def collate(self, idxs, rng):
        return self.ds.collate(idxs, rng)
