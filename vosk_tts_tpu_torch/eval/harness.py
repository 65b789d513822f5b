"""Synthesis evaluation drivers (vosk_tts_tpu/eval/harness.py).

  * ``batch_synthesize``: synthesize a text list across speakers to WAVs
    (extra/build-examples.sh + training/vits2/eval.py:48-90);
  * ``eval_rtf``: RTF and audio seconds per second over a corpus
    (training/vits2/eval.py:140-144 xRT), each request's wall time on the
    host clock after the audio is back on the host;
  * ``speaker_similarity``: cosine similarity of speaker embeddings between
    generated and reference audio (extra/tts-test/ru/eval_similarity.py).
    The embedder is pluggable; the default is the committed GE2E-trained
    LSTM d-vector artifact (eval/speaker_train.py), on the card unless
    ``device`` says otherwise, falling back to the training-free MFCC+F0
    signature (eval/speaker_embed.py) only where the artifact file is
    absent, as the JAX package does;
  * ``transcribe_wer``: ASR round-trip WER (eval.py:106-146) with an
    injected ``asr(path) -> text``;
  * ``eval_utmos``: the UTMOS protocol (extra/tts-test/ru/eval_utmos.py:
    8-18) with an injected ``scorer(path) -> float``;
  * ``frechet_audio_distance``: FAD between embedding sets
    (extra/tts-test/ru/eval_fad.py), with a pluggable embedder.

The scores are numpy on the host; only the default embedder's encoder runs
on the card.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class EvalResult:
    metric: str
    value: float
    extra: dict = field(default_factory=dict)


def batch_synthesize(synth, texts, out_dir, speakers=(0, 1, 2, 3, 4), speech_rate=1.0):
    """Synthesize every (speaker, text) pair to out_dir; returns wav paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for sid in speakers:
        for i, text in enumerate(texts):
            path = os.path.join(out_dir, f"spk{sid}_{i:04d}.wav")
            synth.synth(text, path, speaker_id=sid, speech_rate=speech_rate)
            paths.append(path)
    return paths


def eval_rtf(synth, texts, speaker_id=0, warmup=1) -> EvalResult:
    """Mean RTF + throughput over a text list (after ``warmup`` requests)."""
    for t in texts[:warmup]:
        synth.synth_audio(t, speaker_id=speaker_id)
    total_audio, total_time = 0.0, 0.0
    for t in texts:
        t0 = time.perf_counter()
        audio = synth.synth_audio(t, speaker_id=speaker_id)
        total_time += time.perf_counter() - t0
        total_audio += len(audio) / synth.model.sample_rate
    rtf = total_time / total_audio if total_audio else float("inf")
    return EvalResult("rtf", rtf, {"audio_sec_per_sec": (total_audio / total_time
                                                         if total_time else 0.0),
                                   "audio_sec": total_audio})


def _default_embedder(device=None):
    """Default speaker embedder: the committed GE2E-trained LSTM d-vector
    artifact (eval/speaker_train.py; the architecture and loss family of
    the reference's Resemblyzer gate, trained on the in-repo synthetic
    corpus so that similarity regressions are detectable), on ``device``
    (default: the card). Falls back to the training-free MFCC+F0
    statistics (eval/speaker_embed.py) if the artifact file is absent;
    a missing card raises. Inject a real d-vector/ECAPA model for numbers
    comparable to the published Resemblyzer 0.880 (vc/README.md:24)."""
    from .speaker_train import lstm_embedder

    try:
        return lstm_embedder(device=device)
    except (FileNotFoundError, OSError, KeyError):
        from .speaker_embed import mfcc_f0_embedding

        return mfcc_f0_embedding


def speaker_similarity(pairs, sample_rate=22050, embedder=None, device=None) -> EvalResult:
    """pairs: list of (generated_wav, reference_wav) float arrays. Returns
    avg/min cosine similarity (vc/eval-score.py:25-63 protocol).
    ``device`` places the default embedder."""
    embedder = embedder or _default_embedder(device)
    sims = []
    for gen, ref in pairs:
        a = embedder(np.asarray(gen, np.float32), sample_rate)
        b = embedder(np.asarray(ref, np.float32), sample_rate)
        sims.append(float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9)))
    return EvalResult("speaker_similarity_avg", float(np.mean(sims)),
                      {"min": float(np.min(sims)), "n": len(sims)})


def transcribe_wer(wav_paths, ref_texts, asr) -> EvalResult:
    """ASR round-trip WER. ``asr(path) -> text`` must be provided."""
    import re

    def norm(t):
        return re.sub(r"[^\w ]", "", t.lower()).split()

    errs, total = 0, 0
    for path, ref in zip(wav_paths, ref_texts):
        hyp = norm(asr(path))
        ref_w = norm(ref)
        errs += _edit_distance(hyp, ref_w)
        total += len(ref_w)
    return EvalResult("wer", errs / max(total, 1), {"words": total})


def eval_utmos(wav_paths, scorer) -> EvalResult:
    """UTMOS protocol (extra/tts-test/ru/eval_utmos.py:8-18): score every
    file, report mean and min. ``scorer(path) -> float`` must be injected."""
    scores = [float(scorer(p)) for p in wav_paths]
    return EvalResult("utmos_mean", float(np.mean(scores)),
                      {"min": float(np.min(scores)), "n": len(scores)})


def frechet_audio_distance(ref_wavs, gen_wavs, sample_rate=22050, embedder=None,
                           device=None) -> EvalResult:
    """FAD (eval_fad.py / fadtk protocol): Frechet distance between Gaussian
    fits of per-utterance embeddings of a reference set and a generated set,
    FAD = |mu1-mu2|^2 + tr(S1 + S2 - 2 (S1 S2)^1/2). The embedder is
    pluggable (``embedder(wav, sr) -> vec``); ``device`` places the default
    one."""
    embedder = embedder or _default_embedder(device)
    e_ref = np.stack([embedder(np.asarray(w, np.float32), sample_rate) for w in ref_wavs])
    e_gen = np.stack([embedder(np.asarray(w, np.float32), sample_rate) for w in gen_wavs])
    mu1, mu2 = e_ref.mean(0), e_gen.mean(0)
    s1 = np.cov(e_ref, rowvar=False)
    s2 = np.cov(e_gen, rowvar=False)
    covmean = _sqrtm_psd(s1 @ s2)
    fad = float(np.sum((mu1 - mu2) ** 2) + np.trace(s1 + s2 - 2.0 * covmean))
    return EvalResult("fad", max(fad, 0.0), {"n_ref": len(ref_wavs), "n_gen": len(gen_wavs)})


def _sqrtm_psd(m, eps=1e-10):
    """Matrix square root of the symmetrized product via eigendecomposition
    (scipy-free; exact for the symmetric case, the standard stable
    approximation for the FAD cross term)."""
    sym = (m + m.T) / 2.0
    vals, vecs = np.linalg.eigh(sym)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals + eps)) @ vecs.T


def _edit_distance(a, b):
    dp = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        prev, dp[0] = dp[0], i
        for j, cb in enumerate(b, 1):
            prev, dp[j] = dp[j], min(dp[j] + 1, dp[j - 1] + 1, prev + (ca != cb))
    return dp[len(b)]
