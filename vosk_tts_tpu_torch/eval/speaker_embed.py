"""Training-free speaker embedding for the similarity eval protocol
(vosk_tts_tpu/eval/speaker_embed.py).

The reference scores speaker similarity with Resemblyzer
(training/vc/eval-score.py:25-63) — a pretrained d-vector
net that cannot be downloaded in this environment. Rather than a randomly
initialized stand-in (whose features are not speaker-discriminative), this
implements the classic pre-neural speaker signature that needs no weights:

  - MFCC mean + std over voiced frames (vocal-tract / formant envelope);
  - median and IQR of log-F0 via autocorrelation (glottal source).

These statistics genuinely separate speakers (GMM-UBM-era speaker ID ran on
exactly these) and are deterministic, so both ranking and a meaningful
absolute cosine score work. A trained embedder remains pluggable through
``speaker_similarity(embedder=...)``.

Runs in numpy on the host: this is eval-harness code, not a synthesis hot
path; the mel filterbank is the port's own (ops/stft.py).
"""

from __future__ import annotations

import numpy as np

from ..ops.stft import mel_filterbank


def _frame(wav: np.ndarray, frame: int, hop: int) -> np.ndarray:
    n = 1 + max(0, (len(wav) - frame)) // hop
    idx = np.arange(frame)[None, :] + hop * np.arange(n)[:, None]
    return wav[idx]


def _mfcc(frames: np.ndarray, sample_rate: int, n_fft: int, n_mels: int,
          n_mfcc: int) -> np.ndarray:
    win = np.hanning(frames.shape[1])
    spec = np.abs(np.fft.rfft(frames * win, n=n_fft, axis=1)) ** 2
    mel = np.asarray(mel_filterbank(sample_rate, n_fft, n_mels, 0.0, None))
    logmel = np.log(spec @ mel.T + 1e-10)
    # orthonormal DCT-II over the mel axis
    k = np.arange(n_mels)
    basis = np.cos(np.pi / n_mels * (k[None, :] + 0.5) * np.arange(n_mfcc)[:, None])
    basis *= np.sqrt(2.0 / n_mels)
    basis[0] /= np.sqrt(2.0)
    return logmel @ basis.T  # (frames, n_mfcc)


def _f0_autocorr(frames: np.ndarray, sample_rate: int,
                 fmin: float = 60.0, fmax: float = 400.0) -> np.ndarray:
    """Per-frame F0 (Hz) by autocorrelation peak in [fmin, fmax]; 0 = unvoiced."""
    x = frames - frames.mean(axis=1, keepdims=True)
    n = x.shape[1]
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    spec = np.fft.rfft(x, n=nfft, axis=1)
    ac = np.fft.irfft(spec * np.conj(spec), axis=1)[:, :n]
    lag_min = max(2, int(sample_rate / fmax))
    lag_max = min(n - 1, int(sample_rate / fmin))
    if lag_max <= lag_min:
        return np.zeros(len(x))
    window = ac[:, lag_min:lag_max]
    peak = lag_min + np.argmax(window, axis=1)
    strength = np.take_along_axis(ac, peak[:, None], 1)[:, 0] / (ac[:, 0] + 1e-10)
    f0 = sample_rate / peak.astype(np.float64)
    return np.where(strength > 0.3, f0, 0.0)


def mfcc_f0_embedding(wav: np.ndarray, sample_rate: int, *, n_mfcc: int = 20,
                      n_mels: int = 40) -> np.ndarray:
    """(2*(n_mfcc-1) + 2)-dim speaker signature of one utterance."""
    wav = np.asarray(wav, np.float64)
    wav = np.append(wav[0], wav[1:] - 0.97 * wav[:-1])  # pre-emphasis
    frame = int(0.025 * sample_rate)
    hop = int(0.010 * sample_rate)
    if len(wav) < frame:
        wav = np.pad(wav, (0, frame - len(wav)))
    frames = _frame(wav, frame, hop)
    n_fft = int(2 ** np.ceil(np.log2(frame)))

    energy = np.log(np.mean(frames**2, axis=1) + 1e-12)
    voiced = energy > (energy.max() - 8.0)  # within ~35 dB of the loudest frame
    if voiced.sum() < 4:
        voiced = np.ones(len(frames), bool)

    mf = _mfcc(frames[voiced], sample_rate, n_fft, n_mels, n_mfcc)[:, 1:]  # drop c0
    f0 = _f0_autocorr(frames[voiced], sample_rate)
    logf0 = np.log(f0[f0 > 0]) if (f0 > 0).any() else np.zeros(1)

    feats = np.concatenate([
        mf.mean(axis=0),
        mf.std(axis=0),
        [np.median(logf0), np.subtract(*np.percentile(logf0, [75, 25]))],
    ])
    return feats.astype(np.float32)
