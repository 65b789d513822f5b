"""STFT, mel spectrogram, inverse STFT and the fused MB-iSTFT decoder tail
(vosk_tts_tpu/ops/stft.py).

``stft``/``spectrogram``/``mel_spectrogram`` are the reference's
spectrogram_torch and mel_spectrogram_torch: reflect-pad by (n_fft-hop)//2,
center=False framing, the windowed real DFT as one strided conv (the JAX
package's basis), magnitude sqrt(re^2 + im^2 + 1e-6), the Slaney mel
filterbank (librosa's defaults, re-derived in numpy) and log(clamp(., 1e-5)).

``istft`` is torch.istft(center=True) semantics with ``mode`` "torch"
(windowed inverse-DFT overlap-add, window-envelope normalization, n_fft//2
trimmed at each end), or the exported models' OnnxSTFT.inverse with "onnx"
(the same overlap-add without the envelope normalization).
``istft_multiband`` computes either for all subbands in one block-diagonal
transposed conv; ``istft`` is its one-subband case.
``mb_decoder_tail_fused`` computes pqmf_synthesis(istft_multiband(...))
from the raw conv_post activation as ONE transposed conv at the composite
stride hop*subbands (the JAX package's blocked FIR is a TPU lowering of
that same conv), with the first and last samples recomputed by the
unfused ops, where the composition is not a pure convolution.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .conv import constant, conv1d, conv_transpose1d
from .pqmf import pqmf_filters, pqmf_synthesis


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (== torch.hann_window)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float64)


def _fourier_and_window(n_fft: int, win_length: int):
    """[cos_k ; -sin_k] (n_fft+2, n_fft) and the Hann window centred in n_fft."""
    cutoff = n_fft // 2 + 1
    k = np.arange(cutoff)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    window = np.zeros(n_fft)
    off = (n_fft - win_length) // 2
    window[off: off + win_length] = hann_window(win_length)
    return np.vstack([np.cos(ang), -np.sin(ang)]), window


@lru_cache(maxsize=16)
def _forward_dft_weight(n_fft: int, win_length: int, device, dtype):
    """Windowed real-DFT basis as a conv weight (n_fft+2, 1, n_fft): one
    strided conv gives [real(X_k) | imag(X_k)], k = 0..n_fft/2 (the forward
    half of the JAX package's ``_dft_bases``)."""
    fourier, window = _fourier_and_window(n_fft, win_length)
    w = (fourier * window[None, :]).astype(np.float32)[:, None, :]
    return constant(w, dtype=dtype, device=device)


@lru_cache(maxsize=None)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float | None) -> np.ndarray:
    """Slaney-scale, Slaney-normalised mel filterbank (n_mels, n_fft//2+1),
    librosa.filters.mel's defaults (htk=False, norm='slaney')."""
    if fmax is None:
        fmax = sr / 2.0
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                        f / f_sp)

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        f_sp * m)

    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fftfreqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_pts[2: n_mels + 2] - mel_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def _reflect_pad(y: torch.Tensor, pad: int) -> torch.Tensor:
    """y: (B, T), reflect-padded by ``pad`` on both sides."""
    if pad == 0:
        return y
    return F.pad(y[:, None, :], (pad, pad), mode="reflect")[:, 0, :]


def stft(y: torch.Tensor, n_fft: int, hop: int, win: int, *, pad: int | None = None):
    """Real STFT. y: (B, T) -> (real, imag), each (B, frames, n_fft//2+1):
    reflect-padded by ``pad``, default (n_fft-hop)//2 (spectrogram_torch),
    center=False framing; pad=n_fft//2 gives torch.stft(center=True) (the
    STFT losses and the spectral discriminator). Odd n_fft works (683, 171)."""
    if pad is None:
        pad = (n_fft - hop) // 2
    y = _reflect_pad(y, pad)
    w = _forward_dft_weight(n_fft, win, y.device, y.dtype)
    frames = conv1d(y[..., None], w, stride=hop, padding=0)
    cutoff = n_fft // 2 + 1
    return frames[..., :cutoff], frames[..., cutoff:]


def spectrogram(y: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    """Magnitude spectrogram (B, frames, n_fft//2+1), channels-last."""
    re, im = stft(y, n_fft, hop, win)
    return torch.sqrt(re * re + im * im + 1e-6)


def spectral_normalize(x: torch.Tensor, clip_val: float = 1e-5) -> torch.Tensor:
    """Dynamic-range compression log(clamp(x, clip_val))."""
    return torch.log(torch.clamp(x, min=clip_val))


def spec_to_mel(spec: torch.Tensor, n_fft: int, num_mels: int, sr: int, fmin: float,
                fmax: float | None) -> torch.Tensor:
    """Linear spectrogram (B, T, F) -> log-mel (B, T, num_mels)."""
    fb = torch.as_tensor(mel_filterbank(sr, n_fft, num_mels, fmin, fmax), device=spec.device,
                         dtype=spec.dtype)
    return spectral_normalize(spec @ fb.T)


def mel_spectrogram(y: torch.Tensor, n_fft: int, num_mels: int, sr: int, hop: int, win: int,
                    fmin: float, fmax: float | None) -> torch.Tensor:
    """Waveform (B, T) -> log-mel (B, frames, num_mels)."""
    return spec_to_mel(spectrogram(y, n_fft, hop, win), n_fft, num_mels, sr, fmin, fmax)


@lru_cache(maxsize=None)
def _inverse_dft_basis(n_fft: int, win_length: int):
    """Windowed inverse real-DFT basis (n_fft+2, n_fft): pinv of
    [cos_k ; -sin_k] times the window (the inverse half of the JAX
    package's ``_dft_bases``)."""
    fourier, window = _fourier_and_window(n_fft, win_length)
    return (np.linalg.pinv(fourier).T * window[None, :]).astype(np.float32)


@lru_cache(maxsize=None)
def _window_envelope_np(n_fft: int, hop: int, win: int, n_frames: int) -> np.ndarray:
    """Sum-squared window envelope over the overlap-add output."""
    w = np.zeros(n_fft)
    off = (n_fft - win) // 2
    w[off: off + win] = hann_window(win)
    wsq = w * w
    out = np.zeros(n_fft + hop * (n_frames - 1))
    for i in range(n_frames):
        out[i * hop: i * hop + n_fft] += wsq
    return out.astype(np.float32)


@lru_cache(maxsize=16)
def _multiband_weight(n_fft, win, sub, device, dtype):
    """Block-diagonal inverse basis as a transposed-conv weight
    (sub*(n_fft+2), sub, n_fft)."""
    inv = _inverse_dft_basis(n_fft, win)
    per = n_fft + 2
    w = np.zeros((sub * per, sub, n_fft), np.float32)
    for s in range(sub):
        w[s * per: (s + 1) * per, s, :] = inv
    return constant(w, dtype=dtype, device=device)


@lru_cache(maxsize=64)
def _safe_envelope(n_fft, hop, win, t, device, dtype):
    env = _window_envelope_np(n_fft, hop, win, t)
    env = np.where(env > 1.1754944e-38, env, 1.0)
    return constant(env, dtype=dtype, device=device)


def istft_multiband(mag, phase, n_fft: int, hop: int, win: int, *, mode: str = "torch"):
    """mag/phase: (B, T, sub, n_fft//2+1) -> (B, (T-1)*hop, sub): torch.istft
    semantics (``mode`` "torch"), or without the envelope normalization
    ("onnx")."""
    b, t, sub, _ = mag.shape
    spectra = torch.cat([mag * torch.cos(phase), mag * torch.sin(phase)], dim=-1)
    spectra = spectra.reshape(b, t, sub * (n_fft + 2))
    y = conv_transpose1d(spectra, _multiband_weight(n_fft, win, sub, mag.device, mag.dtype),
                         stride=hop)
    if mode == "torch":
        y = y / _safe_envelope(n_fft, hop, win, t, y.device, y.dtype)[None, :, None]
    half = n_fft // 2
    return y[:, half: y.shape[1] - half, :]


def istft(mag, phase, n_fft: int, hop: int, win: int, *, mode: str = "torch"):
    """mag/phase: (B, frames, n_fft//2+1) -> waveform (B, (frames-1)*hop):
    torch.istft(center=True) (``mode`` "torch"), or OnnxSTFT.inverse, the
    same without the envelope normalization ("onnx", the path baked into
    the exported models)."""
    return istft_multiband(mag[:, :, None], phase[:, :, None], n_fft, hop, win,
                           mode=mode)[..., 0]


@lru_cache(maxsize=None)
def _fused_mb_kernel(n_fft: int, hop: int, win: int, sub: int, taps: int,
                     cutoff_ratio: float, beta: float, mode: str):
    """Composite kernel for iSTFT (stride hop) -> steady-state envelope
    divide ("torch" mode; none for "onnx") -> PQMF synthesis (zero-stuff x
    sub + FIR), collapsed into ONE transposed conv of stride hop*sub.
    Returns (G2 (Kc, C, 1) float32, off) in the JAX layout; the envelope is
    periodic (period hop) away from the signal edges, so it folds into the
    kernel per tap phase."""
    w1 = _inverse_dft_basis(n_fft, win).T  # w1[j, cc]: iSTFT tap j for spectral channel cc
    if mode == "torch":
        env = _window_envelope_np(n_fft, hop, win, 64)
        n0 = hop * (-(-(win - hop) // hop))  # first steady hop-aligned pos
        env_p = env[n0: n0 + hop]
    else:
        env_p = np.ones(hop, np.float32)

    _, h_s = pqmf_filters(sub, taps, cutoff_ratio, beta)
    k2 = taps + 1
    wt = h_s.T[::-1, :] * float(sub)  # flipped synthesis filter (K2, sub)

    c_in = sub * (n_fft + 2)
    kc = sub * (n_fft - 1) + k2
    g2 = np.zeros((kc, c_in, 1), np.float32)
    for s in range(sub):
        for cc in range(n_fft + 2):
            c = s * (n_fft + 2) + cc
            for j in range(n_fft):
                coef = w1[j, cc] / env_p[j % hop]
                lo = sub * j
                g2[lo: lo + k2, c, 0] += coef * wt[:, s]
    off = (k2 - 1) // 2 + sub * (n_fft // 2)
    return g2, off


@lru_cache(maxsize=16)
def _fused_weight(n_fft, hop, win, sub, taps, cutoff_ratio, beta, mode, device, dtype):
    g2, off = _fused_mb_kernel(n_fft, hop, win, sub, taps, cutoff_ratio, beta, mode)
    return constant(np.ascontiguousarray(g2.transpose(1, 2, 0)), dtype=dtype,
                           device=device), off


@lru_cache(maxsize=16)
def _specphase_lanes(n_fft: int, sub: int, device, dtype):
    """Lane-space spec/phase: per subband group of n_fft+2 lanes of the
    conv_post output (log-magnitude bins, then phase-argument bins), the
    iSTFT spectra [re | im] are

        spectra[c] = exp(x[mag_src[c]]) * sin(pi * sin(x[phase_src[c]]) + off[c])

    (sin(theta + pi/2) = cos(theta) turns the re/im split into a per-lane
    phase offset). Returns the two source-lane indices and the offsets as
    tensors on ``device``."""
    per = n_fft + 2
    cutoff = n_fft // 2 + 1
    mag_src = np.zeros(sub * per, np.int64)
    phase_src = np.zeros(sub * per, np.int64)
    off = np.zeros(sub * per, np.float32)
    for g in range(sub):
        for j in range(per):
            c = g * per + j
            if j < cutoff:  # re lane: mag bin j, phase bin j
                mag_src[c] = g * per + j
                phase_src[c] = g * per + cutoff + j
                off[c] = np.pi / 2
            else:  # im lane: mag bin j-cutoff, phase bin j-cutoff
                mag_src[c] = g * per + (j - cutoff)
                phase_src[c] = g * per + j
    return (constant(mag_src, device=device), constant(phase_src, device=device),
            constant(off, dtype=dtype, device=device))


def mb_decoder_tail_fused(x, n_fft: int, hop: int, win: int, *, subbands: int, taps: int = 62,
                          cutoff_ratio: float = 0.15, beta: float = 9.0, mode: str = "torch"):
    """The MB-iSTFT tail after conv_post: x (B, T, sub*(n_fft+2)) ->
    waveform (B, (T-1)*hop*sub, 1). Equals

        spec, phase = exp(x4[..., :cutoff]), pi * sin(x4[..., cutoff:])
        pqmf_synthesis(istft_multiband(spec, phase, ..., mode=mode))

    (x4 the (B, T, sub, n_fft+2) view) to fp-reassociation tolerance."""
    b, t, _ = x.shape
    per = n_fft + 2
    cutoff = n_fft // 2 + 1
    stride = hop * subbands

    def unfused_4d(x_sl):
        xs = x_sl.reshape(x_sl.shape[0], x_sl.shape[1], subbands, per)
        y_mb = istft_multiband(torch.exp(xs[..., :cutoff]), np.pi * torch.sin(xs[..., cutoff:]),
                               n_fft, hop, win, mode=mode)
        return pqmf_synthesis(y_mb, subbands=subbands, taps=taps,
                              cutoff_ratio=cutoff_ratio, beta=beta)

    edge_frames = max(16, -(-((taps + 1) + 2 * win) // stride) + 2)
    if t < 2 * edge_frames + 1:
        return unfused_4d(x)

    mag_src, phase_src, off = _specphase_lanes(n_fft, subbands, x.device, x.dtype)
    spectra = torch.exp(x.index_select(-1, mag_src)) * torch.sin(
        np.pi * torch.sin(x.index_select(-1, phase_src)) + off)

    g2, off_k = _fused_weight(n_fft, hop, win, subbands, taps, cutoff_ratio, beta, mode,
                              x.device, x.dtype)
    z = conv_transpose1d(spectra, g2, stride=stride)
    out = z[:, off_k: off_k + stride * (t - 1), :]

    patch = 8 * stride
    head = unfused_4d(x[:, :edge_frames])
    tail = unfused_4d(x[:, -edge_frames:])
    return torch.cat([head[:, :patch], out[:, patch: out.shape[1] - patch], tail[:, -patch:]],
                     dim=1)
