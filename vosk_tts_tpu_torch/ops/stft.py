"""Inverse STFT and the fused MB-iSTFT decoder tail (vosk_tts_tpu/ops/stft.py).

``istft_multiband`` is torch.istft(center=True) semantics (windowed
inverse-DFT overlap-add, window-envelope normalization, n_fft//2 trimmed
at each end) for all subbands in one block-diagonal transposed conv.
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

from .conv import conv_transpose1d
from .pqmf import pqmf_filters, pqmf_synthesis


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (== torch.hann_window)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float64)


@lru_cache(maxsize=None)
def _inverse_dft_basis(n_fft: int, win_length: int):
    """Windowed inverse real-DFT basis (n_fft+2, n_fft): pinv of
    [cos_k ; -sin_k] times the window (the inverse half of the JAX
    package's ``_dft_bases``)."""
    cutoff = n_fft // 2 + 1
    k = np.arange(cutoff)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    fourier = np.vstack([np.cos(ang), -np.sin(ang)])  # (n_fft+2, n_fft)

    window = np.zeros(n_fft)
    off = (n_fft - win_length) // 2
    window[off: off + win_length] = hann_window(win_length)
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
    return torch.as_tensor(w, dtype=dtype, device=device)


@lru_cache(maxsize=64)
def _safe_envelope(n_fft, hop, win, t, device, dtype):
    env = _window_envelope_np(n_fft, hop, win, t)
    env = np.where(env > 1.1754944e-38, env, 1.0)
    return torch.as_tensor(env, dtype=dtype, device=device)


def istft_multiband(mag, phase, n_fft: int, hop: int, win: int):
    """mag/phase: (B, T, sub, n_fft//2+1) -> (B, (T-1)*hop, sub), torch.istft
    ("torch" mode) semantics."""
    b, t, sub, _ = mag.shape
    spectra = torch.cat([mag * torch.cos(phase), mag * torch.sin(phase)], dim=-1)
    spectra = spectra.reshape(b, t, sub * (n_fft + 2))
    y = conv_transpose1d(spectra, _multiband_weight(n_fft, win, sub, mag.device, mag.dtype),
                         stride=hop)
    y = y / _safe_envelope(n_fft, hop, win, t, y.device, y.dtype)[None, :, None]
    half = n_fft // 2
    return y[:, half: y.shape[1] - half, :]


@lru_cache(maxsize=None)
def _fused_mb_kernel(n_fft: int, hop: int, win: int, sub: int, taps: int,
                     cutoff_ratio: float, beta: float):
    """Composite kernel for iSTFT (stride hop) -> steady-state envelope
    divide -> PQMF synthesis (zero-stuff x sub + FIR), collapsed into ONE
    transposed conv of stride hop*sub. Returns (G2 (Kc, C, 1) float32, off)
    in the JAX layout; the envelope is periodic (period hop) away from the
    signal edges, so it folds into the kernel per tap phase."""
    w1 = _inverse_dft_basis(n_fft, win).T  # w1[j, cc]: iSTFT tap j for spectral channel cc
    env = _window_envelope_np(n_fft, hop, win, 64)
    n0 = hop * (-(-(win - hop) // hop))  # first steady hop-aligned pos
    env_p = env[n0: n0 + hop]

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
def _fused_weight(n_fft, hop, win, sub, taps, cutoff_ratio, beta, device, dtype):
    g2, off = _fused_mb_kernel(n_fft, hop, win, sub, taps, cutoff_ratio, beta)
    return torch.as_tensor(np.ascontiguousarray(g2.transpose(1, 2, 0)), dtype=dtype,
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
    return (torch.as_tensor(mag_src, device=device), torch.as_tensor(phase_src, device=device),
            torch.as_tensor(off, dtype=dtype, device=device))


def mb_decoder_tail_fused(x, n_fft: int, hop: int, win: int, *, subbands: int, taps: int = 62,
                          cutoff_ratio: float = 0.15, beta: float = 9.0):
    """The MB-iSTFT tail after conv_post: x (B, T, sub*(n_fft+2)) ->
    waveform (B, (T-1)*hop*sub, 1). Equals

        spec, phase = exp(x4[..., :cutoff]), pi * sin(x4[..., cutoff:])
        pqmf_synthesis(istft_multiband(spec, phase, ...))

    (x4 the (B, T, sub, n_fft+2) view) to fp-reassociation tolerance."""
    b, t, _ = x.shape
    per = n_fft + 2
    cutoff = n_fft // 2 + 1
    stride = hop * subbands

    def unfused_4d(x_sl):
        xs = x_sl.reshape(x_sl.shape[0], x_sl.shape[1], subbands, per)
        y_mb = istft_multiband(torch.exp(xs[..., :cutoff]), np.pi * torch.sin(xs[..., cutoff:]),
                               n_fft, hop, win)
        return pqmf_synthesis(y_mb, subbands=subbands, taps=taps,
                              cutoff_ratio=cutoff_ratio, beta=beta)

    edge_frames = max(16, -(-((taps + 1) + 2 * win) // stride) + 2)
    if t < 2 * edge_frames + 1:
        return unfused_4d(x)

    mag_src, phase_src, off = _specphase_lanes(n_fft, subbands, x.device, x.dtype)
    spectra = torch.exp(x.index_select(-1, mag_src)) * torch.sin(
        np.pi * torch.sin(x.index_select(-1, phase_src)) + off)

    g2, off_k = _fused_weight(n_fft, hop, win, subbands, taps, cutoff_ratio, beta,
                              x.device, x.dtype)
    z = conv_transpose1d(spectra, g2, stride=stride)
    out = z[:, off_k: off_k + stride * (t - 1), :]

    patch = 8 * stride
    head = unfused_4d(x[:, :edge_frames])
    tail = unfused_4d(x[:, -edge_frames:])
    return torch.cat([head[:, :patch], out[:, patch: out.shape[1] - patch], tail[:, -patch:]],
                     dim=1)
