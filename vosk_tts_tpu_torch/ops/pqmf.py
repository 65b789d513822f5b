"""Pseudo-QMF filterbank: analysis (training's subband STFT loss) and
synthesis (the MB-iSTFT combine stage), and the ms-iSTFT learned upsampling
filter (vosk_tts_tpu/ops/pqmf.py). Filters are built once in numpy; each
stage is one strided conv or transposed conv (the JAX package's
block-Toeplitz form of the same FIR is a TPU lowering)."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from scipy.signal.windows import kaiser

from .conv import constant, conv1d, conv_transpose1d


def design_prototype_filter(taps: int = 62, cutoff_ratio: float = 0.15, beta: float = 9.0) -> np.ndarray:
    """Kaiser-window lowpass prototype."""
    assert taps % 2 == 0
    omega_c = np.pi * cutoff_ratio
    n = np.arange(taps + 1) - 0.5 * taps
    with np.errstate(invalid="ignore"):
        h_i = np.sin(omega_c * n) / (np.pi * n)
    h_i[taps // 2] = cutoff_ratio
    return h_i * kaiser(taps + 1, beta)


@lru_cache(maxsize=None)
def pqmf_filters(subbands: int = 4, taps: int = 62, cutoff_ratio: float = 0.15, beta: float = 9.0):
    """(h_analysis, h_synthesis), each (subbands, taps+1) float32."""
    h_proto = design_prototype_filter(taps, cutoff_ratio, beta)
    n = np.arange(taps + 1) - (taps - 1) / 2
    k = np.arange(subbands)[:, None]
    phase = (2 * k + 1) * (np.pi / (2 * subbands)) * n[None, :]
    sign = ((-1.0) ** k) * np.pi / 4
    h_analysis = 2 * h_proto[None, :] * np.cos(phase + sign)
    h_synthesis = 2 * h_proto[None, :] * np.cos(phase - sign)
    return h_analysis.astype(np.float32), h_synthesis.astype(np.float32)


@lru_cache(maxsize=16)
def _analysis_weight(subbands, device, dtype):
    """The analysis filters (the default prototype) as a conv weight
    (C_out=subbands, C_in=1, K)."""
    h_a, _ = pqmf_filters(subbands)
    return constant(h_a[:, None, :], dtype=dtype, device=device)


def pqmf_analysis(x: torch.Tensor, subbands: int = 4) -> torch.Tensor:
    """x: (B, T, 1) -> (B, T//subbands, subbands): zero-pad taps/2 a side,
    correlate with the analysis filters, keep every ``subbands``-th sample."""
    w = _analysis_weight(subbands, x.device, x.dtype)
    return conv1d(x, w, stride=subbands, padding=(w.shape[-1] - 1) // 2)


@lru_cache(maxsize=16)
def _synthesis_weight(subbands, taps, cutoff_ratio, beta, device, dtype):
    """The synthesis filter as a correlation weight (C_out=1, C_in=subbands, K)."""
    _, h_s = pqmf_filters(subbands, taps, cutoff_ratio, beta)
    return constant(h_s[None], dtype=dtype, device=device)


def polyphase_upfir(x: torch.Tensor, w: torch.Tensor, *, stride: int,
                    gain: float = 1.0) -> torch.Tensor:
    """Zero-stuff x by ``stride`` (times ``gain``), then correlate with ``w``
    at padding (K-1)//2: x (B, T, C_in), w (C_out, C_in, K), K odd ->
    (B, T*stride, C_out). The ms-iSTFT ``multistream_conv_post`` stage
    (vosk_tts_tpu/ops/pqmf.py, through blocked_fir.upsampled_corr). A
    correlation with w is a convolution with w flipped: one strided
    transposed conv."""
    k = w.shape[-1]
    half = (k - 1) // 2
    if half < stride - 1:
        raise ValueError(f"polyphase_upfir: a {k}-tap filter is too short for stride {stride}")
    wt = torch.flip(w, dims=(-1,)).transpose(0, 1) * gain  # (C_in, C_out, K)
    y = conv_transpose1d(x, wt, stride=stride)
    return y[:, k - 1 - half: k - 1 - half + x.shape[1] * stride]


def pqmf_synthesis(x: torch.Tensor, subbands: int = 4, taps: int = 62,
                   cutoff_ratio: float = 0.15, beta: float = 9.0) -> torch.Tensor:
    """x: (B, T, subbands) -> (B, T*subbands, 1)."""
    w = _synthesis_weight(subbands, taps, cutoff_ratio, beta, x.device, x.dtype)
    return polyphase_upfir(x, w, stride=subbands, gain=float(subbands))
