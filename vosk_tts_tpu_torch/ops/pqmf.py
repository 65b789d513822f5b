"""Pseudo-QMF synthesis filterbank (the MB-iSTFT combine stage,
vosk_tts_tpu/ops/pqmf.py). Filters are built once in numpy; synthesis is
one strided transposed conv (the JAX package's block-Toeplitz form of the
same FIR is a TPU lowering)."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from scipy.signal.windows import kaiser

from .conv import conv_transpose1d


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
def _synthesis_weight(subbands, taps, cutoff_ratio, beta, device, dtype):
    """Zero-stuff (x subbands gain) + synthesis-filter correlation as a
    transposed-conv weight (C_in=subbands, C_out=1, K)."""
    _, h_s = pqmf_filters(subbands, taps, cutoff_ratio, beta)
    w = h_s[:, ::-1] * float(subbands)  # flipped: correlation -> convolution
    return torch.as_tensor(np.ascontiguousarray(w[:, None, :]), dtype=dtype, device=device)


def pqmf_synthesis(x: torch.Tensor, subbands: int = 4, taps: int = 62,
                   cutoff_ratio: float = 0.15, beta: float = 9.0) -> torch.Tensor:
    """x: (B, T, subbands) -> (B, T*subbands, 1)."""
    k = taps + 1
    half = (k - 1) // 2
    if half < subbands - 1:
        raise ValueError(f"pqmf_synthesis: {taps} taps are too few for {subbands} subbands")
    w = _synthesis_weight(subbands, taps, cutoff_ratio, beta, x.device, x.dtype)
    y = conv_transpose1d(x, w, stride=subbands)
    return y[:, k - 1 - half: k - 1 - half + x.shape[1] * subbands]
