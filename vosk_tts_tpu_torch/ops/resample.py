"""Sample-rate conversion as one strided conv (vosk_tts_tpu/ops/resample.py).

The WavLM/SLM losses resample 22.05 kHz segments to 16 kHz. The filter is
torchaudio's polyphase windowed sinc (Hann^2 window, lowpass_filter_width
6, rolloff 0.99), built in numpy float64 as the JAX package builds it and
cast to f32. The polyphase bank is one ``F.conv1d`` with ``new`` output
channels and stride ``orig``; the phases then interleave frame by frame.
For 22050 -> 16000: gcd 50, so 441 -> 320, width 9, 459 taps.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .conv import constant


@lru_cache(maxsize=None)
def _resample_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                     rolloff: float = 0.99):
    """(the bank (new, K) f32, orig, new, width), orig and new reduced by
    their gcd, K = 2 width + orig."""
    g = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // g, new_freq // g
    base = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base)
    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx
    t *= base
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t *= np.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel *= window * base / orig
    return kernel.astype(np.float32), orig, new, width


@lru_cache(maxsize=16)
def _conv_weight(orig_freq, new_freq, lowpass_filter_width, rolloff, device, dtype):
    """The bank as a conv weight (new, 1, K) on ``device``."""
    kernel = _resample_kernel(orig_freq, new_freq, lowpass_filter_width, rolloff)[0]
    return constant(kernel[:, None, :], device=device, dtype=dtype)


def resample(x: torch.Tensor, orig_freq: int, new_freq: int, *, lowpass_filter_width: int = 6,
             rolloff: float = 0.99) -> torch.Tensor:
    """x: (B, T) -> (B, ceil(T * new / orig)), differentiable in x."""
    _, orig, new, width = _resample_kernel(orig_freq, new_freq, lowpass_filter_width, rolloff)
    w = _conv_weight(orig_freq, new_freq, lowpass_filter_width, rolloff, x.device, x.dtype)
    b, t = x.shape
    target_len = -(-t * new // orig)
    xp = F.pad(x, (width, width + orig))
    y = F.conv1d(xp[:, None, :], w, stride=orig)  # (B, new, frames)
    # frame-major: sample frame * new + phase
    return y.transpose(1, 2).reshape(b, -1)[:, :target_len]
