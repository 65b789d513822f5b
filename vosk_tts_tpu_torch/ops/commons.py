"""Mask / alignment utilities (vosk_tts_tpu/ops/commons.py)."""

from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """Boolean mask (B, T): True for positions < length."""
    pos = torch.arange(max_length, dtype=lengths.dtype, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def generate_path(durations: torch.Tensor, x_mask: torch.Tensor, y_mask: torch.Tensor) -> torch.Tensor:
    """Durations (B, Tx) (integral floats), x_mask (B, Tx), y_mask (B, Ty) ->
    (B, Ty, Tx) one-hot monotonic path: frame t belongs to token s iff
    cum[s-1] <= t < cum[s]."""
    t_y = y_mask.shape[1]
    cum = torch.cumsum(durations * x_mask, dim=-1)
    pos = torch.arange(t_y, dtype=cum.dtype, device=cum.device)
    below = pos[None, :, None] < cum[:, None, :]
    prev = torch.nn.functional.pad(below[:, :, :-1], (1, 0))
    path = below & ~prev
    return path.to(cum.dtype) * x_mask[:, None, :] * y_mask[:, :, None]


def fused_gate(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """tanh(first half) * sigmoid(second half) of a + b (channel axis)."""
    s = a + b
    n = s.shape[-1] // 2
    return torch.tanh(s[..., :n]) * torch.sigmoid(s[..., n:])
