"""Normalization ops (channels-last)."""

from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the channel (last) axis, as vosk_tts_tpu/ops/norm.py."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta
