"""BigVGAN v2 vocoder (vosk_tts_tpu/models/bigvgan.py), channels-last.

A HiFiGAN-style trunk of transposed convs whose AMP blocks use Snake or
SnakeBeta activations wrapped in alias-free 2x resampling: replicate pad,
upsample by a zero-stuffed transposed conv with a Kaiser-windowed sinc
filter, the activation, then the same low-pass at stride 2. The filter is
one 12-tap kernel shared by every channel, so both resamplers are
depthwise convs here (the JAX package folds the channels into the batch).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv import constant, conv1d, conv_transpose1d

RATIO = 2  # the alias-free resampling factor
TAPS = int(6 * RATIO // 2) * 2  # 12


@dataclass(frozen=True)
class BigVGANConfig:
    num_mels: int = 80
    upsample_rates: Sequence[int] = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: Sequence[int] = (8, 8, 4, 4, 4, 4)
    upsample_initial_channel: int = 1536
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    activation: str = "snakebeta"  # snake | snakebeta
    snake_logscale: bool = True
    use_bias_at_final: bool = False
    use_tanh_at_final: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "BigVGANConfig":
        """From a bundle's ``"vocoder_config"`` block, where JSON lists stand
        for tuples."""
        tup = lambda v: tuple(tup(e) for e in v) if isinstance(v, list) else v
        return cls(**{k: tup(v) for k, v in d.items()})


@lru_cache(maxsize=None)
def _kaiser_sinc_filter(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """The alias-free-torch low-pass: a Kaiser-windowed sinc, normalised to
    unit sum (float32, (kernel_size,))."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    time = np.arange(-half_size, half_size) + 0.5 if even else np.arange(kernel_size) - half_size
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    return (filt / filt.sum()).astype(np.float32)


@lru_cache(maxsize=16)
def _filter(channels: int, scale: float, device, dtype):
    """The shared low-pass as a depthwise weight (C, 1, TAPS)."""
    filt = _kaiser_sinc_filter(0.5 / RATIO, 0.6 / RATIO, TAPS) * scale
    return constant(np.tile(filt, (channels, 1, 1)), dtype=dtype, device=device)


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Alias-free 2x upsampling: x (B, T, C) -> (B, 2T, C)."""
    c = x.shape[-1]
    pad = TAPS // RATIO - 1
    crop_l = pad * RATIO + (TAPS - RATIO) // 2
    crop_r = pad * RATIO + (TAPS - RATIO + 1) // 2
    xt = F.pad(x.transpose(1, 2), (pad, pad), mode="replicate")
    y = F.conv_transpose1d(xt, _filter(c, float(RATIO), x.device, x.dtype), stride=RATIO,
                           groups=c)
    return y[..., crop_l: y.shape[-1] - crop_r].transpose(1, 2)


def _downsample2(x: torch.Tensor) -> torch.Tensor:
    """Alias-free 2x downsampling: the low-pass at stride 2 over the
    replicate-padded x (B, T, C) -> (B, T/2, C)."""
    c = x.shape[-1]
    xt = F.pad(x.transpose(1, 2), (TAPS // 2 - 1, TAPS // 2), mode="replicate")
    y = F.conv1d(xt, _filter(c, 1.0, x.device, x.dtype), stride=RATIO, groups=c)
    return y.transpose(1, 2)


def _snake(x, p, cfg: BigVGANConfig):
    """x + sin(alpha x)^2 / alpha (snake) or / beta (snakebeta); alpha and
    beta (C,) on the log scale where ``snake_logscale``."""
    alpha = p["alpha"]
    beta = p["beta"] if cfg.activation == "snakebeta" else alpha
    if cfg.snake_logscale:
        alpha, beta = torch.exp(alpha), torch.exp(beta)
    return x + (1.0 / (beta + 1e-9)) * torch.sin(alpha * x) ** 2


def _act(x, p, cfg: BigVGANConfig):
    """Anti-aliased activation: upsample 2x, snake, downsample 2x."""
    return _downsample2(_snake(_upsample2(x), p, cfg))


def _amp_block(params, x, cfg: BigVGANConfig, kernel_size: int, dilations):
    """AMPBlock1: x + c2(act(c1(act(x)))) for each dilation in turn."""
    for c1, c2, a1, a2, d in zip(params["convs1"], params["convs2"], params["acts1"],
                                 params["acts2"], dilations):
        xt = conv1d(_act(x, a1, cfg), c1["w"], c1["b"], padding=(kernel_size * d - d) // 2,
                    dilation=d)
        xt = conv1d(_act(xt, a2, cfg), c2["w"], c2["b"], padding=(kernel_size - 1) // 2)
        x = x + xt
    return x


def bigvgan_apply(params, cfg: BigVGANConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel: (B, T, num_mels) -> wav (B, T * prod(upsample_rates)), tanh or
    clipped to [-1, 1] at the end."""
    n_res = len(cfg.resblock_kernel_sizes)
    x = conv1d(mel, params["conv_pre"]["w"], params["conv_pre"]["b"], padding=3)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        x = conv_transpose1d(x, params["ups"][i]["w"], params["ups"][i]["b"], stride=u,
                             padding=(k - u) // 2)
        xs = None
        for j, (kr, dr) in enumerate(zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)):
            r = _amp_block(params["resblocks"][i * n_res + j], x, cfg, kr, dr)
            xs = r if xs is None else xs + r
        x = xs / n_res
    x = _act(x, params["act_post"], cfg)
    x = conv1d(x, params["conv_post"]["w"], params["conv_post"].get("b"), padding=3)
    x = torch.tanh(x) if cfg.use_tanh_at_final else torch.clamp(x, -1.0, 1.0)
    return x[..., 0]


def bigvgan_from_state_dict(sd: dict, cfg: BigVGANConfig) -> dict:
    """Official BigVGAN checkpoint (weight norm folded) -> the bundle-layout
    tree (vosk_tts_tpu/models/bigvgan.py:195)."""
    from ..utils.torch_params import _np, conv, convT, fold_weight_norm

    sd = fold_weight_norm(sd)
    n_res = len(cfg.resblock_kernel_sizes)
    snake = lambda p: {"alpha": _np(sd[p + ".alpha"]),
                       **({"beta": _np(sd[p + ".beta"])} if cfg.activation == "snakebeta" else {})}
    p = {"conv_pre": conv(sd, "conv_pre"), "ups": [], "resblocks": []}
    for i in range(len(cfg.upsample_rates)):
        p["ups"].append(convT(sd, f"ups.{i}.0"))
        for j in range(n_res):
            r = f"resblocks.{i * n_res + j}"
            n_d = len(cfg.resblock_dilation_sizes[j])
            p["resblocks"].append({
                "convs1": [conv(sd, f"{r}.convs1.{d}") for d in range(n_d)],
                "convs2": [conv(sd, f"{r}.convs2.{d}") for d in range(n_d)],
                "acts1": [snake(f"{r}.activations.{2 * d}.act") for d in range(n_d)],
                "acts2": [snake(f"{r}.activations.{2 * d + 1}.act") for d in range(n_d)],
            })
    p["act_post"] = snake("activation_post.act")
    p["conv_post"] = conv(sd, "conv_post")
    return p
