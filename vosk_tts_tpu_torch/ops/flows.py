"""Normalizing-flow layers (vosk_tts_tpu/ops/flows.py), for inference:
Flip (its own inverse), the mean-only residual coupling layer in both
directions, and the reverse directions of ElementwiseAffine and ConvFlow
(the SDP reverse pass). The coupling's forward direction returns y alone:
no inference path reads a log-determinant. Channels-last: x (B, T, C),
mask (B, T, 1)."""

from __future__ import annotations

import math

import torch

from .conv import conv1d
from .transforms import piecewise_rational_quadratic_transform
from .wn import ddsconv_apply, wn_apply


def flip_flow(x):
    """Flip, forward or reverse: flips the channel axis."""
    return torch.flip(x, dims=(-1,))


def residual_coupling_apply(params, x, x_mask, g=None, *, reverse: bool, kernel_size: int,
                            dilation_rate: int):
    """Mean-only affine coupling (every user here: VITS2's plain flows,
    QuickVC): a WN conditioner over the first half of the channels gives
    the shift m of the second half (``post`` gives m alone; logs is 0)."""
    half = x.shape[-1] // 2
    x0, x1 = x[..., :half], x[..., half:]
    h = conv1d(x0, params["pre"]["w"], params["pre"]["b"]) * x_mask
    h = wn_apply(params["enc"], h, x_mask, g, kernel_size=kernel_size,
                 dilation_rate=dilation_rate)
    m = conv1d(h, params["post"]["w"], params["post"]["b"]) * x_mask
    x1 = (x1 - m) * x_mask if reverse else m + x1 * x_mask
    return torch.cat([x0, x1], dim=-1)


def elementwise_affine_apply(params, x, x_mask):
    """Reverse of ElementwiseAffine."""
    return (x - params["m"]) * torch.exp(-params["logs"]) * x_mask


def convflow_apply(params, x, x_mask, g=None, *, filter_channels: int, kernel_size: int,
                   num_bins: int = 10, tail_bound: float = 5.0):
    """Reverse of ConvFlow: neural spline coupling over half the channels;
    its DDSConv stack runs through ``wn.ddsconv_apply``."""
    half = x.shape[-1] // 2
    x0, x1 = x[..., :half], x[..., half:]
    h = conv1d(x0, params["pre"]["w"], params["pre"]["b"])
    h = ddsconv_apply(params["convs"], h, x_mask, g=g, kernel_size=kernel_size)
    h = conv1d(h, params["proj"]["w"], params["proj"]["b"]) * x_mask

    b, t, _ = x0.shape
    h = h.reshape(b, t, half, num_bins * 3 - 1)
    denom = math.sqrt(filter_channels)
    uw = h[..., :num_bins] / denom
    uh = h[..., num_bins: 2 * num_bins] / denom
    ud = h[..., 2 * num_bins:]
    x1, _ = piecewise_rational_quadratic_transform(x1, uw, uh, ud, tail_bound=tail_bound)
    return torch.cat([x0, x1], dim=-1) * x_mask
