"""Normalizing-flow layers (vosk_tts_tpu/ops/flows.py): Log, Flip (its own
inverse, log-determinant 0), the mean-only residual coupling layer in both
directions (its log-determinant is 0 too: no caller reads it), and
ElementwiseAffine and ConvFlow in both directions. Forward returns
``(y, logdet)`` with logdet (B,), reverse returns y: the SDP's training NLL
runs them forward, its sampling pass in reverse. Channels-last: x (B, T, C),
mask (B, T, 1)."""

from __future__ import annotations

import math

import torch

from .conv import conv1d
from .transforms import piecewise_rational_quadratic_transform
from .wn import ddsconv_apply, wn_apply


def log_flow(x, x_mask):
    """Forward Log flow: y = log(max(x, 1e-5)) * mask, logdet = -sum(y)."""
    y = torch.log(x.clamp(min=1e-5)) * x_mask
    return y, -y.sum(dim=(1, 2))


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


def elementwise_affine_apply(params, x, x_mask, *, reverse: bool):
    """ElementwiseAffine: y = (m + exp(logs) * x) * mask forward (with
    logdet sum(logs * mask)), its inverse in reverse."""
    if reverse:
        return (x - params["m"]) * torch.exp(-params["logs"]) * x_mask
    y = (params["m"] + torch.exp(params["logs"]) * x) * x_mask
    return y, (params["logs"] * x_mask).sum(dim=(1, 2))


def convflow_apply(params, x, x_mask, g=None, *, reverse: bool, filter_channels: int,
                   kernel_size: int, num_bins: int = 10, tail_bound: float = 5.0,
                   fused: bool = True):
    """ConvFlow: neural spline coupling over half the channels, forward
    (with logdet) or in reverse. Its DDSConv stack runs through
    ``wn.ddsconv_apply`` (``fused``: the kernel on the card; training passes
    False, the differentiable form)."""
    half = x.shape[-1] // 2
    x0, x1 = x[..., :half], x[..., half:]
    h = conv1d(x0, params["pre"]["w"], params["pre"]["b"])
    h = ddsconv_apply(params["convs"], h, x_mask, g=g, kernel_size=kernel_size, fused=fused)
    h = conv1d(h, params["proj"]["w"], params["proj"]["b"]) * x_mask

    b, t, _ = x0.shape
    h = h.reshape(b, t, half, num_bins * 3 - 1)
    denom = math.sqrt(filter_channels)
    uw = h[..., :num_bins] / denom
    uh = h[..., num_bins: 2 * num_bins] / denom
    ud = h[..., 2 * num_bins:]
    x1, logabsdet = piecewise_rational_quadratic_transform(x1, uw, uh, ud, inverse=reverse,
                                                           tail_bound=tail_bound)
    y = torch.cat([x0, x1], dim=-1) * x_mask
    if reverse:
        return y
    return y, (logabsdet * x_mask).sum(dim=(1, 2))
