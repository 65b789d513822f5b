"""Gated/dilated conv stacks: WN, ResBlock1/2, DDSConv
(vosk_tts_tpu/ops/wn.py), without dropout (training runs none). Weight norm
is folded into the stored weights, as in the bundle."""

from __future__ import annotations

import torch

from . import ddsconv_fused as ddf
from .commons import fused_gate
from ..parallel import tp as ptp
from .conv import conv1d

LRELU_SLOPE = 0.1


def leaky_relu(x, slope: float = LRELU_SLOPE):
    return torch.where(x >= 0, x, slope * x)


def wn_apply(params, x, x_mask, g=None, *, kernel_size: int, dilation_rate: int):
    """x: (B, T, H), x_mask: (B, T, 1), g: (B, Tg, gin) or None -> (B, T, H)."""
    hidden = x.shape[-1]
    n_layers = len(params["in"])
    if g is not None:
        g = conv1d(g, params["cond"]["w"], params["cond"]["b"])
    output = torch.zeros_like(x)
    for i in range(n_layers):
        dilation = dilation_rate**i
        pad = (kernel_size * dilation - dilation) // 2
        x_in = conv1d(x, params["in"][i]["w"], params["in"][i]["b"], padding=pad, dilation=dilation)
        g_l = g[..., 2 * hidden * i: 2 * hidden * (i + 1)] if g is not None else torch.zeros_like(x_in)
        acts = fused_gate(x_in, g_l)
        rs = conv1d(acts, params["res_skip"][i]["w"], params["res_skip"][i]["b"])
        if i < n_layers - 1:
            x = (x + rs[..., :hidden]) * x_mask
            output = output + rs[..., hidden:]
        else:
            output = output + rs
    return output * x_mask


def resblock1_apply(params, x, x_mask=None, *, kernel_size: int = 3, dilation=(1, 3, 5),
                    tp=None):
    """HiFiGAN ResBlock1. ``x_mask`` (B, T, 1), where given, zeroes every
    conv input and the output beyond each row's length (bucketed decodes).
    ``tp``: the block's tensor-parallel scope (parallel/tp.py), x whole or
    channel-sharded."""
    for j, (c1, c2, d) in enumerate(zip(params["convs1"], params["convs2"], dilation)):
        xt = leaky_relu(x)
        if x_mask is not None:
            xt = xt * x_mask
        xt = ptp.conv(tp, ("convs1", j), xt, c1, padding=(kernel_size * d - d) // 2, dilation=d)
        xt = leaky_relu(xt)
        if x_mask is not None:
            xt = xt * x_mask
        xt = ptp.conv(tp, ("convs2", j), xt, c2, padding=(kernel_size - 1) // 2)
        x = xt + x if tp is None else tp.add(xt, x)
    return x if x_mask is None else x * x_mask


def resblock2_apply(params, x, x_mask=None, *, kernel_size: int = 3, dilation=(1, 3), tp=None):
    """HiFiGAN ResBlock2; ``x_mask`` and ``tp`` as in :func:`resblock1_apply`."""
    for j, (c, d) in enumerate(zip(params["convs"], dilation)):
        xt = leaky_relu(x)
        if x_mask is not None:
            xt = xt * x_mask
        xt = ptp.conv(tp, ("convs", j), xt, c, padding=(kernel_size * d - d) // 2, dilation=d)
        x = xt + x if tp is None else tp.add(xt, x)
    return x if x_mask is None else x * x_mask


def ddsconv_apply(params, x, x_mask, g=None, *, kernel_size: int, fused: bool = True):
    """DDSConv stack (x + g first). ``fused`` (serving) runs it through the
    fused kernel's wrapper (ops/ddsconv_fused.py: the CUDA kernel on the card,
    its plain version on the CPU); training passes False and takes the plain
    version, which autograd differentiates (the kernel has no backward)."""
    if g is not None:
        x = x + g
    if not fused:
        return ddf.ddsconv_plain(x, x_mask, params, kernel_size=kernel_size)
    return ddf.ddsconv_fused(x, x_mask, params, kernel_size=kernel_size)
