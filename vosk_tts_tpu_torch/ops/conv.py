"""1-D convolutions over channels-last (B, T, C) activations.

Same padding / output_padding semantics as vosk_tts_tpu/ops/conv.py, with
weights in the port's layouts (utils/params.py): Conv1d (O, I, K), a 1x1
conv as a Linear (O, I), depthwise (C, 1, K), ConvTranspose1d (I, O, K).
The JAX package's subpixel decomposition of the transposed conv is a TPU
lowering; here it is ``F.conv_transpose1d``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def constant(a, device, dtype=None) -> torch.Tensor:
    """A tensor of a cached constant (a filter, a basis), made outside
    inference mode: a serving call under ``torch.inference_mode`` may make
    it first, and a training graph must be able to save it for backward."""
    with torch.inference_mode(False):
        return torch.as_tensor(a, dtype=dtype, device=device)


def _norm_padding(padding, k: int, dilation: int):
    if padding == "same":
        p = (k - 1) * dilation // 2
        return p, (k - 1) * dilation - p
    if isinstance(padding, int):
        return padding, padding
    return tuple(padding)


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           stride: int = 1, padding="same", dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """x: (B, T, C_in); w: (C_out, C_in // groups, K), or (C_out, C_in) for a
    1x1 conv -> (B, T', C_out)."""
    if w.dim() == 2:
        if groups != 1 or _norm_padding(padding, 1, dilation) != (0, 0):
            raise ValueError("a 1x1 conv takes no groups or padding")
        return F.linear(x[:, ::stride], w, b)
    pl, pr = _norm_padding(padding, w.shape[-1], dilation)
    xt = F.pad(x.transpose(1, 2), (pl, pr))
    y = F.conv1d(xt, w, b, stride=stride, dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def depthwise_conv1d(x, w, b=None, *, padding="same", dilation: int = 1):
    """Depthwise conv: w (C, 1, K)."""
    return conv1d(x, w, b, padding=padding, dilation=dilation, groups=x.shape[-1])


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
                     stride: int, padding: int = 0, output_padding: int = 0) -> torch.Tensor:
    """torch ConvTranspose1d semantics. x: (B, T, C_in); w: (C_in, C_out, K)
    -> (B, (T-1)*stride - 2*padding + K + output_padding, C_out)."""
    y = F.conv_transpose1d(x.transpose(1, 2), w, b, stride=stride, padding=padding,
                           output_padding=output_padding)
    return y.transpose(1, 2)
