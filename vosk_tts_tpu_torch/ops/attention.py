"""Relative-position multi-head self-attention, conv FFN and the encoder
stack (vosk_tts_tpu/ops/attention.py), for inference.

Every banded self-attention goes through ``flash_attention.banded_flash_
attention``: its CUDA kernel on the card at any T, its plain version on the
CPU. Cross-attention without a relative window (GPT-SoVITS's MRTE) is plain
torch, as in the JAX package, where no Pallas kernel computes it. The forms
no ported path runs (windowless self-attention, banded cross-attention,
proximal bias, dropout) raise NotImplementedError.
"""

from __future__ import annotations

import math

import torch

from . import flash_attention as fa
from .conv import conv1d
from .norm import layer_norm


def mha_apply(params, x: torch.Tensor, c: torch.Tensor, attn_mask: torch.Tensor | None = None, *,
              n_heads: int, window_size: int | None = None,
              kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """Banded self-attention (``window_size`` set, ``c`` is ``x``, (B, T, C)):
    ``kv_len`` (B,) int32 is the valid key prefix (defaults to T); it stands
    for the JAX version's sequence-mask ``attn_mask``.

    Cross-attention (``window_size`` None, ``c`` (B, Ts, C) another tensor):
    ``attn_mask`` broadcastable to (B, H, Tt, Ts), 0 where a score is masked
    (to -1e4, as the JAX version masks it)."""
    if (window_size is None) == (c is x):
        raise NotImplementedError("only banded self-attention and windowless cross-attention "
                                  "are ported")
    b, t, channels = x.shape
    t_s = c.shape[1]
    d = channels // n_heads
    q = conv1d(x, params["q"]["w"], params["q"]["b"])
    k = conv1d(c, params["k"]["w"], params["k"]["b"])
    v = conv1d(c, params["v"]["w"], params["v"]["b"])
    heads = lambda a, n: a.reshape(b, n, n_heads, d).transpose(1, 2).contiguous()
    q, k, v = heads(q, t), heads(k, t_s), heads(v, t_s)
    if window_size is None:
        scores = torch.matmul(q / math.sqrt(d), k.transpose(-1, -2))
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask == 0, -1e4)
        out = torch.matmul(torch.softmax(scores, dim=-1), v)
    else:
        if kv_len is None:
            kv_len = torch.full((b,), t, dtype=torch.int32, device=x.device)
        out = fa.banded_flash_attention(q * d**-0.5, k, v, params["emb_rel_k"],
                                        params["emb_rel_v"], kv_len, window=window_size)
    out = out.transpose(1, 2).reshape(b, t, channels)
    return conv1d(out, params["o"]["w"], params["o"]["b"])


def ffn_apply(params, x, x_mask, *, kernel_size: int):
    """Conv FFN (ReLU) with (K-1)//2, K//2 padding."""
    pad = ((kernel_size - 1) // 2, kernel_size // 2)
    x = conv1d(x * x_mask, params["c1"]["w"], params["c1"]["b"], padding=pad)
    x = torch.relu(x)
    x = conv1d(x * x_mask, params["c2"]["w"], params["c2"]["b"], padding=pad)
    return x * x_mask


def encoder_apply(params, x, x_mask, g=None, *, n_heads: int, kernel_size: int,
                  window_size: int = 4, cond_layer_idx: int = 2):
    """x: (B, T, H); x_mask: (B, T, 1); g: (B, 1, gin) or None."""
    kv_len = x_mask[..., 0].sum(dim=1).to(torch.int32)
    x = x * x_mask
    for i in range(len(params["attn"])):
        if g is not None and i == cond_layer_idx:
            gp = torch.nn.functional.linear(g, params["spk_emb"]["w"], params["spk_emb"]["b"])
            x = (x + gp) * x_mask
        y = mha_apply(params["attn"][i], x, x, n_heads=n_heads, window_size=window_size,
                      kv_len=kv_len)
        x = layer_norm(x + y, params["norm1"][i]["gamma"], params["norm1"][i]["beta"])
        y = ffn_apply(params["ffn"][i], x, x_mask, kernel_size=kernel_size)
        x = layer_norm(x + y, params["norm2"][i]["gamma"], params["norm2"][i]["beta"])
    return x * x_mask
