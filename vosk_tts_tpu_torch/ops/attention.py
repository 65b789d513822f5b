"""Relative-position multi-head attention, conv FFN, the encoder stack and
the FFT flow block (vosk_tts_tpu/ops/attention.py).

A banded self-attention takes one of two routes, chosen by the caller's
``flash`` argument as in the JAX package. ``flash=True`` (serving, the
default) goes through ``flash_attention.banded_flash_attention``: its CUDA
kernel on the card at any T, its plain version on the CPU. ``flash=False``
(training: the kernel has no backward) is the differentiable torch form of
the JAX package's XLA branch: the dense scores with the relative logits
added along the band, the (query x key) sequence mask at -1e4, softmax,
and the band of the probabilities against the relative values. The two
agree on valid rows; a padded query row attends to its valid keys through
the kernel and uniformly to every key through the dense form (its output
is masked by every caller).

Windowless self-attention under a key-prefix mask (the ``pre_conv`` and
``mono_layer_*`` flows) takes the same choice: ``flash=True`` goes through
``flash_attention.global_flash_attention`` (kernel 5 on the card, its plain
version on the CPU) with ``kv_len``; the JAX package computes this form in
XLA with the (query x key) mask at -1e4, so again only valid rows agree.
The dense torch form (scores, an optional proximal bias, the mask at -1e4,
softmax) computes everything else: the causal self-attention of
``fft_apply`` (``subsequent_mask``), a windowless self-attention with
``flash=False``, and the cross-attention of GPT-SoVITS's MRTE, as the JAX
package computes them (no Pallas kernel does). Banded cross-attention
raises NotImplementedError (no path of either package runs it); dropout
belongs to training and is not ported.
"""

from __future__ import annotations

import math

import torch

from . import flash_attention as fa
from .commons import fused_gate, subsequent_mask
from .conv import conv1d
from .norm import layer_norm


def _relative_embeddings(emb, length: int, window: int):
    """Slice or zero-pad the (H, 2w+1, d) table to (H, 2L-1, d)."""
    pad = max(length - (window + 1), 0)
    start = max((window + 1) - length, 0)
    if pad > 0:
        emb = torch.nn.functional.pad(emb, (0, 0, pad, pad))
    return emb[:, start: start + 2 * length - 1]


def _relative_to_absolute(x):
    """(B, H, L, 2L-1) -> (B, H, L, L) by the pad/reshape skew."""
    b, h, l, _ = x.shape
    x = torch.nn.functional.pad(x, (0, 1)).reshape(b, h, l * 2 * l)
    x = torch.nn.functional.pad(x, (0, l - 1))
    return x.reshape(b, h, l + 1, 2 * l - 1)[:, :, :l, l - 1:]


def _absolute_to_relative(x):
    """(B, H, L, L) -> (B, H, L, 2L-1)."""
    b, h, l, _ = x.shape
    x = torch.nn.functional.pad(x, (0, l - 1)).reshape(b, h, l * l + l * (l - 1))
    x = torch.nn.functional.pad(x, (l, 0))
    return x.reshape(b, h, l, 2 * l)[:, :, :, 1:]


def _grid(rows: int, cols: int, device):
    return torch.arange(rows, device=device)[:, None], torch.arange(cols, device=device)[None, :]


def _band_to_full(rel, w: int, length: int):
    """(B, H, L, 2w+1) -> (B, H, L, L): out[i, i+m-w] = rel[i, m], zeros
    off the band (L >= 2w+1)."""
    b, h, l, k = rel.shape
    flat = torch.nn.functional.pad(rel, (0, length + 1 - k)).reshape(b, h, l * (length + 1))
    full = flat[..., w: w + l * length].reshape(b, h, l, length)
    i, j = _grid(l, length, rel.device)
    return torch.where((i - j).abs() <= w, full, torch.zeros((), dtype=full.dtype,
                                                             device=full.device))


def _full_to_band(p, w: int):
    """(B, H, L, L) -> (B, H, L, 2w+1): out[i, m] = p[i, i+m-w], zeros out
    of range (L >= 2w+1)."""
    b, h, l, _ = p.shape
    k = 2 * w + 1
    flat = torch.nn.functional.pad(p.reshape(b, h, l * l), (w, l - w))
    band = flat.reshape(b, h, l, l + 1)[..., :k]
    i, m = _grid(l, k, p.device)
    valid = (i + m - w >= 0) & (i + m - w < l)
    return torch.where(valid, band, torch.zeros((), dtype=band.dtype, device=band.device))


def banded_attention_dense(q, k, v, rel_k, rel_v, attn_mask, *, window: int):
    """The training route (the JAX XLA branch): q, k, v (B, H, T, D), q NOT
    pre-scaled; rel_k, rel_v (n_rel, 2w+1, D); attn_mask broadcastable to
    (B, H, T, T), 0 where a score is masked. Returns (B, H, T, D)."""
    h, t, d = q.shape[1], k.shape[2], q.shape[-1]
    rel_k, rel_v = rel_k.expand(h, -1, -1), rel_v.expand(h, -1, -1)
    qs = q / math.sqrt(d)
    scores = torch.matmul(qs, k.transpose(-1, -2))
    banded = t >= 2 * window + 1
    if banded:
        scores = scores + _band_to_full(torch.einsum("bhld,hmd->bhlm", qs, rel_k), window, t)
    else:
        rel = torch.einsum("bhld,hmd->bhlm", qs, _relative_embeddings(rel_k, t, window))
        scores = scores + _relative_to_absolute(rel)
    scores = scores.masked_fill(attn_mask == 0, -1e4)
    p = torch.softmax(scores, dim=-1)
    out = torch.matmul(p, v)
    if banded:
        return out + torch.einsum("bhlm,hmd->bhld", _full_to_band(p, window), rel_v)
    return out + torch.einsum("bhlm,hmd->bhld", _absolute_to_relative(p),
                              _relative_embeddings(rel_v, t, window))


def _proximal_bias(length: int, device):
    """-log(1 + |j - i|) (1, 1, T, T): the reference's proximal bias."""
    r = torch.arange(length, dtype=torch.float32, device=device)
    return -torch.log1p((r[None, :] - r[:, None]).abs())[None, None]


def mha_apply(params, x: torch.Tensor, c: torch.Tensor, attn_mask: torch.Tensor | None = None, *,
              n_heads: int, window_size: int | None = None,
              kv_len: torch.Tensor | None = None, flash: bool = True,
              proximal_bias: bool = False) -> torch.Tensor:
    """x (queries): (B, T, C); c (keys and values): (B, Ts, C), ``x`` itself
    for self-attention.

    Banded self-attention (``window_size`` set) by the route ``flash``
    picks: the kernel's wrapper, where ``kv_len`` (B,) int32 is the valid
    key prefix (defaults to T) and stands for the sequence mask; or, with
    ``flash=False``, :func:`banded_attention_dense` under ``attn_mask``
    (None: no mask).

    Windowless self-attention with ``flash`` and neither ``attn_mask`` nor
    ``proximal_bias``: ``flash_attention.global_flash_attention`` under
    ``kv_len``. Every other windowless form is dense: ``attn_mask``
    broadcastable to (B, H, T, Ts), 0 where a score is masked (to -1e4, as
    the JAX version masks it), after the proximal bias where asked."""
    if window_size is not None and c is not x:
        raise NotImplementedError("banded cross-attention is not ported")
    b, t, channels = x.shape
    t_s = c.shape[1]
    d = channels // n_heads
    q = conv1d(x, params["q"]["w"], params["q"]["b"])
    k = conv1d(c, params["k"]["w"], params["k"]["b"])
    v = conv1d(c, params["v"]["w"], params["v"]["b"])
    if window_size is None and c is x and flash and attn_mask is None and not proximal_bias:
        if kv_len is None:
            kv_len = torch.full((b,), t, dtype=torch.int32, device=x.device)
        out = fa.global_flash_attention(q, k, v, kv_len, n_heads=n_heads, sm_scale=d**-0.5)
        return conv1d(out, params["o"]["w"], params["o"]["b"])
    heads = lambda a, n: a.reshape(b, n, n_heads, d).transpose(1, 2).contiguous()
    q, k, v = heads(q, t), heads(k, t_s), heads(v, t_s)
    if window_size is None:
        scores = torch.matmul(q / math.sqrt(d), k.transpose(-1, -2))
        if proximal_bias:
            scores = scores + _proximal_bias(t_s, x.device)
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask == 0, -1e4)
        out = torch.matmul(torch.softmax(scores, dim=-1), v)
    elif not flash:
        mask = torch.ones((), device=x.device) if attn_mask is None else attn_mask
        out = banded_attention_dense(q, k, v, params["emb_rel_k"], params["emb_rel_v"], mask,
                                     window=window_size)
    else:
        if kv_len is None:
            kv_len = torch.full((b,), t, dtype=torch.int32, device=x.device)
        out = fa.banded_flash_attention(q * d**-0.5, k, v, params["emb_rel_k"],
                                        params["emb_rel_v"], kv_len, window=window_size)
    out = out.transpose(1, 2).reshape(b, t, channels)
    return conv1d(out, params["o"]["w"], params["o"]["b"])


def ffn_apply(params, x, x_mask, *, kernel_size: int, causal: bool = False):
    """Conv FFN (ReLU) with (K-1)//2, K//2 padding, or K-1, 0 where
    ``causal``."""
    pad = (kernel_size - 1, 0) if causal else ((kernel_size - 1) // 2, kernel_size // 2)
    x = conv1d(x * x_mask, params["c1"]["w"], params["c1"]["b"], padding=pad)
    x = torch.relu(x)
    x = conv1d(x * x_mask, params["c2"]["w"], params["c2"]["b"], padding=pad)
    return x * x_mask


def encoder_apply(params, x, x_mask, g=None, *, n_heads: int, kernel_size: int,
                  window_size: int | None = 4, cond_layer_idx: int = 2, flash: bool = True):
    """x: (B, T, H); x_mask: (B, T, 1); g: (B, 1, gin) or None. Relative
    windowed attention, or windowless with ``window_size=None`` (the
    ``pre_conv`` and ``mono_layer_*`` flows). ``flash`` picks the attention
    route (:func:`mha_apply`)."""
    kv_len = x_mask[..., 0].sum(dim=1).to(torch.int32)
    attn_mask = None if flash else x_mask[:, None, :, :] * x_mask[:, None, :, 0][..., None, :]
    x = x * x_mask
    for i in range(len(params["attn"])):
        if g is not None and i == cond_layer_idx:
            gp = torch.nn.functional.linear(g, params["spk_emb"]["w"], params["spk_emb"]["b"])
            x = (x + gp) * x_mask
        y = mha_apply(params["attn"][i], x, x, attn_mask, n_heads=n_heads,
                      window_size=window_size, kv_len=kv_len, flash=flash)
        x = layer_norm(x + y, params["norm1"][i]["gamma"], params["norm1"][i]["beta"])
        y = ffn_apply(params["ffn"][i], x, x_mask, kernel_size=kernel_size)
        x = layer_norm(x + y, params["norm2"][i]["gamma"], params["norm2"][i]["beta"])
    return x * x_mask


def fft_apply(params, x, x_mask, g=None, *, n_heads: int, kernel_size: int):
    """The FFT flow block: causal windowless self-attention and causal
    FFNs, post-norm; with g (B, 1, gin), ``cond_layer`` gives each layer's
    2H conditioning and ``cond_pre`` gates the layer's input through
    tanh/sigmoid. x: (B, T, H); x_mask: (B, T, 1). No key-padding mask:
    only the causal one (as in the JAX version)."""
    hidden = x.shape[-1]
    if g is not None:
        g = conv1d(g, params["cond_layer"]["w"], params["cond_layer"]["b"])
    causal = subsequent_mask(x.shape[1], x.device)[None]  # (1, 1, T, T)
    x = x * x_mask
    for i in range(len(params["attn"])):
        if g is not None:
            xp = conv1d(x, params["cond_pre"]["w"], params["cond_pre"]["b"])
            x = fused_gate(xp, g[..., 2 * hidden * i: 2 * hidden * (i + 1)])
        y = mha_apply(params["attn"][i], x, x, causal, n_heads=n_heads)
        x = layer_norm(x + y, params["norm0"][i]["gamma"], params["norm0"][i]["beta"])
        y = ffn_apply(params["ffn"][i], x, x_mask, kernel_size=kernel_size, causal=True)
        x = layer_norm(x + y, params["norm1"][i]["gamma"], params["norm1"][i]["beta"])
    return x * x_mask
