"""WavLM encoder (vosk_tts_tpu/models/wavlm.py), the frozen SLM backbone of
the WavLM/SLM losses of VITS2 training, channels-last.

HuBERT's conv feature extractor, feature projection and grouped conv
positional embedding (models/hubert.encoder_input), then a post-LN
transformer stack with WavLM's gated relative position bias: a bucketed
T5-style bias table (the first layer's, shared by every layer), gated per
layer and head by a projection of the layer's input states. Attention is
a plain matmul and softmax, as in the JAX package (no kernel there).
Weights are in the port's layouts (utils/params.py, ``WAVLM_LINEARS``);
:func:`wavlm_from_state_dict` reads an HF ``WavLMModel`` state dict into
the bundle layout, and ``utils/params.wavlm_init`` draws a tree of the
same structure.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv import constant
from ..ops.norm import layer_norm
from .hubert import encoder_input
from .tree import TreeModule


@dataclass(frozen=True)
class WavLMConfig:
    conv_dim: Sequence[int] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_bucket_distance: int = 800
    layer_norm_eps: float = 1e-5
    feat_extract_norm: str = "group"

    @classmethod
    def from_hf(cls, d: dict):
        """From a Hugging Face ``WavLMConfig`` dict (its ``config.json``)."""
        return cls(
            conv_dim=tuple(d["conv_dim"]),
            conv_kernel=tuple(d["conv_kernel"]),
            conv_stride=tuple(d["conv_stride"]),
            hidden_size=d["hidden_size"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=d["num_attention_heads"],
            intermediate_size=d["intermediate_size"],
            num_conv_pos_embeddings=d.get("num_conv_pos_embeddings", 128),
            num_conv_pos_embedding_groups=d.get("num_conv_pos_embedding_groups", 16),
            num_buckets=d.get("num_buckets", 320),
            max_bucket_distance=d.get("max_bucket_distance", 800),
            layer_norm_eps=d.get("layer_norm_eps", 1e-5),
            feat_extract_norm=d.get("feat_extract_norm", "group"),
        )

    def to_hf(self) -> dict:
        """The Hugging Face ``config.json`` keys that :meth:`from_hf` reads."""
        return {"model_type": "wavlm", "conv_dim": list(self.conv_dim),
                "conv_kernel": list(self.conv_kernel), "conv_stride": list(self.conv_stride),
                "hidden_size": self.hidden_size, "num_hidden_layers": self.num_hidden_layers,
                "num_attention_heads": self.num_attention_heads,
                "intermediate_size": self.intermediate_size,
                "num_conv_pos_embeddings": self.num_conv_pos_embeddings,
                "num_conv_pos_embedding_groups": self.num_conv_pos_embedding_groups,
                "num_buckets": self.num_buckets, "max_bucket_distance": self.max_bucket_distance,
                "layer_norm_eps": self.layer_norm_eps, "feat_extract_norm": self.feat_extract_norm,
                "conv_bias": False, "do_stable_layer_norm": False}


def _relative_buckets(rel_pos: np.ndarray, num_buckets: int, max_distance: int) -> np.ndarray:
    """modeling_wavlm.py:253-271 (T5 bucket scheme, bidirectional), in numpy
    float64 as the JAX package computes it: a float32 log moves some
    buckets at their edges."""
    nb = num_buckets // 2
    buckets = (rel_pos > 0).astype(np.int64) * nb
    rel = np.abs(rel_pos)
    max_exact = nb // 2
    is_small = rel < max_exact
    large = np.log(np.maximum(rel, 1).astype(np.float64) / max_exact)
    large = large / math.log(max_distance / max_exact) * (nb - max_exact)
    large = np.minimum((max_exact + large).astype(np.int64), nb - 1)
    return buckets + np.where(is_small, rel, large)


@lru_cache(maxsize=16)
def _buckets(t: int, num_buckets: int, max_distance: int, device) -> torch.Tensor:
    """The (T, T) bucket of each (query, key) pair on ``device``."""
    rel = np.arange(t)[None, :] - np.arange(t)[:, None]  # key - query
    return constant(_relative_buckets(rel, num_buckets, max_distance), device=device)


def wavlm_apply(params, cfg: WavLMConfig, wav: torch.Tensor) -> list:
    """wav: (B, T) at 16 kHz -> the ``num_hidden_layers + 1`` hidden states
    (B, T_frames, hidden), HF ``output_hidden_states`` order: the encoder's
    input, then each layer's output. Differentiable in ``wav``."""
    x = encoder_input(params, cfg, wav, group_norm=cfg.feat_extract_norm == "group")
    b, t, h = x.shape
    heads = cfg.num_attention_heads
    dk = h // heads
    eps = cfg.layer_norm_eps
    pos_bias = params["rel_attn_embed"][_buckets(t, cfg.num_buckets, cfg.max_bucket_distance,
                                                 x.device)].permute(2, 0, 1)  # (H, T, T)
    split = lambda a: a.reshape(b, t, heads, dk).transpose(1, 2)  # (B, H, T, dk)
    lin = lambda a, p: F.linear(a, p["w"], p["b"])

    hidden_states = [x]
    for layer in params["layers"]:
        q, kk, v = (split(lin(x, layer[n])) for n in ("q", "k", "v"))
        # the gate reads the layer's un-projected input, split per head
        # (modeling_wavlm.py:165-180)
        proj = lin(split(x), layer["gru_lin"]).reshape(b, heads, t, 2, 4).sum(-1)
        gate_a, gate_b = torch.sigmoid(proj).split(1, dim=-1)  # (B, H, T, 1) each
        gate = gate_a * (gate_b * layer["gru_const"].reshape(1, heads, 1, 1) - 1.0) + 2.0
        scores = q @ kk.transpose(-1, -2) / math.sqrt(dk) + gate * pos_bias[None]
        ctx = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(b, t, h)
        x = layer_norm(x + lin(ctx, layer["out"]), layer["attn_ln"]["gamma"],
                       layer["attn_ln"]["beta"], eps)
        f = F.gelu(lin(x, layer["ffn_in"]), approximate="none")
        x = layer_norm(x + lin(f, layer["ffn_out"]), layer["ffn_ln"]["gamma"],
                       layer["ffn_ln"]["beta"], eps)
        hidden_states.append(x)
    return hidden_states


def stacked_hidden_states(hidden_states) -> torch.Tensor:
    """L states (B, T, H) -> (B, T, L*H), feature l*H + h: the layout the
    WavLM discriminator reads (the reference's stack, transpose, flatten)."""
    return torch.cat(list(hidden_states), dim=-1)


# the few converters of vosk_tts_tpu/utils/torch_params.py this reader needs


def fold_weight_norm(sd: dict) -> dict:
    """Replace ``*.weight_g``/``*.weight_v`` pairs by the effective weight
    g * v / ||v||, the norm over the axes where g has size 1: every axis but
    the output channels for torch's ``weight_norm(dim=0)``, the output and
    input channels for the positional conv's ``dim=2``."""
    out = dict(sd)
    for k in list(sd):
        if k.endswith(".weight_v"):
            base = k[: -len(".weight_v")]
            v = np.asarray(sd[k], dtype=np.float32)
            g = np.asarray(sd[base + ".weight_g"], dtype=np.float32)  # keepdims, as torch keeps it
            axes = tuple(i for i in range(v.ndim) if g.shape[i] == 1)
            out[base + ".weight"] = g * v / np.sqrt((v**2).sum(axis=axes, keepdims=True))
            del out[k], out[base + ".weight_g"]
    return out


def _np(x):
    return np.asarray(x, dtype=np.float32)


def linear(sd, p):
    return {"w": _np(sd[p + ".weight"]).T, "b": _np(sd[p + ".bias"])}


def wavlm_from_state_dict(sd: dict, cfg: WavLMConfig) -> dict:
    """HF ``WavLMModel`` state dict (numpy arrays) -> the bundle-layout tree
    (the JAX package's), for ``utils/params.to_port_layout``. The positional
    conv's weight comes folded, or as ``weight_g``/``weight_v`` or
    ``parametrizations.weight.original0``/``original1`` (weight norm over
    the output and input channels, HF's dim 2; the JAX package folds
    ``weight_g``/``weight_v`` over the input channels and taps instead)."""
    sd = fold_weight_norm(sd)
    conv_layers = []
    for i in range(len(cfg.conv_kernel)):
        base = f"feature_extractor.conv_layers.{i}"
        c = {"w": _np(sd[f"{base}.conv.weight"]).transpose(2, 1, 0)}
        if f"{base}.conv.bias" in sd:
            c["b"] = _np(sd[f"{base}.conv.bias"])
        if i == 0 and f"{base}.layer_norm.weight" in sd:
            c["gn_gamma"] = _np(sd[f"{base}.layer_norm.weight"])
            c["gn_beta"] = _np(sd[f"{base}.layer_norm.bias"])
        conv_layers.append(c)
    pw_key = "encoder.pos_conv_embed.conv.weight"
    if pw_key not in sd and "encoder.pos_conv_embed.conv.parametrizations.weight.original0" in sd:
        g = _np(sd["encoder.pos_conv_embed.conv.parametrizations.weight.original0"])
        v = _np(sd["encoder.pos_conv_embed.conv.parametrizations.weight.original1"])
        sd[pw_key] = g * v / np.sqrt((v**2).sum(axis=(0, 1), keepdims=True))
    p = {
        "conv_layers": conv_layers,
        "fp_ln": {"gamma": _np(sd["feature_projection.layer_norm.weight"]),
                  "beta": _np(sd["feature_projection.layer_norm.bias"])},
        "fp": linear(sd, "feature_projection.projection"),
        "pos_conv": {"w": _np(sd[pw_key]).transpose(2, 1, 0),
                     "b": _np(sd["encoder.pos_conv_embed.conv.bias"])},
        "enc_ln": {"gamma": _np(sd["encoder.layer_norm.weight"]),
                   "beta": _np(sd["encoder.layer_norm.bias"])},
        "rel_attn_embed": _np(sd["encoder.layers.0.attention.rel_attn_embed.weight"]),
        "layers": [],
    }
    for i in range(cfg.num_hidden_layers):
        b = f"encoder.layers.{i}"
        p["layers"].append({
            "q": linear(sd, f"{b}.attention.q_proj"),
            "k": linear(sd, f"{b}.attention.k_proj"),
            "v": linear(sd, f"{b}.attention.v_proj"),
            "out": linear(sd, f"{b}.attention.out_proj"),
            "gru_lin": linear(sd, f"{b}.attention.gru_rel_pos_linear"),
            "gru_const": _np(sd[f"{b}.attention.gru_rel_pos_const"]),
            "attn_ln": {"gamma": _np(sd[f"{b}.layer_norm.weight"]),
                        "beta": _np(sd[f"{b}.layer_norm.bias"])},
            "ffn_in": linear(sd, f"{b}.feed_forward.intermediate_dense"),
            "ffn_out": linear(sd, f"{b}.feed_forward.output_dense"),
            "ffn_ln": {"gamma": _np(sd[f"{b}.final_layer_norm.weight"]),
                       "beta": _np(sd[f"{b}.final_layer_norm.bias"])},
        })
    return p


class WavLM(TreeModule):
    """The frozen weights of one WavLM encoder as a module (models/tree.py:
    every leaf a buffer, so nothing trains it; the hidden states keep their
    graph to the input waveform)."""

    def __init__(self, cfg: WavLMConfig, tree):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, wav):
        return wavlm_apply(self.params, self.cfg, wav)
