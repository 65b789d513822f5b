"""HuBERT / ContentVec encoder (vosk_tts_tpu/models/hubert.py), the voice
conversion's content extractor, channels-last.

A 16 kHz waveform -> ``last_hidden_state``: the 7-layer strided conv
feature extractor (group norm on the first layer only, exact GELU), the
feature projection, the grouped conv positional embedding and the post-LN
transformer stack of the HF ``HubertModel`` base configuration, the only
layout ContentVec uses (``feat_extract_norm="group"``, no stable layer
norm). Attention is a plain matmul and softmax, as in the JAX package (no
kernel there). Weights are in the port's layouts (utils/params.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F

from ..ops.conv import conv1d
from ..ops.norm import layer_norm
from .tree import TreeModule


@dataclass(frozen=True)
class HubertConfig:
    conv_dim: Sequence[int] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_hf(cls, d: dict) -> "HubertConfig":
        """An HF ``HubertConfig`` dict (a ``config.json``) -> the config.
        Refuses the layouts :func:`hubert_apply` does not compute (layer
        norm in every feature conv, pre-LN "stable" layer norm); the JAX
        package reads them and computes the base layout regardless."""
        if d.get("feat_extract_norm", "group") != "group" or d.get("do_stable_layer_norm", False):
            raise ValueError("only the base HuBERT layout is ported (feat_extract_norm 'group', "
                             "do_stable_layer_norm false)")
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
            layer_norm_eps=d.get("layer_norm_eps", 1e-5),
        )

    def n_frames(self, n_samples: int) -> int:
        """Output frames for ``n_samples`` input samples (the strided convs,
        no padding): 499 for 10 s at 16 kHz with the base extractor."""
        for k, s in zip(self.conv_kernel, self.conv_stride):
            n_samples = (n_samples - k) // s + 1
        return n_samples


def _gelu(x):
    return F.gelu(x, approximate="none")


def encoder_input(params, cfg, wav: torch.Tensor, *, group_norm: bool = True) -> torch.Tensor:
    """wav: (B, T_samples) at 16 kHz -> the transformer stack's input (B,
    T_frames, hidden): the strided conv feature extractor (with
    ``group_norm``, the first layer's group norm), the feature projection,
    the grouped conv positional embedding and the encoder's layer norm.
    HuBERT and WavLM (models/wavlm.py) share it; ``cfg`` needs the conv
    strides, the positional conv's size and groups and ``layer_norm_eps``."""
    x = wav[..., None]
    for i, stride in enumerate(cfg.conv_stride):
        c = params["conv_layers"][i]
        x = conv1d(x, c["w"], c.get("b"), stride=stride, padding=0)
        if i == 0 and group_norm:
            # GroupNorm(dim groups, dim channels): each channel normalised over
            # time, biased variance
            mean = x.mean(dim=1, keepdim=True)
            var = (x - mean).square().mean(dim=1, keepdim=True)
            x = (x - mean) * torch.rsqrt(var + 1e-5) * c["gn_gamma"] + c["gn_beta"]
        x = _gelu(x)

    eps = cfg.layer_norm_eps
    x = layer_norm(x, params["fp_ln"]["gamma"], params["fp_ln"]["beta"], eps)
    x = F.linear(x, params["fp"]["w"], params["fp"]["b"])

    k = cfg.num_conv_pos_embeddings
    pos = conv1d(x, params["pos_conv"]["w"], params["pos_conv"]["b"], padding=k // 2,
                 groups=cfg.num_conv_pos_embedding_groups)
    if k % 2 == 0:
        pos = pos[:, :-1]
    return layer_norm(x + _gelu(pos), params["enc_ln"]["gamma"], params["enc_ln"]["beta"], eps)


def hubert_apply(params, cfg: HubertConfig, wav: torch.Tensor) -> torch.Tensor:
    """wav: (B, T_samples) at 16 kHz -> last hidden state (B, T_frames, hidden)."""
    x = encoder_input(params, cfg, wav)
    eps = cfg.layer_norm_eps
    b, t, h = x.shape
    heads = cfg.num_attention_heads
    dk = h // heads
    split = lambda a: a.reshape(b, t, heads, dk).transpose(1, 2)
    lin = lambda a, p: F.linear(a, p["w"], p["b"])
    for layer in params["layers"]:
        q, kk, v = (split(lin(x, layer[n])) for n in ("q", "k", "v"))
        attn = torch.softmax(q @ kk.transpose(-1, -2) / math.sqrt(dk), dim=-1)
        ctx = (attn @ v).transpose(1, 2).reshape(b, t, h)
        x = layer_norm(x + lin(ctx, layer["attn_out"]), layer["attn_ln"]["gamma"],
                       layer["attn_ln"]["beta"], eps)
        f = _gelu(lin(x, layer["ffn_in"]))
        x = layer_norm(x + lin(f, layer["ffn_out"]), layer["ffn_ln"]["gamma"],
                       layer["ffn_ln"]["beta"], eps)
    return x


class Hubert(TreeModule):
    """The weights of one HuBERT/ContentVec encoder as a module (models/tree.py)."""

    def __init__(self, cfg: HubertConfig, tree):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, wav):
        return hubert_apply(self.params, self.cfg, wav)


def hubert_from_state_dict(sd: dict, cfg: HubertConfig) -> dict:
    """HF ``HubertModel`` state dict (numpy arrays) -> the bundle-layout tree
    (vosk_tts_tpu/models/hubert.py:156), for ``utils/params.to_port_layout``.
    The positional conv's weight comes folded, or as
    ``parametrizations.weight.original0``/``original1`` or
    ``weight_g``/``weight_v``; both pairs fold over the axes where g has
    size 1 (HF's weight norm is over dim 2: the output and input channels;
    the JAX package folds ``weight_g``/``weight_v`` over dim 0 instead)."""
    from ..utils.torch_params import _np, fold_weight_norm, linear

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
    ln = lambda p: {"gamma": _np(sd[p + ".weight"]), "beta": _np(sd[p + ".bias"])}
    return {
        "conv_layers": conv_layers,
        "fp_ln": ln("feature_projection.layer_norm"),
        "fp": linear(sd, "feature_projection.projection"),
        "pos_conv": {"w": _np(sd["encoder.pos_conv_embed.conv.weight"]).transpose(2, 1, 0),
                     "b": _np(sd["encoder.pos_conv_embed.conv.bias"])},
        "enc_ln": ln("encoder.layer_norm"),
        "layers": [{
            "q": linear(sd, f"encoder.layers.{i}.attention.q_proj"),
            "k": linear(sd, f"encoder.layers.{i}.attention.k_proj"),
            "v": linear(sd, f"encoder.layers.{i}.attention.v_proj"),
            "attn_out": linear(sd, f"encoder.layers.{i}.attention.out_proj"),
            "attn_ln": ln(f"encoder.layers.{i}.layer_norm"),
            "ffn_in": linear(sd, f"encoder.layers.{i}.feed_forward.intermediate_dense"),
            "ffn_out": linear(sd, f"encoder.layers.{i}.feed_forward.output_dense"),
            "ffn_ln": ln(f"encoder.layers.{i}.final_layer_norm"),
        } for i in range(cfg.num_hidden_layers)],
    }


def load_bundle(path, device) -> Hubert:
    """A HuBERT bundle directory (``tools/convert_hubert``'s: the HF
    ``config.json``, ``params.npz`` in the bundle layout) as a module on
    ``device``."""
    import json
    import os

    from ..utils.checkpoint import load_params
    from ..utils.params import to_port_layout

    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        cfg = HubertConfig.from_hf(json.load(f))
    return Hubert(cfg, to_port_layout(load_params(os.path.join(path, "params.npz")))).to(device)
