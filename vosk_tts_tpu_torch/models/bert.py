"""BERT encoder (ruBERT word embeddings for the multistream frontend),
vosk_tts_tpu/models/bert.py.

Post-LN BERT: embeddings + N transformer layers (exact-erf GELU, additive
mask -1e9), returning every hidden state. Plain ``torch.matmul`` and
softmax: the JAX package has no Pallas kernel here. Linear weights are in
the port's (O, I) layout (utils/params.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .tree import TreeModule


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 119547
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @classmethod
    def from_hf(cls, d: dict):
        return cls(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=d["num_attention_heads"],
            intermediate_size=d["intermediate_size"],
            max_position_embeddings=d.get("max_position_embeddings", 512),
            type_vocab_size=d.get("type_vocab_size", 2),
            layer_norm_eps=d.get("layer_norm_eps", 1e-12),
        )


def _ln(x, p, eps):
    return F.layer_norm(x, x.shape[-1:], p["gamma"], p["beta"], eps)


def _linear(x, p):
    return F.linear(x, p["w"], p["b"])


def bert_apply(params, cfg: BertConfig, input_ids, attention_mask=None, token_type_ids=None):
    """input_ids: (B, T) int -> list of hidden states [emb, layer1, ..., layerN],
    each (B, T, hidden)."""
    b, t = input_ids.shape
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    if attention_mask is None:
        attention_mask = torch.ones_like(input_ids)
    pos = torch.arange(t, device=input_ids.device)
    x = (params["word_emb"][input_ids.long()] + params["pos_emb"][pos][None]
         + params["type_emb"][token_type_ids.long()])
    x = _ln(x, params["emb_ln"], cfg.layer_norm_eps)

    bias = torch.where(attention_mask[:, None, None, :] == 0, -1e9, 0.0).to(x.dtype)
    heads = cfg.num_attention_heads
    dk = cfg.hidden_size // heads
    split = lambda a: a.reshape(b, t, heads, dk).transpose(1, 2)
    hidden_states = [x]
    for layer in params["layers"]:
        q, k, v = split(_linear(x, layer["q"])), split(_linear(x, layer["k"])), split(_linear(x, layer["v"]))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dk) + bias
        ctx = torch.matmul(torch.softmax(scores, dim=-1), v)
        ctx = ctx.transpose(1, 2).reshape(b, t, cfg.hidden_size)
        x = _ln(x + _linear(ctx, layer["attn_out"]), layer["attn_ln"], cfg.layer_norm_eps)
        f = F.gelu(_linear(x, layer["ffn_in"]))
        x = _ln(x + _linear(f, layer["ffn_out"]), layer["ffn_ln"], cfg.layer_norm_eps)
        hidden_states.append(x)
    return hidden_states


class BertEncoder(TreeModule):
    """Bundled BERT on one device: one sequence is padded to a length
    bucket, as the JAX package does, and sliced back."""

    LENGTH_BUCKETS = (32, 64, 128, 256, 512)

    def __init__(self, params, config: dict):
        super().__init__(params)
        self.cfg = BertConfig.from_hf(config)

    @torch.inference_mode()
    def forward(self, input_ids, attention_mask, token_type_ids):
        """Lists of ints -> (L+1, T, hidden) tensor on the module's device."""
        t = len(input_ids)
        bucket = next((bkt for bkt in self.LENGTH_BUCKETS if bkt >= t), self.LENGTH_BUCKETS[-1])
        rows = np.zeros((3, 1, bucket), np.int64)
        for i, a in enumerate((input_ids, attention_mask, token_type_ids)):
            rows[i, 0, :t] = a[:bucket]
        ids, mask, types = torch.as_tensor(rows, device=self.device)
        hs = bert_apply(self.params, self.cfg, ids, mask, types)
        return torch.stack(hs)[:, 0, :t]
