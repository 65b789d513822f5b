"""Weight carrier: the JAX package's parameter tree -> the port's layouts.

A bundle's ``params.npz`` holds the JAX package's tree (channels-last
weights, vosk_tts_tpu/ops/conv.py). :func:`to_port_layout` turns that tree,
as numpy arrays, into the port's layouts once, at load:

  ===============  ===========  =====================================
  weight           JAX layout   port layout
  ===============  ===========  =====================================
  Conv1d           (K, I, O)    (O, I, K)   -- ``F.conv1d``
  1x1 conv         (1, I, O)    (O, I)      -- ``F.linear``
  Linear           (I, O)       (O, I)      -- ``F.linear``
  ConvTranspose1d  (K, I, O)    (I, O, K)   -- ``F.conv_transpose1d``
  Conv2d           (kh,kw,I,O)  (O,I,kh,kw) -- ``F.conv2d``
  DDSConv stack    per layer    stacked, see :func:`_pack_ddsconv`
  ===============  ===========  =====================================

A leaf's layout follows from its name and rank: ``"w"`` of rank 2 is a
Linear (``ada_in``, ``ada_out``, ``bert_proj``, ``time_mlp``, every BERT
and HuBERT linear, Vocos' ``pw1``/``pw2``/``head``); ``"w"`` of shape
(1, I, O) a 1x1 conv (DiT ``q``/``k``/``v``/``o``, ``film``, ``in_proj``,
``final_proj``, encoder ``proj``, the FFT flow's ``cond_layer`` and
``cond_pre``, QuickVC's ``enc_p.pre`` over 768 ContentVec features);
other ``"w"`` a Conv1d (``cond_proj``, ``lsc``, the FFN convs, Vocos'
depthwise ``dwconv`` (7, 1, C) -> (C, 1, 7), BigVGAN's AMP convs,
HuBERT's strided feature convs, its grouped ``pos_conv`` (K, I/groups, O)
-> (O, I/groups, K), ms-iSTFT's ``multistream_conv_post`` (63, sub, 1) ->
(1, sub, 63)), or a ConvTranspose1d under ``ups``; a ``"w"`` of rank 4 a
Conv2d (the discriminators' period and spectral stacks). An LSTM's ``w_ih`` (I, 4H) and ``w_hh``
(H, 4H) become torch's (4H, I) and (4H, H), gates in the same i, f, g, o
order. Every other leaf (embedding tables such as ``emb``, ``punc_emb``,
``spk_emb``, ``word_emb``, ``pos_emb``; ``fake_speaker``,
``fake_content``; norm ``gamma``/``beta``, ``gn_gamma``/``gn_beta``;
Vocos' layer scale ``gamma``; BigVGAN's snake ``alpha``/``beta``;
biases; the speaker-encoder artifact's scalar ``w`` and ``b``, the GE2E
similarity scale and offset) keeps its layout. The StableTTS DiT attention's fused qkv
projection is a layout of that model alone: ``models.stabletts.port_layout``
makes it from this one.

The posterior encoder (``enc_q``) is kept: ``vits2.voice_conversion``
reads it.

:func:`from_port_layout` inverts the conversion for every tree this module
initialises, so the port writes them, and compares their gradients, in the
bundle layout that either package loads. A rank-2 port ``"w"`` is a
Linear or a 1x1 conv by the name of its parent alone, and the same name
is one in one tree and the other in another (VITS2's and MRTE's attention
``q``/``k``/``v``/``o`` are 1x1 convs, BERT's and HuBERT's Linears), so
the caller names the tree's Linears: :data:`LINEARS` (VITS2,
the discriminators, QuickVC, Matcha, the vocoders), :data:`AR_LINEARS`,
:data:`SOVITS_LINEARS`, :data:`BERT_LINEARS`, :data:`HUBERT_LINEARS`,
:data:`WAVLM_LINEARS` or :data:`WHISPER_LINEARS`. The WavLM
discriminator's ``pre`` (1, 13 x 768, 64) is a 1x1 conv (under :data:`LINEARS`); WavLM's ``gru_const`` (1, H, 1, 1)
and ``rel_attn_embed`` (buckets, H) are not ``"w"`` and keep their layout.

:func:`synthesizer_init` (every flow type, duration predictor and
decoder), :func:`matcha_init`, :func:`hifigan_init`, :func:`vocos_init`,
:func:`bigvgan_init`, :func:`bert_init`, :func:`hubert_init`, :func:`quickvc_init`,
:func:`ar_init`, :func:`sovits_init`, :func:`wavlm_init`,
:func:`wavlm_disc_init` and :func:`whisper_init` draw trees in the BUNDLE layout
(the JAX one) from the same distributions and shapes as the JAX package's
inits, so a full-width bundle can be made where JAX is absent; their
numbers differ from JAX's draws. The GPT-SoVITS trees convert by the same
rules: the AR's ``qkv``, ``out``, ``ff1``, ``ff2``, ``bert_proj`` and
``predict`` are Linears, ``text_emb``/``audio_emb``/``codebook`` tables
and ``text_alpha``/``audio_alpha`` scalars keep their layout; SoVITS's
strided ``ssl_proj`` (2, 768, 768) is a Conv1d, its MRTE and ``enc_p``
projections 1x1 convs, the style encoder's ``spec1``..``fc`` Linears and
its GLU convs Conv1d.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.vits2 import check_decoder, check_ported, flow_type
from ..models.whisper import _sinusoids


def _pack_ddsconv(p):
    """Per-layer DDSConv tree -> one stacked tree that both the plain
    version and the CUDA kernel read (ops/ddsconv_fused.py):
    sep_w (L, C, K), pw_w (L, C_out, C_in), biases and norms (L, C)."""
    st = lambda xs: np.ascontiguousarray(np.stack(xs)).astype(np.float32)
    return {
        "sep_w": st([s["w"][:, 0, :].T for s in p["sep"]]),
        "sep_b": st([s["b"] for s in p["sep"]]),
        "pw_w": st([w["w"][0].T for w in p["pw"]]),
        "pw_b": st([w["b"] for w in p["pw"]]),
        "norm1_g": st([n["gamma"] for n in p["norm1"]]),
        "norm1_b": st([n["beta"] for n in p["norm1"]]),
        "norm2_g": st([n["gamma"] for n in p["norm2"]]),
        "norm2_b": st([n["beta"] for n in p["norm2"]]),
    }


def _convert(node, path):
    if node is None:
        return None
    if isinstance(node, dict):
        if {"sep", "pw", "norm1", "norm2"} <= set(node):
            return _pack_ddsconv(node)
        return {k: _convert(v, path + (k,)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, path + (str(i),)) for i, v in enumerate(node)]
    a = np.asarray(node)
    if path[-1] in ("w_ih", "w_hh"):  # LSTM (I, 4H) -> (4H, I)
        return np.ascontiguousarray(a.T)
    if path[-1] != "w" or a.ndim == 0:  # a scalar "w": the GE2E similarity scale
        return a
    if "ups" in path:  # ConvTranspose1d (K, I, O) -> (I, O, K)
        return np.ascontiguousarray(a.transpose(1, 2, 0))
    if a.ndim == 4:  # Conv2d (kh, kw, I, O) -> (O, I, kh, kw)
        return np.ascontiguousarray(a.transpose(3, 2, 0, 1))
    if a.ndim == 2:  # Linear (I, O) -> (O, I)
        return np.ascontiguousarray(a.T)
    if a.shape[0] == 1:  # 1x1 conv (1, I, O) -> (O, I)
        return np.ascontiguousarray(a[0].T)
    return np.ascontiguousarray(a.transpose(2, 1, 0))  # (K, I, O) -> (O, I, K)


def to_port_layout(tree):
    """JAX bundle tree (numpy leaves) -> port-layout tree (numpy leaves)."""
    return _convert(tree, ())


def _unpack_ddsconv(p, n_layers: int):
    """Inverse of :func:`_pack_ddsconv`."""
    return {
        "sep": [{"w": np.ascontiguousarray(p["sep_w"][i].T[:, None, :]), "b": p["sep_b"][i]}
                for i in range(n_layers)],
        "pw": [{"w": np.ascontiguousarray(p["pw_w"][i].T[None]), "b": p["pw_b"][i]}
               for i in range(n_layers)],
        "norm1": [{"gamma": p["norm1_g"][i], "beta": p["norm1_b"][i]} for i in range(n_layers)],
        "norm2": [{"gamma": p["norm2_g"][i], "beta": p["norm2_b"][i]} for i in range(n_layers)],
    }


# The parents whose rank-2 port "w" is a Linear, by kind of tree; every other
# rank-2 "w" is a 1x1 conv. VITS2 and its discriminators, QuickVC's speaker
# encoder, Matcha, Vocos:
LINEARS = frozenset({"spk_emb", "output", "pw1", "pw2", "head", "ada_in", "ada_out", "l1", "l2",
                     "bert_proj", "linear"})
# the GPT-SoVITS AR (every projection; the alphas and tables are not "w")
AR_LINEARS = frozenset({"qkv", "out", "ff1", "ff2", "bert_proj", "predict"})
# SoVITS: the VITS2 parts, and the mel style encoder's Linears
SOVITS_LINEARS = LINEARS | {"spec1", "spec2", "wq", "wk", "wv", "fc_attn", "fc"}
BERT_LINEARS = frozenset({"q", "k", "v", "attn_out", "ffn_in", "ffn_out"})
HUBERT_LINEARS = BERT_LINEARS | {"fp"}
WAVLM_LINEARS = frozenset({"q", "k", "v", "out", "gru_lin", "ffn_in", "ffn_out", "fp"})
WHISPER_LINEARS = frozenset({"q", "k", "v", "out", "fc1", "fc2"})


def _restore(node, path, linears):
    if node is None:
        return None
    if isinstance(node, dict):
        if "sep_w" in node:
            return _unpack_ddsconv(node, len(node["sep_w"]))
        return {k: _restore(v, path + (k,), linears) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_restore(v, path + (str(i),), linears) for i, v in enumerate(node)]
    a = np.asarray(node)
    if path[-1] in ("w_ih", "w_hh"):  # LSTM (4H, I) -> (I, 4H)
        return np.ascontiguousarray(a.T)
    if path[-1] != "w" or a.ndim == 0:
        return a
    if "ups" in path:  # (I, O, K) -> (K, I, O)
        return np.ascontiguousarray(a.transpose(2, 0, 1))
    if a.ndim == 4:  # (O, I, kh, kw) -> (kh, kw, I, O)
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0))
    if a.ndim == 2:  # Linear (O, I) -> (I, O); 1x1 conv (O, I) -> (1, I, O)
        return np.ascontiguousarray(a.T if path[-2] in linears else a.T[None])
    return np.ascontiguousarray(a.transpose(2, 1, 0))  # (O, I, K) -> (K, I, O)


def from_port_layout(tree, linears):
    """Port-layout tree (numpy leaves) -> the JAX bundle layout, the inverse
    of :func:`to_port_layout` (DDSConv stacks unpacked per layer).
    ``linears`` names the parents of the tree's Linears, which the port
    layout alone does not tell: :data:`LINEARS` for a VITS2 synthesizer,
    ``mpmsd_init``, ``mpd_init``, ``duration_disc_init``, QuickVC, Matcha
    (before the fused qkv: ``models.stabletts.bundle_layout`` inverts
    ``port_layout``), HiFiGAN, Vocos or BigVGAN tree; :data:`AR_LINEARS`, :data:`SOVITS_LINEARS`,
    :data:`BERT_LINEARS`, :data:`HUBERT_LINEARS`, :data:`WAVLM_LINEARS`,
    :data:`WHISPER_LINEARS` for the GPT-SoVITS AR and SoVITS, BERT, HuBERT,
    WavLM and Whisper trees (the WavLM discriminator's and the speaker
    encoder's under :data:`LINEARS`)."""
    return _restore(tree, (), linears)


def to_torch(tree, device, dtype=torch.float32):
    """Port-layout numpy tree -> the same tree of tensors on ``device``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v, device, dtype) for v in tree]
    t = torch.tensor(np.asarray(tree))
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def perturb_zero_init(tree, seed: int):
    """Give the zero-initialised projections random values, in place on a
    BUNDLE-layout VITS2 or QuickVC tree: the flow ``post`` convs (std 0.02;
    the coupling layers of every flow type and the mono layers) and, where
    the tree has an SDP, its ConvFlow ``proj`` convs (std 0.2, which
    spreads the noise-free durations over about 1-6 frames per token, away
    from the integer edges of the ceil). As initialised they make the flow
    an identity and the durations independent of every DDSConv output, so
    a comparison of two implementations would not see attention, the
    couplings or DDSConv in those paths."""
    rng = np.random.default_rng(seed)

    def fill(p, scale):
        for k in ("w", "b"):
            p[k] = (rng.standard_normal(np.shape(p[k])) * scale).astype(np.float32)

    for layer in tree["flow"]["flows"]:
        fill(layer["coupling"]["post"] if "coupling" in layer else layer["post"], 0.02)
        if "mono" in layer:
            fill(layer["mono"]["post"], 0.02)
    for key in ("flows", "post_flows") if "flows" in tree.get("dp", {}) else ():
        for cf in tree["dp"][key][1:]:
            fill(cf["proj"], 0.2)
    return tree


# ---------------------------------------------------------------------------
# Random init in the bundle layout (vosk_tts_tpu/models/vits2.py:684-695)
# ---------------------------------------------------------------------------


def _u(rng, shape, s):
    return rng.uniform(-s, s, shape).astype(np.float32)


def _conv(rng, k, c_in, c_out):
    s = (c_in * k) ** -0.5
    return {"w": _u(rng, (k, c_in, c_out), s), "b": _u(rng, (c_out,), s)}


def _xavier(rng, c_in, c_out):
    a = math.sqrt(6.0 / (c_in + c_out))
    return {"w": _u(rng, (1, c_in, c_out), a), "b": _u(rng, (c_out,), c_in**-0.5)}


def _norm(c):
    return {"gamma": np.ones((c,), np.float32), "beta": np.zeros((c,), np.float32)}


def _mha(rng, ch, out, heads, window=4, proximal_init=False):
    d = ch // heads
    p = {k: _xavier(rng, ch, ch) for k in ("q", "k", "v")}
    p["o"] = _xavier(rng, ch, out)
    if proximal_init:
        p["k"] = dict(p["q"])
    if window is not None:
        for k in ("emb_rel_k", "emb_rel_v"):
            p[k] = (rng.standard_normal((1, 2 * window + 1, d)) * d**-0.5).astype(np.float32)
    return p


def _encoder(rng, hidden, filt, heads, layers, k, gin=0, window=4):
    p = {
        "attn": [_mha(rng, hidden, hidden, heads, window) for _ in range(layers)],
        "ffn": [{"c1": _conv(rng, k, hidden, filt), "c2": _conv(rng, k, filt, hidden)}
                for _ in range(layers)],
        "norm1": [_norm(hidden) for _ in range(layers)],
        "norm2": [_norm(hidden) for _ in range(layers)],
    }
    if gin:
        s = gin**-0.5
        p["spk_emb"] = {"w": _u(rng, (gin, hidden), s), "b": _u(rng, (hidden,), s)}
    return p


def _wn(rng, hidden, k, layers, gin):
    p = {
        "in": [_conv(rng, k, hidden, 2 * hidden) for _ in range(layers)],
        "res_skip": [_conv(rng, 1, hidden, 2 * hidden if i < layers - 1 else hidden)
                     for i in range(layers)],
    }
    if gin:
        p["cond"] = _conv(rng, 1, gin, 2 * hidden * layers)
    return p


def _fft(rng, hidden, filt, heads, layers, k, gin):
    """The FFT flow block (``attention.fft_init``): proximal-init
    windowless attention, causal FFNs, ``cond_layer``/``cond_pre`` where
    gin > 0."""
    p = {
        "attn": [_mha(rng, hidden, hidden, heads, None, proximal_init=True) for _ in range(layers)],
        "ffn": [{"c1": _conv(rng, k, hidden, filt), "c2": _conv(rng, k, filt, hidden)}
                for _ in range(layers)],
        "norm0": [_norm(hidden) for _ in range(layers)],
        "norm1": [_norm(hidden) for _ in range(layers)],
    }
    if gin:
        p["cond_layer"] = _xavier(rng, gin, 2 * hidden * layers)
        p["cond_pre"] = _xavier(rng, hidden, 2 * hidden)
    return p


def _ddsconv(rng, ch, k, layers):
    return {
        "sep": [_conv(rng, k, 1, ch) for _ in range(layers)],
        "pw": [_conv(rng, 1, ch, ch) for _ in range(layers)],
        "norm1": [_norm(ch) for _ in range(layers)],
        "norm2": [_norm(ch) for _ in range(layers)],
    }


def _zeros_conv(c_in, c_out):
    return {"w": np.zeros((1, c_in, c_out), np.float32), "b": np.zeros((c_out,), np.float32)}


def _convflow(rng, fc, k, bins=10):
    return {"pre": _conv(rng, 1, 1, fc), "convs": _ddsconv(rng, fc, k, 3),
            "proj": _zeros_conv(fc, 3 * bins - 1)}


def _affine():
    return {"m": np.zeros((2,), np.float32), "logs": np.zeros((2,), np.float32)}


def perturb_matcha_zero_init(tree, seed: int):
    """Give the zero-initialised leaves of a BUNDLE-layout ``matcha`` tree
    random values, in place: every DiT block's adaLN-Zero ``ada_out``
    (std 0.05) and the CFG ``fake_speaker``/``fake_content`` (std 1). As
    initialised every gate is 0, so each DiT block is the identity and no
    attention reaches the output, and CFG's unconditional half is
    degenerate: a comparison of two implementations would not see them."""
    rng = np.random.default_rng(seed)
    blocks = (tree["text_encoder"]["encoder"]["blocks"] + tree["text_encoder"]["dp_encoder"]["blocks"]
              + [b["dit"] for b in tree["decoder"]["blocks"]])
    for blk in blocks:
        for k in ("w", "b"):
            blk["ada_out"][k] = (rng.standard_normal(np.shape(blk["ada_out"][k])) * 0.05
                                 ).astype(np.float32)
    for k in ("fake_speaker", "fake_content"):
        tree[k] = rng.standard_normal(np.shape(tree[k])).astype(np.float32)
    return tree


def _generator(rng, cfg, post_channels: int, post_bias: bool = False):
    """The generator trunk + ``conv_post`` (vits2 generator_init)."""
    uic = cfg.upsample_initial_channel
    dec = {"conv_pre": _conv(rng, 7, cfg.inter_channels, uic), "ups": [], "resblocks": []}
    ch = uic
    for i, kk in enumerate(cfg.upsample_kernel_sizes):
        cin, ch = uic // 2**i, uic // 2 ** (i + 1)
        dec["ups"].append({"w": (rng.standard_normal((kk, cin, ch)) * 0.01).astype(np.float32),
                           "b": np.zeros((ch,), np.float32)})
    for i in range(len(cfg.upsample_rates)):
        c = uic // 2 ** (i + 1)
        for kk, d in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            if cfg.resblock == "1":
                dec["resblocks"].append({
                    "convs1": [_conv(rng, kk, c, c) for _ in d],
                    "convs2": [_conv(rng, kk, c, c) for _ in d]})
            else:
                dec["resblocks"].append({"convs": [_conv(rng, kk, c, c) for _ in d]})
    post = _conv(rng, 7, ch, post_channels)
    if not post_bias:
        post["b"] = None
    dec["conv_post"] = post
    if cfg.gin_channels and cfg.decoder_type == "hifigan":
        dec["cond"] = _conv(rng, 1, cfg.gin_channels, uic)
    return dec


def _posterior(rng, cfg):
    """Posterior encoder over ``spec_channels`` inputs (vits2 posterior_init)."""
    h = cfg.hidden_channels
    return {"pre": _conv(rng, 1, cfg.spec_channels, h),
            "enc": _wn(rng, h, 5, cfg.posterior_wn_layers, cfg.gin_channels),
            "proj": _conv(rng, 1, h, cfg.inter_channels * 2)}


def hifigan_init(cfg, seed: int):
    """Bundle-layout HiFiGAN v1 vocoder tree (``vocoder.hifigan_init``)."""
    check_decoder(cfg)
    return _generator(np.random.default_rng(seed), cfg, 1)


def _linear(rng, c_in, c_out):
    s = c_in**-0.5
    return {"w": _u(rng, (c_in, c_out), s), "b": _u(rng, (c_out,), s)}


def _dit_block(rng, hidden, filt, kernel, gin):
    p = {"attn": {k: _xavier(rng, hidden, hidden) for k in ("q", "k", "v", "o")},
         "mlp": {"c1": _conv(rng, kernel, hidden, filt), "c2": _conv(rng, kernel, filt, hidden)},
         "ada_out": {"w": np.zeros((hidden, 6 * hidden), np.float32),
                     "b": np.zeros((6 * hidden,), np.float32)}}
    if gin != hidden:
        p["ada_in"] = _linear(rng, gin, hidden)
    return p


def _dit_encoder(rng, out_ch, hidden, filt, layers, kernel, gin):
    return {"blocks": [_dit_block(rng, hidden, filt, kernel, gin) for _ in range(layers)],
            "proj": _conv(rng, 1, hidden, out_ch)}


def matcha_init(cfg, seed: int):
    """Bundle-layout StableTTS tree (``stabletts.matcha_init``), with the
    adaLN-Zero projections and the CFG fakes at zero as initialised."""
    rng = np.random.default_rng(seed)
    normal = lambda shape, s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)
    te = {
        "emb": normal((cfg.n_vocab, cfg.phone_emb_dim), cfg.phone_emb_dim**-0.5),
        "punc_emb": normal((cfg.n_vocab, cfg.punc_emb_dim), cfg.punc_emb_dim**-0.5),
        "bert_proj": _linear(rng, cfg.bert_dim, cfg.bert_proj_dim),
        "encoder": _dit_encoder(rng, cfg.n_feats, cfg.hidden_channels, cfg.filter_channels,
                                cfg.n_layers, cfg.kernel_size, cfg.spk_emb_dim),
        "dp_encoder": _dit_encoder(rng, cfg.dp_out_channels, cfg.hidden_channels,
                                   cfg.filter_channels, cfg.n_layers, cfg.kernel_size,
                                   cfg.spk_emb_dim),
    }
    h, f, k = cfg.dec_hidden, cfg.dec_filter, cfg.dec_kernel
    dec = {
        "time_mlp": {"l1": _linear(rng, h, f), "l2": _linear(rng, f, h)},
        "in_proj": _conv(rng, 1, h + cfg.n_feats, h),
        "cond_proj": [_conv(rng, k, cfg.hidden_channels, f), _conv(rng, k, f, f),
                      _conv(rng, k, f, h)],
        "blocks": [{"film": {"film": _conv(rng, 1, h, 2 * h)},
                    "dit": _dit_block(rng, h, f, k, cfg.spk_emb_dim)}
                   for _ in range(cfg.dec_layers)],
        "lsc": [_conv(rng, k, 2 * h, h) for _ in range(cfg.dec_layers // 2)],
        "final_proj": _conv(rng, 1, h, cfg.n_feats),
    }
    return {"spk_emb": normal((cfg.n_spks, cfg.spk_emb_dim)),
            "dur_spk_emb": normal((cfg.n_spks, cfg.spk_emb_dim)),
            "text_encoder": te, "decoder": dec,
            "fake_speaker": np.zeros((1, cfg.spk_emb_dim), np.float32),
            "fake_content": np.zeros((1, cfg.hidden_channels, 1), np.float32)}


def bert_init(cfg, seed: int):
    """Bundle-layout BERT tree (``bert.bert_init``): N(0, 0.02) weights and
    embeddings, zero biases, unit layer norms."""
    rng = np.random.default_rng(seed)
    h = cfg.hidden_size
    normal = lambda shape: (rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02))
    lin = lambda i, o: {"w": normal((i, o)), "b": np.zeros((o,), np.float32)}
    return {
        "word_emb": normal((cfg.vocab_size, h)),
        "pos_emb": normal((cfg.max_position_embeddings, h)),
        "type_emb": normal((cfg.type_vocab_size, h)),
        "emb_ln": _norm(h),
        "layers": [{"q": lin(h, h), "k": lin(h, h), "v": lin(h, h), "attn_out": lin(h, h),
                    "attn_ln": _norm(h), "ffn_in": lin(h, cfg.intermediate_size),
                    "ffn_out": lin(cfg.intermediate_size, h), "ffn_ln": _norm(h)}
                   for _ in range(cfg.num_hidden_layers)],
    }


def _flow_layer(rng, cfg):
    """One flow group of ``cfg``'s flow type (vits2 flow_block_init)."""
    h, half, gin = cfg.hidden_channels, cfg.inter_channels // 2, cfg.gin_channels
    coupling = lambda: {"pre": _conv(rng, 1, half, h), "enc": _wn(rng, h, 5, 4, gin),
                        "post": _zeros_conv(h, half)}
    ftype = flow_type(cfg)
    if ftype == "pre_conv":
        return {"pre_transformer": _encoder(rng, half, half, 2, 2, 3, window=None),
                "pre": _conv(rng, 1, half, h), "enc": _wn(rng, h, 5, 4, gin),
                "post": _zeros_conv(h, half)}
    if ftype == "pre_conv2":
        return {"pre": _conv(rng, 1, half, h), "pre_transformer": _encoder(rng, h, h, 2, 1, 5),
                "enc": _wn(rng, h, 5, 4, gin), "post": _zeros_conv(h, half)}
    if ftype == "fft":
        return {"pre": _conv(rng, 1, half, h), "enc": _fft(rng, h, 768, 4, 1, 5, gin),
                "post": _zeros_conv(h, half)}
    if ftype.startswith("mono_layer"):
        return {"coupling": coupling(),
                "mono": {"pre_transformer": _encoder(rng, half, half, 2, 2, 3, window=None),
                         "post": _zeros_conv(half, half)}}
    return {"coupling": coupling()}


def _decoder(rng, cfg):
    """The generator of ``cfg.decoder_type`` (vits2 generator_init)."""
    per = cfg.gen_istft_n_fft + 2
    if cfg.decoder_type == "hifigan":
        return _generator(rng, cfg, 1)
    if cfg.decoder_type == "istft":
        return _generator(rng, cfg, per)
    if cfg.decoder_type == "mb_istft":
        return _generator(rng, cfg, cfg.subbands * per)
    dec = _generator(rng, cfg, cfg.subbands * per, post_bias=True)
    dec["multistream_conv_post"] = {
        "w": (rng.standard_normal((63, cfg.subbands, 1)) * 0.01).astype(np.float32), "b": None}
    return dec


def synthesizer_init(cfg, seed: int):
    """Bundle-layout VITS2 tree of any configuration the serving passes
    run: every flow type, the SDP or the deterministic duration predictor
    (``use_sdp``), every decoder."""
    check_ported(cfg)
    rng = np.random.default_rng(seed)
    h, inter, gin = cfg.hidden_channels, cfg.inter_channels, cfg.gin_channels
    fc, k = 256, 3

    enc_p = {
        "emb": (rng.standard_normal((cfg.n_vocab, h)) * h**-0.5).astype(np.float32),
        "encoder": _encoder(rng, h, cfg.filter_channels, cfg.n_heads, cfg.n_layers,
                            cfg.kernel_size, gin=cfg.enc_gin_channels),
        "proj": _conv(rng, 1, h, inter * 2),
    }
    dec = _decoder(rng, cfg)
    enc_q = _posterior(rng, cfg)
    flow = {"flows": [_flow_layer(rng, cfg) for _ in range(cfg.n_flows)]}
    if cfg.use_sdp:
        dp = {
            "pre": _conv(rng, 1, h, fc),
            "proj": _conv(rng, 1, fc, fc),
            "convs": _ddsconv(rng, fc, k, 3),
            "flows": [_affine()] + [_convflow(rng, fc, k) for _ in range(cfg.sdp_n_flows)],
            "post_pre": _conv(rng, 1, 1, fc),
            "post_proj": _conv(rng, 1, fc, fc),
            "post_convs": _ddsconv(rng, fc, k, 3),
            "post_flows": [_affine()] + [_convflow(rng, fc, k) for _ in range(cfg.sdp_n_flows)],
        }
        if gin:
            dp["cond"] = _conv(rng, 1, gin, fc)
    else:
        dp = {"conv1": _conv(rng, k, h, fc), "norm1": _norm(fc), "conv2": _conv(rng, k, fc, fc),
              "norm2": _norm(fc), "proj": _conv(rng, 1, fc, 1)}
        if gin:
            dp["cond"] = _conv(rng, 1, gin, h)

    p = {"enc_p": enc_p, "dec": dec, "enc_q": enc_q, "flow": flow, "dp": dp}
    if cfg.n_speakers > 1:
        p["emb_g"] = rng.standard_normal((cfg.n_speakers, gin)).astype(np.float32)
    return p


def vocos_init(cfg, seed: int):
    """Bundle-layout Vocos tree (``vocoder.vocos_init``): the embedding and
    depthwise convs U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the pointwise and
    head Linears N(0, 1/I) with zero biases, unit layer norms, layer scale
    1/num_layers."""
    rng = np.random.default_rng(seed)
    d, inter = cfg.dim, cfg.intermediate_dim
    normal = lambda i, o: {"w": (rng.standard_normal((i, o)) * i**-0.5).astype(np.float32),
                           "b": np.zeros((o,), np.float32)}
    return {
        "embed": _conv(rng, 7, cfg.input_channels, d),
        "norm": _norm(d),
        "blocks": [{"dwconv": _conv(rng, 7, 1, d), "norm": _norm(d), "pw1": normal(d, inter),
                    "pw2": normal(inter, d),
                    "gamma": np.full((d,), 1.0 / cfg.num_layers, np.float32)}
                   for _ in range(cfg.num_layers)],
        "final_norm": _norm(d),
        "head": normal(d, cfg.n_fft + 2),
    }


def bigvgan_init(cfg, seed: int):
    """Bundle-layout BigVGAN tree (``bigvgan.bigvgan_init``): convs
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the upsampling transposed convs
    N(0, 0.01^2) with zero biases, snake ``alpha`` (and ``beta`` for
    snakebeta) 0 on the log scale, else 1; ``conv_post`` without a bias
    unless ``use_bias_at_final``."""
    rng = np.random.default_rng(seed)
    uic = cfg.upsample_initial_channel
    act = lambda c: {k: (np.zeros if cfg.snake_logscale else np.ones)((c,), np.float32)
                     for k in (("alpha", "beta") if cfg.activation == "snakebeta" else ("alpha",))}
    # "acts" stays empty, as in the JAX tree (the AMP blocks hold theirs)
    p = {"conv_pre": _conv(rng, 7, cfg.num_mels, uic), "ups": [], "resblocks": [], "acts": []}
    ch = uic
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        cin, ch = uic // 2**i, uic // 2 ** (i + 1)
        p["ups"].append({"w": (rng.standard_normal((k, cin, ch)) * 0.01).astype(np.float32),
                         "b": np.zeros((ch,), np.float32)})
        for kr, dr in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            p["resblocks"].append({"convs1": [_conv(rng, kr, ch, ch) for _ in dr],
                                   "convs2": [_conv(rng, kr, ch, ch) for _ in dr],
                                   "acts1": [act(ch) for _ in dr], "acts2": [act(ch) for _ in dr]})
    p["act_post"] = act(ch)
    p["conv_post"] = _conv(rng, 7, ch, 1)
    if not cfg.use_bias_at_final:
        p["conv_post"]["b"] = None
    return p


def hubert_init(cfg, seed: int):
    """Bundle-layout HuBERT/ContentVec tree (``hubert.hubert_init``): feature
    convs N(0, 1/(I*K)) without bias, the first with its group norm;
    linears U(-1/sqrt(I), 1/sqrt(I)) with zero biases; ``pos_conv``
    N(0, 0.02^2); unit layer norms."""
    rng = np.random.default_rng(seed)
    h = cfg.hidden_size
    lin = lambda i, o: {"w": _u(rng, (i, o), i**-0.5), "b": np.zeros((o,), np.float32)}
    convs, in_dim = [], 1
    for i, (dim, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        c = {"w": (rng.standard_normal((k, in_dim, dim)) * (in_dim * k) ** -0.5).astype(np.float32)}
        if i == 0:
            c["gn_gamma"], c["gn_beta"] = np.ones((dim,), np.float32), np.zeros((dim,), np.float32)
        convs.append(c)
        in_dim = dim
    groups = cfg.num_conv_pos_embedding_groups
    return {
        "conv_layers": convs, "fp_ln": _norm(cfg.conv_dim[-1]), "fp": lin(cfg.conv_dim[-1], h),
        "pos_conv": {"w": (rng.standard_normal((cfg.num_conv_pos_embeddings, h // groups, h))
                           * 0.02).astype(np.float32),
                     "b": np.zeros((h,), np.float32)},
        "enc_ln": _norm(h),
        "layers": [{"q": lin(h, h), "k": lin(h, h), "v": lin(h, h), "attn_out": lin(h, h),
                    "attn_ln": _norm(h), "ffn_in": lin(h, cfg.intermediate_size),
                    "ffn_out": lin(cfg.intermediate_size, h), "ffn_ln": _norm(h)}
                   for _ in range(cfg.num_hidden_layers)],
    }


def wavlm_init(cfg, seed: int):
    """Bundle-layout WavLM tree with the structure and shapes that
    ``models.wavlm.wavlm_from_state_dict`` gives an HF ``WavLMModel``
    state dict (the JAX package has no WavLM init): bias-free feature convs
    N(0, 2/(I*K)) (kaiming), the first with its group norm; linears
    N(0, 0.02^2) with zero biases (``gru_lin`` (head_dim, 8) too);
    ``pos_conv`` N(0, 4/(K*hidden)), its weight norm folded; ``gru_const``
    ones (1, H, 1, 1); ``rel_attn_embed`` N(0, 1) (buckets, H); unit layer
    norms, as HF initialises them."""
    rng = np.random.default_rng(seed)
    h, heads = cfg.hidden_size, cfg.num_attention_heads
    normal = lambda shape, std: (rng.standard_normal(shape) * std).astype(np.float32)
    lin = lambda i, o: {"w": normal((i, o), 0.02), "b": np.zeros((o,), np.float32)}
    convs, in_dim = [], 1
    for i, (dim, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        c = {"w": normal((k, in_dim, dim), (2.0 / (in_dim * k)) ** 0.5)}
        if i == 0 and cfg.feat_extract_norm == "group":
            c["gn_gamma"], c["gn_beta"] = np.ones((dim,), np.float32), np.zeros((dim,), np.float32)
        convs.append(c)
        in_dim = dim
    k, groups = cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups
    return {
        "conv_layers": convs, "fp_ln": _norm(cfg.conv_dim[-1]), "fp": lin(cfg.conv_dim[-1], h),
        "pos_conv": {"w": normal((k, h // groups, h), 2 * (k * h) ** -0.5),
                     "b": np.zeros((h,), np.float32)},
        "enc_ln": _norm(h),
        "rel_attn_embed": normal((cfg.num_buckets, heads), 1.0),
        "layers": [{"q": lin(h, h), "k": lin(h, h), "v": lin(h, h), "out": lin(h, h),
                    "gru_lin": lin(h // heads, 8),
                    "gru_const": np.ones((1, heads, 1, 1), np.float32),
                    "attn_ln": _norm(h), "ffn_in": lin(h, cfg.intermediate_size),
                    "ffn_out": lin(cfg.intermediate_size, h), "ffn_ln": _norm(h)}
                   for _ in range(cfg.num_hidden_layers)],
    }


def quickvc_init(cfg, seed: int):
    """Bundle-layout QuickVC tree (``quickvc.synthesizer_init``): the
    posterior encoders over ContentVec (no speaker conditioning) and over
    the linear spectrogram, four plain mean-only couplings (zero ``post``),
    the ms-iSTFT generator (``conv_post`` with its bias,
    ``multistream_conv_post`` N(0, 0.01^2)) and the LSTM speaker encoder
    (U(-1/sqrt(H), 1/sqrt(H)) gates, zero linear bias)."""
    rng = np.random.default_rng(seed)
    v = cfg.as_vits2()
    h, half, gin = v.hidden_channels, v.inter_channels // 2, v.gin_channels
    dec = _generator(rng, v, v.subbands * (v.gen_istft_n_fft + 2), post_bias=True)
    dec["multistream_conv_post"] = {
        "w": (rng.standard_normal((63, v.subbands, 1)) * 0.01).astype(np.float32), "b": None}
    s, hid = gin**-0.5, gin
    lstm = [{"w_ih": _u(rng, (cfg.n_mel_channels if i == 0 else hid, 4 * hid), s),
             "w_hh": _u(rng, (hid, 4 * hid), s), "b_ih": _u(rng, (4 * hid,), s),
             "b_hh": _u(rng, (4 * hid,), s)} for i in range(3)]
    return {
        "enc_p": _posterior(rng, cfg.as_vits2(spec_channels=cfg.ssl_dim, gin=0)),
        "enc_q": _posterior(rng, v),
        "flow": {"flows": [{"coupling": {"pre": _conv(rng, 1, half, h),
                                         "enc": _wn(rng, h, 5, 4, gin),
                                         "post": _zeros_conv(h, half)}}
                           for _ in range(v.n_flows)]},
        "dec": dec,
        "enc_spk": {"lstm": lstm, "linear": {"w": _u(rng, (hid, gin), s),
                                             "b": np.zeros((gin,), np.float32)}},
    }


def ar_init(cfg, seed: int):
    """Bundle-layout GPT-SoVITS AR tree (``gpt_sovits.ar_init``): embeddings
    N(0, 0.02^2), linears U(-1/sqrt(I), 1/sqrt(I)) with zero biases (no
    bias on ``predict``), unit alphas and layer norms."""
    rng = np.random.default_rng(seed)
    d = cfg.hidden_dim
    lin = lambda i, o: {"w": _u(rng, (i, o), i**-0.5), "b": np.zeros((o,), np.float32)}
    normal = lambda shape: (rng.standard_normal(shape) * 0.02).astype(np.float32)
    return {
        "text_emb": normal((cfg.phoneme_vocab_size, cfg.embedding_dim)),
        "audio_emb": normal((cfg.vocab_size, cfg.embedding_dim)),
        "bert_proj": lin(cfg.bert_dim, cfg.embedding_dim),
        "text_alpha": np.ones((), np.float32),
        "audio_alpha": np.ones((), np.float32),
        "predict": {"w": _u(rng, (d, cfg.vocab_size), d**-0.5)},
        "layers": [{"qkv": lin(d, 3 * d), "out": lin(d, d), "ln1": _norm(d),
                    "ff1": lin(d, cfg.ff_mult * d), "ff2": lin(cfg.ff_mult * d, d), "ln2": _norm(d)}
                   for _ in range(cfg.num_layers)],
    }


def sovits_init(cfg, seed: int):
    """Bundle-layout GPT-SoVITS SoVITS tree (``gpt_sovits.sovits_init``):
    the strided SSL projection and the N(0, 1) codebook; the text encoder
    (SSL, text and second relative-position encoders, N(0, 1) symbol
    embeddings, MRTE with 4-head cross-attention); the posterior, four
    plain mean-only couplings (zero ``post``) and the speaker-conditioned
    HiFiGAN generator of ``cfg.as_vits2()``; the mel style encoder
    (linears and GLU convs with zero biases)."""
    rng = np.random.default_rng(seed)
    v = cfg.as_vits2()
    h, mh, sh = cfg.hidden_channels, cfg.mrte_hidden, cfg.style_hidden
    half, gin = v.inter_channels // 2, v.gin_channels
    enc = lambda layers: _encoder(rng, h, cfg.filter_channels, cfg.n_heads, layers, cfg.kernel_size)
    lin = lambda i, o: {"w": _u(rng, (i, o), i**-0.5), "b": np.zeros((o,), np.float32)}
    glu = lambda: {"w": _u(rng, (5, sh, 2 * sh), (sh * 5) ** -0.5),
                   "b": np.zeros((2 * sh,), np.float32)}
    return {
        "ssl_proj": _conv(rng, 2 if cfg.semantic_frame_rate == "25hz" else 1, cfg.ssl_dim,
                          cfg.ssl_dim),
        "codebook": rng.standard_normal((cfg.n_codes, cfg.ssl_dim)).astype(np.float32),
        "enc_p": {
            "ssl_proj": _conv(rng, 1, cfg.ssl_dim, h),
            "encoder_ssl": enc(cfg.n_layers // 2),
            "text_emb": rng.standard_normal((cfg.n_symbols, h)).astype(np.float32),
            "encoder_text": enc(cfg.n_layers),
            "mrte": {"c_pre": _conv(rng, 1, h, mh), "text_pre": _conv(rng, 1, h, mh),
                     "attn": {k: _xavier(rng, mh, mh) for k in ("q", "k", "v", "o")},
                     "c_post": _conv(rng, 1, mh, h)},
            "encoder2": enc(cfg.n_layers // 2),
            "proj": _conv(rng, 1, h, cfg.inter_channels * 2),
        },
        "enc_q": _posterior(rng, v),
        "flow": {"flows": [{"coupling": {"pre": _conv(rng, 1, half, v.hidden_channels),
                                         "enc": _wn(rng, v.hidden_channels, 5, 4, gin),
                                         "post": _zeros_conv(v.hidden_channels, half)}}
                           for _ in range(v.n_flows)]},
        "dec": _generator(rng, v, 1),
        "ref_enc": {"spec1": lin(cfg.spec_channels, sh), "spec2": lin(sh, sh),
                    "glu1": glu(), "glu2": glu(),
                    **{k: lin(sh, sh) for k in ("wq", "wk", "wv", "fc_attn")},
                    "fc": lin(sh, gin)},
    }


# ---------------------------------------------------------------------------
# The discriminators (vosk_tts_tpu/models/discriminators.py), bundle layout
# ---------------------------------------------------------------------------


def _conv2d(rng, kh, kw, c_in, c_out):
    s = (c_in * kh * kw) ** -0.5
    return {"w": _u(rng, (kh, kw, c_in, c_out), s), "b": _u(rng, (c_out,), s)}


_P_CHANNELS = (1, 32, 128, 512, 1024, 1024)
# DiscriminatorS: (kernel, stride, groups, c_in, c_out, padding)
S_SPECS = ((15, 1, 1, 1, 16, 7), (41, 4, 4, 16, 64, 20), (41, 4, 16, 64, 256, 20),
           (41, 4, 64, 256, 1024, 20), (41, 4, 256, 1024, 1024, 20), (5, 1, 1, 1024, 1024, 2))
SPEC_BANDS = ((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0))


def _disc_s(rng):
    return {"convs": [_conv(rng, k, c_in // g, c_out) for k, _, g, c_in, c_out, _ in S_SPECS],
            "post": _conv(rng, 3, 1024, 1)}


def _disc_p(rng):
    return {"convs": [_conv2d(rng, 5, 1, _P_CHANNELS[i], _P_CHANNELS[i + 1]) for i in range(5)],
            "post": _conv2d(rng, 3, 1, 1024, 1)}


def mpd_init(seed: int):
    """Bundle-layout MultiPeriodDiscriminator (``discriminators.mpd_init``,
    QuickVC's): DiscriminatorS and a DiscriminatorP for each of the periods
    2, 3, 5, 7, 11, initialised as in :func:`mpmsd_init`."""
    rng = np.random.default_rng(seed)
    return {"s": _disc_s(rng), "p": [_disc_p(rng) for _ in range(5)]}


def mpmsd_init(seed: int, periods=(2, 3, 5, 7, 11), spec_ffts=(1024, 2048, 512)):
    """Bundle-layout MultiPeriodMultiSpec discriminator (``mpmsd_init``):
    DiscriminatorS (grouped Conv1d), a DiscriminatorP a period (kernel
    (5, 1) Conv2d, 1 -> 1024 channels) and a DiscriminatorSpec an FFT size
    (five frequency bands of 32-channel Conv2d), every weight and bias
    U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    rng = np.random.default_rng(seed)
    disc_s = _disc_s(rng)
    disc_p = [_disc_p(rng) for _ in periods]
    ch = 32
    disc_spec = [{"band_convs": [[_conv2d(rng, 3, 9, 2, ch), _conv2d(rng, 3, 9, ch, ch),
                                  _conv2d(rng, 3, 9, ch, ch), _conv2d(rng, 3, 9, ch, ch),
                                  _conv2d(rng, 3, 3, ch, ch)] for _ in SPEC_BANDS],
                  "post": _conv2d(rng, 3, 3, ch, 1)} for _ in spec_ffts]
    return {"s": disc_s, "p": disc_p, "spec": disc_spec}


def duration_disc_init(seed: int, in_channels: int, filter_channels: int, kernel_size: int = 3):
    """Bundle-layout duration discriminator, variant 2 (``duration_disc_init``:
    convs U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the output Linear
    N(0, 1/filter_channels) with a zero bias, unit layer norms)."""
    rng = np.random.default_rng(seed)
    fc = filter_channels
    return {
        "conv1": _conv(rng, kernel_size, in_channels, fc),
        "conv2": _conv(rng, kernel_size, fc, fc),
        "dur_proj": _conv(rng, 1, 1, fc),
        "pre_out_conv1": _conv(rng, kernel_size, 2 * fc, fc),
        "pre_out_conv2": _conv(rng, kernel_size, fc, fc),
        "output": {"w": (rng.standard_normal((fc, 1)) * fc**-0.5).astype(np.float32),
                   "b": np.zeros((1,), np.float32)},
        "norm1": _norm(fc), "norm2": _norm(fc), "pre_out_norm1": _norm(fc),
        "pre_out_norm2": _norm(fc),
    }


def wavlm_disc_init(seed: int, slm_hidden: int = 768, slm_layers: int = 13, initial: int = 64):
    """Bundle-layout WavLM discriminator (``discriminators.wavlm_disc_init``):
    the 1x1 ``pre`` conv over the stacked states, three k=5 convs (initial
    -> 2x -> 4x -> 4x channels), the k=3 ``post`` conv; every weight and bias
    U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    rng = np.random.default_rng(seed)
    return {"pre": _conv(rng, 1, slm_hidden * slm_layers, initial),
            "convs": [_conv(rng, 5, initial, initial * 2), _conv(rng, 5, initial * 2, initial * 4),
                      _conv(rng, 5, initial * 4, initial * 4)],
            "post": _conv(rng, 3, initial * 4, 1)}


def whisper_init(cfg, seed: int):
    """Bundle-layout Whisper encoder tree (``whisper.whisper_encoder_init``):
    convs N(0, 0.02^2) with zero biases, linears N(0, 1/I) with zero biases
    (``k``'s bias, which the encoder does not read, too), the sinusoidal
    ``pos`` table, unit layer norms."""
    rng = np.random.default_rng(seed)
    d, f = cfg.d_model, cfg.encoder_ffn_dim
    normal = lambda shape, std: (rng.standard_normal(shape) * std).astype(np.float32)
    lin = lambda i, o: {"w": normal((i, o), i**-0.5), "b": np.zeros((o,), np.float32)}
    ln = lambda: {"g": np.ones((d,), np.float32), "b": np.zeros((d,), np.float32)}
    return {
        "conv1": {"w": normal((3, cfg.num_mel_bins, d), 0.02), "b": np.zeros((d,), np.float32)},
        "conv2": {"w": normal((3, d, d), 0.02), "b": np.zeros((d,), np.float32)},
        "pos": _sinusoids(cfg.max_source_positions, d),
        "layers": [{"ln1": ln(),
                    "attn": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "out": lin(d, d)},
                    "ln2": ln(), "fc1": lin(d, f), "fc2": lin(f, d)}
                   for _ in range(cfg.encoder_layers)],
        "ln_post": ln(),
    }
