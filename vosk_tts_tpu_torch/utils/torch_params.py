"""Reference torch checkpoints -> bundle-layout parameter trees
(vosk_tts_tpu/utils/torch_params.py), numpy only.

Input is a flat ``state_dict``-style mapping of parameter name -> array
(:func:`read_state_dict` reads a ``G_*.pth``, an HF ``pytorch_model.bin``
or ``model.safetensors``). Output is the BUNDLE layout, the tree that
``params.npz`` holds and that ``utils/params.to_port_layout`` turns into the
port's layouts at load. Conversion is a pure name map:

  Conv1d  (O, I, K) -> (K, I, O)        ConvTranspose1d (I, O, K) -> (K, I, O)
  Linear  (O, I)    -> (I, O)           weight-norm g/v pairs are folded.

Layout mirrors the reference module tree (training/vits2/models.py), so each
accessor below cites the torch module it converts.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch


_WEIGHT_NORM_PAIRS = ((".weight_g", ".weight_v"),
                      (".parametrizations.weight.original0", ".parametrizations.weight.original1"))


def fold_weight_norm(sd: dict) -> dict:
    """Replace each weight-norm pair, ``*.weight_g``/``*.weight_v`` or
    ``*.parametrizations.weight.original0``/``original1`` (torch's newer
    spelling, which HF's positional convs use), by the effective
    ``*.weight`` g * v / ||v||, the norm over the axes where g has size 1:
    every axis but the first for torch's ``weight_norm(dim=0)`` (the output
    channels of a Conv1d, the input channels of a ConvTranspose1d), the
    output and input channels for HF's positional conv (``dim=2``)."""
    out = dict(sd)
    for k in list(sd):
        for g_suffix, v_suffix in _WEIGHT_NORM_PAIRS:
            if k.endswith(v_suffix):
                base = k[: -len(v_suffix)]
                v = np.asarray(sd[k], dtype=np.float32)
                g = np.asarray(sd[base + g_suffix], dtype=np.float32)  # keepdims, as torch keeps it
                axes = tuple(i for i in range(v.ndim) if g.shape[i] == 1)
                out[base + ".weight"] = g * v / np.sqrt((v**2).sum(axis=axes, keepdims=True))
                del out[k], out[base + g_suffix]
    return out


# safetensors dtype -> (numpy dtype of the stored words, conversion to the leaf)
_SAFETENSORS_DTYPES = {
    "F32": (np.float32, None),
    "F16": (np.float16, None),
    # bfloat16 is the upper half of a float32: widen by a 16-bit shift
    "BF16": (np.uint16, lambda a: (a.astype(np.uint32) << 16).view(np.float32)),
    "I64": (np.int64, None),  # HF's integer buffers (position ids)
}


def read_safetensors(path) -> dict:
    """A ``.safetensors`` file -> {name: numpy array}: an 8-byte
    little-endian header length, the JSON header ({name: {dtype, shape,
    data_offsets}}, and an optional ``__metadata__``), then the raw
    little-endian buffers. F32, F16, BF16 (widened to f32) and I64."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which this reader "
                             f"does not read")
        dtype, widen = _SAFETENSORS_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if not 0 <= start <= end <= len(data) or end - start != np.dtype(dtype).itemsize * int(
                np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path}: {name}'s offsets {start}..{end} do not fit its "
                             f"{info['dtype']} shape {list(shape)}")
        a = np.frombuffer(data[start:end], dtype=np.dtype(dtype).newbyteorder("<"))
        a = a.astype(dtype).reshape(shape)
        out[name] = widen(a) if widen else a
    return out


def read_state_dict(path) -> dict:
    """A reference checkpoint -> {name: numpy array}. ``*.safetensors`` by
    :func:`read_safetensors`; anything else by ``torch.load(weights_only=
    True)`` (the reference's ``G_*.pth`` writes ``{"model": state_dict,
    "iteration", ...}``: its ``model``; an HF ``pytorch_model.bin`` is the
    state dict itself); floating tensors as float32."""
    if str(path).endswith(".safetensors"):
        return read_safetensors(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["model"] if "model" in ckpt else ckpt
    return {k: (v.float() if v.is_floating_point() else v).numpy()
            for k, v in sd.items() if isinstance(v, torch.Tensor)}


def _np(x):
    return np.asarray(x, dtype=np.float32)


def conv(sd, p):
    w = _np(sd[p + ".weight"]).transpose(2, 1, 0)
    b = _np(sd[p + ".bias"]) if p + ".bias" in sd else None
    return {"w": w, "b": b}


def convT(sd, p):
    w = _np(sd[p + ".weight"]).transpose(2, 0, 1)
    b = _np(sd[p + ".bias"]) if p + ".bias" in sd else None
    return {"w": w, "b": b}


def linear(sd, p):
    return {"w": _np(sd[p + ".weight"]).T, "b": _np(sd[p + ".bias"])}


def ln(sd, p):
    return {"gamma": _np(sd[p + ".gamma"]), "beta": _np(sd[p + ".beta"])}


def wn_module(sd, p, gin: bool):
    """modules.WN"""
    n = 0
    while f"{p}.in_layers.{n}.weight" in sd:
        n += 1
    out = {
        "in": [conv(sd, f"{p}.in_layers.{i}") for i in range(n)],
        "res_skip": [conv(sd, f"{p}.res_skip_layers.{i}") for i in range(n)],
    }
    if gin and f"{p}.cond_layer.weight" in sd:
        out["cond"] = conv(sd, f"{p}.cond_layer")
    return out


def ddsconv(sd, p):
    n = 0
    while f"{p}.convs_sep.{n}.weight" in sd:
        n += 1
    return {
        "sep": [conv(sd, f"{p}.convs_sep.{i}") for i in range(n)],
        "pw": [conv(sd, f"{p}.convs_1x1.{i}") for i in range(n)],
        "norm1": [ln(sd, f"{p}.norms_1.{i}") for i in range(n)],
        "norm2": [ln(sd, f"{p}.norms_2.{i}") for i in range(n)],
    }


def mha(sd, p):
    out = {"q": conv(sd, p + ".conv_q"), "k": conv(sd, p + ".conv_k"),
           "v": conv(sd, p + ".conv_v"), "o": conv(sd, p + ".conv_o")}
    if p + ".emb_rel_k" in sd:
        out["emb_rel_k"] = _np(sd[p + ".emb_rel_k"])
        out["emb_rel_v"] = _np(sd[p + ".emb_rel_v"])
    return out


def ffn(sd, p):
    return {"c1": conv(sd, p + ".conv_1"), "c2": conv(sd, p + ".conv_2")}


def encoder(sd, p):
    """attentions.Encoder"""
    n = 0
    while f"{p}.attn_layers.{n}.conv_q.weight" in sd:
        n += 1
    out = {
        "attn": [mha(sd, f"{p}.attn_layers.{i}") for i in range(n)],
        "ffn": [ffn(sd, f"{p}.ffn_layers.{i}") for i in range(n)],
        "norm1": [ln(sd, f"{p}.norm_layers_1.{i}") for i in range(n)],
        "norm2": [ln(sd, f"{p}.norm_layers_2.{i}") for i in range(n)],
    }
    if f"{p}.spk_emb_linear.weight" in sd:
        out["spk_emb"] = linear(sd, f"{p}.spk_emb_linear")
    return out


def fft_block(sd, p):
    """attentions.FFT"""
    n = 0
    while f"{p}.self_attn_layers.{n}.conv_q.weight" in sd:
        n += 1
    out = {
        "attn": [mha(sd, f"{p}.self_attn_layers.{i}") for i in range(n)],
        "ffn": [ffn(sd, f"{p}.ffn_layers.{i}") for i in range(n)],
        "norm0": [ln(sd, f"{p}.norm_layers_0.{i}") for i in range(n)],
        "norm1": [ln(sd, f"{p}.norm_layers_1.{i}") for i in range(n)],
    }
    if f"{p}.cond_layer.weight" in sd:
        out["cond_layer"] = conv(sd, f"{p}.cond_layer")
        out["cond_pre"] = conv(sd, f"{p}.cond_pre")
    return out


def elementwise_affine(sd, p):
    return {"m": _np(sd[p + ".m"])[:, 0], "logs": _np(sd[p + ".logs"])[:, 0]}


def convflow(sd, p):
    return {"pre": conv(sd, p + ".pre"), "convs": ddsconv(sd, p + ".convs"), "proj": conv(sd, p + ".proj")}


def coupling(sd, p, gin: bool):
    return {"pre": conv(sd, p + ".pre"), "enc": wn_module(sd, p + ".enc", gin), "post": conv(sd, p + ".post")}


def sdp(sd, p, gin: bool):
    """models.StochasticDurationPredictor; flows.{0}=EA, flows.{2i+1}=ConvFlow,
    even indices >0 are Flip (no params)."""
    out = {
        "pre": conv(sd, p + ".pre"),
        "proj": conv(sd, p + ".proj"),
        "convs": ddsconv(sd, p + ".convs"),
        "flows": [elementwise_affine(sd, p + ".flows.0")]
        + [convflow(sd, f"{p}.flows.{2 * i + 1}") for i in range(4)],
        "post_pre": conv(sd, p + ".post_pre"),
        "post_proj": conv(sd, p + ".post_proj"),
        "post_convs": ddsconv(sd, p + ".post_convs"),
        "post_flows": [elementwise_affine(sd, p + ".post_flows.0")]
        + [convflow(sd, f"{p}.post_flows.{2 * i + 1}") for i in range(4)],
    }
    if gin:
        out["cond"] = conv(sd, p + ".cond")
    return out


def dp(sd, p, gin: bool):
    out = {
        "conv1": conv(sd, p + ".conv_1"),
        "norm1": ln(sd, p + ".norm_1"),
        "conv2": conv(sd, p + ".conv_2"),
        "norm2": ln(sd, p + ".norm_2"),
        "proj": conv(sd, p + ".proj"),
    }
    if gin:
        out["cond"] = conv(sd, p + ".cond")
    return out


def flow_block(sd, p, cfg):
    """models.ResidualCouplingTransformersBlock"""
    ftype = cfg.transformer_flow_type if cfg.use_transformer_flows else "plain"
    gin = cfg.gin_channels > 0
    layers = []
    if ftype in ("mono_layer_inter_residual", "mono_layer_post_residual"):
        i = 0
        while f"{p}.flows.{3 * i}.pre.weight" in sd:
            layers.append({
                "coupling": coupling(sd, f"{p}.flows.{3 * i}", gin),
                "mono": {
                    "pre_transformer": encoder(sd, f"{p}.flows.{3 * i + 2}.pre_transformer"),
                    "post": conv(sd, f"{p}.flows.{3 * i + 2}.post"),
                },
            })
            i += 1
    else:
        i = 0
        while f"{p}.flows.{2 * i}.pre.weight" in sd:
            base = f"{p}.flows.{2 * i}"
            if ftype == "plain":
                layers.append({"coupling": coupling(sd, base, gin)})
            elif ftype in ("pre_conv", "pre_conv2"):
                layers.append({
                    "pre": conv(sd, base + ".pre"),
                    "pre_transformer": encoder(sd, base + ".pre_transformer"),
                    "enc": wn_module(sd, base + ".enc", gin),
                    "post": conv(sd, base + ".post"),
                })
            elif ftype == "fft":
                layers.append({
                    "pre": conv(sd, base + ".pre"),
                    "enc": fft_block(sd, base + ".enc"),
                    "post": conv(sd, base + ".post"),
                })
            i += 1
    return {"flows": layers}


def generator(sd, p, cfg):
    n_ups = len(cfg.upsample_rates)
    n_res = n_ups * len(cfg.resblock_kernel_sizes)
    out = {"conv_pre": conv(sd, p + ".conv_pre"), "ups": [convT(sd, f"{p}.ups.{i}") for i in range(n_ups)]}
    blocks = []
    for i in range(n_res):
        base = f"{p}.resblocks.{i}"
        if cfg.resblock == "1":
            blocks.append({
                "convs1": [conv(sd, f"{base}.convs1.{j}") for j in range(3)],
                "convs2": [conv(sd, f"{base}.convs2.{j}") for j in range(3)],
            })
        else:
            blocks.append({"convs": [conv(sd, f"{base}.convs.{j}") for j in range(2)]})
    out["resblocks"] = blocks
    if cfg.decoder_type in ("mb_istft", "ms_istft"):
        out["conv_post"] = conv(sd, p + ".subband_conv_post")
    else:
        out["conv_post"] = conv(sd, p + ".conv_post")
    if cfg.decoder_type == "ms_istft":
        out["multistream_conv_post"] = conv(sd, p + ".multistream_conv_post")
    if f"{p}.cond.weight" in sd:
        out["cond"] = conv(sd, p + ".cond")
    return out


def posterior(sd, p, gin: bool):
    """models.PosteriorEncoder (pre conv -> WN -> proj)."""
    return {"pre": conv(sd, p + ".pre"), "enc": wn_module(sd, p + ".enc", gin), "proj": conv(sd, p + ".proj")}


def lstm_stack(sd, p):
    """torch.nn.LSTM -> list of per-layer gate matrices (quickvc layout)."""
    layers = []
    i = 0
    while f"{p}.weight_ih_l{i}" in sd:
        layers.append({
            "w_ih": _np(sd[f"{p}.weight_ih_l{i}"]).T,
            "w_hh": _np(sd[f"{p}.weight_hh_l{i}"]).T,
            "b_ih": _np(sd[f"{p}.bias_ih_l{i}"]),
            "b_hh": _np(sd[f"{p}.bias_hh_l{i}"]),
        })
        i += 1
    return layers


def quickvc_from_state_dict(sd: dict, cfg) -> dict:
    """vc/models.py SynthesizerTrn state_dict -> the QuickVC tree
    (models/quickvc.py): enc_p over contentvec, enc_q over spec, plain
    coupling flow, MS-iSTFT decoder, LSTM speaker encoder."""
    sd = fold_weight_norm(sd)
    return {
        "enc_p": posterior(sd, "enc_p", False),
        "enc_q": posterior(sd, "enc_q", True),
        "flow": flow_block(sd, "flow", cfg.as_vits2()),
        "dec": generator(sd, "dec", cfg.as_vits2()),
        "enc_spk": {
            "lstm": lstm_stack(sd, "enc_spk.lstm"),
            "linear": linear(sd, "enc_spk.linear"),
        },
    }


def sovits_from_state_dict(sd: dict, cfg) -> dict:
    """GPT-SoVITS stage-2 SynthesizerTrn state_dict
    (training/gpt-sovits/module/models.py:825-899) -> the SoVITS tree
    (models/gpt_sovits.py): ssl_proj + RVQ codebook, MRTE TextEncoder,
    MelStyleEncoder, coupling flow, HiFiGAN decoder."""
    sd = fold_weight_norm(sd)
    v = cfg.as_vits2()
    return {
        "ssl_proj": conv(sd, "ssl_proj"),
        "codebook": _np(sd["quantizer.vq.layers.0._codebook.embed"]),
        "enc_p": {
            "ssl_proj": conv(sd, "enc_p.ssl_proj"),
            "encoder_ssl": encoder(sd, "enc_p.encoder_ssl"),
            "text_emb": _np(sd["enc_p.text_embedding.weight"]),
            "encoder_text": encoder(sd, "enc_p.encoder_text"),
            "mrte": {
                "c_pre": conv(sd, "enc_p.mrte.c_pre"),
                "text_pre": conv(sd, "enc_p.mrte.text_pre"),
                "attn": mha(sd, "enc_p.mrte.cross_attention"),
                "c_post": conv(sd, "enc_p.mrte.c_post"),
            },
            "encoder2": encoder(sd, "enc_p.encoder2"),
            "proj": conv(sd, "enc_p.proj"),
        },
        "enc_q": posterior(sd, "enc_q", True),
        "flow": flow_block(sd, "flow", v),
        "dec": generator(sd, "dec", v),
        "ref_enc": {
            # MelStyleEncoder (module/modules.py:685-763)
            "spec1": linear(sd, "ref_enc.spectral.0.fc"),
            "spec2": linear(sd, "ref_enc.spectral.3.fc"),
            "glu1": conv(sd, "ref_enc.temporal.0.conv1.conv"),
            "glu2": conv(sd, "ref_enc.temporal.1.conv1.conv"),
            "wq": linear(sd, "ref_enc.slf_attn.w_qs"),
            "wk": linear(sd, "ref_enc.slf_attn.w_ks"),
            "wv": linear(sd, "ref_enc.slf_attn.w_vs"),
            "fc_attn": linear(sd, "ref_enc.slf_attn.fc"),
            "fc": linear(sd, "ref_enc.fc.fc"),
        },
    }


def bert_from_state_dict(sd: dict, num_layers: int) -> dict:
    """HF BertModel state_dict -> the BERT tree (models/bert.py)."""
    p = {
        "word_emb": _np(sd["embeddings.word_embeddings.weight"]),
        "pos_emb": _np(sd["embeddings.position_embeddings.weight"]),
        "type_emb": _np(sd["embeddings.token_type_embeddings.weight"]),
        "emb_ln": {"gamma": _np(sd["embeddings.LayerNorm.weight"]), "beta": _np(sd["embeddings.LayerNorm.bias"])},
        "layers": [],
    }
    for i in range(num_layers):
        b = f"encoder.layer.{i}"
        p["layers"].append({
            "q": linear(sd, f"{b}.attention.self.query"),
            "k": linear(sd, f"{b}.attention.self.key"),
            "v": linear(sd, f"{b}.attention.self.value"),
            "attn_out": linear(sd, f"{b}.attention.output.dense"),
            "attn_ln": {"gamma": _np(sd[f"{b}.attention.output.LayerNorm.weight"]),
                        "beta": _np(sd[f"{b}.attention.output.LayerNorm.bias"])},
            "ffn_in": linear(sd, f"{b}.intermediate.dense"),
            "ffn_out": linear(sd, f"{b}.output.dense"),
            "ffn_ln": {"gamma": _np(sd[f"{b}.output.LayerNorm.weight"]),
                       "beta": _np(sd[f"{b}.output.LayerNorm.bias"])},
        })
    return p


def vits2_from_state_dict(sd: dict, cfg) -> dict:
    """Full SynthesizerTrn state_dict -> the VITS2 tree (models/vits2.py)."""
    sd = fold_weight_norm(sd)
    gin = cfg.gin_channels > 0
    params = {
        "enc_p": {
            "emb": _np(sd["enc_p.emb.weight"]),
            "encoder": encoder(sd, "enc_p.encoder"),
            "proj": conv(sd, "enc_p.proj"),
        },
        "dec": generator(sd, "dec", cfg),
        "enc_q": {
            "pre": conv(sd, "enc_q.pre"),
            "enc": wn_module(sd, "enc_q.enc", gin),
            "proj": conv(sd, "enc_q.proj"),
        },
        "flow": flow_block(sd, "flow", cfg),
        "dp": sdp(sd, "dp", gin) if cfg.use_sdp else dp(sd, "dp", gin),
    }
    if "emb_g.weight" in sd:
        params["emb_g"] = _np(sd["emb_g.weight"])
    return params
