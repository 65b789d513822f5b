"""Bundle-layout trees -> synthetic state dicts in the reference's naming.

The inverse of the state-dict readers (vosk_tts_tpu_torch/utils/torch_params.py
and the models' ``*_from_state_dict``): each writer takes a bundle-layout
tree (``utils/params.*_init``, numpy leaves) and gives the flat
{name: numpy array} dict that the reference's torch module would save:

  Conv1d (K, I, O) -> (O, I, K)         ConvTranspose1d (K, I, O) -> (I, O, K)
  Linear (I, O)    -> (O, I)            LSTM gates (I, 4H) -> (4H, I)

The weights that the reference wraps in ``weight_norm`` (the WN layers, the
generators' upsampling, residual and post convs, every BigVGAN conv) are
split into ``weight_g``/``weight_v``: v is the weight times a per-channel
scale, g the weight's norm over every axis but dim 0, so that folding gives
the weight back. HuBERT's positional conv takes the spelling asked for.

Also a synthetic CMUdict (:func:`synthetic_lexicon`, :func:`write_cmudict`)
for the G2P tools. Imports numpy only (chip_smoke.py imports it from
``tests/``).
"""

from __future__ import annotations

import os

import numpy as np

# the positional conv's spellings: folded; HF's (weight norm over dim 2) as
# torch's parametrizations or as weight_g/weight_v; weight_g/weight_v over dim 0
POS_SPELLINGS = ("folded", "parametrizations", "weight_norm", "weight_norm_dim0")


def _weight(sd, p, w, wn=False, keep=0, names=(".weight_g", ".weight_v")):
    """Write torch-layout ``w`` at ``p``: as ``.weight``, or (``wn``) as a
    weight-norm pair whose g keeps the axes ``keep`` (torch's ``dim``)."""
    w = np.ascontiguousarray(w, dtype=np.float32)
    if not wn:
        sd[p + ".weight"] = w
        return
    keep = (keep,) if isinstance(keep, int) else keep
    axes = tuple(i for i in range(w.ndim) if i not in keep)
    scale_shape = [w.shape[i] if i in keep else 1 for i in range(w.ndim)]
    scale = np.linspace(0.5, 2.0, int(np.prod(scale_shape)), dtype=np.float32).reshape(scale_shape)
    sd[p + names[0]] = np.sqrt((w.astype(np.float64) ** 2).sum(axis=axes, keepdims=True)).astype(
        np.float32)
    sd[p + names[1]] = w * scale


def _bias(sd, p, b):
    if b is not None:
        sd[p + ".bias"] = np.asarray(b, np.float32)


def conv(sd, p, node, wn=False):
    _weight(sd, p, np.asarray(node["w"]).transpose(2, 1, 0), wn)
    _bias(sd, p, node.get("b"))


def convT(sd, p, node, wn=False):
    _weight(sd, p, np.asarray(node["w"]).transpose(1, 2, 0), wn)
    _bias(sd, p, node.get("b"))


def linear(sd, p, node):
    sd[p + ".weight"] = np.ascontiguousarray(np.asarray(node["w"]).T)
    _bias(sd, p, node.get("b"))


def ln(sd, p, node):
    sd[p + ".gamma"], sd[p + ".beta"] = node["gamma"], node["beta"]


def ln_wb(sd, p, node):
    """A torch LayerNorm (``weight``/``bias``)."""
    sd[p + ".weight"], sd[p + ".bias"] = node["gamma"], node["beta"]


def wn_module(sd, p, node):
    for i, (a, b) in enumerate(zip(node["in"], node["res_skip"])):
        conv(sd, f"{p}.in_layers.{i}", a, wn=True)
        conv(sd, f"{p}.res_skip_layers.{i}", b, wn=True)
    if "cond" in node:
        conv(sd, f"{p}.cond_layer", node["cond"], wn=True)


def ddsconv(sd, p, node):
    for i in range(len(node["sep"])):
        conv(sd, f"{p}.convs_sep.{i}", node["sep"][i])
        conv(sd, f"{p}.convs_1x1.{i}", node["pw"][i])
        ln(sd, f"{p}.norms_1.{i}", node["norm1"][i])
        ln(sd, f"{p}.norms_2.{i}", node["norm2"][i])


def mha(sd, p, node):
    for n in "qkvo":
        conv(sd, f"{p}.conv_{n}", node[n])
    if "emb_rel_k" in node:
        sd[p + ".emb_rel_k"], sd[p + ".emb_rel_v"] = node["emb_rel_k"], node["emb_rel_v"]


def ffn(sd, p, node):
    conv(sd, p + ".conv_1", node["c1"])
    conv(sd, p + ".conv_2", node["c2"])


def encoder(sd, p, node):
    for i in range(len(node["attn"])):
        mha(sd, f"{p}.attn_layers.{i}", node["attn"][i])
        ffn(sd, f"{p}.ffn_layers.{i}", node["ffn"][i])
        ln(sd, f"{p}.norm_layers_1.{i}", node["norm1"][i])
        ln(sd, f"{p}.norm_layers_2.{i}", node["norm2"][i])
    if "spk_emb" in node:
        linear(sd, p + ".spk_emb_linear", node["spk_emb"])


def fft_block(sd, p, node):
    for i in range(len(node["attn"])):
        mha(sd, f"{p}.self_attn_layers.{i}", node["attn"][i])
        ffn(sd, f"{p}.ffn_layers.{i}", node["ffn"][i])
        ln(sd, f"{p}.norm_layers_0.{i}", node["norm0"][i])
        ln(sd, f"{p}.norm_layers_1.{i}", node["norm1"][i])
    if "cond_layer" in node:
        conv(sd, p + ".cond_layer", node["cond_layer"])
        conv(sd, p + ".cond_pre", node["cond_pre"])


def coupling(sd, p, node):
    conv(sd, p + ".pre", node["pre"])
    wn_module(sd, p + ".enc", node["enc"])
    conv(sd, p + ".post", node["post"])


def _flows(sd, p, flows):
    """flows.0 an ElementwiseAffine, flows.{2i+1} ConvFlows (Flips between)."""
    sd[p + ".0.m"], sd[p + ".0.logs"] = flows[0]["m"][:, None], flows[0]["logs"][:, None]
    for i, cf in enumerate(flows[1:]):
        conv(sd, f"{p}.{2 * i + 1}.pre", cf["pre"])
        ddsconv(sd, f"{p}.{2 * i + 1}.convs", cf["convs"])
        conv(sd, f"{p}.{2 * i + 1}.proj", cf["proj"])


def duration_predictor(sd, p, node):
    if "flows" in node:  # StochasticDurationPredictor
        for k in ("pre", "proj", "post_pre", "post_proj"):
            conv(sd, f"{p}.{k}", node[k])
        ddsconv(sd, p + ".convs", node["convs"])
        ddsconv(sd, p + ".post_convs", node["post_convs"])
        _flows(sd, p + ".flows", node["flows"])
        _flows(sd, p + ".post_flows", node["post_flows"])
    else:
        conv(sd, p + ".conv_1", node["conv1"])
        ln(sd, p + ".norm_1", node["norm1"])
        conv(sd, p + ".conv_2", node["conv2"])
        ln(sd, p + ".norm_2", node["norm2"])
        conv(sd, p + ".proj", node["proj"])
    if "cond" in node:
        conv(sd, p + ".cond", node["cond"])


def flow_block(sd, p, node, cfg):
    ftype = cfg.transformer_flow_type if cfg.use_transformer_flows else "plain"
    for i, layer in enumerate(node["flows"]):
        if ftype.startswith("mono_layer"):
            coupling(sd, f"{p}.flows.{3 * i}", layer["coupling"])
            encoder(sd, f"{p}.flows.{3 * i + 2}.pre_transformer", layer["mono"]["pre_transformer"])
            conv(sd, f"{p}.flows.{3 * i + 2}.post", layer["mono"]["post"])
            continue
        base = f"{p}.flows.{2 * i}"
        if ftype == "plain":
            coupling(sd, base, layer["coupling"])
            continue
        conv(sd, base + ".pre", layer["pre"])
        conv(sd, base + ".post", layer["post"])
        if ftype == "fft":
            fft_block(sd, base + ".enc", layer["enc"])
        else:  # pre_conv, pre_conv2
            encoder(sd, base + ".pre_transformer", layer["pre_transformer"])
            wn_module(sd, base + ".enc", layer["enc"])


def generator(sd, p, node, cfg):
    conv(sd, p + ".conv_pre", node["conv_pre"])
    for i, u in enumerate(node["ups"]):
        convT(sd, f"{p}.ups.{i}", u, wn=True)
    for i, blk in enumerate(node["resblocks"]):
        for name, convs in blk.items():
            for j, c in enumerate(convs):
                conv(sd, f"{p}.resblocks.{i}.{name}.{j}", c, wn=True)
    if cfg.decoder_type in ("mb_istft", "ms_istft"):
        conv(sd, p + ".subband_conv_post", node["conv_post"], wn=True)
    else:
        conv(sd, p + ".conv_post", node["conv_post"])
    if "multistream_conv_post" in node:
        conv(sd, p + ".multistream_conv_post", node["multistream_conv_post"], wn=True)
    if "cond" in node:
        conv(sd, p + ".cond", node["cond"])


def posterior(sd, p, node):
    conv(sd, p + ".pre", node["pre"])
    wn_module(sd, p + ".enc", node["enc"])
    conv(sd, p + ".proj", node["proj"])


def vits2_state_dict(tree, cfg) -> dict:
    """``models.SynthesizerTrn`` (training/vits2/models.py)."""
    sd = {"enc_p.emb.weight": tree["enc_p"]["emb"]}
    encoder(sd, "enc_p.encoder", tree["enc_p"]["encoder"])
    conv(sd, "enc_p.proj", tree["enc_p"]["proj"])
    generator(sd, "dec", tree["dec"], cfg)
    posterior(sd, "enc_q", tree["enc_q"])
    flow_block(sd, "flow", tree["flow"], cfg)
    duration_predictor(sd, "dp", tree["dp"])
    if "emb_g" in tree:
        sd["emb_g.weight"] = tree["emb_g"]
    return sd


def quickvc_state_dict(tree, cfg) -> dict:
    """vc/models.py ``SynthesizerTrn``."""
    sd = {}
    posterior(sd, "enc_p", tree["enc_p"])
    posterior(sd, "enc_q", tree["enc_q"])
    flow_block(sd, "flow", tree["flow"], cfg.as_vits2())
    generator(sd, "dec", tree["dec"], cfg.as_vits2())
    for i, layer in enumerate(tree["enc_spk"]["lstm"]):
        for k in ("ih", "hh"):
            sd[f"enc_spk.lstm.weight_{k}_l{i}"] = np.ascontiguousarray(layer[f"w_{k}"].T)
            sd[f"enc_spk.lstm.bias_{k}_l{i}"] = layer[f"b_{k}"]
    linear(sd, "enc_spk.linear", tree["enc_spk"]["linear"])
    return sd


def sovits_state_dict(tree, cfg) -> dict:
    """GPT-SoVITS stage 2 ``SynthesizerTrn`` (module/models.py:825-899)."""
    sd = {"quantizer.vq.layers.0._codebook.embed": tree["codebook"]}
    conv(sd, "ssl_proj", tree["ssl_proj"])
    e = tree["enc_p"]
    conv(sd, "enc_p.ssl_proj", e["ssl_proj"])
    encoder(sd, "enc_p.encoder_ssl", e["encoder_ssl"])
    sd["enc_p.text_embedding.weight"] = e["text_emb"]
    encoder(sd, "enc_p.encoder_text", e["encoder_text"])
    for k in ("c_pre", "text_pre", "c_post"):
        conv(sd, f"enc_p.mrte.{k}", e["mrte"][k])
    mha(sd, "enc_p.mrte.cross_attention", e["mrte"]["attn"])
    encoder(sd, "enc_p.encoder2", e["encoder2"])
    conv(sd, "enc_p.proj", e["proj"])
    posterior(sd, "enc_q", tree["enc_q"])
    v = cfg.as_vits2()
    flow_block(sd, "flow", tree["flow"], v)
    generator(sd, "dec", tree["dec"], v)
    r = tree["ref_enc"]
    for k, name in (("spec1", "spectral.0.fc"), ("spec2", "spectral.3.fc"), ("wq", "slf_attn.w_qs"),
                    ("wk", "slf_attn.w_ks"), ("wv", "slf_attn.w_vs"), ("fc_attn", "slf_attn.fc"),
                    ("fc", "fc.fc")):
        linear(sd, f"ref_enc.{name}", r[k])
    conv(sd, "ref_enc.temporal.0.conv1.conv", r["glu1"])
    conv(sd, "ref_enc.temporal.1.conv1.conv", r["glu2"])
    return sd


def bert_state_dict(tree) -> dict:
    """HF ``BertModel``."""
    sd = {"embeddings.word_embeddings.weight": tree["word_emb"],
          "embeddings.position_embeddings.weight": tree["pos_emb"],
          "embeddings.token_type_embeddings.weight": tree["type_emb"]}
    ln_wb(sd, "embeddings.LayerNorm", tree["emb_ln"])
    for i, layer in enumerate(tree["layers"]):
        b = f"encoder.layer.{i}"
        for k, name in (("q", "attention.self.query"), ("k", "attention.self.key"),
                        ("v", "attention.self.value"), ("attn_out", "attention.output.dense"),
                        ("ffn_in", "intermediate.dense"), ("ffn_out", "output.dense")):
            linear(sd, f"{b}.{name}", layer[k])
        ln_wb(sd, f"{b}.attention.output.LayerNorm", layer["attn_ln"])
        ln_wb(sd, f"{b}.output.LayerNorm", layer["ffn_ln"])
    return sd


def ar_state_dict(tree) -> dict:
    """GPT-SoVITS ``Text2SemanticDecoder`` (``model.`` stripped)."""
    sd = {"ar_text_embedding.word_embeddings.weight": tree["text_emb"],
          "ar_audio_embedding.word_embeddings.weight": tree["audio_emb"],
          "ar_text_position.alpha": np.reshape(tree["text_alpha"], (1,)),
          "ar_audio_position.alpha": np.reshape(tree["audio_alpha"], (1,)),
          "ar_predict_layer.weight": np.ascontiguousarray(tree["predict"]["w"].T)}
    linear(sd, "bert_proj", tree["bert_proj"])
    for i, layer in enumerate(tree["layers"]):
        b = f"h.layers.{i}"
        sd[f"{b}.self_attn.in_proj_weight"] = np.ascontiguousarray(layer["qkv"]["w"].T)
        sd[f"{b}.self_attn.in_proj_bias"] = layer["qkv"]["b"]
        linear(sd, f"{b}.self_attn.out_proj", layer["out"])
        linear(sd, f"{b}.linear1", layer["ff1"])
        linear(sd, f"{b}.linear2", layer["ff2"])
        ln_wb(sd, f"{b}.norm1", layer["ln1"])
        ln_wb(sd, f"{b}.norm2", layer["ln2"])
    return sd


def hubert_state_dict(tree, pos: str = "parametrizations") -> dict:
    """HF ``HubertModel``; ``pos`` spells the positional conv's weight (one
    of :data:`POS_SPELLINGS`)."""
    sd = {}
    for i, c in enumerate(tree["conv_layers"]):
        base = f"feature_extractor.conv_layers.{i}"
        conv(sd, base + ".conv", c)
        if "gn_gamma" in c:
            sd[base + ".layer_norm.weight"], sd[base + ".layer_norm.bias"] = c["gn_gamma"], c["gn_beta"]
    ln_wb(sd, "feature_projection.layer_norm", tree["fp_ln"])
    linear(sd, "feature_projection.projection", tree["fp"])
    w = np.asarray(tree["pos_conv"]["w"]).transpose(2, 1, 0)
    p = "encoder.pos_conv_embed.conv"
    if pos == "parametrizations":
        _weight(sd, p, w, True, (2,), (".parametrizations.weight.original0",
                                       ".parametrizations.weight.original1"))
    else:
        _weight(sd, p, w, pos != "folded", 2 if pos == "weight_norm" else 0)
    _bias(sd, p, tree["pos_conv"]["b"])
    ln_wb(sd, "encoder.layer_norm", tree["enc_ln"])
    for i, layer in enumerate(tree["layers"]):
        b = f"encoder.layers.{i}"
        for k, name in (("q", "attention.q_proj"), ("k", "attention.k_proj"),
                        ("v", "attention.v_proj"), ("attn_out", "attention.out_proj"),
                        ("ffn_in", "feed_forward.intermediate_dense"),
                        ("ffn_out", "feed_forward.output_dense")):
            linear(sd, f"{b}.{name}", layer[k])
        ln_wb(sd, f"{b}.layer_norm", layer["attn_ln"])
        ln_wb(sd, f"{b}.final_layer_norm", layer["ffn_ln"])
    return sd


def vocos_state_dict(tree) -> dict:
    """The official Vocos checkpoint (``backbone.*``, ``head.*``)."""
    sd = {}
    conv(sd, "backbone.embed", tree["embed"])
    ln_wb(sd, "backbone.norm", tree["norm"])
    for i, blk in enumerate(tree["blocks"]):
        b = f"backbone.convnext.{i}"
        conv(sd, b + ".dwconv", blk["dwconv"])
        ln_wb(sd, b + ".norm", blk["norm"])
        linear(sd, b + ".pwconv1", blk["pw1"])
        linear(sd, b + ".pwconv2", blk["pw2"])
        sd[b + ".gamma"] = blk["gamma"]
    ln_wb(sd, "backbone.final_layer_norm", tree["final_norm"])
    linear(sd, "head.out", tree["head"])
    return sd


def bigvgan_state_dict(tree) -> dict:
    """The official BigVGAN checkpoint (every conv weight-normed)."""
    sd = {}

    def snake(p, node):
        for k, a in node.items():
            sd[f"{p}.{k}"] = a

    conv(sd, "conv_pre", tree["conv_pre"], wn=True)
    for i, u in enumerate(tree["ups"]):
        convT(sd, f"ups.{i}.0", u, wn=True)
    for ri, blk in enumerate(tree["resblocks"]):
        for d in range(len(blk["convs1"])):
            conv(sd, f"resblocks.{ri}.convs1.{d}", blk["convs1"][d], wn=True)
            conv(sd, f"resblocks.{ri}.convs2.{d}", blk["convs2"][d], wn=True)
            snake(f"resblocks.{ri}.activations.{2 * d}.act", blk["acts1"][d])
            snake(f"resblocks.{ri}.activations.{2 * d + 1}.act", blk["acts2"][d])
    snake("activation_post.act", tree["act_post"])
    conv(sd, "conv_post", tree["conv_post"], wn=True)
    return sd


def randomize(tree, seed: int):
    """The tree with every array leaf drawn anew, N(0, 1) (zero-initialised
    projections and unit norms would hide a swapped or dropped leaf)."""
    rng = np.random.default_rng(seed)

    def go(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: go(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [go(v) for v in node]
        return rng.standard_normal(np.shape(node)).astype(np.float32)

    return go(tree)


# a letter -> phones rule for a synthetic CMUdict: vowels take stress 1 on
# their word's first vowel and 0 after it; "th", "sh", "ch" and "ng" are one phone
_VOWELS = {"a": "AE", "e": "EH", "i": "IH", "o": "AA", "u": "AH", "y": "IY"}
_CONSONANTS = {"b": "B", "c": "K", "d": "D", "f": "F", "g": "G", "h": "HH", "j": "JH", "k": "K",
               "l": "L", "m": "M", "n": "N", "p": "P", "q": "K", "r": "R", "s": "S", "t": "T",
               "v": "V", "w": "W", "x": "Z", "z": "Z"}
_DIGRAPHS = {"th": "TH", "sh": "SH", "ch": "CH", "ng": "NG"}


def lexicon_phones(word: str) -> tuple:
    out, i, stressed = [], 0, False
    while i < len(word):
        if word[i:i + 2] in _DIGRAPHS:
            out.append(_DIGRAPHS[word[i:i + 2]])
            i += 2
            continue
        c = word[i]
        if c in _VOWELS:
            out.append(_VOWELS[c] + ("0" if stressed else "1"))
            stressed = True
        else:
            out.append(_CONSONANTS[c])
        i += 1
    return tuple(out)


def synthetic_lexicon(n: int, seed: int) -> dict:
    """``n`` distinct words of 4-10 letters (consonant-vowel syllables, some
    closed) -> their phones by :func:`lexicon_phones`."""
    rng = np.random.default_rng(seed)
    cons, vows = sorted(_CONSONANTS), sorted(_VOWELS)
    out = {}
    while len(out) < n:
        word = ""
        for _ in range(int(rng.integers(2, 5))):
            word += cons[rng.integers(len(cons))] + vows[rng.integers(len(vows))]
            if rng.random() < 0.3:
                word += cons[rng.integers(len(cons))]
        word = word[:10]
        if len(word) >= 4:
            out.setdefault(word, lexicon_phones(word))
    return out


def write_cmudict(path, lexicon: dict) -> None:
    """``path``/cmudict.rep: 57 comment lines (the readers skip up to 57),
    then ``WORD  PH PH ...``."""
    with open(os.path.join(path, "cmudict.rep"), "w", encoding="latin-1") as f:
        f.write(";;; synthetic\n" * 57)
        for w, ph in sorted(lexicon.items()):
            f.write(f"{w.upper()}  {' '.join(ph)}\n")


def write_safetensors(path, sd: dict) -> None:
    """``sd`` ({name: float32 array}) as a ``.safetensors`` file: an 8-byte
    little-endian header length, the JSON header padded with spaces to 8
    bytes, the little-endian F32 buffers."""
    import json
    import struct

    header, blobs, offset = {"__metadata__": {"format": "pt"}}, [], 0
    for name, a in sd.items():
        raw = np.ascontiguousarray(a, dtype="<f4").tobytes()
        header[name] = {"dtype": "F32", "shape": list(np.shape(a)),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)) + text + b"".join(blobs))


def vits2_reference_config(cfg, sampling_rate: int = 22050, hop_length: int = 256) -> dict:
    """The reference training ``config.json`` (model, data and train blocks,
    training/vits2/configs/mb_istft_vits2_multi.json's keys) that
    ``VITS2Config.from_reference_json`` reads back as ``cfg``."""
    decoder_flag = {"mb_istft": "mb_istft_vits", "ms_istft": "ms_istft_vits",
                    "istft": "istft_vits"}.get(cfg.decoder_type)
    keys = ("n_vocab", "inter_channels", "hidden_channels", "filter_channels", "n_heads",
            "n_layers", "n_flows", "posterior_wn_layers", "sdp_n_flows", "kernel_size",
            "p_dropout", "resblock", "upsample_initial_channel", "gen_istft_n_fft",
            "gen_istft_hop_size", "subbands", "gin_channels", "use_sdp",
            "use_spk_conditioned_encoder", "use_transformer_flows", "transformer_flow_type",
            "istft_mode", "use_noise_scaled_mas", "mas_noise_scale_initial", "noise_scale_delta")
    model = {k: getattr(cfg, k) for k in keys}
    model.update({k: [list(v) if isinstance(v, tuple) else v for v in getattr(cfg, k)]
                  for k in ("resblock_kernel_sizes", "resblock_dilation_sizes", "upsample_rates",
                            "upsample_kernel_sizes")})
    if decoder_flag:
        model[decoder_flag] = True
    return {"model": model,
            "data": {"sampling_rate": sampling_rate, "filter_length": (cfg.spec_channels - 1) * 2,
                     "hop_length": hop_length, "n_speakers": cfg.n_speakers},
            "train": {"segment_size": cfg.segment_size * hop_length}}
