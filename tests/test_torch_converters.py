"""The port's checkpoint readers vs the JAX package's, on synthetic state dicts.

A random bundle-layout tree (the port's numpy ``utils/params.*_init`` at a
small width, every leaf redrawn N(0, 1)) is written in the reference's
naming by tests/torch_ref_layout.py, weight-norm pairs split. Then, for
each reader:

* the JAX reader returns the source tree from that dict and reads every
  key of it (which validates the helper);
* the port's reader reads the same keys and returns the JAX reader's tree.

"Equal" is exact at every leaf but the folded weight-norm ones, which are
g * v / ||v|| of the helper's split and so within 1e-6 relative of the
source weight (both readers fold with the same numpy arithmetic, so port
and JAX agree exactly there too). A read is recorded by the leaf itself
(its ``__array__``), so that reads through the readers' copies of the dict
count. HuBERT's positional conv takes every spelling; the one the JAX
package folds wrongly (``weight_g``/``weight_v`` with HF's weight norm over
dim 2) is checked against the source tree on the port's side and shown to
differ on JAX's.
"""

import dataclasses
import json
import struct

import numpy as np
import pytest
import torch

from vosk_tts_tpu.models import bigvgan as jbig
from vosk_tts_tpu.models import gpt_sovits as jgs
from vosk_tts_tpu.models import hubert as jhub
from vosk_tts_tpu.models import quickvc as jqvc
from vosk_tts_tpu.models import vits2 as jv
from vosk_tts_tpu.models import vocoder as jvoc
from vosk_tts_tpu.utils import torch_params as jtp
from vosk_tts_tpu_torch.models import bert as tbert
from vosk_tts_tpu_torch.models import bigvgan as tbig
from vosk_tts_tpu_torch.models import gpt_sovits as tgs
from vosk_tts_tpu_torch.models import hubert as thub
from vosk_tts_tpu_torch.models import quickvc as tqvc
from vosk_tts_tpu_torch.models import vits2 as tv
from vosk_tts_tpu_torch.models import vocoder as tvoc
from vosk_tts_tpu_torch.utils import params as P
from vosk_tts_tpu_torch.utils import torch_params as ttp

import torch_ref_layout as R

FOLD_RTOL = 1e-6

VITS2_BASE = dict(inter_channels=32, hidden_channels=32, filter_channels=64, n_layers=2,
                  n_flows=2, upsample_initial_channel=32, n_speakers=4, gin_channels=16,
                  spec_channels=13, posterior_wn_layers=2)  # the SDP keeps its 4 flows,
# which the readers take as fixed
# one configuration a flow type; together every decoder and both duration predictors
VITS2_FLOWS = {
    "plain": dict(use_transformer_flows=False, decoder_type="ms_istft"),
    "pre_conv": dict(transformer_flow_type="pre_conv", decoder_type="istft"),
    "pre_conv2": dict(transformer_flow_type="pre_conv2", decoder_type="mb_istft", use_sdp=False),
    "fft": dict(transformer_flow_type="fft", decoder_type="hifigan"),
    "mono_layer_inter_residual": dict(transformer_flow_type="mono_layer_inter_residual",
                                      decoder_type="ms_istft", use_sdp=False),
    "mono_layer_post_residual": dict(transformer_flow_type="mono_layer_post_residual",
                                     decoder_type="istft", resblock="2",
                                     resblock_dilation_sizes=((1, 3), (1, 3), (1, 3))),
}
HUBERT = dict(conv_dim=(32, 32, 32), conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
              hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
              num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


class _Leaf:
    """A state-dict value that records its key when read as an array."""

    def __init__(self, key, array, reads):
        self.key, self.array, self.reads = key, array, reads

    def __array__(self, dtype=None, copy=None):
        self.reads.add(self.key)
        return self.array if dtype is None else self.array.astype(dtype)


def _recording(sd):
    reads = set()
    return {k: _Leaf(k, np.asarray(v), reads) for k, v in sd.items()}, reads


def _leaves(tree, path=()):
    if tree is None:
        return {path: None}
    if isinstance(tree, dict):
        return {p: a for k, v in tree.items() for p, a in _leaves(v, path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: a for i, v in enumerate(tree) for p, a in _leaves(v, path + (i,)).items()}
    return {path: np.asarray(tree)}


def _same(got, want, n_folded=0):
    """Equal structure; every leaf exact but at most ``n_folded`` (the
    folded weights), which are within FOLD_RTOL of the largest magnitude."""
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys(), sorted(set(g) ^ set(w), key=str)[:8]
    inexact = []
    for p, b in w.items():
        a = g[p]
        if b is None or a is None:
            assert a is None and b is None, p
            continue
        assert a.shape == b.shape and a.dtype == np.float32, (p, a.shape, b.shape, a.dtype)
        if not np.array_equal(a, b):
            np.testing.assert_allclose(a, b, rtol=0, atol=FOLD_RTOL * float(np.abs(b).max()),
                                       err_msg=str(p))
            inexact.append(p)
    assert len(inexact) <= n_folded, inexact[:8]


def _n_folded(sd):
    return sum(k.endswith((".weight_v", ".original1")) for k in sd)


def _check(source, sd, read_jax, read_port):
    """JAX's reader gives ``source`` back reading every key; the port's reads
    the same keys and gives JAX's tree."""
    rec, jax_reads = _recording(sd)
    theirs = read_jax(rec)
    assert jax_reads == set(sd), sorted(set(sd) - jax_reads)[:8]
    _same(theirs, source, _n_folded(sd))
    rec, port_reads = _recording(sd)
    mine = read_port(rec)
    assert port_reads == jax_reads
    _same(mine, theirs)
    return mine


@pytest.mark.parametrize("flow", list(VITS2_FLOWS))
def test_vits2_from_state_dict(flow):
    kw = {**VITS2_BASE, **VITS2_FLOWS[flow]}
    tcfg, jcfg = tv.VITS2Config(**kw), jv.VITS2Config(**kw)
    source = R.randomize(P.synthesizer_init(tcfg, seed=0), seed=1)
    sd = R.vits2_state_dict(source, tcfg)
    _check(source, sd, lambda d: jtp.vits2_from_state_dict(d, jcfg),
           lambda d: ttp.vits2_from_state_dict(d, tcfg))


def test_quickvc_from_state_dict():
    kw = dict(hidden_channels=32, inter_channels=32, ssl_dim=24, spec_channels=13,
              gin_channels=16, upsample_initial_channel=32, n_mel_channels=12)
    tcfg, jcfg = tqvc.QuickVCConfig(**kw), jqvc.QuickVCConfig(**kw)
    source = R.randomize(P.quickvc_init(tcfg, seed=0), seed=1)
    _check(source, R.quickvc_state_dict(source, tcfg),
           lambda d: jtp.quickvc_from_state_dict(d, jcfg),
           lambda d: ttp.quickvc_from_state_dict(d, tcfg))


def test_sovits_from_state_dict():
    kw = dict(hidden_channels=32, inter_channels=32, filter_channels=64, n_layers=2,
              spec_channels=13, gin_channels=16, ssl_dim=24, upsample_initial_channel=32,
              n_codes=17, n_symbols=20, mrte_hidden=32, style_hidden=16)
    tcfg, jcfg = tgs.SoVITSConfig(**kw), jgs.SoVITSConfig(**kw)
    source = R.randomize(P.sovits_init(tcfg, seed=0), seed=1)
    _check(source, R.sovits_state_dict(source, tcfg),
           lambda d: jtp.sovits_from_state_dict(d, jcfg),
           lambda d: ttp.sovits_from_state_dict(d, tcfg))


def test_bert_from_state_dict():
    cfg = tbert.BertConfig(vocab_size=40, hidden_size=32, num_hidden_layers=2,
                           num_attention_heads=4, intermediate_size=64,
                           max_position_embeddings=24)
    source = R.randomize(P.bert_init(cfg, seed=0), seed=1)
    _check(source, R.bert_state_dict(source), lambda d: jtp.bert_from_state_dict(d, 2),
           lambda d: ttp.bert_from_state_dict(d, 2))


def test_ar_from_state_dict():
    kw = dict(embedding_dim=32, hidden_dim=32, num_head=4, num_layers=2, vocab_size=33,
              phoneme_vocab_size=21, bert_dim=24)
    tcfg, jcfg = tgs.ARConfig(**kw), jgs.ARConfig(**kw)
    source = R.randomize(P.ar_init(tcfg, seed=0), seed=1)
    _check(source, R.ar_state_dict(source), lambda d: jgs.ar_from_state_dict(d, jcfg),
           lambda d: tgs.ar_from_state_dict(d, tcfg))


@pytest.mark.parametrize("pos", ["parametrizations", "weight_norm_dim0", "folded"])
def test_hubert_from_state_dict(pos):
    tcfg, jcfg = thub.HubertConfig(**HUBERT), jhub.HubertConfig(**HUBERT)
    source = R.randomize(P.hubert_init(tcfg, seed=0), seed=1)
    _check(source, R.hubert_state_dict(source, pos),
           lambda d: jhub.hubert_from_state_dict(d, jcfg),
           lambda d: thub.hubert_from_state_dict(d, tcfg))


def test_hubert_weight_norm_over_dim_2():
    """HF's positional conv keeps weight norm over dim 2 (g of shape
    (1, 1, K)). Spelled ``weight_g``/``weight_v``, the port folds it over
    the output and input channels and gets the source weight back; the JAX
    package folds every such pair over dim 0 and does not."""
    tcfg, jcfg = thub.HubertConfig(**HUBERT), jhub.HubertConfig(**HUBERT)
    source = R.randomize(P.hubert_init(tcfg, seed=0), seed=1)
    sd = R.hubert_state_dict(source, "weight_norm")
    assert sd["encoder.pos_conv_embed.conv.weight_g"].shape == (1, 1, 16)
    mine = thub.hubert_from_state_dict(dict(sd), tcfg)
    _same(mine, source, 1)
    theirs = jhub.hubert_from_state_dict(dict(sd), jcfg)
    err = np.abs(theirs["pos_conv"]["w"] - source["pos_conv"]["w"]).max()
    assert err > 0.1 * np.abs(source["pos_conv"]["w"]).max(), err
    theirs["pos_conv"] = mine["pos_conv"]
    _same(theirs, mine)


def test_hubert_config_from_hf():
    d = {**{k: list(v) if isinstance(v, tuple) else v for k, v in HUBERT.items()},
         "layer_norm_eps": 1e-5, "feat_extract_norm": "group", "do_stable_layer_norm": False,
         "model_type": "hubert"}
    mine, theirs = thub.HubertConfig.from_hf(d), jhub.HubertConfig.from_hf(d)
    want = {f.name: getattr(theirs, f.name) for f in dataclasses.fields(mine)}
    assert dataclasses.asdict(mine) == want
    with pytest.raises(ValueError, match="base HuBERT"):
        thub.HubertConfig.from_hf({**d, "do_stable_layer_norm": True})
    with pytest.raises(ValueError, match="base HuBERT"):
        thub.HubertConfig.from_hf({**d, "feat_extract_norm": "layer"})


def test_vocos_from_state_dict():
    kw = dict(input_channels=12, dim=32, intermediate_dim=48, num_layers=2, n_fft=64,
              hop_length=16)
    tcfg, jcfg = tvoc.VocosConfig(**kw), jvoc.VocosConfig(**kw)
    source = R.randomize(P.vocos_init(tcfg, seed=0), seed=1)
    _check(source, R.vocos_state_dict(source), lambda d: jvoc.vocos_from_state_dict(d, jcfg),
           lambda d: tvoc.vocos_from_state_dict(d, tcfg))


@pytest.mark.parametrize("activation", ["snakebeta", "snake"])
def test_bigvgan_from_state_dict(activation):
    kw = dict(num_mels=12, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
              upsample_initial_channel=32, resblock_kernel_sizes=(3, 5),
              resblock_dilation_sizes=((1, 3), (1, 3, 5)), activation=activation)
    tcfg, jcfg = tbig.BigVGANConfig(**kw), jbig.BigVGANConfig(**kw)
    source = R.randomize(P.bigvgan_init(tcfg, seed=0), seed=1)
    _check(source, R.bigvgan_state_dict(source), lambda d: jbig.bigvgan_from_state_dict(d, jcfg),
           lambda d: tbig.bigvgan_from_state_dict(d, tcfg))


def _safetensors_bytes(tensors: dict) -> bytes:
    """A .safetensors file written by hand: {name: (dtype, shape, raw bytes)}."""
    header, blobs, offset = {"__metadata__": {"format": "pt"}}, [], 0
    for name, (dtype, shape, raw) in tensors.items():
        header[name] = {"dtype": dtype, "shape": list(shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)  # the format pads the header with spaces
    return struct.pack("<Q", len(text)) + text + b"".join(blobs)


def test_safetensors_reader(tmp_path):
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 4)).astype(np.float32)
    f16 = rng.standard_normal((5,)).astype(np.float16)
    bf16 = np.array([1.0, -2.5, 3.140625, 1e-3], np.float32)
    bf16_bits = (bf16.view(np.uint32) >> 16).astype("<u2")
    i64 = np.arange(6, dtype=np.int64).reshape(2, 3)
    path = tmp_path / "model.safetensors"
    path.write_bytes(_safetensors_bytes({
        "a.weight": ("F32", f32.shape, f32.astype("<f4").tobytes()),
        "b.half": ("F16", f16.shape, f16.astype("<f2").tobytes()),
        "c.bf16": ("BF16", bf16.shape, bf16_bits.tobytes()),
        "d.ids": ("I64", i64.shape, i64.astype("<i8").tobytes()),
    }))
    got = ttp.read_state_dict(path)
    assert sorted(got) == ["a.weight", "b.half", "c.bf16", "d.ids"]
    np.testing.assert_array_equal(got["a.weight"], f32)
    np.testing.assert_array_equal(got["b.half"], f16)
    # bf16 keeps the top 16 bits of the f32: exact for these values, truncated for 1e-3
    np.testing.assert_array_equal(got["c.bf16"], (bf16.view(np.uint32) & 0xFFFF0000).view(np.float32))
    assert got["c.bf16"].dtype == np.float32
    np.testing.assert_array_equal(got["d.ids"], i64)

    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(_safetensors_bytes({"x": ("F8_E4M3", (2,), b"\0\0")}))
    with pytest.raises(ValueError, match="F8_E4M3"):
        ttp.read_state_dict(bad)
    short = tmp_path / "short.safetensors"
    short.write_bytes(_safetensors_bytes({"x": ("F32", (4,), b"\0" * 12)}))
    with pytest.raises(ValueError, match="do not fit"):
        ttp.read_state_dict(short)


def test_read_state_dict_of_a_reference_checkpoint(tmp_path):
    """A G_*.pth as the reference writes it ({"model", "iteration",
    "optimizer", "learning_rate"}) reads under weights_only=True; bf16
    tensors widen to f32."""
    sd = {"a.weight": torch.randn(3, 2), "b.bias": torch.randn(4).to(torch.bfloat16),
          "c.ids": torch.arange(3)}
    opt = torch.optim.AdamW([torch.nn.Parameter(torch.zeros(2))]).state_dict()
    torch.save({"model": sd, "iteration": 7, "optimizer": opt, "learning_rate": 2e-4},
               tmp_path / "G_7.pth")
    torch.save(sd, tmp_path / "pytorch_model.bin")
    for name in ("G_7.pth", "pytorch_model.bin"):
        got = ttp.read_state_dict(tmp_path / name)
        assert sorted(got) == sorted(sd)
        np.testing.assert_array_equal(got["a.weight"], sd["a.weight"].numpy())
        np.testing.assert_array_equal(got["b.bias"], sd["b.bias"].float().numpy())
        assert got["b.bias"].dtype == np.float32 and got["c.ids"].dtype == np.int64
