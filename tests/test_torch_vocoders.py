"""The multistream vocoders of the PyTorch port vs the JAX package, on the CPU.

Vocos (ConvNeXt blocks, the iSTFT head), BigVGAN (snake and snakebeta,
``snake_logscale`` on and off, tanh or clip at the end) and the HiFiGAN
denoiser, at small widths, on seeded numpy inputs, 1e-4 x peak (f32
through several layers; the denoiser 1e-5 x peak). Trees come from the
port's numpy ``vocos_init``/``bigvgan_init`` (held to ``jax.eval_shape``
of the JAX inits) with the zero-initialised snake parameters spread.
End to end, a tiny multistream_v3 bundle written by the JAX package with
each vocoder goes through both packages' ``Model``/``Synth.synth_audio``
at noise level 0: equal length, int16 samples within 2.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import torch

from vosk_tts_tpu import api as japi
from vosk_tts_tpu.models import bigvgan as jbv
from vosk_tts_tpu.models import vocoder as jvoc
from vosk_tts_tpu.models.vits2 import VITS2Config as JVITS2Config
from vosk_tts_tpu.text import multistream_symbol_map
from vosk_tts_tpu.utils.checkpoint import save_params
from vosk_tts_tpu_torch import api as tapi
from vosk_tts_tpu_torch.models import bigvgan as tbv
from vosk_tts_tpu_torch.models import stabletts as tst
from vosk_tts_tpu_torch.models import vits2 as tv
from vosk_tts_tpu_torch.models import vocoder as tvoc
from vosk_tts_tpu_torch.utils.params import (LINEARS, bigvgan_init, from_port_layout,
                                             hifigan_init, matcha_init, perturb_matcha_zero_init,
                                             to_port_layout, to_torch, vocos_init)

VOCOS = dict(input_channels=16, dim=32, intermediate_dim=48, num_layers=2)
BIGVGAN = dict(num_mels=16, upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
               upsample_initial_channel=32, resblock_kernel_sizes=(3, 5),
               resblock_dilation_sizes=((1, 3), (1, 3)))
MS_CFG = dict(n_vocab=207, n_feats=16, n_spks=5, spk_emb_dim=8, hidden_channels=32,
              filter_channels=64, n_heads=2, n_layers=2, phone_emb_dim=12, punc_emb_dim=4,
              bert_dim=24, bert_proj_dim=4, dec_hidden=32, dec_filter=64, dec_layers=2,
              dec_heads=2)
TEXT = "Привет, мир и всем хорошего дня!"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch threads here; the JAX executables this module compiled are
    dropped after it (a test worker runs other modules next)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def _t(a):
    return torch.tensor(np.asarray(a))


def _peak_close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rel * float(np.abs(want).max()))


def _vocos_tree(cfg, seed):
    """The numpy init with the head scaled by 0.1, so that most samples
    stay inside the final clip to [-1, 1]."""
    tree = vocos_init(cfg, seed)
    tree["head"]["w"] = tree["head"]["w"] * np.float32(0.1)
    return tree


def _bigvgan_tree(cfg, seed):
    """The numpy init with the snake parameters spread (as initialised
    every channel has alpha = beta = 1)."""
    tree = bigvgan_init(cfg, seed)
    rng = np.random.default_rng(seed + 1)

    def spread(node):
        if isinstance(node, dict):
            for k, v in node.items():
                if k in ("alpha", "beta"):
                    node[k] = (rng.normal(0.0, 0.3, v.shape) if cfg.snake_logscale
                               else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
                else:
                    spread(v)
        elif isinstance(node, list):
            for v in node:
                spread(v)

    spread(tree)
    return tree


def test_vocos():
    jcfg, tcfg = jvoc.VocosConfig(**VOCOS), tvoc.VocosConfig(**VOCOS)
    tree = _vocos_tree(tcfg, 0)
    mel = np.random.default_rng(1).standard_normal((2, 24, 16)).astype(np.float32)
    want = jax.jit(lambda p, m: jvoc.vocos_apply(p, jcfg, m))(tree, mel)
    got = tvoc.vocos_apply(to_torch(to_port_layout(tree), "cpu"), tcfg, _t(mel))
    assert got.shape == np.asarray(want).shape == (2, 23 * 256)
    assert np.mean(np.abs(np.asarray(want)) < 0.999) > 0.5  # mostly not clipped
    _peak_close(got, want, 1e-4)


@pytest.mark.parametrize("activation,logscale,tanh", [
    ("snake", True, True), ("snake", False, False), ("snakebeta", True, False),
    ("snakebeta", False, True)])
def test_bigvgan(activation, logscale, tanh):
    kw = dict(BIGVGAN, activation=activation, snake_logscale=logscale, use_tanh_at_final=tanh,
              use_bias_at_final=tanh)
    jcfg, tcfg = jbv.BigVGANConfig(**kw), tbv.BigVGANConfig(**kw)
    tree = _bigvgan_tree(tcfg, 2)
    mel = np.random.default_rng(3).standard_normal((2, 10, 16)).astype(np.float32)
    want = jax.jit(lambda p, m: jbv.bigvgan_apply(p, jcfg, m))(tree, mel)
    got = tbv.bigvgan_apply(to_torch(to_port_layout(tree), "cpu"), tcfg, _t(mel))
    assert got.shape == np.asarray(want).shape == (2, 10 * 256)
    assert float(np.abs(np.asarray(want)).max()) > 1e-3
    _peak_close(got, want, 1e-4)


def test_resamplers():
    """The alias-free 2x resamplers alone (the port's depthwise form against
    the JAX batch-folded form), 1e-6 x peak."""
    x = np.random.default_rng(4).standard_normal((2, 17, 5)).astype(np.float32)
    _peak_close(tbv._upsample2(_t(x)), jbv._upsample2(x), 1e-6)
    _peak_close(tbv._downsample2(_t(x)), jbv._downsample2(x), 1e-6)
    np.testing.assert_array_equal(tbv._kaiser_sinc_filter(0.25, 0.3, 12),
                                  jbv._kaiser_sinc_filter(0.25, 0.3, 12))


def test_denoiser():
    """denoiser_bias of a small HiFiGAN (80 mels, as the JAX function
    hard-codes) and denoise of a waveform with that bias, 1e-5 x peak."""
    cfg = dict(inter_channels=80, upsample_initial_channel=32, upsample_rates=(8, 8, 2, 2),
               upsample_kernel_sizes=(16, 16, 4, 4), decoder_type="hifigan", gin_channels=0,
               n_speakers=0)
    jcfg, tcfg = JVITS2Config(**cfg), tv.VITS2Config(**cfg)
    tree = hifigan_init(tcfg, 5)
    tp = to_torch(to_port_layout(tree), "cpu")
    want_bias = jax.jit(lambda p: jvoc.denoiser_bias(p, jcfg))(tree)
    got_bias = tvoc.denoiser_bias(tp, tcfg)
    assert got_bias.shape == np.asarray(want_bias).shape == (1, 1, 513)
    _peak_close(got_bias, want_bias, 1e-5)
    wav = (np.random.default_rng(6).standard_normal((1, 8192)) * 0.1).astype(np.float32)
    bias = np.asarray(want_bias) * 1e3  # strong enough to floor some bins
    want = jax.jit(jvoc.denoise)(wav, bias)
    got = tvoc.denoise(_t(wav), _t(bias))
    assert got.shape == np.asarray(want).shape
    _peak_close(got, want, 1e-5)


def test_inits_and_layouts_match_jax():
    """The numpy inits have the JAX inits' structure and shapes at the
    test's widths and with the published configurations' structure (every
    layer and stage of VocosConfig() and BigVGANConfig() at narrow widths,
    which keeps the trees small) (``jax.eval_shape``: no JAX init runs);
    ``from_port_layout`` inverts ``to_port_layout`` on each tree."""
    key = jax.random.PRNGKey(0)
    narrow_vocos, narrow_bigvgan = dict(dim=32, intermediate_dim=48), dict(upsample_initial_channel=64)
    cases = [(vocos_init, jvoc.vocos_init, tvoc.VocosConfig(**VOCOS), jvoc.VocosConfig(**VOCOS)),
             (vocos_init, jvoc.vocos_init, tvoc.VocosConfig(**narrow_vocos),
              jvoc.VocosConfig(**narrow_vocos)),
             (bigvgan_init, jbv.bigvgan_init, tbv.BigVGANConfig(**narrow_bigvgan),
              jbv.BigVGANConfig(**narrow_bigvgan))]
    for kw in (dict(activation="snake"), dict(snake_logscale=False, use_bias_at_final=True)):
        cases.append((bigvgan_init, jbv.bigvgan_init, tbv.BigVGANConfig(**BIGVGAN, **kw),
                      jbv.BigVGANConfig(**BIGVGAN, **kw)))
    for mine_init, their_init, tcfg, jcfg in cases:
        mine = mine_init(tcfg, 0)
        theirs = jax.eval_shape(lambda k: their_init(k, jcfg), key)
        assert jax.tree.structure(mine) == jax.tree.structure(theirs), tcfg
        assert ([a.shape for a in jax.tree.leaves(mine)]
                == [a.shape for a in jax.tree.leaves(theirs)]), tcfg
        back = from_port_layout(to_port_layout(mine), LINEARS)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(mine)):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def matcha():
    cfg = tst.StableTTSConfig(**MS_CFG)
    return cfg, perturb_matcha_zero_init(matcha_init(cfg, seed=0), seed=1)


@pytest.mark.parametrize("vocoder", ["vocos", "bigvgan"])
def test_multistream_bundle_end_to_end(matcha, tmp_path, vocoder):
    """A multistream_v3 bundle (no BERT front) with the vocoder, written by
    the JAX package's save_params, through both packages' Model/Synth at
    noise level 0."""
    cfg, tree = matcha
    if vocoder == "vocos":
        vcfg, voc_tree = tvoc.VocosConfig(**VOCOS), _vocos_tree(tvoc.VocosConfig(**VOCOS), 7)
    else:
        vcfg = tbv.BigVGANConfig(**BIGVGAN)
        voc_tree = _bigvgan_tree(vcfg, 7)
    save_params(tmp_path / "params.npz", {"matcha": tree, "vocoder": voc_tree})
    with open(tmp_path / "config.json", "w", encoding="utf-8") as f:
        json.dump({"model_type": "multistream_v3", "sample_rate": 22050, "hop_length": 256,
                   "vocoder": vocoder, "vocoder_config": dataclasses.asdict(vcfg),
                   "phoneme_id_map": multistream_symbol_map(), "inference": {"n_timesteps": 2},
                   "model": dataclasses.asdict(cfg)}, f, ensure_ascii=False)
    (tmp_path / "dictionary").write_text("привет 1.0 p rj i0 vj e1 t\n", encoding="utf-8")
    kw = dict(speaker_id=1, noise_level=0.0)
    want = japi.Synth(japi.Model(model_path=tmp_path)).synth_audio(TEXT, **kw)
    model = tapi.Model(tmp_path, device="cpu")
    assert model.vocoder_type == vocoder and model.vocoder_config == vcfg
    got = tapi.Synth(model).synth_audio(TEXT, **kw)
    assert got.dtype == np.int16 and len(got) == len(want) > 0 and np.any(want != 0)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 2
