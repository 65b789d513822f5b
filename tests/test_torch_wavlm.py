"""The WavLM/SLM parts of the PyTorch port vs the JAX package, on the CPU.

* ``resample`` (22050 -> 16000, 16000 -> 22050, 32000 -> 16000 at odd
  lengths) within 1e-5 x peak of the JAX package's, and an in-band sine
  kept (tests/test_wavlm.py::test_resample_sine);
* ``_relative_buckets`` equal;
* ``wavlm_from_state_dict`` of one synthetic Hugging Face-named numpy
  state dict equal to the JAX package's tree, with the positional conv's
  weight folded and as ``parametrizations`` (the ``weight_g``/``weight_v``
  form folds over HF's dim 2 here, held to the ``parametrizations`` tree);
* the port's numpy ``wavlm_init`` has that tree's structure and shapes;
* ``wavlm_apply`` on a narrow configuration (even positional kernel, 2
  layers) against the JAX package's, each hidden state within 1e-5 x its
  max; ``stacked_hidden_states`` and ``wavlm_disc_apply`` (1e-5 x peak)
  against the JAX package's, and the numpy ``wavlm_disc_init`` has the JAX
  init's structure and shapes.

The JAX references run under ``jax.jit``; JAX's caches are cleared after
the module.
"""

import numpy as np
import pytest

import jax
import torch

from vosk_tts_tpu.models import discriminators as jd
from vosk_tts_tpu.models import wavlm as jw
from vosk_tts_tpu.ops.resample import resample as jresample
from vosk_tts_tpu_torch.models import discriminators as td
from vosk_tts_tpu_torch.models import wavlm as tw
from vosk_tts_tpu_torch.ops import resample as tr
from vosk_tts_tpu_torch.utils import params as P

# narrow, with an even positional kernel and a first conv with its group norm
CFG = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
           conv_dim=(16, 16, 16), conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, num_buckets=32,
           max_bucket_distance=50)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def _t(a):
    return torch.tensor(np.asarray(a))


def _peak_close(got, want, rel, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()),
                               err_msg=what)


def _same_tree(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _state_dict(cfg, seed=0, pos="folded"):
    """A Hugging Face ``WavLMModel``-named state dict of numpy arrays (no
    ``transformers`` here); ``pos`` is the positional conv's form: "folded",
    "parametrizations" or "weight_norm" (the last two with the same g, v)."""
    rng = np.random.default_rng(seed)
    r = lambda *s, std=0.1: (rng.standard_normal(s) * std).astype(np.float32)
    h, heads, inter = cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size
    sd, in_dim = {}, 1
    for i, (dim, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        sd[f"feature_extractor.conv_layers.{i}.conv.weight"] = r(dim, in_dim, k, std=0.3)
        in_dim = dim
    sd["feature_extractor.conv_layers.0.layer_norm.weight"] = 1 + r(cfg.conv_dim[0])
    sd["feature_extractor.conv_layers.0.layer_norm.bias"] = r(cfg.conv_dim[0])
    c = cfg.conv_dim[-1]
    sd["feature_projection.layer_norm.weight"] = 1 + r(c)
    sd["feature_projection.layer_norm.bias"] = r(c)
    sd["feature_projection.projection.weight"] = r(h, c, std=0.2)
    sd["feature_projection.projection.bias"] = r(h)
    k, groups = cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups
    g, v = 1 + r(1, 1, k), r(h, h // groups, k)
    if pos == "folded":
        sd["encoder.pos_conv_embed.conv.weight"] = g * v / np.sqrt((v**2).sum(axis=(0, 1),
                                                                            keepdims=True))
    elif pos == "parametrizations":
        sd["encoder.pos_conv_embed.conv.parametrizations.weight.original0"] = g
        sd["encoder.pos_conv_embed.conv.parametrizations.weight.original1"] = v
    else:
        sd["encoder.pos_conv_embed.conv.weight_g"] = g
        sd["encoder.pos_conv_embed.conv.weight_v"] = v
    sd["encoder.pos_conv_embed.conv.bias"] = r(h)
    sd["encoder.layer_norm.weight"] = 1 + r(h)
    sd["encoder.layer_norm.bias"] = r(h)
    sd["encoder.layers.0.attention.rel_attn_embed.weight"] = r(cfg.num_buckets, heads, std=1.0)
    for i in range(cfg.num_hidden_layers):
        b = f"encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{b}.attention.{n}.weight"] = r(h, h, std=0.2)
            sd[f"{b}.attention.{n}.bias"] = r(h)
        sd[f"{b}.attention.gru_rel_pos_linear.weight"] = r(8, h // heads, std=0.5)
        sd[f"{b}.attention.gru_rel_pos_linear.bias"] = r(8)
        sd[f"{b}.attention.gru_rel_pos_const"] = 1 + r(1, heads, 1, 1)
        for n in ("layer_norm", "final_layer_norm"):
            sd[f"{b}.{n}.weight"] = 1 + r(h)
            sd[f"{b}.{n}.bias"] = r(h)
        sd[f"{b}.feed_forward.intermediate_dense.weight"] = r(inter, h, std=0.2)
        sd[f"{b}.feed_forward.intermediate_dense.bias"] = r(inter)
        sd[f"{b}.feed_forward.output_dense.weight"] = r(h, inter, std=0.2)
        sd[f"{b}.feed_forward.output_dense.bias"] = r(h)
    return sd


# ---------------------------------------------------------------------------
# resample (1e-5 x peak)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("orig,new,t", [(22050, 16000, 8191), (16000, 22050, 5945),
                                        (32000, 16000, 4001)])
def test_resample_matches_jax(orig, new, t):
    x = (np.random.default_rng(t).standard_normal((2, t)) * 0.3).astype(np.float32)
    want = jax.jit(lambda a: jresample(a, orig, new))(x)
    got = tr.resample(_t(x), orig, new)
    assert got.shape == (2, -(-t * new // orig))
    _peak_close(got, want, 1e-5, f"{orig} -> {new}")


def test_resample_sine():
    """22.05k -> 16k keeps an in-band 440 Hz sine within 1e-2 (the JAX
    package's test_resample_sine)."""
    t = np.arange(22050, dtype=np.float64) / 22050
    x = np.sin(2 * np.pi * 440 * t).astype(np.float32)[None]
    y = tr.resample(_t(x), 22050, 16000).numpy()
    assert y.shape == (1, 16000)
    ref = np.sin(2 * np.pi * 440 * np.arange(16000, dtype=np.float64) / 16000)
    assert np.abs(y[0, 100:-100] - ref[100:-100]).max() < 1e-2


def test_resample_gradient_reaches_the_input():
    x = torch.randn(2, 2205, requires_grad=True)
    tr.resample(x, 22050, 16000).square().sum().backward()
    assert x.grad is not None and float(x.grad.abs().max()) > 0


# ---------------------------------------------------------------------------
# buckets, the state-dict reader, the init
# ---------------------------------------------------------------------------


def test_relative_buckets_equal():
    rel = np.arange(400)[None, :] - np.arange(400)[:, None]
    for nb, md in ((320, 800), (32, 50)):
        np.testing.assert_array_equal(tw._relative_buckets(rel, nb, md),
                                      jw._relative_buckets(rel, nb, md))


@pytest.mark.parametrize("pos", ["folded", "parametrizations"])
def test_from_state_dict_equals_jax(pos):
    cfg_t, cfg_j = tw.WavLMConfig(**CFG), jw.WavLMConfig(**CFG)
    sd = _state_dict(cfg_t, pos=pos)
    _same_tree(tw.wavlm_from_state_dict(dict(sd), cfg_t), jw.wavlm_from_state_dict(dict(sd), cfg_j))


def test_weight_norm_pos_conv_folds_over_dim_2():
    """The legacy ``weight_g``/``weight_v`` positional conv (HF's
    weight_norm over dim 2) gives the ``parametrizations`` form's weight."""
    cfg = tw.WavLMConfig(**CFG)
    got = tw.wavlm_from_state_dict(_state_dict(cfg, pos="weight_norm"), cfg)
    want = tw.wavlm_from_state_dict(_state_dict(cfg, pos="parametrizations"), cfg)
    np.testing.assert_allclose(got["pos_conv"]["w"], want["pos_conv"]["w"], rtol=1e-6, atol=0)


def test_wavlm_init_has_the_readers_structure():
    """``wavlm_init`` against the JAX reader's tree of a state dict of the
    same configuration: structure and shapes (``gn_gamma``/``gn_beta`` on
    the first conv only, ``gru_const`` (1, H, 1, 1), ``rel_attn_embed``
    (buckets, H))."""
    cfg = tw.WavLMConfig(**CFG)
    mine = P.wavlm_init(cfg, seed=1)
    theirs = jw.wavlm_from_state_dict(_state_dict(cfg), jw.WavLMConfig(**CFG))
    assert jax.tree.structure(mine) == jax.tree.structure(theirs)
    assert [a.shape for a in jax.tree.leaves(mine)] == [a.shape for a in jax.tree.leaves(theirs)]
    assert "gn_gamma" in mine["conv_layers"][0] and "gn_gamma" not in mine["conv_layers"][1]


def test_wavlm_init_base_plus():
    """At ``WavLMConfig()`` (base-plus, 12 x 768): ~94 M parameters, the
    gate and bias tables per head."""
    tree = P.wavlm_init(tw.WavLMConfig(), seed=0)
    assert len(tree["layers"]) == 12 and len(tree["conv_layers"]) == 7
    assert tree["layers"][0]["gru_const"].shape == (1, 12, 1, 1)
    assert tree["layers"][0]["gru_lin"]["w"].shape == (64, 8)
    assert tree["rel_attn_embed"].shape == (320, 12)
    assert tree["pos_conv"]["w"].shape == (128, 48, 768)
    assert 93e6 < sum(a.size for a in jax.tree.leaves(tree)) < 96e6


# ---------------------------------------------------------------------------
# the encoder and the discriminator (1e-5 x peak)
# ---------------------------------------------------------------------------


def test_wavlm_apply_matches_jax():
    cfg_t, cfg_j = tw.WavLMConfig(**CFG), jw.WavLMConfig(**CFG)
    tree = jw.wavlm_from_state_dict(_state_dict(cfg_t, seed=2), cfg_j)
    wav = (np.random.default_rng(3).standard_normal((2, 3201)) * 0.3).astype(np.float32)
    want = jax.jit(lambda p, w: jw.wavlm_apply(p, cfg_j, w))(tree, wav)
    model = tw.WavLM(cfg_t, P.to_port_layout(tree))
    got = model(_t(wav))
    assert len(got) == len(want) == CFG["num_hidden_layers"] + 1
    assert got[0].shape == (2, 159, 32)
    for i, (g, w) in enumerate(zip(got, want)):
        _peak_close(g, w, 1e-5, f"state {i}")
    assert not any(b.requires_grad for b in model.buffers())

    stacked_t = tw.stacked_hidden_states(got)
    stacked_j = jw.stacked_hidden_states(want)
    _peak_close(stacked_t, stacked_j, 1e-5, "stacked")
    np.testing.assert_array_equal(stacked_t[..., 32:64].detach().numpy(),
                                  got[1].detach().numpy())

    disc = jax.device_get(jax.jit(lambda k: jd.wavlm_disc_init(k, 32, 3, 8))(
        jax.random.PRNGKey(4)))
    mine = P.wavlm_disc_init(4, 32, 3, 8)
    assert jax.tree.structure(mine) == jax.tree.structure(disc)
    assert [a.shape for a in jax.tree.leaves(mine)] == [a.shape for a in jax.tree.leaves(disc)]
    want_d = jax.jit(jd.wavlm_disc_apply)(disc, stacked_j)
    got_d = td.wavlm_disc_apply(P.to_torch(P.to_port_layout(disc), "cpu"), stacked_t)
    assert got_d.shape == (2, 159)
    _peak_close(got_d, want_d, 1e-5, "wavlm discriminator")


def test_wavlm_gradient_flows_to_the_waveform():
    """The frozen encoder's buffers take no gradient, the input does."""
    cfg = tw.WavLMConfig(**CFG)
    model = tw.WavLM(cfg, P.to_port_layout(P.wavlm_init(cfg, seed=5)))
    wav = torch.randn(1, 1600, requires_grad=True)
    sum(h.abs().mean() for h in model(wav)).backward()
    assert wav.grad is not None and float(wav.grad.abs().max()) > 0
    assert all(b.grad is None for b in model.buffers())
