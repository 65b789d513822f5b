"""The port's Whisper encoder vs the JAX package, on the CPU.

A small configuration (d_model 64, 2 layers, 4 heads, FFN 128, 80 mels,
1500 positions) from the port's numpy ``whisper_init``, whose structure and
shapes are held to the JAX ``whisper_encoder_init`` (``jax.eval_shape``);
the JAX references run under ``jax.jit``. Tolerances (f32 on both sides):
the log-mel 1e-5 absolute (its values lie in about [-1.5, 1.5]);
``whisper_encoder_apply`` and ``get_content`` 1e-4 x peak, equal shapes;
``get_content`` raises ValueError at 30 s as the JAX one does;
``whisper_from_state_dict`` of a synthetic Hugging Face-named state dict
gives the JAX reader's tree, leaf for leaf, and the same tree after the
port's layout.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vosk_tts_tpu.models import whisper as jw
from vosk_tts_tpu_torch.models import whisper as tw
from vosk_tts_tpu_torch.models.tree import TreeModule
from vosk_tts_tpu_torch.utils import params as P
from vosk_tts_tpu_torch.utils.checkpoint import _flatten

CFG = dict(d_model=64, encoder_layers=2, encoder_attention_heads=4, encoder_ffn_dim=128)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def _rel(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


@pytest.fixture(scope="module")
def tree():
    cfg = tw.WhisperEncConfig(**CFG)
    t = P.whisper_init(cfg, seed=0)
    want = jax.eval_shape(lambda k: jw.whisper_encoder_init(k, jw.WhisperEncConfig(**CFG)),
                          jax.random.PRNGKey(0))
    assert jax.tree.structure(t) == jax.tree.structure(want)
    assert jax.tree.map(np.shape, t) == jax.tree.map(lambda a: a.shape, want)
    # ln gains, biases and the positional table are the JAX init's exactly
    np.testing.assert_array_equal(t["pos"], jw._sinusoids(1500, 64))
    return t


def _port(tree):
    return TreeModule(P.to_port_layout(tree)).params


def _wav(seconds, seed):
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 0.7 * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("seconds", [30.0, 3.7])
def test_log_mel(seconds):
    wav = _wav(seconds, 1)[None]
    want = np.asarray(jax.jit(jw.whisper_log_mel)(jnp.asarray(wav)))
    got = tw.whisper_log_mel(torch.tensor(wav)).numpy()
    assert got.shape == want.shape == (1, int(seconds * 16000) // 160, 80)
    assert float(np.abs(got - want).max()) <= 1e-5


def test_pad_or_trim():
    for n in (100, tw.N_SAMPLES, tw.N_SAMPLES + 7):
        w = np.arange(n, dtype=np.float32)
        np.testing.assert_array_equal(tw.pad_or_trim(w), jw.pad_or_trim(w))


def test_encoder_apply(tree):
    cfg = jw.WhisperEncConfig(**CFG)
    mel = np.asarray(jw.whisper_log_mel(jnp.asarray(jw.pad_or_trim(_wav(12.0, 2)))[None]))
    want = np.asarray(jax.jit(lambda p, m: jw.whisper_encoder_apply(p, cfg, m))(tree, mel))
    got = tw.whisper_encoder_apply(_port(tree), tw.WhisperEncConfig(**CFG),
                                   torch.tensor(mel)).numpy()
    assert got.shape == (1, 1500, 64)
    _rel(got, want, 1e-4)


def test_get_content(tree):
    cfg_j, cfg_t = jw.WhisperEncConfig(**CFG), tw.WhisperEncConfig(**CFG)
    enc = jax.jit(lambda p, m: jw.whisper_encoder_apply(p, cfg_j, m))
    mel = jax.jit(jw.whisper_log_mel)
    params = _port(tree)
    for seconds in (10.0, 29.9):
        wav = _wav(seconds, 3)
        n_frames = len(wav) // 160
        want = np.asarray(enc(tree, mel(jnp.asarray(jw.pad_or_trim(wav))[None])))
        want = want[:, : n_frames // 2]
        got = tw.get_content(params, cfg_t, wav).numpy()
        assert got.shape == (1, len(wav) // 160 // 2, 64)
        _rel(got, want, 1e-4, seconds)
    for f, p, c in ((tw.get_content, params, cfg_t), (jw.get_content, tree, cfg_j)):
        with pytest.raises(ValueError, match="30 s"):
            f(p, c, np.zeros(30 * 16000, np.float32))


def _state_dict(cfg, seed=0):
    """A synthetic HF ``WhisperModel.encoder`` state dict (torch layouts)."""
    rng = np.random.default_rng(seed)
    d, f = cfg.d_model, cfg.encoder_ffn_dim
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    sd = {"conv1.weight": r(d, cfg.num_mel_bins, 3), "conv1.bias": r(d),
          "conv2.weight": r(d, d, 3), "conv2.bias": r(d),
          "embed_positions.weight": r(cfg.max_source_positions, d),
          "layer_norm.weight": r(d), "layer_norm.bias": r(d)}
    for i in range(cfg.encoder_layers):
        pfx = f"layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{pfx}.self_attn.{name}.weight"] = r(d, d)
            if name != "k_proj":
                sd[f"{pfx}.self_attn.{name}.bias"] = r(d)
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{pfx}.{ln}.weight"], sd[f"{pfx}.{ln}.bias"] = r(d), r(d)
        sd[f"{pfx}.fc1.weight"], sd[f"{pfx}.fc1.bias"] = r(f, d), r(f)
        sd[f"{pfx}.fc2.weight"], sd[f"{pfx}.fc2.bias"] = r(d, f), r(d)
    return sd


def test_from_state_dict_equals_jax():
    cfg = jw.WhisperEncConfig(**CFG)
    sd = _state_dict(cfg)
    got = tw.whisper_from_state_dict(dict(sd), tw.WhisperEncConfig(**CFG))
    want = jax.device_get(jw.whisper_from_state_dict(dict(sd), cfg))
    g, w = _flatten(got), _flatten(want)
    assert sorted(g) == sorted(w)  # JAX's tree_map sorts the keys
    for k in w:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    g, w = _flatten(P.to_port_layout(got)), _flatten(P.to_port_layout(want))
    assert all(np.array_equal(g[k], w[k]) for k in w)
    # the HF names map where the encoder reads them: Linear (O, I) in the port's layout
    port = P.to_port_layout(got)
    np.testing.assert_array_equal(port["layers"][1]["attn"]["k"]["w"],
                                  sd["layers.1.self_attn.k_proj.weight"])
    np.testing.assert_array_equal(port["conv2"]["w"], sd["conv2.weight"])


def test_config_from_hf():
    d = {"num_mel_bins": 80, "d_model": 768, "encoder_layers": 12,
         "encoder_attention_heads": 12, "encoder_ffn_dim": 3072, "max_source_positions": 1500,
         "vocab_size": 51865}
    assert tw.WhisperEncConfig.from_hf(d) == tw.WhisperEncConfig()
    assert dataclasses.asdict(tw.WhisperEncConfig.from_hf(d)) == \
        dataclasses.asdict(jw.WhisperEncConfig.from_hf(d))


def test_small_parameter_count():
    """WhisperEncConfig() ("small"): the init's parameters by formula, without
    building the tree (88.2 M with k's unused bias)."""
    c = tw.WhisperEncConfig()
    d, f = c.d_model, c.encoder_ffn_dim
    per_layer = 4 * (d * d + d) + 2 * 2 * d + (d * f + f) + (f * d + d)
    total = (3 * c.num_mel_bins * d + d) + (3 * d * d + d) + c.max_source_positions * d \
        + c.encoder_layers * per_layer + 2 * d
    small = P.whisper_init(tw.WhisperEncConfig(**CFG), 0)
    d, f = 64, 128
    assert sum(a.size for a in _flatten(small).values()) == (
        (3 * 80 * d + d) + (3 * d * d + d) + 1500 * d
        + 2 * (4 * (d * d + d) + 4 * d + (d * f + f) + (f * d + d)) + 2 * d)
    assert 88e6 < total < 89e6
