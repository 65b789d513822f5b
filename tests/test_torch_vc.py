"""The voice-conversion slice of the PyTorch port vs the JAX package.

ContentVec/HuBERT, QuickVC (LSTM speaker encoder, posterior encoder, plain
couplings, ms-iSTFT generator), ``pipelines.convert_voice`` and VITS2's
``voice_conversion`` (``pre_conv2`` flows forward then in reverse, the
unfused MB-iSTFT tail), each on the CPU at test widths: one parameter tree
in the bundle layout from the port's numpy init (whose shapes are held to
the JAX init's; zero-initialised flow ``post`` convs perturbed, or the
flows are the identity), inputs from a seeded numpy generator, and the
posterior's normal draw fed to the port exactly as ``jax.random.normal``
makes it. Tolerances (f32 on both sides, sums in other orders): strided
conv 1e-6; log-mel 1e-5 absolute; HuBERT 1e-4; speaker embedding,
posterior and flows 1e-5; waveforms 1e-4 x the JAX waveform's peak, equal
lengths, valid samples. Beside them: a bundle of another ``model_type``
loads as VITS2, and the carried HuBERT/QuickVC layouts.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vosk_tts_tpu import pipelines as jpipe
from vosk_tts_tpu.models import hubert as jh
from vosk_tts_tpu.models import quickvc as jq
from vosk_tts_tpu.models import vits2 as jv
from vosk_tts_tpu.ops import conv as jconv
from vosk_tts_tpu.ops import stft as jstft
from vosk_tts_tpu_torch import api as tapi
from vosk_tts_tpu_torch import pipelines as tpipe
from vosk_tts_tpu_torch.models import hubert as th
from vosk_tts_tpu_torch.models import quickvc as tq
from vosk_tts_tpu_torch.models import vits2 as tv
from vosk_tts_tpu_torch.ops import conv as tconv
from vosk_tts_tpu_torch.ops import stft as tstft
from vosk_tts_tpu_torch.text import plain_symbol_map
from vosk_tts_tpu_torch.utils.checkpoint import save_params
from vosk_tts_tpu_torch.utils.params import (hubert_init, perturb_zero_init, quickvc_init,
                                             synthesizer_init, to_port_layout, to_torch)

HUBERT = dict(hidden_size=24, num_hidden_layers=1, num_attention_heads=2, intermediate_size=48,
              conv_dim=(8, 8), conv_kernel=(10, 4), conv_stride=(5, 4),
              num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=2)
QUICKVC = dict(spec_channels=65, inter_channels=32, hidden_channels=32,
               upsample_initial_channel=64, gin_channels=16, ssl_dim=24)
VITS2 = dict(inter_channels=32, hidden_channels=32, filter_channels=64, n_layers=3,
             upsample_initial_channel=64, n_speakers=4, gin_channels=16, spec_channels=13)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


def _close_wav(got, want):
    """Equal shapes, max abs error <= 1e-4 x the JAX waveform's peak."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    peak = float(np.abs(want).max())
    assert peak > 1e-6
    assert float(np.abs(got - want).max()) <= 1e-4 * peak


def _mask(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]


def _noise(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def _shapes(tree):
    return jax.tree_util.tree_map(np.shape, tree)


@pytest.fixture(scope="module")
def hubert():
    tcfg = th.HubertConfig(**HUBERT)
    tree = hubert_init(tcfg, seed=0)
    return jh.HubertConfig(**HUBERT), tcfg, tree, to_torch(to_port_layout(tree), "cpu")


@pytest.fixture(scope="module")
def quickvc():
    """QuickVC tree, couplings perturbed, plus the decoder's speaker
    ``cond`` conv that converted QuickVC checkpoints carry (the inits have
    none)."""
    tcfg = tq.QuickVCConfig(**QUICKVC)
    tree = perturb_zero_init(quickvc_init(tcfg, seed=1), seed=2)
    rng = np.random.default_rng(3)
    tree["dec"]["cond"] = {"w": rng.uniform(-0.25, 0.25, (1, 16, 64)).astype(np.float32),
                           "b": rng.uniform(-0.25, 0.25, (64,)).astype(np.float32)}
    return jq.QuickVCConfig(**QUICKVC), tcfg, tree, to_torch(to_port_layout(tree), "cpu")


@pytest.fixture(scope="module")
def vits2():
    tcfg = tv.VITS2Config(**VITS2)
    tree = perturb_zero_init(synthesizer_init(tcfg, seed=4), seed=5)
    return jv.VITS2Config(**VITS2), tcfg, tree, to_torch(to_port_layout(tree), "cpu")


def test_numpy_inits_have_the_jax_shapes(hubert, quickvc):
    key = jax.random.PRNGKey(0)
    jh_cfg, _, htree, _ = hubert
    assert _shapes(htree) == _shapes(jax.eval_shape(lambda k: jh.hubert_init(k, jh_cfg), key))
    jq_cfg, _, qtree, _ = quickvc
    want = _shapes(jax.eval_shape(lambda k: jq.synthesizer_init(k, jq_cfg), key))
    got = _shapes(qtree)
    del got["dec"]["cond"]
    assert got == want


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,stride,groups", [(10, 5, 1), (3, 2, 1), (4, 2, 2), (1, 2, 1)])
def test_conv1d_stride(k, stride, groups):
    rng = np.random.default_rng(k + stride)
    x = rng.standard_normal((2, 53, 8)).astype(np.float32)
    w = rng.standard_normal((k, 8 // groups, 6)).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    want = jconv.conv1d(x, w, b, stride=stride, padding=0, groups=groups)
    tw = to_port_layout({"w": w})["w"]
    got = tconv.conv1d(_t(x), _t(tw), _t(b), stride=stride, padding=0, groups=groups)
    assert got.shape == want.shape
    _close(got, want, 1e-6)


@pytest.mark.parametrize("n_fft,hop,sr,n_mels", [(1280, 320, 16000, 80), (1024, 256, 22050, 13)])
def test_spectrogram_and_mel(n_fft, hop, sr, n_mels):
    y = (np.random.default_rng(n_fft).standard_normal((2, 9000)) * 0.1).astype(np.float32)
    want = jstft.spectrogram(y, n_fft, hop, n_fft)
    got = tstft.spectrogram(_t(y), n_fft, hop, n_fft)
    assert got.shape == want.shape
    _close(got, want, 1e-5 * float(np.abs(np.asarray(want)).max()))
    np.testing.assert_array_equal(tstft.mel_filterbank(sr, n_fft, n_mels, 0.0, None),
                                  jstft.mel_filterbank(sr, n_fft, n_mels, 0.0, None))
    want = jstft.mel_spectrogram(y, n_fft, n_mels, sr, hop, n_fft, 0.0, None)
    got = tstft.mel_spectrogram(_t(y), n_fft, n_mels, sr, hop, n_fft, 0.0, None)
    assert got.shape == want.shape
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# HuBERT, QuickVC pieces
# ---------------------------------------------------------------------------


def test_hubert(hubert):
    jcfg, tcfg, tree, tp = hubert
    # convert_voice's shapes (JAX compiles each op once a shape)
    wav = (np.random.default_rng(6).standard_normal((1, 2000)) * 0.1).astype(np.float32)
    want = jh.hubert_apply(tree, jcfg, wav)
    got = th.hubert_apply(tp, tcfg, _t(wav))
    assert got.shape == want.shape == (1, tcfg.n_frames(2000), 24) == (1, 99, 24)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("frames", [90, 128, 300])
def test_speaker_embedding(quickvc, frames):
    _, _, tree, tp = quickvc
    mel = np.random.default_rng(frames).standard_normal((1, frames, 80)).astype(np.float32)
    want = jq.embed_utterance(tree["enc_spk"], mel)
    got = tq.embed_utterance(tp["enc_spk"], _t(mel))
    assert got.shape == want.shape == (1, 16)
    _close(got, want, 1e-5)
    want = jq.speaker_encoder_apply(tree["enc_spk"], np.concatenate([mel, mel * 0.5])[:, :100])
    got = tq.speaker_encoder_apply(tp["enc_spk"], _t(np.concatenate([mel, mel * 0.5])[:, :100]))
    _close(got, want, 1e-5)


def test_posterior(quickvc):
    jcfg, tcfg, tree, tp = quickvc
    rng = np.random.default_rng(7)
    y = rng.standard_normal((2, 40, 65)).astype(np.float32)
    lengths = np.array([40, 27], np.int32)
    g = rng.standard_normal((2, 1, 16)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    want = jv.posterior_apply(tree["enc_q"], jcfg.as_vits2(), y, lengths, g, rng=key)
    got = tv.posterior_apply(tp["enc_q"], tcfg.as_vits2(), _t(y), _t(lengths), _t(g),
                             noise=_t(_noise(key, (2, 40, 32))))
    for a, b in zip(got, want):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("kind", ["plain", "pre_conv2"])
def test_flow_both_directions(quickvc, vits2, kind):
    jcfg, tcfg, tree, tp = quickvc if kind == "plain" else vits2
    if kind == "plain":
        jcfg, tcfg = jcfg.as_vits2(), tcfg.as_vits2()
    rng = np.random.default_rng(9)
    mask = _mask([60, 37], 60)
    z = rng.standard_normal((2, 60, 32)).astype(np.float32) * mask
    g = rng.standard_normal((2, 1, 16)).astype(np.float32)
    for reverse in (False, True):
        want = jv.flow_block_apply(tree["flow"], jcfg, z, mask, g, reverse=reverse)
        got = tv.flow_block_apply(tp["flow"], tcfg, _t(z), _t(mask), _t(g), reverse=reverse)
        assert float(np.abs(np.asarray(want) - z).max()) > 1e-3  # not the identity
        _close(got, want, 1e-5)
    fwd = tv.flow_block_apply(tp["flow"], tcfg, _t(z), _t(mask), _t(g), reverse=False)
    _close(tv.flow_block_apply(tp["flow"], tcfg, fwd, _t(mask), _t(g), reverse=True), z, 1e-5)


def test_ms_istft_generator(quickvc):
    jcfg, tcfg, tree, tp = quickvc
    rng = np.random.default_rng(10)
    z = rng.standard_normal((2, 30, 32)).astype(np.float32)
    g = rng.standard_normal((2, 1, 16)).astype(np.float32)
    want, want_mb = jv.generator_apply(tree["dec"], jcfg.as_vits2(), z, g)
    got, got_mb = tv.generator_apply(tp["dec"], tcfg.as_vits2(), _t(z), _t(g))
    _close_wav(got_mb, want_mb)
    assert got.shape == (2, 30 * 320, 1)
    _close_wav(got, want)


def test_mb_istft_unfused_tail(vits2):
    jcfg, tcfg, tree, tp = vits2
    z = np.random.default_rng(11).standard_normal((2, 40, 32)).astype(np.float32)
    want, want_mb = jv.generator_apply(tree["dec"], jcfg, z)
    got, got_mb = tv.generator_apply(tp["dec"], tcfg, _t(z))
    _close_wav(got_mb, want_mb)  # the subband waveforms training reads
    assert got.shape == (2, 40 * tcfg.upsample_factor, 1)
    _close_wav(got, want)
    # the fused serving tail computes the same waveform
    fused, _ = tv.generator_apply(tp["dec"], tcfg, _t(z), fused_tail=True)
    _close_wav(fused, want)


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------


def test_quickvc_infer(quickvc):
    jcfg, tcfg, tree, tp = quickvc
    rng = np.random.default_rng(12)
    # convert_voice's shapes: 99 ContentVec frames, 150 target mel frames
    c = rng.standard_normal((1, 99, 24)).astype(np.float32)
    tgt_mel = rng.standard_normal((1, 150, 80)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    want = jq.infer(tree, jcfg, c, tgt_mel, rng=key)
    model = tq.QuickVC(tcfg, to_port_layout(tree))
    got = model.infer(_t(c), _t(tgt_mel), noise=_t(_noise(key, (1, 99, 32))))
    assert got.shape == (1, 99 * 320)
    _close_wav(got, want)


def test_convert_voice(hubert, quickvc):
    hj, ht, htree, hp = hubert
    qj, qt, qtree, qp = quickvc
    rng = np.random.default_rng(14)
    src = (rng.standard_normal(2000) * 0.1).astype(np.float32)
    tgt = (rng.standard_normal(48000) * 0.1).astype(np.float32)  # 150 mel frames: 2 slices + last
    key = jax.random.PRNGKey(15)
    want = jpipe.convert_voice(qtree, qj, htree, hj, src, tgt, rng=key)
    frames = ht.n_frames(len(src))
    got = tpipe.convert_voice(qp, qt, hp, ht, src, tgt, device="cpu",
                              noise=_t(_noise(key, (1, frames, 32))))
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == (frames * 320,)
    _close_wav(got, want)


def test_vits2_voice_conversion(vits2):
    jcfg, tcfg, tree, tp = vits2
    rng = np.random.default_rng(16)
    wav = (rng.standard_normal((2, 40 * 256)) * 0.1).astype(np.float32)
    y = np.asarray(jstft.mel_spectrogram(wav, 1024, 13, 22050, 256, 1024, 0.0, None))
    t = y.shape[1]
    lengths = np.array([t, t - 11], np.int32)
    sid_src, sid_tgt = np.array([0, 2], np.int32), np.array([3, 1], np.int32)
    key = jax.random.PRNGKey(17)
    want, want_mask = jv.voice_conversion(tree, jcfg, y, lengths, sid_src, sid_tgt, rng=key)
    synth = tv.Synthesizer(tcfg, to_port_layout(tree))
    got, mask = synth.voice_conversion(_t(y), _t(lengths), _t(sid_src), _t(sid_tgt),
                                       noise=_t(_noise(key, (2, t, 32))))
    _close(mask, want_mask, 0)
    up = tcfg.upsample_factor
    assert got.shape == (2, t * up, 1)
    for i, n in enumerate(lengths * up):
        _close_wav(got[i, :n], np.asarray(want)[i, :n])


# ---------------------------------------------------------------------------
# Loading: other model types, carried layouts
# ---------------------------------------------------------------------------


def _bundle(path, model_type, tree, cfg):
    path.mkdir()
    save_params(path / "params.npz", tree)
    with open(path / "config.json", "w", encoding="utf-8") as f:
        json.dump({"model_type": model_type, "sample_rate": 22050,
                   "phoneme_id_map": {k: [v] for k, v in plain_symbol_map().items()},
                   "inference": {}, "model": dataclasses.asdict(cfg)}, f, ensure_ascii=False)
    (path / "dictionary").write_text("привет 1.0 p rj i0 vj e1 t\n", encoding="utf-8")
    return path


def test_other_model_type_loads_as_vits2(tmp_path):
    """A ``"model_type": "vits"`` bundle loads and synthesizes exactly what
    the same bundle does as ``"vits2"`` (the JAX Model's rule)."""
    cfg = tv.VITS2Config(**VITS2)
    tree = perturb_zero_init(synthesizer_init(cfg, seed=0), seed=1)
    kw = dict(speaker_id=1, noise_level=0.0, duration_noise_level=0.0)
    audio = {}
    for kind in ("vits", "vits2"):
        model = tapi.Model(_bundle(tmp_path / kind, kind, tree, cfg), device="cpu")
        assert model.model_type == kind and isinstance(model.synthesizer, tv.Synthesizer)
        synth = tapi.Synth(model)
        audio[kind] = synth.synth_audio("Привет мир!", **kw)
        batch = synth.synth_batch(["Привет мир!"], speaker_ids=[1], noise_level=0.0,
                                  duration_noise_level=0.0)
        np.testing.assert_array_equal(batch[0], audio[kind])
    assert len(audio["vits"]) > 0
    np.testing.assert_array_equal(audio["vits"], audio["vits2"])


def test_carried_layouts():
    """HuBERT and QuickVC trees as the JAX package lays them out -> the
    port's: LSTM gates in torch's order, the grouped pos_conv, the
    ms-iSTFT filter, a 1x1 conv over 768 features; a VITS2 tree keeps enc_q."""
    hcfg = th.HubertConfig(**HUBERT)
    htree = hubert_init(hcfg, seed=0)
    hp = to_port_layout(htree)
    pw = htree["pos_conv"]["w"]  # (K, I/groups, O)
    assert pw.shape == (8, 12, 24)
    np.testing.assert_array_equal(hp["pos_conv"]["w"], pw.transpose(2, 1, 0))
    np.testing.assert_array_equal(hp["fp"]["w"], htree["fp"]["w"].T)
    assert hp["conv_layers"][0]["w"].shape == (8, 1, 10) and "b" not in hp["conv_layers"][0]

    qcfg = tq.QuickVCConfig(ssl_dim=768, spec_channels=65, inter_channels=32,
                            hidden_channels=32, upsample_initial_channel=64, gin_channels=16)
    qtree = quickvc_init(qcfg, seed=0)
    qp = to_port_layout(qtree)
    assert qtree["enc_p"]["pre"]["w"].shape == (1, 768, 32)
    np.testing.assert_array_equal(qp["enc_p"]["pre"]["w"], qtree["enc_p"]["pre"]["w"][0].T)
    assert qtree["dec"]["multistream_conv_post"]["w"].shape == (63, 4, 1)
    np.testing.assert_array_equal(qp["dec"]["multistream_conv_post"]["w"],
                                  qtree["dec"]["multistream_conv_post"]["w"].transpose(2, 1, 0))
    for i, layer in enumerate(qtree["enc_spk"]["lstm"]):
        assert layer["w_ih"].shape == ((80 if i == 0 else 16), 64)
        np.testing.assert_array_equal(qp["enc_spk"]["lstm"][i]["w_ih"], layer["w_ih"].T)
        np.testing.assert_array_equal(qp["enc_spk"]["lstm"][i]["w_hh"], layer["w_hh"].T)
    # torch.nn.LSTM loaded with the carried gates gives the port's embedding
    lstm = torch.nn.LSTM(80, 16, num_layers=3, batch_first=True)
    names = (("weight_ih", "w_ih"), ("weight_hh", "w_hh"), ("bias_ih", "b_ih"), ("bias_hh", "b_hh"))
    lstm.load_state_dict({f"{n}_l{i}": torch.tensor(qp["enc_spk"]["lstm"][i][k])
                          for i in range(3) for n, k in names})
    mel = torch.tensor(np.random.default_rng(0).standard_normal((2, 50, 80)), dtype=torch.float32)
    with torch.no_grad():
        _, (h, _) = lstm(mel)
        e = torch.relu(torch.nn.functional.linear(h[-1], torch.tensor(qp["enc_spk"]["linear"]["w"]),
                                                  torch.tensor(qp["enc_spk"]["linear"]["b"])))
    got = tq.speaker_encoder_apply(to_torch(qp["enc_spk"], "cpu"), mel)
    _close(got, e / e.norm(dim=1, keepdim=True), 1e-6)

    vcfg = tv.VITS2Config(**VITS2)
    vp = to_port_layout(synthesizer_init(vcfg, seed=0))
    assert set(vp["enc_q"]) == {"pre", "enc", "proj"}
    assert "enc_q" in tv.Synthesizer(vcfg, vp).params
