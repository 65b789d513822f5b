"""The MB-iSTFT-VITS2 serving slice of the PyTorch port vs the JAX package.

One small configuration (every structure of the shipped one: speaker
conditioning, SDP with four DDSConv stacks, four pre_conv2 flows,
MB-iSTFT decoder with the fused tail) and one parameter tree from the JAX
init, with the zero-initialised flow ``post`` and ConvFlow ``proj`` weights
perturbed (as initialised, the flow is an identity and the durations do not
depend on any DDSConv output, so a wrong attention or DDSConv would pass).
Both packages run it on the CPU with the noise scales at 0. Stage outputs
hold 1e-4 (f32 through several layers, summation order differs); durations
are pinned from the JAX encode pass where a stage feeds ``ceil(exp(.))``.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import torch

from vosk_tts_tpu import api as japi
from vosk_tts_tpu.models import vits2 as jv
from vosk_tts_tpu.text import plain_symbol_map
from vosk_tts_tpu.utils.checkpoint import save_params
from vosk_tts_tpu_torch import api as tapi
from vosk_tts_tpu_torch.models import vits2 as tv
from vosk_tts_tpu_torch.utils.params import perturb_zero_init, to_port_layout, to_torch

CFG = dict(inter_channels=32, hidden_channels=32, filter_channels=64, n_layers=3,
           upsample_initial_channel=64, n_speakers=4, gin_channels=16, spec_channels=13)
TEXT = "Привет мир и всем хорошего дня!"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """(jax cfg, port cfg, jax tree (numpy), port tree (tensors))."""
    jcfg = jv.VITS2Config(**CFG)
    tree = perturb_zero_init(jax.device_get(jv.synthesizer_init(jax.random.PRNGKey(0), jcfg)),
                             seed=1)
    return jcfg, tv.VITS2Config(**CFG), tree, to_torch(to_port_layout(tree), "cpu")


@pytest.fixture(scope="module")
def bundle(tmp_path_factory, model):
    jcfg, _, tree, _ = model
    out = tmp_path_factory.mktemp("bundle") / "vits2-port-test"
    out.mkdir()
    save_params(out / "params.npz", tree)
    with open(out / "config.json", "w", encoding="utf-8") as f:
        json.dump({"model_type": "vits2", "sample_rate": 22050,
                   "phoneme_id_map": {k: [v] for k, v in plain_symbol_map().items()},
                   "inference": {"noise_level": 0.8, "speech_rate": 1.0,
                                 "duration_noise_level": 0.8},
                   "model": dataclasses.asdict(jcfg)}, f, ensure_ascii=False)
    (out / "dictionary").write_text("привет 1.0 p rj i0 vj e1 t\n", encoding="utf-8")
    return out


def _inputs(lengths, t, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 62, (len(lengths), t)).astype(np.int32)
    ids *= np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    return ids, np.asarray(lengths, np.int32), np.arange(len(lengths), dtype=np.int32) % 4


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def _speaker(tree, sid):
    return tree["emb_g"][sid][:, None, :]


def test_text_encoder(model):
    jcfg, tcfg, tree, tp = model
    ids, lengths, sid = _inputs([64, 40], 64, 0)
    g = _speaker(tree, sid)
    want = jv.text_encoder_apply(tree["enc_p"], jcfg, ids, lengths, g)
    got = tv.text_encoder_apply(tp["enc_p"], tcfg, _t(ids), _t(lengths), _t(g))
    for a, b in zip(got, want):
        _close(a, b)


def test_sdp_reverse(model):
    """logw before the ceil, four DDSConv stacks on the plain path."""
    jcfg, tcfg, tree, tp = model
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 32)).astype(np.float32)
    mask = (np.arange(32)[None, :] < np.array([[32], [19]])).astype(np.float32)[..., None]
    g = _speaker(tree, np.array([1, 3]))
    want = jv.sdp_reverse(tree["dp"], jcfg, x * mask, mask, g, rng=jax.random.PRNGKey(0),
                          noise_scale=0.0, fused=False)
    got = tv.sdp_reverse(tp["dp"], tcfg, _t(x * mask), _t(mask), _t(g), noise_scale=0.0)
    assert float(np.abs(np.asarray(want)).max()) > 1e-3  # durations depend on the DDSConvs
    _close(got, want)


def test_flow_reverse(model):
    jcfg, tcfg, tree, tp = model
    rng = np.random.default_rng(2)
    z = rng.standard_normal((2, 100, 32)).astype(np.float32)
    mask = (np.arange(100)[None, :] < np.array([[100], [61]])).astype(np.float32)[..., None]
    g = _speaker(tree, np.array([0, 2]))
    want = jv.flow_block_apply(tree["flow"], jcfg, z * mask, mask, g, reverse=True)
    got = tv.flow_block_apply(tp["flow"], tcfg, _t(z * mask), _t(mask), _t(g), reverse=True)
    assert float(np.abs(np.asarray(want) - z * mask).max()) > 1e-3  # the flow is not an identity
    _close(got, want)


def test_generator(model):
    jcfg, tcfg, tree, tp = model
    z = np.random.default_rng(3).standard_normal((2, 40, 32)).astype(np.float32)
    want, _ = jv.generator_apply(tree["dec"], jcfg, z, fused_tail=True)
    got, got_mb = tv.generator_apply(tp["dec"], tcfg, _t(z), fused_tail=True)
    assert got_mb is None
    assert got.shape == want.shape == (2, 40 * tcfg.upsample_factor, 1)
    _close(got, want)


def test_encode_and_decode(model):
    """encode_for_infer in both; decode_from_durations fed the JAX encode
    output (w_ceil pinned), with a generator slice below the frame bucket."""
    jcfg, tcfg, tree, tp = model
    ids, lengths, sid = _inputs([32, 21], 32, 4)
    key = jax.random.PRNGKey(5)
    enc_j = jv.encode_for_infer(tree, jcfg, ids, lengths, sid, rng=key, noise_scale_w=0.0)
    enc_t = tv.encode_for_infer(tp, tcfg, _t(ids), _t(lengths), _t(sid), noise_scale_w=0.0)
    for k in ("m_p", "logs_p", "x_mask"):
        _close(enc_t[k], enc_j[k])
    np.testing.assert_array_equal(enc_t["w_ceil"].numpy(), np.asarray(enc_j["w_ceil"]))

    pred = int(np.max(np.asarray(enc_j["pred_frames"])))
    fb = japi.pick_frame_bucket(pred, 32)
    gen = japi.pick_gen_frames(pred, fb)
    want = jv.decode_from_durations(tree, jcfg, enc_j, sid, rng=key, max_frames=fb,
                                    noise_scale=0.0, gen_frames=gen)
    pinned = {k: _t(v) for k, v in enc_j.items()}
    got = tv.decode_from_durations(tp, tcfg, pinned, _t(sid), max_frames=fb, noise_scale=0.0,
                                   gen_frames=gen)
    np.testing.assert_array_equal(got["wav_lengths"].numpy(), np.asarray(want["wav_lengths"]))
    n = int(np.max(np.asarray(want["wav_lengths"])))
    _close(got["wav"][:, :n], np.asarray(want["wav"])[:, :n])

    # pass one alone, and the single-pass path (VOSK_TTS_ADAPTIVE=0) at the
    # same frame bucket: its own durations equal the JAX ones (checked above)
    np.testing.assert_array_equal(
        tv.predict_frames(tp, tcfg, _t(ids), _t(lengths), _t(sid), noise_scale_w=0.0).numpy(),
        np.asarray(enc_j["pred_frames"]))
    want = jv.infer(tree, jcfg, ids, lengths, sid, rng=key, max_frames=fb, noise_scale=0.0,
                    noise_scale_w=0.0)
    got = tv.infer(tp, tcfg, _t(ids), _t(lengths), _t(sid), max_frames=fb, noise_scale=0.0,
                   noise_scale_w=0.0)
    np.testing.assert_array_equal(got["wav_lengths"].numpy(), np.asarray(want["wav_lengths"]))
    _close(got["wav"][:, :n], np.asarray(want["wav"])[:, :n])


def test_decode_with_decoder_cond(model):
    """A bundle whose decoder carries the speaker ``cond`` conv (the
    reference Generator has one whenever gin_channels > 0): the serving
    decode adds it before the upsampling stack, as the JAX package does."""
    jcfg, tcfg, tree, _ = model
    rng = np.random.default_rng(6)
    uic, gin = jcfg.upsample_initial_channel, jcfg.gin_channels
    tree = {**tree, "dec": {**tree["dec"], "cond": {
        "w": (rng.standard_normal((1, gin, uic)) * gin**-0.5).astype(np.float32),
        "b": (rng.standard_normal(uic) * 0.1).astype(np.float32)}}}
    tp = to_torch(to_port_layout(tree), "cpu")
    ids, lengths, sid = _inputs([32, 21], 32, 4)
    key = jax.random.PRNGKey(5)
    enc_j = jv.encode_for_infer(tree, jcfg, ids, lengths, sid, rng=key, noise_scale_w=0.0)
    fb = japi.pick_frame_bucket(int(np.max(np.asarray(enc_j["pred_frames"]))), 32)
    want = jv.decode_from_durations(tree, jcfg, enc_j, sid, rng=key, max_frames=fb,
                                    noise_scale=0.0)
    no_cond = jv.decode_from_durations({**tree, "dec": {k: v for k, v in tree["dec"].items()
                                                        if k != "cond"}},
                                       jcfg, enc_j, sid, rng=key, max_frames=fb, noise_scale=0.0)
    got = tv.decode_from_durations(tp, tcfg, {k: _t(v) for k, v in enc_j.items()}, _t(sid),
                                   max_frames=fb, noise_scale=0.0)
    n = int(np.max(np.asarray(want["wav_lengths"])))
    want_wav = np.asarray(want["wav"])[:, :n]
    assert np.abs(want_wav - np.asarray(no_cond["wav"])[:, :n]).max() > 1e-3  # cond is used
    _close(got["wav"][:, :n], want_wav)


def test_synth_audio_end_to_end(bundle):
    """Model/Synth of both packages on one bundle written by the JAX
    package: equal length, int16 samples within 2 (one rounding of each
    side's float output)."""
    kw = dict(speaker_id=1, noise_level=0.0, duration_noise_level=0.0)
    want = japi.Synth(japi.Model(model_path=bundle)).synth_audio(TEXT, **kw)
    port = tapi.Synth(tapi.Model(bundle, device="cpu"))
    got = port.synth_audio(TEXT, **kw)
    assert got.dtype == np.int16 and len(got) == len(want) > 0
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 2

    batch = port.synth_batch([TEXT, "Привет!"], speaker_ids=[1, 2], noise_level=0.0,
                             duration_noise_level=0.0)
    assert len(batch[0]) == len(got)
    assert np.abs(batch[0].astype(np.int32) - got.astype(np.int32)).max() <= 2
    assert len(batch[1]) > 0 and batch[1].dtype == np.int16


def test_synth_writes_wav(bundle, tmp_path):
    import wave

    out = tmp_path / "out.wav"
    tapi.Synth(tapi.Model(bundle, device="cpu")).synth("Привет мир!", out, speaker_id=2)
    with wave.open(str(out)) as f:
        assert f.getframerate() == 22050 and f.getnchannels() == 1 and f.getnframes() > 0


def test_buckets_match_jax():
    assert tapi.TEXT_BUCKETS == japi.TEXT_BUCKETS
    assert tapi.FRAME_BUCKETS == japi.FRAME_BUCKETS
    for pred, tb in ((1, 32), (500, 256), (10**6, 1024), (101, 64), (1300, 128)):
        fb = tapi.pick_frame_bucket(pred, tb)
        assert fb == japi.pick_frame_bucket(pred, tb)
        assert tapi.pick_gen_frames(pred, fb) == japi.pick_gen_frames(pred, fb)


def test_cli_needs_the_card(bundle, tmp_path):
    """The CLI runs on the card: without CUDA it fails rather than fall back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would run on it")
    r = subprocess.run([sys.executable, "-m", "vosk_tts_tpu_torch.cli", "--model", str(bundle),
                        "--input", "Привет мир!", "--output", str(tmp_path / "x.wav")],
                       capture_output=True, text=True, timeout=120,
                       cwd=Path(__file__).resolve().parent.parent)
    assert r.returncode != 0 and "CUDA is not available" in r.stderr
    assert not (tmp_path / "x.wav").exists()


def test_synthesizer_refuses_what_it_cannot_run(model):
    """A synthesizer runs every flow type, decoder and iSTFT mode of the JAX
    package (the hifigan and istft decoders included) and refuses only an
    unknown one; the generator refuses an unknown decoder."""
    _, _, _, tp = model
    voc = tv.VITS2Config(decoder_type="hifigan", gin_channels=0, n_speakers=0)
    tv.check_decoder(voc)
    tv.check_decoder(tv.VITS2Config(decoder_type="hifigan"))
    for cfg in (voc, tv.VITS2Config(decoder_type="hifigan")):
        tv.check_ported(cfg)
    for cfg in (tv.VITS2Config(decoder_type="wavenet"),
                tv.VITS2Config(transformer_flow_type="unknown")):
        with pytest.raises(ValueError, match="unknown"):
            tv.Synthesizer(cfg, {})
    with pytest.raises(ValueError, match="wavenet"):
        tv.generator_apply(tp["dec"], tv.VITS2Config(**CFG, decoder_type="wavenet"),
                           torch.zeros(1, 4, 32))
