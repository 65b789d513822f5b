"""The port's eval harness, speaker embedders, profiling, repro and plotting
utilities and tools vs the JAX package, on the CPU.

Tolerances (f32 on both sides):

* ``mfcc_f0_embedding`` (numpy on both sides): 1e-6 relative to the JAX
  value's largest magnitude;
* ``_utterance_mel``: 1e-5 x peak, and 1e-4 x peak at the bins whose mel
  energy is below 1e-3 of the largest (there the log turns the DFT's f32
  rounding into a relative error of 1/energy: one bin of 4120 at 1.7e-4 of
  the largest energy reads 2.3e-5 x peak);
* ``lstm_embedder`` on the committed artifact (the same file, byte for
  byte): the unit-norm embedding within 1e-5 absolute; the held-out check of
  tests/test_speaker_embedder.py at its thresholds (same > 0.75, same >
  cross + 0.15);
* ``ge2e_loss``: 1e-6 relative;
* three ``train_speaker_encoder`` steps from the JAX init on the same
  batches: the last loss 1e-5 relative; each leaf within 1e-5 of its
  largest magnitude at every element whose JAX gradient stays above 1e-6 x
  that step's largest gradient in all three steps. An element below that
  floor has a gradient that float rounding decides (the GE2E offset ``b``
  is one: its gradient is 0 in exact arithmetic), and Adam divides it by
  its own magnitude plus eps = 1e-8, so its step is any value up to lr:
  such elements are held to 2 lr a step. The clip-and-Adam arithmetic alone
  against optax on the same gradients: 1e-6 relative;
* ``speaker_similarity``, ``frechet_audio_distance``, ``transcribe_wer``,
  ``eval_utmos`` and ``_edit_distance``: 1e-6 relative on fixed inputs and
  embedders;
* the plotting images equal to the JAX package's.
"""

import dataclasses
import json
import logging
import os
import subprocess
import sys
import types
import wave
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from vosk_tts_tpu.eval import harness as jh
from vosk_tts_tpu.eval import speaker_embed as je
from vosk_tts_tpu.eval import speaker_train as js
from vosk_tts_tpu.models.quickvc import speaker_encoder_init
from vosk_tts_tpu.utils import plotting as jplot
from vosk_tts_tpu_torch import api as tapi
from vosk_tts_tpu_torch.eval import harness as th
from vosk_tts_tpu_torch.eval import speaker_embed as te
from vosk_tts_tpu_torch.eval import speaker_train as ts
from vosk_tts_tpu_torch.models import vits2 as tv
from vosk_tts_tpu_torch.text import plain_symbol_map
from vosk_tts_tpu_torch.tools import build_examples, eval_tts, train_speaker_embedder
from vosk_tts_tpu_torch.utils import params as tparams
from vosk_tts_tpu_torch.utils import plotting as tplot
from vosk_tts_tpu_torch.utils import profiling as tprof
from vosk_tts_tpu_torch.utils import repro as trepro
from vosk_tts_tpu_torch.utils.checkpoint import _flatten, save_params

ROOT = Path(__file__).resolve().parent.parent
# a small VITS2 with 5 speakers (batch_synthesize's default speakers 0-4)
VITS2 = dict(inter_channels=32, hidden_channels=32, filter_channels=64, n_layers=3,
             upsample_initial_channel=64, n_speakers=5, gin_channels=16, spec_channels=13)
TEXTS = ["Привет мир!", "Мама мыла раму."]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def _rel(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale + 1e-12, (what, err, scale)
    return err / max(scale, 1e-30)


def _voices(seed, n_voices, n_utts):
    rng = np.random.default_rng(seed)
    voices = [js.synthetic_voice(rng) for _ in range(n_voices)]
    return [[js.synthetic_utterance(rng, v) for _ in range(n_utts)] for v in voices]


@pytest.fixture(scope="module")
def utts():
    return _voices(999, 3, 3)


# ---------------------------------------------------------------------------
# Embedders
# ---------------------------------------------------------------------------


def test_synthetic_corpus_equals_jax():
    """The same rng gives the same voices and utterances in both packages."""
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    va, vb = js.synthetic_voice(a), ts.synthetic_voice(b)
    assert va.keys() == vb.keys() and all(np.array_equal(va[k], vb[k]) for k in va)
    np.testing.assert_array_equal(js.synthetic_utterance(a, va), ts.synthetic_utterance(b, vb))


def test_mfcc_f0_embedding(utts):
    for wav in (utts[0][0], utts[1][1][:300]):  # a full utterance, one shorter than a frame
        _rel(te.mfcc_f0_embedding(wav, 22050), je.mfcc_f0_embedding(wav, 22050), 1e-6)


def test_utterance_mel(utts):
    for wav in (utts[2][0], utts[0][1]):
        got, want = ts._utterance_mel(wav), np.asarray(js._utterance_mel(wav))
        assert got.shape == want.shape
        err, peak = np.abs(got - want), float(np.abs(want).max())
        quiet = want < want.max() + np.log(1e-3)  # energy below 1e-3 of the largest
        assert float(err[~quiet].max()) <= 1e-5 * peak
        assert float(err.max()) <= 1e-4 * peak


def test_artifact_is_the_jax_packages():
    assert (ROOT / "vosk_tts_tpu_torch/eval/data/speaker_encoder.npz").read_bytes() == \
        (ROOT / "vosk_tts_tpu/eval/data/speaker_encoder.npz").read_bytes()


def test_lstm_embedder_on_the_artifact(utts):
    emb_t, emb_j = ts.lstm_embedder(device="cpu"), js.lstm_embedder()
    for wav, sr in ((utts[0][0], 22050), (utts[1][0][:8000], 22050), (utts[2][1], 16000)):
        got, want = emb_t(wav, sr), emb_j(wav, sr)
        assert got.shape == want.shape == (64,)
        assert float(np.abs(got - want).max()) <= 1e-5


def test_artifact_discriminates_heldout_voices():
    """tests/test_speaker_embedder.py's held-out check, on the port."""
    emb = ts.lstm_embedder(device="cpu")
    rng = np.random.default_rng(999)
    va, vb, vc = (ts.synthetic_voice(rng) for _ in range(3))
    a = [ts.synthetic_utterance(rng, va) for _ in range(3)]
    b = [ts.synthetic_utterance(rng, vb) for _ in range(3)]
    c = [ts.synthetic_utterance(rng, vc) for _ in range(2)]
    same = th.speaker_similarity([(a[0], a[1]), (a[1], a[2]), (b[0], b[1]), (c[0], c[1])],
                                 embedder=emb)
    cross = th.speaker_similarity([(a[0], b[0]), (a[1], b[1]), (b[2], c[0]), (a[2], c[1])],
                                  embedder=emb)
    assert same.value > 0.75, (same.value, cross.value)
    assert same.value > cross.value + 0.15, (same.value, cross.value)


def test_default_embedder_is_the_artifact(monkeypatch, tmp_path):
    """The artifact on the requested device; the MFCC+F0 signature only where
    the file is missing (the JAX package's behaviour); no card raises."""
    emb = th._default_embedder("cpu")
    assert emb is not te.mfcc_f0_embedding
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            th._default_embedder()
    monkeypatch.setattr(ts, "ARTIFACT", str(tmp_path / "missing.npz"))
    assert th._default_embedder("cpu") is te.mfcc_f0_embedding


# ---------------------------------------------------------------------------
# GE2E training
# ---------------------------------------------------------------------------


def test_ge2e_loss():
    rng = np.random.default_rng(3)
    e = rng.standard_normal((4, 3, 16)).astype(np.float32)
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    want = js.ge2e_loss(jnp.asarray(e), jnp.asarray(7.0), jnp.asarray(-2.0))
    got = ts.ge2e_loss(torch.tensor(e), torch.tensor(7.0), torch.tensor(-2.0))
    _rel(got.numpy(), want, 1e-6)


def test_clip_adam_matches_optax():
    """The trainer's optimizer against optax.chain(clip_by_global_norm(3),
    adam(1e-3)) on the same gradients, three steps, one of them clipped."""
    rng = np.random.default_rng(4)
    p0 = {"a": rng.standard_normal((5, 7)).astype(np.float32),
          "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32) for k, v in p0.items()}
             for s in (0.1, 5.0, 0.3)]
    opt = optax.chain(optax.clip_by_global_norm(3.0), optax.adam(1e-3))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = opt.init(jp)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    topt = ts._ClipAdam(tp.values(), 1e-3)
    for g in grads:
        upd, jstate = opt.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        topt.step()
    for k in p0:
        _rel(tp[k].numpy(), jp[k], 1e-6, k)


GE2E = dict(n_voices=6, utts_per_voice=4, voices_per_batch=4, utts_per_batch=3, steps=3,
            hidden=16, emb=16, layers=2)


def test_train_speaker_encoder_three_steps(monkeypatch):
    """Both trainers from the JAX init of seed 2, three steps on the same
    batches (the same rng draws them); the JAX step's gradients recorded."""
    seed, lr = 2, 1e-3
    init = {"enc": jax.device_get(speaker_encoder_init(
                jax.random.PRNGKey(seed), mel_channels=40, hidden=GE2E["hidden"],
                emb=GE2E["emb"], layers=GE2E["layers"])),
            "w": np.asarray(10.0, np.float32), "b": np.asarray(-5.0, np.float32)}
    grads = []

    def chain(*transforms):
        inner = optax.chain(*transforms)

        def update(g, state, params=None):
            jax.debug.callback(lambda g: grads.append(jax.device_get(g)), g)
            return inner.update(g, state, params)
        return optax.GradientTransformation(inner.init, update)

    monkeypatch.setattr(js, "optax", types.SimpleNamespace(
        chain=chain, clip_by_global_norm=optax.clip_by_global_norm, adam=optax.adam,
        apply_updates=optax.apply_updates))
    jparams, jextra = js.train_speaker_encoder(seed, lr=lr, **GE2E)
    tparams_, textra = ts.train_speaker_encoder(seed, lr=lr, device="cpu", params=init, **GE2E)
    assert len(grads) == GE2E["steps"]
    assert textra.keys() == jextra.keys()
    _rel(textra["loss"], jextra["loss"], 1e-5, "loss")

    want, got, start = (_flatten(jax.device_get(jparams)), _flatten(tparams_), _flatten(init))
    flat_grads = [_flatten(g) for g in grads]
    floors = [1e-6 * max(float(np.abs(a).max()) for a in g.values()) for g in flat_grads]
    for path, w in want.items():
        steady = np.all([np.abs(g[path]) > f for g, f in zip(flat_grads, floors)], axis=0)
        err = np.abs(got[path] - w)
        scale = float(np.abs(w).max())
        assert float(err[steady].max(initial=0.0)) <= 1e-5 * scale, (path, scale)
        assert float(err[~steady].max(initial=0.0)) <= 2 * lr * GE2E["steps"], path
        assert float(np.abs(got[path] - start[path]).max()) > 0, path  # every leaf trained
    assert not np.abs(flat_grads[0]["b"]) > floors[0]  # the offset's gradient: rounding


def test_trainer_init_and_defaults():
    """train_speaker_encoder's own init (a torch.Generator) has the JAX
    init's structure and shapes; the loss is finite and the embedder of the
    result runs; no card raises."""
    want = jax.eval_shape(lambda k: speaker_encoder_init(k, mel_channels=40, hidden=8, emb=8,
                                                         layers=1), jax.random.PRNGKey(0))
    tree = ts.init_tree(1, hidden=8, emb=8, layers=1)
    assert jax.tree.structure(tree["enc"]) == jax.tree.structure(want)
    assert jax.tree.map(np.shape, tree["enc"]) == jax.tree.map(lambda a: a.shape, want)
    params, extra = ts.train_speaker_encoder(
        1, n_voices=4, utts_per_voice=3, voices_per_batch=3, utts_per_batch=2, steps=3,
        hidden=8, emb=8, layers=1, device="cpu")
    assert np.isfinite(extra["loss"])
    e = ts.lstm_embedder(params, device="cpu")(
        np.random.default_rng(0).standard_normal(22050).astype(np.float32), 22050)
    assert e.shape == (8,) and np.isfinite(e).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ts.train_speaker_encoder(1, steps=1)


def test_artifact_round_trip(tmp_path):
    art = ts.load_artifact()
    path = tmp_path / "enc.npz"
    ts.save_artifact(str(path), art["params"], {k: v for k, v in art["meta"].items()})
    again = ts.load_artifact(str(path))
    for tree in ("params", "meta"):
        a, b = _flatten(art[tree]), _flatten(again[tree])
        assert list(a) == list(b) and all(np.array_equal(a[k], b[k]) for k in a)
    # the JAX package reads what the port writes
    jx = js.load_artifact(str(path))
    np.testing.assert_array_equal(jx["params"]["enc"]["lstm"][1]["w_hh"],
                                  art["params"]["enc"]["lstm"][1]["w_hh"])


# ---------------------------------------------------------------------------
# Scores
# ---------------------------------------------------------------------------


def test_scores_equal_jax(utts):
    pairs = [(utts[0][0], utts[0][1]), (utts[0][1], utts[1][0]), (utts[2][0], utts[2][2])]
    for emb in (te.mfcc_f0_embedding, lambda w, sr: np.asarray(w[:64:3], np.float32) + 0.1):
        got, want = th.speaker_similarity(pairs, embedder=emb), jh.speaker_similarity(pairs,
                                                                                     embedder=emb)
        assert got.metric == want.metric and got.extra["n"] == want.extra["n"]
        _rel(got.value, want.value, 1e-6)
        _rel(got.extra["min"], want.extra["min"], 1e-6)
    ref = [u for v in utts[:2] for u in v]
    gen = [u[: 20000] for u in utts[2]] + [utts[0][0][::-1].copy()] * 3
    got = th.frechet_audio_distance(ref, gen, embedder=te.mfcc_f0_embedding)
    want = jh.frechet_audio_distance(ref, gen, embedder=je.mfcc_f0_embedding)
    assert got.extra == want.extra
    _rel(got.value, want.value, 1e-6)
    m = np.random.default_rng(1).standard_normal((6, 6))
    _rel(th._sqrtm_psd(m @ m.T), jh._sqrtm_psd(m @ m.T), 1e-6)

    asr = {"a.wav": "Привет, мир", "b.wav": "мама мыла раму"}.get
    refs = ["привет мир!", "Мама мыла раму и окно."]
    for f in (th, jh):
        assert f._edit_distance("a b c d".split(), "a x c".split()) == 2
    got, want = (th.transcribe_wer(["a.wav", "b.wav"], refs, asr),
                 jh.transcribe_wer(["a.wav", "b.wav"], refs, asr))
    assert got.extra == want.extra and got.value == pytest.approx(want.value, rel=1e-6)
    scores = {"a.wav": 4.0, "b.wav": 3.25, "c.wav": 3.5}.get
    got, want = th.eval_utmos(list("abc"), lambda p: scores(p + ".wav")), \
        jh.eval_utmos(list("abc"), lambda p: scores(p + ".wav"))
    assert (got.metric, got.extra) == (want.metric, want.extra)
    _rel(got.value, want.value, 1e-6)


# ---------------------------------------------------------------------------
# Synthesis drivers and tools on a small bundle
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    cfg = tv.VITS2Config(**VITS2)
    out = tmp_path_factory.mktemp("evalbundle") / "vosk-model-tts-ru-eval-test"
    out.mkdir()
    save_params(out / "params.npz",
                tparams.perturb_zero_init(tparams.synthesizer_init(cfg, seed=0), seed=1))
    with open(out / "config.json", "w", encoding="utf-8") as f:
        json.dump({"model_type": "vits2", "sample_rate": 22050,
                   "phoneme_id_map": {k: [v] for k, v in plain_symbol_map().items()},
                   "inference": {}, "model": dataclasses.asdict(cfg)}, f, ensure_ascii=False)
    (out / "dictionary").write_text("привет 1.0 p rj i0 vj e1 t\n", encoding="utf-8")
    return out


def _wav_ok(path):
    with wave.open(str(path)) as f:
        assert f.getframerate() == 22050 and f.getsampwidth() == 2
        data = np.frombuffer(f.readframes(f.getnframes()), np.int16)
    assert len(data) > 0 and np.any(data != 0)


def test_batch_synthesize_and_rtf(bundle, tmp_path):
    synth = tapi.Synth(tapi.Model(bundle, device="cpu"))
    paths = th.batch_synthesize(synth, TEXTS, tmp_path / "wavs", speakers=(0, 4))
    assert [os.path.basename(p) for p in paths] == ["spk0_0000.wav", "spk0_0001.wav",
                                                      "spk4_0000.wav", "spk4_0001.wav"]
    for p in paths:
        _wav_ok(p)
    r = th.eval_rtf(synth, TEXTS)
    assert r.metric == "rtf" and 0 < r.value < float("inf")
    assert r.extra["audio_sec"] > 0 and r.extra["audio_sec_per_sec"] == pytest.approx(
        1 / r.value, rel=1e-9)


def test_tools_on_the_cpu(bundle, tmp_path, capsys):
    paths = build_examples.main([str(bundle), str(tmp_path / "ex"), "--speakers", "0,1,2,3,4",
                                 "--device", "cpu"])
    assert len(paths) == 5
    for p in paths:
        _wav_ok(p)
    texts = tmp_path / "texts.txt"
    texts.write_text("\n".join(TEXTS) + "\n", encoding="utf-8")
    first = eval_tts.main([str(bundle), "--texts", str(texts), "--out", str(tmp_path / "a"),
                           "--speakers", "0,2", "--device", "cpu"])
    res = eval_tts.main([str(bundle), "--texts", str(texts), "--out", str(tmp_path / "b"),
                         "--speakers", "0,2", "--ref-dir", str(tmp_path / "a"), "--device", "cpu",
                         "--asr-cmd", f"{sys.executable} -c print('привет')"])
    assert first["n_wavs"] == res["n_wavs"] == 4 and res["rtf"] > 0
    # the same seed, noise and text: the reference WAVs are the same voices
    assert res["speaker_similarity_avg"] > 0.99 and res["speaker_similarity_min"] <= 1.0 + 1e-6
    assert 0.0 <= res["wer"] <= 1.5
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    out, extra, same, cross = train_speaker_embedder.main(
        ["--steps", "2", "--out", str(tmp_path / "enc" / "speaker_encoder.npz"),
         "--device", "cpu"])
    assert os.path.exists(out) and np.isfinite(extra["loss"]) and np.isfinite([same, cross]).all()
    assert ts.lstm_embedder(ts.load_artifact(out)["params"], device="cpu")(
        np.ones(22050, np.float32), 22050).shape == (64,)


def test_tools_run_as_modules(tmp_path):
    """``python -m vosk_tts_tpu_torch.tools.<name> --help`` in a fresh
    process, and the default device: no card raises."""
    for name in ("eval_tts", "build_examples", "train_speaker_embedder"):
        r = subprocess.run([sys.executable, "-m", f"vosk_tts_tpu_torch.tools.{name}", "--help"],
                           capture_output=True, text=True, cwd=ROOT, timeout=120)
        assert r.returncode == 0 and "--device" in r.stdout, (name, r.stderr)
    if not torch.cuda.is_available():
        r = subprocess.run([sys.executable, "-m", "vosk_tts_tpu_torch.tools.train_speaker_embedder",
                            "--steps", "1", "--out", str(tmp_path / "x.npz")],
                           capture_output=True, text=True, cwd=ROOT, timeout=120)
        assert r.returncode != 0 and "CUDA is not available" in r.stderr
        assert not (tmp_path / "x.npz").exists()


# ---------------------------------------------------------------------------
# Profiling, repro, plotting
# ---------------------------------------------------------------------------


def test_stage_timer_keys_equal_jax():
    from vosk_tts_tpu.utils import profiling as jprof

    reports = []
    for mod in (tprof, jprof):
        t = mod.StageTimer()
        with t.stage("a"):
            pass
        with t.stage("b", sync=np.zeros(2) if mod is jprof else torch.zeros(2)):
            pass
        with t.stage("a"):
            pass
        t.add_audio(22050)
        reports.append(t.report())
    got, want = reports
    assert got.keys() == want.keys() and got["stages_sec"].keys() == want["stages_sec"].keys()
    assert got["audio_sec"] == want["audio_sec"] == 1.0
    assert got["rtf"] == pytest.approx(got["total_sec"]) and got["audio_sec_per_sec"] > 0
    assert tprof.device_stats() == ([] if not torch.cuda.is_available() else tprof.device_stats())


def test_device_timeit_on_cpu_tensors():
    """Host clock for CPU tensors: the slope of a 96x96 matmul chain is
    positive and below the n2 run's time over n2 - n1; a dict carry works."""
    a = torch.randn(96, 96) / 10
    per, t1, t2 = tprof.device_timeit(lambda c: {"x": torch.tanh(c["x"] @ a), "n": c["n"] + 1},
                                      {"x": torch.randn(96, 96), "n": torch.zeros(())},
                                      n1=2, n2=12, reps=3)
    assert per > 0 and t2 > t1 > 0 and per <= t2 / 10 * 1.5


def test_trace_writes_a_file(tmp_path):
    with tprof.trace(str(tmp_path / "tr")):
        torch.randn(32, 32) @ torch.randn(32, 32)
    files = list((tmp_path / "tr").iterdir())
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert "traceEvents" in json.loads(files[0].read_text())


def test_check_git_hash(tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(trepro, "git_hash", lambda: "a" * 40)
    trepro.check_git_hash(str(tmp_path / "run"))
    assert (tmp_path / "run" / "githash").read_text() == "a" * 40
    with caplog.at_level(logging.WARNING, logger="vosk_tts_tpu_torch.repro"):
        trepro.check_git_hash(str(tmp_path / "run"))
        assert not caplog.records
        monkeypatch.setattr(trepro, "git_hash", lambda: "b" * 40)
        trepro.check_git_hash(str(tmp_path / "run"))
    assert "git hash mismatch" in caplog.text
    assert (tmp_path / "run" / "githash").read_text() == "a" * 40
    monkeypatch.setattr(trepro, "git_hash", lambda: None)
    trepro.check_git_hash(str(tmp_path / "none"))
    assert not (tmp_path / "none").exists()
    monkeypatch.undo()
    h = trepro.git_hash()
    assert h is None or (len(h) == 40 and all(c in "0123456789abcdef" for c in h))


@pytest.mark.parametrize("shape", [(20, 30), (7, 5)])
def test_plotting_equals_jax(shape):
    x = np.random.default_rng(sum(shape)).random(shape)
    np.testing.assert_array_equal(tplot.plot_spectrogram_to_numpy(x),
                                  jplot.plot_spectrogram_to_numpy(x))
    np.testing.assert_array_equal(tplot.plot_alignment_to_numpy(x),
                                  jplot.plot_alignment_to_numpy(x))


def test_plotting_without_matplotlib(monkeypatch):
    """The branch the card's machine takes: no matplotlib."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    x = np.random.default_rng(0).random((6, 9))
    img = tplot.plot_spectrogram_to_numpy(x)
    assert img.shape == (6, 9, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(img, jplot.plot_spectrogram_to_numpy(x))
    assert tplot.plot_alignment_to_numpy(x).shape == (9, 6, 3)
