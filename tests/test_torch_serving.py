"""The serving path of the PyTorch port (vosk_tts_tpu_torch.serving, the
registry and the CLI's model selection) against the JAX package, on the CPU.

* ``split_decode_groups``: identical to the JAX function on its own test
  cases and on 200 seeded random lists of predicted frames per branch.
* ``BatchSynthesizer`` on tiny bundles written by the JAX package (the
  zero-initialised flow, ConvFlow and adaLN-Zero projections perturbed, so
  that durations depend on every stage): requests of different lengths at
  mixed rates, forced into one batch, noise levels 0 (the ODE starts from
  z = 0), against the JAX ``BatchSynthesizer`` on the same bundle: equal
  lengths and int16 samples within 2 (one rounding of each side's float
  output), with the duration-adaptive split (the VITS2 case regroups into
  two decode calls) and with VOSK_TTS_ADAPTIVE=0.
* Per-row knobs: (B, 1, 1) scales through the passes against the JAX
  passes (durations exact) and against the port's own float calls.
* Errors reach every future of a batch; mixed rates stay separate.
* The protoc-free message classes: the same descriptor bytes as protoc's
  for the JAX package, and each side parses the other's messages.
* gRPC on 127.0.0.1 (where grpc is installed), the registry over a
  file:// registry, and ``--list-languages``.
"""

import dataclasses
import json
import shutil
import subprocess
import sys
import threading
import wave
from pathlib import Path

import numpy as np
import pytest

import jax
import torch

from vosk_tts_tpu import api as japi
from vosk_tts_tpu import registry as jreg
from vosk_tts_tpu.models import bert as jbert
from vosk_tts_tpu.models import stabletts as jst
from vosk_tts_tpu.models import vits2 as jv
from vosk_tts_tpu.serving import batcher as jbatcher
from vosk_tts_tpu.text import multistream_symbol_map, plain_symbol_map
from vosk_tts_tpu.utils.checkpoint import save_params
from vosk_tts_tpu_torch import api as tapi
from vosk_tts_tpu_torch import registry as treg
from vosk_tts_tpu_torch.models import bert as tbert
from vosk_tts_tpu_torch.models import stabletts as tst
from vosk_tts_tpu_torch.models import vits2 as tv
from vosk_tts_tpu_torch.serving import batcher as tbatcher
from vosk_tts_tpu_torch.utils import params as tparams
from vosk_tts_tpu_torch.utils.params import perturb_matcha_zero_init, perturb_zero_init

ROOT = Path(__file__).resolve().parent.parent
CFG = dict(inter_channels=32, hidden_channels=32, filter_channels=64, n_layers=3,
           upsample_initial_channel=64, n_speakers=4, gin_channels=16, spec_channels=13)
MS_CFG = dict(n_vocab=207, n_feats=16, n_spks=5, spk_emb_dim=8, hidden_channels=32,
              filter_channels=64, n_heads=2, n_layers=2, phone_emb_dim=12, punc_emb_dim=4,
              bert_dim=24, bert_proj_dim=4, dec_hidden=32, dec_filter=64, dec_layers=2,
              dec_heads=2)
VOC_CFG = dict(inter_channels=16, upsample_initial_channel=64, upsample_rates=(8, 8, 2, 2),
               upsample_kernel_sizes=(16, 16, 4, 4), decoder_type="hifigan", gin_channels=0,
               n_speakers=0)
BERT_CFG = dict(vocab_size=200, hidden_size=24, num_hidden_layers=2, num_attention_heads=2,
                intermediate_size=48, max_position_embeddings=64)
LETTERS = "абвгдежзийклмнопрстуфхцчшщъыьэюяё"
# (text, speaker, speech rate): three lengths at mixed rates; the short fast
# one decodes in its own smaller frame bucket (two decode calls)
REQUESTS = [("Привет мир и всем хорошего дня!", 1, 0.8), ("Привет!", 2, 1.25),
            ("Съешь же ещё этих мягких булок.", 3, 1.0)]
MS_REQUESTS = [("Привет, мир и всем хорошего дня!", 1, 0.9), ("Привет!", 3, 1.25)]
LSB = 2  # int16: one rounding of each side's float output


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write_config(path, config):
    with open(path / "config.json", "w", encoding="utf-8") as f:
        json.dump(config, f, ensure_ascii=False)


@pytest.fixture(scope="module")
def vits2_tree():
    """(JAX config, bundle-layout tree): the port's numpy init, which draws
    the JAX init's structure (tests/test_torch_ops.py) in a fraction of its
    time; both packages load the bundle it is written to."""
    return jv.VITS2Config(**CFG), perturb_zero_init(tparams.synthesizer_init(tv.VITS2Config(**CFG),
                                                                             seed=0), seed=1)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory, vits2_tree):
    jcfg, tree = vits2_tree
    out = tmp_path_factory.mktemp("bundle") / "vosk-model-tts-ru-serving-test"
    out.mkdir()
    save_params(out / "params.npz", tree)
    _write_config(out, {"model_type": "vits2", "sample_rate": 22050,
                        "phoneme_id_map": {k: [v] for k, v in plain_symbol_map().items()},
                        "inference": {}, "model": dataclasses.asdict(jcfg)})
    (out / "dictionary").write_text("привет 1.0 p rj i0 vj e1 t\n", encoding="utf-8")
    return out


@pytest.fixture(scope="module")
def ms_bundle(tmp_path_factory):
    out = tmp_path_factory.mktemp("msbundle") / "vosk-model-tts-ru-ms-serving-test"
    (out / "bert").mkdir(parents=True)
    cfg, vcfg, bcfg = (jst.StableTTSConfig(**MS_CFG), jv.VITS2Config(**VOC_CFG),
                       jbert.BertConfig(**BERT_CFG))
    matcha = perturb_matcha_zero_init(tparams.matcha_init(tst.StableTTSConfig(**MS_CFG), seed=0),
                                      seed=3)
    save_params(out / "params.npz", {
        "matcha": matcha, "vocoder": tparams.hifigan_init(tv.VITS2Config(**VOC_CFG), seed=1)})
    save_params(out / "bert" / "params.npz",
                tparams.bert_init(tbert.BertConfig(**BERT_CFG), seed=2))
    (out / "bert" / "config.json").write_text(json.dumps(dataclasses.asdict(bcfg)))
    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ",", ".", "!"] + list(LETTERS)
             + ["##" + c for c in LETTERS])
    (out / "bert" / "vocab.txt").write_text("\n".join(vocab), encoding="utf-8")
    _write_config(out, {"model_type": "multistream_v3", "sample_rate": 22050, "hop_length": 256,
                        "vocoder": "hifigan", "vocoder_config": dataclasses.asdict(vcfg),
                        "phoneme_id_map": multistream_symbol_map(),
                        "inference": {"n_timesteps": 2}, "model": dataclasses.asdict(cfg)})
    (out / "dictionary").write_text("привет 1.0 p rj i0 vj e1 t\n", encoding="utf-8")
    return out


@pytest.fixture(scope="module")
def port_models(bundle, ms_bundle):
    return {"vits2": tapi.Model(bundle, device="cpu"), "ms": tapi.Model(ms_bundle, device="cpu")}


@pytest.fixture(scope="module")
def jax_models(bundle, ms_bundle):
    return {"vits2": japi.Model(model_path=bundle), "ms": japi.Model(model_path=ms_bundle)}


def _serve(batcher_cls, model, requests, **kw):
    """``requests`` through one batcher with a 500 ms window: returns (int16
    arrays, sizes of the batches run, decode-runner calls)."""
    b = batcher_cls(model, max_batch=4, max_wait_ms=500.0)
    sizes, calls = [], []
    run_batch = b._run_batch
    b._run_batch = lambda items: (sizes.append(len(items)), run_batch(items))[1]
    name = "_ms_decode_runner" if b.multistream else "_decode_runner"
    decode = getattr(b, name)
    setattr(b, name, lambda *a: (calls.append(a[1:]), decode(*a))[1])
    try:
        futures = [b.submit_text(t, sid=s, speech_rate=r, **kw) for t, s, r in requests]
        return [f.result(timeout=600) for f in futures], sizes, calls
    finally:
        b.close()


def _assert_same_audio(got, want):
    for g, w in zip(got, want, strict=True):
        assert g.dtype == np.int16 and len(g) == len(w) > 0 and np.any(w != 0)
        assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= LSB


# ---------------------------------------------------------------------------
# split_decode_groups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multistream", [False, True])
def test_split_decode_groups_matches_jax(multistream):
    """The JAX tests' cases, then 200 seeded random lists (1-8 items, frames
    spread over the ladder, text buckets 32-1024)."""
    cases = ([([300, 310, 290], 64), ([200, 3900, 250], 128)] if multistream else
             [([100, 101, 99], 64), ([90, 100, 1500, 95], 256), ([64, 700, 300, 120, 2000], 256)])
    rng = np.random.default_rng(7 + multistream)
    for _ in range(200):
        n = int(rng.integers(1, 9))
        bucket = int(rng.choice(tapi.TEXT_BUCKETS))
        top = bucket * (tapi.MS_FRAMES_PER_TOKEN if multistream else tapi.FRAMES_PER_TOKEN)
        cases.append(([int(p) for p in np.exp(rng.uniform(0, np.log(top), n))], bucket))
    n_split = 0
    for preds, bucket in cases:
        got = tbatcher.split_decode_groups(preds, bucket, multistream=multistream)
        want = jbatcher.split_decode_groups(preds, bucket, multistream=multistream)
        assert got == want, (preds, bucket)
        assert sorted(i for idx, _, _ in got for i in idx) == list(range(len(preds)))
        n_split += len(got) == 2
    assert n_split >= 20  # the random lists exercise the split, not only one group


def test_batch_geometry_matches_jax(port_models, jax_models):
    """Text bucket and padded rows for 1-9 items of mixed lengths."""
    for max_batch in (1, 4, 8):
        tb = tbatcher.BatchSynthesizer(port_models["vits2"], max_batch=max_batch)
        jb = jbatcher.BatchSynthesizer(jax_models["vits2"], max_batch=max_batch)
        try:
            for n in range(1, 10):
                items = [tbatcher._Item(list(range(1 + 37 * i)), None, None, None, 0, 1.0, 0.8, 0.8)
                         for i in range(n)]
                assert tb._batch_geometry(items) == jb._batch_geometry(items)
        finally:
            tb.close()
            jb.close()


# ---------------------------------------------------------------------------
# per-row knobs through the passes
# ---------------------------------------------------------------------------

def test_row_scales_through_vits2_passes(port_models):
    """(B, 1, 1) knobs through encode_for_infer and decode_from_durations:
    row i's durations equal the float call's at row i's length scale, and
    noise (0, 1, 0) leaves rows 0 and 2 as the noise-0 call gives them (f32,
    1e-6) and changes row 1. (The batcher tests hold these passes, fed the
    same (B, 1, 1) knobs, against the JAX passes.)"""
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 62, (3, 32))
    lengths = np.array([32, 20, 9], np.int32)
    ids *= np.arange(32)[None, :] < lengths[:, None]
    ids, lengths, sid = torch.from_numpy(ids), torch.from_numpy(lengths), torch.tensor([0, 2, 3])
    scale = torch.tensor([0.7, 1.0, 1.6])[:, None, None]
    syn = port_models["vits2"].synthesizer
    with torch.inference_mode():
        enc = syn.encode_for_infer(ids, lengths, sid, length_scale=scale,
                                   noise_scale_w=torch.zeros(3, 1, 1))
        for i in range(3):
            row = syn.encode_for_infer(ids[i:i + 1], lengths[i:i + 1], sid[i:i + 1],
                                       length_scale=float(scale[i]), noise_scale_w=0.0)
            assert torch.equal(row["w_ceil"][0], enc["w_ceil"][i])
        fb = tapi.pick_frame_bucket(int(enc["pred_frames"].max()), 32)
        quiet = syn.decode_from_durations(enc, sid, max_frames=fb, noise_scale=0.0)["wav"]
        noisy = syn.decode_from_durations(enc, sid, max_frames=fb,
                                          noise_scale=torch.tensor([0.0, 1.0, 0.0])[:, None, None],
                                          generator=torch.Generator().manual_seed(0))["wav"]
    torch.testing.assert_close(noisy[[0, 2]], quiet[[0, 2]], rtol=1e-6, atol=1e-6)
    assert float((noisy[1] - quiet[1]).abs().max()) > 1e-3


def test_row_scales_through_stabletts_passes(port_models):
    """A (B, 1, 1) length scale through encode_for_synth: row i's durations
    equal the float call's. Temperatures (0, 1) through decode_from_durations:
    z is drawn at B rows before CFG doubles the batch, so row 0 equals the
    temperature-0 call on row 0 alone (f32, 1e-5) and row 1 does not."""
    model = port_models["ms"]
    x, xl, bert, pde, bucket = (torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                                for a in tapi.multistream_inputs(model, [t for t, _, _ in MS_REQUESTS]))
    sid = torch.tensor([1, 3])
    scale = torch.tensor([0.8, 1.3])[:, None, None]
    m = model.matcha
    with torch.inference_mode():
        enc = m.encode_for_synth(x, xl, sid, bert, length_scale=scale, phone_duration_extra=pde)
        for i in range(2):
            row = m.encode_for_synth(x[i:i + 1], xl[i:i + 1], sid[i:i + 1], bert[i:i + 1],
                                     length_scale=float(scale[i]), phone_duration_extra=pde[i:i + 1])
            assert torch.equal(row["w_round"][0], enc["w_round"][i])
        fb = tapi.pick_ms_frame_bucket(int(enc["pred_frames"].max()), bucket)
        both = m.decode_from_durations(enc, sid, max_frames=fb, n_timesteps=2,
                                       temperature=torch.tensor([0.0, 1.0])[:, None, None],
                                       generator=torch.Generator().manual_seed(0))["mel"]
        rows = [m.decode_from_durations({k: v[i:i + 1] for k, v in enc.items()}, sid[i:i + 1],
                                        max_frames=fb, n_timesteps=2, temperature=0.0)["mel"]
                for i in range(2)]
    torch.testing.assert_close(both[:1], rows[0], rtol=1e-5, atol=1e-5)
    assert float((both[1:] - rows[1]).abs().max()) > 1e-2


@pytest.mark.parametrize("zeros_after", [0, 4, 8, 16, 32])
def test_decode_tail_sets_last_frames(port_models, zeros_after):
    """The generator is not mask-aware (in both packages): the last frames
    of an utterance depend on how many zero frames follow it in its decode
    call, which is why a request batched behind a longer one can end
    differently from the same request alone. Relative to 64 zero frames
    after: none changes the last frames by a large share of the peak, 4 by
    less, 8 or more by under 1e-3 (printed with -s)."""
    syn = port_models["vits2"].synthesizer
    ids = tapi.encode_plain(port_models["vits2"], REQUESTS[2][0])
    x = torch.zeros((1, 128), dtype=torch.int64)
    x[0, :len(ids)] = torch.tensor(ids)
    sid = torch.tensor([1])
    with torch.inference_mode():
        enc = syn.encode_for_infer(x, torch.tensor([len(ids)], dtype=torch.int32), sid,
                                   noise_scale_w=0.0)
        pred = int(enc["pred_frames"][0])
        wav = {n: syn.decode_from_durations(enc, sid, max_frames=pred + 64, noise_scale=0.0,
                                            gen_frames=pred + n)["wav"][0, :, 0]
               for n in (zeros_after, 64)}
    n = pred * port_models["vits2"].model_config.upsample_factor
    ref = wav[64][:n]
    rel = float((wav[zeros_after][:n] - ref).abs().max() / ref.abs().max())
    print(f"{zeros_after} zero frames after {pred}: max |diff| / peak {rel:.3g}")
    assert rel > 0.05 if zeros_after == 0 else rel < (1e-2 if zeros_after == 4 else 1e-3)


# ---------------------------------------------------------------------------
# the batcher against the JAX batcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("adaptive", ["1", "0"])
def test_batcher_vits2_matches_jax(port_models, jax_models, monkeypatch, adaptive):
    monkeypatch.setenv("VOSK_TTS_ADAPTIVE", adaptive)
    kw = dict(noise_level=0.0, duration_noise_level=0.0)
    want, j_sizes, j_calls = _serve(jbatcher.BatchSynthesizer, jax_models["vits2"], REQUESTS, **kw)
    got, sizes, calls = _serve(tbatcher.BatchSynthesizer, port_models["vits2"], REQUESTS, **kw)
    assert sizes == j_sizes == [3]
    assert calls == j_calls
    if adaptive == "1":
        assert len(calls) == 2 and len({fb for fb, _ in calls}) == 2, calls  # regrouped
    else:
        assert calls == []
    _assert_same_audio(got, want)


@pytest.mark.parametrize("adaptive", ["1", "0"])
def test_batcher_multistream_matches_jax(port_models, jax_models, monkeypatch, adaptive):
    monkeypatch.setenv("VOSK_TTS_ADAPTIVE", adaptive)
    want, j_sizes, j_calls = _serve(jbatcher.BatchSynthesizer, jax_models["ms"], MS_REQUESTS,
                                    noise_level=0.0)
    got, sizes, calls = _serve(tbatcher.BatchSynthesizer, port_models["ms"], MS_REQUESTS,
                               noise_level=0.0)
    assert sizes == j_sizes == [2] and calls == j_calls
    assert len(calls) == (2 if adaptive == "1" else 0), calls  # adaptive: regrouped
    _assert_same_audio(got, want)
    assert all(len(a) % 256 == 0 for a in got)


def test_batcher_mixed_rates_in_one_batch(port_models):
    """The same text at rates 0.5 and 4.0 in one batch keeps each rate: each
    row equals its own single-request synthesis (noise 0, within 2), and
    those two differ in length (durations of at least one frame a token
    keep the random model's fast one above an eighth of the slow one)."""
    reqs = [("Привет мир!", 1, 0.5), ("Привет мир!", 1, 4.0)]
    got, sizes, _ = _serve(tbatcher.BatchSynthesizer, port_models["vits2"], reqs,
                           noise_level=0.0, duration_noise_level=0.0)
    assert sizes == [2]
    synth = tapi.Synth(port_models["vits2"])
    want = [synth.synth_audio(t, speaker_id=s, speech_rate=r, noise_level=0.0,
                              duration_noise_level=0.0) for t, s, r in reqs]
    assert len(want[0]) > len(want[1])
    _assert_same_audio(got, want)


def test_batch_error_reaches_every_future(port_models):
    """A batch whose pass raises sets that exception on each of its futures
    (no retry, no fallback), and the worker goes on serving."""
    b = tbatcher.BatchSynthesizer(port_models["vits2"], max_batch=4, max_wait_ms=500.0)
    encode = b._encode_runner

    def broken():
        def run(*args):
            raise RuntimeError("kernel failed")
        return run

    b._encode_runner = broken
    try:
        futures = [b.submit_text(t, sid=s, speech_rate=r) for t, s, r in REQUESTS]
        for f in futures:
            with pytest.raises(RuntimeError, match="kernel failed"):
                f.result(timeout=60)
        b._encode_runner = encode
        ids = tapi.encode_plain(port_models["vits2"], "Привет!")
        audio = b.submit(ids, sid=1).result(timeout=120)  # pre-encoded ids
        assert audio.dtype == np.int16 and len(audio) > 0
    finally:
        b.close()
    assert not b._thread.is_alive()


# ---------------------------------------------------------------------------
# imports and the wire
# ---------------------------------------------------------------------------

def _run(code, env=None):
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, timeout=120, env=env)


def test_batcher_imports_without_grpc_or_protobuf():
    r = _run("import sys\n"
             "sys.modules['grpc'] = None\n"
             "sys.modules['google.protobuf'] = None\n"
             "from vosk_tts_tpu_torch.serving import batcher\n"
             "assert callable(batcher.BatchSynthesizer)\n"
             "print(sorted(m for m in sys.modules if m.startswith(('grpc', 'google.protobuf'))"
             " and sys.modules[m] is not None))")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_hygiene_walk_reaches_serving_and_registry():
    """tests/test_torch_hygiene.py imports every module pkgutil walks in the
    port and checks that none brings in JAX or the JAX package: the walk
    reaches the serving subpackage and the registry, so those checks cover
    them."""
    import pkgutil

    import vosk_tts_tpu_torch as pkg

    names = {m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")}
    assert {"vosk_tts_tpu_torch.registry", "vosk_tts_tpu_torch.serving.batcher",
            "vosk_tts_tpu_torch.serving.proto", "vosk_tts_tpu_torch.serving.server",
            "vosk_tts_tpu_torch.serving.client"} <= names


def test_proto_needs_no_protoc(tmp_path):
    """proto.py builds its classes with no protoc on PATH, and spawns no
    process."""
    r = _run("import subprocess\n"
             "def refuse(*a, **k):\n"
             "    raise AssertionError('a process was started')\n"
             "subprocess.run = subprocess.Popen = refuse\n"
             "from vosk_tts_tpu_torch.serving import proto\n"
             "print(proto.UtteranceSynthesisRequest(text='x').SerializeToString().hex())",
             env={"PATH": str(tmp_path), "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "120178"  # field 2 (text), length 1, "x"


def test_descriptor_matches_protoc():
    """The port's FileDescriptorProto is byte for byte the one protoc wrote
    for the JAX package (fields, numbers, types, labels, oneofs, enums,
    json names, the service); and each message's fields agree by name,
    number, type and oneof through the built classes."""
    from google.protobuf import descriptor_pb2

    from vosk_tts_tpu.serving import proto as jp
    from vosk_tts_tpu_torch.serving import proto as tp

    fds = descriptor_pb2.FileDescriptorSet.FromString(Path(jp.DESC).read_bytes())
    assert tp.file_descriptor().SerializeToString() == fds.file[0].SerializeToString()
    for name in ("UtteranceSynthesisRequest", "UtteranceSynthesisResponse", "AudioChunk", "Hints",
                 "AudioFormatOptions", "RawAudio", "ContainerAudio"):
        fields = lambda d: [(f.name, f.number, f.type, f.is_repeated,
                             f.containing_oneof.name if f.containing_oneof else None)
                            for f in d.fields]
        jd, td = getattr(jp, name).DESCRIPTOR, getattr(tp, name).DESCRIPTOR
        assert td.full_name == jd.full_name == f"vosk.tts.{name}"
        assert fields(td) == fields(jd)
    assert (tp.SERVICE_NAME, tp.METHOD) == (jp.SERVICE_NAME, jp.METHOD)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_messages_cross_parse(direction):
    from vosk_tts_tpu.serving import proto as jp
    from vosk_tts_tpu_torch.serving import proto as tp

    src, dst = (tp, jp) if direction == "port_to_jax" else (jp, tp)
    req = src.UtteranceSynthesisRequest(text="Привет, мир!", model="ru")
    req.hints.add(speaker_id=3)
    req.hints.add(speech_rate=1.25)
    req.hints.add(role="narrator")
    req.output_audio_spec.raw_audio.sample_rate_hertz = 22050
    req.output_audio_spec.raw_audio.audio_encoding = 1
    back = dst.UtteranceSynthesisRequest.FromString(req.SerializeToString())
    assert back.text == "Привет, мир!" and back.model == "ru"
    assert [h.WhichOneof("Hint") for h in back.hints] == ["speaker_id", "speech_rate", "role"]
    assert (back.hints[0].speaker_id, back.hints[1].speech_rate, back.hints[2].role) == (
        3, 1.25, "narrator")
    assert back.output_audio_spec.WhichOneof("AudioFormat") == "raw_audio"
    assert back.output_audio_spec.raw_audio.sample_rate_hertz == 22050
    assert back.SerializeToString() == req.SerializeToString()

    wav_spec = src.AudioFormatOptions(container_audio=src.ContainerAudio(container_audio_type=1))
    assert dst.AudioFormatOptions.FromString(
        wav_spec.SerializeToString()).container_audio.container_audio_type == 1
    resp = src.UtteranceSynthesisResponse(audio_chunk=src.AudioChunk(data=b"\x01\x02\x03"))
    assert dst.UtteranceSynthesisResponse.FromString(
        resp.SerializeToString()).audio_chunk.data == b"\x01\x02\x03"


@pytest.mark.parametrize("kind", ["vits2", "ms"])
def test_grpc_server_serves_both_bundle_kinds(port_models, kind, tmp_path):
    """make_server on 127.0.0.1, port 0: one request, then 4 concurrent ones
    (co-batched), each a WAV at 22050 Hz whose frame count is the data's;
    headerless PCM when raw audio is asked for."""
    pytest.importorskip("grpc")
    from vosk_tts_tpu_torch.serving import proto
    from vosk_tts_tpu_torch.serving.client import SynthesizerClient
    from vosk_tts_tpu_torch.serving.server import make_server

    server, servicer, port = make_server(port_models[kind], interface="127.0.0.1", port=0,
                                         threads=4)
    server.start()
    client = SynthesizerClient(f"127.0.0.1:{port}")
    try:
        results = {}

        def one(i):
            results[i] = client.synthesize("Привет мир!", speaker_id=i % 4, speech_rate=1.0)

        one(4)
        threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)

        req = proto.UtteranceSynthesisRequest(text="Привет мир!")
        req.hints.add(speaker_id=0)
        req.output_audio_spec.raw_audio.sample_rate_hertz = 22050
        raw = b"".join(r.audio_chunk.data for r in client._call(req, timeout=300))
    finally:
        client.close()
        server.stop(0)
        servicer.batcher.close()
    assert len(results) == 5
    for i, data in results.items():
        assert data[:4] == b"RIFF"
        path = tmp_path / f"{i}.wav"
        path.write_bytes(data)
        with wave.open(str(path)) as f:
            assert f.getframerate() == 22050 and f.getnchannels() == 1
            assert f.getnframes() == (len(data) - 44) // 2 > 1000
    assert raw[:4] != b"RIFF" and len(raw) % 2 == 0 and len(raw) > 2000


# ---------------------------------------------------------------------------
# registry and CLI
# ---------------------------------------------------------------------------

@pytest.fixture
def registry(bundle, tmp_path, monkeypatch):
    """A file:// registry in tmp_path holding the bundle's zip under three
    entries: an obsolete "small" ru one listed first, the live one, and an
    en "big" one."""
    reg = tmp_path / "registry"
    reg.mkdir()
    name = bundle.name
    shutil.make_archive(str(reg / name), "zip", root_dir=bundle.parent, base_dir=name)
    (reg / "model-list.json").write_text(json.dumps([
        {"name": "vosk-model-tts-ru-old", "lang": "ru", "type": "small", "obsolete": "true"},
        {"name": "other-model", "lang": "en", "type": "big", "obsolete": "false"},
        {"name": name, "lang": "ru", "type": "small", "obsolete": "false"},
        {"name": "vosk-model-tts-kz", "lang": "kz", "type": "small", "obsolete": "false"},
    ]), encoding="utf-8")
    monkeypatch.setenv("VOSK_TTS_REGISTRY", f"file://{reg}")
    return reg, name


def test_registry_resolves_as_jax(registry, tmp_path, monkeypatch):
    _, name = registry
    models = treg.model_list()
    assert models == jreg.model_list()
    for lang in ("ru", "en", "kz", "de"):
        assert treg.select_by_lang(models, lang) == jreg.select_by_lang(models, lang)
    assert treg.select_by_lang(models, "ru")["name"] == name  # the obsolete entry is skipped
    assert treg.select_by_name(models, "other-model") == jreg.select_by_name(models, "other-model")

    by_name = treg.resolve(name, None, [str(tmp_path / "c1")])
    assert by_name == tmp_path / "c1" / name
    assert jreg.resolve(name, None, [str(tmp_path / "c2")]) == tmp_path / "c2" / name
    assert (by_name / "config.json").exists() and not (tmp_path / "c1" / f"{name}.zip").exists()
    by_lang = treg.resolve(None, "ru", [str(tmp_path / "c3")])
    assert by_lang.name == jreg.resolve(None, "ru", [str(tmp_path / "c4")]).name == name
    with pytest.raises(FileNotFoundError):
        treg.resolve("no-such-model", None, [str(tmp_path / "c5")])

    # Model() by lang with an empty cache pulls from the registry; the
    # second load finds the local copy with no registry set
    monkeypatch.setattr(tapi, "MODEL_DIRS", [str(tmp_path / "cache")])
    model = tapi.Model(lang="ru", device="cpu")
    assert model.path == tmp_path / "cache" / name and model.synthesizer is not None
    monkeypatch.delenv("VOSK_TTS_REGISTRY")
    assert tapi.Model(model_name=name, device="cpu").path == model.path


def test_registry_refuses_path_traversal(tmp_path, monkeypatch):
    import zipfile

    reg = tmp_path / "registry"
    reg.mkdir()
    with zipfile.ZipFile(reg / "evil.zip", "w") as zf:
        zf.writestr("evil/config.json", "{}")
        zf.writestr("../cache-escape/x", "x")
    with pytest.raises(ValueError, match="unsafe path"):
        treg.download_model("evil", tmp_path / "cache", base_url=f"file://{reg}")
    assert not (tmp_path / "cache-escape").exists()


def test_cli_lists_languages(registry, capsys, monkeypatch):
    from vosk_tts_tpu import cli as jcli
    from vosk_tts_tpu_torch import cli as tcli

    tcli.main(["--list-languages"])
    got = capsys.readouterr().out
    jcli.main(["--list-languages"])
    assert got == capsys.readouterr().out == "en\nkz\nru\n"
    monkeypatch.delenv("VOSK_TTS_REGISTRY")
    tcli.main(["--list-languages"])
    assert capsys.readouterr().out == "ru\n"
    args = tcli.build_parser().parse_args(["-l", "kz", "-i", "x"])
    assert (args.lang, args.model, args.model_name) == ("kz", None, None)
