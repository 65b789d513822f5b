"""The serving batcher of the port on the card.

Marked ``cuda``: each test skips where there is no NVIDIA GPU. This file
imports no JAX, so on a machine with the card and without JAX it runs as
``python -m pytest tests/test_torch_cuda_serving.py -m cuda --noconftest``.
Small bundles (the port's numpy inits, zero-initialised projections
perturbed; head dim 32 in every attention, the SDP's DDSConv at 256
channels) go through ``BatchSynthesizer`` on the card with the plain
versions of the kernels refused: five requests of mixed lengths, speakers
and rates forced into one batch at noise 0. Each kernel's launches follow
the serving formula (per encode call and per decode group, from the
config), and every row matches the same batch served on the CPU: equal
length, int16 within 1e-3 x peak plus one step (f32 on both sides, other
summation orders; both truncate float audio).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from vosk_tts_tpu_torch import api
from vosk_tts_tpu_torch.models import bert, stabletts, vits2
from vosk_tts_tpu_torch.ops import ddsconv_fused as ddf
from vosk_tts_tpu_torch.ops import flash_attention as fa
from vosk_tts_tpu_torch.serving.batcher import BatchSynthesizer
from vosk_tts_tpu_torch.text import multistream_symbol_map, plain_symbol_map
from vosk_tts_tpu_torch.utils.checkpoint import save_params
from vosk_tts_tpu_torch.utils.params import (bert_init, hifigan_init, matcha_init,
                                             perturb_matcha_zero_init, perturb_zero_init,
                                             synthesizer_init)

VITS2_CFG = dict(inter_channels=32, hidden_channels=64, filter_channels=128, n_layers=2,
                 upsample_initial_channel=64, n_speakers=4, gin_channels=16, spec_channels=13)
# phone 44 + 4 punctuation streams x 4 + BERT projection 4 = hidden 64
MS_CFG = dict(n_feats=16, n_spks=5, spk_emb_dim=8, hidden_channels=64, filter_channels=128,
              n_heads=2, n_layers=2, phone_emb_dim=44, punc_emb_dim=4, bert_dim=24,
              bert_proj_dim=4, dec_hidden=64, dec_filter=128, dec_layers=2, dec_heads=2)
VOC_CFG = dict(inter_channels=16, upsample_initial_channel=64, upsample_rates=(8, 8, 2, 2),
               upsample_kernel_sizes=(16, 16, 4, 4), decoder_type="hifigan", gin_channels=0,
               n_speakers=0)
BERT_CFG = dict(vocab_size=200, hidden_size=24, num_hidden_layers=2, num_attention_heads=2,
                intermediate_size=48, max_position_embeddings=512)
LETTERS = "абвгдежзийклмнопрстуфхцчшщъыьэюяё"
N_TIMESTEPS = 3
REQUESTS = [("Привет мир!", 0, 1.0), ("Сегодня хорошая погода, и мы идём гулять в парк.", 1, 0.8),
            ("Мама мыла раму.", 2, 1.25), ("Привет!", 3, 2.0),
            ("Съешь же ещё этих мягких французских булок, да выпей чаю.", 1, 1.0)]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _config(path, config):
    with open(path / "config.json", "w", encoding="utf-8") as f:
        json.dump(config, f, ensure_ascii=False)
    (path / "dictionary").write_text("привет 1.0 p rj i0 vj e1 t\n", encoding="utf-8")


@pytest.fixture(scope="module")
def bundles(dev, tmp_path_factory):
    root = tmp_path_factory.mktemp("cuda-serving")
    plain = root / "vits2"
    plain.mkdir()
    cfg = vits2.VITS2Config(**VITS2_CFG)
    save_params(plain / "params.npz", perturb_zero_init(synthesizer_init(cfg, seed=0), seed=1))
    _config(plain, {"model_type": "vits2", "sample_rate": 22050,
                    "phoneme_id_map": {k: [v] for k, v in plain_symbol_map().items()},
                    "inference": {}, "model": dataclasses.asdict(cfg)})

    ms = root / "ms"
    (ms / "bert").mkdir(parents=True)
    mcfg, vcfg = stabletts.StableTTSConfig(**MS_CFG), vits2.VITS2Config(**VOC_CFG)
    save_params(ms / "params.npz", {
        "matcha": perturb_matcha_zero_init(matcha_init(mcfg, seed=0), seed=1),
        "vocoder": hifigan_init(vcfg, seed=2)})
    bcfg = bert.BertConfig(**BERT_CFG)
    save_params(ms / "bert" / "params.npz", bert_init(bcfg, seed=3))
    (ms / "bert" / "config.json").write_text(json.dumps(dataclasses.asdict(bcfg)))
    (ms / "bert" / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ",", ".", "!", "?"] + list(LETTERS)
        + ["##" + c for c in LETTERS]), encoding="utf-8")
    _config(ms, {"model_type": "multistream_v3", "sample_rate": 22050, "hop_length": 256,
                 "vocoder": "hifigan", "vocoder_config": dataclasses.asdict(vcfg),
                 "phoneme_id_map": multistream_symbol_map(),
                 "inference": {"n_timesteps": N_TIMESTEPS}, "model": dataclasses.asdict(mcfg)})
    return {"vits2": plain, "ms": ms}


def _refuse(*a, **k):
    raise AssertionError("plain version reached with CUDA tensors")


def _serve(model):
    """REQUESTS at noise 0 in one batch: (audio, encode calls, decode groups)."""
    b = BatchSynthesizer(model, max_batch=8, max_wait_ms=1000.0)
    batches, groups = [], []
    run_batch = b._run_batch
    b._run_batch = lambda items: (batches.append(len(items)), run_batch(items))[1]
    name = "_ms_decode_runner" if b.multistream else "_decode_runner"
    decode = getattr(b, name)
    setattr(b, name, lambda *a: (groups.append(a), decode(*a))[1])
    try:
        futures = [b.submit_text(t, sid=s, speech_rate=r, noise_level=0.0,
                                 duration_noise_level=0.0) for t, s, r in REQUESTS]
        audio = [f.result(timeout=600) for f in futures]
    finally:
        b.close()
    assert batches == [len(REQUESTS)] and not b._thread.is_alive()
    return audio, len(batches), len(groups)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["vits2", "ms"])
def test_batcher_on_the_card(dev, bundles, monkeypatch, kind):
    want, _, _ = _serve(api.Model(bundles[kind], device="cpu"))
    model = api.Model(bundles[kind])
    assert model.device.type == "cuda"
    for name in ("banded_attention_plain", "global_attention_plain"):
        monkeypatch.setattr(fa, name, _refuse)
    monkeypatch.setattr(ddf, "ddsconv_plain", _refuse)
    kernels = {"banded": fa.KERNEL, "ddsconv": ddf.KERNEL, "rope": fa.GLOBAL_ROPE_KERNEL,
               "packed": fa.GLOBAL_PACKED_KERNEL, "separate": fa.GLOBAL_KERNEL}
    before = {n: k.launches for n, k in kernels.items()}
    got, encodes, groups = _serve(model)
    launches = {n: k.launches - before[n] for n, k in kernels.items()}
    if kind == "vits2":  # text encoder layers; one flow attention a coupling layer; SDP's 4 stacks
        flows = len(model.synthesizer.params["flow"]["flows"])
        expected = {"banded": VITS2_CFG["n_layers"] * encodes + flows * groups,
                    "ddsconv": 4 * encodes}
        multiple = model.model_config.upsample_factor
    else:  # the two DiT text encoders; the decoder's layers at each Euler step
        expected = {"rope": 2 * MS_CFG["n_layers"] * encodes
                    + MS_CFG["dec_layers"] * N_TIMESTEPS * groups}
        multiple = 256
    assert launches == {n: expected.get(n, 0) for n in kernels}, (launches, encodes, groups)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == np.int16 and len(g) == len(w) > 0 and len(g) % multiple == 0
        peak = int(np.abs(w.astype(np.int32)).max())
        assert peak > 0
        assert int(np.abs(g.astype(np.int32) - w.astype(np.int32)).max()) <= 1e-3 * peak + 1


@pytest.mark.cuda
def test_synth_batch_runs_the_models_own_synthesizer(dev, bundles):
    """``synth_batch`` with its default devices runs shard 0 on the model's
    own synthesizer and generator (``Model()``'s ``cuda`` is resolved to
    ``cuda:N``, so it equals the visible card's device); a copy is made
    only for the other cards."""
    model = api.Model(bundles["vits2"])
    assert model.device == torch.device("cuda", torch.cuda.current_device())
    synth = api.Synth(model)
    syn, gen = synth._replica(0, "cuda")
    assert syn is model.synthesizer and gen is synth.generator
    out = synth.synth_batch([t for t, _, _ in REQUESTS[:3]], noise_level=0.0,
                            duration_noise_level=0.0)
    assert len(out) == 3 and all(len(a) > 0 for a in out)
    assert set(synth._replicas) == {(i, torch.device("cuda", i))
                                    for i in range(1, torch.cuda.device_count())}
