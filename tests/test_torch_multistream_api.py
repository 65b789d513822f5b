"""The multistream_v3 serving path of the PyTorch port vs the JAX package.

A tiny multistream_v3 bundle written by the JAX package (StableTTS at the
widths of tests/test_multistream_api.py, with the zero-initialised adaLN-Zero
projections and CFG fakes perturbed; a HiFiGAN vocoder; a tiny BERT and
WordPiece vocabulary) goes through both packages' ``Model``/``Synth.
synth_audio`` on the CPU at noise level 0: equal length, int16 samples
within 2 (one rounding of each side's float output). The parts: the copied
``g2p_multistream``, the port's own WordPiece tokenizer against the
``tokenizers`` package, BERT hidden states and the HiFiGAN vocoder, each in
f32 within the stated tolerance.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import torch

from vosk_tts_tpu import api as japi
from vosk_tts_tpu.models import bert as jbert
from vosk_tts_tpu.models import stabletts as jst
from vosk_tts_tpu.models import vocoder as jvoc
from vosk_tts_tpu.models.vits2 import VITS2Config as JVITS2Config
from vosk_tts_tpu.text import frontend as jfront
from vosk_tts_tpu.text import multistream_symbol_map as j_ms_map
from vosk_tts_tpu.utils.checkpoint import save_params
from vosk_tts_tpu_torch import api as tapi
from vosk_tts_tpu_torch.models import bert as tbert
from vosk_tts_tpu_torch.models import vits2 as tv
from vosk_tts_tpu_torch.models import vocoder as tvoc
from vosk_tts_tpu_torch.text import PHONES, WordPieceTokenizer, g2p_multistream, multistream_symbol_map
from vosk_tts_tpu_torch.utils.params import perturb_matcha_zero_init, to_port_layout, to_torch

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
VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + list(LETTERS) + ["##" + c for c in LETTERS]
         + ["при", "##вет", "мир", "hello", "##world", ",", ".", "!", "-", "a", "##b", "é"])
TEXT = "Привет, мир _ и всем хорошего дня!"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    out = tmp_path_factory.mktemp("msbundle") / "multistream-v3-port-test"
    (out / "bert").mkdir(parents=True)
    cfg = jst.StableTTSConfig(**MS_CFG)
    matcha = perturb_matcha_zero_init(jax.device_get(jst.matcha_init(jax.random.PRNGKey(0), cfg)),
                                      seed=3)
    vcfg = JVITS2Config(**VOC_CFG)
    save_params(out / "params.npz", {"matcha": matcha,
                                     "vocoder": jvoc.hifigan_init(jax.random.PRNGKey(1), vcfg)})
    bcfg = jbert.BertConfig(**BERT_CFG)
    save_params(out / "bert" / "params.npz", jbert.bert_init(jax.random.PRNGKey(2), bcfg))
    (out / "bert" / "config.json").write_text(json.dumps(dataclasses.asdict(bcfg)))
    (out / "bert" / "vocab.txt").write_text("\n".join(VOCAB), encoding="utf-8")
    with open(out / "config.json", "w", encoding="utf-8") as f:
        json.dump({"model_type": "multistream_v3", "sample_rate": 22050, "hop_length": 256,
                   "vocoder": "hifigan", "vocoder_config": dataclasses.asdict(vcfg),
                   "phoneme_id_map": j_ms_map(), "inference": {"n_timesteps": 3},
                   "model": dataclasses.asdict(cfg)}, f, ensure_ascii=False)
    (out / "dictionary").write_text("привет 1.0 p rj i0 vj e1 t\n", encoding="utf-8")
    return out


@pytest.mark.parametrize("adaptive", ["1", "0"])
def test_synth_audio_end_to_end(bundle, monkeypatch, adaptive):
    """Both packages' Model/Synth on one bundle, at noise level 0 (the ODE
    starts from z = 0): the split path and, with VOSK_TTS_ADAPTIVE=0, the
    single pass at the worst-case frame capacity."""
    monkeypatch.setenv("VOSK_TTS_ADAPTIVE", adaptive)
    kw = dict(speaker_id=1, noise_level=0.0, speech_rate=0.9)
    want = japi.Synth(japi.Model(model_path=bundle)).synth_audio(TEXT, **kw)
    model = tapi.Model(bundle, device="cpu")
    assert model.bert is not None and model.tokenizer is not None
    got = tapi.Synth(model).synth_audio(TEXT, **kw)
    assert got.dtype == np.int16 and len(got) == len(want) > 0 and np.any(want != 0)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 2


def test_synth_writes_wav_and_refuses_batch(bundle, tmp_path):
    import wave

    synth = tapi.Synth(tapi.Model(bundle, device="cpu"))
    synth.synth("Привет мир!", tmp_path / "out.wav", speaker_id=2)
    with wave.open(str(tmp_path / "out.wav")) as f:
        assert f.getframerate() == 22050 and f.getnframes() > 0
    with pytest.raises(NotImplementedError):
        synth.synth_batch(["Привет мир!"])


def test_unported_vocoder_is_refused(bundle, tmp_path):
    """A vocoder name other than hifigan, vocos and bigvgan is refused (the
    JAX loader would build a HiFiGAN for it)."""
    cfg = json.loads((bundle / "config.json").read_text(encoding="utf-8"))
    cfg["vocoder"] = "wavenet"
    (tmp_path / "config.json").write_text(json.dumps(cfg), encoding="utf-8")
    with pytest.raises(ValueError, match="wavenet"):
        tapi.Model(tmp_path, device="cpu")


def test_ms_frame_buckets_match_jax():
    assert (tapi.MS_FRAMES_PER_TOKEN, tapi.MS_FRAMES_CAP) == (japi.MS_FRAMES_PER_TOKEN,
                                                              japi.MS_FRAMES_CAP)
    for pred, tb in ((1, 32), (500, 32), (1600, 32), (3000, 128), (10**6, 1024), (700, 64)):
        assert tapi.pick_ms_frame_bucket(pred, tb) == japi.pick_ms_frame_bucket(pred, tb)


@pytest.mark.parametrize("text", [
    "Привет, мир _ и всем!", 'Он сказал: "Иди домой" - и ушёл...', "Москва - столица России.",
    "Да... нет? Может быть! _ Тишина; и (скобки)", "мама мыла раму\nвторая строка -тире"])
@pytest.mark.parametrize("word_pos,pauses,aligned", [(True, True, False), (False, False, False),
                                                     (True, False, True)])
def test_g2p_multistream_copy(text, word_pos, pauses, aligned):
    dic = {"привет": "p rj i0 vj e1 t"}
    if aligned:
        text = "p_rj_i0 a1_b, m_a1!"
    id_map = multistream_symbol_map()
    assert id_map == j_ms_map()
    id_map |= {p: 300 + i for i, p in enumerate(PHONES)}  # bare phones, for word_pos=False
    bert = [f"word {i}" for i in range(40)]  # rows stand for BERT vectors: which word each phone takes
    kw = dict(word_pos=word_pos, pause_markers=pauses, aligned=aligned)
    assert g2p_multistream(text, dic, id_map, bert, **kw) == jfront.g2p_multistream(
        text, dic, id_map, bert, **kw)


@pytest.mark.parametrize("text", [
    "привет, мир!", "ёлка и йогурт: Йошкар-Ола", "HelloWorld hello, Café naïve", "x" * 120,
    "неизвестноеслово 123 и [SEP] и [UNK]", "«кавычки» — тире … “quotes” 中文", "", "а\tб\nв\x07г"])
def test_wordpiece_matches_tokenizers(tmp_path, text):
    tokenizers = pytest.importorskip("tokenizers")
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(VOCAB), encoding="utf-8")
    ref = tokenizers.implementations.BertWordPieceTokenizer(vocab=str(vocab), unk_token="[UNK]",
                                                            lowercase=True).encode(text)
    got = WordPieceTokenizer(vocab).encode(text)
    assert (got.ids, got.tokens, got.attention_mask, got.type_ids) == (
        ref.ids, ref.tokens, ref.attention_mask, ref.type_ids)


def test_bert_hidden_states(bundle):
    """Every hidden state of the port's BERT against bert_apply (f32, 2e-5:
    layer norms with eps 1e-12 over 24 features)."""
    params = jax.device_get(jbert.bert_init(jax.random.PRNGKey(2), jbert.BertConfig(**BERT_CFG)))
    cfg = json.loads((bundle / "bert" / "config.json").read_text())
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 200, (2, 20)).astype(np.int32)
    mask = (np.arange(20)[None, :] < np.array([[20], [13]])).astype(np.int32)
    types = np.zeros_like(ids)
    want = jbert.bert_apply(params, jbert.BertConfig(**BERT_CFG), ids, mask, types)
    port = to_torch(to_port_layout(params), "cpu")
    got = tbert.bert_apply(port, tbert.BertConfig.from_hf(cfg), *(torch.from_numpy(a) for a in
                                                                   (ids, mask, types)))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=2e-5)
    enc = tbert.BertEncoder(port, cfg)  # one sequence, padded to its length bucket
    np.testing.assert_allclose(enc(ids[1, :13].tolist(), [1] * 13, [0] * 13).numpy(),
                               np.stack([np.asarray(h)[1, :13] for h in want]), rtol=2e-5, atol=2e-5)


def test_hifigan_vocoder():
    """HiFiGAN v1 structure at 64 channels: trunk, bias-free conv_post,
    tanh, clip; 1e-5 (f32 through 4 upsampling stages)."""
    jcfg = JVITS2Config(**VOC_CFG)
    params = jax.device_get(jvoc.hifigan_init(jax.random.PRNGKey(1), jcfg))
    mel = np.random.default_rng(1).standard_normal((2, 12, 16)).astype(np.float32) * 3
    want = jvoc.hifigan_apply(params, mel, jcfg)
    tcfg = tv.VITS2Config(**VOC_CFG)
    got = tvoc.hifigan_apply(to_torch(to_port_layout(params), "cpu"), torch.from_numpy(mel), tcfg)
    assert got.shape == want.shape == (2, 12 * 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert tvoc.hifigan_v1_config() == tv.VITS2Config.from_dict(
        dataclasses.asdict(jvoc.hifigan_v1_config()))
