"""Public API of the port: ``Model`` + ``Synth`` (vosk_tts_tpu/api.py), for
plain ``vits2`` bundles and multistream (StableTTS) bundles. As in the JAX
package, a bundle of any ``model_type`` other than ``multistream_v1/v2/v3``
loads as a VITS2 bundle.

A bundle directory holds ``config.json`` (``model_type``, ``phoneme_id_map``,
``inference`` defaults, the ``model`` architecture block, ``sample_rate``),
``params.npz`` (the JAX package's parameter tree) and ``dictionary``. A
VITS2 bundle may hold any configuration the JAX ``Synthesizer`` runs
(every flow type, duration predictor and decoder). A
``multistream_v1/v2/v3`` bundle's ``params.npz`` holds ``{"matcha",
"vocoder"}``, its config names the ``vocoder`` (``hifigan``, the default,
``vocos`` or ``bigvgan``, with an optional ``vocoder_config`` block) and
its ``bert/`` directory (``config.json``, ``params.npz``, ``vocab.txt``)
the ruBERT front.

Entry points run on the card: ``Model(path)`` means ``device="cuda"`` and
raises where CUDA is missing; pass ``device="cpu"`` to run the plain
versions of the kernels on the CPU.

Bucket ladder: text lengths are padded to ``TEXT_BUCKETS`` and the decode
pass runs at a frame bucket picked from the duration pass
(``FRAME_BUCKETS``), exactly as the JAX package does. PyTorch has no static
shapes, but the same buckets keep the two packages' shapes equal (so their
outputs compare like with like) and bound the set of shapes a CUDA graph
would have to be captured for.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import re
import time
import wave
from pathlib import Path

import numpy as np
import torch

from .models import bigvgan, stabletts, vits2
from .models import vocoder as voc
from .models.bert import BertEncoder
from .models.tree import TreeModule
from .text import WordPieceTokenizer, g2p_multistream, g2p_plain, load_dictionary
from .utils.checkpoint import load_params
from .utils.params import to_port_layout
from .utils.precision import full_float32

MULTISTREAM_TYPES = ("multistream_v1", "multistream_v2", "multistream_v3")

MODEL_DIRS = [
    os.getenv("VOSK_TPU_MODEL_PATH"),
    os.getenv("VOSK_MODEL_PATH"),
    "/usr/share/vosk",
    str(Path.home() / ".cache/vosk-tpu"),
    str(Path.home() / ".cache/vosk"),
]

#: text-length buckets (tokens incl. blanks)
TEXT_BUCKETS = (32, 64, 128, 256, 384, 512, 768, 1024)
#: output frame capacity per text token (worst case; durations are clipped)
FRAMES_PER_TOKEN = 16


def _frame_bucket_ladder(lo: int = 128, hi: int = 16384, ratio: float = 1.25):
    """+128 steps to 1024, then ~x1.25 quantized to 128."""
    out = [64] + list(range(lo, 1025, 128))
    b = 1024
    while b < hi:
        b = min(hi, -(-int(b * ratio) // 128) * 128)
        out.append(b)
    return tuple(out)


FRAME_BUCKETS = _frame_bucket_ladder()

#: multistream (StableTTS) worst-case mel-frame capacity per text token:
#: durations are sigmoid sums of 50 rows, so about 50 frames a phone at most
MS_FRAMES_PER_TOKEN = 48
MS_FRAMES_CAP = 4096


def pick_frame_bucket(pred_frames: int, text_bucket: int) -> int:
    """Smallest frame bucket holding ``pred_frames``, capped at the
    worst-case ``text_bucket * FRAMES_PER_TOKEN`` (durations clip there)."""
    cap = text_bucket * FRAMES_PER_TOKEN
    for b in FRAME_BUCKETS:
        if b >= pred_frames:
            return min(b, cap)
    return min(FRAME_BUCKETS[-1], cap)


def pick_gen_frames(pred_frames: int, frame_bucket: int) -> int | None:
    """Generator frame count for the decode pass, quantized to
    ``max(16, frame_bucket // 16)``; None when the bucket is already tight."""
    step = max(16, frame_bucket // 16)
    gen = min(frame_bucket, -(-max(1, pred_frames) // step) * step)
    return gen if gen < frame_bucket else None


def pick_ms_frame_bucket(pred_frames: int, text_bucket: int) -> int:
    """Smallest frame bucket holding ``pred_frames`` for the multistream
    path, capped at ``min(text_bucket * 48, 4096)``."""
    cap = min(text_bucket * MS_FRAMES_PER_TOKEN, MS_FRAMES_CAP)
    for b in FRAME_BUCKETS:
        if b >= pred_frames:
            return min(b, cap)
    return cap


def list_models():
    """The registry's model list when VOSK_TTS_REGISTRY is set, then the
    locally installed bundles."""
    from . import registry

    for m in registry.model_list():
        print(m["name"])
    for d in MODEL_DIRS:
        if d and Path(d).is_dir():
            for name in sorted(os.listdir(d)):
                if (Path(d) / name / "config.json").exists():
                    print(name)


def list_languages():
    """The registry's languages ("ru" when no registry is set)."""
    from . import registry

    langs = {m.get("lang") for m in registry.model_list()} or {"ru"}
    for lang in sorted(lang for lang in langs if lang):
        print(lang)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. A card without an index gets the current
    one (``cuda`` -> ``cuda:0``), so that devices compare equal. Raises
    instead of falling back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


class Model:
    """One bundle on one device. Without ``model_path`` the bundle is found
    by ``model_name`` or ``lang`` in MODEL_DIRS, else fetched from the
    registry (registry.resolve)."""

    def __init__(self, model_path=None, model_name=None, lang=None, *, device=None):
        full_float32()
        self.device = resolve_device(device)
        if model_path is None:
            model_path = self._find(model_name, lang)
        model_path = Path(model_path)
        logging.info("Loading model from %s", model_path)

        self.path = model_path
        with open(model_path / "config.json", encoding="utf-8") as f:
            self.config = json.load(f)
        self.model_type = self.config.get("model_type", "vits2")
        dic_path = model_path / "dictionary"
        self.dic = load_dictionary(dic_path) if dic_path.exists() else {}
        self.sample_rate = self.config.get("sample_rate", 22050)
        self.synthesizer = self.matcha = self.vocoder = None
        self.tokenizer = self.bert = None
        if self.model_type in MULTISTREAM_TYPES:
            self._load_multistream(model_path)
            return
        self.model_config = vits2.VITS2Config.from_dict(self.config.get("model", {}))
        tree = to_port_layout(load_params(model_path / "params.npz"))
        self.synthesizer = vits2.Synthesizer(self.model_config, tree).to(self.device)

    def _load_multistream(self, model_path: Path):
        self.model_config = stabletts.StableTTSConfig.from_dict(self.config.get("model", {}))
        self.vocoder_type = self.config.get("vocoder", "hifigan")
        vcfg = self.config.get("vocoder_config")
        if self.vocoder_type == "vocos":
            self.vocoder_config = voc.VocosConfig(**(vcfg or {}))
        elif self.vocoder_type == "bigvgan":
            self.vocoder_config = bigvgan.BigVGANConfig.from_dict(vcfg or {})
        elif self.vocoder_type == "hifigan":
            self.vocoder_config = (voc.hifigan_v1_config() if vcfg is None
                                   else vits2.VITS2Config.from_dict(vcfg))
            vits2.check_decoder(self.vocoder_config)
        else:
            raise ValueError(f"unknown vocoder {self.vocoder_type!r} "
                             "(hifigan, vocos or bigvgan)")
        tree = load_params(model_path / "params.npz")
        self.matcha = stabletts.Matcha(self.model_config,
                                       stabletts.port_layout(tree["matcha"])).to(self.device)
        self.vocoder = TreeModule(to_port_layout(tree["vocoder"])).to(self.device)
        bert_dir = model_path / "bert"
        if (bert_dir / "vocab.txt").exists() and (bert_dir / "params.npz").exists():
            self.tokenizer = WordPieceTokenizer(bert_dir / "vocab.txt")
            with open(bert_dir / "config.json", encoding="utf-8") as f:
                bert_config = json.load(f)
            self.bert = BertEncoder(to_port_layout(load_params(bert_dir / "params.npz")),
                                    bert_config).to(self.device)

    @property
    def params(self):
        if self.synthesizer is not None:
            return self.synthesizer.params
        return {"matcha": self.matcha.params, "vocoder": self.vocoder.params}

    @staticmethod
    def _find(model_name, lang):
        from . import registry

        return registry.resolve(model_name, lang, MODEL_DIRS)


def audio_float_to_int16(audio: np.ndarray, max_wav_value: float = 32767.0) -> np.ndarray:
    return np.clip(audio * max_wav_value, -max_wav_value, max_wav_value).astype("int16")


def encode_plain(model: Model, text: str) -> list:
    """Text -> phoneme id sequence for plain vits2 bundles."""
    cfg = model.config
    flat_map = {k: (v[0] if isinstance(v, list) else v) for k, v in cfg["phoneme_id_map"].items()}
    ids, _ = g2p_plain(text, model.dic, flat_map, None, blank=not cfg.get("no_blank", 0))
    return ids


def word_bert(model: Model, text: str, nopunc: bool = False) -> np.ndarray:
    """One BERT vector per word (rows of the ``bert_layer`` hidden state,
    default -3): '##' subwords dropped, and punctuation too with ``nopunc``.
    Returns a (words, hidden) float32 array on the host."""
    enc = model.tokenizer.encode(text.replace("+", "").replace("_", ""))
    hs = model.bert(enc.ids, enc.attention_mask, enc.type_ids)
    layer = model.config.get("bert_layer", -3)
    pattern = re.compile('[-,.?!;:"]')
    selected = [i for i, tok in enumerate(enc.tokens)
                if tok[0] != "#" and not (nopunc and pattern.match(tok))]
    return hs[layer][selected].cpu().numpy()


def encode_multistream(model: Model, text: str):
    """Text -> (tuples (T, 5) ints, bert rows (T, 768) or None, extra
    durations or None) for multistream_v1/v2/v3 bundles."""
    id_map = {k: (v[0] if isinstance(v, list) else v) for k, v in model.config["phoneme_id_map"].items()}
    bert_rows = word_bert(model, text.lower(), nopunc=True) if model.bert is not None else None
    return g2p_multistream(text, model.dic, id_map, bert_rows,
                           word_pos=model.model_type != "multistream_v1",
                           pause_markers=model.model_type == "multistream_v3")


def multistream_inputs(model: Model, texts):
    """Texts -> the numpy inputs of the multistream passes, padded to the
    text bucket of the longest: x (B, 5, bucket) int64, x_lengths (B,)
    int32, bert (B, bucket, bert_dim) float32, pde (B, bucket) float32, and
    the bucket."""
    encoded = [encode_multistream(model, re.sub("—", "-", t.strip())) for t in texts]
    longest = max(len(tuples) for tuples, _, _ in encoded)
    bucket = next((b for b in TEXT_BUCKETS if b >= longest), TEXT_BUCKETS[-1])
    n = len(encoded)
    x = np.zeros((n, 5, bucket), np.int64)
    x_lengths = np.zeros((n,), np.int32)
    bert = np.zeros((n, bucket, model.model_config.bert_dim), np.float32)
    pde = np.zeros((n, bucket), np.float32)
    for i, (tuples, embs, extras) in enumerate(encoded):
        if len(tuples) > bucket:
            logging.warning("text too long (%d tokens), truncating to %d", len(tuples), bucket)
        t = min(len(tuples), bucket)
        x_lengths[i] = t
        x[i, :, :t] = np.asarray(tuples, np.int64).T[:, :t]
        if embs is not None:
            bert[i, :t] = np.asarray(embs, np.float32)[:t]
        if extras is not None:
            pde[i, :t] = np.asarray(extras, np.float32)[:t]
    return x, x_lengths, bert, pde, bucket


# ---------------------------------------------------------------------------
# Runner factories (the serving batcher's passes; vosk_tts_tpu/api.py names)
# ---------------------------------------------------------------------------
# Each is a closure over the Model that runs under torch.inference_mode().
# Per-request knobs (noise, inv_rate, dur_noise, temperature, length_scale)
# are floats or (B, 1, 1) tensors on the model's device; ``generator`` is a
# torch.Generator on that device (or None).


def make_vits2_runner(model: Model, max_frames: int):
    """Single-pass batched VITS2 inference at ``max_frames``; returns the
    ``vits2.infer`` dict (wav (B, samples, 1), wav_lengths, ...)."""
    syn = model.synthesizer

    @torch.inference_mode()
    def run(x, x_lengths, sid, generator, noise, inv_rate, dur_noise):
        return syn.infer(x, x_lengths, sid, generator=generator, max_frames=max_frames,
                         noise_scale=noise, length_scale=inv_rate, noise_scale_w=dur_noise)

    return run


def make_vits2_encode_runner(model: Model):
    """Pass one of the split serving path: encoder + SDP. The returned dict
    (tensors on the device) feeds the decode runner directly."""
    syn = model.synthesizer

    @torch.inference_mode()
    def run(x, x_lengths, sid, generator, inv_rate, dur_noise):
        return syn.encode_for_infer(x, x_lengths, sid, generator=generator,
                                    length_scale=inv_rate, noise_scale_w=dur_noise)

    return run


def make_vits2_decode_runner(model: Model, max_frames: int, gen_frames: int | None = None):
    """Pass two: alignment + flow + generator from pass one's dict;
    ``gen_frames`` slices the generator input below the frame bucket."""
    syn = model.synthesizer

    @torch.inference_mode()
    def run(enc, sid, generator, noise):
        return syn.decode_from_durations(enc, sid, generator=generator, max_frames=max_frames,
                                         noise_scale=noise, gen_frames=gen_frames)

    return run


def vocoder_apply(model: Model, mel):
    """The bundle's vocoder: mel (B, T, n_mels) -> wav (B, samples)."""
    params, cfg = model.vocoder.params, model.vocoder_config
    if model.vocoder_type == "vocos":
        return voc.vocos_apply(params, cfg, mel)
    if model.vocoder_type == "bigvgan":
        return bigvgan.bigvgan_apply(params, cfg, mel)
    return voc.hifigan_apply(params, mel, cfg)


def make_multistream_runner(model: Model, max_frames: int, n_timesteps: int):
    """Single-pass batched StableTTS + vocoder at ``max_frames`` (the
    VOSK_TTS_ADAPTIVE=0 path); returns (wav (B, samples), mel_lengths)."""

    @torch.inference_mode()
    def run(x, x_lengths, sid, bert, pde, generator, temperature, length_scale, dp_temperature):
        # dp_temperature: StableTTS durations are deterministic (sigmoid sums)
        out = model.matcha.synthesise(x, x_lengths, sid, bert, max_frames=max_frames,
                                      n_timesteps=n_timesteps, temperature=temperature,
                                      length_scale=length_scale, phone_duration_extra=pde,
                                      generator=generator)
        return vocoder_apply(model, out["mel"]), out["mel_lengths"]

    return run


def make_multistream_encode_runner(model: Model):
    """Pass one of the multistream split path: both DiT text encoders and
    the sigmoid-sum durations; the dict feeds the decode runner."""

    @torch.inference_mode()
    def run(x, x_lengths, sid, bert, pde, length_scale):
        return model.matcha.encode_for_synth(x, x_lengths, sid, bert, length_scale=length_scale,
                                             phone_duration_extra=pde)

    return run


def make_multistream_decode_runner(model: Model, max_frames: int, n_timesteps: int):
    """Pass two: alignment + CFM ODE + vocoder from pass one's dict;
    returns (wav (B, samples), mel_lengths)."""

    @torch.inference_mode()
    def run(enc, sid, generator, temperature):
        out = model.matcha.decode_from_durations(enc, sid, max_frames=max_frames,
                                                 n_timesteps=n_timesteps,
                                                 temperature=temperature, generator=generator)
        return vocoder_apply(model, out["mel"]), out["mel_lengths"]

    return run


def visible_devices(model: Model) -> list:
    """Every visible card where the model is on a card, else the model's
    device: the devices :meth:`Synth.synth_batch` spreads a batch over."""
    if model.device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [model.device]


class Synth:
    def __init__(self, model: Model):
        self.model = model
        self.generator = torch.Generator(device=model.device)
        self.generator.manual_seed(int(model.config.get("seed", 0)))
        self._replicas: dict = {}

    def _replica(self, i: int, device):
        """(synthesizer, generator) of shard ``i`` on ``device``: the model's
        own for shard 0 on the model's device, else a copy kept for the
        shard (one a card; two shards named on one card hold two), its
        generator seeded by the seed + ``i``."""
        device = resolve_device(device)
        if i == 0 and device == self.model.device:
            return self.model.synthesizer, self.generator
        if (i, device) not in self._replicas:
            syn = copy.deepcopy(self.model.synthesizer).to(device)
            gen = torch.Generator(device=device)
            gen.manual_seed(int(self.model.config.get("seed", 0)) + i)
            self._replicas[(i, device)] = (syn, gen)
        return self._replicas[(i, device)]

    def _defaults(self, noise_level, speech_rate, duration_noise_level, scale):
        inference = self.model.config.get("inference", {})
        pick = lambda v, k, d: inference.get(k, d) if v is None else v
        return (pick(noise_level, "noise_level", 0.8), pick(speech_rate, "speech_rate", 1.0),
                pick(duration_noise_level, "duration_noise_level", 0.8), pick(scale, "scale", 1.0))

    def _encode(self, text: str):
        return encode_plain(self.model, re.sub("—", "-", text.strip()))

    def _encode_pass(self, shards, inv_rate, dur_noise, bucket):
        """Duration-adaptive pass one on every shard (synthesizer, generator,
        (x, x_lengths, sid), real rows): encoder + SDP once each, then fetch
        only the predicted frame counts; returns (each shard's enc, the
        frame bucket, gen_frames) from the largest count of the real rows,
        or (Nones, worst case, None) when disabled with VOSK_TTS_ADAPTIVE=0."""
        if os.environ.get("VOSK_TTS_ADAPTIVE", "1") == "0":
            return [None] * len(shards), bucket * FRAMES_PER_TOKEN, None
        encs = [syn.encode_for_infer(*args, generator=gen, length_scale=inv_rate,
                                     noise_scale_w=dur_noise) for syn, gen, args, _ in shards]
        pred = max(int(enc["pred_frames"][:real].max()) for enc, (*_, real) in zip(encs, shards))
        fb = pick_frame_bucket(pred, bucket)
        return encs, fb, pick_gen_frames(pred, fb)

    @torch.inference_mode()
    def _run(self, all_ids, speaker_ids, noise_level, speech_rate, duration_noise_level,
             devices=None):
        """Pad a batch to its text bucket, run both passes; returns
        (wav (B, samples) numpy, lengths (B,) numpy). ``devices`` (default
        the model's) splits the batch, padded to a multiple of their count,
        into one shard a device (:meth:`_replica`): the encode pass runs on
        every shard, then one frame bucket and one ``gen_frames`` from the
        largest ``pred_frames`` of every shard's real rows (a row's tail
        depends on the frames after it, so every shard decodes at the same
        geometry), then each shard's decode, the rows back in order."""
        devices = [self.model.device] if devices is None else [resolve_device(d) for d in devices]
        bucket = next((b for b in TEXT_BUCKETS if b >= max(len(i) for i in all_ids)),
                      TEXT_BUCKETS[-1])
        n, k = len(all_ids), len(devices)
        per = -(-n // k)  # rows a shard: the batch padded to a multiple of the devices
        x = np.zeros((per * k, bucket), np.int64)
        x_lengths = np.ones((per * k,), np.int32)
        sid = np.zeros((per * k,), np.int64)
        for i, ids in enumerate(all_ids):
            if len(ids) > bucket:
                logging.warning("text too long (%d tokens), truncating to %d", len(ids), bucket)
                ids = ids[:bucket]
            x[i, : len(ids)] = ids
            x_lengths[i] = len(ids)
            sid[i] = speaker_ids[i] or 0
        inv_rate = 1.0 / speech_rate
        shards = []
        for i, dev in enumerate(devices):
            if i * per >= n:  # a shard of padding only: nothing to run
                break
            rows = slice(i * per, (i + 1) * per)
            syn, gen = self._replica(i, dev)
            args = [torch.as_tensor(a[rows], device=dev) for a in (x, x_lengths, sid)]
            shards.append((syn, gen, args, min(n - i * per, per)))
        encs, max_frames, gen_frames = self._encode_pass(shards, inv_rate, duration_noise_level,
                                                         bucket)
        wavs, lengths = [], []
        for (syn, gen, (xs, xls, sids), _), enc in zip(shards, encs):
            if enc is None:
                out = syn.infer(xs, xls, sids, generator=gen, max_frames=max_frames,
                                noise_scale=noise_level, length_scale=inv_rate,
                                noise_scale_w=duration_noise_level)
            else:
                out = syn.decode_from_durations(enc, sids, generator=gen, max_frames=max_frames,
                                                noise_scale=noise_level, gen_frames=gen_frames)
            wavs.append(out["wav"][..., 0].cpu().numpy())
            lengths.append(out["wav_lengths"].cpu().numpy())
        return np.concatenate(wavs)[:n], np.concatenate(lengths)[:n]

    @torch.inference_mode()
    def _synth_multistream(self, text, speaker_id, noise_level, speech_rate):
        """StableTTS + vocoder for one text: the duration-adaptive split
        (encoders and durations, then the CFM ODE and the vocoder at the
        smallest frame bucket), or with VOSK_TTS_ADAPTIVE=0 the single pass
        at the worst-case frame capacity. Returns float audio (samples,)."""
        model = self.model
        x, x_lengths, bert, pde, bucket = multistream_inputs(model, [text])
        n_timesteps = int(model.config.get("inference", {}).get("n_timesteps", 10))
        dev = model.device
        x, x_lengths, bert, pde = (torch.as_tensor(a, device=dev) for a in (x, x_lengths, bert, pde))
        sid = torch.tensor([speaker_id or 0], dtype=torch.int64, device=dev)
        kw = dict(n_timesteps=n_timesteps, temperature=noise_level, generator=self.generator)
        if os.environ.get("VOSK_TTS_ADAPTIVE", "1") == "0":
            out = model.matcha.synthesise(
                x, x_lengths, sid, bert, max_frames=min(bucket * MS_FRAMES_PER_TOKEN, MS_FRAMES_CAP),
                length_scale=1.0 / speech_rate, phone_duration_extra=pde, **kw)
        else:
            enc = model.matcha.encode_for_synth(x, x_lengths, sid, bert,
                                                length_scale=1.0 / speech_rate,
                                                phone_duration_extra=pde)
            max_frames = pick_ms_frame_bucket(int(enc["pred_frames"].max()), bucket)
            out = model.matcha.decode_from_durations(enc, sid, max_frames=max_frames, **kw)
        wav = vocoder_apply(model, out["mel"])
        n = int(out["mel_lengths"][0]) * model.config.get("hop_length", 256)
        return wav[0, :n].cpu().numpy()

    def synth_audio(self, text, speaker_id=0, noise_level=None, speech_rate=None,
                    duration_noise_level=None, scale=None):
        noise_level, speech_rate, duration_noise_level, scale = self._defaults(
            noise_level, speech_rate, duration_noise_level, scale)
        # the timed spans are the JAX package's: the multistream one holds
        # G2P and BERT, the VITS2 one starts after G2P
        if self.model.model_type in MULTISTREAM_TYPES:
            start = time.perf_counter()
            wav = self._synth_multistream(text, speaker_id, noise_level, speech_rate)
            audio = audio_float_to_int16(wav * scale)
        else:
            ids = self._encode(text)
            start = time.perf_counter()
            wav, lengths = self._run([ids], [speaker_id], noise_level, speech_rate,
                                     duration_noise_level)
            audio = audio_float_to_int16(wav[0, : lengths[0]] * scale)
        elapsed = time.perf_counter() - start
        dur = len(audio) / self.model.sample_rate
        rtf = elapsed / dur if dur > 0 else 0.0
        logging.info("Real-time factor: %0.3f (infer=%0.3f sec, audio=%0.2f sec)", rtf, elapsed, dur)
        return audio

    def synth(self, text, oname, speaker_id=0, noise_level=None, speech_rate=None,
              duration_noise_level=None, scale=None):
        audio = self.synth_audio(text, speaker_id, noise_level, speech_rate,
                                 duration_noise_level, scale)
        with wave.open(str(oname), "w") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(self.model.sample_rate)
            f.writeframes(audio.tobytes())

    def synth_batch(self, texts, speaker_ids=None, noise_level=None, speech_rate=None,
                    duration_noise_level=None, scale=None, devices=None):
        """Many utterances as one batch (one encode pass, one decode pass),
        spread over ``devices`` (default :func:`visible_devices`: every
        visible card), one shard and one replica of the synthesizer a
        device (:meth:`_run`); a list may name a card more than once. Returns
        a list of int16 arrays. VITS2 bundles only, as in the JAX package."""
        if self.model.model_type in MULTISTREAM_TYPES:
            raise NotImplementedError("synth_batch runs VITS2 bundles only")
        noise_level, speech_rate, duration_noise_level, scale = self._defaults(
            noise_level, speech_rate, duration_noise_level, scale)
        if speaker_ids is None:
            speaker_ids = [0] * len(texts)
        start = time.perf_counter()
        wav, lengths = self._run([self._encode(t) for t in texts], speaker_ids, noise_level,
                                 speech_rate, duration_noise_level,
                                 visible_devices(self.model) if devices is None else devices)
        audios = [audio_float_to_int16(wav[i, : lengths[i]] * scale) for i in range(len(texts))]
        elapsed = time.perf_counter() - start
        dur = sum(len(a) for a in audios) / self.model.sample_rate
        logging.info("Real-time factor: %0.3f (batch of %d, infer=%0.3f sec, audio=%0.2f sec)",
                     elapsed / dur if dur > 0 else 0.0, len(texts), elapsed, dur)
        return audios
