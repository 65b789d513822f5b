"""Inference pipelines beyond plain TTS (vosk_tts_tpu/pipelines.py):
voice conversion (ContentVec -> QuickVC) and GPT-SoVITS zero-shot cloning
(reference wav -> ContentVec -> semantic prompt codes; AR decode of the
text's semantic tokens; SoVITS decode with the reference spectrogram).

Both take port-layout parameter trees already on ``device`` (the card
unless the caller asks for the CPU) and numpy inputs, and return numpy
waveforms."""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from .api import resolve_device
from .models import gpt_sovits as GS
from .models import quickvc as Q
from .models.hubert import HubertConfig, hubert_apply
from .ops.stft import mel_spectrogram


def convert_voice(vc_params, vc_cfg: Q.QuickVCConfig, hubert_params, hubert_cfg: HubertConfig,
                  src_wav_16k: np.ndarray, tgt_wav_16k: np.ndarray, *, device=None,
                  generator: torch.Generator | None = None, noise: torch.Tensor | None = None,
                  mel_n: int = 80) -> np.ndarray:
    """The source's content in the target's voice. Both waveforms are 1-D
    float arrays at 16 kHz; the params are port-layout trees on ``device``
    (``QuickVC.params``, ``Hubert.params``), which defaults to the card.
    The target's 80-mel log spectrogram gives the speaker embedding, the
    source's ContentVec features the content; ``generator`` (or ``noise``,
    (1, frames, inter_channels)) gives the posterior's draw. Returns the
    converted waveform, 320 samples a ContentVec frame, as float32 numpy."""
    dev = resolve_device(device)
    src = torch.as_tensor(np.asarray(src_wav_16k, np.float32), device=dev)[None]
    tgt = torch.as_tensor(np.asarray(tgt_wav_16k, np.float32), device=dev)[None]
    with torch.inference_mode():
        c = hubert_apply(hubert_params, hubert_cfg, src)
        tgt_mel = mel_spectrogram(tgt, 1280, mel_n, 16000, 320, 1280, 0.0, None)
        wav = Q.infer(vc_params, vc_cfg, c, tgt_mel, generator=generator, noise=noise)
    return wav[0].cpu().numpy()


def clone_tts(ar_params, ar_cfg: GS.ARConfig, sovits_params, sovits_cfg: GS.SoVITSConfig,
              hubert_params, hubert_cfg: HubertConfig, phoneme_ids: np.ndarray, bert: np.ndarray,
              ref_wav_16k: np.ndarray, ref_spec: np.ndarray, *, device=None,
              generator: torch.Generator | None = None, top_k: int = 15,
              temperature: float = 1.0, max_new: int = 600, noise_scale: float = 0.5):
    """GPT-SoVITS two-stage inference for one text: the reference wav (1-D,
    16 kHz) -> ContentVec -> semantic prompt codes; the AR decode of
    ``phoneme_ids`` (T,) with ``bert`` (T, bert_dim) -> semantic tokens;
    the SoVITS decode of the tokens (padded to a CODE_BUCKETS length) with
    ``ref_spec`` (Tr, spec_channels) -> 32 kHz waveform. ``generator``
    gives the AR draws and the prior's noise. Returns (waveform float32
    numpy of n * upsample_factor samples, n tokens)."""
    dev = resolve_device(device)
    with torch.inference_mode():
        ssl = hubert_apply(hubert_params, hubert_cfg,
                           torch.as_tensor(np.asarray(ref_wav_16k, np.float32), device=dev)[None])
        prompts = GS.sovits_extract_latent(sovits_params, sovits_cfg, ssl)
        ids = torch.as_tensor(np.asarray(phoneme_ids, np.int64), device=dev)[None]
        tokens, n = GS.ar_infer(ar_params, ar_cfg, ids,
                                torch.as_tensor(np.asarray(bert, np.float32), device=dev)[None],
                                prompts, generator=generator, top_k=top_k,
                                temperature=temperature, max_new=max_new)
        n = max(int(n), 1)
        codes = tokens[:, :bucket_len(n, CODE_BUCKETS)]
        ints = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
        wav = GS.sovits_decode(sovits_params, sovits_cfg, codes, ids, ints([ids.shape[1]]),
                               torch.as_tensor(np.asarray(ref_spec, np.float32), device=dev)[None],
                               ints([ref_spec.shape[0]]), generator=generator,
                               noise_scale=noise_scale, code_lengths=ints([n]))
    return wav[0, :n * GS.upsample_factor(sovits_cfg)].cpu().numpy(), n


# ---------------------------------------------------------------------------
# Long-text cloning (GPT-SoVITS inference_cli.py:164-274: cut the text into
# sentences, merge short chunks, synthesize each with the prompt text's
# phonemes prepended, join with silence)
# ---------------------------------------------------------------------------

#: semantic-code buckets for sovits_decode (worst-case padding ~12%)
CODE_BUCKETS = (32, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536)

#: phoneme-length buckets for the AR prefill / decode text conditioning
PHONE_BUCKETS = (16, 32, 64, 96, 128, 192, 256, 384, 512)

#: the splits set of inference_cli.py:122 (the fork's ru/en subset plus the
#: CJK marks it still recognizes when cutting)
SPLITS = {"，", "。", "？", "！", ",", ".", "?", "!", "~", ":", "：", "—", "…"}


def bucket_len(n: int, buckets) -> int:
    """Smallest bucket >= n (the last bucket if none)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def cut_text(text: str, merge_threshold: int = 5) -> list:
    """cut4 + merge_short_text_in_array (inference_cli.py:137-161): split on
    '.', drop the trailing one, then greedily merge chunks shorter than
    ``merge_threshold`` characters into their successor (the tail merges
    back)."""
    chunks = text.strip("\n").strip(".").split(".")
    if len(chunks) < 2:
        return [c for c in chunks if c.strip()]
    merged, cur = [], ""
    for c in chunks:
        cur += c
        if len(cur) >= merge_threshold:
            merged.append(cur)
            cur = ""
    if cur:
        if merged:
            merged[-1] += cur
        else:
            merged.append(cur)
    return [c for c in merged if c.strip()]


def _pow2_batch(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, max(max_batch, 1))


def clone_tts_long(ar_params, ar_cfg: GS.ARConfig, sovits_params, sovits_cfg: GS.SoVITSConfig,
                   hubert_params, hubert_cfg: HubertConfig, text: str, ref_wav_16k: np.ndarray,
                   ref_spec: np.ndarray, *, frontend, device=None,
                   generator: torch.Generator | None = None, prompt_text: str | None = None,
                   language: str = "ru", top_k: int = 15, top_p: float = 0.6,
                   temperature: float = 1.0, max_new: int = 600, noise_scale: float = 0.5,
                   sample_rate: int = 32000, silence_s: float = 0.3, max_batch: int = 8):
    """Long-text zero-shot cloning (inference_cli.py get_tts_wav :164-274).

    ``frontend`` is a ``text.Cleaner``-like object with ``clean_text(text,
    language) -> (phones, word2ph, norm_text)`` and ``to_ids(phones)``.
    As the reference: 0.3 s of silence appended to the reference wav
    before ContentVec; the text cut into sentences with short chunks
    merged; the prompt text's phonemes prepended for the AR while the
    SoVITS decode sees only the chunk's; each chunk peak-normalised if it
    clips; chunks joined, each followed by ``silence_s`` of silence.

    Chunks are batched as in the JAX package: grouped by phone bucket
    through ``ar_infer_batch`` (BERT zeros, as for ru/en), then by (code
    bucket, text bucket) through ``sovits_decode``, ``max_batch`` at a
    time; batches are padded to powers of two by repeating row 0. Chunk
    order is kept. Returns (waveform float32 numpy, total tokens)."""
    dev = resolve_device(device)
    upf = GS.upsample_factor(sovits_cfg)
    ref = np.concatenate([np.asarray(ref_wav_16k, np.float32), np.zeros(int(16000 * 0.3), np.float32)])
    prompt_ids = frontend.to_ids(frontend.clean_text(prompt_text.strip("\n"), language)[0]) \
        if prompt_text else []

    chunk_ids = []
    for chunk in cut_text(text.strip("\n")):
        chunk = chunk.strip()
        if not chunk:
            continue
        if chunk[-1] not in SPLITS:
            chunk += "."
        ids = frontend.to_ids(frontend.clean_text(chunk, language)[0])
        if ids:
            chunk_ids.append(ids)
    if not chunk_ids:
        return np.zeros(0, np.float32), 0

    def groups(keys):
        by = defaultdict(list)
        for i, k in enumerate(keys):
            by[k].append(i)
        return [(k, by[k][s:s + max_batch]) for k in sorted(by)
                for s in range(0, len(by[k]), max_batch)]

    def padded(rows, width, fill=0):
        """A (pow2 batch, width) int array of the rows, pad rows repeating row 0."""
        b = _pow2_batch(len(rows), max_batch)
        out = np.full((b, width), fill, np.int64)
        for r, row in enumerate(rows + [rows[0]] * (b - len(rows))):
            out[r, :len(row)] = row
        return torch.as_tensor(out, device=dev)

    ints = lambda v: torch.as_tensor(np.asarray(v, np.int64), device=dev)
    tokens_all, n_all = [None] * len(chunk_ids), [0] * len(chunk_ids)
    audios = [None] * len(chunk_ids)
    with torch.inference_mode():
        ssl = hubert_apply(hubert_params, hubert_cfg, torch.as_tensor(ref, device=dev)[None])
        prompts = GS.sovits_extract_latent(sovits_params, sovits_cfg, ssl)

        for tb, grp in groups([bucket_len(len(prompt_ids) + len(ids), PHONE_BUCKETS)
                               for ids in chunk_ids]):
            rows = [prompt_ids + chunk_ids[i] for i in grp]
            x = padded(rows, tb)
            b = x.shape[0]
            lens = [len(r) for r in rows]
            toks, ns = GS.ar_infer_batch(
                ar_params, ar_cfg, x, ints(lens + [lens[0]] * (b - len(lens))),
                torch.zeros(b, tb, ar_cfg.bert_dim, device=dev), prompts.expand(b, -1),
                generator=generator, top_k=top_k, top_p=top_p, temperature=temperature,
                max_new=max_new)
            toks, ns = toks.cpu().numpy(), ns.cpu().numpy()
            for r, i in enumerate(grp):
                tokens_all[i], n_all[i] = toks[r], max(int(ns[r]), 1)

        refer = torch.as_tensor(np.asarray(ref_spec, np.float32), device=dev)[None]
        for (cb, db), grp in groups([(bucket_len(n_all[i], CODE_BUCKETS),
                                      bucket_len(len(ids), PHONE_BUCKETS))
                                     for i, ids in enumerate(chunk_ids)]):
            codes = padded([tokens_all[i][:cb] for i in grp], cb)  # cb may exceed max_new: masked
            text_ids = padded([chunk_ids[i][:db] for i in grp], db)
            b = codes.shape[0]
            code_lens = [min(n_all[i], cb) for i in grp]
            text_lens = [min(len(chunk_ids[i]), db) for i in grp]
            wav = GS.sovits_decode(
                sovits_params, sovits_cfg, codes, text_ids,
                ints(text_lens + [text_lens[0]] * (b - len(grp))), refer.expand(b, -1, -1),
                ints([ref_spec.shape[0]] * b), generator=generator, noise_scale=noise_scale,
                code_lengths=ints(code_lens + [code_lens[0]] * (b - len(grp)))).cpu().numpy()
            for r, i in enumerate(grp):
                audio = wav[r, :code_lens[r] * upf]
                peak = np.abs(audio).max()
                audios[i] = audio / peak if peak > 1 else audio  # 16-bit clip guard (:261-262)
    silence = np.zeros(int(sample_rate * silence_s), np.float32)
    return (np.concatenate([p for a in audios for p in (a, silence)]).astype(np.float32),
            int(sum(n_all)))
