"""Inference pipelines beyond plain TTS (vosk_tts_tpu/pipelines.py):
voice conversion, ContentVec -> QuickVC."""

from __future__ import annotations

import numpy as np
import torch

from .api import resolve_device
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
