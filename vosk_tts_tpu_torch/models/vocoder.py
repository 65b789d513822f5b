"""Mel -> waveform vocoder of the multistream bundles: HiFiGAN v1
(vosk_tts_tpu/models/vocoder.py), the VITS2 generator trunk at vocoder
configuration. Vocos, BigVGAN and the denoiser are not ported."""

from __future__ import annotations

import torch

from .vits2 import VITS2Config, generator_apply


def hifigan_v1_config() -> VITS2Config:
    """HiFiGAN v1 at 22.05 kHz / hop 256."""
    return VITS2Config(
        inter_channels=80,  # mel input channels
        resblock="1",
        resblock_kernel_sizes=(3, 7, 11),
        resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
        upsample_rates=(8, 8, 2, 2),
        upsample_initial_channel=512,
        upsample_kernel_sizes=(16, 16, 4, 4),
        decoder_type="hifigan",
        gin_channels=0,
        n_speakers=0,
    )


def hifigan_apply(params, mel: torch.Tensor, cfg: VITS2Config | None = None) -> torch.Tensor:
    """mel: (B, T, 80) -> wav (B, T*256), clipped to [-1, 1]."""
    cfg = cfg or hifigan_v1_config()
    return torch.clamp(generator_apply(params, cfg, mel)[0][..., 0], -1.0, 1.0)
