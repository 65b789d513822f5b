"""Mel -> waveform vocoders of the multistream bundles
(vosk_tts_tpu/models/vocoder.py): HiFiGAN v1 (the VITS2 generator trunk at
vocoder configuration) with its spectral-subtraction denoiser, and Vocos
(ConvNeXt blocks and an iSTFT head). BigVGAN is models/bigvgan.py."""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..ops.conv import conv1d, depthwise_conv1d
from ..ops.norm import layer_norm
from ..ops.stft import istft, stft
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


# the denoiser's STFT (the reference's Denoiser: filter 1024, hop 256,
# window 1024) and its default strength
DENOISE_N_FFT, DENOISE_HOP, DENOISE_WIN = 1024, 256, 1024
DENOISE_STRENGTH = 2.5e-4


def _spectrum(wav):
    return stft(wav, DENOISE_N_FFT, DENOISE_HOP, DENOISE_WIN, pad=DENOISE_N_FFT // 2)


def denoiser_bias(params, cfg: VITS2Config):
    """The vocoder's magnitude on an all-zero mel (88 frames): the first
    STFT frame (1, 1, 513), the bias :func:`denoise` subtracts."""
    mel = torch.zeros((1, 88, cfg.inter_channels), device=params["conv_pre"]["w"].device)
    re, im = _spectrum(hifigan_apply(params, mel, cfg))
    return torch.sqrt(re**2 + im**2)[:, :1, :]


def denoise(wav: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Spectral subtraction: wav (B, T) -> (B, T') with the magnitude
    lowered by ``bias * DENOISE_STRENGTH`` (floored at 0) and the phase
    kept."""
    re, im = _spectrum(wav)
    mag = torch.clamp(torch.sqrt(re**2 + im**2) - bias * DENOISE_STRENGTH, min=0.0)
    return istft(mag, torch.atan2(im, re), DENOISE_N_FFT, DENOISE_HOP, DENOISE_WIN)


@dataclass(frozen=True)
class VocosConfig:
    input_channels: int = 80
    dim: int = 512
    intermediate_dim: int = 1536
    num_layers: int = 8
    n_fft: int = 1024
    hop_length: int = 256
    padding: str = "same"  # mel frames == (T_wav / hop) frames


def vocos_apply(params, cfg: VocosConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel: (B, T, input_channels) -> wav (B, (T-1)*hop), clipped to
    [-1, 1]: the embedding conv, ConvNeXt blocks (depthwise k=7, LayerNorm,
    Linear, exact GELU, Linear, layer scale, residual), the final norm and
    the iSTFT head (magnitude exp(min(., 100)), phase as is)."""
    x = conv1d(mel, params["embed"]["w"], params["embed"]["b"], padding=3)
    x = layer_norm(x, params["norm"]["gamma"], params["norm"]["beta"], eps=1e-6)
    for blk in params["blocks"]:
        h = depthwise_conv1d(x, blk["dwconv"]["w"], blk["dwconv"]["b"], padding=3)
        h = layer_norm(h, blk["norm"]["gamma"], blk["norm"]["beta"], eps=1e-6)
        h = F.gelu(F.linear(h, blk["pw1"]["w"], blk["pw1"]["b"]))
        x = x + blk["gamma"] * F.linear(h, blk["pw2"]["w"], blk["pw2"]["b"])
    x = layer_norm(x, params["final_norm"]["gamma"], params["final_norm"]["beta"], eps=1e-6)
    h = F.linear(x, params["head"]["w"], params["head"]["b"])  # (B, T, n_fft+2)
    half = cfg.n_fft // 2 + 1
    mag = torch.exp(torch.clamp(h[..., :half], max=1e2))
    wav = istft(mag, h[..., half:], cfg.n_fft, cfg.hop_length, cfg.n_fft)
    return torch.clamp(wav, -1.0, 1.0)
