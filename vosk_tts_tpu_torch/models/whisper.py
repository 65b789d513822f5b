"""Whisper audio encoder (vosk_tts_tpu/models/whisper.py), the alternative
SSL content extractor of GPT-SoVITS
(training/gpt-sovits/feature_extractor/whisper_enc.py): 30 s of 16 kHz
audio -> Whisper log-mel -> two convs (the second strided) -> pre-LN
transformer -> features truncated to mel_len // 2 frames.

The log-mel is the JAX package's: a reflect-padded 400-point Hann STFT,
the last frame dropped, the Slaney mel filterbank, log10 of max(x, 1e-10)
floored at its max - 8, then (x + 4) / 4. The STFT is ``torch.fft.rfft``
of the frames (Whisper's own ``torch.stft`` route; the JAX package's DFT
matmul is its TPU form): the log keeps bins 8 decades below the loudest,
where an f32 DFT matmul's rounding reaches 6e-5 of the log-mel and an
FFT's stays near 8e-6. The attention is
the JAX package's ``_attn``: no bias on ``k``, ``q`` scaled by
head_dim**-0.5, a softmax over all keys with no mask, in plain matmuls
(the JAX package computes it outside any Pallas kernel). Parameters are in
the port's layout (``utils/params.to_port_layout`` of the bundle-layout
tree that ``whisper_from_state_dict`` or ``utils/params.whisper_init``
gives; :data:`utils.params.WHISPER_LINEARS` inverts it).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv import constant, conv1d
from ..ops.stft import hann_window, mel_filterbank

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
N_SAMPLES = 30 * SAMPLE_RATE  # 480_000 -> 3000 mel frames


@dataclass(frozen=True)
class WhisperEncConfig:
    num_mel_bins: int = 80
    d_model: int = 768          # "small"
    encoder_layers: int = 12
    encoder_attention_heads: int = 12
    encoder_ffn_dim: int = 3072
    max_source_positions: int = 1500
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_hf(cls, d: dict):
        return cls(
            num_mel_bins=d["num_mel_bins"], d_model=d["d_model"],
            encoder_layers=d["encoder_layers"],
            encoder_attention_heads=d["encoder_attention_heads"],
            encoder_ffn_dim=d["encoder_ffn_dim"],
            max_source_positions=d["max_source_positions"],
        )


# ---------------------------------------------------------------------------
# log-mel frontend (whisper.audio.log_mel_spectrogram semantics)
# ---------------------------------------------------------------------------


def _bases(n_mels: int, device, dtype):
    """The Hann window (N_FFT,) and the Slaney mel filterbank
    (n_mels, N_FFT//2+1), as constants."""
    mel = mel_filterbank(SAMPLE_RATE, N_FFT, n_mels, 0.0, None)
    return tuple(constant(np.asarray(a, np.float32), device, dtype)
                 for a in (hann_window(N_FFT), mel))


def whisper_log_mel(wav: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """wav (B, N) at 16 kHz -> (B, N // 160, n_mels) log-mel (3000 frames
    for N_SAMPLES): centered 400-point Hann STFT (reflect pad), power
    spectrum with the last frame dropped, Slaney mel, log10 clamped at
    1e-10, floored at (max - 8) per row, then (x + 4) / 4."""
    n = wav.shape[1]
    window, mel = _bases(n_mels, wav.device, wav.dtype)
    y = F.pad(wav[:, None, :], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    frames = y.unfold(1, N_FFT, HOP)[:, : n // HOP] * window  # whisper drops the last frame
    spec = torch.fft.rfft(frames, dim=-1)
    spec = (spec.real * spec.real + spec.imag * spec.imag) @ mel.T
    log_spec = torch.log10(torch.clamp(spec, min=1e-10))
    floor = log_spec.amax(dim=(1, 2), keepdim=True) - 8.0
    return (torch.maximum(log_spec, floor) + 4.0) / 4.0


def pad_or_trim(wav: np.ndarray, length: int = N_SAMPLES) -> np.ndarray:
    wav = np.asarray(wav, np.float32)
    if len(wav) >= length:
        return wav[:length]
    return np.pad(wav, (0, length - len(wav)))


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def _ln(x, p, eps):
    return F.layer_norm(x, (x.shape[-1],), p["g"], p["b"], eps)


def _attn(x, p, n_heads):
    b, t, d = x.shape
    hd = d // n_heads
    q = F.linear(x, p["q"]["w"], p["q"]["b"]) * (hd ** -0.5)
    k = F.linear(x, p["k"]["w"])  # no bias in whisper k_proj
    v = F.linear(x, p["v"]["w"], p["v"]["b"])
    q, k, v = (a.reshape(b, t, n_heads, hd).transpose(1, 2) for a in (q, k, v))
    w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    o = (w @ v).transpose(1, 2).reshape(b, t, d)
    return F.linear(o, p["out"]["w"], p["out"]["b"])


def whisper_encoder_apply(params, cfg: WhisperEncConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, T_mel, n_mels) -> hidden states (B, T_mel//2, d_model)."""
    x = F.gelu(conv1d(mel, params["conv1"]["w"], params["conv1"]["b"], padding=1))
    x = F.gelu(conv1d(x, params["conv2"]["w"], params["conv2"]["b"], stride=2, padding=1))
    x = x + params["pos"][: x.shape[1]]
    eps = cfg.layer_norm_eps
    for layer in params["layers"]:
        x = x + _attn(_ln(x, layer["ln1"], eps), layer["attn"], cfg.encoder_attention_heads)
        h = _ln(x, layer["ln2"], eps)
        h = F.gelu(F.linear(h, layer["fc1"]["w"], layer["fc1"]["b"]))
        x = x + F.linear(h, layer["fc2"]["w"], layer["fc2"]["b"])
    return _ln(x, params["ln_post"], eps)


def get_content(params, cfg: WhisperEncConfig, wav_16k: np.ndarray) -> torch.Tensor:
    """whisper_enc.get_content: (n,) float 16 kHz audio shorter than 30 s ->
    (1, n // 160 // 2, d_model) features (channels-last; the reference
    transposes to (1, d, T), whisper_enc.py:14-25), on the parameters'
    device. Raises ValueError at 30 s or longer, as the reference asserts."""
    n_frames = len(wav_16k) // HOP
    if n_frames >= 3000:
        raise ValueError("input longer than 30 s (whisper_enc.py asserts this)")
    pos = params["pos"]
    wav = torch.as_tensor(pad_or_trim(wav_16k), device=pos.device, dtype=pos.dtype)[None]
    feats = whisper_encoder_apply(params, cfg, whisper_log_mel(wav, cfg.num_mel_bins))
    return feats[:, : n_frames // 2, :]


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed positional table (whisper/model.py sinusoids)."""
    log_timescale = math.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    ang = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)


def whisper_from_state_dict(sd: dict, cfg: WhisperEncConfig) -> dict:
    """HF ``WhisperModel.encoder`` state dict (numpy arrays) -> the
    bundle-layout tree (the JAX package's), for ``to_port_layout``."""
    sd = {k: np.asarray(v) for k, v in sd.items()}

    def lin(pfx):
        return {"w": np.ascontiguousarray(sd[pfx + ".weight"].T),
                "b": sd.get(pfx + ".bias", np.zeros(sd[pfx + ".weight"].shape[0], np.float32))}

    def lnp(pfx):
        return {"g": sd[pfx + ".weight"], "b": sd[pfx + ".bias"]}

    p = {
        # torch Conv1d (O, I, K) -> (K, I, O)
        "conv1": {"w": sd["conv1.weight"].transpose(2, 1, 0), "b": sd["conv1.bias"]},
        "conv2": {"w": sd["conv2.weight"].transpose(2, 1, 0), "b": sd["conv2.bias"]},
        "pos": sd["embed_positions.weight"],
        "layers": [],
        "ln_post": lnp("layer_norm"),
    }
    for i in range(cfg.encoder_layers):
        pfx = f"layers.{i}"
        p["layers"].append({
            "ln1": lnp(f"{pfx}.self_attn_layer_norm"),
            "attn": {
                "q": lin(f"{pfx}.self_attn.q_proj"),
                "k": {"w": np.ascontiguousarray(sd[f"{pfx}.self_attn.k_proj.weight"].T)},
                "v": lin(f"{pfx}.self_attn.v_proj"),
                "out": lin(f"{pfx}.self_attn.out_proj"),
            },
            "ln2": lnp(f"{pfx}.final_layer_norm"),
            "fc1": lin(f"{pfx}.fc1"),
            "fc2": lin(f"{pfx}.fc2"),
        })
    return p
