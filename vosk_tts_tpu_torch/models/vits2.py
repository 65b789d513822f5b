"""MB-iSTFT-VITS2 inference (vosk_tts_tpu/models/vits2.py), channels-last.

The port runs the shipped serving configuration: ``pre_conv2``
transformer flows, the ``mb_istft`` decoder with the fused tail
(``istft_mode`` "torch"), and the stochastic duration predictor. The
generator also runs as the HiFiGAN v1 vocoder of the multistream bundles
(``decoder_type="hifigan"`` without speaker conditioning,
models/vocoder.py). Other flow types and decoders, the deterministic
duration predictor and the posterior encoder raise NotImplementedError.

Shapes are bucketed as in the JAX package (``max_frames``, ``gen_frames``)
so that both packages see the same shapes; real lengths are returned for
trimming. Noise comes from an explicit ``torch.Generator`` on the model's
device (the JAX package's jax.random draws other numbers).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F

from ..ops import attention as att
from ..ops import flows as fl
from ..ops import wn as wnops
from ..ops.commons import generate_path, sequence_mask
from ..ops.conv import conv1d, conv_transpose1d
from ..ops.stft import mb_decoder_tail_fused
from .tree import TreeModule


@dataclass(frozen=True)
class VITS2Config:
    n_vocab: int = 62
    spec_channels: int = 80
    segment_size: int = 32
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.1
    resblock: str = "1"
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: Sequence[int] = (4, 4)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: Sequence[int] = (16, 16)
    upsample_paddings: Sequence[int] | None = None
    upsample_output_paddings: Sequence[int] | None = None
    gen_istft_n_fft: int = 16
    gen_istft_hop_size: int = 4
    subbands: int = 4
    n_speakers: int = 200
    gin_channels: int = 256
    use_sdp: bool = True
    use_spk_conditioned_encoder: bool = True
    use_transformer_flows: bool = True
    transformer_flow_type: str = "pre_conv2"
    decoder_type: str = "mb_istft"
    istft_mode: str = "torch"
    use_noise_scaled_mas: bool = False
    mas_noise_scale_initial: float = 0.01
    noise_scale_delta: float = 2e-6
    n_flows: int = 4
    posterior_wn_layers: int = 16
    sdp_n_flows: int = 4

    @property
    def enc_gin_channels(self) -> int:
        return self.gin_channels if (self.use_spk_conditioned_encoder and self.gin_channels > 0) else 0

    @property
    def upsample_factor(self) -> int:
        """Output samples per input frame of the decoder."""
        up = math.prod(self.upsample_rates)
        if self.decoder_type in ("mb_istft", "ms_istft"):
            return up * self.gen_istft_hop_size * self.subbands
        if self.decoder_type == "istft":
            return up * self.gen_istft_hop_size
        return up

    @classmethod
    def from_dict(cls, d: dict) -> "VITS2Config":
        """From a bundle's ``"model"`` block, where JSON lists stand for tuples."""
        tup = lambda v: tuple(tup(e) for e in v) if isinstance(v, list) else v
        return cls(**{k: tup(v) for k, v in d.items()})


def check_decoder(cfg: VITS2Config):
    """Raise NotImplementedError for a generator the port does not run: it
    runs ``mb_istft`` with the torch iSTFT, and ``hifigan`` without speaker
    conditioning (the vocoder form)."""
    if cfg.decoder_type == "hifigan":
        if cfg.gin_channels:
            raise NotImplementedError("the speaker-conditioned hifigan decoder is not ported")
    elif cfg.decoder_type != "mb_istft" or cfg.istft_mode != "torch":
        raise NotImplementedError(f"decoder {cfg.decoder_type!r} ({cfg.istft_mode!r} iSTFT) "
                                  "is not ported")


def check_ported(cfg: VITS2Config):
    """Raise NotImplementedError for a synthesizer configuration the port
    does not run: SDP, ``pre_conv2`` flows and the ``mb_istft`` decoder."""
    if not cfg.use_sdp:
        raise NotImplementedError("the deterministic duration predictor (dp_apply) is not ported")
    if not cfg.use_transformer_flows or cfg.transformer_flow_type != "pre_conv2":
        raise NotImplementedError(f"flow type {cfg.transformer_flow_type!r} is not ported")
    if cfg.decoder_type != "mb_istft":
        raise NotImplementedError(f"a synthesizer with the {cfg.decoder_type!r} decoder "
                                  "is not ported")
    check_decoder(cfg)


# ---------------------------------------------------------------------------
# Text encoder
# ---------------------------------------------------------------------------


def text_encoder_apply(params, cfg: VITS2Config, x_ids, x_lengths, g=None):
    """x_ids: (B, T) int -> (x (B, T, H), m, logs, x_mask (B, T, 1))."""
    h = cfg.hidden_channels
    x = params["emb"][x_ids.long()] * math.sqrt(h)
    x_mask = sequence_mask(x_lengths, x_ids.shape[1]).to(x.dtype)[..., None]
    x = att.encoder_apply(params["encoder"], x * x_mask, x_mask, g,
                          n_heads=cfg.n_heads, kernel_size=cfg.kernel_size)
    stats = conv1d(x, params["proj"]["w"], params["proj"]["b"]) * x_mask
    return x, stats[..., :cfg.inter_channels], stats[..., cfg.inter_channels:], x_mask


# ---------------------------------------------------------------------------
# Stochastic duration predictor, reverse pass
# ---------------------------------------------------------------------------


def _sdp_context(params, x, x_mask, g, *, kernel_size=3):
    x = conv1d(x, params["pre"]["w"], params["pre"]["b"])
    if g is not None:
        x = x + conv1d(g, params["cond"]["w"], params["cond"]["b"])
    x = wnops.ddsconv_apply(params["convs"], x, x_mask, kernel_size=kernel_size)
    return conv1d(x, params["proj"]["w"], params["proj"]["b"]) * x_mask


def sdp_reverse(params, cfg: VITS2Config, x, x_mask, g=None, *, generator=None,
                noise_scale=1.0, filter_channels=256, kernel_size=3):
    """Sample log-durations (B, T, 1). Runs four DDSConv stacks: the context
    net, then ConvFlows 4, 3 and 2 (ConvFlow 1 is dropped in reverse)."""
    ctx = _sdp_context(params, x, x_mask, g, kernel_size=kernel_size)
    b, t, _ = x.shape
    z = torch.randn((b, t, 2), generator=generator, device=x.device, dtype=x.dtype) * noise_scale
    for cf in params["flows"][:0:-1][:-1]:  # CF4, CF3, CF2
        z = fl.flip_flow(z)
        z = fl.convflow_apply(cf, z, x_mask, g=ctx, filter_channels=filter_channels,
                              kernel_size=kernel_size)
    z = fl.flip_flow(z)
    z = fl.elementwise_affine_apply(params["flows"][0], z, x_mask)
    return z[..., :1]


# ---------------------------------------------------------------------------
# Flow block (pre_conv2), reverse pass
# ---------------------------------------------------------------------------


def _flow_layer_apply(layer, cfg: VITS2Config, x, x_mask, g):
    """Reverse of one ``pre_conv2`` coupling layer (mean-only)."""
    half = cfg.inter_channels // 2
    x0, x1 = x[..., :half], x[..., half:]
    hid = conv1d(x0, layer["pre"]["w"], layer["pre"]["b"]) * x_mask
    # the flow block's kernel_size is 5 (inherited by Layer2's pre_transformer)
    hid = hid + att.encoder_apply(layer["pre_transformer"], hid * x_mask, x_mask,
                                  n_heads=2, kernel_size=5, window_size=4)
    hid = wnops.wn_apply(layer["enc"], hid, x_mask, g, kernel_size=5, dilation_rate=1)
    m = conv1d(hid, layer["post"]["w"], layer["post"]["b"]) * x_mask
    return torch.cat([x0, (x1 - m) * x_mask], dim=-1)


def flow_block_apply(params, cfg: VITS2Config, x, x_mask, g=None):
    """The flow in reverse (``reverse=True`` in the JAX package; the forward
    direction is training-only): for each (coupling, Flip) group from the
    last, Flip then the coupling layer's inverse."""
    check_ported(cfg)
    for layer in reversed(params["flows"]):
        x = fl.flip_flow(x)
        x = _flow_layer_apply(layer, cfg, x, x_mask, g)
    return x


# ---------------------------------------------------------------------------
# MB-iSTFT generator
# ---------------------------------------------------------------------------


def _generator_trunk(params, cfg: VITS2Config, x):
    x = conv1d(x, params["conv_pre"]["w"], params["conv_pre"]["b"], padding=3)
    n_kernels = len(cfg.resblock_kernel_sizes)
    resblock_apply = wnops.resblock1_apply if cfg.resblock == "1" else wnops.resblock2_apply
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        x = wnops.leaky_relu(x)
        pad = cfg.upsample_paddings[i] if cfg.upsample_paddings else (k - u) // 2
        opad = cfg.upsample_output_paddings[i] if cfg.upsample_output_paddings else 0
        x = conv_transpose1d(x, params["ups"][i]["w"], params["ups"][i]["b"], stride=u,
                             padding=pad, output_padding=opad)
        xs = None
        for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)):
            r = resblock_apply(params["resblocks"][i * n_kernels + j], x, kernel_size=rk,
                               dilation=tuple(rd))
            xs = r if xs is None else xs + r
        x = xs / n_kernels
    # the final activation uses torch's default slope 0.01, not LRELU_SLOPE
    return wnops.leaky_relu(x, 0.01)


def generator_apply(params, cfg: VITS2Config, x):
    """x: (B, T, inter) -> waveform (B, T * upsample_factor, 1): for
    ``mb_istft`` through the fused iSTFT + PQMF tail (the JAX
    ``fused_tail=True`` serving form); for ``hifigan`` through ``conv_post``
    (padding 3, no bias, no reflection pad) and tanh."""
    check_decoder(cfg)
    x = _generator_trunk(params, cfg, x)
    if cfg.decoder_type == "hifigan":
        return torch.tanh(conv1d(x, params["conv_post"]["w"], params["conv_post"]["b"], padding=3))
    x = F.pad(x.transpose(1, 2), (1, 0), mode="reflect").transpose(1, 2)  # ReflectionPad1d((1, 0))
    x = conv1d(x, params["conv_post"]["w"], params["conv_post"]["b"], padding=3)
    n_fft = cfg.gen_istft_n_fft
    return mb_decoder_tail_fused(x, n_fft, cfg.gen_istft_hop_size, n_fft, subbands=cfg.subbands)


# ---------------------------------------------------------------------------
# Serving passes
# ---------------------------------------------------------------------------


def _speaker(params, cfg, sid):
    return params["emb_g"][sid.long()][:, None, :] if cfg.n_speakers > 1 else None


def encode_for_infer(params, cfg: VITS2Config, x_ids, x_lengths, sid=None, *, generator=None,
                     length_scale: float | torch.Tensor = 1.0,
                     noise_scale_w: float | torch.Tensor = 0.8):
    """Pass one of the split serving path: text encoder + SDP. Returns a dict
    (m_p, logs_p, x_mask, w_ceil, pred_frames) for
    :func:`decode_from_durations`. Each scale is a float or a (B, 1, 1)
    tensor, one value a row (the batcher's per-request knobs)."""
    check_ported(cfg)
    g = _speaker(params, cfg, sid)
    x, m_p, logs_p, x_mask = text_encoder_apply(params["enc_p"], cfg, x_ids, x_lengths,
                                                g if cfg.enc_gin_channels else None)
    logw = sdp_reverse(params["dp"], cfg, x, x_mask, g, generator=generator,
                       noise_scale=noise_scale_w)
    w_ceil = torch.ceil(torch.exp(logw) * x_mask * length_scale)[..., 0]
    pred = w_ceil.sum(dim=-1).clamp(min=1).to(torch.int32)
    return {"m_p": m_p, "logs_p": logs_p, "x_mask": x_mask, "w_ceil": w_ceil,
            "pred_frames": pred}


def decode_from_durations(params, cfg: VITS2Config, enc: dict, sid=None, *, generator=None,
                          max_frames: int, noise_scale: float | torch.Tensor = 0.667,
                          gen_frames: int | None = None):
    """Pass two: alignment expansion + reverse flow + decoder. ``gen_frames``
    (<= max_frames) runs the generator on only the first frames; the caller
    picks it >= every item's frame count. ``noise_scale`` is a float or a
    (B, 1, 1) tensor."""
    g = _speaker(params, cfg, sid)
    m_p, logs_p, x_mask, w_ceil = enc["m_p"], enc["logs_p"], enc["x_mask"], enc["w_ceil"]
    y_lengths = w_ceil.sum(dim=-1).clamp(1, max_frames).to(torch.int32)
    y_mask = sequence_mask(y_lengths, max_frames).to(x_mask.dtype)[..., None]
    attn = generate_path(w_ceil, x_mask[..., 0], y_mask[..., 0])

    m_p = torch.bmm(attn, m_p)
    logs_p = torch.bmm(attn, logs_p)
    noise = torch.randn(m_p.shape, generator=generator, device=m_p.device, dtype=m_p.dtype)
    z_p = m_p + noise * torch.exp(logs_p) * noise_scale
    z = flow_block_apply(params["flow"], cfg, z_p, y_mask, g)
    zy = z * y_mask
    if gen_frames is not None and gen_frames < max_frames:
        zy = zy[:, :gen_frames]
        y_lengths = torch.minimum(y_lengths, torch.tensor(gen_frames, dtype=y_lengths.dtype,
                                                          device=y_lengths.device))
    wav = generator_apply(params["dec"], cfg, zy)
    return {"wav": wav, "wav_lengths": y_lengths * cfg.upsample_factor, "attn": attn,
            "y_mask": y_mask, "durations": w_ceil}


def infer(params, cfg: VITS2Config, x_ids, x_lengths, sid=None, *, generator=None,
          max_frames: int, noise_scale: float | torch.Tensor = 0.667,
          length_scale: float | torch.Tensor = 1.0, noise_scale_w: float | torch.Tensor = 0.8):
    """Single-pass inference at a fixed frame capacity (scales as in
    :func:`encode_for_infer`)."""
    enc = encode_for_infer(params, cfg, x_ids, x_lengths, sid, generator=generator,
                           length_scale=length_scale, noise_scale_w=noise_scale_w)
    return decode_from_durations(params, cfg, enc, sid, generator=generator,
                                 max_frames=max_frames, noise_scale=noise_scale)


def predict_frames(params, cfg: VITS2Config, x_ids, x_lengths, sid=None, *, generator=None,
                   length_scale: float | torch.Tensor = 1.0,
                   noise_scale_w: float | torch.Tensor = 0.8):
    """Predicted total frames (B,) int32, unclipped: pass one only."""
    return encode_for_infer(params, cfg, x_ids, x_lengths, sid, generator=generator,
                            length_scale=length_scale, noise_scale_w=noise_scale_w)["pred_frames"]


class Synthesizer(TreeModule):
    """The weights of one VITS2 bundle as a module (models/tree.py): every
    leaf of the port-layout tree is a buffer, and :attr:`params` gives the
    nested tree the functions above take."""

    def __init__(self, cfg: VITS2Config, tree):
        check_ported(cfg)
        super().__init__(tree)
        self.cfg = cfg

    def encode_for_infer(self, *args, **kwargs):
        return encode_for_infer(self.params, self.cfg, *args, **kwargs)

    def decode_from_durations(self, *args, **kwargs):
        return decode_from_durations(self.params, self.cfg, *args, **kwargs)

    def infer(self, *args, **kwargs):
        return infer(self.params, self.cfg, *args, **kwargs)
