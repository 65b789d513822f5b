"""MB-iSTFT-VITS2 (vosk_tts_tpu/models/vits2.py), channels-last: inference
and the training forward.

The serving passes (``Synthesizer``) run every configuration the JAX
``Synthesizer`` runs: the flow types ``plain``, ``pre_conv``, ``pre_conv2``,
``fft``, ``mono_layer_inter_residual`` and ``mono_layer_post_residual`` in
both directions, the stochastic (``use_sdp``) or the deterministic duration
predictor, and the ``hifigan``, ``istft``, ``mb_istft`` (fused tail in
serving) and ``ms_istft`` decoders, each iSTFT in ``istft_mode`` "torch" or
"onnx". Voice conversion adds the posterior encoder and the flow's forward
direction (``voice_conversion``; QuickVC in models/quickvc.py). The
generator also runs as the HiFiGAN v1 vocoder of the multistream bundles
(``decoder_type="hifigan"`` without speaker conditioning,
models/vocoder.py) and as GPT-SoVITS's speaker-conditioned ``hifigan``
decoder with padded-frame masking (models/gpt_sovits.py). Training
(``forward_train``, train/vits2_train.py) runs every one of those
configurations, with the monotonic alignment search (ops/mas.py) and the
SDP's NLL or ``dp_apply``'s squared log-duration error; its attention and
DDSConv take the differentiable routes (``flash=False``, ``fused=False``)
where the JAX package takes its XLA branches, and every decoder runs its
unfused tail.

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
from ..ops.commons import (as_dtype, at_least_f32, generate_path, rand_slice_segments,
                           sequence_mask)
from ..ops.conv import conv1d
from ..ops.mas import maximum_path
from ..ops.pqmf import polyphase_upfir, pqmf_synthesis
from ..ops.norm import layer_norm
from ..ops.stft import istft, istft_multiband, mb_decoder_tail_fused
from ..parallel import tp as ptp
from ..parallel.mesh import total
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
    def from_reference_json(cls, model_cfg: dict, data_cfg: dict, train_cfg: dict) -> "VITS2Config":
        """From the reference config.json's model, data and train blocks
        (training/vits2/configs/mb_istft_vits2_multi.json), as the JAX
        package reads them, and the model block's ``istft_mode`` ("torch"
        or "onnx"), which the JAX reader leaves at "torch"."""
        decoder = next((d for key, d in (("mb_istft_vits", "mb_istft"), ("ms_istft_vits", "ms_istft"),
                                          ("istft_vits", "istft")) if model_cfg.get(key)), "hifigan")
        spec_channels = (data_cfg.get("n_mel_channels", 80)
                         if model_cfg.get("use_mel_posterior_encoder", False)
                         else data_cfg.get("filter_length", 1024) // 2 + 1)
        get = model_cfg.get
        return cls(
            n_vocab=get("n_vocab", 62), spec_channels=spec_channels,
            segment_size=train_cfg.get("segment_size", 8192) // data_cfg.get("hop_length", 256),
            inter_channels=get("inter_channels", 192), hidden_channels=get("hidden_channels", 192),
            filter_channels=get("filter_channels", 768), n_heads=get("n_heads", 2),
            n_layers=get("n_layers", 6), n_flows=get("n_flows", 4),
            posterior_wn_layers=get("posterior_wn_layers", 16), sdp_n_flows=get("sdp_n_flows", 4),
            kernel_size=get("kernel_size", 3), p_dropout=get("p_dropout", 0.1),
            resblock=get("resblock", "1"),
            resblock_kernel_sizes=tuple(get("resblock_kernel_sizes", (3, 7, 11))),
            resblock_dilation_sizes=tuple(tuple(d) for d in get(
                "resblock_dilation_sizes", ((1, 3, 5), (1, 3, 5), (1, 3, 5)))),
            upsample_rates=tuple(get("upsample_rates", (4, 4))),
            upsample_initial_channel=get("upsample_initial_channel", 512),
            upsample_kernel_sizes=tuple(get("upsample_kernel_sizes", (16, 16))),
            gen_istft_n_fft=get("gen_istft_n_fft", 16),
            gen_istft_hop_size=get("gen_istft_hop_size", 4), subbands=get("subbands", 4),
            n_speakers=data_cfg.get("n_speakers", get("n_speakers", 0)),
            gin_channels=get("gin_channels", 0), use_sdp=get("use_sdp", True),
            use_spk_conditioned_encoder=get("use_spk_conditioned_encoder", False),
            use_transformer_flows=get("use_transformer_flows", False),
            transformer_flow_type=get("transformer_flow_type", "pre_conv"),
            decoder_type=decoder, istft_mode=get("istft_mode", "torch"),
            use_noise_scaled_mas=get("use_noise_scaled_mas", False),
            mas_noise_scale_initial=get("mas_noise_scale_initial", 0.01),
            noise_scale_delta=get("noise_scale_delta", 2e-6),
        )

    @classmethod
    def from_dict(cls, d: dict) -> "VITS2Config":
        """From a bundle's ``"model"`` block, where JSON lists stand for tuples."""
        tup = lambda v: tuple(tup(e) for e in v) if isinstance(v, list) else v
        return cls(**{k: tup(v) for k, v in d.items()})


def flow_type(cfg: VITS2Config) -> str:
    return cfg.transformer_flow_type if cfg.use_transformer_flows else "plain"


FLOW_TYPES = ("plain", "pre_conv", "pre_conv2", "fft", "mono_layer_inter_residual",
              "mono_layer_post_residual")
DECODERS = ("hifigan", "istft", "mb_istft", "ms_istft")


def check_flow(cfg: VITS2Config):
    """Raise ValueError for a flow type that neither package knows."""
    if flow_type(cfg) not in FLOW_TYPES:
        raise ValueError(f"unknown flow type {flow_type(cfg)!r}")


def check_decoder(cfg: VITS2Config):
    """Raise ValueError for a generator that neither package knows."""
    if cfg.decoder_type not in DECODERS or cfg.istft_mode not in ("torch", "onnx"):
        raise ValueError(f"unknown decoder {cfg.decoder_type!r} ({cfg.istft_mode!r} iSTFT)")


def check_ported(cfg: VITS2Config):
    """Raise ValueError for a synthesizer configuration that neither
    package knows: the serving passes run every known one."""
    check_flow(cfg)
    check_decoder(cfg)


# ---------------------------------------------------------------------------
# Text encoder
# ---------------------------------------------------------------------------


def text_encoder_apply(params, cfg: VITS2Config, x_ids, x_lengths, g=None, *,
                       flash: bool = True):
    """x_ids: (B, T) int -> (x (B, T, H), m, logs, x_mask (B, T, 1)).
    ``flash`` picks the attention route (ops/attention.py)."""
    h = cfg.hidden_channels
    x = params["emb"][x_ids.long()] * math.sqrt(h)
    x_mask = sequence_mask(x_lengths, x_ids.shape[1]).to(x.dtype)[..., None]
    x = att.encoder_apply(params["encoder"], x * x_mask, x_mask, g,
                          n_heads=cfg.n_heads, kernel_size=cfg.kernel_size, flash=flash)
    stats = conv1d(x, params["proj"]["w"], params["proj"]["b"]) * x_mask
    return x, stats[..., :cfg.inter_channels], stats[..., cfg.inter_channels:], x_mask


# ---------------------------------------------------------------------------
# Stochastic duration predictor: the sampling (reverse) pass and the NLL
# ---------------------------------------------------------------------------


# the SDP's DDSConv and ConvFlow widths (the reference's fixed 256 and 3)
SDP_FILTER_CHANNELS, SDP_KERNEL = 256, 3
DP_KERNEL = 3


def _sdp_context(params, x, x_mask, g, *, fused: bool):
    """The condition net over the detached encoder output (and speaker)."""
    x = conv1d(x.detach(), params["pre"]["w"], params["pre"]["b"])
    if g is not None:
        x = x + conv1d(g.detach(), params["cond"]["w"], params["cond"]["b"])
    x = wnops.ddsconv_apply(params["convs"], x, x_mask, kernel_size=SDP_KERNEL, fused=fused)
    return conv1d(x, params["proj"]["w"], params["proj"]["b"]) * x_mask


def sdp_reverse(params, cfg: VITS2Config, x, x_mask, g=None, *, generator=None, noise=None,
                noise_scale=1.0, fused: bool = True):
    """Sample log-durations (B, T, 1). Runs four DDSConv stacks: the context
    net, then ConvFlows 4, 3 and 2 (ConvFlow 1 is dropped in reverse).
    ``noise`` (B, T, 2) is the standard normal draw (else from
    ``generator``). ``fused`` (serving) takes the DDSConv kernel; training
    passes False: its duration-discriminator branch differentiates this
    pass."""
    ctx = _sdp_context(params, x, x_mask, g, fused=fused)
    b, t, _ = x.shape
    if noise is None:
        noise = torch.randn((b, t, 2), generator=generator, device=x.device, dtype=x.dtype)
    z = noise * as_dtype(noise_scale, noise.dtype)
    for cf in params["flows"][:0:-1][:-1]:  # CF4, CF3, CF2
        z = fl.flip_flow(z)
        z = fl.convflow_apply(cf, z, x_mask, g=ctx, reverse=True,
                              filter_channels=SDP_FILTER_CHANNELS, kernel_size=SDP_KERNEL,
                              fused=fused)
    z = fl.flip_flow(z)
    z = fl.elementwise_affine_apply(params["flows"][0], z, x_mask, reverse=True)
    return z[..., :1]


def sdp_forward_nll(params, cfg: VITS2Config, x, x_mask, w, g=None, *, generator=None,
                    noise=None):
    """Training NLL (B,) of the observed durations w (B, T, 1): the
    posterior flows turn the draw e_q (B, T, 2) (``noise``, else from
    ``generator``) into the dequantisation u and the second channel, the
    main flows map (log(w - u), z1) to the prior. Every DDSConv stack takes
    the differentiable route. Flip's log-determinant is 0."""
    ctx = _sdp_context(params, x, x_mask, g, fused=False)
    b, t, _ = x.shape
    h_w = conv1d(w, params["post_pre"]["w"], params["post_pre"]["b"])
    h_w = wnops.ddsconv_apply(params["post_convs"], h_w, x_mask, kernel_size=SDP_KERNEL,
                              fused=False)
    h_w = conv1d(h_w, params["post_proj"]["w"], params["post_proj"]["b"]) * x_mask
    if noise is None:
        noise = torch.randn((b, t, 2), generator=generator, device=x.device, dtype=x.dtype)
    e_q = noise * x_mask
    gq = ctx + h_w
    z_q, logdet_q = fl.elementwise_affine_apply(params["post_flows"][0], e_q, x_mask,
                                                reverse=False)
    for cf in params["post_flows"][1:]:
        z_q, ld = fl.convflow_apply(cf, z_q, x_mask, g=gq, reverse=False,
                                    filter_channels=SDP_FILTER_CHANNELS, kernel_size=SDP_KERNEL,
                                    fused=False)
        logdet_q = logdet_q + ld
        z_q = fl.flip_flow(z_q)
    z_u, z1 = z_q[..., :1], z_q[..., 1:]
    u = torch.sigmoid(z_u) * x_mask
    z0 = (w - u) * x_mask
    logdet_q = logdet_q + ((F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * x_mask).sum(dim=(1, 2))
    logq = (-0.5 * (math.log(2 * math.pi) + e_q**2) * x_mask).sum(dim=(1, 2)) - logdet_q

    z0, logdet = fl.log_flow(z0, x_mask)
    z, ld = fl.elementwise_affine_apply(params["flows"][0], torch.cat([z0, z1], dim=-1), x_mask,
                                        reverse=False)
    logdet = logdet + ld
    for cf in params["flows"][1:]:
        z, ld = fl.convflow_apply(cf, z, x_mask, g=ctx, reverse=False,
                                  filter_channels=SDP_FILTER_CHANNELS, kernel_size=SDP_KERNEL,
                                  fused=False)
        logdet = logdet + ld
        z = fl.flip_flow(z)
    nll = (0.5 * (math.log(2 * math.pi) + z**2) * x_mask).sum(dim=(1, 2)) - logdet
    return nll + logq


def dp_apply(params, cfg: VITS2Config, x, x_mask, g=None):
    """The deterministic duration predictor: log-durations (B, T, 1) from
    two conv -> ReLU -> LayerNorm stages over the detached encoder output
    (and speaker), then a 1x1 projection."""
    x = x.detach()
    if g is not None:
        x = x + conv1d(g.detach(), params["cond"]["w"], params["cond"]["b"])
    for i in (1, 2):
        x = conv1d(x * x_mask, params[f"conv{i}"]["w"], params[f"conv{i}"]["b"],
                   padding=DP_KERNEL // 2)
        x = layer_norm(torch.relu(x), params[f"norm{i}"]["gamma"], params[f"norm{i}"]["beta"])
    return conv1d(x * x_mask, params["proj"]["w"], params["proj"]["b"]) * x_mask


# ---------------------------------------------------------------------------
# Posterior encoder
# ---------------------------------------------------------------------------


def posterior_apply(params, cfg: VITS2Config, y, y_lengths, g=None, *, generator=None,
                    noise=None):
    """y: (B, T, spec_channels) -> (z, m, logs, y_mask), z = (m + noise *
    exp(logs)) * y_mask. ``noise`` (B, T, inter_channels) is the standard
    normal draw; without it the draw comes from ``generator``."""
    y_mask = sequence_mask(y_lengths, y.shape[1]).to(y.dtype)[..., None]
    x = conv1d(y, params["pre"]["w"], params["pre"]["b"]) * y_mask
    x = wnops.wn_apply(params["enc"], x, y_mask, g, kernel_size=5, dilation_rate=1)
    stats = conv1d(x, params["proj"]["w"], params["proj"]["b"]) * y_mask
    m, logs = stats[..., :cfg.inter_channels], stats[..., cfg.inter_channels:]
    if noise is None:
        noise = torch.randn(m.shape, generator=generator, device=m.device, dtype=m.dtype)
    return (m + noise * torch.exp(logs)) * y_mask, m, logs, y_mask


# ---------------------------------------------------------------------------
# Flow block (every flow type), both directions
# ---------------------------------------------------------------------------


def _shift_half(x, m, x_mask, reverse: bool):
    """The mean-only affine coupling of the second half by m."""
    half = x.shape[-1] // 2
    x0, x1 = x[..., :half], x[..., half:]
    x1 = (x1 - m) * x_mask if reverse else m + x1 * x_mask
    return torch.cat([x0, x1], dim=-1)


def _flow_layer_apply(layer, cfg: VITS2Config, ftype: str, x, x_mask, g, *, reverse: bool,
                      flash: bool):
    """One ``pre_conv``, ``pre_conv2`` or ``fft`` coupling layer (mean-only)."""
    x0 = x[..., :cfg.inter_channels // 2]
    if ftype == "pre_conv":
        # windowless attention over the first half (kernel 5 with ``flash``)
        x0 = x0 + att.encoder_apply(layer["pre_transformer"], x0 * x_mask, x_mask, n_heads=2,
                                    kernel_size=3, window_size=None, flash=flash)
        hid = conv1d(x0, layer["pre"]["w"], layer["pre"]["b"]) * x_mask
        hid = wnops.wn_apply(layer["enc"], hid, x_mask, g, kernel_size=5, dilation_rate=1)
    elif ftype == "pre_conv2":
        hid = conv1d(x0, layer["pre"]["w"], layer["pre"]["b"]) * x_mask
        # the flow block's kernel_size is 5 (inherited by Layer2's pre_transformer)
        hid = hid + att.encoder_apply(layer["pre_transformer"], hid * x_mask, x_mask,
                                      n_heads=2, kernel_size=5, window_size=4, flash=flash)
        hid = wnops.wn_apply(layer["enc"], hid, x_mask, g, kernel_size=5, dilation_rate=1)
    else:  # fft
        hid = conv1d(x0, layer["pre"]["w"], layer["pre"]["b"]) * x_mask
        hid = hid + att.fft_apply(layer["enc"], hid, x_mask, g, n_heads=4, kernel_size=5)
    m = conv1d(hid, layer["post"]["w"], layer["post"]["b"]) * x_mask
    return _shift_half(x, m, x_mask, reverse)


def _mono_layer_apply(layer, cfg: VITS2Config, x, x_mask, *, reverse: bool, residual: bool,
                      flash: bool):
    """The mono transformer flow layer (mean-only): windowless attention
    over the first half (kernel 5 with ``flash``) gives the shift of the
    second. The ``residual`` (post-residual) form adds its input in the
    forward direction, so its reverse halves both halves."""
    half = cfg.inter_channels // 2

    def shift(x0):
        h = att.encoder_apply(layer["pre_transformer"], x0 if residual else x0 * x_mask, x_mask,
                              n_heads=2, kernel_size=3, window_size=None, flash=flash)
        return conv1d(h if residual else h + x0, layer["post"]["w"], layer["post"]["b"]) * x_mask

    if not residual:
        return _shift_half(x, shift(x[..., :half]), x_mask, reverse)
    x0, x1 = x[..., :half], x[..., half:]
    if not reverse:
        return x + torch.cat([x0, shift(x0) + x1 * x_mask], dim=-1)
    x0 = x0 / 2
    return torch.cat([x0, (x1 - shift(x0)) / 2 * x_mask], dim=-1)


def flow_block_apply(params, cfg: VITS2Config, x, x_mask, g=None, *, reverse: bool,
                     flash: bool = True):
    """The flow: groups of (coupling layer, Flip), or for the mono types
    (residual coupling, Flip, mono layer). Forward runs each group from
    the first; reverse runs the groups from the last, each group's
    contents backwards. ``flash`` picks the attention route of the
    ``pre_conv``, ``pre_conv2`` and mono layers."""
    check_flow(cfg)
    ftype = flow_type(cfg)

    def coupling(layer, x, rev):
        if "coupling" in layer:
            return fl.residual_coupling_apply(layer["coupling"], x, x_mask, g, reverse=rev,
                                              kernel_size=5, dilation_rate=1)
        return _flow_layer_apply(layer, cfg, ftype, x, x_mask, g, reverse=rev, flash=flash)

    mono = ftype.startswith("mono_layer")
    residual = ftype == "mono_layer_post_residual"
    if not reverse:
        for layer in params["flows"]:
            x = fl.flip_flow(coupling(layer, x, False))
            if mono:
                x = _mono_layer_apply(layer["mono"], cfg, x, x_mask, reverse=False,
                                      residual=residual, flash=flash)
        return x
    for layer in reversed(params["flows"]):
        if mono:
            x = _mono_layer_apply(layer["mono"], cfg, x, x_mask, reverse=True, residual=residual,
                                  flash=flash)
        x = coupling(layer, fl.flip_flow(x), True)
    return x


# ---------------------------------------------------------------------------
# Generators (HiFiGAN trunk; hifigan, mb_istft and ms_istft heads)
# ---------------------------------------------------------------------------


def _generator_trunk(params, cfg: VITS2Config, x, g=None, *, x_lengths=None, tp=None):
    """``x_lengths`` (B,), where given, re-zeroes every conv input beyond
    each row's length (scaled by each upsample), so that the samples below
    the length equal an unpadded run's. ``tp``: as in :func:`generator_apply`;
    the activations between its convs may be channel-sharded."""
    lengths = x_lengths
    mask = None if lengths is None else sequence_mask(lengths, x.shape[1]).to(x.dtype)[..., None]
    x = ptp.conv(tp, ("conv_pre",), x, params["conv_pre"], padding=3)
    if g is not None and "cond" in params:
        c = ptp.conv(tp, ("cond",), g, params["cond"])
        x = x + c if tp is None else tp.add(x, c)
    if mask is not None:
        x = x * mask
    n_kernels = len(cfg.resblock_kernel_sizes)
    resblock_apply = wnops.resblock1_apply if cfg.resblock == "1" else wnops.resblock2_apply
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        x = wnops.leaky_relu(x)
        pad = cfg.upsample_paddings[i] if cfg.upsample_paddings else (k - u) // 2
        opad = cfg.upsample_output_paddings[i] if cfg.upsample_output_paddings else 0
        x = ptp.conv(tp, ("ups", i), x, params["ups"][i], transpose=True, stride=u, padding=pad,
                     output_padding=opad)
        if lengths is not None:
            lengths = lengths * u
            mask = sequence_mask(lengths, x.shape[1]).to(x.dtype)[..., None]
            x = x * mask
        xs = None
        for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)):
            k_rb = i * n_kernels + j
            r = resblock_apply(params["resblocks"][k_rb], x, mask, kernel_size=rk,
                               dilation=tuple(rd),
                               tp=None if tp is None else tp.scope("resblocks", k_rb))
            xs = r if xs is None else xs + r
        x = xs / n_kernels
    # the final activation uses torch's default slope 0.01, not LRELU_SLOPE
    return wnops.leaky_relu(x, 0.01)


def generator_apply(params, cfg: VITS2Config, x, g=None, *, x_lengths=None,
                    fused_tail: bool = False, tp=None):
    """x: (B, T, inter), g: (B, 1, gin) or None (read where the bundle has a
    ``cond`` conv) -> (waveform (B, T * upsample_factor, 1), the subband
    waveforms (B, T * upsample_factor / subbands, subbands) of the unfused
    ``mb_istft`` and ``ms_istft`` tails, else None). ``x_lengths``
    (B,) masks padded frames in the trunk (:func:`_generator_trunk`): for
    ``hifigan`` the samples below length * upsample_factor then equal an
    unpadded decode's. ``hifigan``:
    ``conv_post`` (padding 3, no reflection pad) and tanh. ``mb_istft``:
    the multiband iSTFT and PQMF synthesis, or with ``fused_tail`` the
    fused tail of the serving path (ops/stft.mb_decoder_tail_fused), which
    gives no subband waveforms: training reads them, serving does not.
    ``ms_istft``: the multiband iSTFT, then the learned upsampling filter
    ``multistream_conv_post``. ``istft``: the single-band iSTFT. Every
    iSTFT takes ``cfg.istft_mode``.

    ``tp`` (a ``parallel.tp.TensorParallel``, with ``params`` this rank's
    part from ``parallel.tp.shard_generator_params``) runs the trunk and
    ``conv_post`` tensor-parallel over its model axis; the output is whole
    and equal on every rank of the axis."""
    check_decoder(cfg)
    x = _generator_trunk(params, cfg, x, g, x_lengths=x_lengths, tp=tp)
    if cfg.decoder_type == "hifigan":
        return torch.tanh(ptp.conv(tp, ("conv_post",), x, params["conv_post"], padding=3)), None
    x = F.pad(x.transpose(1, 2), (1, 0), mode="reflect").transpose(1, 2)  # ReflectionPad1d((1, 0))
    x = ptp.conv(tp, ("conv_post",), x, params["conv_post"], padding=3)
    n_fft, hop, sub, mode = cfg.gen_istft_n_fft, cfg.gen_istft_hop_size, cfg.subbands, cfg.istft_mode
    cutoff = n_fft // 2 + 1
    if cfg.decoder_type == "istft":
        return istft(torch.exp(x[..., :cutoff]), math.pi * torch.sin(x[..., cutoff:]),
                     n_fft, hop, n_fft, mode=mode)[..., None], None
    if cfg.decoder_type == "mb_istft" and fused_tail:
        return mb_decoder_tail_fused(x, n_fft, hop, n_fft, subbands=sub, mode=mode), None
    b, t, _ = x.shape
    x = x.reshape(b, t, sub, n_fft + 2)
    y_mb = istft_multiband(torch.exp(x[..., :cutoff]), math.pi * torch.sin(x[..., cutoff:]),
                           n_fft, hop, n_fft, mode=mode)
    if cfg.decoder_type == "mb_istft":
        return pqmf_synthesis(y_mb, subbands=sub), y_mb
    return polyphase_upfir(y_mb, params["multistream_conv_post"]["w"], stride=sub,
                           gain=float(sub)), y_mb


# ---------------------------------------------------------------------------
# Serving passes
# ---------------------------------------------------------------------------


def _speaker(params, cfg, sid):
    return params["emb_g"][sid.long()][:, None, :] if cfg.n_speakers > 1 else None


def encode_for_infer(params, cfg: VITS2Config, x_ids, x_lengths, sid=None, *, generator=None,
                     length_scale: float | torch.Tensor = 1.0,
                     noise_scale_w: float | torch.Tensor = 0.8):
    """Pass one of the split serving path: text encoder + duration
    predictor (the SDP, or ``dp_apply`` without ``use_sdp``). Returns a dict
    (m_p, logs_p, x_mask, w_ceil, pred_frames) for
    :func:`decode_from_durations`. Each scale is a float or a (B, 1, 1)
    tensor, one value a row (the batcher's per-request knobs)."""
    check_ported(cfg)
    g = _speaker(params, cfg, sid)
    x, m_p, logs_p, x_mask = text_encoder_apply(params["enc_p"], cfg, x_ids, x_lengths,
                                                g if cfg.enc_gin_channels else None)
    if cfg.use_sdp:
        logw = sdp_reverse(params["dp"], cfg, x, x_mask, g, generator=generator,
                           noise_scale=noise_scale_w)
    else:
        logw = dp_apply(params["dp"], cfg, x, x_mask, g)
    # the frame counts in f32 from a bf16 graph too: integers past 256 are not bf16's
    w_ceil = torch.ceil(torch.exp(at_least_f32(logw)) * x_mask * length_scale)[..., 0]
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
    y_lengths = at_least_f32(w_ceil).sum(dim=-1).clamp(1, max_frames).to(torch.int32)
    y_mask = sequence_mask(y_lengths, max_frames).to(x_mask.dtype)[..., None]
    attn = generate_path(w_ceil, x_mask[..., 0], y_mask[..., 0])

    m_p = torch.bmm(attn, m_p)
    logs_p = torch.bmm(attn, logs_p)
    noise = torch.randn(m_p.shape, generator=generator, device=m_p.device, dtype=m_p.dtype)
    z_p = m_p + noise * torch.exp(logs_p) * as_dtype(noise_scale, m_p.dtype)
    z = flow_block_apply(params["flow"], cfg, z_p, y_mask, g, reverse=True)
    zy = z * y_mask
    if gen_frames is not None and gen_frames < max_frames:
        zy = zy[:, :gen_frames]
        y_lengths = torch.minimum(y_lengths, torch.tensor(gen_frames, dtype=y_lengths.dtype,
                                                          device=y_lengths.device))
    wav, _ = generator_apply(params["dec"], cfg, zy, g, fused_tail=True)
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


def voice_conversion(params, cfg: VITS2Config, y, y_lengths, sid_src, sid_tgt, *,
                     generator=None, noise=None):
    """Flow re-conditioning between speakers: the posterior of the
    spectrogram y (B, T, spec_channels) under the source speaker, the flow
    forward under it and back in reverse under the target, then the
    generator (unfused tail, as in the JAX package). ``noise`` as in
    :func:`posterior_apply`. Returns (wav (B, T * upsample_factor, 1),
    y_mask (B, T, 1))."""
    if "enc_q" not in params:
        raise ValueError("voice conversion needs the posterior encoder (enc_q), "
                         "which this bundle does not hold")
    g_src = params["emb_g"][sid_src.long()][:, None, :]
    g_tgt = params["emb_g"][sid_tgt.long()][:, None, :]
    z, _, _, y_mask = posterior_apply(params["enc_q"], cfg, y, y_lengths, g_src,
                                      generator=generator, noise=noise)
    z_p = flow_block_apply(params["flow"], cfg, z, y_mask, g_src, reverse=False)
    z_hat = flow_block_apply(params["flow"], cfg, z_p, y_mask, g_tgt, reverse=True)
    return generator_apply(params["dec"], cfg, z_hat * y_mask, g_tgt)[0], y_mask


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


def _neg_cent(z_p, m_p, logs_p):
    """Log-likelihood of each frame z_p (B, Ty, C) under each token's prior
    (m_p, logs_p (B, Tx, C)) -> (B, Ty, Tx)."""
    s_p_sq_r = torch.exp(-2 * logs_p)
    nc1 = (-0.5 * math.log(2 * math.pi) - logs_p).sum(dim=-1)
    nc2 = torch.bmm(-0.5 * z_p**2, s_p_sq_r.transpose(1, 2))
    nc3 = torch.bmm(z_p, (m_p * s_p_sq_r).transpose(1, 2))
    nc4 = (-0.5 * m_p**2 * s_p_sq_r).sum(dim=-1)
    return nc1[:, None, :] + nc2 + nc3 + nc4[:, None, :]


def forward_train(params, cfg: VITS2Config, x_ids, x_lengths, y, y_lengths, sid=None, *,
                  generator=None, noise=None, dp=None, tp=None):
    """The training forward (vosk_tts_tpu/models/vits2.py forward_train) of
    any configuration :func:`check_ported` accepts: text encoder, posterior
    over the mel y (B, T_y, spec_channels), flow forward (every flow type,
    dense attention), the alignment by MAS (no gradient), the duration loss
    ``l_length`` (B,) and the log-durations ``logw`` the duration
    discriminator reads: with ``use_sdp`` the SDP's NLL and a differentiable
    SDP sample, else ``dp_apply``'s prediction and its squared error to the
    alignment's log-durations; then the generator on a random
    ``segment_size``-frame slice of z (unfused tail, so ``wav_mb`` holds the
    subband waveforms of ``mb_istft`` and ``ms_istft``). Returns the JAX
    package's dict.

    ``noise`` (a dict, else everything is drawn from ``generator``) pins the
    random draws: ``"posterior"`` (B, T_y, inter_channels), with the SDP
    ``"e_q"`` and ``"z"`` (B, T_x, 2) (the NLL's and the sample's standard
    normals; ``dp_apply`` draws none), ``"ids_slice"`` (B,) the slice
    starts; and optionally ``"attn"`` (B, T_y, T_x), an alignment that
    replaces MAS (a parity run feeds one device's alignment to the other, as
    the serving parity feeds durations).

    MAS runs on the clean log-likelihoods: the JAX trainer's noise-scaled
    MAS is added at scale 0 (its driver never passes another).

    ``dp`` (the data axis of a data-parallel step, parallel/mesh.py) makes
    ``l_length`` this rank's share of the global batch's: its normalizer,
    the text mask's sum, is summed over the axis. ``tp`` runs the generator
    tensor-parallel (:func:`generator_apply`)."""
    check_ported(cfg)
    noise = {k: v.to(y.dtype) if v.is_floating_point() else v for k, v in (noise or {}).items()}
    g = _speaker(params, cfg, sid)
    x, m_p, logs_p, x_mask = text_encoder_apply(params["enc_p"], cfg, x_ids, x_lengths,
                                                g if cfg.enc_gin_channels else None, flash=False)
    z, m_q, logs_q, y_mask = posterior_apply(params["enc_q"], cfg, y, y_lengths, g,
                                             generator=generator, noise=noise.get("posterior"))
    z_p = flow_block_apply(params["flow"], cfg, z, y_mask, g, reverse=False, flash=False)

    attn = noise.get("attn")
    if attn is None:
        with torch.no_grad():
            attn = maximum_path(_neg_cent(z_p, m_p, logs_p),
                                y_mask[..., 0][:, :, None] * x_mask[..., 0][:, None, :])
    attn = attn.to(m_p.dtype)

    w = attn.sum(dim=1)[..., None]
    logw_ = torch.log(w + 1e-6) * x_mask
    if cfg.use_sdp:
        l_length = sdp_forward_nll(params["dp"], cfg, x, x_mask, w, g, generator=generator,
                                   noise=noise.get("e_q")) / total(x_mask.sum(), dp)
        logw = sdp_reverse(params["dp"], cfg, x, x_mask, g, generator=generator,
                           noise=noise.get("z"), noise_scale=1.0, fused=False)
    else:
        logw = dp_apply(params["dp"], cfg, x, x_mask, g)
        l_length = ((logw - logw_) ** 2).sum(dim=(1, 2)) / total(x_mask.sum(), dp)

    m_p = torch.bmm(attn, m_p)
    logs_p = torch.bmm(attn, logs_p)
    z_slice, ids_slice = rand_slice_segments(z, y_lengths, cfg.segment_size,
                                             generator=generator, ids=noise.get("ids_slice"))
    o, o_mb = generator_apply(params["dec"], cfg, z_slice, g, tp=tp)
    return {"x": x, "wav": o, "wav_mb": o_mb, "l_length": l_length, "attn": attn,
            "ids_slice": ids_slice, "x_mask": x_mask, "y_mask": y_mask, "z": z, "z_p": z_p,
            "m_p": m_p, "logs_p": logs_p, "m_q": m_q, "logs_q": logs_q, "logw": logw,
            "logw_": logw_}


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

    def voice_conversion(self, *args, **kwargs):
        return voice_conversion(self.params, self.cfg, *args, **kwargs)
