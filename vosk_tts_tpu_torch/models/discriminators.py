"""GAN discriminators of VITS2 and QuickVC training
(vosk_tts_tpu/models/discriminators.py): period (DiscriminatorP), scale
(DiscriminatorS), multiband spectral (DiscriminatorSpec), their
MultiPeriodMultiSpec combination (VITS2), the MultiPeriod one of S and the
periods (QuickVC), the duration discriminator (variant 2) and the WavLM
discriminator of the SLM loss.

Weights are in the port's layouts (utils/params.py: Conv2d (O, I, kh, kw),
Conv1d (O, I/groups, K)). The waveform discriminators run channels-first,
torch's own layout for ``F.conv2d``/``F.conv1d``: a feature map is
(B, C, H, W) or (B, C, T) where the JAX package keeps (B, H, W, C) or
(B, T, C); the logits of the period and scale discriminators are the same
(B, n) rows, the spectral one's (B, 1, frames, F'). Every loss over them
is a mean, a sum or a median over all elements, so it does not see the
layout. The duration discriminator is channels-last, as in the JAX package.
The WavLM discriminator takes the stacked WavLM states channels-last, as
the JAX package does, and runs its k=5 and k=3 convs channels-first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.conv import conv1d
from ..ops.norm import layer_norm
from ..ops.stft import stft
from ..utils.params import S_SPECS, SPEC_BANDS

PERIODS = (2, 3, 5, 7, 11)
SPEC_FFTS = (1024, 2048, 512)
LRELU_SLOPE = 0.1


def _lrelu(x):
    return F.leaky_relu(x, LRELU_SLOPE)


def disc_p_apply(params, y, period: int):
    """y: (B, T) -> (logits (B, n), feature maps): T reflect-padded to a
    multiple of the period, folded to (B, 1, T/period, period)."""
    b, t = y.shape
    if t % period:
        n_pad = period - t % period
        y = F.pad(y[:, None], (0, n_pad), mode="reflect")[:, 0]
        t += n_pad
    x = y.reshape(b, 1, t // period, period)
    fmap = []
    for i, c in enumerate(params["convs"]):
        pad = (c["w"].shape[2] - 1) // 2
        x = _lrelu(F.conv2d(x, c["w"], c["b"], stride=(3 if i < 4 else 1, 1), padding=(pad, 0)))
        fmap.append(x)
    x = F.conv2d(x, params["post"]["w"], params["post"]["b"], padding=(1, 0))
    fmap.append(x)
    return x.reshape(b, -1), fmap


def disc_s_apply(params, y):
    """y: (B, T) -> (logits (B, n), feature maps (B, C, T'))."""
    x = y[:, None, :]
    fmap = []
    for c, (_, stride, groups, _, _, pad) in zip(params["convs"], S_SPECS):
        x = _lrelu(F.conv1d(x, c["w"], c["b"], stride=stride, padding=pad, groups=groups))
        fmap.append(x)
    x = F.conv1d(x, params["post"]["w"], params["post"]["b"], padding=1)
    fmap.append(x)
    return x.reshape(x.shape[0], -1), fmap


def _spec_bands(n_fft: int):
    nb = n_fft // 2 + 1
    return [(int(b0 * nb), int(b1 * nb)) for b0, b1 in SPEC_BANDS]


def disc_spec_apply(params, y, window_length: int):
    """y: (B, T): DC removed, peak-normalised to 0.8, the complex STFT
    (center=True, hop window/4) as (B, 2, frames, F); each frequency band
    through its conv stack, the bands joined along frequency, a 3x3 post
    conv. Returns (logits (B, 1, frames, F'), feature maps)."""
    hop = int(window_length * 0.25)
    y = y - y.mean(dim=-1, keepdim=True)
    y = 0.8 * y / (y.abs().amax(dim=-1, keepdim=True) + 1e-9)
    re, im = stft(y, window_length, hop, window_length, pad=window_length // 2)
    x = torch.stack([re, im], dim=1)
    fmap, outs = [], []
    for (b0, b1), stack in zip(_spec_bands(window_length), params["band_convs"]):
        band = x[..., b0:b1]
        for i, c in enumerate(stack):
            kh, kw = c["w"].shape[2:]
            stride = (1, 2) if (kw == 9 and i > 0) else (1, 1)
            band = _lrelu(F.conv2d(band, c["w"], c["b"], stride=stride,
                                   padding=(kh // 2, kw // 2)))
            if i > 0:
                fmap.append(band)
        outs.append(band)
    x = F.conv2d(torch.cat(outs, dim=3), params["post"]["w"], params["post"]["b"], padding=(1, 1))
    fmap.append(x)
    return x, fmap


def mpmsd_apply(params, y, y_hat, periods, spec_ffts):
    """MultiPeriodMultiSpecDiscriminator on the real y and generated y_hat
    (B, T) -> (real logits, generated logits, real fmaps, generated fmaps),
    a list each: S, then each period, then each FFT size. Both waveforms go
    through each discriminator as one batch of 2B (every op is per row)."""
    b = y.shape[0]
    wav = torch.cat([y, y_hat], dim=0)
    runs = [disc_s_apply(params["s"], wav)]
    runs += [disc_p_apply(pp, wav, p) for p, pp in zip(periods, params["p"])]
    runs += [disc_spec_apply(sp, wav, n) for n, sp in zip(spec_ffts, params.get("spec", ()))]
    y_d_rs = [o[:b] for o, _ in runs]
    y_d_gs = [o[b:] for o, _ in runs]
    fmap_rs = [[f[:b] for f in fm] for _, fm in runs]
    fmap_gs = [[f[b:] for f in fm] for _, fm in runs]
    return y_d_rs, y_d_gs, fmap_rs, fmap_gs


def mpd_apply(params, y, y_hat):
    """MultiPeriodDiscriminator (S, then periods 2/3/5/7/11): as
    :func:`mpmsd_apply` without the spectral discriminators."""
    return mpmsd_apply(params, y, y_hat, PERIODS, ())


def duration_disc_apply(params, x, x_mask, dur_r, dur_hat):
    """Variant 2 (relu -> layer norm after each conv). x (B, T, C), the
    encoder output, is detached here, as in the JAX package; dur_r, dur_hat
    (B, T, 1). Returns [prob_r, prob_g], each (B, T, 1) in (0, 1)."""
    x = x.detach()

    def block(h, conv, norm):
        w = params[conv]["w"]
        h = conv1d(h * x_mask, w, params[conv]["b"], padding=w.shape[-1] // 2)
        return layer_norm(torch.relu(h), params[norm]["gamma"], params[norm]["beta"])

    x = block(block(x, "conv1", "norm1"), "conv2", "norm2")
    probs = []
    for dur in (dur_r, dur_hat):
        d = conv1d(dur, params["dur_proj"]["w"], params["dur_proj"]["b"])
        h = block(torch.cat([x, d], dim=-1), "pre_out_conv1", "pre_out_norm1")
        h = block(h, "pre_out_conv2", "pre_out_norm2") * x_mask
        probs.append(torch.sigmoid(F.linear(h, params["output"]["w"], params["output"]["b"])))
    return probs


def wavlm_disc_apply(params, x):
    """The WavLM (SLM) discriminator: x (B, T, slm_hidden * slm_layers), the
    stacked hidden states (models/wavlm.stacked_hidden_states: feature
    l * hidden + h), -> logits (B, T). The 1x1 ``pre`` conv, three k=5
    convs with leaky ReLU, a k=3 ``post`` conv."""
    h = F.linear(x, params["pre"]["w"], params["pre"]["b"]).transpose(1, 2)  # (B, C, T)
    for c in params["convs"]:
        h = _lrelu(F.conv1d(h, c["w"], c["b"], padding=2))
    h = F.conv1d(h, params["post"]["w"], params["post"]["b"], padding=1)
    return h.reshape(h.shape[0], -1)
