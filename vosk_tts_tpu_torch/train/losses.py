"""Training losses (vosk_tts_tpu/train/losses.py): LSGAN, feature matching,
TPRLS, KL, duration MSE and the (subband) multi-resolution STFT loss.

Each takes an optional ``dp``, the data axis of a data-parallel step
(parallel/mesh.py): with it a loss is this rank's share of the loss over
the global batch (the shares sum to it over the axis), as the mesh module
sets out: means over equal-shaped shards / the axis size, mask sums over
the axis, the TPRLS median and the spectral convergence's norms over every
rank's rows. Without it (None) a loss is the local batch's.
"""

from __future__ import annotations

import torch

from ..ops.stft import stft as stft_fn
from ..parallel.mesh import all_sum, gather_rows, mean_share, total


def feature_loss(fmap_r, fmap_g, dp=None):
    """2 x the sum over layers of mean |real - generated| (real detached)."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + mean_share(torch.abs(rl.detach() - gl), dp)
    return loss * 2.0


def discriminator_loss(disc_real_outputs, disc_generated_outputs, dp=None):
    """LSGAN D loss: (loss, real losses, generated losses)."""
    loss, r_losses, g_losses = 0.0, [], []
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        r_loss = mean_share((1.0 - dr) ** 2, dp)
        g_loss = mean_share(dg**2, dp)
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs, dp=None):
    """LSGAN G loss: (loss, per-discriminator losses)."""
    loss, gen_losses = 0.0, []
    for dg in disc_outputs:
        l = mean_share((1.0 - dg) ** 2, dp)
        gen_losses.append(l)
        loss = loss + l
    return loss, gen_losses


def _median(x):
    """jnp.median: the mean of the two middle values for an even count."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


TPRLS_TAU = 0.04


def _tprls_one(dr, dg, dp=None):
    """StyleTTS2's relativistic least-squares term: the mean of
    (dr - dg - m)^2 over the elements where dr < dg + m, m the median of
    dr - dg, capped at TPRLS_TAU. With ``dp`` the term of every rank's
    elements together (gathered, differentiably), / the axis size."""
    if dp is not None:
        both = gather_rows(torch.stack([dr.reshape(-1), dg.reshape(-1)], dim=-1), dp)
        dr, dg = both[:, 0], both[:, 1]
    diff = dr - dg
    m = _median(diff)
    mask = dr < dg + m
    sq = (diff - m) ** 2
    l_rel = torch.where(mask, sq, torch.zeros_like(sq)).sum() / mask.sum().clamp(min=1)
    term = TPRLS_TAU - torch.relu(TPRLS_TAU - l_rel)
    return term if dp is None else term / dp.size


def discriminator_tprls_loss(disc_real_outputs, disc_generated_outputs, dp=None):
    return sum(_tprls_one(dr, dg, dp) for dr, dg in zip(disc_real_outputs,
                                                         disc_generated_outputs))


def generator_tprls_loss(disc_real_outputs, disc_generated_outputs, dp=None):
    """The same quantity as the discriminator's (the reference swaps only
    the iteration names)."""
    return sum(_tprls_one(dr, dg, dp) for dr, dg in zip(disc_real_outputs,
                                                         disc_generated_outputs))


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask, dp=None):
    """Channels-last: (B, T, C); z_mask (B, T, 1)."""
    kl = logs_p - logs_q - 0.5 + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * z_mask) / total(torch.sum(z_mask), dp)


def duration_loss(logw, logw_, x_mask, dp=None):
    """MSE of the deterministic duration predictor."""
    return torch.sum((logw - logw_) ** 2) / total(torch.sum(x_mask), dp)


def _stft_mag(x, n_fft, hop, win):
    """torch.stft(center=True) magnitude, clamped at 1e-7 under the root:
    (B, T) -> (B, frames, F)."""
    re, im = stft_fn(x, n_fft, hop, win, pad=n_fft // 2)
    return torch.sqrt(torch.clamp(re * re + im * im, min=1e-7))


def stft_loss(x, y, n_fft, hop, win, dp=None):
    """(spectral convergence, log-magnitude L1); with ``dp`` the norms of
    the spectral convergence are over every rank's rows."""
    x_mag = _stft_mag(x, n_fft, hop, win)
    y_mag = _stft_mag(y, n_fft, hop, win)
    if dp is None:
        sc = torch.linalg.norm(y_mag - x_mag) / torch.linalg.norm(y_mag)
    else:
        sums = all_sum(torch.stack([(y_mag - x_mag).square().sum(), y_mag.square().sum()]), dp)
        sc = torch.sqrt(sums[0]) / torch.sqrt(sums[1]) / dp.size
    mag = mean_share(torch.abs(torch.log(y_mag) - torch.log(x_mag)), dp)
    return sc, mag


def multi_resolution_stft_loss(x, y, fft_sizes, hop_sizes, win_lengths, dp=None):
    """Both terms averaged over the resolutions."""
    sc_total, mag_total = 0.0, 0.0
    for n_fft, hop, win in zip(fft_sizes, hop_sizes, win_lengths):
        sc, mag = stft_loss(x, y, n_fft, hop, win, dp)
        sc_total = sc_total + sc
        mag_total = mag_total + mag
    n = len(fft_sizes)
    return sc_total / n, mag_total / n


def subband_stft_loss(y_mb, y_hat_mb, fft_sizes, hop_sizes, win_lengths, dp=None):
    """Subbands folded into the batch: y_mb (B, T, sub), y_hat_mb
    (B, >= T, sub) -> sc + mag."""
    b, t, sub = y_mb.shape
    y_flat = y_mb.transpose(1, 2).reshape(b * sub, t)
    y_hat_flat = y_hat_mb.transpose(1, 2).reshape(b * sub, -1)[:, :t]
    sc, mag = multi_resolution_stft_loss(y_hat_flat, y_flat, fft_sizes, hop_sizes, win_lengths,
                                         dp)
    return sc + mag
