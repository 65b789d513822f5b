"""QuickVC GAN training step (vosk_tts_tpu/train/vc_train.py), in PyTorch.

One step runs the JAX package's order on the QuickVC graph:

  * one generator forward (``quickvc.forward_train``), its graph kept;
  * the discriminator (``mpd``: S and periods 2/3/5/7/11) update on the
    detached generated segment: the least-squares loss plus the TPRLS one;
  * the generator loss through the UPDATED discriminator (its parameters
    take no gradient there): adversarial + TPRLS + feature matching +
    ``c_mel`` x the mel L1 (both mels cut to the shorter, as the JAX step
    does for the ms-iSTFT output's extra frame) + ``c_kl`` x the KL.

The generator and the discriminator each have an AdamW of the VITS2
trainer's settings (train/vits2_train.py); the driver applies no
learning-rate schedule, as the JAX driver does not. ``dp`` takes the
data-parallel step of the VITS2 trainer (its module docstring).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models import discriminators as D
from ..models import quickvc as Q
from ..ops.commons import slice_segments
from ..ops.stft import mel_spectrogram
from ..parallel.mesh import mean_share, reduce_grads, reduce_metrics
from ..utils import params as P
from . import losses as L
from . import vits2_train as T


@dataclass(frozen=True)
class VCTrainConfig(T.TrainConfig):
    sampling_rate: int = 16000
    filter_length: int = 1280
    hop_length: int = 320
    win_length: int = 1280


def init_trees(mcfg: Q.QuickVCConfig, seed: int) -> dict:
    """Port-layout trees of the generator (``quickvc_init``, zero coupling
    projections as initialised) and the discriminator (``mpd_init``) from
    the numpy inits (the JAX package's init draws other numbers)."""
    return {"g": P.to_port_layout(P.quickvc_init(mcfg, seed)),
            "d": P.to_port_layout(P.mpd_init(seed + 1))}


def init_train_state(mcfg: Q.QuickVCConfig, tcfg: VCTrainConfig, *, seed: int = 0, device,
                     trees: dict | None = None) -> T.TrainState:
    return T.TrainState(tcfg, trees if trees is not None else init_trees(mcfg, seed), device)


def make_train_step(mcfg: Q.QuickVCConfig, tcfg: VCTrainConfig, compute_dtype=None, dp=None):
    """Returns ``step(state, batch, *, generator=None, noise=None) ->
    metrics`` (0-dim tensors, not synchronised). ``batch``: c (B, T,
    ssl_dim), spec (B, T, F), mel (B, T, n_mel), wav (B, T * hop), tensors
    on the state's device. ``noise`` pins ``forward_train``'s draws. After
    the step each parameter's ``.grad`` holds the gradient its optimizer
    applied. ``compute_dtype`` as in ``vits2_train.make_train_step``."""
    seg_samples = mcfg.segment_size * tcfg.hop_length

    def mel_of(wav):
        return mel_spectrogram(wav, tcfg.filter_length, tcfg.n_mel_channels, tcfg.sampling_rate,
                               tcfg.hop_length, tcfg.win_length, tcfg.mel_fmin, tcfg.mel_fmax)

    def step(state: T.TrainState, batch: dict, *, generator=None, noise=None) -> dict:
        net_g, net_d = state.params["g"], state.params["d"]
        opt_g, opt_d = state.opt["g"], state.opt["d"]
        c, spec, mel, wav = (T._cast(batch[k], compute_dtype) for k in ("c", "spec", "mel", "wav"))

        opt_g.zero_grad(set_to_none=True)
        out = Q.forward_train(T._cast(net_g.params, compute_dtype), mcfg, c, spec, mel,
                              generator=generator, noise=noise)
        y_hat = out["wav"][..., 0][:, :seg_samples]
        y_real = slice_segments(wav[..., None], out["ids_slice"] * tcfg.hop_length,
                                seg_samples)[..., 0]

        # the discriminator, on the detached generated segment
        opt_d.zero_grad(set_to_none=True)
        yr, yg, _, _ = D.mpd_apply(T._cast(net_d.params, compute_dtype), y_real, y_hat.detach())
        loss_disc = L.discriminator_loss(yr, yg, dp)[0] + L.discriminator_tprls_loss(yr, yg, dp)
        loss_disc.backward()
        T.fill_missing_grads(opt_d)
        reduce_grads(net_d.parameters(), dp)
        opt_d.step()

        # the generator, through the updated discriminator
        with T._frozen(net_d):
            yr, yg, fmap_r, fmap_g = D.mpd_apply(T._cast(net_d.params, compute_dtype), y_real,
                                                 y_hat)
            loss_gen = L.generator_loss(yg, dp)[0]
            loss_tprls = L.generator_tprls_loss(yr, yg, dp)
            loss_fm = L.feature_loss(fmap_r, fmap_g, dp)
            y_mel, yh_mel = mel_of(y_real), mel_of(y_hat)
            n = min(y_mel.shape[1], yh_mel.shape[1])
            loss_mel = mean_share(torch.abs(y_mel[:, :n] - yh_mel[:, :n]), dp) * tcfg.c_mel
            loss_kl = L.kl_loss(out["z_p"], out["logs_q"], out["m_p"], out["logs_p"],
                                out["spec_mask"], dp) * tcfg.c_kl
            total = loss_gen + loss_tprls + loss_fm + loss_mel + loss_kl
            total.backward()
        T.fill_missing_grads(opt_g)
        reduce_grads(net_g.parameters(), dp)
        opt_g.step()
        state.step += 1
        return reduce_metrics({"loss_disc": loss_disc.detach(), "loss_gen_all": total.detach(),
                               "loss_gen": loss_gen.detach(), "loss_fm": loss_fm.detach(),
                               "loss_mel": loss_mel.detach(), "loss_kl": loss_kl.detach()}, dp)

    return step
