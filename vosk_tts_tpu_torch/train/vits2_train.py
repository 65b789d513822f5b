"""VITS2 GAN training step (vosk_tts_tpu/train/vits2_train.py), in PyTorch.

One step runs the JAX package's order:

  * one generator forward (``vits2.forward_train``), its graph kept;
  * the discriminator update on the detached generated segment;
  * with the WavLM/SLM branch (``slm=``, the reference's train_ms.py:
    397-406, 441-444), the WavLM discriminator update on the detached
    WavLM states of the real and generated segments (resampled to 16 kHz);
  * the duration discriminator update on the detached encoder output and
    log-durations;
  * the generator loss through the UPDATED discriminators, backpropagated
    through the one kept generator graph; the discriminators' parameters
    take no gradient there (``requires_grad`` is off around it), so
    nothing accumulates into their next step. With the SLM branch it adds
    ``loss_lm``, the sum over the WavLM states of the mean |real - fake|,
    and ``loss_lm_gen``, LSGAN through the updated WavLM discriminator.

A data-parallel step (``dp=``, the data axis of parallel/mesh.py) is the
JAX package's global-batch step: each rank computes its share of every loss
(train/losses.py), each network's gradients are summed over the axis after
``fill_missing_grads`` and before its optimizer's step (one collective a
bucket, ``mesh.reduce_grads``), and the metrics are summed over the axis
for the log; the parameters after the step are equal on every rank. With
``tp=`` the generator runs tensor-parallel over the model axis
(parallel/tp.py; the state's generator tree then holds this rank's part).
No ``DistributedDataParallel`` wrapper: the D runs twice a step and the
networks are functional trees.

The frozen WavLM's leaves are buffers: it takes no gradient, but the
generator's gradient flows through it and through the resampler into the
generated waveform. The JAX step runs WavLM on each segment twice (under
``stop_gradient`` for the discriminator update, then again inside the
generator loss); the port runs it once a segment: the real segment's
states without a graph, the generated segment's with its graph kept, read
detached by the discriminator update and attached by the generator loss.
The values are the same.

Each network is a ``TreeModule`` of ``nn.Parameter`` leaves in the port's
layouts; each has its own ``torch.optim.AdamW`` (betas (0.8, 0.99), eps
1e-9, weight decay 0.01: optax ``adamw``'s update, decoupled decay of the
old parameter and eps outside the root; a parameter that no loss reaches
takes a zero gradient, :func:`fill_missing_grads`, and decays as under
optax), all on one per-epoch exponential learning-rate schedule.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Sequence

import torch

from ..models import discriminators as D
from ..models import vits2
from ..models.tree import TreeModule
from ..models.wavlm import stacked_hidden_states, wavlm_apply
from ..ops.commons import slice_segments
from ..ops.pqmf import pqmf_analysis
from ..ops.resample import resample
from ..ops.stft import mel_spectrogram
from ..parallel.mesh import mean_share, reduce_grads, reduce_metrics
from ..utils import params as P
from . import losses as L


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-4
    betas: Sequence[float] = (0.8, 0.99)
    eps: float = 1e-9
    lr_decay: float = 0.999875  # a factor an epoch
    c_mel: float = 45.0
    c_kl: float = 1.0
    sampling_rate: int = 22050
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mel_channels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: float | None = None
    fft_sizes: Sequence[int] = (384, 683, 171)
    hop_sizes: Sequence[int] = (30, 60, 10)
    win_lengths: Sequence[int] = (150, 300, 60)
    use_dur_disc: bool = True
    use_slm: bool = False
    disc_periods: Sequence[int] = field(default=D.PERIODS)
    disc_spec_ffts: Sequence[int] = field(default=D.SPEC_FFTS)


def make_optimizer(params, tcfg: TrainConfig) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=tcfg.learning_rate, betas=tuple(tcfg.betas),
                             eps=tcfg.eps, weight_decay=0.01)


def fill_missing_grads(opt: torch.optim.Optimizer) -> None:
    """Give each parameter of ``opt`` that no loss reached a zero gradient.
    torch's AdamW skips a parameter whose ``.grad`` is None; optax's
    ``adamw`` gives it a zero gradient, whose update is 0 / (0 + eps) plus
    the decay ``-lr * wd * p``. Called before every ``opt.step()``."""
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


NETS = ("g", "d", "dur", "wd")


class TrainState:
    """The networks (``params["g"]``, ``["d"]``, with the duration
    discriminator ``["dur"]``, with the SLM branch ``["wd"]``, the WavLM
    discriminator: trainable TreeModules), their optimizers (``opt``, same
    keys, each ``make_opt(parameters, tcfg)``) and the step count. Updated
    in place by a step; the StableTTS and QuickVC trainers hold theirs in
    one too."""

    def __init__(self, tcfg, trees: dict, device, make_opt=make_optimizer):
        self.params = {k: TreeModule(t, trainable=True).to(device)
                       for k, t in trees.items() if t is not None}
        self.opt = {k: make_opt(m.parameters(), tcfg) for k, m in self.params.items()}
        self.step = 0

    def state_dict(self) -> dict:
        return {"step": self.step, **{f"params_{k}": m.state_dict() for k, m in self.params.items()},
                **{f"opt_{k}": o.state_dict() for k, o in self.opt.items()}}

    def load_state_dict(self, state: dict) -> None:
        """Restore every network and its optimizer; only a WavLM
        discriminator may be missing from ``state`` (the SLM loss turned on
        for a run saved without it): it keeps its fresh init. Any other
        missing network raises KeyError."""
        self.step = int(state["step"])
        for k, m in self.params.items():
            if k == "wd" and "params_wd" not in state:
                continue
            m.load_state_dict(state[f"params_{k}"])
            self.opt[k].load_state_dict(state[f"opt_{k}"])


def init_trees(mcfg: vits2.VITS2Config, tcfg: TrainConfig, seed: int, *, slm_hidden: int = 768,
               slm_layers: int = 13, slm_initial: int = 64) -> dict:
    """Port-layout trees of the generator and discriminators from numpy
    inits (utils/params.py), the generator's zero projections as
    initialised (the JAX package's ``init_train_state`` draws other
    numbers); with ``tcfg.use_slm`` the WavLM discriminator over
    ``slm_layers`` states of ``slm_hidden`` features."""
    return {
        "g": P.to_port_layout(P.synthesizer_init(mcfg, seed)),
        "d": P.to_port_layout(P.mpmsd_init(seed + 1, tuple(tcfg.disc_periods),
                                           tuple(tcfg.disc_spec_ffts))),
        "dur": (P.to_port_layout(P.duration_disc_init(seed + 2, mcfg.hidden_channels,
                                                      mcfg.hidden_channels, 3))
                if tcfg.use_dur_disc else None),
        "wd": (P.to_port_layout(P.wavlm_disc_init(seed + 3, slm_hidden, slm_layers, slm_initial))
               if tcfg.use_slm else None),
    }


def init_train_state(mcfg: vits2.VITS2Config, tcfg: TrainConfig, *, seed: int = 0, device,
                     trees: dict | None = None, **slm_dims) -> TrainState:
    """A fresh state on ``device`` from ``trees`` (port layout; default
    :func:`init_trees` of ``seed`` and ``slm_dims``: ``slm_hidden``,
    ``slm_layers``, ``slm_initial``)."""
    if trees is None:
        trees = init_trees(mcfg, tcfg, seed, **slm_dims)
    return TrainState(tcfg, trees, device)


def lr_at_epoch(tcfg: TrainConfig, epoch: int) -> float:
    return tcfg.learning_rate * (tcfg.lr_decay**epoch)


def set_lr(state: TrainState, lr: float) -> None:
    """One schedule for every optimizer (and every param group)."""
    for opt in state.opt.values():
        for group in opt.param_groups:
            group["lr"] = lr


@contextlib.contextmanager
def _frozen(*modules):
    """requires_grad off for the modules' parameters inside the block."""
    params = [p for m in modules if m is not None for p in m.parameters()]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _cast(tree, dtype):
    """A differentiable cast of a tree's floating leaves (None: no cast)."""
    if dtype is None or tree is None:
        return tree
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def make_train_step(mcfg: vits2.VITS2Config, tcfg: TrainConfig, compute_dtype=None, slm=None,
                    dp=None, tp=None):
    """Returns ``step(state, batch, *, generator=None, noise=None) ->
    metrics`` (0-dim tensors, not synchronised). ``batch``: x (B, Tx) int,
    x_lengths (B,), mel (B, Tf, n_mel), mel_lengths (B,), wav (B, Ts),
    sid (B,), tensors on the state's device. ``noise`` pins
    ``forward_train``'s draws. After the step each parameter's ``.grad``
    holds the gradient its optimizer applied.

    ``slm``: a frozen ``models.wavlm.WavLM`` on the state's device turns on
    the WavLM/SLM branch (the state must then hold ``"wd"``:
    ``tcfg.use_slm``; a step raises ValueError where one of the two is
    missing); it adds ``loss_slm_disc``, ``loss_lm`` and ``loss_lm_gen`` to the
    metrics.

    ``compute_dtype`` (e.g. torch.bfloat16) runs forward and backward in
    that type through a differentiable cast of the f32 master parameters
    (the frozen WavLM's too) and of mel and wav, with no loss scaling (bf16
    keeps f32's exponent range), as the JAX package's mixed-precision step;
    the optimizers and their state stay f32.

    ``dp`` (a ``parallel.mesh.Axis``) takes the data-parallel step over its
    ranks, each with its rows of the global batch; ``tp`` (a
    ``parallel.tp.TensorParallel``) runs the generator tensor-parallel."""
    seg_frames = mcfg.segment_size
    seg_samples = seg_frames * tcfg.hop_length
    periods, spec_ffts = tuple(tcfg.disc_periods), tuple(tcfg.disc_spec_ffts)

    def mel_of(wav):
        return mel_spectrogram(wav, tcfg.filter_length, tcfg.n_mel_channels, tcfg.sampling_rate,
                               tcfg.hop_length, tcfg.win_length, tcfg.mel_fmin, tcfg.mel_fmax)

    def slm_states(wav):
        return wavlm_apply(_cast(slm.params, compute_dtype), slm.cfg,
                           resample(wav, tcfg.sampling_rate, 16000))

    def step(state: TrainState, batch: dict, *, generator=None, noise=None) -> dict:
        net_g, net_d, net_dur, net_wd = (state.params.get(k) for k in NETS)
        opt_g, opt_d, opt_dur, opt_wd = (state.opt.get(k) for k in NETS)
        use_slm = slm is not None
        if use_slm != (net_wd is not None):
            raise ValueError("the SLM branch needs both a WavLM (make_train_step(slm=)) and a "
                             "WavLM discriminator in the state (TrainConfig.use_slm)")
        mel = _cast(batch["mel"], compute_dtype)
        wav = _cast(batch["wav"], compute_dtype)

        opt_g.zero_grad(set_to_none=True)
        out = vits2.forward_train(_cast(net_g.params, compute_dtype), mcfg, batch["x"],
                                  batch["x_lengths"], mel, batch["mel_lengths"], batch["sid"],
                                  generator=generator, noise=noise, dp=dp, tp=tp)
        ids = out["ids_slice"]
        y_hat = out["wav"][..., 0]
        y_real = slice_segments(wav[..., None], ids * tcfg.hop_length, seg_samples)[..., 0]
        y_mel = slice_segments(mel, ids, seg_frames)
        metrics = {}

        # the discriminator, on the detached generated segment
        opt_d.zero_grad(set_to_none=True)
        yr, yg, _, _ = D.mpmsd_apply(_cast(net_d.params, compute_dtype), y_real, y_hat.detach(),
                                     periods, spec_ffts)
        loss_disc = L.discriminator_loss(yr, yg, dp)[0] + L.discriminator_tprls_loss(yr, yg, dp)
        loss_disc.backward()
        fill_missing_grads(opt_d)
        reduce_grads(net_d.parameters(), dp)
        opt_d.step()
        metrics["loss_disc"] = loss_disc.detach()

        # the WavLM discriminator, on the detached states of both segments
        if use_slm:
            with torch.no_grad():
                hs_real = slm_states(y_real)
            hs_fake = slm_states(y_hat)  # the graph kept for the generator loss
            opt_wd.zero_grad(set_to_none=True)
            wd = _cast(net_wd.params, compute_dtype)
            dr = D.wavlm_disc_apply(wd, stacked_hidden_states(hs_real))
            dg = D.wavlm_disc_apply(wd, stacked_hidden_states([h.detach() for h in hs_fake]))
            loss_slm_disc = mean_share((1 - dr) ** 2, dp) + mean_share(dg**2, dp)
            loss_slm_disc.backward()
            fill_missing_grads(opt_wd)
            reduce_grads(net_wd.parameters(), dp)
            opt_wd.step()
            metrics["loss_slm_disc"] = loss_slm_disc.detach()

        # the duration discriminator, on the detached encoder output and durations
        if net_dur is not None:
            opt_dur.zero_grad(set_to_none=True)
            pr, pg = D.duration_disc_apply(_cast(net_dur.params, compute_dtype),
                                           out["x"].detach(), out["x_mask"],
                                           out["logw_"].detach(), out["logw"].detach())
            loss_dur_disc = L.discriminator_loss([pr], [pg], dp)[0]
            loss_dur_disc.backward()
            fill_missing_grads(opt_dur)
            reduce_grads(net_dur.parameters(), dp)
            opt_dur.step()
            metrics["loss_dur_disc"] = loss_dur_disc.detach()

        # the generator, through the updated discriminators
        with _frozen(net_d, net_dur, net_wd):
            yh_mel = mel_of(y_hat)
            yr_, yg_, fmap_r, fmap_g = D.mpmsd_apply(_cast(net_d.params, compute_dtype), y_real,
                                                     y_hat, periods, spec_ffts)
            loss_gen = L.generator_loss(yg_, dp)[0]
            loss_gen_tprls = L.generator_tprls_loss(yr_, yg_, dp)
            loss_fm = L.feature_loss(fmap_r, fmap_g, dp)
            n = min(y_mel.shape[1], yh_mel.shape[1])
            loss_mel = mean_share(torch.abs(y_mel[:, :n] - yh_mel[:, :n]), dp) * tcfg.c_mel
            loss_dur = torch.sum(out["l_length"])
            loss_kl = L.kl_loss(out["z_p"], out["logs_q"], out["m_p"], out["logs_p"],
                                out["y_mask"], dp) * tcfg.c_kl
            if mcfg.decoder_type == "mb_istft":
                y_mb = pqmf_analysis(y_real[..., None], subbands=mcfg.subbands)
                loss_subband = L.subband_stft_loss(y_mb, out["wav_mb"], tcfg.fft_sizes,
                                                   tcfg.hop_sizes, tcfg.win_lengths, dp)
            else:
                loss_subband = loss_mel.new_zeros(())
            total = (loss_gen + loss_gen_tprls + loss_fm + loss_mel + loss_dur + loss_kl
                     + loss_subband)
            if net_dur is not None:
                _, pg = D.duration_disc_apply(_cast(net_dur.params, compute_dtype), out["x"],
                                              out["x_mask"], out["logw_"], out["logw"])
                total = total + L.generator_loss([pg], dp)[0]
            if use_slm:
                loss_lm = sum(mean_share(torch.abs(hr - hf), dp)
                              for hr, hf in zip(hs_real, hs_fake))
                dg = D.wavlm_disc_apply(_cast(net_wd.params, compute_dtype),
                                        stacked_hidden_states(hs_fake))
                loss_lm_gen = mean_share((1 - dg) ** 2, dp)
                total = total + loss_lm + loss_lm_gen
                metrics.update({"loss_lm": loss_lm.detach(), "loss_lm_gen": loss_lm_gen.detach()})
            total.backward()
        fill_missing_grads(opt_g)
        reduce_grads(net_g.parameters(), dp)
        opt_g.step()
        state.step += 1
        metrics.update({"loss_gen_all": total.detach(), "loss_gen": loss_gen.detach(),
                        "loss_fm": loss_fm.detach(), "loss_mel": loss_mel.detach(),
                        "loss_dur": loss_dur.detach(), "loss_kl": loss_kl.detach(),
                        "loss_subband": loss_subband.detach()})
        return reduce_metrics(metrics, dp)

    return step
