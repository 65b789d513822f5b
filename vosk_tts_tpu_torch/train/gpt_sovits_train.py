"""GPT-SoVITS training steps (vosk_tts_tpu/train/gpt_sovits_train.py), in
PyTorch.

Stage 1, the AR (text -> semantic codes): the cross-entropy summed over
every position (``gpt_sovits.ar_forward_train``), or with ``if_dpo`` the
DPO forward on a span-repeated rejection; ScaledAdam (train/scaled_adam.py,
the reference's lr 0.01 locked to 0.002 by its schedule) by default, or
``optimizer="adamw"``: the gradient clipped to a global norm of
``grad_clip``, then AdamW (betas 0.9/0.999, eps 1e-8) on optax's
``warmup_cosine_decay_schedule`` from 0 to ``learning_rate`` and back to 0,
set each step from the step count.

Stage 2, SoVITS (codes -> waveform): the VITS GAN step of the QuickVC
trainer (train/vc_train.py: D on the detached segment, then G through the
UPDATED D) with the MultiPeriod discriminator, least-squares adversarial,
feature, ``c_mel`` x mel L1 (cut to the shorter), ``c_kl`` x KL and
``c_commit`` x the codebook's commit loss; no TPRLS, no duration
discriminator, no learning-rate schedule (the JAX driver sets none). The
codebook is not a parameter: the EMA buffers (ops/rvq.py, ``state.vq``)
are k-means-initialised on the first batch from the pre-update
``ssl_proj`` features, the forward reads ``vq["embed"]``, and after the
optimizers the buffers take the EMA step with the same features. In JAX
``codebook`` is a leaf of the generator's tree that gets a zero gradient
and is overwritten by the EMA after each step, so holding it out of the
optimizer changes nothing.

Both steps take ``dp=``, the data-parallel step of the VITS2 trainer (its
module docstring): S1's loss is a sum, so a rank's share is its rows' sum
(a rank collates its own rows, padded to its own length, as each host does
in the JAX package); the gradient is summed over the axis before S1's clip;
S2's k-means runs over every rank's rows and its EMA step over every rank's
counts and sums (ops/rvq.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..models import discriminators as D
from ..models import gpt_sovits as G
from ..ops import rvq
from ..ops.commons import slice_segments
from ..ops.conv import conv1d
from ..ops.stft import mel_spectrogram
from ..parallel.mesh import mean_share, reduce_grads, reduce_metrics
from ..utils import params as P
from . import losses as L
from . import vits2_train as T
from .scaled_adam import ScaledAdam, warmup_cosine_lr


# ---------------------------------------------------------------------------
# Stage 1: the AR
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class S1TrainConfig:
    # "scaled_adam" (t2s_lightning_module.py:119-127) or "adamw"
    optimizer: str = "scaled_adam"
    learning_rate: float = 1e-4  # AdamW's peak (ScaledAdam runs locked at 0.002)
    warmup_steps: int = 2000
    total_steps: int = 300_000
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    if_dpo: bool = False  # the driver halves the batch (ar/data/data_module.py:45)


def make_s1_optimizer(params, tcfg: S1TrainConfig):
    if tcfg.optimizer == "scaled_adam":
        return ScaledAdam(params, lr=warmup_cosine_lr(0.0, 0.01, 0.002, tcfg.warmup_steps,
                                                      tcfg.total_steps, locked=0.002),
                          betas=(0.9, 0.95), clipping_scale=2.0, clipping_update_period=1000)
    if tcfg.optimizer != "adamw":
        raise ValueError(f"unknown optimizer {tcfg.optimizer!r}")
    return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=tcfg.weight_decay)


def adamw_lr(tcfg: S1TrainConfig, step: int) -> float:
    """optax ``warmup_cosine_decay_schedule(0, learning_rate, warmup_steps,
    total_steps)`` at ``step`` updates taken: linear up, cosine down to 0."""
    w, peak = tcfg.warmup_steps, tcfg.learning_rate
    if step < w:
        return peak * min(step, w) / w
    d = tcfg.total_steps - w
    return peak * 0.5 * (1.0 + math.cos(math.pi * min(step - w, d) / d))


def init_s1_tree(mcfg: G.ARConfig, seed: int):
    """The port-layout AR tree of the numpy init (``utils/params.ar_init``;
    the JAX package's init draws other numbers)."""
    return P.to_port_layout(P.ar_init(mcfg, seed))


def init_s1_state(mcfg: G.ARConfig, tcfg: S1TrainConfig, *, seed: int = 0, device,
                  tree=None) -> T.TrainState:
    """``params["ar"]`` the AR tree (port layout), ``opt["ar"]`` its optimizer."""
    tree = tree if tree is not None else init_s1_tree(mcfg, seed)
    return T.TrainState(tcfg, {"ar": tree}, device, make_opt=make_s1_optimizer)


def make_s1_step(mcfg: G.ARConfig, tcfg: S1TrainConfig, compute_dtype=None, dp=None):
    """Returns ``step(state, batch, *, generator=None, noise=None) ->
    {"loss", "acc"}`` (0-dim tensors, not synchronised). ``batch``: x (B,
    Tx), x_lengths, y (B, Ty) codes, y_lengths, bert (B, Tx, bert_dim) on
    the state's device. ``noise`` {"reject_ids" (B, 2)} pins the DPO spans.
    After the step each parameter's ``.grad`` holds the gradient its
    optimizer applied (AdamW's clipped). ``compute_dtype`` runs forward and
    backward in that type through a differentiable cast of the f32
    parameters and the BERT rows."""

    def step(state: T.TrainState, batch: dict, *, generator=None, noise=None) -> dict:
        net, opt = state.params["ar"], state.opt["ar"]
        opt.zero_grad(set_to_none=True)
        args = (T._cast(net.params, compute_dtype), mcfg, batch["x"], batch["x_lengths"],
                batch["y"], batch["y_lengths"], T._cast(batch["bert"], compute_dtype))
        if tcfg.if_dpo:
            loss, acc = G.ar_forward_train_dpo(*args, generator=generator,
                                               ids=(noise or {}).get("reject_ids"), dp=dp)
        else:
            loss, acc = G.ar_forward_train(*args, dp=dp)
        loss.backward()
        # ScaledAdam reads a missing gradient as 0 too
        T.fill_missing_grads(opt)
        reduce_grads(net.parameters(), dp)
        if tcfg.optimizer == "adamw":
            grads = [p.grad for p in net.parameters()]
            norm = torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()
            # optax clip_by_global_norm: g / norm * max_norm where norm >= max_norm
            torch._foreach_mul_(grads, torch.where(norm < tcfg.grad_clip, 1.0,
                                                   tcfg.grad_clip / norm))
            for group in opt.param_groups:
                group["lr"] = adamw_lr(tcfg, state.step)
        opt.step()
        state.step += 1
        return reduce_metrics({"loss": loss.detach(), "acc": acc.detach()}, dp)

    return step


# ---------------------------------------------------------------------------
# Stage 2: SoVITS
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class S2TrainConfig(T.TrainConfig):
    sampling_rate: int = 32000
    filter_length: int = 2048
    hop_length: int = 640
    win_length: int = 2048
    c_commit: float = 1.0
    # the EMA buffers (module/quantize.py:44-50); the dead-code expiry has no
    # effect (ops/rvq.ema_step), so its threshold is not an option here
    vq_decay: float = 0.99
    vq_epsilon: float = 1e-5
    vq_kmeans_iters: int = 50


def init_s2_trees(mcfg: G.SoVITSConfig, seed: int) -> dict:
    """Port-layout trees of the generator (``sovits_init`` without its
    ``codebook``, which the EMA buffers hold) and of the MultiPeriod
    discriminator (``mpd_init``), from the numpy inits."""
    g = P.to_port_layout(P.sovits_init(mcfg, seed))
    del g["codebook"]
    return {"g": g, "d": P.to_port_layout(P.mpd_init(seed + 1))}


class S2TrainState(T.TrainState):
    """``params["g"]``/``["d"]`` and their AdamWs as ``TrainState``, plus
    ``vq``, the codebook's EMA buffers (ops/rvq.py) on the same device, and
    ``vq_inited``, the host's copy of ``vq["inited"]`` (so a step reads
    nothing from the card to decide on k-means)."""

    def __init__(self, tcfg, trees: dict, device, vq: dict):
        super().__init__(tcfg, trees, device)
        self.vq = {k: v.to(device) for k, v in vq.items()}
        self.vq_inited = bool(self.vq["inited"] > 0)

    def state_dict(self) -> dict:
        return {**super().state_dict(), "vq": dict(self.vq)}

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        dev = self.vq["embed"].device
        self.vq = {k: v.to(dev) for k, v in state["vq"].items()}
        self.vq_inited = bool(self.vq["inited"] > 0)

    def bundle_tree(self):
        """The SoVITS tree in the bundle layout (``codebook`` the EMA's embed):
        what ``gpt_sovits.sovits_decode`` serves after ``to_port_layout``."""
        tree = P.from_port_layout(self.params["g"].numpy_tree(), P.SOVITS_LINEARS)
        return {**tree, "codebook": self.vq["embed"].detach().cpu().numpy()}


def init_s2_state(mcfg: G.SoVITSConfig, tcfg: S2TrainConfig, *, seed: int = 0, device,
                  trees: dict | None = None, vq: dict | None = None) -> S2TrainState:
    """A fresh state: ``trees`` (default :func:`init_s2_trees`) and ``vq``
    (default not inited, ``rvq.state_init``)."""
    trees = trees if trees is not None else init_s2_trees(mcfg, seed)
    vq = vq if vq is not None else rvq.state_init(mcfg.n_codes, mcfg.ssl_dim)
    return S2TrainState(tcfg, trees, device, vq)


def make_s2_step(mcfg: G.SoVITSConfig, tcfg: S2TrainConfig, compute_dtype=None, dp=None):
    """Returns ``step(state, batch, *, generator=None, noise=None) ->
    metrics`` (0-dim tensors, not synchronised). ``batch``: ssl (B, Tf,
    ssl_dim), spec (B, Tf, F), spec_lengths, text (B, Tt), text_lengths, wav
    (B, Tf * hop), on the state's device. ``noise`` pins the draws:
    "kmeans_ids" (n_codes,) the k-means initial means' rows (first step),
    and ``sovits_forward_train``'s "posterior" and "ids_slice". After the
    step each parameter's ``.grad`` holds the gradient its optimizer
    applied. ``compute_dtype`` as in ``make_s1_step`` (the EMA buffers stay
    f32)."""
    seg_samples = mcfg.segment_size * tcfg.hop_length
    stride = 2 if mcfg.semantic_frame_rate == "25hz" else 1

    def mel_of(wav):
        return mel_spectrogram(wav, tcfg.filter_length, tcfg.n_mel_channels, tcfg.sampling_rate,
                               tcfg.hop_length, tcfg.win_length, tcfg.mel_fmin, tcfg.mel_fmax)

    def step(state: S2TrainState, batch: dict, *, generator=None, noise=None) -> dict:
        noise = noise or {}
        net_g, net_d = state.params["g"], state.params["d"]
        opt_g, opt_d = state.opt["g"], state.opt["d"]
        ssl, spec, wav = (T._cast(batch[k], compute_dtype) for k in ("ssl", "spec", "wav"))
        params_g = T._cast(net_g.params, compute_dtype)

        # the codebook's buffers see the pre-update features, outside autograd
        with torch.no_grad():
            proj = params_g["ssl_proj"]
            flat = conv1d(ssl, proj["w"], proj["b"], stride=stride, padding=0).float()
            flat = flat.reshape(-1, flat.shape[-1])
        if not state.vq_inited:
            state.vq = rvq.kmeans_init(state.vq, flat, kmeans_iters=tcfg.vq_kmeans_iters,
                                       generator=generator, ids=noise.get("kmeans_ids"), dp=dp)
            state.vq_inited = True

        opt_g.zero_grad(set_to_none=True)
        out = G.sovits_forward_train(
            {**params_g, "codebook": T._cast(state.vq["embed"], compute_dtype)}, mcfg, ssl,
            spec, batch["spec_lengths"], batch["text"], batch["text_lengths"],
            generator=generator, noise=noise, dp=dp)
        y_hat = out["wav"][..., 0][:, :seg_samples]
        y_real = slice_segments(wav[..., None], out["ids_slice"] * tcfg.hop_length,
                                seg_samples)[..., 0]

        # the discriminator, on the detached generated segment
        opt_d.zero_grad(set_to_none=True)
        yr, yg, _, _ = D.mpd_apply(T._cast(net_d.params, compute_dtype), y_real, y_hat.detach())
        loss_disc = L.discriminator_loss(yr, yg, dp)[0]
        loss_disc.backward()
        T.fill_missing_grads(opt_d)
        reduce_grads(net_d.parameters(), dp)
        opt_d.step()

        # the generator, through the updated discriminator
        with T._frozen(net_d):
            _, yg, fmap_r, fmap_g = D.mpd_apply(T._cast(net_d.params, compute_dtype), y_real,
                                                y_hat)
            loss_gen = L.generator_loss(yg, dp)[0]
            loss_fm = L.feature_loss(fmap_r, fmap_g, dp)
            y_mel, yh_mel = mel_of(y_real), mel_of(y_hat)
            n = min(y_mel.shape[1], yh_mel.shape[1])
            loss_mel = mean_share(torch.abs(y_mel[:, :n] - yh_mel[:, :n]), dp) * tcfg.c_mel
            loss_kl = L.kl_loss(out["z_p"], out["logs_q"], out["m_p"], out["logs_p"],
                                out["y_mask"], dp) * tcfg.c_kl
            commit = out["commit_loss"]
            total = loss_gen + loss_fm + loss_mel + loss_kl + commit * tcfg.c_commit
            total.backward()
        T.fill_missing_grads(opt_g)
        reduce_grads(net_g.parameters(), dp)
        opt_g.step()

        state.vq = rvq.ema_step(state.vq, flat, decay=tcfg.vq_decay, epsilon=tcfg.vq_epsilon,
                                dp=dp)
        state.step += 1
        return reduce_metrics({"loss_disc": loss_disc.detach(), "loss_gen_all": total.detach(),
                               "loss_gen": loss_gen.detach(), "loss_fm": loss_fm.detach(),
                               "loss_mel": loss_mel.detach(), "loss_kl": loss_kl.detach(),
                               "commit": commit.detach()}, dp)

    return step
