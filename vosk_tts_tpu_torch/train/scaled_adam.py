"""ScaledAdam (k2/icefall), GPT-SoVITS stage 1's optimizer
(vosk_tts_tpu/train/scaled_adam.py), as a ``torch.optim.Optimizer``.

Adam-like steps scaled by each tensor's parameter RMS, a learned per-tensor
log-scale moved every ``size_update_period`` steps, and gradient clipping
against a threshold refreshed from a ring of past gradient norms. Each
parameter has its own state, as each leaf of the JAX transformation does
(the reference stacks same-shaped tensors only to go faster on its CPU).

Every quirk of the JAX function is kept, since it runs them:

  * the clipping factor reaches only the size update's ``scale_grads``; the
    Adam step and the second moment read the raw gradient;
  * a parameter of one element takes the scalar step: lr x
    ``scalar_lr_scale``, then the parameter clamped to +-``scalar_max``;
  * ``param_rms`` starts as the initial parameter's RMS and is refreshed on
    size steps (``step % T == T - 1``); the size update itself runs there
    only when ``step > 0``;
  * the ring of ``clipping_update_period`` (P) total norms refreshes the
    threshold to ``clipping_scale x sorted(ring)[min(P - 1, (P // 4) * 2)]``
    on steps that are multiples of P (not step 0); the factor is 1 for the
    first P steps;
  * the second moment is bias-corrected only while ``1 - beta2^(step+1)``
    is below 0.99;
  * the step count starts at 0.

The whole update is tensor ops on the parameters' device: the step count,
the ring and the threshold are tensors, branches are ``torch.where``, and
nothing is read on the host, so a step may be captured in a CUDA graph.

``warmup_cosine_lr`` is the reference's WarmupCosineLRSchedule, whose
``step()`` sets the learning rate to 0.002 whatever the schedule says: the
lock (the default) is what the reference runs.
"""

from __future__ import annotations

import math

import torch


def warmup_cosine_lr(init_lr: float, peak_lr: float, end_lr: float, warmup_steps: int,
                     total_steps: int, locked: float | None = 0.002):
    """The learning rate as a function of the step count (a tensor):
    the constant ``locked``, or with ``locked=None`` a linear warmup from
    ``init_lr`` to ``peak_lr`` over ``warmup_steps``, a cosine down to
    ``end_lr`` at ``total_steps``, then ``end_lr``."""
    if locked is not None:
        return lambda step: torch.full((), locked, dtype=torch.float32, device=step.device)

    def schedule(step):
        step = step.to(torch.float32)
        warm = init_lr + (peak_lr - init_lr) / warmup_steps * step
        ratio = ((step - warmup_steps) / (total_steps - warmup_steps)).clamp(0.0, 1.0)
        cos = end_lr + 0.5 * (1.0 + torch.cos(math.pi * ratio)) * (peak_lr - end_lr)
        return torch.where(step < warmup_steps, warm,
                           torch.where(step > total_steps, torch.full_like(cos, end_lr), cos))

    return schedule


class ScaledAdam(torch.optim.Optimizer):
    """``lr`` a float or a function of the step count (a 0-dim int64 tensor)
    returning the learning rate. ``.grad`` of each parameter is the raw
    gradient (None reads as 0); :meth:`step` moves the parameters in place.
    The shared state (the step count, the norm ring, the threshold) is
    ``global_state``, saved in ``state_dict()`` under ``"global"``."""

    def __init__(self, params, lr=0.01, betas=(0.9, 0.95), clipping_scale: float = 2.0,
                 scalar_lr_scale: float = 0.1, eps: float = 1e-8, param_min_rms: float = 1e-5,
                 param_max_rms: float = 3.0, scalar_max: float = 10.0,
                 size_update_period: int = 4, clipping_update_period: int = 1000):
        # a schedule stays out of the param group, which state_dict() saves
        self.lr_fn = lr if callable(lr) else None
        defaults = dict(lr=None if callable(lr) else lr, betas=tuple(betas),
                        clipping_scale=clipping_scale, scalar_lr_scale=scalar_lr_scale, eps=eps,
                        param_min_rms=param_min_rms, param_max_rms=param_max_rms,
                        scalar_max=scalar_max,
                        size_update_period=size_update_period,
                        clipping_update_period=clipping_update_period)
        super().__init__(params, defaults)
        if len(self.param_groups) != 1:
            raise ValueError("ScaledAdam takes one parameter group (the clip is global)")
        group = self.param_groups[0]
        dev = group["params"][0].device
        self.global_state = {
            "step": torch.zeros((), dtype=torch.int64, device=dev),
            "model_norms": torch.zeros(clipping_update_period, device=dev),
            "model_norm_threshold": torch.full((), math.inf, device=dev)}
        with torch.no_grad():
            for p in group["params"]:
                st = self.state[p]
                st["delta"] = torch.zeros_like(p)
                st["exp_avg_sq"] = torch.zeros_like(p)
                if p.numel() > 1:
                    # optim.py:287-290: the rms of the initial parameter
                    st["param_rms"] = p.square().mean().sqrt()
                    st["scale_grads"] = torch.zeros(size_update_period, dtype=p.dtype,
                                                    device=dev)
                    st["scale_exp_avg_sq"] = torch.zeros((), dtype=p.dtype, device=dev)

    def state_dict(self) -> dict:
        return {**super().state_dict(), "global": dict(self.global_state)}

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        saved = state_dict.pop("global")
        super().load_state_dict(state_dict)
        self.global_state = {k: v.to(self.global_state[k].device) for k, v in saved.items()}

    def _clip_factor(self, params, grads, group):
        """(the factor on scale_grads, the new norm ring, the new threshold)
        (optim.py:300-389)."""
        gs = self.global_state
        step, period, scale = gs["step"], group["clipping_update_period"], group["clipping_scale"]
        weighted = [g.float() if p.numel() == 1 else g.float() * self.state[p]["param_rms"].float()
                    for p, g in zip(params, grads)]
        tot_norm = torch.stack(torch._foreach_norm(weighted)).square().sum().sqrt()
        slot = torch.arange(period, device=step.device) == step % period
        norms = torch.where(slot, tot_norm, gs["model_norms"])
        med = torch.sort(norms).values[min(period - 1, (period // 4) * 2)]
        refresh = (step % period == 0) & (step > 0)
        threshold = torch.where(refresh, scale * med, gs["model_norm_threshold"])
        factor = torch.where(step < period, 1.0, torch.clamp(threshold / (tot_norm + 1e-20),
                                                             max=1.0))
        return torch.where(step == 0, 1.0, factor), norms, threshold

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ScaledAdam takes no closure")
        group = self.param_groups[0]
        params = group["params"]
        # a parameter the loss does not read has gradient 0, as in JAX: its
        # momentum still moves it
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        gs = self.global_state
        step = gs["step"]
        lr = self.lr_fn(step) if self.lr_fn is not None else group["lr"]
        beta1, beta2 = group["betas"]
        eps, min_rms = group["eps"], group["param_min_rms"]
        t = group["size_update_period"]
        size_lr = lr * group["scalar_lr_scale"]
        factor, norms, threshold = self._clip_factor(params, grads, group)

        is_size_step = step % t == t - 1
        do_size = is_size_step & (step > 0)
        beta2c = beta2 ** t
        bc2_size = 1 - beta2c ** ((step + 1) // t).to(torch.float32)
        bc2 = 1 - beta2 ** (step + 1).to(torch.float32)
        # the gradient's second moment is bias-corrected only while bc2 < 0.99
        bc2_used = torch.where(bc2 < 0.99, bc2, 1.0)
        slot = torch.arange(t, device=step.device) == step % t
        for p, g in zip(params, grads):
            st = self.state[p]
            delta, eas = st["delta"], st["exp_avg_sq"]
            delta.mul_(beta1)
            eas.mul_(beta2).addcmul_(g, g, value=1 - beta2)
            if p.numel() == 1:
                # _step_scalar (optim.py:600-622)
                denom = (eas / bc2).sqrt() + eps
                delta.add_(-size_lr * (1 - beta1) * g / denom)
                p.add_((p.clamp(-group["scalar_max"], group["scalar_max"]) - p) + delta)
                continue
            # the size (log-scale) bookkeeping (optim.py:474-489)
            sg = torch.where(slot, (p * (g * factor)).sum(), st["scale_grads"])
            st["scale_grads"] = sg
            rms = torch.where(is_size_step, p.square().mean().sqrt(), st["param_rms"])
            st["param_rms"] = rms
            # _size_update (optim.py:499-558)
            seas_new = beta2c * st["scale_exp_avg_sq"] + (1 - beta2c) * sg.square().mean()
            scale_step = -size_lr * bc2_size.sqrt() * sg.sum() / (seas_new.sqrt() + eps)
            scale_step = torch.where(rms < min_rms, 0.0, scale_step)
            scale_step = torch.where(rms > group["param_max_rms"], -size_lr * t, scale_step)
            st["scale_exp_avg_sq"] = torch.where(do_size, seas_new, st["scale_exp_avg_sq"])
            delta.add_(torch.where(do_size, (1 - beta1) * scale_step, 0.0) * p)
            # _step (optim.py:560-598)
            alpha = -lr * (1 - beta1) * rms.clamp(min=min_rms)
            delta.add_(g / ((eas / bc2_used).sqrt() + eps) * alpha)
            p.add_(delta)
        gs["model_norms"], gs["model_norm_threshold"] = norms, threshold
        gs["step"] = step + 1
