"""StableTTS/Matcha CFM training step (vosk_tts_tpu/train/stabletts_train.py),
in PyTorch.

One AdamW (weight decay 0) over the whole Matcha tree, with gradient
accumulation as the JAX package's ``optax.MultiSteps(chain(
clip_by_global_norm(5), adamw))``: each call of the step is one
micro-batch; its gradient of ``diff_loss + dur_loss`` goes into a running
mean (``acc + (g - acc) / (n + 1)``, optax's); the parameters stay unmoved
until the ``accumulate``-th micro-step, which clips the averaged gradient to
a global norm of 5 and takes one AdamW step. The forward is
``stabletts.forward_train`` on the dense attention route (no hand-written
kernel). The tree is in the port's serving layout (fused qkv), so a
trained state serves through ``stabletts.synthesise`` as it is.

A data-parallel step (``dp=``, parallel/mesh.py) takes each rank's share of
the global micro-batch's losses; the running mean of the shares is summed
over the axis once, on the ``accumulate``-th micro-step before the clip,
so the update is the global batch's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models import stabletts as S
from ..parallel.mesh import all_reduce_tensors, reduce_metrics
from ..utils import params as P
from . import vits2_train as T


@dataclass(frozen=True)
class StableTrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    grad_clip: float = 5.0
    accumulate: int = 4
    cfg_dropout: float = 0.1


def make_optimizer(params, tcfg: StableTrainConfig) -> torch.optim.AdamW:
    """optax ``adamw``'s defaults (betas 0.9/0.999, eps 1e-8 outside the root)."""
    return torch.optim.AdamW(params, lr=tcfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=tcfg.weight_decay)


class StableTrainState(T.TrainState):
    """``params["g"]`` the Matcha tree (port layout), ``opt["g"]`` its
    AdamW, ``acc`` the running mean of the micro-steps' gradients since the
    last update (a tensor a parameter), ``step`` the micro-steps taken."""

    def __init__(self, tcfg: StableTrainConfig, tree, device):
        super().__init__(tcfg, {"g": tree}, device, make_opt=make_optimizer)
        self.acc = [torch.zeros_like(p) for p in self.params["g"].parameters()]

    def state_dict(self) -> dict:
        return {**super().state_dict(), "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        self.acc = [a.to(p.device) for a, p in zip(state["acc"], self.params["g"].parameters())]


def init_tree(mcfg: S.StableTTSConfig, seed: int):
    """The port-layout Matcha tree of the numpy init (``utils/params.
    matcha_init``, adaLN-Zero projections and CFG fakes at zero as
    initialised; the JAX package's init draws other numbers)."""
    return S.port_layout(P.matcha_init(mcfg, seed))


def init_train_state(mcfg: S.StableTTSConfig, tcfg: StableTrainConfig, *, seed: int = 0, device,
                     tree=None) -> StableTrainState:
    return StableTrainState(tcfg, tree if tree is not None else init_tree(mcfg, seed), device)


def make_train_step(mcfg: S.StableTTSConfig, tcfg: StableTrainConfig, compute_dtype=None,
                    dp=None):
    """Returns ``step(state, batch, *, generator=None, noise=None) ->
    metrics`` (0-dim tensors, not synchronised). ``batch``: x (B, 5, T)
    int, x_lengths (B,), mel (B, T_f, n_feats) normalised, mel_lengths (B,),
    sid (B,), bert (B, T, bert_dim), durations (B, T); tensors on the
    state's device. ``noise`` pins ``forward_train``'s draws.
    ``compute_dtype`` runs forward and backward in that type through a
    differentiable cast of the f32 parameters, mel and BERT rows (the
    accumulated gradient and the optimizer stay f32)."""
    k = tcfg.accumulate

    def step(state: StableTrainState, batch: dict, *, generator=None, noise=None) -> dict:
        net, opt = state.params["g"], state.opt["g"]
        params = list(net.parameters())
        out = S.forward_train(T._cast(net.params, compute_dtype), mcfg, batch["x"],
                              batch["x_lengths"], T._cast(batch["mel"], compute_dtype),
                              batch["mel_lengths"], batch["sid"],
                              T._cast(batch["bert"], compute_dtype), batch["durations"],
                              cfg_dropout=tcfg.cfg_dropout, generator=generator, noise=noise,
                              dp=dp)
        loss = out["diff_loss"] + out["dur_loss"]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        n = state.step % k
        with torch.no_grad():
            for a, g in zip(state.acc, grads):  # a tensor the loss does not read has gradient 0
                a.add_(((g.to(a.dtype) if g is not None else 0.0) - a) / (n + 1))
            if n == k - 1:
                all_reduce_tensors(state.acc, dp)
                norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(a)
                                                             for a in state.acc]))
                # optax clip_by_global_norm: g / norm * max_norm where norm >= max_norm
                scale = torch.where(norm < tcfg.grad_clip, 1.0, tcfg.grad_clip / norm)
                for p, a in zip(params, state.acc):
                    p.grad = a * scale
                opt.step()
                for a in state.acc:
                    a.zero_()
        state.step += 1
        return reduce_metrics({"loss": loss.detach(), "diff_loss": out["diff_loss"].detach(),
                               "dur_loss": out["dur_loss"].detach()}, dp)

    return step
