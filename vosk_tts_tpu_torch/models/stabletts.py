"""StableTTS / Matcha flow-matching acoustic model, inference
(vosk_tts_tpu/models/stabletts.py), channels-last.

  DiT blocks (adaLN-Zero + partial RoPE + SiLU conv FFN); the 5-stream
  text encoder (phone + 4 punctuation streams + projected BERT, two DiT
  encoders for the mel prior and the durations); the CFM decoder (U-ViT:
  time-FiLM DiT stack with long skips) solved with Euler or Heun steps on a
  cosine-warped time grid, with classifier-free guidance through the
  learned fake speaker/content as one 2B batch.

Every DiT attention runs through ``flash_attention.global_flash_attention_
rope`` on one fused qkv projection (the weights' ``attn.qkv``, concatenated
at load by :func:`port_layout`): the CUDA kernel on the card, its plain version
on the CPU, at any T. Keys at or past the length are masked at -30000;
query rows there are zeroed by the block, as in the JAX package.

Frame shapes are bucketed as in the JAX package (``max_frames``) so that
both packages see the same shapes. The ODE's noise ``z`` may be passed in;
otherwise it comes from an explicit ``torch.Generator``.

Training (:func:`forward_train`: the duration loss and the CFM loss with
classifier-free-guidance dropout) takes the dense differentiable route of
the attention (``flash=False``: the JAX package's einsum path, query x key
masked at -finfo.max); the kernel has no backward. ``noise=`` pins its
draws, as ``vits2.forward_train``'s does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import flash_attention as fa
from ..ops.commons import as_dtype, at_least_f32, generate_path, sequence_mask
from ..ops.conv import conv1d
from ..parallel.mesh import mean_share, total
from ..utils.params import LINEARS, from_port_layout, to_port_layout
from .tree import TreeModule


@dataclass(frozen=True)
class StableTTSConfig:
    n_vocab: int = 256
    n_feats: int = 80
    n_spks: int = 128
    spk_emb_dim: int = 128
    hidden_channels: int = 256
    filter_channels: int = 1024
    n_heads: int = 4
    n_layers: int = 4
    kernel_size: int = 3
    p_dropout: float = 0.1
    phone_emb_dim: int = 160
    punc_emb_dim: int = 16
    bert_dim: int = 768
    bert_proj_dim: int = 32
    dp_out_channels: int = 50  # per-phone duration rows (max 50 frames)
    dec_hidden: int = 384
    dec_filter: int = 768
    dec_layers: int = 6
    dec_heads: int = 4
    dec_kernel: int = 3
    sigma_min: float = 1e-2
    mel_mean: float = -5.8066
    mel_std: float = 2.4542

    @classmethod
    def from_dict(cls, d: dict) -> "StableTTSConfig":
        """From a bundle's ``"model"`` block."""
        return cls(**d)


def rope(x: torch.Tensor, d: int, *, time_axis: int = 2) -> torch.Tensor:
    """Rotate the first ``d`` features (d even) of the last axis: x is
    (B, H, T, Dk) with time_axis=2, or (B, T, H, Dk) with time_axis=1."""
    cos, sin = fa.rope_tables(x.shape[time_axis], d, x.device)
    if time_axis == 1:
        cos, sin = cos[:, None, :], sin[:, None, :]
    return fa.apply_rope(x, cos.to(x.dtype), sin.to(x.dtype))


def d_rope_of(dk: int) -> int:
    """The roped features of a head: half of it, rounded down to even."""
    return (dk // 2) // 2 * 2


def fuse_qkv(attn):
    """Port-layout DiT attention {q, k, v, o} -> {qkv, o}: one (3C, C)
    Linear whose output is [q | k | v], what the global attention kernel
    reads."""
    cat = lambda key: np.ascontiguousarray(np.concatenate([attn[n][key] for n in "qkv"]))
    return {"qkv": {"w": cat("w"), "b": cat("b")}, "o": attn["o"]}


def _dit_blocks(tree):
    te, dec = tree["text_encoder"], tree["decoder"]
    return te["encoder"]["blocks"] + te["dp_encoder"]["blocks"] + [b["dit"] for b in dec["blocks"]]


def port_layout(tree):
    """Bundle-layout ``matcha`` tree (numpy leaves) -> the port's layout:
    utils/params.to_port_layout, then every DiT block's attention fused by
    :func:`fuse_qkv`."""
    out = to_port_layout(tree)
    for blk in _dit_blocks(out):
        blk["attn"] = fuse_qkv(blk["attn"])
    return out


def bundle_layout(tree):
    """The inverse of :func:`port_layout` (a port-layout tree, or its
    gradients, in the JAX package's layout): utils/params.from_port_layout,
    which gives each fused qkv as one (1, C, 3C) 1x1 conv, then that conv
    split into q, k and v."""
    out = from_port_layout(tree, LINEARS)
    for blk in _dit_blocks(out):
        qkv = blk["attn"].pop("qkv")
        ws, bs = np.split(qkv["w"], 3, axis=-1), np.split(qkv["b"], 3)
        blk["attn"] = {**{n: {"w": np.ascontiguousarray(w), "b": np.ascontiguousarray(b)}
                          for n, w, b in zip("qkv", ws, bs)}, **blk["attn"]}
    return out


# ---------------------------------------------------------------------------
# DiT building blocks
# ---------------------------------------------------------------------------


def dit_mha_apply(params, x: torch.Tensor, kv_len: torch.Tensor, *, n_heads: int,
                  flash: bool = True) -> torch.Tensor:
    """x: (B, T, C); kv_len: (B,) int32 valid prefix. One fused qkv
    projection, the attention, the o projection. ``flash``: the global
    RoPE attention kernel (keys at or past kv_len masked); else the dense
    differentiable route of the JAX package's f32 path (q and k roped, the
    scores masked query x key at -finfo.max, so a padded query row attends
    uniformly)."""
    b, t, c = x.shape
    dk = c // n_heads
    qkv = F.linear(x, params["qkv"]["w"], params["qkv"]["b"])  # (B, T, 3C)
    if flash:
        out = fa.global_flash_attention_rope(qkv, kv_len, n_heads=n_heads,
                                             sm_scale=1.0 / math.sqrt(dk), d_rope=d_rope_of(dk))
    else:
        q, k, v = (a.reshape(b, t, n_heads, dk).transpose(1, 2) for a in qkv.split(c, dim=-1))
        q, k = rope(q, d_rope_of(dk)), rope(k, d_rope_of(dk))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dk)
        valid = sequence_mask(kv_len, t)
        pair = valid[:, None, :, None] & valid[:, None, None, :]
        # the JAX package adds -finfo.max there, which any score rounds to
        scores = scores.masked_fill(~pair, -torch.finfo(scores.dtype).max)
        out = torch.matmul(torch.softmax(scores, dim=-1), v).transpose(1, 2).reshape(b, t, c)
    return F.linear(out, params["o"]["w"], params["o"]["b"])


def dit_ffn_apply(params, x, x_mask, *, kernel_size: int):
    x = conv1d(x * x_mask, params["c1"]["w"], params["c1"]["b"], padding=kernel_size // 2)
    x = F.silu(x)
    x = conv1d(x * x_mask, params["c2"]["w"], params["c2"]["b"], padding=kernel_size // 2)
    return x * x_mask


def _kv_len(x_mask):
    return x_mask[..., 0].sum(dim=1).to(torch.int32)


def dit_block_apply(params, x, c, x_mask, *, n_heads: int, kernel_size: int, kv_len=None,
                    flash: bool = True):
    """DiTConVBlock. x: (B, T, C); c: (B, gin); x_mask: (B, T, 1); ``flash``
    as in :func:`dit_mha_apply`."""
    if kv_len is None:
        kv_len = _kv_len(x_mask)
    x = x * x_mask
    h = c
    if "ada_in" in params:
        h = F.linear(h, params["ada_in"]["w"], params["ada_in"]["b"])
    mods = F.linear(F.silu(h), params["ada_out"]["w"], params["ada_out"]["b"])  # (B, 6C)
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mods[:, None, :].chunk(6, dim=-1)
    norm = lambda v: F.layer_norm(v, v.shape[-1:], eps=1e-5)
    a = dit_mha_apply(params["attn"], norm(x) * (1 + scale_msa) + shift_msa, kv_len,
                      n_heads=n_heads, flash=flash)
    x = x + gate_msa * a * x_mask
    f = dit_ffn_apply(params["mlp"], norm(x) * (1 + scale_mlp) + shift_mlp, x_mask,
                      kernel_size=kernel_size)
    return x + gate_mlp * f


def dit_encoder_apply(params, x, c, x_mask, *, n_heads: int, kernel_size: int,
                      flash: bool = True):
    kv_len = _kv_len(x_mask)
    for blk in params["blocks"]:
        x = dit_block_apply(blk, x, c, x_mask, n_heads=n_heads, kernel_size=kernel_size,
                            kv_len=kv_len, flash=flash)
    mu = F.linear(x, params["proj"]["w"], params["proj"]["b"]) * x_mask
    return x, mu


def _text_embed(params, cfg: StableTTSConfig, x, x_lengths, bert):
    """The 5-stream embedding (phone, 4 punctuation streams, projected
    BERT) -> (x_cat (B, T, hidden), x_mask (B, T, 1))."""
    x = x.long()
    x0 = params["emb"][x[:, 0]] * math.sqrt(cfg.phone_emb_dim)
    puncs = [params["punc_emb"][x[:, i]] * math.sqrt(cfg.punc_emb_dim) for i in range(1, 5)]
    br = F.linear(bert, params["bert_proj"]["w"], params["bert_proj"]["b"])
    xc = torch.cat([x0, *puncs, br], dim=-1)
    return xc, sequence_mask(x_lengths, xc.shape[1]).to(xc.dtype)[..., None]


def text_encoder_apply(params, cfg: StableTTSConfig, x, x_lengths, spks, dur_spks, bert, *,
                       flash: bool = True):
    """x: (B, 5, T) int; bert: (B, T, bert_dim). Returns (x_cat, mu_mel,
    mu_dp, x_mask)."""
    xc, x_mask = _text_embed(params, cfg, x, x_lengths, bert)
    _, mu_mel = dit_encoder_apply(params["encoder"], xc, spks, x_mask, n_heads=cfg.n_heads,
                                  kernel_size=cfg.kernel_size, flash=flash)
    _, mu_dp = dit_encoder_apply(params["dp_encoder"], xc, dur_spks, x_mask, n_heads=cfg.n_heads,
                                 kernel_size=cfg.kernel_size, flash=flash)
    return xc, mu_mel, mu_dp, x_mask


# ---------------------------------------------------------------------------
# CFM decoder (U-ViT)
# ---------------------------------------------------------------------------


def _time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """SinusoidalPosEmb with scale 1000. t: (B,). The angles reach ~1000 rad,
    where one ulp of t moves sin/cos by ~1e-4: :func:`time_grid` forms t as
    the JAX package does."""
    half = dim // 2
    emb = math.log(10000) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -emb)
    ang = 1000.0 * t[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def cond_proj_apply(params, cfg: StableTTSConfig, mu):
    """The decoder's content-conditioning stack: depends only on mu, so the
    ODE hoists it out of its time-step loop."""
    m = mu
    n = len(params["cond_proj"])
    for i, cp in enumerate(params["cond_proj"]):
        m = conv1d(m, cp["w"], cp["b"], padding=cfg.dec_kernel // 2)
        if i < n - 1:
            m = F.silu(m)
    return m


def decoder_apply(params, cfg: StableTTSConfig, x, mask, mu, t, c, *, cond=None,
                  flash: bool = True):
    """Velocity estimator. x: (B, T, n_feats); mask: (B, T, 1); mu: (B, T,
    hidden_channels); t: (B,); c: (B, spk_emb_dim); cond: the precomputed
    :func:`cond_proj_apply` of mu (computed here when None); ``flash`` as in
    :func:`dit_mha_apply`."""
    h = cfg.dec_hidden
    te = _time_embedding(t, h).to(mu.dtype)
    te = F.silu(F.linear(te, params["time_mlp"]["l1"]["w"], params["time_mlp"]["l1"]["b"]))
    te = F.linear(te, params["time_mlp"]["l2"]["w"], params["time_mlp"]["l2"]["b"])  # (B, h)

    m = cond_proj_apply(params, cfg, mu) if cond is None else cond
    x = F.linear(torch.cat([x, m], dim=-1), params["in_proj"]["w"], params["in_proj"]["b"])

    kv_len = _kv_len(mask)
    n = len(params["blocks"])
    skips = []
    for idx, blk in enumerate(params["blocks"]):
        if idx < n // 2:
            skips.append(x)
        else:
            lc = params["lsc"][idx - n // 2]
            x = conv1d(torch.cat([x, skips.pop()], dim=-1), lc["w"], lc["b"],
                       padding=cfg.dec_kernel // 2)
        gb = F.linear(te, blk["film"]["film"]["w"], blk["film"]["film"]["b"])[:, None, :]
        x = (gb[..., :h] * x + gb[..., h:]) * mask
        x = dit_block_apply(blk["dit"], x, c, mask, n_heads=cfg.dec_heads,
                            kernel_size=cfg.dec_kernel, kv_len=kv_len, flash=flash)
    out = F.linear(x * mask, params["final_proj"]["w"], params["final_proj"]["b"])
    return out * mask


# ---------------------------------------------------------------------------
# CFM solvers
# ---------------------------------------------------------------------------


def _cfg_inputs(params, cfg: StableTTSConfig, mask, mu, spks, guidance_scale):
    """The CFG-doubled (mask, mu, spks) and the hoisted cond_proj output,
    all invariant over the ODE's steps."""
    if guidance_scale <= 0.0:
        return mask, mu, spks, cond_proj_apply(params["decoder"], cfg, mu)
    b = mu.shape[0]
    fake_spk = params["fake_speaker"].expand(b, cfg.spk_emb_dim)
    fake_mu = params["fake_content"][0, :, 0][None, None, :].expand(b, mu.shape[1],
                                                                    cfg.hidden_channels)
    mm = torch.cat([mask, mask], dim=0)
    uu = torch.cat([mu, fake_mu], dim=0)
    ss = torch.cat([spks, fake_spk], dim=0)
    return mm, uu, ss, cond_proj_apply(params["decoder"], cfg, uu)


def _estimate_cfg(params, cfg: StableTTSConfig, x, t, guidance_scale, cfg_in):
    """One velocity estimate; with guidance, the conditional and
    unconditional passes run as one 2B batch (every estimator op is
    batch-elementwise, so this is exact)."""
    mm, uu, ss, cond = cfg_in
    if guidance_scale <= 0.0:
        return decoder_apply(params["decoder"], cfg, x, mm, uu, t, ss, cond=cond)
    b = x.shape[0]
    est = decoder_apply(params["decoder"], cfg, torch.cat([x, x], dim=0), mm, uu,
                        torch.cat([t, t], dim=0), ss, cond=cond)
    dphi, dphi_avg = est[:b], est[b:]
    return dphi + guidance_scale * (dphi - dphi_avg)


def time_grid(n_timesteps: int) -> np.ndarray:
    """The cosine-warped grid 1 - cos(linspace(0, 1, n+1) * pi/2), in f32 on
    the host, with the linspace formed as JAX forms it (i * f32(1/n), the
    last point 1)."""
    ts = np.arange(n_timesteps + 1, dtype=np.float32) * (np.float32(1.0) / np.float32(n_timesteps))
    ts[-1] = 1.0
    return (1.0 - torch.cos(torch.from_numpy(ts) * 0.5 * math.pi)).numpy()


def cfm_solve(params, cfg: StableTTSConfig, mu, mask, *, n_timesteps: int,
              temperature: float | torch.Tensor = 1.0, spks=None, guidance_scale: float = 0.5,
              solver: str = "euler", z=None, generator=None):
    """z ~ N(0, 1) * temperature (or the given ``z``), then fixed-step Euler
    or Heun over :func:`time_grid`. ``temperature`` is a float or a (B, 1, 1)
    tensor: z is drawn and scaled at the B rows before the CFG batch doubles
    them, so row i of the doubled batch and row B + i share row i's z."""
    b, t_len, _ = mu.shape
    if z is None:
        z = torch.randn((b, t_len, cfg.n_feats), generator=generator, device=mu.device,
                        dtype=mu.dtype) * as_dtype(temperature, mu.dtype)
    ts = time_grid(n_timesteps)
    cfg_in = _cfg_inputs(params, cfg, mask, mu, spks, guidance_scale)
    est = lambda x, tv: _estimate_cfg(params, cfg, x, torch.full((b,), tv, device=mu.device),
                                      guidance_scale, cfg_in)
    x = z
    for t0, t1 in zip(ts[:-1], ts[1:]):
        t0, dt = float(t0), float(t1 - t0)
        d1 = est(x, t0)
        if solver == "euler":
            x = x + dt * d1
        else:
            d2 = est(x + dt * d1, float(np.float32(t0) + np.float32(dt)))
            x = x + dt * 0.5 * (d1 + d2)
    return x


# ---------------------------------------------------------------------------
# Serving passes
# ---------------------------------------------------------------------------


def encode_for_synth(params, cfg: StableTTSConfig, x, x_lengths, spks_id, bert, *,
                     length_scale: float | torch.Tensor = 1.0, phone_duration_extra=None):
    """Pass one of the split serving path: the 5-stream text encoder (both
    DiT stacks) and the sigmoid-sum durations. Returns a dict (xc, mu_mel,
    x_mask, w_round, pde, pred_frames) for :func:`decode_from_durations`;
    ``pred_frames`` (B,) int32 is the unclipped total frame count.
    ``length_scale`` is a float or a (B, 1, 1) tensor, one value a row."""
    sid = spks_id.long()
    spks, dur_spks = params["spk_emb"][sid], params["dur_spk_emb"][sid]
    xc, mu_mel, mu_dp, x_mask = text_encoder_apply(params["text_encoder"], cfg, x, x_lengths,
                                                   spks, dur_spks, bert)
    logw = torch.sigmoid(mu_dp).sum(dim=-1, keepdim=True) * x_mask  # (B, T, 1)
    if phone_duration_extra is not None:
        pde = phone_duration_extra[..., None].to(logw.dtype)
        logw = torch.where(pde == 0, logw, pde)
    else:
        pde = torch.zeros_like(logw)
    w_round = torch.clamp(torch.round(logw * length_scale), min=1) * x_mask
    # frame counts past 256 are not bf16's: summed in f32 from a bf16 graph
    pred = torch.clamp(at_least_f32(w_round).sum(dim=(1, 2)), min=1).to(torch.int32)
    return {"xc": xc, "mu_mel": mu_mel, "x_mask": x_mask, "w_round": w_round, "pde": pde,
            "pred_frames": pred}


def decode_from_durations(params, cfg: StableTTSConfig, enc: dict, spks_id, *, max_frames: int,
                          n_timesteps: int = 10, temperature: float | torch.Tensor = 1.0,
                          guidance_scale: float = 0.5, solver: str = "euler", z=None,
                          generator=None):
    """Pass two: alignment expansion, the CFM ODE, pause replacement and
    denormalization at a ``max_frames`` bucket (``temperature`` as in
    :func:`cfm_solve`)."""
    spks = params["spk_emb"][spks_id.long()]
    xc, mu_mel, x_mask = enc["xc"], enc["mu_mel"], enc["x_mask"]
    w_round, pde = enc["w_round"], enc["pde"]

    y_lengths = torch.clamp(at_least_f32(w_round).sum(dim=(1, 2)), 1, max_frames).to(torch.int32)
    y_mask = sequence_mask(y_lengths, max_frames).to(x_mask.dtype)[..., None]
    attn = generate_path(w_round[..., 0], x_mask[..., 0], y_mask[..., 0])  # (B, Ty, Tx)
    mu_y = torch.bmm(attn, xc)
    mu_y_mel = torch.bmm(attn, mu_mel)
    pau_mel = torch.bmm(attn, pde)

    dec = cfm_solve(params, cfg, mu_y, y_mask, n_timesteps=n_timesteps, temperature=temperature,
                    spks=spks, guidance_scale=guidance_scale, solver=solver, z=z,
                    generator=generator)
    dec = torch.where(pau_mel > 0, dec[:, :1, :], dec)  # pause frames -> the first frame's mel

    mel = dec * cfg.mel_std + cfg.mel_mean
    mel_enc = mu_y_mel * cfg.mel_std + cfg.mel_mean
    return {"decoder_outputs": dec, "encoder_outputs": mu_y_mel, "mel": mel * y_mask,
            "mel_enc": mel_enc * y_mask, "mel_lengths": y_lengths, "attn": attn,
            "durations": w_round[..., 0]}


def synthesise(params, cfg: StableTTSConfig, x, x_lengths, spks_id, bert, *, max_frames: int,
               n_timesteps: int = 10, temperature: float | torch.Tensor = 1.0,
               length_scale: float | torch.Tensor = 1.0,
               guidance_scale: float = 0.5, phone_duration_extra=None, solver: str = "euler",
               z=None, generator=None):
    """The single-pass path at a fixed ``max_frames``: :func:`encode_for_synth`
    then :func:`decode_from_durations`."""
    enc = encode_for_synth(params, cfg, x, x_lengths, spks_id, bert, length_scale=length_scale,
                           phone_duration_extra=phone_duration_extra)
    return decode_from_durations(params, cfg, enc, spks_id, max_frames=max_frames,
                                 n_timesteps=n_timesteps, temperature=temperature,
                                 guidance_scale=guidance_scale, solver=solver, z=z,
                                 generator=generator)


# ---------------------------------------------------------------------------
# Training: the CFM and duration losses (flow_matching.py, duration_predictors.py)
# ---------------------------------------------------------------------------

CFM_T_MAX = 0.98  # the CFM loss's time cut
MAX_PHONE_DUR = 50  # the duration rows of dp_out_channels
BOUNDARY_DUR = 10.0  # the duration the loss pins at BOS and at the sentence end


def cfm_loss(params, cfg: StableTTSConfig, x1, mask, mu, spks, *, generator=None, noise=None,
             dp=None):
    """OT-CFM: the MSE of the decoder's velocity against x1 - z at
    y = (1 - t) z + t x1, t = 1 - cos(u * 0.98 * pi/2), on the dense
    attention route. ``noise`` {"t": u (B, 1, 1) uniform, "z": (B, T,
    n_feats) normal, other keys unread} pins the draws; else they come from
    ``generator``. ``dp`` (the data axis of a data-parallel step,
    parallel/mesh.py): this rank's share, the mask's sum over the axis."""
    b = x1.shape[0]
    if noise is None:
        noise = {"t": torch.rand((b, 1, 1), generator=generator, device=x1.device, dtype=x1.dtype),
                 "z": torch.randn(x1.shape, generator=generator, device=x1.device, dtype=x1.dtype)}
    t = 1.0 - torch.cos(noise["t"] * CFM_T_MAX * 0.5 * math.pi)
    z = noise["z"]
    y = (1 - t) * z + t * x1
    est = decoder_apply(params["decoder"], cfg, y, mask, mu, t[:, 0, 0], spks, flash=False)
    return torch.sum(((est - (x1 - z)) * mask) ** 2) / (total(torch.sum(mask), dp) * cfg.n_feats)


def duration_loss(mu_dp, durations, x_mask, x_lengths, dp=None):
    """The StyleTTS duration loss: a row's log-L1 of the sigmoid-sum
    duration plus 10 x the BCE against the target's duration row (columns
    below the duration set), averaged over valid phones, then over the
    batch. mu_dp: (B, T, 50) logits; durations (B, T) frames, clipped to
    [1, 49], pinned to 10 at BOS and at x_lengths - 2. ``dp``: this rank's
    share of the global batch's (the row means / the axis size)."""
    m = x_mask[..., 0]
    dur = torch.floor(durations.clamp(max=MAX_PHONE_DUR - 1)).clamp(min=1)
    idx = torch.arange(dur.shape[1], device=dur.device)[None, :]
    dur = torch.where((idx == 0) | (idx == (x_lengths - 2)[:, None]), BOUNDARY_DUR, dur)
    cols = torch.arange(mu_dp.shape[-1], device=mu_dp.device)
    trg = (cols[None, None, :] < dur[..., None]).to(mu_dp.dtype)
    dur_pred = torch.sigmoid(mu_dp).sum(dim=-1).clamp(min=1)
    denom = m.sum(dim=1).clamp(min=1)
    l1 = (torch.abs(torch.log(dur_pred) - torch.log(dur)) * m).sum(dim=1) / denom
    bce = -trg * F.logsigmoid(mu_dp) - (1.0 - trg) * F.logsigmoid(-mu_dp)  # optax's sigmoid BCE
    bce = (bce * m[..., None]).sum(dim=(1, 2)) / (denom * mu_dp.shape[-1])
    return mean_share(l1, dp) + 10.0 * mean_share(bce, dp)


def forward_train(params, cfg: StableTTSConfig, x, x_lengths, y, y_lengths, spks_id, bert,
                  durations, *, cfg_dropout: float = 0.1, generator=None, noise=None, dp=None):
    """The training forward on the given durations: the duration encoder's
    loss, the alignment from the durations, classifier-free-guidance dropout
    (a row's speaker and content replaced by the learned fakes) and the CFM
    loss, all on the dense attention route. y: (B, T_f, n_feats) normalised
    mel; durations: (B, T) frames. ``noise`` {"cfg": (B, 1) uniform, "t",
    "z" as in :func:`cfm_loss`} pins the draws; else they come from
    ``generator``. Returns {"dur_loss", "diff_loss", "attn" (B, T_f, T)}.
    The mel encoder's output is not read by either loss, so it is not run
    (its gradient is 0). ``dp``: both losses are this rank's shares of the
    global batch's (:func:`cfm_loss`, :func:`duration_loss`)."""
    sid = spks_id.long()
    spks, dur_spks = params["spk_emb"][sid], params["dur_spk_emb"][sid]
    te = params["text_encoder"]
    xc, x_mask = _text_embed(te, cfg, x, x_lengths, bert)
    _, mu_dp = dit_encoder_apply(te["dp_encoder"], xc, dur_spks, x_mask, n_heads=cfg.n_heads,
                                 kernel_size=cfg.kernel_size, flash=False)
    y_mask = sequence_mask(y_lengths, y.shape[1]).to(x_mask.dtype)[..., None]
    attn = generate_path(durations.to(x_mask.dtype), x_mask[..., 0], y_mask[..., 0])
    logw_ = attn.sum(dim=1) * x_mask[..., 0]
    dur_loss = duration_loss(mu_dp, logw_, x_mask, x_lengths, dp)
    mu_y = torch.bmm(attn, xc)

    b = y.shape[0]
    u = (noise["cfg"] if noise is not None
         else torch.rand((b, 1), generator=generator, device=y.device, dtype=y.dtype))
    keep = (u > cfg_dropout).to(y.dtype)
    spks = spks * keep + (1 - keep) * params["fake_speaker"]
    fake_mu = params["fake_content"][0, :, 0][None, None, :]
    mu_y = mu_y * keep[..., None] + (1 - keep[..., None]) * fake_mu
    diff_loss = cfm_loss(params, cfg, y, y_mask, mu_y, spks, generator=generator, noise=noise,
                         dp=dp)
    return {"dur_loss": dur_loss, "diff_loss": diff_loss, "attn": attn}


class Matcha(TreeModule):
    """The ``matcha`` weights of one multistream bundle as a module
    (models/tree.py): every leaf is a buffer."""

    def __init__(self, cfg: StableTTSConfig, tree):
        super().__init__(tree)
        self.cfg = cfg

    def encode_for_synth(self, *args, **kwargs):
        return encode_for_synth(self.params, self.cfg, *args, **kwargs)

    def decode_from_durations(self, *args, **kwargs):
        return decode_from_durations(self.params, self.cfg, *args, **kwargs)

    def synthesise(self, *args, **kwargs):
        return synthesise(self.params, self.cfg, *args, **kwargs)
