"""GPT-SoVITS (vosk_tts_tpu/models/gpt_sovits.py): zero-shot cloning, and the
training forwards of both stages.

Stage 1, the AR model (text -> semantic tokens): a joint [x; y] post-LN
transformer, causal over y, with a static KV cache. ``prefill`` runs the
text and the prompt once and fills the cache (L, B, H, max_t, Dk); each
further token is one step of all layers over the cache. The step keeps
everything it reads and writes in tensors at fixed addresses (the cache,
the tokens, the step counter, the key lengths, the Gumbel draws made up
front from a ``torch.Generator``), with cache writes by ``index_copy_`` and
no host sync, so on the card it is captured once a decode as a CUDA graph
and replayed for each token; on the CPU it runs eagerly. The JAX package
compiles the same step into one program for the same reason (``lax.scan``
over stacked layers, gpt_sovits.py:277-333): eagerly it is ~460 launches
a token.

Stage 2, SoVITS (semantic tokens + reference spectrogram -> 32 kHz
waveform): the mel style encoder gives the speaker vector, the text
encoder with MRTE cross-attention gives the prior (its three relative-
position encoders run the banded attention kernel, ops/attention.py), then
the reverse plain couplings and the speaker-conditioned HiFiGAN generator
with padded-frame masking (models/vits2.py).

Training (train/gpt_sovits_train.py): ``ar_forward_train`` (the summed
cross-entropy of the teacher-forced pass) and ``ar_forward_train_dpo``
(with a span-repeated rejection, ``make_reject_y``); ``sovits_forward_train``
(the straight-through codebook, the MRTE encoder on the dense attention
route, the posterior, the flow forward and the generator on a random slice).

Layouts are the port's (utils/params.py): Linear (O, I), Conv1d (O, I, K).
Draws come from a ``torch.Generator``; jax.random draws other numbers, so
parity with the JAX package holds under greedy decoding (``top_k=1``), on
the filtered logits, and at ``noise_scale=0`` or with ``noise=`` fed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import attention as att
from ..ops.commons import rand_slice_segments, sequence_mask
from ..ops.conv import conv1d
from ..parallel.mesh import mean_share, size
from . import vits2

#: the host reads the decode's stop flags once every this many tokens
CHECK_EVERY = 16


@dataclass(frozen=True)
class ARConfig:
    embedding_dim: int = 512
    hidden_dim: int = 512
    num_head: int = 8
    num_layers: int = 24
    vocab_size: int = 1025  # 1024 codes + EOS
    phoneme_vocab_size: int = 512
    bert_dim: int = 1024
    eos: int = 1024
    max_len: int = 1500  # static decode cap (t2s_model.py:390)
    ff_mult: int = 4


def _sine_pe(t: int, dim: int) -> np.ndarray:
    position = np.arange(t, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32) * -(math.log(10000.0) / dim))
    pe = np.zeros((t, dim), np.float32)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


def _ln(x, p):
    return F.layer_norm(x, x.shape[-1:], p["gamma"], p["beta"], 1e-5)


def _heads(a, cfg: ARConfig):
    """(B, T, D) -> (B, H, T, Dk)."""
    b, t, _ = a.shape
    return a.reshape(b, t, cfg.num_head, cfg.hidden_dim // cfg.num_head).transpose(1, 2)


def _ffn_and_norms(layer, x, ctx):
    """The rest of a post-LN layer after attention: out projection, LN1,
    ReLU FFN, LN2."""
    x = _ln(x + F.linear(ctx, layer["out"]["w"], layer["out"]["b"]), layer["ln1"])
    f = torch.relu(F.linear(x, layer["ff1"]["w"], layer["ff1"]["b"]))
    return _ln(x + F.linear(f, layer["ff2"]["w"], layer["ff2"]["b"]), layer["ln2"])


def _layer_full(layer, cfg: ARConfig, x, attn_bias):
    """Post-LN layer over a full sequence. attn_bias: (B|1, 1, T, T).
    Returns (x, k, v), k and v (B, H, T, Dk) for the cache."""
    b, t, d = x.shape
    dk = cfg.hidden_dim // cfg.num_head
    q, k, v = (_heads(a, cfg) for a in F.linear(x, layer["qkv"]["w"], layer["qkv"]["b"]).split(d, -1))
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dk) + attn_bias
    ctx = torch.matmul(torch.softmax(scores, dim=-1), v).transpose(1, 2).reshape(b, t, d)
    return _ffn_and_norms(layer, x, ctx), k, v


def _embed_inputs(params, cfg: ARConfig, x_ids, bert, y_ids):
    """Text emb + BERT + alpha-scaled sine positions; audio emb + positions."""
    x = params["text_emb"][x_ids.long()]
    if bert is not None:
        x = x + F.linear(bert, params["bert_proj"]["w"], params["bert_proj"]["b"])
    pe = lambda t: torch.from_numpy(_sine_pe(t, cfg.embedding_dim)).to(x.device, x.dtype)
    x = x + params["text_alpha"] * pe(x_ids.shape[1])
    y = params["audio_emb"][y_ids.long()] + params["audio_alpha"] * pe(y_ids.shape[1])
    return x, y


def joint_mask(x_len: int, y_len: int, x_lens, y_lens=None):
    """(B, 1, T, T) additive bias: x sees x (not y); y is causal over y and
    sees x; padded keys (x past x_lens, y past y_lens) at -1e9."""
    dev = x_lens.device
    pos = torch.arange(x_len + y_len, device=dev)
    is_y = pos >= x_len
    vis = ~(is_y[None, :] & (~is_y[:, None] | (pos[None, :] > pos[:, None])))
    pad_x = torch.arange(x_len, device=dev)[None, :] < x_lens[:, None]
    pad_y = (torch.arange(y_len, device=dev)[None, :] < y_lens[:, None] if y_lens is not None
             else torch.ones(x_lens.shape[0], y_len, dtype=torch.bool, device=dev))
    mask = vis[None] & torch.cat([pad_x, pad_y], dim=1)[:, None, :]
    return torch.where(mask, 0.0, -1e9)[:, None]


def _eos_padded(cfg: ARConfig, y_ids, y_lens):
    """(B, Ty + 1): y's codes, EOS past each row's length and in the appended
    last column (pad_y_eos, t2s_model.py:316-321)."""
    t_y = y_ids.shape[1]
    y_pad = torch.arange(t_y, device=y_ids.device)[None, :] >= y_lens[:, None]
    return F.pad(torch.where(y_pad, cfg.eos, y_ids), (0, 1), value=cfg.eos)


def ar_logits(params, cfg: ARConfig, x_ids, x_lens, y_ids, y_lens, bert):
    """Teacher-forced logits (B, Ty, V): the joint pass over [x; y] with
    y's padded codes as EOS (t2s_model.py make_input_data); the logits at
    y position j predict code j + 1."""
    t_y = y_ids.shape[1]
    y_in = _eos_padded(cfg, y_ids, y_lens)[:, :-1]
    x, y = _embed_inputs(params, cfg, x_ids, bert, y_in)
    xy = torch.cat([x, y], dim=1)
    bias = joint_mask(x_ids.shape[1], t_y, x_lens, y_lens)
    for layer in params["layers"]:
        xy, _, _ = _layer_full(layer, cfg, xy, bias)
    return F.linear(xy[:, x_ids.shape[1]:], params["predict"]["w"])


# ---------------------------------------------------------------------------
# Training (t2s_model.py forward_old :184-248 and the DPO forward :145-182)
# ---------------------------------------------------------------------------


def _target_logps(logits, targets):
    """log_softmax(logits) at the targets: (B, Ty)."""
    return torch.log_softmax(logits, dim=-1).gather(-1, targets[..., None].long())[..., 0]


def _ce_and_acc(params, cfg: ARConfig, x_ids, x_lens, y_ids, y_lens, bert, dp=None):
    """(the targets' log-probabilities (B, Ty), the accuracy): targets are
    the EOS-padded codes shifted by one."""
    logits = ar_logits(params, cfg, x_ids, x_lens, y_ids, y_lens, bert)
    targets = _eos_padded(cfg, y_ids, y_lens)[:, 1:]
    acc = mean_share((logits.argmax(-1) == targets).to(logits.dtype), dp)
    return _target_logps(logits, targets), acc


def ar_forward_train(params, cfg: ARConfig, x_ids, x_lens, y_ids, y_lens, bert, *, dp=None):
    """(loss, acc): the cross-entropy SUMMED over every position, padded ones
    too (their target is EOS; t2s_model.py:243 ``reduction="sum"`` with no
    mask), and the accuracy of the argmax over every position. x_ids (B,
    Tx), y_ids (B, Ty) codes, bert (B, Tx, bert_dim). ``dp`` (the data axis
    of a data-parallel step, parallel/mesh.py): this rank's shares (the
    loss is a sum, so its share is the local sum)."""
    logps, acc = _ce_and_acc(params, cfg, x_ids, x_lens, y_ids, y_lens, bert, dp)
    return -logps.sum(), acc


def make_reject_y(y_ids, y_lens, *, generator=None, ids=None):
    """The DPO rejection (ar/models/utils.py make_reject_y :196-230): each
    padded row with a span [i0, i1) repeated, position t reading y[t] for
    t < i1 and y[t - (i1 - i0)] after, in a (B, 2 Ty) buffer, zero past
    the new length Ty + (i1 - i0) (the reference counts the padded length).
    ``ids`` (B, 2) are the span's two ends, drawn uniformly in [0, Ty)
    from ``generator`` where not given. Returns (reject (B, 2 Ty), lengths)."""
    b, t_y = y_ids.shape
    if ids is None:
        ids = torch.randint(0, t_y, (b, 2), generator=generator, device=y_ids.device)
    ids = ids.to(y_ids.device).long()
    i0, i1 = ids.min(dim=1).values, ids.max(dim=1).values
    span = i1 - i0
    pos = torch.arange(2 * t_y, device=y_ids.device)[None, :]
    src = torch.where(pos < i1[:, None], pos, pos - span[:, None]).clamp(0, t_y - 1)
    lengths = t_y + span
    return y_ids.gather(1, src) * (pos < lengths[:, None]).to(y_ids.dtype), lengths


def dpo_loss(chosen_logps, rejected_logps, beta: float = 0.2):
    """Reference-free DPO (ar/models/utils.py :164-181, beta 0.2)."""
    return -F.logsigmoid(beta * (chosen_logps - rejected_logps)).mean()


def _batch_logps(logits, targets):
    """A row's summed target log-probabilities over the whole y region,
    padded positions too (get_batch_logps, ar/models/utils.py :185-193)."""
    return _target_logps(logits, targets).sum(-1)


def ar_forward_train_dpo(params, cfg: ARConfig, x_ids, x_lens, y_ids, y_lens, bert, *,
                         generator=None, ids=None, dp=None):
    """(loss, acc) of the DPO forward (t2s_model.py forward :145-182): the
    summed cross-entropy of the chosen codes plus the DPO term against
    :func:`make_reject_y`'s rejection (``ids`` pins its spans), whose pass
    runs on the 2 Ty buffer. ``dp`` as in :func:`ar_forward_train`."""
    logps, acc = _ce_and_acc(params, cfg, x_ids, x_lens, y_ids, y_lens, bert, dp)
    reject, reject_lens = make_reject_y(y_ids, y_lens, generator=generator, ids=ids)
    r_logits = ar_logits(params, cfg, x_ids, x_lens, reject, reject_lens, bert)
    r_logps = _batch_logps(r_logits, _eos_padded(cfg, reject, reject_lens)[:, 1:])
    # the DPO term is a mean over the rows: a rank's share is its mean / the axis size
    return -logps.sum() + dpo_loss(logps.sum(-1), r_logps) / size(dp), acc


def prefill(params, cfg: ARConfig, x_ids, x_lens, bert, prompts, *, max_new: int):
    """The full pass over [text; prompt]: (logits of the next token (B, V)
    with EOS at -inf, as the first step cannot stop; cache_k, cache_v
    (L, B, H, max_t, Dk) with max_t = Tx + Tp + max_new + 1, rows past
    Tx + Tp zero)."""
    b, t_x = x_ids.shape
    t0 = t_x + prompts.shape[1]
    x, y = _embed_inputs(params, cfg, x_ids, bert, prompts)
    cur = torch.cat([x, y], dim=1)
    bias = joint_mask(t_x, prompts.shape[1], x_lens)
    h, dk = cfg.num_head, cfg.hidden_dim // cfg.num_head
    shape = (len(params["layers"]), b, h, t0 + max_new + 1, dk)
    cache_k, cache_v = cur.new_zeros(shape), cur.new_zeros(shape)
    for li, layer in enumerate(params["layers"]):
        cur, k, v = _layer_full(layer, cfg, cur, bias)
        cache_k[li, :, :, :t0] = k
        cache_v[li, :, :, :t0] = v
    logits = F.linear(cur[:, -1], params["predict"]["w"])
    logits[:, cfg.eos] = -math.inf
    return logits, cache_k, cache_v


# ---------------------------------------------------------------------------
# Sampling (ar/models/utils.py:110-161)
# ---------------------------------------------------------------------------


def filter_logits(logits, prev_mask, *, top_k=15, top_p=1.0, repetition_penalty=1.35,
                  temperature=1.0):
    """The logits the draw samples from, over the last axis (-inf outside
    the support), in the JAX package's order: the repetition penalty on
    previously seen tokens (``prev_mask``), the top-p filter on the sorted
    softmax (the first entry kept), the temperature, then top-k as
    ``logits < k-th largest`` -> -inf (ties kept)."""
    if repetition_penalty != 1.0:
        penalized = torch.where(logits < 0, logits * repetition_penalty, logits / repetition_penalty)
        logits = torch.where(prev_mask, penalized, logits)
    if top_p is not None and top_p < 1.0:
        sorted_logits, sort_idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        remove_sorted = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1) > top_p
        remove_sorted[..., 0] = False
        remove = torch.zeros_like(remove_sorted).scatter(-1, sort_idx, remove_sorted)
        logits = logits.masked_fill(remove, -math.inf)
    logits = logits / max(temperature, 1e-5)
    if top_k is not None and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -math.inf)
    return logits


def gumbel(shape, generator, device):
    """Standard Gumbel draws -log(-log(u)), u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def sample_logits(logits, prev_mask, g, **kw):
    """A categorical draw over the last axis from :func:`filter_logits`'s
    logits, as the argmax of logits + ``g`` (standard Gumbel draws of the
    logits' shape, :func:`gumbel`)."""
    return torch.argmax(filter_logits(logits, prev_mask, **kw) + g, dim=-1)


# ---------------------------------------------------------------------------
# KV-cached AR decode
# ---------------------------------------------------------------------------


def _layer_step(layer, cfg: ARConfig, x, ck, cv, pos, hidden):
    """One token through one layer. x (B, 1, D); ck, cv (B, H, max_t, Dk),
    this token's k, v written at ``pos`` ((1,) int64); hidden (B, 1, 1,
    max_t) True for the keys it may not see."""
    b, _, d = x.shape
    dk = cfg.hidden_dim // cfg.num_head
    q, k, v = (_heads(a, cfg) for a in F.linear(x, layer["qkv"]["w"], layer["qkv"]["b"]).split(d, -1))
    ck.index_copy_(2, pos, k)
    cv.index_copy_(2, pos, v)
    scores = (torch.matmul(q, ck.transpose(-1, -2)) / math.sqrt(dk)).masked_fill(hidden, -1e9)
    ctx = torch.matmul(torch.softmax(scores, dim=-1), cv).transpose(1, 2).reshape(b, 1, d)
    return _ffn_and_norms(layer, x, ctx)


class Decode:
    """One AR decode: the prefill, the first token, then :meth:`step` for
    each further token, all state in tensors on the decode's device.

    ``tokens`` (B, max_new) int64 starts as EOS; ``stop`` (B,) is the step
    at which each row sampled the EOS that stopped it (max_new if none);
    ``logits`` (B, V) the last step's unpenalised logits. Row semantics are
    the JAX package's: a row stops when the argmax of the unpenalised
    logits or the sampled token is EOS, once ``i >= min_new``; a sampled
    EOS before that is written and fed back; a stopped row writes EOS."""

    def __init__(self, params, cfg: ARConfig, x_ids, x_lens, bert, prompts, *, generator=None,
                 max_new: int = 600, min_new: int = 0, top_k: int = 15, top_p: float = 1.0,
                 temperature: float = 1.0, repetition_penalty: float = 1.35):
        dev = x_ids.device
        b, t_x = x_ids.shape
        t_p = prompts.shape[1]
        self.params, self.cfg, self.max_new, self.min_new = params, cfg, max_new, min_new
        self.sampling = dict(top_k=top_k, top_p=top_p, temperature=temperature,
                             repetition_penalty=repetition_penalty)
        self.t_x, self.t0 = t_x, t_x + t_p
        logits0, self.cache_k, self.cache_v = prefill(params, cfg, x_ids, x_lens, bert, prompts,
                                                      max_new=max_new)
        max_t = self.cache_k.shape[3]
        self.x_lens = x_lens.to(torch.int64)
        self.key_idx = torch.arange(max_t, device=dev)
        self.pe = torch.from_numpy(_sine_pe(max_t, cfg.embedding_dim)).to(dev)
        self.gumbel = gumbel((max_new, b, cfg.vocab_size), generator, dev)
        self.prev_mask = torch.zeros(b, cfg.vocab_size, dtype=torch.bool, device=dev)
        if t_p > 0:
            self.prev_mask.scatter_(1, prompts.long(), True)
        first = sample_logits(logits0, self.prev_mask, self.gumbel[0], **self.sampling)
        self.tokens = torch.full((b, max_new), cfg.eos, dtype=torch.int64, device=dev)
        self.tokens[:, 0] = first
        self.done = (first == cfg.eos) & (min_new < 1)
        self.stop = torch.where(self.done, 0, max_new)
        self.prev_mask.scatter_(1, first[:, None], True)
        self.i = torch.ones(1, dtype=torch.int64, device=dev)
        self.logits = logits0.clone()

    def step(self):
        """Token ``i``: embed token i-1, all layers over the cache, the
        predict head, the draw and the stop bookkeeping; then i += 1."""
        p, cfg, i = self.params, self.cfg, self.i
        last = self.tokens.index_select(1, i - 1)[:, 0]
        pos = i + (self.t0 - 1)  # token i-1's cache slot
        x = (p["audio_emb"][last] + p["audio_alpha"] * self.pe.index_select(0, pos - self.t_x))[:, None]
        idx = self.key_idx[None, :]
        seen = (idx <= pos) & ((idx < self.x_lens[:, None]) | (idx >= self.t_x))
        hidden = ~seen[:, None, None, :]
        for li, layer in enumerate(p["layers"]):
            x = _layer_step(layer, cfg, x, self.cache_k[li], self.cache_v[li], pos, hidden)
        logits = F.linear(x[:, 0], p["predict"]["w"])
        self.logits.copy_(logits)
        self.prev_mask.scatter_(1, last[:, None], True)
        nxt = sample_logits(logits, self.prev_mask, self.gumbel.index_select(0, i)[0],
                            **self.sampling)
        is_eos = ((torch.argmax(logits, dim=-1) == cfg.eos) | (nxt == cfg.eos)) & (i >= self.min_new)
        self.stop.copy_(torch.where(~self.done & is_eos, i, self.stop))
        self.tokens.index_copy_(1, i, torch.where(self.done | is_eos, cfg.eos, nxt)[:, None])
        self.done.logical_or_(is_eos)
        self.i.add_(1)

    def capture(self) -> torch.cuda.CUDAGraph:
        """A CUDA graph of :meth:`step`; each replay advances the decode one
        token. The step runs once eagerly on a side stream first (the
        warm-up a capture needs), so the decode is one token further on
        return. A capture that fails raises."""
        dev = self.i.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            self.step()
            graph.capture_begin()
            try:
                self.step()
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        return graph

    def run(self):
        """Steps until every row has stopped or max_new tokens exist: on the
        card replays of one captured step (the host reads the stop flags
        every CHECK_EVERY tokens; a stopped row only writes EOS), on the CPU
        the step itself. Returns (tokens, stop)."""
        todo = self.max_new - 1
        graph = None
        while todo > 0 and not bool(self.done.all()):
            chunk = min(CHECK_EVERY if self.i.is_cuda else 1, todo)
            for _ in range(chunk):
                if not self.i.is_cuda:
                    self.step()
                elif graph is None:
                    graph = self.capture()
                else:
                    graph.replay()
            todo -= chunk
        return self.tokens, self.stop


def ar_infer(params, cfg: ARConfig, x_ids, bert, prompts, *, generator=None, max_new: int = 600,
             min_new: int = 0, top_k: int = 15, top_p: float = 1.0, temperature: float = 1.0,
             repetition_penalty: float = 1.35, x_len=None):
    """infer_panel (t2s_model.py:324-447) for one text: x_ids (1, Tx),
    bert (1, Tx, bert_dim) or None, prompts (1, Tp) reference codes.
    Returns (tokens (1, max_new), n): tokens past n are EOS, n drops the
    stopping EOS. ``min_new``: EOS is ignored for the first min_new tokens.
    ``x_len``: the true text length where x_ids is right-padded (padded
    positions are masked out of every attention, so the tokens equal an
    unpadded run's)."""
    x_lens = torch.tensor([x_ids.shape[1] if x_len is None else x_len], device=x_ids.device)
    tokens, stop = Decode(params, cfg, x_ids, x_lens, bert, prompts, generator=generator,
                          max_new=max_new, min_new=min_new, top_k=top_k, top_p=top_p,
                          temperature=temperature, repetition_penalty=repetition_penalty).run()
    return tokens, stop[0]


def ar_infer_batch(params, cfg: ARConfig, x_ids, x_lens, bert, prompts, *, generator=None,
                   max_new: int = 600, min_new: int = 0, top_k: int = 15, top_p: float = 1.0,
                   temperature: float = 1.0, repetition_penalty: float = 1.35):
    """Batched infer_panel: x_ids (B, Tx) right-padded, x_lens (B,), bert
    (B, Tx, bert_dim), prompts (B, Tp). Every row decodes until its own
    EOS; stopped rows write EOS. Returns (tokens (B, max_new), n (B,)):
    n is each row's first EOS (max_new if none), as in the JAX package.
    With top_k=1 each row equals its batch-1 greedy run."""
    tokens, _ = Decode(params, cfg, x_ids, x_lens, bert, prompts, generator=generator,
                       max_new=max_new, min_new=min_new, top_k=top_k, top_p=top_p,
                       temperature=temperature, repetition_penalty=repetition_penalty).run()
    is_eos = tokens == cfg.eos
    n = torch.where(is_eos.any(dim=1), torch.argmax(is_eos.to(torch.int8), dim=1), max_new)
    return tokens, n


# ===========================================================================
# Stage 2: SoVITS token-to-waveform decoder
# ===========================================================================


@dataclass(frozen=True)
class SoVITSConfig:
    spec_channels: int = 1025
    segment_size: int = 32  # frames
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    resblock: str = "1"
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: tuple = (10, 8, 2, 2, 2)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: tuple = (16, 16, 8, 2, 2)
    gin_channels: int = 512
    ssl_dim: int = 768
    n_codes: int = 1024
    semantic_frame_rate: str = "25hz"
    n_symbols: int = 512
    mrte_hidden: int = 512
    style_hidden: int = 128

    def as_vits2(self) -> vits2.VITS2Config:
        """The VITS2 configuration of the posterior, flows and generator."""
        return vits2.VITS2Config(
            spec_channels=self.spec_channels, segment_size=self.segment_size,
            inter_channels=self.inter_channels, hidden_channels=self.hidden_channels,
            filter_channels=self.filter_channels, n_heads=self.n_heads, n_layers=self.n_layers,
            kernel_size=self.kernel_size, resblock=self.resblock,
            resblock_kernel_sizes=self.resblock_kernel_sizes,
            resblock_dilation_sizes=self.resblock_dilation_sizes,
            upsample_rates=self.upsample_rates,
            upsample_initial_channel=self.upsample_initial_channel,
            upsample_kernel_sizes=self.upsample_kernel_sizes, decoder_type="hifigan",
            gin_channels=self.gin_channels, n_speakers=0, use_transformer_flows=False)


def upsample_factor(cfg: SoVITSConfig) -> int:
    """Audio samples per semantic code: x2 for 25 Hz codes, then the HiFiGAN
    upsample stack (1280 at 32 kHz)."""
    return (2 if cfg.semantic_frame_rate == "25hz" else 1) * math.prod(cfg.upsample_rates)


def mel_style_encoder_apply(params, cfg: SoVITSConfig, spec, spec_mask):
    """MelStyleEncoder (module/modules.py:685-763): spec (B, T,
    spec_channels), spec_mask (B, T, 1) -> speaker vector (B, gin). Mish
    MLP, two GLU convs (padding 2), 2-head self-attention at temperature
    sqrt(style_hidden) with masked keys at -inf, a masked temporal mean."""
    h = cfg.style_hidden
    m = spec_mask[..., 0]
    x = F.mish(F.linear(spec, params["spec1"]["w"], params["spec1"]["b"]))
    x = F.mish(F.linear(x, params["spec2"]["w"], params["spec2"]["b"]))
    for glu in ("glu1", "glu2"):
        y = conv1d(x, params[glu]["w"], params[glu]["b"], padding=2)
        x = x + y[..., :h] * torch.sigmoid(y[..., h:])
    x = x * m[..., None]
    b, t, _ = x.shape
    heads = lambda a: a.reshape(b, t, 2, h // 2).transpose(1, 2)
    q, k, v = (heads(F.linear(x, params[n]["w"], params[n]["b"])) for n in ("wq", "wk", "wv"))
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(h)
    scores = scores.masked_fill(m[:, None, None, :] == 0, -math.inf)
    out = torch.matmul(torch.softmax(scores, dim=-1), v).transpose(1, 2).reshape(b, t, h)
    x = x + F.linear(out, params["fc_attn"]["w"], params["fc_attn"]["b"])
    x = F.linear(x, params["fc"]["w"], params["fc"]["b"])
    return (x * m[..., None]).sum(dim=1) / m.sum(dim=1, keepdim=True).clamp(min=1)


def rvq_encode(codebook, x):
    """Nearest codes: codebook (bins, D), x (B, T, D) -> (B, T) int64."""
    d = (x.square().sum(-1, keepdim=True) - 2 * torch.matmul(x, codebook.T)
         + codebook.square().sum(-1)[None, None])
    return torch.argmin(d, dim=-1)


def rvq_decode(codebook, codes):
    """codebook[codes]; an index past the table (the EOS that pads a row
    past its length in a bucketed decode) reads its last row, as JAX's
    gather clamps."""
    return codebook[codes.long().clamp(0, codebook.shape[0] - 1)]


def sovits_extract_latent(params, cfg: SoVITSConfig, ssl):
    """SSL features (B, T, ssl_dim) -> semantic codes (B, T // 2) for 25 Hz
    codes (models.py:990): the strided ``ssl_proj`` conv, nearest codes."""
    stride = 2 if cfg.semantic_frame_rate == "25hz" else 1
    x = conv1d(ssl, params["ssl_proj"]["w"], params["ssl_proj"]["b"], stride=stride, padding=0)
    return rvq_encode(params["codebook"], x)


def _sovits_enc_p(params, cfg: SoVITSConfig, quantized, y_lengths, text, text_lengths, ge, *,
                  flash: bool = True):
    """The text encoder with MRTE (module/models.py:174-248,
    mrte_model.py:9-61): the SSL encoder (n_layers // 2), the text encoder
    (n_layers), the codes' frames attending over the text (4 heads) plus
    the frames and the speaker, then encoder2 (n_layers // 2). Returns
    (y, m_p, logs_p, y_mask); rows past y_lengths are garbage before the
    mask (the banded attention attends them to the valid keys). ``flash``
    picks the encoders' attention route (ops/attention.py): training takes
    the dense differentiable one."""
    enc = lambda p, x, mask: att.encoder_apply(p, x * mask, mask, n_heads=cfg.n_heads,
                                               kernel_size=cfg.kernel_size, flash=flash)
    y_mask = sequence_mask(y_lengths, quantized.shape[1]).to(quantized.dtype)[..., None]
    y = conv1d(quantized * y_mask, params["ssl_proj"]["w"], params["ssl_proj"]["b"]) * y_mask
    y = enc(params["encoder_ssl"], y, y_mask)
    text_mask = sequence_mask(text_lengths, text.shape[1]).to(quantized.dtype)[..., None]
    t = enc(params["encoder_text"], params["text_emb"][text.long()], text_mask)
    mr = params["mrte"]
    ssl_enc = conv1d(y * y_mask, mr["c_pre"]["w"], mr["c_pre"]["b"])
    text_enc = conv1d(t * text_mask, mr["text_pre"]["w"], mr["text_pre"]["b"])
    attn_mask = (y_mask * text_mask[:, None, :, 0])[:, None]  # (B, 1, Ty, Tt)
    x = att.mha_apply(mr["attn"], ssl_enc * y_mask, text_enc * text_mask, attn_mask, n_heads=4)
    x = x + ssl_enc + ge[:, None, :]
    y = conv1d(x * y_mask, mr["c_post"]["w"], mr["c_post"]["b"])
    y = enc(params["encoder2"], y, y_mask)
    stats = conv1d(y, params["proj"]["w"], params["proj"]["b"]) * y_mask
    return y, stats[..., :cfg.inter_channels], stats[..., cfg.inter_channels:], y_mask


def sovits_decode(params, cfg: SoVITSConfig, codes, text, text_lengths, refer, refer_lengths, *,
                  generator=None, noise=None, noise_scale: float = 0.5, code_lengths=None):
    """Semantic codes -> waveform (module/models.py:961-988). codes (B, Tc),
    text (B, Tt), refer (B, Tr, spec_channels) -> (B, Tc * upsample_factor).
    ``code_lengths`` (B,) lets codes be padded to a bucket: padded frames
    are masked at every stage (the generator included), so the samples
    below code_length * upsample_factor equal an unpadded decode's.
    ``noise`` (B, 2 Tc, inter_channels) is the prior's standard normal draw;
    without it the draw comes from ``generator``."""
    refer_mask = sequence_mask(refer_lengths, refer.shape[1]).to(refer.dtype)[..., None]
    ge = mel_style_encoder_apply(params["ref_enc"], cfg, refer * refer_mask, refer_mask)
    up = 2 if cfg.semantic_frame_rate == "25hz" else 1
    quantized = rvq_decode(params["codebook"], codes).repeat_interleave(up, dim=1)
    t_q = quantized.shape[1]
    y_lengths = (torch.full((codes.shape[0],), t_q, dtype=torch.int32, device=codes.device)
                 if code_lengths is None else code_lengths.to(torch.int32) * up)
    _, m_p, logs_p, y_mask = _sovits_enc_p(params["enc_p"], cfg, quantized, y_lengths, text,
                                           text_lengths, ge)
    if noise is None:
        noise = torch.randn(m_p.shape, generator=generator, device=m_p.device, dtype=m_p.dtype)
    z_p = (m_p + noise * torch.exp(logs_p) * noise_scale) * y_mask
    v, g = cfg.as_vits2(), ge[:, None, :]
    z = vits2.flow_block_apply(params["flow"], v, z_p, y_mask, g, reverse=True)
    o, _ = vits2.generator_apply(params["dec"], v, z * y_mask, g,
                                 x_lengths=None if code_lengths is None else y_lengths)
    return o[..., 0]


def sovits_forward_train(params, cfg: SoVITSConfig, ssl, spec, spec_lengths, text, text_lengths,
                         *, generator=None, noise=None, dp=None):
    """The training forward (module/models.py:902-937). ssl (B, Ts,
    ssl_dim) frame-aligned to the spectrogram (Ts = Tf at 50 Hz), spec (B,
    Tf, spec_channels), text (B, Tt). The style encoder on the masked
    spectrogram; the strided ``ssl_proj``; the nearest codes of the
    detached features, the commit loss against the detached quantized
    features and the straight-through ``x + (q - x).detach()``, repeated
    x2 for 25 Hz codes; the MRTE text encoder on the dense attention route;
    the posterior, the flow forward, the generator on a random
    ``segment_size``-frame slice of z. ``params["codebook"]`` takes no
    gradient. ``noise`` {"posterior" (B, Tf, inter_channels) normal,
    "ids_slice" (B,) int} pins the draws; else they come from
    ``generator``. Returns the JAX package's dict: wav, commit_loss,
    ids_slice, y_mask, z, z_p, m_p, logs_p, m_q, logs_q. ``dp`` (the data
    axis of a data-parallel step, parallel/mesh.py): ``commit_loss`` is this
    rank's share of the global batch's."""
    noise = noise or {}
    y_mask = sequence_mask(spec_lengths, spec.shape[1]).to(spec.dtype)[..., None]
    ge = mel_style_encoder_apply(params["ref_enc"], cfg, spec * y_mask, y_mask)
    up = 2 if cfg.semantic_frame_rate == "25hz" else 1
    x_ssl = conv1d(ssl, params["ssl_proj"]["w"], params["ssl_proj"]["b"], stride=up, padding=0)
    codebook = params["codebook"].detach()
    quantized = rvq_decode(codebook, rvq_encode(codebook, x_ssl.detach()))
    commit_loss = mean_share((x_ssl - quantized) ** 2, dp)
    quantized = (x_ssl + (quantized - x_ssl).detach()).repeat_interleave(up, dim=1)
    quantized = quantized[:, :spec.shape[1]]
    _, m_p, logs_p, y_mask = _sovits_enc_p(params["enc_p"], cfg, quantized, spec_lengths, text,
                                           text_lengths, ge, flash=False)
    v, g = cfg.as_vits2(), ge[:, None, :]
    z, m_q, logs_q, _ = vits2.posterior_apply(params["enc_q"], v, spec, spec_lengths, g,
                                              generator=generator, noise=noise.get("posterior"))
    z_p = vits2.flow_block_apply(params["flow"], v, z, y_mask, g, reverse=False, flash=False)
    z_slice, ids = rand_slice_segments(z, spec_lengths, cfg.segment_size, generator=generator,
                                       ids=noise.get("ids_slice"))
    o, _ = vits2.generator_apply(params["dec"], v, z_slice, g)
    return {"wav": o, "commit_loss": commit_loss, "ids_slice": ids, "y_mask": y_mask, "z": z,
            "z_p": z_p, "m_p": m_p, "logs_p": logs_p, "m_q": m_q, "logs_q": logs_q}


def ar_from_state_dict(sd: dict, cfg: ARConfig) -> dict:
    """Reference Text2SemanticDecoder state dict (``model.*`` prefixes
    stripped) -> the bundle-layout AR tree (vosk_tts_tpu/models/
    gpt_sovits.py:826); ``utils/params.to_port_layout`` gives the port's."""
    from ..utils.torch_params import _np, linear

    p = {
        "text_emb": _np(sd["ar_text_embedding.word_embeddings.weight"]),
        "audio_emb": _np(sd["ar_audio_embedding.word_embeddings.weight"]),
        "bert_proj": linear(sd, "bert_proj"),
        "text_alpha": _np(sd["ar_text_position.alpha"]).reshape(()),
        "audio_alpha": _np(sd["ar_audio_position.alpha"]).reshape(()),
        "predict": {"w": _np(sd["ar_predict_layer.weight"]).T},
        "layers": [],
    }
    i = 0
    while f"h.layers.{i}.self_attn.in_proj_weight" in sd:
        b = f"h.layers.{i}"
        p["layers"].append({
            "qkv": {"w": _np(sd[f"{b}.self_attn.in_proj_weight"]).T,
                    "b": _np(sd[f"{b}.self_attn.in_proj_bias"])},
            "out": linear(sd, f"{b}.self_attn.out_proj"),
            "ln1": {"gamma": _np(sd[f"{b}.norm1.weight"]), "beta": _np(sd[f"{b}.norm1.bias"])},
            "ff1": linear(sd, f"{b}.linear1"),
            "ff2": linear(sd, f"{b}.linear2"),
            "ln2": {"gamma": _np(sd[f"{b}.norm2.weight"]), "beta": _np(sd[f"{b}.norm2.bias"])},
        })
        i += 1
    return p
