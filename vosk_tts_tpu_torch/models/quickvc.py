"""QuickVC voice conversion (vosk_tts_tpu/models/quickvc.py), inference,
channels-last.

  enc_p   posterior encoder over 768-d ContentVec features (no speaker)
  flow    plain residual couplings (4, mean-only), run in reverse
  dec     ms-iSTFT generator at 16 kHz (upsample 5, 4; 4 subbands)
  enc_spk 3-layer LSTM speaker encoder over an 80-mel log spectrogram,
          averaged over 128-frame partial slices

The posterior encoder, flows and generator are models/vits2.py's, on the
VITS2 configuration ``QuickVCConfig.as_vits2`` gives. ContentVec itself
is models/hubert.py; ``pipelines.convert_voice`` joins the two.
:func:`forward_train` is the training forward (train/vc_train.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F

from ..ops.commons import rand_slice_segments
from . import vits2
from .tree import TreeModule


@dataclass(frozen=True)
class QuickVCConfig:
    spec_channels: int = 641  # filter_length 1280 // 2 + 1
    segment_size: int = 32  # frames
    inter_channels: int = 192
    hidden_channels: int = 192
    ssl_dim: int = 768
    gin_channels: int = 256
    resblock: str = "1"
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: Sequence[int] = (5, 4)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: Sequence[int] = (16, 16)
    gen_istft_n_fft: int = 16
    gen_istft_hop_size: int = 4
    subbands: int = 4
    decoder_type: str = "ms_istft"
    n_mel_channels: int = 80

    def as_vits2(self, *, spec_channels=None, gin=None) -> vits2.VITS2Config:
        rates, kernels = tuple(self.upsample_rates), tuple(self.upsample_kernel_sizes)
        return vits2.VITS2Config(
            spec_channels=self.spec_channels if spec_channels is None else spec_channels,
            segment_size=self.segment_size,
            inter_channels=self.inter_channels,
            hidden_channels=self.hidden_channels,
            resblock=self.resblock,
            resblock_kernel_sizes=tuple(self.resblock_kernel_sizes),
            resblock_dilation_sizes=tuple(tuple(d) for d in self.resblock_dilation_sizes),
            upsample_rates=rates,
            upsample_initial_channel=self.upsample_initial_channel,
            upsample_kernel_sizes=kernels,
            # QuickVC's ConvTranspose1d scheme: padding (k-u+1-i)//2 and
            # output_padding 1-i for layer i
            upsample_paddings=tuple((k - u + 1 - i) // 2
                                    for i, (u, k) in enumerate(zip(rates, kernels))),
            upsample_output_paddings=tuple(1 - i for i in range(len(rates))),
            gen_istft_n_fft=self.gen_istft_n_fft,
            gen_istft_hop_size=self.gen_istft_hop_size,
            subbands=self.subbands,
            decoder_type=self.decoder_type,
            gin_channels=self.gin_channels if gin is None else gin,
            n_speakers=0,
            use_transformer_flows=False,
        )


PARTIAL_FRAMES, PARTIAL_HOP = 128, 64  # embed_utterance's slices


def speaker_encoder_apply(params, mels: torch.Tensor, *, train: bool = False) -> torch.Tensor:
    """mels: (B, T, n_mel) -> L2-normalised embedding (B, emb): the LSTM
    stack (torch's gate order i, f, g, o, as in the bundle), ReLU of the
    projection of the last layer's final hidden state. ``train`` runs the
    LSTM in its training mode (dropout 0, so the same numbers), the one
    whose backward cuDNN runs; serving uses its inference mode."""
    layers = params["lstm"]
    weights = [w for layer in layers for w in (layer["w_ih"], layer["w_hh"], layer["b_ih"],
                                               layer["b_hh"])]
    h0 = mels.new_zeros(len(layers), mels.shape[0], layers[0]["w_hh"].shape[1])
    _, h_last, _ = torch.lstm(mels, (h0, h0), weights, True, len(layers), 0.0, train, False, True)
    e = torch.relu(F.linear(h_last[-1], params["linear"]["w"], params["linear"]["b"]))
    return e / torch.linalg.vector_norm(e, dim=1, keepdim=True)


def embed_utterance(params, mel: torch.Tensor) -> torch.Tensor:
    """mel: (1, T, n_mel) -> (1, emb). Up to 128 frames: one embedding of
    the whole; longer: the mean of the embeddings of the 128-frame slices
    starting every 64 frames below T - 128, and of the last 128 frames."""
    t = mel.shape[1]
    if t <= PARTIAL_FRAMES:
        return speaker_encoder_apply(params, mel)
    starts = range(0, t - PARTIAL_FRAMES, PARTIAL_HOP)
    stack = torch.stack([mel[0, s: s + PARTIAL_FRAMES] for s in starts]
                        + [mel[0, t - PARTIAL_FRAMES:]])
    return speaker_encoder_apply(params, stack).mean(dim=0, keepdim=True)


def forward_train(params, cfg: QuickVCConfig, c, spec, mel, *, generator=None, noise=None):
    """The training forward. c: (B, T, ssl_dim) ContentVec features; spec:
    (B, T, spec_channels) linear spectrogram; mel: (B, T, n_mel) for the
    speaker embedding (the LSTM in training mode); every row full length.
    The content posterior (prior stats m_p, logs_p), the spectral posterior
    under the embedding, the flow forward, and the generator on a random
    ``segment_size``-frame slice of z. ``noise`` {"posterior_p",
    "posterior_q" (B, T, inter_channels) normal, "ids_slice" (B,) int} pins
    the draws; else they come from ``generator``. Returns wav (B,
    segment * 320, 1), wav_mb, ids_slice, spec_mask, z, z_p, m_p, logs_p,
    m_q, logs_q."""
    noise = noise or {}
    full = lambda a: torch.full((a.shape[0],), a.shape[1], dtype=torch.int32, device=a.device)
    g = speaker_encoder_apply(params["enc_spk"], mel, train=True)[:, None, :]
    v = cfg.as_vits2()
    _, m_p, logs_p, _ = vits2.posterior_apply(
        params["enc_p"], cfg.as_vits2(spec_channels=cfg.ssl_dim, gin=0), c, full(c),
        generator=generator, noise=noise.get("posterior_p"))
    lengths = full(spec)
    z, m_q, logs_q, spec_mask = vits2.posterior_apply(params["enc_q"], v, spec, lengths, g,
                                                      generator=generator,
                                                      noise=noise.get("posterior_q"))
    z_p = vits2.flow_block_apply(params["flow"], v, z, spec_mask, g, reverse=False)
    z_slice, ids = rand_slice_segments(z, lengths, cfg.segment_size, generator=generator,
                                       ids=noise.get("ids_slice"))
    o, o_mb = vits2.generator_apply(params["dec"], v, z_slice, g)
    return {"wav": o, "wav_mb": o_mb, "ids_slice": ids, "spec_mask": spec_mask, "z": z,
            "z_p": z_p, "m_p": m_p, "logs_p": logs_p, "m_q": m_q, "logs_q": logs_q}


def infer(params, cfg: QuickVCConfig, c, tgt_mel, *, generator=None, noise=None):
    """c: (B, T, ssl_dim) ContentVec features; tgt_mel: (1, Tm, n_mel) the
    target's log-mel -> waveform (B, T * 320). The content posterior
    (``noise`` (B, T, inter_channels) or a draw from ``generator``), the
    flow in reverse under the target's embedding, the generator."""
    b = c.shape[0]
    c_lengths = torch.full((b,), c.shape[1], dtype=torch.int32, device=c.device)
    g = embed_utterance(params["enc_spk"], tgt_mel)[:, None, :].expand(b, 1, -1)
    z_p, _, _, c_mask = vits2.posterior_apply(
        params["enc_p"], cfg.as_vits2(spec_channels=cfg.ssl_dim, gin=0), c, c_lengths,
        generator=generator, noise=noise)
    v = cfg.as_vits2()
    z = vits2.flow_block_apply(params["flow"], v, z_p, c_mask, g, reverse=True)
    return vits2.generator_apply(params["dec"], v, z * c_mask, g)[0][..., 0]


class QuickVC(TreeModule):
    """The weights of one QuickVC model as a module (models/tree.py)."""

    def __init__(self, cfg: QuickVCConfig, tree):
        vits2.check_flow(cfg.as_vits2())
        vits2.check_decoder(cfg.as_vits2())
        super().__init__(tree)
        self.cfg = cfg

    def embed_utterance(self, mel):
        return embed_utterance(self.params["enc_spk"], mel)

    def infer(self, *args, **kwargs):
        return infer(self.params, self.cfg, *args, **kwargs)
