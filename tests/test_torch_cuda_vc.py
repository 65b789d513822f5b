"""The voice-conversion paths of the port on the card.

Marked ``cuda``: each test skips where there is no NVIDIA GPU. This file
imports no JAX, so on a machine with the card and without JAX it runs as
``python -m pytest tests/test_torch_cuda_vc.py -m cuda --noconftest``.
Small models from the port's numpy inits (couplings perturbed) go through
``pipelines.convert_voice`` and ``vits2.Synthesizer.voice_conversion`` on
the card, with the plain versions of the kernels refused, and on the CPU
with the same posterior noise: equal lengths, waveforms within 1e-3 x peak
(f32 on both sides, other summation orders). ``voice_conversion`` launches
the banded attention kernel 8 times a call (4 flows, forward and in
reverse) and no other kernel; ``convert_voice`` launches none.
"""

import numpy as np
import pytest
import torch

from vosk_tts_tpu_torch import pipelines
from vosk_tts_tpu_torch.models import hubert, quickvc, vits2
from vosk_tts_tpu_torch.ops import ddsconv_fused as ddf
from vosk_tts_tpu_torch.ops import flash_attention as fa
from vosk_tts_tpu_torch.utils.params import (hubert_init, perturb_zero_init, quickvc_init,
                                             synthesizer_init, to_port_layout)

HUBERT = dict(hidden_size=48, num_hidden_layers=2, num_attention_heads=4, intermediate_size=96,
              conv_dim=(32,) * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
QUICKVC = dict(ssl_dim=48, inter_channels=32, hidden_channels=32, upsample_initial_channel=64,
               gin_channels=16)
# head dim 32 in the flows' attention (hidden 64, 2 heads)
VITS2 = dict(inter_channels=32, hidden_channels=64, filter_channels=128, n_layers=2,
             upsample_initial_channel=64, n_speakers=4, gin_channels=16, spec_channels=20)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _refuse(*a, **k):
    raise AssertionError("plain version reached with CUDA tensors")


def _refuse_plain(monkeypatch):
    """From here on the plain versions raise; returns the kernels and their
    launch counts so far."""
    for name in ("banded_attention_plain", "global_attention_plain"):
        monkeypatch.setattr(fa, name, _refuse)
    monkeypatch.setattr(ddf, "ddsconv_plain", _refuse)
    ks = {"banded": fa.KERNEL, "ddsconv": ddf.KERNEL, "rope": fa.GLOBAL_ROPE_KERNEL,
          "packed": fa.GLOBAL_PACKED_KERNEL, "separate": fa.GLOBAL_KERNEL}
    return ks, {n: k.launches for n, k in ks.items()}


def _launches(kernels):
    ks, before = kernels
    return {n: k.launches - before[n] for n, k in ks.items()}


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    peak = float(np.abs(want).max())
    assert peak > 0 and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-3 * peak


@pytest.mark.cuda
def test_convert_voice_on_the_card(dev, monkeypatch):
    hcfg, qcfg = hubert.HubertConfig(**HUBERT), quickvc.QuickVCConfig(**QUICKVC)
    htree = to_port_layout(hubert_init(hcfg, seed=0))
    qtree = to_port_layout(perturb_zero_init(quickvc_init(qcfg, seed=1), seed=2))
    rng = np.random.default_rng(3)
    src = (rng.standard_normal(24000) * 0.1).astype(np.float32)
    tgt = (rng.standard_normal(48000) * 0.1).astype(np.float32)  # 150 mel frames
    frames = hcfg.n_frames(len(src))
    noise = torch.randn(1, frames, qcfg.inter_channels, generator=torch.Generator().manual_seed(4))
    want = pipelines.convert_voice(quickvc.QuickVC(qcfg, qtree).params, qcfg,
                                   hubert.Hubert(hcfg, htree).params, hcfg, src, tgt,
                                   device="cpu", noise=noise)
    hub, vc = hubert.Hubert(hcfg, htree).to(dev), quickvc.QuickVC(qcfg, qtree).to(dev)
    kernels = _refuse_plain(monkeypatch)
    got = pipelines.convert_voice(vc.params, qcfg, hub.params, hcfg, src, tgt, noise=noise.to(dev))
    assert got.shape == (frames * 320,)
    _close(got, want)
    assert all(v == 0 for v in _launches(kernels).values())


@pytest.mark.cuda
def test_vits2_voice_conversion_on_the_card(dev, monkeypatch):
    cfg = vits2.VITS2Config(**VITS2)
    tree = to_port_layout(perturb_zero_init(synthesizer_init(cfg, seed=0), seed=1))
    rng = np.random.default_rng(5)
    t = 150
    y = rng.standard_normal((2, t, cfg.spec_channels)).astype(np.float32)
    lengths = torch.tensor([t, 97], dtype=torch.int32)
    sid_src, sid_tgt = torch.tensor([0, 1]), torch.tensor([3, 2])
    noise = torch.randn(2, t, cfg.inter_channels, generator=torch.Generator().manual_seed(6))
    want, _ = vits2.Synthesizer(cfg, tree).voice_conversion(torch.tensor(y), lengths, sid_src,
                                                            sid_tgt, noise=noise)
    synth = vits2.Synthesizer(cfg, tree).to(dev)
    kernels = _refuse_plain(monkeypatch)
    with torch.inference_mode():
        for _ in range(2):
            got, mask = synth.voice_conversion(*(a.to(dev) for a in (torch.tensor(y), lengths,
                                                                      sid_src, sid_tgt)),
                                               noise=noise.to(dev))
    got = got.cpu()
    assert _launches(kernels) == {"banded": 8 * 2, "ddsconv": 0, "rope": 0, "packed": 0,
                                  "separate": 0}
    up = cfg.upsample_factor
    assert got.shape == (2, t * up, 1)
    for i, n in enumerate(lengths.tolist()):
        _close(got[i, :n * up], want[i, :n * up])
