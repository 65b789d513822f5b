"""The VITS2 variants and the BigVGAN vocoder of the port on the card.

Marked ``cuda``: each test skips where there is no NVIDIA GPU. This file
imports no JAX, so on a machine with the card and without JAX it runs as
``python -m pytest tests/test_torch_cuda_variants.py -m cuda --noconftest``.
Kernel 5 (``flash_attention.global_flash_attention``) against its plain
version at the windowless flow attention's shapes (C 96, 2 heads, head dim
48; valid lengths below T), 1e-4 abs. A ``pre_conv`` bundle from the port's
numpy init (couplings perturbed) through the serving passes on the card,
with the plain versions refused, and on the CPU fed the card's durations,
noise 0: kernel 5 launches twice a flow a decode (its two windowless
layers), kernel 1 once a text-encoder layer, kernel 2 four times (the SDP),
and the waveforms agree within 1e-3 x peak (f32 on both sides, other
summation orders); a BigVGAN vocoder on the card against the CPU within
1e-3 x peak.
"""

import numpy as np
import pytest
import torch

from vosk_tts_tpu_torch.models import bigvgan, vits2
from vosk_tts_tpu_torch.ops import ddsconv_fused as ddf
from vosk_tts_tpu_torch.ops import flash_attention as fa
from vosk_tts_tpu_torch.utils.params import (bigvgan_init, perturb_zero_init, synthesizer_init,
                                             to_port_layout, to_torch)

VITS2 = dict(inter_channels=192, hidden_channels=64, filter_channels=128, n_layers=2, n_flows=2,
             upsample_initial_channel=64, n_speakers=4, gin_channels=16,
             transformer_flow_type="pre_conv", decoder_type="istft")
BIGVGAN = dict(num_mels=16, upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
               upsample_initial_channel=64, resblock_kernel_sizes=(3, 7),
               resblock_dilation_sizes=((1, 3), (1, 3)))


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
    ks = {"banded": fa.KERNEL, "ddsconv": ddf.KERNEL, "separate": fa.GLOBAL_KERNEL}
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
@pytest.mark.parametrize("b,t,lengths", [(1, 397, [355]), (16, 2048, [2048 - 97 * i
                                                                     for i in range(16)])])
def test_kernel5_at_the_flow_shapes(dev, b, t, lengths):
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(b, t, 96, generator=g, device=dev) for _ in range(3))
    kv_len = torch.tensor(lengths, dtype=torch.int32, device=dev)
    want = fa.global_attention_plain(q, k, v, kv_len, n_heads=2, sm_scale=48**-0.5)
    before = fa.GLOBAL_KERNEL.launches
    got = fa.global_flash_attention(q, k, v, kv_len, n_heads=2, sm_scale=48**-0.5)
    assert fa.GLOBAL_KERNEL.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_pre_conv_bundle_on_the_card(dev, monkeypatch):
    cfg = vits2.VITS2Config(**VITS2)
    tree = to_port_layout(perturb_zero_init(synthesizer_init(cfg, seed=0), seed=1))
    ids = torch.tensor(np.random.default_rng(2).integers(1, 62, (1, 64)))
    ids[0, 50:] = 0
    lengths, sid = torch.tensor([50], dtype=torch.int32), torch.tensor([3])
    synth = vits2.Synthesizer(cfg, tree).to(dev)
    kernels = _refuse_plain(monkeypatch)
    with torch.inference_mode():
        enc = synth.encode_for_infer(ids.to(dev), lengths.to(dev), sid.to(dev), noise_scale_w=0.0)
        got = synth.decode_from_durations(enc, sid.to(dev), max_frames=512, noise_scale=0.0)
    assert _launches(kernels) == {"banded": 2, "ddsconv": 4, "separate": 4}
    monkeypatch.undo()
    cpu = vits2.Synthesizer(cfg, tree)
    with torch.inference_mode():
        enc_c = cpu.encode_for_infer(ids, lengths, sid, noise_scale_w=0.0)
        enc_c["w_ceil"] = enc["w_ceil"].cpu()  # the card's durations
        want = cpu.decode_from_durations(enc_c, sid, max_frames=512, noise_scale=0.0)
    n = int(want["wav_lengths"][0])
    assert n == int(got["wav_lengths"][0]) > 0
    _close(got["wav"][0, :n].cpu(), want["wav"][0, :n])


@pytest.mark.cuda
def test_bigvgan_on_the_card(dev):
    cfg = bigvgan.BigVGANConfig(**BIGVGAN)
    tree = to_port_layout(bigvgan_init(cfg, seed=3))
    mel = torch.randn(2, 32, 16, generator=torch.Generator().manual_seed(4))
    want = bigvgan.bigvgan_apply(to_torch(tree, "cpu"), cfg, mel)
    with torch.inference_mode():
        got = bigvgan.bigvgan_apply(to_torch(tree, dev), cfg, mel.to(dev)).cpu()
    assert got.shape == (2, 32 * 256)
    _close(got, want)
