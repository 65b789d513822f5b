"""The GPT-SoVITS cloning path of the port on the card.

Marked ``cuda``: each test skips where there is no NVIDIA GPU. This file
imports no JAX, so on a machine with the card and without JAX it runs as
``python -m pytest tests/test_torch_cuda_clone.py -m cuda --noconftest``.
Small models from the port's numpy inits:

* the AR decode step replayed from its CUDA graph against the same step
  run eagerly on the card (greedy tokens equal; logits within 1e-5, f32
  with TF32 off, the same kernels in the same order);
* the banded attention kernel at the clone shapes (B1 T1024, and a
  5-phone text, below the band's 2w+1 = 9) against its plain version
  (1e-4, as chip_smoke.py holds it);
* ``pipelines.clone_tts`` on the card with the plain versions refused,
  against the CPU under greedy decoding at noise 0: equal tokens,
  waveforms within 1e-3 x peak, 12 banded attention launches (3 + 6 + 3
  encoder layers) and no other kernel;
* ``clone_tts`` whose decode step cannot be captured raises; it does not
  run the step eagerly or on the CPU.
"""

import numpy as np
import pytest
import torch

from vosk_tts_tpu_torch import pipelines
from vosk_tts_tpu_torch.models import gpt_sovits as gs
from vosk_tts_tpu_torch.models import hubert
from vosk_tts_tpu_torch.ops import ddsconv_fused as ddf
from vosk_tts_tpu_torch.ops import flash_attention as fa
from vosk_tts_tpu_torch.utils.params import (ar_init, hubert_init, perturb_zero_init, sovits_init,
                                             to_port_layout, to_torch)

AR = dict(embedding_dim=128, hidden_dim=128, num_head=4, num_layers=3, vocab_size=65,
          phoneme_vocab_size=360, bert_dim=32, eos=64)
SOVITS = dict(inter_channels=32, hidden_channels=64, filter_channels=96, n_layers=6,
              upsample_initial_channel=64, upsample_rates=(10, 8, 2, 2, 2), gin_channels=64,
              ssl_dim=48, n_codes=64, n_symbols=360, mrte_hidden=64, style_hidden=32)
HUBERT = dict(hidden_size=48, num_hidden_layers=2, num_attention_heads=4, intermediate_size=96,
              conv_dim=(32,) * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@pytest.fixture(scope="module")
def models():
    acfg, scfg, hcfg = gs.ARConfig(**AR), gs.SoVITSConfig(**SOVITS), hubert.HubertConfig(**HUBERT)
    trees = (to_port_layout(ar_init(acfg, seed=0)),
             to_port_layout(perturb_zero_init(sovits_init(scfg, seed=1), seed=2)),
             to_port_layout(hubert_init(hcfg, seed=3)))
    return (acfg, scfg, hcfg), trees


def _refuse(*a, **k):
    raise AssertionError("plain version reached with CUDA tensors")


def _ar_inputs(dev, b=2, tx=20, t_p=12):
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.integers(0, 360, (b, tx)), device=dev)
    bert = torch.as_tensor(rng.standard_normal((b, tx, 32)).astype(np.float32), device=dev)
    prompts = torch.as_tensor(rng.integers(0, 64, (b, t_p)), device=dev)
    return x, torch.tensor([tx, tx - 7][:b], device=dev), bert, prompts


@pytest.mark.cuda
def test_replayed_step_equals_eager_step(dev, models):
    (acfg, _, _), trees = models
    ap = to_torch(trees[0], dev)
    x, xl, bert, prompts = _ar_inputs(dev)
    eager = gs.Decode(ap, acfg, x, xl, bert, prompts, max_new=40, min_new=40, top_k=1)
    replayed = gs.Decode(ap, acfg, x, xl, bert, prompts, max_new=40, min_new=40, top_k=1)
    with torch.inference_mode():
        graph = replayed.capture()  # one eager step, then the capture
        eager.step()
        torch.testing.assert_close(replayed.logits, eager.logits, rtol=0, atol=1e-5)
        for _ in range(30):
            graph.replay()
            eager.step()
            torch.testing.assert_close(replayed.logits, eager.logits, rtol=0, atol=1e-5)
    assert torch.equal(replayed.tokens, eager.tokens) and int(replayed.i) == int(eager.i) == 32


def _clone_inputs(trees, cfgs, dev):
    rng = np.random.default_rng(5)
    phonemes = rng.integers(0, 360, 30)
    return ([to_torch(trees[0], dev), cfgs[0], to_torch(trees[1], dev), cfgs[1],
             to_torch(trees[2], dev), cfgs[2], phonemes, np.zeros((30, 32), np.float32),
             (rng.standard_normal(32000) * 0.1).astype(np.float32),
             rng.standard_normal((60, 1025)).astype(np.float32)])


@pytest.mark.cuda
def test_capture_failure_raises(dev, models, monkeypatch):
    """clone_tts on the card whose decode step cannot be captured raises;
    it runs the step neither eagerly nor on the CPU."""
    cfgs, trees = models

    def broken(self, *a, **k):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin", broken)
    with pytest.raises(RuntimeError, match="capture refused"):
        pipelines.clone_tts(*_clone_inputs(trees, cfgs, dev), max_new=8)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1024, 5])
def test_banded_kernel_at_clone_shapes(dev, t):
    g = torch.Generator(device=dev).manual_seed(t)
    q, k, v = (torch.randn(1, 2, t, 96, generator=g, device=dev) for _ in range(3))
    rel_k, rel_v = (torch.randn(1, 9, 96, generator=g, device=dev) * 96**-0.5 for _ in range(2))
    args = (q * 96**-0.5, k, v, rel_k, rel_v, torch.tensor([t], dtype=torch.int32, device=dev))
    got = fa.banded_flash_attention(*args, window=4)
    want = fa.banded_attention_plain(*args, window=4)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_clone_tts_on_the_card(dev, models, monkeypatch):
    cfgs, trees = models
    kw = dict(top_k=1, max_new=24, noise_scale=0.0)
    want, want_n = pipelines.clone_tts(*_clone_inputs(trees, cfgs, "cpu"), device="cpu", **kw)
    card_args = _clone_inputs(trees, cfgs, dev)
    for name in ("banded_attention_plain", "global_attention_plain"):
        monkeypatch.setattr(fa, name, _refuse)
    monkeypatch.setattr(ddf, "ddsconv_plain", _refuse)
    ks = (fa.KERNEL, ddf.KERNEL, fa.GLOBAL_ROPE_KERNEL, fa.GLOBAL_PACKED_KERNEL, fa.GLOBAL_KERNEL)
    before = [k.launches for k in ks]
    got, n = pipelines.clone_tts(*card_args, **kw)
    assert [k.launches - b for k, b in zip(ks, before)] == [12, 0, 0, 0, 0]
    assert n == want_n and got.shape == want.shape == (n * 1280,)
    peak = float(np.abs(want).max())
    assert peak > 0 and float(np.abs(got - want).max()) <= 1e-3 * peak
