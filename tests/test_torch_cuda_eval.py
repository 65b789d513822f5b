"""Whisper, the GE2E speaker encoder and the profiling utilities of the
port on the card.

Marked ``cuda``: each test skips where there is no NVIDIA GPU. This file
imports no JAX, so on a machine with the card and without JAX it runs as
``python -m pytest tests/test_torch_cuda_eval.py -m cuda --noconftest``.
TF32 is off (f32 on both sides, other summation orders). Tolerances: a
small Whisper encoder's log-mel card vs CPU 1e-4 absolute, its
``get_content`` 1e-3 x peak; one GE2E step from the same tree and batch,
the loss 1e-4 relative and the gradients 1e-3 relative L2 (all tensors
together); ``lstm_embedder`` on the committed artifact 1e-4 absolute on the
unit-norm embedding; ``device_timeit`` on the card within 25% of the same
work timed between CUDA events; ``device_stats`` lists the card.
"""

import numpy as np
import pytest
import torch

from vosk_tts_tpu_torch.eval import speaker_train as ST
from vosk_tts_tpu_torch.models import whisper as W
from vosk_tts_tpu_torch.models.tree import TreeModule
from vosk_tts_tpu_torch.utils import profiling
from vosk_tts_tpu_torch.utils.params import to_port_layout, whisper_init

pytestmark = pytest.mark.cuda

WHISPER = dict(d_model=128, encoder_layers=2, encoder_attention_heads=4, encoder_ffn_dim=256)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _wav(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    wav = 0.3 * np.sin(2 * np.pi * 180 * t) + 0.05 * rng.standard_normal(len(t))
    return wav.astype(np.float32)


def test_whisper_card_vs_cpu(dev):
    cfg = W.WhisperEncConfig(**WHISPER)
    tree = to_port_layout(whisper_init(cfg, seed=0))
    wav = _wav(7.3, 1)
    with torch.inference_mode():
        mel_g = W.whisper_log_mel(torch.tensor(W.pad_or_trim(wav), device=dev)[None]).cpu()
        mel_c = W.whisper_log_mel(torch.tensor(W.pad_or_trim(wav))[None])
        got = W.get_content(TreeModule(tree).to(dev).params, cfg, wav).cpu()
        want = W.get_content(TreeModule(tree).params, cfg, wav)
    assert float((mel_g - mel_c).abs().max()) <= 1e-4
    assert got.shape == want.shape == (1, len(wav) // 160 // 2, 128)
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


def test_ge2e_step_card_vs_cpu(dev):
    tree = to_port_layout(ST.init_tree(0, hidden=32, emb=32, layers=2))
    rng = np.random.default_rng(2)
    utts = [ST.synthetic_utterance(rng, ST.synthetic_voice(rng)) for _ in range(12)]
    mels = np.stack([ST._utterance_mel(u)[: ST.PARTIAL_FRAMES] for u in utts])
    batch = mels.reshape(4, 3, *mels.shape[1:])
    sides = []
    for d in (dev, torch.device("cpu")):
        m = TreeModule(tree, trainable=True).to(d)
        loss = ST.batch_loss(m.params, torch.tensor(batch, device=d))
        loss.backward()
        sides.append((float(loss.detach()), [p.grad.cpu().double() for p in m.parameters()]))
    (lg, gg), (lc, gc) = sides
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    num = sum(float((a - b).pow(2).sum()) for a, b in zip(gg, gc))
    den = sum(float(b.pow(2).sum()) for b in gc)
    assert (num / den) ** 0.5 <= 1e-3


def test_lstm_embedder_card_vs_cpu(dev):
    wav = ST.synthetic_utterance(np.random.default_rng(3),
                                 ST.synthetic_voice(np.random.default_rng(4)))
    got = ST.lstm_embedder(device=dev)(wav, 22050)
    want = ST.lstm_embedder(device="cpu")(wav, 22050)
    assert got.shape == want.shape == (64,)
    assert float(np.abs(got - want).max()) <= 1e-4


def test_device_timeit_and_stats(dev):
    a = torch.randn(1024, 1024, device=dev) / 32
    fn = lambda c: torch.tanh(c @ a)
    per, t1, t2 = profiling.device_timeit(fn, torch.randn(1024, 1024, device=dev), n1=5, n2=25)
    c = torch.randn(1024, 1024, device=dev)
    for _ in range(3):
        c = fn(c)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(50):
        c = fn(c)
    end.record()
    end.synchronize()
    events = start.elapsed_time(end) / 50 / 1e3
    assert t2 > t1 > 0 and abs(per - events) <= 0.25 * events, (per, events)
    stats = profiling.device_stats()
    assert len(stats) == torch.cuda.device_count() and stats[0]["bytes_in_use"] > 0
