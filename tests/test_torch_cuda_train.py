"""VITS2 training of the port on the card.

Marked ``cuda``: each test skips where there is no NVIDIA GPU. This file
imports no JAX, so on a machine with the card and without JAX it runs as
``python -m pytest tests/test_torch_cuda_train.py -m cuda --noconftest``.

* the MAS kernel (csrc/mas.cu) equals its plain version exactly, at ragged
  lengths, an empty row, T_x above a block's 256 threads and above 1024;
* one train step at a small width on the card: finite losses, the banded
  attention and DDSConv kernels launched 0 times (training takes their
  differentiable routes) and MAS once; the same step on the CPU from the
  same parameters, noise and alignment (the card's) within 1e-3 relative
  in every loss (f32 on both sides, TF32 off, other summation orders);
* the AdamW moments lie on the card.
"""

import numpy as np
import pytest
import torch

from vosk_tts_tpu_torch.models import vits2
from vosk_tts_tpu_torch.ops import ddsconv_fused as ddf
from vosk_tts_tpu_torch.ops import flash_attention as fa
from vosk_tts_tpu_torch.ops import mas
from vosk_tts_tpu_torch.train import vits2_train as tt
from vosk_tts_tpu_torch.utils.params import perturb_zero_init, synthesizer_init, to_port_layout

pytestmark = pytest.mark.cuda

CFG = dict(n_vocab=40, spec_channels=80, segment_size=16, inter_channels=64, hidden_channels=64,
           filter_channels=128, n_layers=2, upsample_initial_channel=128, n_speakers=4,
           gin_channels=32, n_flows=2, posterior_wn_layers=4)
TRAIN = dict(disc_periods=(2, 3), disc_spec_ffts=(512, 1024))


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@pytest.mark.parametrize("b,ty,tx,t_ys,t_xs", [
    (3, 37, 15, [37, 30, 0], [15, 12, 7]),
    (24, 512, 160, None, None),
    (2, 64, 300, [64, 50], [300, 211]),
    (1, 1200, 1100, [1200], [1100]),
])
def test_mas_kernel_equals_plain(dev, b, ty, tx, t_ys, t_xs):
    g = torch.Generator(device=dev).manual_seed(ty + tx)
    neg_cent = torch.randn(b, ty, tx, generator=g, device=dev) * 3
    if t_ys is None:  # a training batch: t_x <= t_y, ragged
        t_ys = [ty - 9 * i for i in range(b)]
        t_xs = [tx - 3 * i for i in range(b)]
    ly = torch.tensor(t_ys, dtype=torch.int32, device=dev)
    lx = torch.tensor(t_xs, dtype=torch.int32, device=dev)
    n = mas.KERNEL.launches
    got = mas.mas_path(neg_cent, ly, lx)
    torch.cuda.synchronize()
    assert mas.KERNEL.launches == n + 1
    want = mas.maximum_path_plain(neg_cent, ly, lx)
    assert torch.equal(got, want)
    assert int(got.sum()) == sum(y for y, x in zip(t_ys, t_xs) if x > 0)


def _batch(dev):
    rng = np.random.default_rng(0)
    b, tx, tf, hop = 2, 24, 64, 256
    x_len, mel_len = [24, 17], [64, 50]
    wav = (rng.standard_normal((b, tf * hop)) * 0.3).astype(np.float32)
    mel = rng.standard_normal((b, tf, 80)).astype(np.float32)
    for i in range(b):
        wav[i, mel_len[i] * hop:] = 0
        mel[i, mel_len[i]:] = 0
    batch = {"x": torch.tensor(rng.integers(1, 40, (b, tx))), "x_lengths": torch.tensor(x_len),
             "mel": torch.tensor(mel), "mel_lengths": torch.tensor(mel_len),
             "wav": torch.tensor(wav), "sid": torch.tensor([1, 3])}
    noise = {"posterior": torch.tensor(rng.standard_normal((b, tf, 64)).astype(np.float32)),
             "e_q": torch.tensor(rng.standard_normal((b, tx, 2)).astype(np.float32)),
             "z": torch.tensor(rng.standard_normal((b, tx, 2)).astype(np.float32)),
             "ids_slice": torch.tensor([20, 11], dtype=torch.int32)}
    return batch, noise


def test_train_step_on_card(dev):
    mcfg, tcfg = vits2.VITS2Config(**CFG), tt.TrainConfig(**TRAIN)
    trees = tt.init_trees(mcfg, tcfg, seed=0)
    trees["g"] = to_port_layout(perturb_zero_init(synthesizer_init(mcfg, 0), seed=1))
    batch, noise = _batch(dev)
    on = lambda d: ({k: v.to(d) for k, v in batch.items()}, {k: v.to(d) for k, v in noise.items()})

    cb, cn = on(dev)
    state = tt.init_train_state(mcfg, tcfg, device=dev, trees=trees)
    with torch.no_grad():  # the card's alignment, for the CPU run
        attn = vits2.forward_train(state.params["g"].params, mcfg, cb["x"], cb["x_lengths"],
                                   cb["mel"], cb["mel_lengths"], cb["sid"], noise=cn)["attn"]
    kernels = (fa.KERNEL, ddf.KERNEL, mas.KERNEL)
    before = [k.launches for k in kernels]
    got = tt.make_train_step(mcfg, tcfg)(state, cb, noise=cn)
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(kernels, before)] == [0, 0, 1]
    got = {k: float(v) for k, v in got.items()}
    assert all(np.isfinite(v) for v in got.values()), got
    for opt in state.opt.values():
        for s in opt.state.values():
            assert s["exp_avg"].is_cuda and s["exp_avg_sq"].is_cuda

    cpu_state = tt.init_train_state(mcfg, tcfg, device="cpu", trees=trees)
    cpu_noise = {**noise, "attn": attn.cpu()}
    want = {k: float(v) for k, v in tt.make_train_step(mcfg, tcfg)(cpu_state, batch,
                                                                     noise=cpu_noise).items()}
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-3 * abs(w), (k, got[k], w)
