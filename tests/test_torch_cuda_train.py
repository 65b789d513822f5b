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
* the AdamW moments lie on the card;
* a variant's step (``mono_layer_inter_residual`` + ``ms_istft``/onnx +
  ``dp_apply``) and an SLM step (``fft`` + ``hifigan`` with a small WavLM
  and its discriminator) on the card against the CPU: losses within 1e-3
  relative, only MAS launched;
* a StableTTS micro-step (a cycle of 2, so the second moves the
  parameters) and a QuickVC GAN step at small widths on the card against
  the same steps on the CPU from the same parameters, noise and batch:
  losses within 1e-3 relative, no hand-written kernel launched (both take
  the dense differentiable routes; the QuickVC step runs the speaker
  encoder's cuDNN LSTM backward, which its inference mode cannot);
* a GPT-SoVITS S1 step (ScaledAdam, and a DPO step) and an S2 step (its
  codebook k-means-initialised, then the EMA step) at small widths on the
  card against the same steps on the CPU: losses within 1e-3 relative,
  the S2 EMA buffers within 1e-5 relative, no hand-written kernel launched
  (the AR's attention is dense; SoVITS trains on the dense route);
* ``run_gpt_sovits`` trains on the card by default and on the CPU with
  ``--device cpu`` (without CUDA it raises: tests/test_torch_gpt_sovits_
  train.py);
* ``run_vits2 --distributed`` as one NCCL rank (torchrun's environment for
  a world of 1): two steps on ``cuda:0``, then a resumed step from its
  ``STATE_2``, the group left after each run.
"""

import json
import socket
import wave

import numpy as np
import pytest
import torch

from vosk_tts_tpu_torch.models import gpt_sovits, quickvc, stabletts, vits2, wavlm
from vosk_tts_tpu_torch.ops import ddsconv_fused as ddf
from vosk_tts_tpu_torch.ops import flash_attention as fa
from vosk_tts_tpu_torch.ops import mas
from vosk_tts_tpu_torch.train import gpt_sovits_train as gt
from vosk_tts_tpu_torch.train import run_gpt_sovits, run_vits2
from vosk_tts_tpu_torch.train import stabletts_train as st
from vosk_tts_tpu_torch.train import vc_train as vt
from vosk_tts_tpu_torch.train import vits2_train as tt
from vosk_tts_tpu_torch.utils.params import (ar_init, matcha_init, mpd_init,
                                             perturb_matcha_zero_init, perturb_zero_init,
                                             quickvc_init, sovits_init, synthesizer_init,
                                             to_port_layout, wavlm_init)

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


ALL_KERNELS = (fa.KERNEL, ddf.KERNEL, fa.GLOBAL_ROPE_KERNEL, fa.GLOBAL_PACKED_KERNEL,
               fa.GLOBAL_KERNEL, mas.KERNEL)

WAVLM = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
             conv_dim=(16, 16), conv_kernel=(10, 4), conv_stride=(5, 4), num_conv_pos_embeddings=16,
             num_conv_pos_embedding_groups=4, num_buckets=32, max_bucket_distance=50)


@pytest.mark.parametrize("over,use_slm", [
    (dict(transformer_flow_type="mono_layer_inter_residual", decoder_type="ms_istft",
          istft_mode="onnx", use_sdp=False), False),
    (dict(transformer_flow_type="fft", decoder_type="hifigan", upsample_rates=(8, 8, 2, 2),
          upsample_kernel_sizes=(16, 16, 4, 4)), True)],
    ids=["mono_ms_istft_dp", "fft_hifigan_slm"])
def test_variant_step_on_card(dev, over, use_slm):
    """A variant's step (windowless flow attention, the deterministic
    duration predictor, the onnx iSTFT; or the FFT flow and HiFiGAN with the
    WavLM/SLM branch) on the card against the CPU from the same trees,
    noise and alignment (the card's): losses within 1e-3 relative; only MAS
    launched (kernel 5 serves these flows, training takes the dense route)."""
    mcfg = vits2.VITS2Config(**{**CFG, **over})
    tcfg = tt.TrainConfig(**TRAIN, use_slm=use_slm)
    trees = tt.init_trees(mcfg, tcfg, seed=0, slm_hidden=32, slm_layers=3, slm_initial=16)
    trees["g"] = to_port_layout(perturb_zero_init(synthesizer_init(mcfg, 0), seed=1))
    wl_cfg = wavlm.WavLMConfig(**WAVLM)
    wl_tree = to_port_layout(wavlm_init(wl_cfg, 2))
    batch, noise = _batch(dev)
    if not mcfg.use_sdp:
        noise = {k: v for k, v in noise.items() if k not in ("e_q", "z")}
    runs, attn = {}, None
    for d in (dev, torch.device("cpu")):
        state = tt.init_train_state(mcfg, tcfg, device=d, trees=trees)
        b = {k: v.to(d) for k, v in batch.items()}
        n = {k: v.to(d) for k, v in noise.items()}
        if attn is None:
            with torch.no_grad():
                attn = vits2.forward_train(state.params["g"].params, mcfg, b["x"], b["x_lengths"],
                                           b["mel"], b["mel_lengths"], b["sid"], noise=n)["attn"]
        else:
            n["attn"] = attn.to(d)
        slm = wavlm.WavLM(wl_cfg, wl_tree).to(d) if use_slm else None
        before = [k.launches for k in ALL_KERNELS]
        out = tt.make_train_step(mcfg, tcfg, slm=slm)(state, b, noise=n)
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert [k.launches - m for k, m in zip(ALL_KERNELS, before)] == [0] * 5 + [1]
        runs[d.type] = {k: float(v) for k, v in out.items()}
    got, want = runs["cuda"], runs["cpu"]
    assert use_slm == ("loss_slm_disc" in got)
    for k, w in want.items():
        assert np.isfinite(got[k]) and abs(got[k] - w) <= 1e-3 * abs(w) + 1e-12, (k, got[k], w)


def _card_and_cpu(dev, make_state, step_fn, batch, noise, n_steps=1):
    """The same steps on the card and on the CPU; returns each side's last
    metrics as floats and the card's kernel launches during its steps."""
    runs, launches = {}, None
    for device in (dev, torch.device("cpu")):
        state = make_state(device)
        before = [k.launches for k in ALL_KERNELS]
        for i in range(n_steps):
            out = step_fn(state, {k: v.to(device) for k, v in batch.items()},
                          noise={k: v.to(device) for k, v in noise[i].items()})
        if device.type == "cuda":
            torch.cuda.synchronize()
            launches = [k.launches - n for k, n in zip(ALL_KERNELS, before)]
        runs[device.type] = {k: float(v) for k, v in out.items()}
    return runs["cuda"], runs["cpu"], launches


def test_stabletts_micro_steps_on_card(dev):
    cfg = stabletts.StableTTSConfig(n_spks=3, spk_emb_dim=16, hidden_channels=64,
                                    filter_channels=128, n_layers=2, phone_emb_dim=32,
                                    punc_emb_dim=4, bert_dim=32, bert_proj_dim=16, dec_hidden=64,
                                    dec_filter=128, dec_layers=2)
    tcfg = st.StableTrainConfig(accumulate=2, learning_rate=1e-3)
    tree = stabletts.port_layout(perturb_matcha_zero_init(matcha_init(cfg, 0), seed=1))
    rng = np.random.default_rng(2)
    b, tx, tf = 2, 24, 96
    x_len, mel_len = np.array([24, 17]), np.array([96, 70])
    xm = np.arange(tx)[None] < x_len[:, None]
    batch = {"x": torch.tensor(rng.integers(1, 200, (b, 5, tx)) * xm[:, None]),
             "x_lengths": torch.tensor(x_len), "mel": torch.tensor(
                 rng.standard_normal((b, tf, 80)).astype(np.float32)),
             "mel_lengths": torch.tensor(mel_len), "sid": torch.tensor([0, 2]),
             "bert": torch.tensor(rng.standard_normal((b, tx, 32)).astype(np.float32)),
             "durations": torch.tensor(rng.integers(1, 5, (b, tx)) * xm)}
    noise = [{"cfg": torch.tensor([[0.5], [0.05]]),  # the second row takes the CFG fakes
              "t": torch.tensor(rng.uniform(size=(b, 1, 1)).astype(np.float32)),
              "z": torch.tensor(rng.standard_normal((b, tf, 80)).astype(np.float32))}
             for _ in range(2)]
    got, want, launches = _card_and_cpu(
        dev, lambda d: st.init_train_state(cfg, tcfg, device=d, tree=tree),
        st.make_train_step(cfg, tcfg), batch, noise, n_steps=2)
    assert launches == [0] * len(ALL_KERNELS), launches
    for k, w in want.items():
        assert np.isfinite(got[k]) and abs(got[k] - w) <= 1e-3 * abs(w), (k, got[k], w)


def test_vc_step_on_card(dev):
    """The speaker encoder's LSTM runs in training mode on the card: cuDNN's
    backward of its inference mode raises."""
    cfg = quickvc.QuickVCConfig(segment_size=16, inter_channels=64, hidden_channels=64,
                                gin_channels=64, upsample_initial_channel=128)
    tcfg = vt.VCTrainConfig()
    trees = {"g": to_port_layout(perturb_zero_init(quickvc_init(cfg, 0), seed=1)),
             "d": to_port_layout(mpd_init(2))}
    rng = np.random.default_rng(3)
    b, t = 2, 48
    batch = {"c": torch.tensor(rng.standard_normal((b, t, 768)).astype(np.float32)),
             "spec": torch.tensor(np.abs(rng.standard_normal((b, t, 641))).astype(np.float32)),
             "mel": torch.tensor(rng.standard_normal((b, t, 80)).astype(np.float32) - 4),
             "wav": torch.tensor((rng.standard_normal((b, t * 320)) * 0.3).astype(np.float32))}
    noise = [{"posterior_p": torch.tensor(rng.standard_normal((b, t, 64)).astype(np.float32)),
              "posterior_q": torch.tensor(rng.standard_normal((b, t, 64)).astype(np.float32)),
              "ids_slice": torch.tensor([5, 30], dtype=torch.int32)}]
    got, want, launches = _card_and_cpu(
        dev, lambda d: vt.init_train_state(cfg, tcfg, device=d, trees=trees),
        vt.make_train_step(cfg, tcfg), batch, noise)
    assert launches == [0] * len(ALL_KERNELS), launches
    for k, w in want.items():
        assert np.isfinite(got[k]) and abs(got[k] - w) <= 1e-3 * abs(w), (k, got[k], w)


AR = dict(embedding_dim=64, hidden_dim=64, num_head=4, num_layers=2, vocab_size=33,
          phoneme_vocab_size=64, bert_dim=16, eos=32)


@pytest.mark.parametrize("if_dpo", [False, True])
def test_s1_step_on_card(dev, if_dpo):
    cfg, tcfg = gpt_sovits.ARConfig(**AR), gt.S1TrainConfig(if_dpo=if_dpo)
    tree = to_port_layout(ar_init(cfg, 0))
    rng = np.random.default_rng(4)
    b, tx, ty = 2, 24, 64
    x_len, y_len = np.array([24, 15]), np.array([64, 41])
    y = rng.integers(0, 32, (b, ty))
    y[1, 41:] = 32
    batch = {"x": torch.tensor(rng.integers(1, 60, (b, tx)) * (np.arange(tx) < x_len[:, None])),
             "x_lengths": torch.tensor(x_len), "y": torch.tensor(y),
             "y_lengths": torch.tensor(y_len),
             "bert": torch.tensor(rng.standard_normal((b, tx, 16)).astype(np.float32))}
    noise = [{"reject_ids": torch.tensor([[3, 40], [50, 9]])}] * 2
    got, want, launches = _card_and_cpu(
        dev, lambda d: gt.init_s1_state(cfg, tcfg, device=d, tree=tree), gt.make_s1_step(cfg, tcfg),
        batch, noise, n_steps=2)
    assert launches == [0] * len(ALL_KERNELS), launches
    for k, w in want.items():
        assert np.isfinite(got[k]) and abs(got[k] - w) <= 1e-3 * abs(w), (k, got[k], w)


def test_s2_step_on_card(dev):
    cfg = gpt_sovits.SoVITSConfig(spec_channels=257, segment_size=16, inter_channels=64,
                                  hidden_channels=64, filter_channels=128, n_layers=2,
                                  upsample_rates=(8, 4, 4), upsample_initial_channel=128,
                                  upsample_kernel_sizes=(16, 8, 8), gin_channels=64,
                                  n_codes=64, mrte_hidden=64, style_hidden=32)
    tcfg = gt.S2TrainConfig(sampling_rate=16000, filter_length=512, hop_length=128,
                            win_length=512, n_mel_channels=80)
    trees = gt.init_s2_trees(cfg, 0)
    trees["g"] = to_port_layout(perturb_zero_init(sovits_init(cfg, 0), seed=1))
    del trees["g"]["codebook"]
    rng = np.random.default_rng(5)
    b, tf, tt = 2, 64, 20
    lens = np.array([64, 47])
    m = (np.arange(tf) < lens[:, None])[..., None]
    batch = {"ssl": torch.tensor((rng.standard_normal((b, tf, 768)) * m).astype(np.float32)),
             "spec": torch.tensor((np.abs(rng.standard_normal((b, tf, 257))) * m)
                                  .astype(np.float32)),
             "spec_lengths": torch.tensor(lens), "text": torch.tensor(rng.integers(1, 60, (b, tt))),
             "text_lengths": torch.tensor([20, 11]),
             "wav": torch.tensor((rng.standard_normal((b, tf * 128)) * 0.3).astype(np.float32))}
    noise = [{"kmeans_ids": torch.tensor(rng.permutation(b * tf // 2)[:64]),
              "posterior": torch.tensor(rng.standard_normal((b, tf, 64)).astype(np.float32)),
              "ids_slice": torch.tensor([40, 7], dtype=torch.int32)}]
    states = {}

    def make_state(d):
        states[d.type] = gt.init_s2_state(cfg, tcfg, device=d, trees=trees)
        return states[d.type]

    got, want, launches = _card_and_cpu(dev, make_state, gt.make_s2_step(cfg, tcfg), batch, noise)
    assert launches == [0] * len(ALL_KERNELS), launches
    for k, w in want.items():
        assert np.isfinite(got[k]) and abs(got[k] - w) <= 1e-3 * abs(w), (k, got[k], w)
    for k, w in states["cpu"].vq.items():
        g = states["cuda"].vq[k].cpu()
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max()), k


def test_run_gpt_sovits_defaults_to_the_card(dev, tmp_path):
    lines, sem = [], []
    rng = np.random.default_rng(6)
    for i in range(4):
        lines.append(f"u{i}.wav|0|text|mj_i1_r k_a1_k s_o1_n")
        sem.append(f"u{i}\t" + " ".join(str(c) for c in rng.integers(0, 32, 40 + 5 * i)))
    (tmp_path / "meta.csv").write_text("\n".join(lines) + "\n", encoding="utf-8")
    (tmp_path / "semantic.tsv").write_text("\n".join(sem) + "\n", encoding="utf-8")
    cfg = {"data": {"metadata": str(tmp_path / "meta.csv"),
                    "semantic": str(tmp_path / "semantic.tsv")},
           "model": AR, "train": {"batch_size": 2, "log_interval": 1}}
    (tmp_path / "c.json").write_text(json.dumps(cfg), encoding="utf-8")
    args = ["--stage", "s1", "-c", str(tmp_path / "c.json"), "--max-steps", "1"]
    state, _ = run_gpt_sovits.main(args + ["-m", str(tmp_path / "card")])
    assert state.params["ar"].device.type == "cuda"
    state, _ = run_gpt_sovits.main(args + ["-m", str(tmp_path / "cpu"), "--device", "cpu"])
    assert state.params["ar"].device.type == "cpu"


def test_run_vits2_distributed_one_nccl_rank(dev, tmp_path, monkeypatch):
    lines = []
    for i, aligned in enumerate(["m_a1 vj_i1_r", "d_o1_m u1"]):
        data = (np.random.default_rng(20 + i).standard_normal(64 * 48) * 3000).astype(np.int16)
        with wave.open(str(tmp_path / f"t{i}.wav"), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(22050)
            f.writeframes(data.tobytes())
        lines.append(f"{tmp_path}/t{i}.wav|{i}|{aligned}|{aligned}")
    (tmp_path / "meta.csv").write_text("\n".join(lines) + "\n", encoding="utf-8")
    cfg = {"train": {"batch_size": 2, "epochs": 10, "log_interval": 1, "eval_interval": 100,
                     "segment_size": 2048, "fft_sizes": [64, 128, 32], "hop_sizes": [8, 16, 4],
                     "win_lengths": [32, 64, 16]},
           "data": {"training_files": f"{tmp_path}/meta.csv", "sampling_rate": 22050,
                    "filter_length": 256, "hop_length": 64, "win_length": 256,
                    "n_mel_channels": 40, "aligned_text": True, "n_speakers": 4,
                    "use_mel_posterior_encoder": True},
           "model": {"use_mel_posterior_encoder": True, "mb_istft_vits": True,
                     "use_transformer_flows": True, "transformer_flow_type": "pre_conv2",
                     "use_spk_conditioned_encoder": True, "inter_channels": 16,
                     "hidden_channels": 16, "filter_channels": 32, "n_heads": 2, "n_layers": 1,
                     "n_flows": 1, "posterior_wn_layers": 2, "sdp_n_flows": 1,
                     "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
                     "upsample_rates": [4], "upsample_kernel_sizes": [8],
                     "upsample_initial_channel": 32, "n_speakers": 4, "gin_channels": 8,
                     "use_duration_discriminator": True}}
    (tmp_path / "c.json").write_text(json.dumps(cfg), encoding="utf-8")
    with socket.socket() as s:  # a free port on this host for rank 0's store
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(k, v)
    args = ["-c", str(tmp_path / "c.json"), "-m", str(tmp_path / "model"), "--distributed"]
    mas.KERNEL.launches = 0
    state, metrics = run_vits2.main(args + ["--max-steps", "2"])
    assert state.step == 2 and all(np.isfinite(v) for v in metrics.values())
    assert state.params["g"].device == torch.device("cuda", 0)
    assert not torch.distributed.is_initialized()
    state, metrics = run_vits2.main(args + ["--max-steps", "3"])
    assert state.step == 3 and all(np.isfinite(v) for v in metrics.values())
    assert mas.KERNEL.launches == 3
    assert not torch.distributed.is_initialized()
