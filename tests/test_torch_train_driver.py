"""The port's VITS2 training driver on the CPU (tests/test_train_drivers.py's
VITS2 cases, ported), on a tiny synthetic corpus: two 64 x 48-sample wavs
with aligned phone texts, the shipped flags (``pre_conv2`` flows, SDP,
``mb_istft``, the duration discriminator) at tiny widths.

* the mel loss falls below 0.7 x its first value within 25 steps on one
  fixed batch;
* ``--finetune`` keeps the duration discriminator's parameters exactly
  frozen while G and D move;
* a second run resumes from the newest STATE: step, params and optimizer
  state as saved, then trains on;
* ``from_port_layout(to_port_layout(t)) == t`` for JAX ``synthesizer_init``,
  ``mpmsd_init`` and ``duration_disc_init`` trees, and the port's numpy
  ``mpmsd_init``/``duration_disc_init`` have the JAX inits' structure and
  shapes;
* the port's ``G_*.npz`` is read by the JAX package's ``load_params`` and
  equals the trained generator in the JAX layout;
* ``--wavlm-dir`` (a tiny WavLM written by the port) trains the SLM
  branch, saves and resumes the WavLM discriminator with its optimizer,
  and finetunes from a pretrained state that has none;
* a step given only one of the WavLM and the WavLM discriminator raises,
  and a saved state may lack only the WavLM discriminator.
"""

import dataclasses
import json
import shutil
import wave

import numpy as np
import pytest

import jax
import torch

from vosk_tts_tpu.models import discriminators as jd
from vosk_tts_tpu.models import vits2 as jv
from vosk_tts_tpu.utils import checkpoint as jckpt
from vosk_tts_tpu_torch.models import vits2 as tv
from vosk_tts_tpu_torch.models.wavlm import WavLMConfig
from vosk_tts_tpu_torch.ops import pqmf as tpqmf
from vosk_tts_tpu_torch.ops import stft as tstft
from vosk_tts_tpu_torch.train import losses as tl
from vosk_tts_tpu_torch.train import run_vits2
from vosk_tts_tpu_torch.train import vits2_train as tt
from vosk_tts_tpu_torch.train.data import BucketBatcher, TTSDataset
from vosk_tts_tpu_torch.train.driver_common import to_device
from vosk_tts_tpu_torch.utils import checkpoint as ckpt
from vosk_tts_tpu_torch.utils import params as P

ALIGNED = ["m_a1 vj_i1_r", "d_o1_m u1"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("vits2_torch")
    lines = []
    for i, aligned in enumerate(ALIGNED):
        data = (np.random.default_rng(20 + i).standard_normal(64 * 48) * 3000).astype(np.int16)
        with wave.open(str(root / f"t{i}.wav"), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(22050)
            f.writeframes(data.tobytes())
        lines.append(f"{root}/t{i}.wav|{i}|{aligned}|{aligned}")
    (root / "meta.csv").write_text("\n".join(lines) + "\n", encoding="utf-8")
    return root


def cfg_dict(root):
    return {
        "train": {"batch_size": 2, "epochs": 1, "log_interval": 1, "eval_interval": 1,
                  "segment_size": 2048, "fft_sizes": [64, 128, 32],
                  "hop_sizes": [8, 16, 4], "win_lengths": [32, 64, 16]},
        "data": {"training_files": f"{root}/meta.csv", "sampling_rate": 22050,
                 "filter_length": 256, "hop_length": 64, "win_length": 256,
                 "n_mel_channels": 40, "aligned_text": True, "n_speakers": 4,
                 "use_mel_posterior_encoder": True},
        "model": {"use_mel_posterior_encoder": True, "mb_istft_vits": True,
                  "use_transformer_flows": True, "transformer_flow_type": "pre_conv2",
                  "use_spk_conditioned_encoder": True,
                  "inter_channels": 16, "hidden_channels": 16, "filter_channels": 32,
                  "n_heads": 2, "n_layers": 1, "n_flows": 1, "posterior_wn_layers": 2,
                  "sdp_n_flows": 1, "resblock_kernel_sizes": [3],
                  "resblock_dilation_sizes": [[1, 3]], "upsample_rates": [4],
                  "upsample_kernel_sizes": [8], "upsample_initial_channel": 32,
                  "n_speakers": 4, "gin_channels": 8, "use_duration_discriminator": True},
    }


def _write_cfg(tmp_path, corpus):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg_dict(corpus)), encoding="utf-8")
    return str(path)


def _leaves(state, net):
    return {k: v.detach().clone() for k, v in state.params[net].state_dict().items()}


def test_gan_loss_decreases(corpus):
    mcfg, tcfg, dcfg = run_vits2.build_configs(cfg_dict(corpus))
    # one period and one FFT size: the full discriminator makes 25 steps slow here
    tcfg = dataclasses.replace(tcfg, disc_periods=(2,), disc_spec_ffts=(256,))
    batch = to_device(next(iter(BucketBatcher(TTSDataset(dcfg), 2).epoch(0))), "cpu")
    state = tt.init_train_state(mcfg, tcfg, seed=0, device="cpu")
    step = tt.make_train_step(mcfg, tcfg)
    gen = torch.Generator().manual_seed(0)
    mel = [float(step(state, batch, generator=gen)["loss_mel"]) for _ in range(25)]
    assert all(np.isfinite(mel))
    assert min(mel[-5:]) < mel[0] * 0.7, mel[:3] + mel[-3:]


def test_step_after_inference_mode_serving(corpus):
    """Serving under torch.inference_mode makes the cached iSTFT, PQMF and
    STFT constants first; a train step after it can still save them for
    backward."""
    mcfg, tcfg, dcfg = run_vits2.build_configs(cfg_dict(corpus))
    tcfg = dataclasses.replace(tcfg, disc_periods=(2,), disc_spec_ffts=(256,))
    batch = to_device(next(iter(BucketBatcher(TTSDataset(dcfg), 2).epoch(0))), "cpu")
    state = tt.init_train_state(mcfg, tcfg, seed=0, device="cpu")
    with torch.inference_mode():
        tv.generator_apply(state.params["g"].params["dec"], mcfg,
                           torch.zeros(2, mcfg.segment_size, mcfg.inter_channels),
                           torch.zeros(2, 1, mcfg.gin_channels))
        tpqmf.pqmf_analysis(batch["wav"][..., None])
        tl.subband_stft_loss(torch.zeros(2, 512, 4), torch.zeros(2, 512, 4), tcfg.fft_sizes,
                             tcfg.hop_sizes, tcfg.win_lengths)
        tstft.mel_spectrogram(batch["wav"], tcfg.filter_length, tcfg.n_mel_channels,
                              tcfg.sampling_rate, tcfg.hop_length, tcfg.win_length, 0.0, None)
    metrics = tt.make_train_step(mcfg, tcfg)(state, batch, generator=torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_finetune_freezes_duration_disc(corpus, tmp_path):
    cfg = _write_cfg(tmp_path, corpus)
    pre, _ = run_vits2.main(["-c", cfg, "-m", str(tmp_path / "pre"), "--device", "cpu"])
    ft, metrics = run_vits2.main(["-c", cfg, "-m", str(tmp_path / "ft"), "--device", "cpu",
                                  "--finetune", str(tmp_path / "pre")])
    assert metrics and all(np.isfinite(v) for v in metrics.values()), metrics
    before, after = _leaves(pre, "dur"), _leaves(ft, "dur")
    for k in before:
        torch.testing.assert_close(after[k], before[k], rtol=0, atol=0)
    assert ft.opt["dur"].state_dict()["state"][0]["step"] > 0  # its optimizer still advanced
    for net in ("g", "d"):
        a, b = _leaves(pre, net), _leaves(ft, net)
        assert max(float((a[k] - b[k]).abs().max()) for k in a) > 0, net


def test_resume_restores_state(corpus, tmp_path):
    cfg = _write_cfg(tmp_path, corpus)
    model_dir = str(tmp_path / "m")
    first, _ = run_vits2.main(["-c", cfg, "-m", model_dir, "--device", "cpu", "--max-steps", "1"])
    saved = ckpt.load_full_state(model_dir, "STATE")
    assert saved["step"] == first.step == 1

    mcfg, tcfg, _ = run_vits2.build_configs(cfg_dict(corpus))
    state = tt.init_train_state(mcfg, tcfg, seed=99, device="cpu")
    assert run_vits2.resume_state(model_dir, state) == saved["epoch"]
    assert state.step == 1
    for net in state.params:
        for k, v in saved[f"params_{net}"].items():
            torch.testing.assert_close(state.params[net].state_dict()[k], v, rtol=0, atol=0)
        opt = state.opt[net].state_dict()
        for i, s in saved[f"opt_{net}"]["state"].items():
            for name in ("step", "exp_avg", "exp_avg_sq"):
                torch.testing.assert_close(opt["state"][i][name], s[name], rtol=0, atol=0)

    again, _ = run_vits2.main(["-c", cfg, "-m", model_dir, "--device", "cpu", "--max-steps", "2"])
    assert again.step == 2
    assert ckpt.latest_checkpoint(model_dir, "STATE_", ".pt").endswith("STATE_2.pt")


def test_generator_export_loads_in_jax(corpus, tmp_path):
    cfg = _write_cfg(tmp_path, corpus)
    state, _ = run_vits2.main(["-c", cfg, "-m", str(tmp_path / "m"), "--device", "cpu",
                               "--max-steps", "1"])
    got = jckpt.load_params(str(tmp_path / "m" / "G_1.npz"))
    want = P.from_port_layout(state.params["g"].numpy_tree(), P.LINEARS)
    flat_got, flat_want = jax.tree.leaves_with_path(got), jax.tree.leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (_, a), (_, b) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(a, b)
    # and it has the JAX init's structure and shapes
    mcfg, _, _ = run_vits2.build_configs(cfg_dict(corpus))
    jcfg = jv.VITS2Config(**{f: getattr(mcfg, f) for f in mcfg.__dataclass_fields__})
    shapes = jax.eval_shape(lambda k: jv.synthesizer_init(k, jcfg), jax.random.PRNGKey(0))
    assert jax.tree.structure(shapes) == jax.tree.structure(got)
    assert [s.shape for s in jax.tree.leaves(shapes)] == [a.shape for a in jax.tree.leaves(got)]


def _assert_same_tree(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_from_port_layout_inverts_to_port_layout():
    cfg = jv.VITS2Config(inter_channels=32, hidden_channels=32, filter_channels=64, n_layers=2,
                         upsample_initial_channel=64, n_speakers=4, gin_channels=16)
    rng = np.random.default_rng(0)
    inits = [lambda k: jv.synthesizer_init(k, cfg),
             lambda k: jd.mpmsd_init(k, periods=(2, 3), spec_ffts=(256,)),
             lambda k: jd.duration_disc_init(k, 32, 32, 3, variant=2)]
    # the JAX inits' trees (structure and shapes), random values: an eager
    # init draws op by op and takes tens of seconds here
    trees = [jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                          jax.eval_shape(init, jax.random.PRNGKey(0))) for init in inits]
    for tree in trees:
        _assert_same_tree(P.from_port_layout(P.to_port_layout(tree), P.LINEARS), tree)
    # the port's numpy inits have the JAX inits' structure and shapes
    for mine, theirs in ((P.mpmsd_init(0, (2, 3), (256,)), trees[1]),
                         (P.duration_disc_init(0, 32, 32, 3), trees[2])):
        assert jax.tree.structure(mine) == jax.tree.structure(theirs)
        assert ([a.shape for a in jax.tree.leaves(mine)]
                == [a.shape for a in jax.tree.leaves(theirs)])


def _write_wavlm(path):
    """A tiny WavLM directory: ``config.json`` in the Hugging Face form and
    ``params.npz`` (``wavlm_init``'s tree, the bundle layout)."""
    cfg = WavLMConfig(hidden_size=8, num_hidden_layers=1, num_attention_heads=2,
                      intermediate_size=16, conv_dim=(8, 8), conv_kernel=(10, 4),
                      conv_stride=(5, 4), num_conv_pos_embeddings=8,
                      num_conv_pos_embedding_groups=2, num_buckets=16, max_bucket_distance=32)
    path.mkdir()
    (path / "config.json").write_text(json.dumps(cfg.to_hf()), encoding="utf-8")
    ckpt.save_params(str(path / "params.npz"), P.wavlm_init(cfg, seed=3))
    return str(path)


def test_wavlm_dir_trains(corpus, tmp_path):
    """``--wavlm-dir`` trains the SLM branch: finite ``loss_slm_disc``,
    ``loss_lm`` and ``loss_lm_gen``; STATE_* carries the WavLM
    discriminator (2 states, 8 channels in) and its AdamW state, and a resume
    restores them; ``--finetune`` from a pretrained STATE without one starts
    it fresh and copies G and D."""
    cfg = _write_cfg(tmp_path, corpus)
    wdir = _write_wavlm(tmp_path / "wavlm")
    model_dir = str(tmp_path / "m")
    state, metrics = run_vits2.main(["-c", cfg, "-m", model_dir, "--device", "cpu",
                                     "--wavlm-dir", wdir, "--max-steps", "1"])
    for k in ("loss_slm_disc", "loss_lm", "loss_lm_gen"):
        assert np.isfinite(metrics[k]) and metrics[k] > 0, metrics
    saved = ckpt.load_full_state(model_dir, "STATE")
    assert "params_wd" in saved and saved["opt_wd"]["state"]
    assert state.params["wd"].params["pre"]["w"].shape == (64, 2 * 8)

    mcfg, tcfg, _ = run_vits2.build_configs(cfg_dict(corpus))
    tcfg = dataclasses.replace(tcfg, use_slm=True)
    fresh = tt.init_train_state(mcfg, tcfg, seed=99, device="cpu", slm_hidden=8, slm_layers=2)
    assert run_vits2.resume_state(model_dir, fresh) == saved["epoch"]
    for k, v in saved["params_wd"].items():
        torch.testing.assert_close(fresh.params["wd"].state_dict()[k], v, rtol=0, atol=0)
    for i, s in saved["opt_wd"]["state"].items():
        torch.testing.assert_close(fresh.opt["wd"].state_dict()["state"][i]["exp_avg"],
                                   s["exp_avg"], rtol=0, atol=0)
    again, _ = run_vits2.main(["-c", cfg, "-m", model_dir, "--device", "cpu", "--wavlm-dir", wdir,
                               "--max-steps", "2"])
    assert again.step == 2

    # finetune with the SLM loss from a pretrained run without it
    pre, _ = run_vits2.main(["-c", cfg, "-m", str(tmp_path / "pre"), "--device", "cpu",
                             "--max-steps", "1"])
    assert "params_wd" not in ckpt.load_full_state(str(tmp_path / "pre"), "STATE")
    ft, m = run_vits2.main(["-c", cfg, "-m", str(tmp_path / "ft"), "--device", "cpu",
                            "--wavlm-dir", wdir, "--finetune", str(tmp_path / "pre"),
                            "--max-steps", "1"])
    assert np.isfinite(m["loss_slm_disc"]) and ft.step == 1
    before, after = _leaves(pre, "dur"), _leaves(ft, "dur")
    for k in before:  # copied from the pretrained state, then kept frozen
        torch.testing.assert_close(after[k], before[k], rtol=0, atol=0)
    shutil.rmtree(tmp_path)  # ~0.5 GB a STATE (the full-size discriminators)


def test_slm_switches_must_agree(corpus, tmp_path):
    """A step raises ValueError where only one of the WavLM (``slm=``) and
    the WavLM discriminator (``TrainConfig.use_slm``) is given, instead of
    skipping the SLM loss; ``load_state_dict`` leaves only a missing WavLM
    discriminator at its init and raises KeyError for any other missing
    network."""
    mcfg, tcfg, dcfg = run_vits2.build_configs(cfg_dict(corpus))
    tcfg = dataclasses.replace(tcfg, disc_periods=(2,), disc_spec_ffts=(256,))
    slm_tcfg = dataclasses.replace(tcfg, use_slm=True)
    batch = to_device(next(iter(BucketBatcher(TTSDataset(dcfg), 2).epoch(0))), "cpu")
    slm = run_vits2.load_wavlm(_write_wavlm(tmp_path / "wavlm"), "cpu")
    dims = dict(slm_hidden=8, slm_layers=2)
    plain = tt.init_train_state(mcfg, tcfg, seed=0, device="cpu")
    with_wd = tt.init_train_state(mcfg, slm_tcfg, seed=0, device="cpu", **dims)
    for state, step in ((plain, tt.make_train_step(mcfg, tcfg, slm=slm)),
                        (with_wd, tt.make_train_step(mcfg, slm_tcfg))):
        with pytest.raises(ValueError, match="SLM branch"):
            step(state, batch, generator=torch.Generator().manual_seed(0))

    fresh = tt.init_train_state(mcfg, slm_tcfg, seed=1, device="cpu", **dims)
    fresh.load_state_dict(plain.state_dict())  # the WavLM discriminator keeps its init
    for k, v in _leaves(plain, "dur").items():
        torch.testing.assert_close(fresh.params["dur"].state_dict()[k], v, rtol=0, atol=0)
    saved = {k: v for k, v in with_wd.state_dict().items() if not k.endswith("_dur")}
    with pytest.raises(KeyError, match="params_dur"):
        fresh.load_state_dict(saved)


def test_driver_needs_cuda_without_device(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_vits2.main(["-c", _write_cfg(tmp_path, corpus), "-m", str(tmp_path / "m")])
