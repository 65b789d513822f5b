"""QuickVC GAN training of the PyTorch port vs the JAX package, on the CPU.

A small QuickVC (the geometry of tests/test_train_drivers.py's VC driver:
16 channels, 8-dim content features, 20 mels, hop 32 from one 2x
upsampling, 4 ms-iSTFT subbands) with the full-width MultiPeriod
discriminator (S and periods 2/3/5/7/11; the step tests keep S and
periods 2 and 3, see ``step_disc``). The trees have the structure and
shapes of the JAX ``vc_train.init_train_state`` trees (checked against its
``jax.eval_shape``), drawn by the port's numpy inits with the zero coupling
projections perturbed (as initialised the flow is the identity). The JAX
draws of ``forward_train`` (both posterior normals and the slice uniform)
are reproduced from the same key and fed to the port as ``noise=``. The
JAX references (the step, with the gradients each optimizer was given
recorded; ``forward_train``; ``mpd_apply``) run under ``jax.jit``.

Tolerances (f32 on both sides): ``mpd_apply``'s logits and feature maps,
``forward_train``'s outputs and the step's losses 1e-4 of the JAX value's
largest magnitude (the slice start equal); the G and D gradients 1e-3 of
each tensor's largest magnitude. ``VCDataset``/``ShuffleBatcher`` batches on
the same files and seed: equal windows (content features, waveform), the
spectrogram and mel within 1e-5; the driver on the CPU for 2 steps, its
``STATE_2`` restored into the state zeroed (parameters and AdamW state
exactly as saved; a resumed run is the StableTTS driver test's, on the
same ``train_loop``).
"""

import hashlib
import json
import shutil
import wave

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from torch_shared import shared
from vosk_tts_tpu.models import discriminators as jd
from vosk_tts_tpu.models import quickvc as jq
from vosk_tts_tpu.train import gpt_sovits_data as jgd
from vosk_tts_tpu.train import vc_data as jdata
from vosk_tts_tpu.train import vc_train as jtrain
from vosk_tts_tpu_torch.models import discriminators as td
from vosk_tts_tpu_torch.models import quickvc as tq
from vosk_tts_tpu_torch.train import run_vc as trun
from vosk_tts_tpu_torch.train import vc_data as tdata
from vosk_tts_tpu_torch.train import vc_train as ttrain
from vosk_tts_tpu_torch.train.driver_common import resume_state
from vosk_tts_tpu_torch.train.gpt_sovits_data import ShuffleBatcher
from vosk_tts_tpu_torch.utils import params as P
from vosk_tts_tpu_torch.utils.checkpoint import _flatten

SR, HOP, FILT, N_MEL = 3200, 32, 128, 20
MODEL = dict(segment_size=8, inter_channels=16, hidden_channels=16, ssl_dim=8, gin_channels=16,
             resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),), upsample_rates=(2,),
             upsample_initial_channel=32, upsample_kernel_sizes=(4,))
CFG = dict(spec_channels=FILT // 2 + 1, n_mel_channels=N_MEL, **MODEL)
TRAIN = dict(sampling_rate=SR, filter_length=FILT, hop_length=HOP, win_length=FILT,
             n_mel_channels=N_MEL)
B, T = 2, 24


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def _t(a):
    return torch.tensor(np.asarray(a))


def _rel(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale + 1e-12, (what, err, scale)
    return err / max(scale, 1e-30)


def _batch():
    rng = np.random.default_rng(0)
    return {"c": rng.standard_normal((B, T, 8)).astype(np.float32),
            "spec": np.abs(rng.standard_normal((B, T, CFG["spec_channels"]))).astype(np.float32),
            "mel": rng.standard_normal((B, T, N_MEL)).astype(np.float32) - 3,
            "wav": (rng.standard_normal((B, T * HOP)) * 0.3).astype(np.float32)}


def _jax_noise(key):
    r_p, r_q, r_slice = jax.random.split(key, 3)
    u = jax.random.uniform(r_slice, (B,))
    ids = (u * np.float32(max(T - MODEL["segment_size"] + 1, 1))).astype(jnp.int32)
    return {"posterior_p": np.asarray(jax.random.normal(r_p, (B, T, 16))),
            "posterior_q": np.asarray(jax.random.normal(r_q, (B, T, 16))),
            "ids_slice": np.asarray(ids)}


def step_disc(d):
    """The discriminator of the step tests: S and the first two periods (both
    packages' mpd_apply zip the periods with the tree's period stacks). The
    five-period tree (47M parameters) is held to JAX in test_mpd_apply and
    trains on the card; here it would double the file's memory and time."""
    return {"s": d["s"], "p": d["p"][:2]}


def _recording(make):
    """make_optimizer whose state also keeps the last gradients it was given."""
    def wrapped(tcfg):
        inner = make(tcfg)

        def init(params):
            return inner.init(params), jax.tree.map(jnp.zeros_like, params)

        def update(grads, state, params=None):
            updates, inner_state = inner.update(grads, state[0], params)
            return updates, (inner_state, grads)
        return optax.GradientTransformation(init, update)
    return wrapped


# ---------------------------------------------------------------------------
# Data pipeline and driver
# ---------------------------------------------------------------------------


def _write_wav(path, n_samples, seed):
    data = (np.random.default_rng(seed).standard_normal(n_samples) * 3000).astype(np.int16)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(SR)
        f.writeframes(data.tobytes())


@pytest.fixture(scope="module")
def vc_corpus(tmp_path_factory):
    """Four utterances at 3.2 kHz with ``.cv.npy`` sidecars, and a file list,
    written twice: one copy for each package (each caches spectrograms)."""
    root = tmp_path_factory.mktemp("vc_corpus")
    rng = np.random.default_rng(2)
    for side in ("jax", "port"):
        (root / side).mkdir()
    for i in range(4):
        _write_wav(root / "jax" / f"w{i}.wav", HOP * (40 + 4 * i), seed=10 + i)
        np.save(root / "jax" / f"w{i}.cv.npy", rng.standard_normal((44 + 3 * i, 8)).astype(np.float32))
        shutil.copy(root / "jax" / f"w{i}.wav", root / "port")
        shutil.copy(root / "jax" / f"w{i}.cv.npy", root / "port")
    for side in ("jax", "port"):
        (root / side / "train.txt").write_text(
            "\n".join(str(root / side / f"w{i}.wav") for i in (2, 0, 3, 1)) + "\n", encoding="utf-8")
    return root


def _data_cfg(cls, root):
    return cls(file_list=str(root / "train.txt"), sampling_rate=SR, filter_length=FILT,
               hop_length=HOP, win_length=FILT, n_mel_channels=N_MEL, max_speclen=24)


def test_dataset_and_batches(vc_corpus):
    jds = jdata.VCDataset(_data_cfg(jdata.VCDataConfig, vc_corpus / "jax"))
    tds = tdata.VCDataset(_data_cfg(tdata.VCDataConfig, vc_corpus / "port"))
    assert jds.lengths == tds.lengths
    jb, tb = jgd.ShuffleBatcher(jds, 2), ShuffleBatcher(tds, 2)
    assert tb.order == jb.order and tb.num_batches() == jb.num_batches()
    for epoch in (0, 1):
        for got, want in zip(tb.epoch(epoch), jb.epoch(epoch), strict=True):
            assert set(got) == set(want) - {"sid"}  # the JAX batch's zero sid is read by no step
            for k in ("c", "wav"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            for k in ("spec", "mel"):
                _rel(got[k], want[k], 1e-5, k)


def _fingerprint(state):
    """Exact digests of a TrainState's parameters and AdamW state."""
    digest = lambda t: hashlib.sha1(t.detach().cpu().numpy().tobytes()).hexdigest()
    out = {"step": state.step}
    for k in ("g", "d"):
        out[k] = [digest(p) for p in state.params[k].parameters()]
        out[f"opt_{k}"] = [[digest(v) for v in st.values()] for st in state.opt[k].state.values()]
    return out


def _driver_cfg(root):
    return {"data": {"training_files": str(root / "train.txt"), "sampling_rate": SR,
                     "filter_length": FILT, "hop_length": HOP, "win_length": FILT,
                     "n_mel_channels": N_MEL, "max_speclen": 24},
            "model": {k: list(v) if isinstance(v, tuple) else v for k, v in MODEL.items()},
            "train": {"batch_size": 2, "epochs": 100, "log_interval": 1, "eval_interval": 100}}


def test_driver_and_resume(vc_corpus, tmp_path):
    cfg_path = tmp_path / "vc.json"
    cfg_path.write_text(json.dumps(_driver_cfg(vc_corpus / "port")), encoding="utf-8")
    model_dir = tmp_path / "model"
    args = ["-c", str(cfg_path), "-m", str(model_dir), "--device", "cpu"]
    first, m1 = trun.main(args + ["--max-steps", "2"])
    assert first.step == 2 and set(m1) == {"loss_disc", "loss_gen_all", "loss_gen", "loss_fm",
                                           "loss_mel", "loss_kl"}
    assert all(np.isfinite(v) for v in m1.values())
    _, mcfg, tcfg = trun.build_configs(_driver_cfg(vc_corpus / "port"))
    assert mcfg.as_vits2() == tq.QuickVCConfig(**CFG).as_vits2()
    assert tcfg == ttrain.VCTrainConfig(**TRAIN)
    # the saved state's exact fingerprint, then every parameter zeroed and the
    # AdamW state dropped, then STATE_2 restored into the same state
    saved = _fingerprint(first)
    for k in ("g", "d"):
        for p in first.params[k].parameters():
            p.data.zero_()
        first.opt[k].state.clear()
    first.step = 0
    assert resume_state(str(model_dir), first) is not None
    assert first.step == 2 and _fingerprint(first) == saved
    # no schedule: the learning rate is the configured one
    assert all(g["lr"] == tcfg.learning_rate for o in first.opt.values() for g in o.param_groups)


def test_driver_needs_cuda_without_device(vc_corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg_path = tmp_path / "vc.json"
    cfg_path.write_text(json.dumps(_driver_cfg(vc_corpus / "port")), encoding="utf-8")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trun.main(["-c", str(cfg_path), "-m", str(tmp_path / "m")])


# ---------------------------------------------------------------------------
# The step against the JAX package (after the driver, whose full-width
# discriminator state is freed before the JAX compiles)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX VC step, forward_train and mpd_apply (their outputs built
    once a run and read by every xdist worker: tests/torch_shared.py)."""
    jcfg, jtcfg = jq.QuickVCConfig(**CFG), jtrain.VCTrainConfig(**TRAIN)
    mcfg = tq.QuickVCConfig(**CFG)
    trees = {"g": P.perturb_zero_init(P.quickvc_init(mcfg, 0), seed=3), "d": P.mpd_init(1)}
    want = jax.eval_shape(lambda k: jtrain.init_train_state(k, jcfg, jtcfg), jax.random.PRNGKey(0))
    for k, t in trees.items():
        assert jax.tree.structure(t) == jax.tree.structure(want[f"params_{k}"]), k
        assert jax.tree.map(np.shape, t) == jax.tree.map(lambda a: a.shape, want[f"params_{k}"]), k
    batch = _batch()
    rng = np.random.default_rng(5)
    y, y_hat = (rng.standard_normal((B, 700)).astype(np.float32) * 0.3 for _ in range(2))
    key = jax.random.PRNGKey(1)

    def build(_):
        make = jtrain.make_optimizer
        jtrain.make_optimizer = _recording(make)
        try:
            step, opt = jtrain.make_train_step(jcfg, jtcfg), jtrain.make_optimizer(jtcfg)

            def run(params, batch, key):
                state = {"step": jnp.zeros((), jnp.int32),
                         **{f"params_{k}": v for k, v in params.items()},
                         **{f"opt_{k}": opt.init(v) for k, v in params.items()}}
                new_state, metrics = step(state, batch, key)
                return metrics, {k: new_state[f"opt_{k}"][1] for k in params}

            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            metrics, grads = jax.device_get(jax.jit(run)(
                {"g": trees["g"], "d": step_disc(trees["d"])}, jb, key))
        finally:
            jtrain.make_optimizer = make
        fwd = jax.device_get(jax.jit(lambda g, b, k: jq.forward_train(g, jcfg, b["c"], b["spec"],
                                                                        b["mel"], rng=k))(
            trees["g"], jb, key))
        mpd = jax.device_get(jax.jit(jd.mpd_apply)(trees["d"], y, y_hat))
        jax.clear_caches()
        return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
                "forward": fwd, "mpd": mpd}

    ref = shared(tmp_path_factory, "vc_train_setup", build)[1]
    return {"mcfg": mcfg, "tcfg": ttrain.VCTrainConfig(**TRAIN), "trees": trees, "batch": batch,
            "noise": _jax_noise(key), "metrics": ref["metrics"], "grads": ref["grads"],
            "forward": ref["forward"], "mpd": (y, y_hat, ref["mpd"])}


def test_mpd_apply(setup):
    y, y_hat, want = setup["mpd"]
    got = td.mpd_apply(P.to_torch(P.to_port_layout(setup["trees"]["d"]), "cpu"), _t(y), _t(y_hat))
    layout = lambda f: f.permute(0, 2, 3, 1) if f.dim() == 4 else f.transpose(1, 2)
    assert [len(g) for g in got] == [len(w) for w in want] == [6, 6, 6, 6]
    for k in (0, 1):
        for g, w in zip(got[k], want[k]):
            _rel(g, w, 1e-4, f"logits {k}")
    for k in (2, 3):
        for gs, ws in zip(got[k], want[k]):
            for g, w in zip(gs, ws):
                _rel(layout(g), w, 1e-4, f"fmap {k}")


def test_forward_train(setup):
    want = setup["forward"]
    with torch.no_grad():
        got = tq.forward_train(P.to_torch(P.to_port_layout(setup["trees"]["g"]), "cpu"),
                               setup["mcfg"], *(_t(setup["batch"][k]) for k in ("c", "spec", "mel")),
                               noise={k: _t(v) for k, v in setup["noise"].items()})
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["ids_slice"].numpy(), np.asarray(want["ids_slice"]))
    errs = {k: _rel(got[k], want[k], 1e-4, k) for k in want if k != "ids_slice"}
    k = max(errs, key=errs.get)
    print(f"forward_train: worst {errs[k]:.3e} x peak ({k})")


def test_train_step_losses_and_grads(setup):
    trees = {"g": setup["trees"]["g"], "d": step_disc(setup["trees"]["d"])}
    state = ttrain.init_train_state(setup["mcfg"], setup["tcfg"], device="cpu",
                                    trees={k: P.to_port_layout(v) for k, v in trees.items()})
    pb = {k: _t(v) for k, v in setup["batch"].items()}
    metrics = ttrain.make_train_step(setup["mcfg"], setup["tcfg"])(
        state, pb, noise={k: _t(v) for k, v in setup["noise"].items()})
    assert set(metrics) == set(setup["metrics"]) and state.step == 1
    worst = max(_rel(metrics[k], np.float32(w), 1e-4, k) for k, w in setup["metrics"].items())
    print(f"losses: worst relative difference {worst:.3e}")
    for net in ("g", "d"):
        want = _flatten(P.to_port_layout(setup["grads"][net]))
        leaves = state.params[net].leaves()
        assert set(leaves) == set(want)
        worst = max(_rel(p.grad, want[path], 1e-3, f"{net} {path}") for path, p in leaves.items())
        print(f"{net} gradients: worst {worst:.3e} of a tensor's max")
