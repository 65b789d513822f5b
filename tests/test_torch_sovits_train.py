"""GPT-SoVITS stage-2 training (SoVITS with its EMA codebook) of the PyTorch
port vs the JAX package, on the CPU.

A narrow SoVITS (hidden 16, 2 encoder layers, 16 codes of 16-dim SSL
features, a 4 x 4 x 2 HiFiGAN for 32 samples a frame at 3.2 kHz) from the
port's numpy ``sovits_init`` (shapes held to the JAX init's), the flows'
zero ``post`` convs perturbed, and the MultiPeriod discriminator's S and
first two periods (the full one trains in the driver test and on the
card). The JAX references run under ``jax.jit``; their draws (the k-means
initial means' rows, the posterior normal, the slice starts) are made
from the same keys and fed to the port (``ids=``, ``noise=``).

Tolerances (f32 on both sides):

* ``kmeans_run``/``kmeans``/``maybe_kmeans_init``: means 1e-5 of their
  largest magnitude, cluster sizes equal; ``ema_step`` with
  ``threshold_ema_dead_code`` 2.0 and codes below it, and two calls of
  ``train_update``: every buffer 1e-5;
* ``sovits_forward_train``: every output 1e-4 of the JAX value's largest
  magnitude on the valid frames (the packages mask padded rows differently),
  the codes' commit loss 1e-5 relative, the slice starts equal;
* one S2 step: every loss 1e-4 relative; the G and D gradients 1e-3 of
  each tensor's largest magnitude, save the attention key biases, 0 in
  exact arithmetic: below 1e-6 x G's largest gradient on both sides;
  JAX's codebook gradient exactly 0; the EMA buffers after the step 1e-5;
* ``S2Dataset`` batches: SSL features, waveform and text equal, the
  spectrogram 1e-5; the driver on the CPU for 2 steps, STATE_2 restored
  into a zeroed state exactly (parameters, AdamW states, EMA buffers),
  ``SOVITS_2.npz`` loaded back by ``to_port_layout`` equal to the state's
  tree and EMA codebook, a resumed run's step 3.
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

from vosk_tts_tpu.models import gpt_sovits as jg
from vosk_tts_tpu.ops import rvq as jrvq
from vosk_tts_tpu.train import gpt_sovits_data as jdata
from vosk_tts_tpu.train import gpt_sovits_train as jtrain
from vosk_tts_tpu_torch.models import gpt_sovits as tg
from vosk_tts_tpu_torch.ops import rvq as trvq
from vosk_tts_tpu_torch.train import gpt_sovits_data as tdata
from vosk_tts_tpu_torch.train import gpt_sovits_train as ttrain
from vosk_tts_tpu_torch.train import run_gpt_sovits as trun
from vosk_tts_tpu_torch.train.driver_common import resume_state
from vosk_tts_tpu_torch.utils import params as P
from vosk_tts_tpu_torch.utils.checkpoint import _flatten, load_params

SR, HOP, FILT, N_MEL = 3200, 32, 128, 20
SOVITS = dict(spec_channels=FILT // 2 + 1, segment_size=8, inter_channels=16, hidden_channels=16,
              filter_channels=32, n_heads=2, n_layers=2, resblock_kernel_sizes=(3,),
              resblock_dilation_sizes=((1, 3),), upsample_rates=(4, 4, 2),
              upsample_initial_channel=32, upsample_kernel_sizes=(8, 8, 4), gin_channels=16,
              ssl_dim=16, n_codes=16, n_symbols=64, mrte_hidden=16, style_hidden=8)
TRAIN = dict(sampling_rate=SR, filter_length=FILT, hop_length=HOP, win_length=FILT,
             n_mel_channels=N_MEL)
B, TF, TT = 2, 24, 12
SPEC_LENS, TEXT_LENS = (24, 19), (12, 7)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def _t(a):
    return torch.tensor(np.asarray(a))


def _rel(got, want, tol, what="", scale=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(got - want).max())
    assert err <= tol * scale + 1e-30, (what, err, scale)
    return err / max(scale, 1e-30)


def _features(seed, n, d=16, clusters=5):
    """n feature rows around a few centres (k-means has something to find)."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((clusters, d)) * 3
    return (centres[rng.integers(0, clusters, n)] + rng.standard_normal((n, d))).astype(np.float32)


def _sample_ids(key, n, num):
    """The rows JAX's ``sample_vectors`` takes (permutation, else randint)."""
    if n >= num:
        return np.asarray(jax.random.permutation(key, n)[:num])
    return np.asarray(jax.random.randint(key, (num,), 0, n))


# ---------------------------------------------------------------------------
# The codebook's buffers (ops/rvq.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [40, 10])  # permutation (n >= K) and randint draws
def test_kmeans(n):
    x = _features(1, n)
    key = jax.random.PRNGKey(2)
    jmeans, jbins = jax.jit(jrvq.kmeans, static_argnums=(2, 3))(key, jnp.asarray(x), 16, 10)
    ids = _sample_ids(key, n, 16)
    means, bins = trvq.kmeans(_t(x), 16, 10, ids=_t(ids))
    _rel(means, jmeans, 1e-5, "means")
    np.testing.assert_array_equal(bins.numpy(), np.asarray(jbins))
    # kmeans_run from the same initial means
    m0 = x[ids]
    jm, jb = jax.jit(jrvq.kmeans_run, static_argnums=2)(jnp.asarray(m0), jnp.asarray(x), 3)
    m, b = trvq.kmeans_run(_t(m0), _t(x), 3)
    _rel(m, jm, 1e-5, "kmeans_run")
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


def test_maybe_kmeans_init():
    x = _features(3, 60)
    key = jax.random.PRNGKey(4)
    want = jax.jit(lambda s, x, k: jrvq.maybe_kmeans_init(s, x, k, kmeans_iters=50))(
        jrvq.state_init(16, 16), jnp.asarray(x), key)
    got = trvq.maybe_kmeans_init(trvq.state_init(16, 16), _t(x), kmeans_iters=50,
                                 ids=_t(_sample_ids(key, 60, 16)))
    assert float(got["inited"]) == float(want["inited"]) == 1.0
    for k in ("embed", "embed_avg", "cluster_size"):
        _rel(got[k], want[k], 1e-5, k)
    # an inited state comes back as it is
    again = trvq.maybe_kmeans_init(got, _t(_features(5, 60)), kmeans_iters=50)
    assert all(again[k] is got[k] for k in got)


def test_ema_step_with_dead_codes():
    x0, x = _features(6, 60), _features(7, 50)
    key = jax.random.PRNGKey(8)
    state = jax.jit(lambda s, x, k: jrvq.maybe_kmeans_init(s, x, k, kmeans_iters=10))(
        jrvq.state_init(16, 16), jnp.asarray(x0), key)
    assert int(jnp.sum(state["cluster_size"] < 2.0)) > 0  # codes below the dead-code threshold
    want = jax.jit(lambda s, x, k: jrvq.ema_step(s, x, k, threshold_ema_dead_code=2.0))(
        state, jnp.asarray(x), jax.random.PRNGKey(9))
    got = trvq.ema_step({k: _t(v) for k, v in state.items()}, _t(x))
    for k in ("embed", "embed_avg", "cluster_size", "inited"):
        _rel(got[k], want[k], 1e-5, k)


def test_train_update():
    """k-means on the first call, then the EMA step; the second call only the
    EMA step (the JAX function's dead-code draw from its second key reaches
    nothing)."""
    x1, x2 = _features(15, 40), _features(16, 30)
    update = jax.jit(lambda s, x, k: jrvq.train_update(s, x, k, kmeans_iters=10))
    want = jrvq.state_init(16, 16)
    got = trvq.state_init(16, 16)
    for i, x in enumerate((x1, x2)):
        key = jax.random.PRNGKey(17 + i)
        want = update(want, jnp.asarray(x), key)
        ids = _sample_ids(jax.random.split(key)[0], len(x), 16)
        got = trvq.train_update(got, _t(x), kmeans_iters=10, ids=_t(ids))
        for k in ("embed", "embed_avg", "cluster_size", "inited"):
            _rel(got[k], want[k], 1e-5, f"call {i} {k}")


# ---------------------------------------------------------------------------
# sovits_forward_train and one S2 step
# ---------------------------------------------------------------------------


def _batch():
    rng = np.random.default_rng(10)
    spec = np.abs(rng.standard_normal((B, TF, SOVITS["spec_channels"]))).astype(np.float32)
    ssl = _features(11, B * TF).reshape(B, TF, 16)
    text = rng.integers(1, 60, (B, TT)).astype(np.int32)
    wav = (rng.standard_normal((B, TF * HOP)) * 0.3).astype(np.float32)
    for i in range(B):
        spec[i, SPEC_LENS[i]:], ssl[i, SPEC_LENS[i]:], text[i, TEXT_LENS[i]:] = 0, 0, 0
        wav[i, SPEC_LENS[i] * HOP:] = 0
    return {"ssl": ssl, "spec": spec, "spec_lengths": np.array(SPEC_LENS, np.int32),
            "text": text, "text_lengths": np.array(TEXT_LENS, np.int32), "wav": wav}


def _jax_noise(key):
    """The JAX forward's draws: the posterior normal and the slice starts."""
    r_q, r_slice = jax.random.split(key)
    u = jax.random.uniform(r_slice, (B,))
    ids = (u * np.maximum(np.array(SPEC_LENS) - SOVITS["segment_size"] + 1, 1)
           .astype(np.float32)).astype(jnp.int32)
    return {"posterior": _t(jax.random.normal(r_q, (B, TF, SOVITS["inter_channels"]))),
            "ids_slice": _t(ids)}


def step_disc(d):
    """S and the first two periods of the MultiPeriod discriminator (both
    packages zip the periods with the tree's period stacks)."""
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


@pytest.fixture(scope="module")
def setup():
    jcfg, jtcfg = jg.SoVITSConfig(**SOVITS), jtrain.S2TrainConfig(**TRAIN)
    mcfg = tg.SoVITSConfig(**SOVITS)
    trees = {"g": P.perturb_zero_init(P.sovits_init(mcfg, 0), seed=1), "d": P.mpd_init(2)}
    want = jax.eval_shape(lambda k: jg.sovits_init(k, jcfg), jax.random.PRNGKey(0))
    assert jax.tree.structure(trees["g"]) == jax.tree.structure(want)
    assert jax.tree.map(np.shape, trees["g"]) == jax.tree.map(lambda a: a.shape, want)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(12)
    make = jtrain.make_optimizer
    jtrain.make_optimizer = _recording(make)
    try:
        step, opt = jtrain.make_s2_step(jcfg, jtcfg), jtrain.make_optimizer(jtcfg)

        def run(params, batch, key):
            state = {"step": jnp.zeros((), jnp.int32), "params_g": params["g"],
                     "params_d": params["d"], "opt_g": opt.init(params["g"]),
                     "opt_d": opt.init(params["d"]), "vq": jrvq.state_init(16, 16)}
            new_state, metrics = step(state, batch, key)
            return metrics, {"g": new_state["opt_g"][1], "d": new_state["opt_d"][1]}, \
                new_state["vq"]

        metrics, grads, vq = jax.device_get(jax.jit(run)(
            {"g": trees["g"], "d": step_disc(trees["d"])}, jb, key))
    finally:
        jtrain.make_optimizer = make
    # the step's draws: k-means rows from r_init, then the forward's
    rng, r_vq = jax.random.split(key)
    r_init, _ = jax.random.split(r_vq)
    step_noise = {"kmeans_ids": _t(_sample_ids(r_init, B * TF // 2, 16)), **_jax_noise(rng)}
    # the forward on its own, from the step's pre-update codebook
    fkey = jax.random.PRNGKey(13)
    fwd = jax.device_get(jax.jit(lambda g, b, k: jg.sovits_forward_train(
        g, jcfg, b["ssl"], b["spec"], b["spec_lengths"], b["text"], b["text_lengths"], rng=k))(
        trees["g"], jb, fkey))
    jax.clear_caches()
    return {"mcfg": mcfg, "tcfg": ttrain.S2TrainConfig(**TRAIN), "trees": trees, "batch": batch,
            "metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads, "vq": vq,
            "step_noise": step_noise, "forward": fwd, "forward_noise": _jax_noise(fkey)}


def test_sovits_forward_train(setup):
    want = setup["forward"]
    b = {k: _t(v) for k, v in setup["batch"].items()}
    with torch.no_grad():
        got = tg.sovits_forward_train(P.to_torch(P.to_port_layout(setup["trees"]["g"]), "cpu"),
                                      setup["mcfg"], b["ssl"], b["spec"], b["spec_lengths"],
                                      b["text"], b["text_lengths"], noise=setup["forward_noise"])
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["ids_slice"].numpy(), np.asarray(want["ids_slice"]))
    _rel(got["commit_loss"], want["commit_loss"], 1e-5, "commit_loss")
    _rel(got["wav"], want["wav"], 1e-4, "wav")
    np.testing.assert_array_equal(got["y_mask"].numpy(), np.asarray(want["y_mask"]))
    errs = {}
    for k in ("z", "z_p", "m_p", "logs_p", "m_q", "logs_q"):
        for i, n in enumerate(SPEC_LENS):
            errs[k] = max(errs.get(k, 0.0), _rel(got[k][i, :n], want[k][i, :n], 1e-4, k,
                                                 scale=float(np.abs(want[k]).max())))
    k = max(errs, key=errs.get)
    print(f"sovits_forward_train: worst {errs[k]:.3e} x peak ({k})")


def test_s2_step_losses_grads_and_buffers(setup):
    trees = {"g": P.to_port_layout(setup["trees"]["g"]),
             "d": P.to_port_layout(step_disc(setup["trees"]["d"]))}
    assert not np.any(setup["grads"]["g"]["codebook"])  # JAX's codebook: gradient 0
    del trees["g"]["codebook"]
    state = ttrain.init_s2_state(setup["mcfg"], setup["tcfg"], device="cpu", trees=trees)
    assert not state.vq_inited
    pb = {k: _t(v) for k, v in setup["batch"].items()}
    metrics = ttrain.make_s2_step(setup["mcfg"], setup["tcfg"])(state, pb,
                                                                 noise=setup["step_noise"])
    assert set(metrics) == set(setup["metrics"]) and state.step == 1 and state.vq_inited
    worst = max(_rel(metrics[k], np.float32(w), 1e-4, k) for k, w in setup["metrics"].items())
    print(f"S2 losses: worst relative difference {worst:.3e}")
    for net in ("g", "d"):
        want = _flatten(P.to_port_layout(setup["grads"][net]))
        want.pop("codebook", None)
        leaves = state.params[net].leaves()
        assert set(leaves) == set(want)
        # the attention key biases (the style encoder's wk too): gradient 0 in
        # exact arithmetic (a bias added to every key shifts a query's scores
        # alike), float noise on both sides, each below 1e-6 x the network's
        # largest
        largest = max(float(np.abs(w).max()) for w in want.values())
        worst = 0.0
        for path, p in leaves.items():
            if path.endswith(("/k/b", "/wk/b")):
                assert float(np.abs(want[path]).max()) <= 1e-6 * largest, path
                assert float(p.grad.abs().max()) <= 1e-6 * largest, path
                continue
            worst = max(worst, _rel(p.grad, want[path], 1e-3, f"{net} {path}"))
        print(f"{net} gradients: worst {worst:.3e} of a tensor's max")
    for k in ("embed", "embed_avg", "cluster_size", "inited"):
        _rel(state.vq[k], setup["vq"][k], 1e-5, f"vq {k}")


# ---------------------------------------------------------------------------
# Data pipeline and driver
# ---------------------------------------------------------------------------

ALIGNED = ["p_rj_i1_vj_e0_t mj_i1_r", "k_a1_k", "dj_e0_l_a0 s_o1_n", "mj_i1_r k_a1_k s_o1_n"]


def _write_wav(path, n_samples, seed):
    data = (np.random.default_rng(seed).standard_normal(n_samples) * 3000).astype(np.int16)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(SR)
        f.writeframes(data.tobytes())


@pytest.fixture(scope="module")
def s2_corpus(tmp_path_factory):
    """Five wavs at 3.2 kHz (one over 20 s, dropped), each with ``.ssl.npy``
    features (some shorter than the spectrogram, repeated at the tail; one
    longer, cut), and the metadata, written once for each package (each
    caches spectrograms)."""
    root = tmp_path_factory.mktemp("s2_corpus")
    rng = np.random.default_rng(14)
    for side in ("jax", "port"):
        (root / side).mkdir()
    lines = []
    for i in range(5):
        n = SR * 21 if i == 4 else HOP * (40 + 6 * i)
        _write_wav(root / "jax" / f"w{i}.wav", n, seed=20 + i)
        frames = (n - FILT) // HOP + 1 if i != 4 else 10
        np.save(root / "jax" / f"w{i}.ssl.npy",
                rng.standard_normal((frames + (-5, 3, 0, -1, 0)[i], 16)).astype(np.float32))
        for suffix in (".wav", ".ssl.npy"):
            shutil.copy(root / "jax" / f"w{i}{suffix}", root / "port")
        lines.append(f"w{i}.wav|0|text|{ALIGNED[i % len(ALIGNED)]}")
    for side in ("jax", "port"):
        (root / side / "meta.csv").write_text("\n".join(lines) + "\n", encoding="utf-8")
    return root


def _dcfg(cls, root):
    return cls(metadata=str(root / "meta.csv"), wav_dir=str(root), sampling_rate=SR,
               filter_length=FILT, hop_length=HOP, win_length=FILT, ssl_dim=16)


def test_s2_dataset_and_batches(s2_corpus):
    jds = jdata.S2Dataset(_dcfg(jdata.S2DataConfig, s2_corpus / "jax"))
    tds = tdata.S2Dataset(_dcfg(tdata.S2DataConfig, s2_corpus / "port"))
    assert len(tds) == len(jds) == 4 and tds.lengths == jds.lengths
    jb, tb = jdata.ShuffleBatcher(jds, 2), tdata.ShuffleBatcher(tds, 2)
    assert tb.order == jb.order
    for epoch in (0, 1):
        for got, want in zip(tb.epoch(epoch), jb.epoch(epoch), strict=True):
            assert set(got) == set(want)
            for k in ("ssl", "spec_lengths", "text", "text_lengths", "wav"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            _rel(got["spec"], want["spec"], 1e-5, "spec")


def _driver_cfg(root):
    tup = lambda v: [list(x) if isinstance(x, tuple) else x for x in v] \
        if isinstance(v, tuple) else v
    return {"data": {"metadata": str(root / "meta.csv"), "wav_dir": str(root),
                     "sampling_rate": SR, "filter_length": FILT, "hop_length": HOP,
                     "win_length": FILT},
            "model": {k: tup(v) for k, v in SOVITS.items()},
            "train": {"batch_size": 2, "epochs": 100, "log_interval": 1, "save_interval": 100,
                      "n_mel_channels": N_MEL}}


def _fingerprint(state):
    digest = lambda t: hashlib.sha1(t.detach().cpu().numpy().tobytes()).hexdigest()
    out = {"step": state.step, "vq": {k: digest(v) for k, v in state.vq.items()}}
    for k in ("g", "d"):
        out[k] = [digest(p) for p in state.params[k].parameters()]
        out[f"opt_{k}"] = [[digest(v) for v in st.values()] for st in state.opt[k].state.values()]
    return out


def test_s2_driver_and_resume(s2_corpus, tmp_path):
    root = s2_corpus / "port"
    cfg_path = tmp_path / "s2.json"
    cfg_path.write_text(json.dumps(_driver_cfg(root)), encoding="utf-8")
    model_dir = tmp_path / "model"
    args = ["--stage", "s2", "-c", str(cfg_path), "-m", str(model_dir), "--device", "cpu"]
    first, m1 = trun.main(args + ["--max-steps", "2"])
    assert first.step == 2 and set(m1) == {"loss_disc", "loss_gen_all", "loss_gen", "loss_fm",
                                           "loss_mel", "loss_kl", "commit"}
    assert all(np.isfinite(v) for v in m1.values()) and first.vq_inited
    _, mcfg, tcfg = trun.build_s2(_driver_cfg(root))
    assert mcfg == tg.SoVITSConfig(**SOVITS) and tcfg == ttrain.S2TrainConfig(**TRAIN)
    # the bundle-layout tree, its codebook the EMA's: to_port_layout loads it back
    back = _flatten(P.to_port_layout(load_params(model_dir / "SOVITS_2.npz")))
    np.testing.assert_array_equal(back.pop("codebook"), first.vq["embed"].numpy())
    leaves = first.params["g"].leaves()
    assert set(back) == set(leaves)
    for k, p in leaves.items():
        np.testing.assert_array_equal(back[k], p.detach().numpy(), err_msg=k)
    saved = _fingerprint(first)
    for k in ("g", "d"):
        for p in first.params[k].parameters():
            p.data.zero_()
        first.opt[k].state.clear()
    first.vq = ttrain.rvq.state_init(16, 16)
    first.vq_inited, first.step = False, 0
    assert resume_state(str(model_dir), first) is not None
    assert first.vq_inited and _fingerprint(first) == saved
    # no schedule: the learning rate is the configured one
    assert all(g["lr"] == tcfg.learning_rate for o in first.opt.values() for g in o.param_groups)
    resumed, m2 = trun.main(args + ["--max-steps", "3"])
    assert resumed.step == 3 and all(np.isfinite(v) for v in m2.values())
