"""VITS2 variant training and the WavLM/SLM loss branch of the PyTorch port
vs the JAX package, on the CPU.

Each of the six variant configurations that tests/test_torch_vits2_variants.py
serves (every flow type; the SDP and ``dp_apply``; the ``hifigan``,
``istft``, ``mb_istft`` and ``ms_istft`` decoders; the torch and onnx
iSTFT), each decoder upsampling to 256 samples a frame, at small widths
(hidden 32, 3 text layers (the speaker joins at the third), one flow, a
2-layer posterior, one SDP flow, one resblock), with one period and one
spectral FFT size in the step's discriminator (tests/test_torch_train.py's).
Trees come from the port's numpy inits in the bundle layout
(zero-initialised projections perturbed); the JAX step's random draws are
reproduced from its key and fed to the port as ``noise=`` (a ``dp_apply``
configuration draws no duration noise). The SLM branch runs a narrow WavLM
(hidden 16, 2 layers, 3 hidden states; ``wavlm_init``'s tree, which has the
JAX reader's structure: tests/test_torch_wavlm.py) and an 8-channel WavLM
discriminator. The JAX references run under ``jax.jit``, the step and
``forward_train`` as one function; JAX's caches are cleared after the
module.

Tolerances (f32 on both sides, sums in other orders): ``forward_train``
outputs 1e-4 x peak (on valid rows where rows are masked), the alignment
and slice starts equal; one step's losses 1e-4 relative, its G, D, durD and
WavLM-discriminator gradients (recorded from the JAX step's own update)
1e-3 x each tensor's largest magnitude, except a tensor whose JAX gradient
is below 1e-6 x its network's largest (0 in exact arithmetic: the attention
key biases), held to that 1e-6 floor. Steps: the ``dp_apply`` variants
(``pre_conv2`` + ``mb_istft``/onnx without SLM; ``mono_layer_inter_residual``
+ ``ms_istft``/onnx with SLM and durD) and ``fft`` + ``hifigan`` (SDP) with
SLM and without durD. A bf16 SLM step gives finite losses.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from torch_shared import shared
from vosk_tts_tpu.models import vits2 as jv
from vosk_tts_tpu.models import wavlm as jw
from vosk_tts_tpu.train import vits2_train as jt
from vosk_tts_tpu_torch.models import vits2 as tv
from vosk_tts_tpu_torch.models import wavlm as tw
from vosk_tts_tpu_torch.train import vits2_train as tt
from vosk_tts_tpu_torch.utils import params as P
from vosk_tts_tpu_torch.utils.checkpoint import _flatten

BASE = dict(n_vocab=20, spec_channels=80, segment_size=8, inter_channels=32, hidden_channels=32,
            filter_channels=64, n_layers=3, upsample_initial_channel=32, n_speakers=4,
            gin_channels=16, n_flows=1, posterior_wn_layers=2, sdp_n_flows=1,
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
UP_64 = dict(upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16))
# tests/test_torch_vits2_variants.py's BUNDLES, each decoder at 256 samples a frame
BUNDLES = {
    "plain": dict(decoder_type="ms_istft"),
    "pre_conv": dict(decoder_type="istft", **UP_64),
    "pre_conv2": dict(decoder_type="mb_istft", istft_mode="onnx", use_sdp=False),
    "fft": dict(decoder_type="hifigan", upsample_rates=(8, 8, 2, 2),
                upsample_kernel_sizes=(16, 16, 4, 4)),
    "mono_layer_inter_residual": dict(decoder_type="ms_istft", istft_mode="onnx", use_sdp=False),
    "mono_layer_post_residual": dict(decoder_type="istft", istft_mode="onnx", **UP_64),
}
# the variants whose whole step is held to JAX's: (use_slm, use_dur_disc)
STEPS = {"pre_conv2": (False, True), "mono_layer_inter_residual": (True, True),
         "fft": (True, False)}
TRAIN = dict(disc_periods=(3,), disc_spec_ffts=(256,))
WAVLM = dict(hidden_size=16, num_hidden_layers=2, num_attention_heads=2, intermediate_size=32,
             conv_dim=(8, 8), conv_kernel=(10, 4), conv_stride=(5, 4), num_conv_pos_embeddings=8,
             num_conv_pos_embedding_groups=2, num_buckets=32, max_bucket_distance=50)
SLM_INITIAL = 8
B, TX, TF, HOP = 2, 12, 40, 256
X_LENGTHS, MEL_LENGTHS = (12, 9), (40, 31)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    _RUNS.clear()
    jax.clear_caches()


def _t(a):
    return torch.tensor(np.asarray(a))


def _rel(got, want, tol, what="", floor=0.0):
    """max |got - want| <= tol x max |want| (+ ``floor``); returns
    max |got - want| / max |want|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale + floor + 1e-12, (what, err, scale)
    return err / max(scale, 1e-30)


def _mask(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]


def _cfg(flow):
    flows = dict(use_transformer_flows=flow != "plain",
                 transformer_flow_type="pre_conv2" if flow == "plain" else flow)
    return {**BASE, **flows, **BUNDLES[flow]}


def _batch():
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((B, TF * HOP)) * 0.3).astype(np.float32)
    for i, n in enumerate(MEL_LENGTHS):
        wav[i, n * HOP:] = 0.0
    mel = rng.standard_normal((B, TF, 80)).astype(np.float32) * _mask(MEL_LENGTHS, TF)
    return {"x": rng.integers(1, 20, size=(B, TX)).astype(np.int32),
            "x_lengths": np.asarray(X_LENGTHS, np.int32), "mel": mel,
            "mel_lengths": np.asarray(MEL_LENGTHS, np.int32), "wav": wav,
            "sid": np.asarray([1, 3], np.int32)}


def _jax_noise(key, cfg):
    """forward_train's draws from ``key``, as the JAX package makes them
    (vits2.py's split: the posterior normal, with the SDP its e_q and
    sample z, the slice uniform)."""
    r_post, _, r_dp, r_slice = jax.random.split(key, 4)
    u = jax.random.uniform(r_slice, (B,))
    ids_max = np.maximum(np.asarray(MEL_LENGTHS) - cfg.segment_size + 1, 1)
    noise = {"posterior": np.asarray(jax.random.normal(r_post, (B, TF, cfg.inter_channels))),
             "ids_slice": np.asarray((u * ids_max.astype(np.float32)).astype(jnp.int32))}
    if cfg.use_sdp:
        r_dp1, r_dp2 = jax.random.split(r_dp)
        r1, _ = jax.random.split(r_dp1)
        noise["e_q"] = np.asarray(jax.random.normal(r1, (B, TX, 2)))
        noise["z"] = np.asarray(jax.random.normal(r_dp2, (B, TX, 2)))
    return noise


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


_RUNS = {}


def _run(flow, tmp_path_factory):
    """The JAX side of a variant, once a module: its trees (bundle layout),
    the batch, the draws, ``forward_train``'s outputs and, for the STEPS
    variants, one step's metrics and the gradients each optimizer was given
    (the step and forward_train compiled as one function). The JAX outputs
    are built once a run and read by every xdist worker
    (tests/torch_shared.py)."""
    if flow in _RUNS:
        return _RUNS[flow]
    cfg = _cfg(flow)
    jcfg, mcfg = jv.VITS2Config(**cfg), tv.VITS2Config(**cfg)
    i = list(BUNDLES).index(flow)
    trees = {"g": P.perturb_zero_init(P.synthesizer_init(mcfg, 10 + i), 20 + i)}
    batch = _batch()
    key = jax.random.PRNGKey(1 + i)
    out = {"cfg": cfg, "trees": trees, "batch": batch, "noise": _jax_noise(key, jcfg)}
    fwd = lambda g, b, k: jv.forward_train(g, jcfg, b["x"], b["x_lengths"], b["mel"],
                                           b["mel_lengths"], b["sid"], rng=k)
    jbatch = lambda: {k: jnp.asarray(v) for k, v in batch.items()}
    if flow not in STEPS:
        out.update(shared(tmp_path_factory, f"variants_train_{flow}", lambda _: {
            "forward": jax.device_get(jax.jit(fwd)(trees["g"], jbatch(), key))})[1])
        _RUNS[flow] = out
        return out

    use_slm, use_dur = STEPS[flow]
    trees["d"] = P.mpmsd_init(1, TRAIN["disc_periods"], TRAIN["disc_spec_ffts"])
    if use_dur:
        trees["dur"] = P.duration_disc_init(2, jcfg.hidden_channels, jcfg.hidden_channels, 3)
    slm = None
    if use_slm:
        wcfg = tw.WavLMConfig(**WAVLM)
        out["wavlm"] = P.wavlm_init(wcfg, seed=30 + i)
        trees["wd"] = P.wavlm_disc_init(4, wcfg.hidden_size, wcfg.num_hidden_layers + 1,
                                        SLM_INITIAL)
        slm = {"params": out["wavlm"], "cfg": jw.WavLMConfig(**WAVLM)}
    tcfg = jt.TrainConfig(**TRAIN, use_dur_disc=use_dur, use_slm=use_slm)

    def build(_):
        make = jt.make_optimizer
        jt.make_optimizer = _recording(make)
        try:
            step, opt = jt.make_train_step(jcfg, tcfg, slm=slm), jt.make_optimizer(tcfg)

            def run(params, batch, key):
                state = {"step": jnp.zeros((), jnp.int32),
                         **{f"params_{k}": v for k, v in params.items()},
                         **{f"opt_{k}": opt.init(v) for k, v in params.items()}}
                new_state, metrics = step(state, batch, key)
                return (metrics, {k: new_state[f"opt_{k}"][1] for k in params},
                        fwd(params["g"], batch, key))

            metrics, grads, forward = jax.jit(run)(trees, jbatch(), key)
        finally:
            jt.make_optimizer = make
        return {"metrics": {k: float(v) for k, v in metrics.items()},
                "grads": jax.device_get(grads), "forward": jax.device_get(forward)}

    out.update(shared(tmp_path_factory, f"variants_train_{flow}", build)[1],
               tcfg=tt.TrainConfig(**TRAIN, use_dur_disc=use_dur, use_slm=use_slm))
    _RUNS[flow] = out
    return out


def _port_batch(batch):
    return {k: _t(v).long() if k in ("x", "sid") else _t(v) for k, v in batch.items()}


def _port_step(run, compute_dtype=None):
    """A fresh port state from the run's trees and its step (with the SLM
    branch where the run has a WavLM)."""
    trees = {k: P.to_port_layout(v) for k, v in run["trees"].items()}
    state = tt.init_train_state(tv.VITS2Config(**run["cfg"]), run["tcfg"], device="cpu",
                                trees=trees)
    slm = (tw.WavLM(tw.WavLMConfig(**WAVLM), P.to_port_layout(run["wavlm"]))
           if "wavlm" in run else None)
    return state, tt.make_train_step(tv.VITS2Config(**run["cfg"]), run["tcfg"],
                                     compute_dtype=compute_dtype, slm=slm)


@pytest.mark.parametrize("flow", list(BUNDLES))
def test_forward_train(flow, tmp_path_factory):
    run = _run(flow, tmp_path_factory)
    want = run["forward"]
    pb = _port_batch(run["batch"])
    with torch.no_grad():
        got = tv.forward_train(P.to_torch(P.to_port_layout(run["trees"]["g"]), "cpu"),
                               tv.VITS2Config(**run["cfg"]), pb["x"], pb["x_lengths"], pb["mel"],
                               pb["mel_lengths"], pb["sid"],
                               noise={k: _t(v) for k, v in run["noise"].items()})
    np.testing.assert_array_equal(got["attn"].numpy(), np.asarray(want["attn"]))
    np.testing.assert_array_equal(got["ids_slice"].numpy(), np.asarray(want["ids_slice"]))
    xm, ym = _mask(X_LENGTHS, TX), _mask(MEL_LENGTHS, TF)
    rows = {"x": xm, "logw": xm, "logw_": xm, "z": ym, "z_p": ym, "m_p": ym, "logs_p": ym,
            "m_q": ym, "logs_q": ym}
    errs = {k: _rel(got[k] * _t(m), np.asarray(want[k]) * m, 1e-4, k) for k, m in rows.items()}
    for k in ("wav", "l_length", "x_mask", "y_mask"):
        errs[k] = _rel(got[k], want[k], 1e-4, k)
    assert (got["wav_mb"] is None) == (want["wav_mb"] is None)
    if want["wav_mb"] is not None:
        errs["wav_mb"] = _rel(got["wav_mb"], want["wav_mb"], 1e-4, "wav_mb")
    assert got["wav"].shape == (B, BASE["segment_size"] * HOP, 1)
    k = max(errs, key=errs.get)
    print(f"{flow}: forward_train worst {errs[k]:.3e} x peak ({k})")


@pytest.mark.parametrize("flow", list(STEPS))
def test_train_step_losses_and_grads(flow, tmp_path_factory):
    run = _run(flow, tmp_path_factory)
    state, step = _port_step(run)
    metrics = step(state, _port_batch(run["batch"]),
                   noise={k: _t(v) for k, v in run["noise"].items()})
    use_slm, _ = STEPS[flow]
    # the JAX step reports loss_lm and loss_lm_gen only inside loss_gen_all
    assert set(metrics) == set(run["metrics"]) | ({"loss_lm", "loss_lm_gen"} if use_slm else set())
    worst = max(_rel(metrics[k], np.float32(want), 1e-4, k) for k, want in run["metrics"].items())
    print(f"{flow}: losses worst relative difference {worst:.3e}")
    if use_slm:
        assert all(np.isfinite(float(metrics[k])) and float(metrics[k]) > 0
                   for k in ("loss_slm_disc", "loss_lm", "loss_lm_gen"))
    assert set(state.params) == set(run["grads"])
    for net in state.params:
        want = _flatten(P.to_port_layout(run["grads"][net]))
        leaves = state.params[net].leaves()
        assert set(leaves) == set(want)
        floor = 1e-6 * max(float(np.abs(w).max()) for w in want.values())
        tiny = sorted(path for path, w in want.items() if float(np.abs(w).max()) < floor)
        errs = {path: _rel(p.grad, want[path], 1e-3, f"{net} {path}")
                for path, p in leaves.items() if path not in tiny}
        for path in tiny:
            _rel(leaves[path].grad, want[path], 1e-3, f"{net} {path}", floor=floor)
        where = max(errs, key=errs.get)
        print(f"{flow} {net}: worst {errs[where]:.3e} of a tensor's max ({where}); {len(tiny)} "
              f"of {len(want)} tensors held to the floor {floor:.3e}")


def test_bf16_slm_step_is_finite(tmp_path_factory):
    """``compute_dtype`` covers the WavLM, its discriminator and the
    resampler: a bf16 SLM step (no JAX counterpart) gives finite losses."""
    run = _run("mono_layer_inter_residual", tmp_path_factory)
    state, step = _port_step(run, compute_dtype=torch.bfloat16)
    metrics = step(state, _port_batch(run["batch"]),
                   noise={k: _t(v) for k, v in run["noise"].items()})
    vals = {k: float(v) for k, v in metrics.items()}
    assert all(np.isfinite(v) for v in vals.values()), vals
    assert {"loss_slm_disc", "loss_lm", "loss_lm_gen"} <= set(vals)
