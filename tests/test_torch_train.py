"""VITS2 GAN training of the PyTorch port vs the JAX package, on the CPU.

A small configuration shaped like tests/test_train.py::small_cfg (the
shipped flags: ``pre_conv2`` flows, SDP, ``mb_istft``, the duration
discriminator on; a 4-layer posterior, one coupling flow and one SDP flow,
which keep the JAX step's compile short) with one period and one spectral
FFT size in the step's multi-period discriminator (three and two where the
discriminators are checked alone). The parameter trees have the structure
and shapes of the JAX package's ``init_train_state`` trees (checked against
its ``jax.eval_shape``) and are drawn by the port's numpy inits
(zero-initialised flow and ConvFlow projections perturbed, or those flows
are the identity), carried to the port's layout; the batch comes from a seeded numpy generator with ragged lengths, and the
JAX step's random draws (the split at vits2.py:897: the posterior normal,
the SDP's e_q and sample z, the slice uniform) are reproduced from the same
key and fed to the port as ``noise=``. The JAX references run under
``jax.jit``; the step and forward_train are one compiled function.

Tolerances (f32 on both sides, sums in other orders): maximum_path exactly
equal; the spline, sdp_forward_nll, the discriminators' outputs and feature
maps and every loss 1e-4 relative (to the JAX value's largest magnitude);
forward_train outputs at valid rows 1e-4 x peak; one train step's losses
1e-4 relative and its G, D and durD gradients (taken before the optimizer,
recorded from the JAX step's own update) 1e-3 x each tensor's largest
magnitude, except a tensor whose JAX gradient is below 1e-6 x its
network's largest (0 in exact arithmetic: the attention key biases), held
to that 1e-6 floor; AdamW against optax ``adamw`` over three steps with a learning
rate change 1e-6 relative. A bf16 step (no JAX counterpart) gives finite
losses within 10% of the f32 step's.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from vosk_tts_tpu.models import discriminators as jd
from vosk_tts_tpu.models import vits2 as jv
from vosk_tts_tpu.ops import mas as jmas
from vosk_tts_tpu.ops import pqmf as jpqmf
from vosk_tts_tpu.ops import stft as jstft
from vosk_tts_tpu.ops import transforms as jtr
from vosk_tts_tpu.train import losses as jl
from vosk_tts_tpu.train import vits2_train as jt
from vosk_tts_tpu_torch.models import discriminators as td
from vosk_tts_tpu_torch.models import vits2 as tv
from vosk_tts_tpu_torch.models.tree import TreeModule
from vosk_tts_tpu_torch.ops import mas as tmas
from vosk_tts_tpu_torch.ops import pqmf as tpqmf
from vosk_tts_tpu_torch.ops import stft as tstft
from vosk_tts_tpu_torch.ops import transforms as ttr
from vosk_tts_tpu_torch.train import losses as tl
from vosk_tts_tpu_torch.train import vits2_train as tt
from vosk_tts_tpu_torch.utils.checkpoint import _flatten
from vosk_tts_tpu_torch.utils import params as P
from vosk_tts_tpu_torch.utils.params import perturb_zero_init, to_port_layout, to_torch

CFG = dict(n_vocab=20, spec_channels=80, segment_size=8, inter_channels=32, hidden_channels=32,
           filter_channels=64, n_layers=3, upsample_initial_channel=64, n_speakers=4,
           gin_channels=16, n_flows=1, posterior_wn_layers=4, sdp_n_flows=1)
TRAIN = dict(disc_periods=(3,), disc_spec_ffts=(256,))
DISC = dict(periods=(2, 3, 5), spec_ffts=(256, 512))
B, TX, TF, HOP = 2, 12, 40, 256
X_LENGTHS, MEL_LENGTHS = (12, 9), (40, 31)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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
    """forward_train's draws from ``key``, as the JAX package makes them."""
    r_post, _, r_dp, r_slice = jax.random.split(key, 4)
    r_dp1, r_dp2 = jax.random.split(r_dp)
    r1, _ = jax.random.split(r_dp1)
    u = jax.random.uniform(r_slice, (B,))
    ids_max = np.maximum(np.asarray(MEL_LENGTHS) - cfg.segment_size + 1, 1)
    return {"posterior": np.asarray(jax.random.normal(r_post, (B, TF, cfg.inter_channels))),
            "e_q": np.asarray(jax.random.normal(r1, (B, TX, 2))),
            "z": np.asarray(jax.random.normal(r_dp2, (B, TX, 2))),
            "ids_slice": np.asarray((u * ids_max.astype(np.float32)).astype(jnp.int32))}


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


def _trees(jcfg, tcfg):
    """Bundle-layout (JAX-layout) trees of G, D and durD with the structure
    and shapes of ``init_train_state``'s, drawn by the numpy inits (the
    JAX inits compile an executable for each op and shape: ~25 s here)."""
    want = jax.eval_shape(lambda key: jt.init_train_state(key, jcfg, tcfg), jax.random.PRNGKey(0))
    trees = {"g": perturb_zero_init(P.synthesizer_init(jcfg, 0), seed=3),
             "d": P.mpmsd_init(1, tuple(tcfg.disc_periods), tuple(tcfg.disc_spec_ffts)),
             "dur": P.duration_disc_init(2, jcfg.hidden_channels, jcfg.hidden_channels, 3)}
    for k, t in trees.items():
        assert (jax.tree.structure(t) == jax.tree.structure(want[f"params_{k}"])
                and jax.tree.map(np.shape, t) == jax.tree.map(lambda a: a.shape,
                                                              want[f"params_{k}"])), k
    return trees


@pytest.fixture(scope="module")
def setup():
    """The JAX step and forward_train from the same key, compiled as one
    function with the state's construction inside: the metrics, the
    gradients each optimizer was given, and forward_train's outputs."""
    jcfg, tcfg_j = jv.VITS2Config(**CFG), jt.TrainConfig(**TRAIN)
    trees = _trees(jcfg, tcfg_j)
    batch = _batch()
    key = jax.random.PRNGKey(1)
    make = jt.make_optimizer
    jt.make_optimizer = _recording(make)
    try:
        step, opt = jt.make_train_step(jcfg, tcfg_j), jt.make_optimizer(tcfg_j)

        def run(params, batch, key):
            state = {"step": jnp.zeros((), jnp.int32),
                     **{f"params_{k}": v for k, v in params.items()},
                     **{f"opt_{k}": opt.init(v) for k, v in params.items()}}
            new_state, metrics = step(state, batch, key)
            fwd = jv.forward_train(params["g"], jcfg, batch["x"], batch["x_lengths"], batch["mel"],
                                   batch["mel_lengths"], batch["sid"], rng=key)
            return metrics, {k: new_state[f"opt_{k}"][1] for k in params}, fwd

        metrics, grads, fwd = jax.jit(run)(trees, {k: jnp.asarray(v) for k, v in batch.items()},
                                           key)
    finally:
        jt.make_optimizer = make
    return {"jcfg": jcfg, "tcfg": tt.TrainConfig(**TRAIN), "trees": trees, "batch": batch,
            "noise": _jax_noise(key, jcfg), "key": key,
            "metrics": {k: float(v) for k, v in metrics.items()}, "grads": jax.device_get(grads),
            "forward": jax.device_get(fwd)}


def _port_state(setup):
    trees = {k: to_port_layout(v) for k, v in setup["trees"].items()}
    return tt.init_train_state(tv.VITS2Config(**CFG), setup["tcfg"], device="cpu", trees=trees)


def _port_batch(batch):
    return {k: _t(v).long() if k in ("x", "sid") else _t(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------


def test_maximum_path_equals_jax():
    rng = np.random.default_rng(4)
    b, ty, tx = 3, 37, 15
    neg_cent = (rng.standard_normal((b, ty, tx)) * 3).astype(np.float32)
    mask = _mask([37, 30, 21], ty)[..., 0][:, :, None] * _mask([15, 12, 7], tx)[..., 0][:, None, :]
    want = np.asarray(jax.jit(jmas.maximum_path)(neg_cent, mask))
    got = tmas.maximum_path(_t(neg_cent), _t(mask)).numpy()
    assert want.sum() > 0
    np.testing.assert_array_equal(got, want)


def test_spline_forward_with_logabsdet():
    rng = np.random.default_rng(5)
    shape = (2, 17, 1)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)  # some inputs in the tails
    uw, uh = (rng.standard_normal(shape + (10,)).astype(np.float32) for _ in range(2))
    ud = rng.standard_normal(shape + (9,)).astype(np.float32)
    want = jtr.piecewise_rational_quadratic_transform(x, uw, uh, ud, inverse=False,
                                                      tails="linear", tail_bound=5.0)
    got = ttr.piecewise_rational_quadratic_transform(_t(x), _t(uw), _t(uh), _t(ud),
                                                     inverse=False, tail_bound=5.0)
    _rel(got[0], want[0], 1e-4, "outputs")
    _rel(got[1], want[1], 1e-4, "logabsdet")


@pytest.mark.parametrize("n_fft,hop,win", [(683, 60, 300), (171, 10, 60), (512, 128, 512)])
def test_stft_center_pad(n_fft, hop, win):
    y = np.random.default_rng(6).standard_normal((2, 2048)).astype(np.float32)
    want = jstft.stft(jnp.asarray(y), n_fft, hop, win, pad=n_fft // 2)
    got = tstft.stft(_t(y), n_fft, hop, win, pad=n_fft // 2)
    for g, w in zip(got, want):
        _rel(g, w, 1e-4, n_fft)


def test_pqmf_analysis():
    y = np.random.default_rng(7).standard_normal((2, 2048, 1)).astype(np.float32)
    _rel(tpqmf.pqmf_analysis(_t(y)), jpqmf.pqmf_analysis(jnp.asarray(y)), 1e-4)


def test_sdp_forward_nll(setup):
    jcfg = setup["jcfg"]
    dp = setup["trees"]["g"]["dp"]
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, TX, 32)).astype(np.float32)
    mask = _mask(X_LENGTHS, TX)
    w = (rng.integers(1, 6, (B, TX, 1)) * mask).astype(np.float32)
    g = rng.standard_normal((B, 1, 16)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = jax.jit(jv.sdp_forward_nll, static_argnums=1)(dp, jcfg, x, mask, w, g, rng=key)
    e_q = np.asarray(jax.random.normal(jax.random.split(key)[0], (B, TX, 2)))
    got = tv.sdp_forward_nll(to_torch(to_port_layout(dp), "cpu"), tv.VITS2Config(**CFG), _t(x),
                             _t(mask), _t(w), _t(g), noise=_t(e_q))
    print(f"sdp_forward_nll: {_rel(got, want, 1e-4):.3e} relative")


# ---------------------------------------------------------------------------
# Discriminators and losses
# ---------------------------------------------------------------------------


def _fmap_layout(f):
    """The port's channels-first feature map in the JAX layout."""
    return f.permute(0, 2, 3, 1) if f.dim() == 4 else f.transpose(1, 2)


def test_discriminators(setup):
    rng = np.random.default_rng(10)
    y, y_hat = (rng.standard_normal((B, 2048)).astype(np.float32) * 0.3 for _ in range(2))
    d = jax.device_get(jd.mpmsd_init(jax.random.PRNGKey(10), **DISC))
    want = jax.jit(jd.mpmsd_apply, static_argnames=("periods", "spec_ffts"))(d, y, y_hat, **DISC)
    got = td.mpmsd_apply(to_torch(to_port_layout(d), "cpu"), _t(y), _t(y_hat), **DISC)
    for k in (0, 1):
        for g_, w_ in zip(got[k], want[k]):
            _rel(_fmap_layout(g_) if g_.dim() == 4 else g_, w_, 1e-4, f"logits {k}")
    for k in (2, 3):
        for gs, ws in zip(got[k], want[k]):
            for g_, w_ in zip(gs, ws):
                _rel(_fmap_layout(g_), w_, 1e-4, f"fmap {k}")

    dur = setup["trees"]["dur"]
    x = rng.standard_normal((B, TX, 32)).astype(np.float32)
    mask = _mask(X_LENGTHS, TX)
    dr, dh = (rng.standard_normal((B, TX, 1)).astype(np.float32) * mask for _ in range(2))
    want = jax.jit(jd.duration_disc_apply)(dur, x, mask, dr, dh)
    got = td.duration_disc_apply(to_torch(to_port_layout(dur), "cpu"), _t(x), _t(mask), _t(dr),
                                 _t(dh))
    for g_, w_ in zip(got, want):
        _rel(g_, w_, 1e-4, "duration discriminator")


def test_losses():
    rng = np.random.default_rng(11)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    dr, dg = [r(2, 30), r(2, 1, 5, 7)], [r(2, 30), r(2, 1, 5, 7)]
    fr, fg = [[r(2, 4, 9), r(2, 3, 6, 5)]], [[r(2, 4, 9), r(2, 3, 6, 5)]]
    T = lambda xs: [_t(a) for a in xs]
    pairs = [
        (tl.feature_loss([T(fr[0])], [T(fg[0])]), jl.feature_loss(fr, fg)),
        (tl.discriminator_loss(T(dr), T(dg))[0], jl.discriminator_loss(dr, dg)[0]),
        (tl.generator_loss(T(dg))[0], jl.generator_loss(dg)[0]),
        (tl.discriminator_tprls_loss(T(dr), T(dg)), jl.discriminator_tprls_loss(dr, dg)),
        (tl.generator_tprls_loss(T(dr), T(dg)), jl.generator_tprls_loss(dr, dg)),
    ]
    z_p, logs_q, m_p, logs_p = (r(2, 10, 8) * 0.5 for _ in range(4))
    zm = _mask([10, 7], 10)
    pairs.append((tl.kl_loss(*(_t(a) for a in (z_p, logs_q, m_p, logs_p, zm))),
                  jl.kl_loss(z_p, logs_q, m_p, logs_p, zm)))
    pairs.append((tl.duration_loss(_t(z_p), _t(m_p), _t(zm)), jl.duration_loss(z_p, m_p, zm)))
    y_mb, y_hat_mb = r(2, 512, 4), r(2, 520, 4)
    sizes = ((384, 683, 171), (30, 60, 10), (150, 300, 60))
    pairs.append((tl.subband_stft_loss(_t(y_mb), _t(y_hat_mb), *sizes),
                  jl.subband_stft_loss(y_mb, y_hat_mb, *sizes)))
    for i, (got, want) in enumerate(pairs):
        _rel(got, want, 1e-4, i)


# ---------------------------------------------------------------------------
# forward_train and the train step
# ---------------------------------------------------------------------------


def test_forward_train(setup):
    batch, want = setup["batch"], setup["forward"]
    pb = _port_batch(batch)
    with torch.no_grad():
        got = tv.forward_train(to_torch(to_port_layout(setup["trees"]["g"]), "cpu"),
                               tv.VITS2Config(**CFG), pb["x"], pb["x_lengths"], pb["mel"],
                               pb["mel_lengths"], pb["sid"],
                               noise={k: _t(v) for k, v in setup["noise"].items()})
    np.testing.assert_array_equal(got["attn"].numpy(), np.asarray(want["attn"]))
    np.testing.assert_array_equal(got["ids_slice"].numpy(), np.asarray(want["ids_slice"]))
    xm, ym = _mask(X_LENGTHS, TX), _mask(MEL_LENGTHS, TF)
    rows = {"x": xm, "logw": xm, "logw_": xm, "z": ym, "z_p": ym, "m_p": ym, "logs_p": ym,
            "m_q": ym, "logs_q": ym}
    errs = {k: _rel(got[k] * _t(m), np.asarray(want[k]) * m, 1e-4, k) for k, m in rows.items()}
    for k in ("wav", "wav_mb", "l_length", "x_mask", "y_mask"):
        errs[k] = _rel(got[k], want[k], 1e-4, k)
    k = max(errs, key=errs.get)
    print(f"forward_train: worst {errs[k]:.3e} x peak ({k})")


def test_train_step_losses_and_grads(setup):
    state = _port_state(setup)
    step = tt.make_train_step(tv.VITS2Config(**CFG), setup["tcfg"])
    metrics = step(state, _port_batch(setup["batch"]),
                   noise={k: _t(v) for k, v in setup["noise"].items()})
    assert set(metrics) == set(setup["metrics"])
    worst = max(_rel(metrics[k], np.float32(want), 1e-4, k) for k, want in setup["metrics"].items())
    print(f"losses: worst relative difference {worst:.3e}")
    assert state.step == 1
    for net in ("g", "d", "dur"):
        want = _flatten(to_port_layout(setup["grads"][net]))
        leaves = state.params[net].leaves()
        assert set(leaves) == set(want)
        # a gradient that is 0 in exact arithmetic (the attention key biases:
        # softmax does not see a shift shared by every key) is float noise on
        # both sides: a tensor whose JAX gradient is below 1e-6 x the
        # network's largest is held to that floor; every other one to 1e-3 x
        # its own largest magnitude
        floor = 1e-6 * max(float(np.abs(w).max()) for w in want.values())
        tiny = sorted(path for path, w in want.items() if float(np.abs(w).max()) < floor)
        worst = max(_rel(p.grad, want[path], 1e-3, f"{net} {path}") for path, p in leaves.items()
                    if path not in tiny)
        for path in tiny:
            _rel(leaves[path].grad, want[path], 1e-3, f"{net} {path}", floor=floor)
        print(f"{net}: worst {worst:.3e} of a tensor's max; {len(tiny)} of {len(want)} tensors "
              f"held to the floor {floor:.3e}: {tiny}")


def test_bf16_step_is_finite_and_close(setup):
    runs = {}
    for dtype in (None, torch.bfloat16):
        state = _port_state(setup)
        step = tt.make_train_step(tv.VITS2Config(**CFG), setup["tcfg"], compute_dtype=dtype)
        runs[dtype] = {k: float(v) for k, v in step(
            state, _port_batch(setup["batch"]),
            noise={k: _t(v) for k, v in setup["noise"].items()}).items()}
        assert all(np.isfinite(v) for v in runs[dtype].values()), runs[dtype]
    for k in ("loss_disc", "loss_gen", "loss_mel", "loss_kl", "loss_gen_all"):
        assert abs(runs[torch.bfloat16][k] - runs[None][k]) <= 0.1 * abs(runs[None][k]), k


def test_adamw_matches_optax():
    """torch AdamW and optax adamw: three steps of the same gradients, the
    learning rate changed between the second and the third."""
    rng = np.random.default_rng(12)
    p0 = {"a": rng.standard_normal((5, 7)).astype(np.float32),
          "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    lrs = (2e-4, 2e-4, 1.5e-4)
    opt = jt.make_optimizer(jt.TrainConfig())
    jp, js = {k: jnp.asarray(v) for k, v in p0.items()}, None
    js = opt.init(jp)
    module = TreeModule(p0, trainable=True)
    topt = tt.make_optimizer(module.parameters(), tt.TrainConfig())
    for g, lr in zip(grads, lrs):
        js.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        upd, js = opt.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        for group in topt.param_groups:
            group["lr"] = lr
        for path, p in module.leaves().items():
            p.grad = _t(g[path])
        topt.step()
    for path, p in module.leaves().items():
        _rel(p, jp[path], 1e-6, path)
