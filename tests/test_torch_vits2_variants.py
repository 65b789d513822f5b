"""The VITS2 variants of the PyTorch port vs the JAX package, on the CPU.

Every flow type (``plain``, ``pre_conv``, ``pre_conv2``, ``fft``,
``mono_layer_inter_residual``, ``mono_layer_post_residual``), the
deterministic duration predictor, and every decoder (``hifigan``,
``istft``, ``mb_istft`` fused and unfused, ``ms_istft``) in both iSTFT
modes, at small widths (hidden 32, 2 flows). Inputs are seeded numpy
arrays; trees come from the port's numpy ``synthesizer_init`` (held to
``jax.eval_shape`` of the JAX init: a JAX init of a whole synthesizer
compiles for ~30 s here), with the zero-initialised flow ``post`` convs
(and the mono layers') and the SDP's ConvFlow ``proj`` perturbed so that
the flows are not identities. The JAX references run under ``jax.jit``
(op by op their compiles dominate).

Tolerances, each stated where it is checked: attention forms and
``dp_apply`` 1e-5 abs (f32, a few layers); flows 1e-4 x peak (several
layers, other summation orders); iSTFT forms 1e-5 x peak; generators 1e-4 x
peak; end to end 2 int16 LSB and equal length. Windowless self-attention
masks keys only on the port's side (kernel 5's semantics) where the JAX
package masks query x key at -1e4, so it is compared on valid rows.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import torch

from vosk_tts_tpu import api as japi
from vosk_tts_tpu.models import vits2 as jv
from vosk_tts_tpu.ops import attention as jatt
from vosk_tts_tpu.ops import commons as jcommons
from vosk_tts_tpu.ops import stft as jstft
from vosk_tts_tpu.text import plain_symbol_map
from vosk_tts_tpu.utils.checkpoint import save_params
from vosk_tts_tpu_torch import api as tapi
from vosk_tts_tpu_torch.models import vits2 as tv
from vosk_tts_tpu_torch.ops import attention as tatt
from vosk_tts_tpu_torch.ops import commons as tcommons
from vosk_tts_tpu_torch.ops import stft as tstft
from vosk_tts_tpu_torch.serving.batcher import BatchSynthesizer
from vosk_tts_tpu_torch.utils.params import (LINEARS, from_port_layout, perturb_zero_init,
                                             synthesizer_init, to_port_layout, to_torch)

BASE = dict(inter_channels=32, hidden_channels=32, filter_channels=64, n_layers=2, n_flows=2,
            upsample_initial_channel=32, n_speakers=4, gin_channels=16, spec_channels=13,
            posterior_wn_layers=2, sdp_n_flows=2)
TEXT = "Привет мир и всем хорошего дня!"
KW = dict(speaker_id=1, noise_level=0.0, duration_noise_level=0.0)

# one bundle per flow type; together they cover every decoder, both iSTFT
# modes and both duration predictors
BUNDLES = {
    "plain": dict(decoder_type="ms_istft"),
    "pre_conv": dict(decoder_type="istft"),
    "pre_conv2": dict(decoder_type="mb_istft", istft_mode="onnx", use_sdp=False),
    "fft": dict(decoder_type="hifigan"),
    "mono_layer_inter_residual": dict(decoder_type="ms_istft", istft_mode="onnx", use_sdp=False),
    "mono_layer_post_residual": dict(decoder_type="istft", istft_mode="onnx"),
}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch threads here; the JAX executables this module compiled are
    dropped after it (a test worker runs other modules next)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def _cfg(flow="pre_conv2", **kw):
    flows = dict(use_transformer_flows=flow != "plain",
                 transformer_flow_type="pre_conv2" if flow == "plain" else flow)
    return {**BASE, **flows, **kw}


def _tree(cfg: dict, seed=0):
    tcfg = tv.VITS2Config(**cfg)
    return jv.VITS2Config(**cfg), tcfg, perturb_zero_init(synthesizer_init(tcfg, seed), seed + 1)


def _t(a):
    return torch.tensor(np.asarray(a))


def _mask(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]


def _peak_close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rel * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# attention forms (valid rows, 1e-5 abs)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["windowless", "causal", "proximal", "fft"])
def test_attention_forms(form):
    rng = np.random.default_rng(0)
    t, lengths = 24, [24, 15]
    mask = _mask(lengths, t)
    x = rng.standard_normal((2, t, 32)).astype(np.float32) * mask
    if form == "fft":
        p = jax.device_get(jax.jit(lambda key: jatt.fft_init(key, 32, 64, 4, 2, 5, gin=16))(
            jax.random.PRNGKey(1)))
        g = rng.standard_normal((2, 1, 16)).astype(np.float32)
        want = jax.jit(jatt.fft_apply, static_argnames=("n_heads", "kernel_size"))(
            p, x, mask, g, n_heads=4, kernel_size=5)
        got = tatt.fft_apply(to_torch(to_port_layout(p), "cpu"), _t(x), _t(mask), _t(g),
                             n_heads=4, kernel_size=5)
        np.testing.assert_allclose((got * _t(mask)).numpy(), np.asarray(want), atol=1e-5, rtol=0)
        return
    p = jax.device_get(jax.jit(lambda key: jatt.mha_init(key, 32, 32, 2,
                                                         proximal_init=form == "proximal"))(
        jax.random.PRNGKey(1)))
    tp = to_torch(to_port_layout(p), "cpu")
    mha = jax.jit(jatt.mha_apply, static_argnames=("n_heads", "proximal_bias"))
    if form == "windowless":
        am = mask[:, None, :, 0][:, :, None, :] * mask[:, None, :, 0][:, :, :, None]
        want = mha(p, x, x, am, n_heads=2)
        xt = _t(x)
        got = tatt.mha_apply(tp, xt, xt, n_heads=2, kv_len=_t(np.asarray(lengths, np.int32)))
    else:
        causal = np.asarray(jcommons.subsequent_mask(t))[None]
        np.testing.assert_array_equal(tcommons.subsequent_mask(t).numpy()[None], causal)
        want = mha(p, x, x, causal, n_heads=2, proximal_bias=form == "proximal")
        xt = _t(x)
        got = tatt.mha_apply(tp, xt, xt, _t(causal), n_heads=2, proximal_bias=form == "proximal")
    np.testing.assert_allclose((got * _t(mask)).numpy(), np.asarray(want) * mask, atol=1e-5,
                               rtol=0)


# ---------------------------------------------------------------------------
# flows, both directions (1e-4 x peak)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("flow", list(BUNDLES))
def test_flow(flow, reverse):
    jcfg, tcfg, tree = _tree(_cfg(flow), seed=2)
    rng = np.random.default_rng(3)
    t = 48
    mask = _mask([t, 31], t)
    z = rng.standard_normal((2, t, 32)).astype(np.float32) * mask
    g = tree["emb_g"][np.array([0, 3])][:, None, :]
    want = jax.jit(jv.flow_block_apply, static_argnames=("cfg", "reverse"))(
        tree["flow"], jcfg, z, mask, g, reverse=reverse)
    got = tv.flow_block_apply(to_torch(to_port_layout(tree["flow"]), "cpu"), tcfg, _t(z),
                              _t(mask), _t(g), reverse=reverse)
    assert float(np.abs(np.asarray(want) - z).max()) > 1e-3  # the flow is not an identity
    _peak_close(got * _t(mask), np.asarray(want) * mask, 1e-4)


def test_dp_apply():
    jcfg, tcfg, tree = _tree(_cfg(use_sdp=False), seed=4)
    rng = np.random.default_rng(5)
    mask = _mask([20, 13], 20)
    x = rng.standard_normal((2, 20, 32)).astype(np.float32) * mask
    g = tree["emb_g"][np.array([1, 2])][:, None, :]
    want = jax.jit(jv.dp_apply, static_argnames="cfg")(tree["dp"], jcfg, x, mask, g)
    got = tv.dp_apply(to_torch(to_port_layout(tree["dp"]), "cpu"), tcfg, _t(x), _t(mask), _t(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# iSTFT forms (1e-5 x peak)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["istft", "istft_onnx", "multiband_onnx", "tail_fused_torch",
                                  "tail_fused_onnx"])
def test_istft_forms(form):
    rng = np.random.default_rng(6)
    t, n_fft, hop, sub = 48, 16, 4, 4
    if form.startswith("tail_fused"):
        mode = form.rsplit("_", 1)[1]
        x = rng.standard_normal((2, t, sub * (n_fft + 2))).astype(np.float32) * 0.5
        want = jax.jit(lambda a: jstft.mb_decoder_tail_fused(a, n_fft, hop, n_fft, subbands=sub,
                                                             mode=mode))(x)
        got = tstft.mb_decoder_tail_fused(_t(x), n_fft, hop, n_fft, subbands=sub, mode=mode)
    elif form == "multiband_onnx":
        mag = np.exp(rng.standard_normal((2, t, sub, n_fft // 2 + 1))).astype(np.float32)
        phase = rng.uniform(-np.pi, np.pi, mag.shape).astype(np.float32)
        want = jax.jit(lambda m, p: jstft.istft_multiband(m, p, n_fft, hop, n_fft,
                                                          mode="onnx"))(mag, phase)
        got = tstft.istft_multiband(_t(mag), _t(phase), n_fft, hop, n_fft, mode="onnx")
    else:
        n_fft, hop = 64, 16  # a Vocos-like single band
        mag = np.exp(rng.standard_normal((2, t, n_fft // 2 + 1))).astype(np.float32)
        phase = rng.uniform(-np.pi, np.pi, mag.shape).astype(np.float32)
        want = jax.jit(lambda m, p: getattr(jstft, form)(m, p, n_fft, hop, n_fft))(mag, phase)
        got = tstft.istft(_t(mag), _t(phase), n_fft, hop, n_fft,
                          mode="onnx" if form == "istft_onnx" else "torch")
    assert got.shape == np.asarray(want).shape
    _peak_close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# generators (1e-4 x peak)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("decoder,mode,fused", [
    ("hifigan", "torch", False), ("istft", "torch", False), ("istft", "onnx", False),
    ("mb_istft", "torch", True), ("mb_istft", "onnx", True), ("mb_istft", "onnx", False),
    ("ms_istft", "torch", False), ("ms_istft", "onnx", False)])
def test_generator(decoder, mode, fused):
    cfg = {**_cfg(), "decoder_type": decoder, "istft_mode": mode}
    jcfg, tcfg, tree = _tree(cfg, seed=7)
    params = tree["dec"]
    rng = np.random.default_rng(8)
    z = rng.standard_normal((2, 40, 32)).astype(np.float32)
    g = rng.standard_normal((2, 1, 16)).astype(np.float32)
    want, want_mb = jax.jit(jv.generator_apply, static_argnames=("cfg", "fused_tail"))(
        params, jcfg, z, g, fused_tail=fused)
    got, got_mb = tv.generator_apply(to_torch(to_port_layout(params), "cpu"), tcfg, _t(z), _t(g),
                                     fused_tail=fused)
    assert got.shape == np.asarray(want).shape == (2, 40 * tcfg.upsample_factor, 1)
    assert (got_mb is None) == (want_mb is None)
    _peak_close(got, want, 1e-4)
    if want_mb is not None:
        _peak_close(got_mb, want_mb, 1e-4)


def test_inits_and_layouts_match_jax():
    """The port's numpy ``synthesizer_init`` gives the JAX init's structure
    and shapes for every variant (``jax.eval_shape``: no JAX init runs),
    and ``from_port_layout`` inverts ``to_port_layout`` on each tree."""
    for flow, extra in BUNDLES.items():
        cfg = _cfg(flow, **extra)
        mine = synthesizer_init(tv.VITS2Config(**cfg), seed=0)
        jcfg = jv.VITS2Config(**cfg)
        theirs = jax.eval_shape(lambda key: jv.synthesizer_init(key, jcfg), jax.random.PRNGKey(0))
        assert jax.tree.structure(mine) == jax.tree.structure(theirs), flow
        assert ([a.shape for a in jax.tree.leaves(mine)]
                == [a.shape for a in jax.tree.leaves(theirs)]), flow
        back = from_port_layout(to_port_layout(mine), LINEARS)
        assert jax.tree.structure(back) == jax.tree.structure(mine)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(mine)):
            np.testing.assert_array_equal(a, b)


def test_configs_refused_and_training_variants():
    """Serving refuses only what neither package knows; every configuration
    it serves also trains: one port train step of each (tiny mel settings,
    the decoder's samples a frame as the hop) gives finite losses and moves
    the generator. Its parity with the JAX step is
    tests/test_torch_vits2_variants_train.py's."""
    from vosk_tts_tpu_torch.train import vits2_train as tt

    for bad in (dict(transformer_flow_type="nope"), dict(decoder_type="wavenet"),
                dict(istft_mode="cufft")):
        with pytest.raises(ValueError):
            tv.check_ported(tv.VITS2Config(**{**BASE, **bad}))
    rng = np.random.default_rng(9)
    for i, (flow, extra) in enumerate(BUNDLES.items()):
        cfg = tv.VITS2Config(**{**_cfg(flow, **extra), "segment_size": 8})
        tv.check_ported(cfg)
        hop, t_x, t_f = cfg.upsample_factor, 10, 24
        tcfg = tt.TrainConfig(hop_length=hop, filter_length=256, win_length=256,
                              n_mel_channels=cfg.spec_channels, disc_periods=(2,),
                              disc_spec_ffts=(128,), fft_sizes=(64, 128, 32), hop_sizes=(8, 16, 4),
                              win_lengths=(32, 64, 16))
        trees = tt.init_trees(cfg, tcfg, seed=i)
        trees["g"] = to_port_layout(perturb_zero_init(synthesizer_init(cfg, i), i + 1))
        state = tt.init_train_state(cfg, tcfg, device="cpu", trees=trees)
        before = {k: v.detach().clone() for k, v in state.params["g"].leaves().items()}
        batch = {"x": torch.tensor(rng.integers(1, 40, (2, t_x))),
                 "x_lengths": torch.tensor([t_x, 7]),
                 "mel": torch.tensor(rng.standard_normal((2, t_f, cfg.spec_channels)),
                                     dtype=torch.float32),
                 "mel_lengths": torch.tensor([t_f, 19]),
                 "wav": torch.tensor(rng.standard_normal((2, t_f * hop)) * 0.3,
                                     dtype=torch.float32),
                 "sid": torch.tensor([0, 3])}
        metrics = tt.make_train_step(cfg, tcfg)(state, batch,
                                                generator=torch.Generator().manual_seed(i))
        vals = {k: float(v) for k, v in metrics.items()}
        assert all(np.isfinite(v) for v in vals.values()), (flow, vals)
        assert (vals["loss_subband"] != 0) == (cfg.decoder_type == "mb_istft"), flow
        moved = sum(not torch.equal(before[k], v) for k, v in state.params["g"].leaves().items())
        assert moved > 0.9 * len(before), (flow, moved, len(before))


# ---------------------------------------------------------------------------
# end to end: one bundle a flow type (2 int16 LSB, equal length)
# ---------------------------------------------------------------------------


def _write_bundle(path, jcfg, tree):
    path.mkdir()
    save_params(path / "params.npz", tree)
    with open(path / "config.json", "w", encoding="utf-8") as f:
        json.dump({"model_type": "vits2", "sample_rate": 22050,
                   "phoneme_id_map": {k: [v] for k, v in plain_symbol_map().items()},
                   "inference": {"noise_level": 0.8, "speech_rate": 1.0,
                                 "duration_noise_level": 0.8},
                   "model": dataclasses.asdict(jcfg)}, f, ensure_ascii=False)
    (path / "dictionary").write_text("привет 1.0 p rj i0 vj e1 t\n", encoding="utf-8")
    return path


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    root = tmp_path_factory.mktemp("variants")
    out = {}
    for i, (flow, extra) in enumerate(BUNDLES.items()):
        jcfg, _, tree = _tree(_cfg(flow, **extra), seed=10 + i)
        out[flow] = _write_bundle(root / flow, jcfg, tree)
    return out


@pytest.mark.parametrize("flow", list(BUNDLES))
def test_synth_audio_end_to_end(bundles, flow):
    """Both packages' Model/Synth on one bundle written by the JAX package,
    noise 0: equal length (so equal durations) and samples within 2."""
    bundle = bundles[flow]
    jmodel, port = japi.Model(model_path=bundle), tapi.Model(bundle, device="cpu")
    want = japi.Synth(jmodel).synth_audio(TEXT, **KW)
    got = tapi.Synth(port).synth_audio(TEXT, **KW)
    assert got.dtype == np.int16 and len(got) == len(want) > 0 and np.any(want != 0)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 2


def test_batcher_serves_a_variant_as_synth(bundles):
    """A ``pre_conv`` bundle through the port's dynamic batcher: a request
    alone in its batch equals ``Synth.synth_audio`` (noise 0)."""
    model = tapi.Model(bundles["pre_conv"], device="cpu")
    want = tapi.Synth(model).synth_audio(TEXT, **KW)
    b = BatchSynthesizer(model, max_batch=4)
    try:
        got = b.submit_text(TEXT, sid=1, noise_level=0.0, duration_noise_level=0.0).result(
            timeout=300)
    finally:
        b.close()
    assert len(got) == len(want) > 0
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 2
