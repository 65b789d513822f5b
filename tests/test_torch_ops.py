"""Ops of the PyTorch port vs their JAX counterparts, on the CPU.

Same inputs (numpy, from a seed) and the same parameters (the JAX ``*_init``
trees through the port's weight carrier) go through both. f32; single ops
hold rtol/atol 1e-5, stacks and the spline 1e-4 (summation order differs,
and the spline divides by small bin widths).
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vosk_tts_tpu.models import vits2 as jvits2
from vosk_tts_tpu.ops import commons as jcommons
from vosk_tts_tpu.ops import conv as jconv
from vosk_tts_tpu.ops import flows as jflows
from vosk_tts_tpu.ops import norm as jnorm
from vosk_tts_tpu.ops import pqmf as jpqmf
from vosk_tts_tpu.ops import stft as jstft
from vosk_tts_tpu.ops import transforms as jtr
from vosk_tts_tpu.ops import wn as jwn
from vosk_tts_tpu.text import frontend as jfront
from vosk_tts_tpu.text import g2p as jg2p
from vosk_tts_tpu.text import symbols as jsym
from vosk_tts_tpu.utils import checkpoint as jckpt
from vosk_tts_tpu_torch import text as ttext
from vosk_tts_tpu_torch.models import vits2 as tvits2
from vosk_tts_tpu_torch.ops import commons as tcommons
from vosk_tts_tpu_torch.ops import conv as tconv
from vosk_tts_tpu_torch.ops import flows as tflows
from vosk_tts_tpu_torch.ops import norm as tnorm
from vosk_tts_tpu_torch.ops import pqmf as tpqmf
from vosk_tts_tpu_torch.ops import stft as tstft
from vosk_tts_tpu_torch.ops import transforms as ttr
from vosk_tts_tpu_torch.ops import wn as twn
from vosk_tts_tpu_torch.utils import checkpoint as tckpt
from vosk_tts_tpu_torch.utils import params as tparams


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port(tree):
    return tparams.to_torch(tparams.to_port_layout(jax.device_get(tree)), "cpu")


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def _mask(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]


def test_layer_norm():
    rng = np.random.default_rng(0)
    x, g, b = rng.standard_normal((2, 7, 48)), rng.standard_normal(48), rng.standard_normal(48)
    x, g, b = (a.astype(np.float32) for a in (x, g, b))
    _close(tnorm.layer_norm(_t(x), _t(g), _t(b)), jnorm.layer_norm(x, g, b))


@pytest.mark.parametrize("k,dilation,padding", [(5, 1, "same"), (3, 3, 3), (7, 1, 3), (1, 1, "same"),
                                                (4, 2, (1, 5))])
def test_conv1d(k, dilation, padding):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 23, 12)).astype(np.float32)
    p = jax.device_get(jwn._conv_init(jax.random.PRNGKey(k), k, 12, 20))
    want = jconv.conv1d(x, p["w"], p["b"], padding=padding, dilation=dilation)
    pp = tparams.to_port_layout({"c": p})["c"]
    _close(tconv.conv1d(_t(x), _t(pp["w"]), _t(pp["b"]), padding=padding, dilation=dilation), want)


def test_depthwise_conv1d():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 19, 16)).astype(np.float32)
    w = rng.standard_normal((3, 1, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    want = jconv.depthwise_conv1d(x, w, b, padding=3, dilation=3)
    _close(tconv.depthwise_conv1d(_t(x), _t(w.transpose(2, 1, 0)), _t(b), padding=3, dilation=3),
           want)


@pytest.mark.parametrize("k,stride,padding,opad", [(16, 4, 6, 0), (8, 4, 2, 1), (7, 3, 1, 0),
                                                   (16, 8, 4, 0)])
def test_conv_transpose1d(k, stride, padding, opad):
    rng = np.random.default_rng(k + stride)
    x = rng.standard_normal((2, 11, 8)).astype(np.float32)
    w = rng.standard_normal((k, 8, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    want = jconv.conv_transpose1d(x, w, b, stride=stride, padding=padding, output_padding=opad)
    got = tconv.conv_transpose1d(_t(x), _t(w.transpose(1, 2, 0)), _t(b), stride=stride,
                                 padding=padding, output_padding=opad)
    assert got.shape == want.shape
    _close(got, want)


def test_commons():
    rng = np.random.default_rng(2)
    lengths = np.array([5, 2, 7], np.int32)
    np.testing.assert_array_equal(tcommons.sequence_mask(_t(lengths), 9).numpy(),
                                  np.asarray(jcommons.sequence_mask(jnp.asarray(lengths), 9)))
    dur = rng.integers(0, 4, (3, 7)).astype(np.float32)
    xm = _mask(lengths, 7)[..., 0]
    ym = _mask([12, 4, 20], 20)[..., 0]
    np.testing.assert_array_equal(tcommons.generate_path(_t(dur), _t(xm), _t(ym)).numpy(),
                                  np.asarray(jcommons.generate_path(dur, xm, ym)))
    a, b = (rng.standard_normal((2, 5, 8)).astype(np.float32) for _ in range(2))
    _close(tcommons.fused_gate(_t(a), _t(b)), jcommons.fused_gate(a, b))


def test_wn_apply():
    rng = np.random.default_rng(3)
    p = jwn.wn_init(jax.random.PRNGKey(3), 16, 5, 1, 4, gin=8)
    x = rng.standard_normal((2, 30, 16)).astype(np.float32)
    m = _mask([30, 12], 30)
    g = rng.standard_normal((2, 1, 8)).astype(np.float32)
    want = jwn.wn_apply(p, x, m, g, kernel_size=5, dilation_rate=1)
    _close(twn.wn_apply(_port(p), _t(x), _t(m), _t(g), kernel_size=5, dilation_rate=1), want)


@pytest.mark.parametrize("kind", ["1", "2"])
def test_resblocks(kind):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 40, 16)).astype(np.float32)
    if kind == "1":
        p = jwn.resblock1_init(jax.random.PRNGKey(4), 16, 7, (1, 3, 5))
        want = jwn.resblock1_apply(p, x, kernel_size=7, dilation=(1, 3, 5))
        got = twn.resblock1_apply(_port(p), _t(x), kernel_size=7, dilation=(1, 3, 5))
    else:
        p = jwn.resblock2_init(jax.random.PRNGKey(4), 16, 3, (1, 3))
        want = jwn.resblock2_apply(p, x, kernel_size=3, dilation=(1, 3))
        got = twn.resblock2_apply(_port(p), _t(x), kernel_size=3, dilation=(1, 3))
    _close(got, want, 1e-4)


@pytest.mark.parametrize("seed", [5, 6])
def test_spline_transform_inverse(seed):
    rng = np.random.default_rng(seed)
    shape = (2, 17, 1)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)  # some inputs in the tails
    uw, uh = (rng.standard_normal(shape + (10,)).astype(np.float32) for _ in range(2))
    ud = rng.standard_normal(shape + (9,)).astype(np.float32)
    want = jtr.piecewise_rational_quadratic_transform(x, uw, uh, ud, inverse=True,
                                                      tails="linear", tail_bound=5.0)
    got = ttr.piecewise_rational_quadratic_transform(_t(x), _t(uw), _t(uh), _t(ud),
                                                     inverse=True, tail_bound=5.0)
    _close(got[0], want[0], 1e-4)
    _close(got[1], want[1], 1e-4)


def test_flows_reverse():
    """ConvFlow reverse with a perturbed (nonzero) proj, then Flip and
    ElementwiseAffine, as sdp_reverse chains them."""
    rng = np.random.default_rng(6)
    cf = jax.device_get(jflows.convflow_init(jax.random.PRNGKey(6), 2, 64, 3, 3))
    cf["proj"]["w"] = (rng.standard_normal(cf["proj"]["w"].shape) * 0.05).astype(np.float32)
    cf["proj"]["b"] = (rng.standard_normal(cf["proj"]["b"].shape) * 0.05).astype(np.float32)
    ea = {"m": rng.standard_normal(2).astype(np.float32),
          "logs": (0.1 * rng.standard_normal(2)).astype(np.float32)}
    z = rng.standard_normal((2, 24, 2)).astype(np.float32)
    m = _mask([24, 13], 24)
    g = rng.standard_normal((2, 24, 64)).astype(np.float32)

    want = jflows.convflow_apply(cf, jflows.flip_flow(z, reverse=True), m, g=g, reverse=True,
                                 filter_channels=64, kernel_size=3)
    want = jflows.elementwise_affine_apply(ea, jflows.flip_flow(want, reverse=True), m, reverse=True)
    got = tflows.convflow_apply(_port(cf), tflows.flip_flow(_t(z)), _t(m), g=_t(g),
                                reverse=True, filter_channels=64, kernel_size=3)
    got = tflows.elementwise_affine_apply(_port(ea), tflows.flip_flow(got), _t(m), reverse=True)
    _close(got, want, 1e-4)


def test_pqmf_synthesis():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 50, 4)).astype(np.float32)
    _close(tpqmf.pqmf_synthesis(_t(x)), jpqmf.pqmf_synthesis(jnp.asarray(x)))


def test_istft_multiband():
    rng = np.random.default_rng(8)
    mag = np.exp(rng.standard_normal((2, 20, 4, 9))).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (2, 20, 4, 9)).astype(np.float32)
    _close(tstft.istft_multiband(_t(mag), _t(phase), 16, 4, 16),
           jstft.istft_multiband(mag, phase, 16, 4, 16))


@pytest.mark.parametrize("t", [12, 50])
def test_mb_decoder_tail_fused(t):
    """t=50 takes the composite-FIR path with its edge patches, t=12 the
    unfused fallback."""
    x = np.random.default_rng(9).standard_normal((2, t, 72)).astype(np.float32)
    want = jstft.mb_decoder_tail_fused(jnp.asarray(x), 16, 4, 16, subbands=4)
    got = tstft.mb_decoder_tail_fused(_t(x), 16, 4, 16, subbands=4)
    assert got.shape == want.shape
    _close(got, want, 1e-4)


def test_text_frontend_copy(tmp_path):
    dic_path = tmp_path / "dictionary"
    dic_path.write_text("привет 1.0 p rj i0 vj e1 t\nпривет 0.5 p r i\nмир 1.0 mj i1 r\n",
                        encoding="utf-8")
    assert ttext.load_dictionary(dic_path) == jfront.load_dictionary(dic_path)
    dic = jfront.load_dictionary(dic_path)
    assert ttext.plain_symbol_map() == jsym.plain_symbol_map()
    for word in ("абстр+акцию", "ёжик", "съел", "подъезд", "Гоголь", "щи-щи"):
        assert ttext.convert(word) == jg2p.convert(word)
    id_map = jsym.plain_symbol_map()
    for text in ("Привет мир!", "Как дела, друг? «Хорошо» - сказал он.", "ёлка (зелёная); да."):
        for blank in (True, False):
            assert (ttext.g2p_plain(text.replace("«", '"').replace("»", '"'), dic, id_map,
                                    blank=blank)
                    == jfront.g2p_plain(text.replace("«", '"').replace("»", '"'), dic, id_map,
                                        blank=blank))


def test_checkpoint_format(tmp_path):
    """The port's jax-free loader reads what the JAX package writes, and
    writes what it reads (lists, None leaves)."""
    cfg = jvits2.VITS2Config(inter_channels=16, hidden_channels=16, filter_channels=32,
                             n_layers=1, upsample_initial_channel=32, n_speakers=2,
                             gin_channels=8, spec_channels=8)
    params = jvits2.synthesizer_init(jax.random.PRNGKey(0), cfg)
    jckpt.save_params(tmp_path / "a.npz", params)
    mine = tckpt.load_params(tmp_path / "a.npz")
    theirs = jckpt.load_params(tmp_path / "a.npz")
    assert mine["dec"]["conv_post"]["b"] is None
    tckpt.save_params(tmp_path / "b.npz", mine)
    again = jckpt.load_params(tmp_path / "b.npz")
    flat = lambda tree: {jax.tree_util.keystr(k): v for k, v in
                         jax.tree_util.tree_leaves_with_path(tree)}
    for tree in (mine, again):
        got, want = flat(tree), flat(theirs)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_synthesizer_init_matches_jax_structure():
    """The port's numpy init draws the same tree (keys, shapes, dtypes, None
    leaves, zero-initialised projections) as the JAX init."""
    cfg = dict(inter_channels=16, hidden_channels=16, filter_channels=32, n_layers=3,
               upsample_initial_channel=32, n_speakers=3, gin_channels=8, spec_channels=8)
    want = jax.device_get(jvits2.synthesizer_init(jax.random.PRNGKey(0), jvits2.VITS2Config(**cfg)))
    got = tparams.synthesizer_init(tvits2.VITS2Config(**cfg), seed=0)
    paths = lambda tree: {jax.tree_util.keystr(k): (np.shape(v), np.asarray(v).dtype)
                          for k, v in jax.tree_util.tree_leaves_with_path(
                              tree, is_leaf=lambda x: x is None)}
    assert paths(got) == paths(want)
    assert got["dec"]["conv_post"]["b"] is None
    assert not np.any(got["flow"]["flows"][0]["post"]["w"])
    assert not np.any(got["dp"]["flows"][1]["proj"]["w"])


def test_config_from_bundle_dict():
    import dataclasses

    cfg = jvits2.VITS2Config()
    d = json.loads(json.dumps(dataclasses.asdict(cfg)))
    port = tvits2.VITS2Config.from_dict(d)
    assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
    assert port.upsample_factor == cfg.upsample_factor == 256
    assert port.enc_gin_channels == cfg.enc_gin_channels
