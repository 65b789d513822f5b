"""The StableTTS (multistream) model of the PyTorch port vs the JAX package.

One small configuration (that of tests/test_multistream_api.py: every
structure of the shipped one at narrow widths) and one parameter tree from
the JAX init, with the zero-initialised adaLN-Zero projections and CFG
fakes perturbed (as initialised, every DiT block is the identity and the
unconditional half of CFG is degenerate, so a wrong attention would pass).
Both packages run on the CPU; the JAX DiT attention takes its f32 einsum
path. f32 throughout. Stage outputs hold 1e-5 (rtol and atol: several
layers, sums in other orders; measured 6e-7 at most); the ODE and the mel
hold 2e-5, since they run the decoder 2-12 times over. The decoder's time
embedding takes sin/cos of angles up to 1000 rad, where one ulp of t moves
the result by ~1e-4: the port forms the ODE's time grid as JAX does
(``stabletts.time_grid``), so both sides take the same f32 angles.
Durations go through round(), so the decode tests take ``w_round`` from
the JAX encode pass.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from torch_shared import shared
from vosk_tts_tpu.models import stabletts as jst
from vosk_tts_tpu_torch.models import stabletts as tst
from vosk_tts_tpu_torch.utils.params import perturb_matcha_zero_init, to_port_layout, to_torch

CFG = dict(n_vocab=207, n_feats=16, n_spks=5, spk_emb_dim=8, hidden_channels=32,
           filter_channels=64, n_heads=2, n_layers=2, phone_emb_dim=12, punc_emb_dim=4,
           bert_dim=24, bert_proj_dim=4, dec_hidden=32, dec_filter=64, dec_layers=2, dec_heads=2)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(jax cfg, port cfg, jax tree (numpy), port tree (tensors)); the tree,
    from the JAX init op by op, is built once a run and read by every xdist
    worker (tests/torch_shared.py)."""
    jcfg = jst.StableTTSConfig(**CFG)
    tree = shared(tmp_path_factory, "stabletts_model", lambda _: perturb_matcha_zero_init(
        jax.device_get(jst.matcha_init(jax.random.PRNGKey(0), jcfg)), seed=1))[1]
    return jcfg, tst.StableTTSConfig(**CFG), tree, to_torch(tst.port_layout(tree), "cpu")


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _mask(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]


def _text_inputs(lengths, t, seed):
    """x (B, 5, T) stream ids, x_lengths, bert rows, speaker ids."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    x = rng.integers(0, 207, (b, 5, t)).astype(np.int32) * _mask(lengths, t)[:, None, :, 0].astype(np.int32)
    bert = rng.standard_normal((b, t, 24)).astype(np.float32) * _mask(lengths, t)
    return x, np.asarray(lengths, np.int32), bert, np.arange(b, dtype=np.int32) % 5


def test_qkv_fused_in_matcha_only(model):
    """port_layout fuses every DiT attention of the matcha tree into
    [q | k | v]; the shared converter leaves any other {q, k, v, o} dict (a
    VITS2 attention without a window) as it is."""
    _, _, tree, tp = model
    te, dec = tp["text_encoder"], tp["decoder"]
    for blk in te["encoder"]["blocks"] + te["dp_encoder"]["blocks"] + [b["dit"] for b in dec["blocks"]]:
        assert set(blk["attn"]) == {"qkv", "o"}
    a = tree["text_encoder"]["encoder"]["blocks"][0]["attn"]
    np.testing.assert_array_equal(te["encoder"]["blocks"][0]["attn"]["qkv"]["w"][32:64].numpy(),
                                  np.asarray(a["k"]["w"])[0].T)
    plain = to_port_layout({"pre_transformer": {"attn": [dict(a)]}})
    assert set(plain["pre_transformer"]["attn"][0]) == {"q", "k", "v", "o"}


@pytest.mark.parametrize("time_axis", [1, 2])
def test_rope(time_axis):
    x = np.random.default_rng(time_axis).standard_normal((2, 37, 3, 24)).astype(np.float32)
    if time_axis == 2:
        x = x.transpose(0, 2, 1, 3)
    want = jst.rope(jnp.asarray(x), 12, time_axis=time_axis)
    _close(tst.rope(_t(x), 12, time_axis=time_axis), want, 1e-6)


def test_dit_mha_valid_rows(model):
    """Against the einsum path with the block's attention bias (-finfo.max
    where the query or the key is masked): valid rows agree; rows past the
    length differ by design (the kernel masks keys only) and are zeroed by
    the block."""
    _, _, tree, tp = model
    blk_j = tree["text_encoder"]["encoder"]["blocks"][0]
    blk_t = tp["text_encoder"]["encoder"]["blocks"][0]
    lengths, t = [50, 23], 50
    x = np.random.default_rng(3).standard_normal((2, t, 32)).astype(np.float32)
    m = _mask(lengths, t)[..., 0]
    bias = np.where(m[:, None, :, None] * m[:, None, None, :] == 0,
                    -np.finfo(np.float32).max, 0.0).astype(np.float32)
    want = np.asarray(jst.dit_mha_apply(blk_j["attn"], jnp.asarray(x), jnp.asarray(bias),
                                        n_heads=2))
    got = tst.dit_mha_apply(blk_t["attn"], _t(x), torch.tensor(lengths, dtype=torch.int32),
                            n_heads=2).numpy()
    for i, n in enumerate(lengths):
        _close(got[i, :n], want[i, :n])


def test_dit_block(model):
    _, _, tree, tp = model
    lengths, t = [40, 17], 40
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, t, 32)).astype(np.float32)
    c = rng.standard_normal((2, 8)).astype(np.float32)
    mask = _mask(lengths, t)
    blk_j = tree["decoder"]["blocks"][1]["dit"]
    blk_t = tp["decoder"]["blocks"][1]["dit"]
    want = jst.dit_block_apply(blk_j, jnp.asarray(x), jnp.asarray(c), jnp.asarray(mask),
                               n_heads=2, kernel_size=3)
    assert float(np.abs(np.asarray(want) - x * mask).max()) > 1e-2  # the block is not an identity
    got = tst.dit_block_apply(blk_t, _t(x), _t(c), _t(mask), n_heads=2, kernel_size=3)
    _close(got, want)  # every row: rows past the length are 0 in both


def test_text_encoder(model):
    jcfg, tcfg, tree, tp = model
    x, lengths, bert, sid = _text_inputs([32, 19], 32, 5)
    spks, dur = tree["spk_emb"][sid], tree["dur_spk_emb"][sid]
    want = jst.text_encoder_apply(tree["text_encoder"], jcfg, x, lengths, spks, dur, bert)
    got = tst.text_encoder_apply(tp["text_encoder"], tcfg, _t(x), _t(lengths), _t(spks), _t(dur),
                                 _t(bert))
    for a, b in zip(got, want):
        _close(a, b)


def test_decoder_apply(model):
    """The time embedding takes sin/cos of angles up to 1000 rad: both sides
    compute the same f32 angles from the same t."""
    jcfg, tcfg, tree, tp = model
    rng = np.random.default_rng(6)
    lengths, t = [64, 45], 64
    mask = _mask(lengths, t)
    x = rng.standard_normal((2, t, 16)).astype(np.float32)
    mu = rng.standard_normal((2, t, 32)).astype(np.float32) * mask
    ts = np.array([0.0123, 0.87], np.float32)
    c = tree["spk_emb"][[1, 3]]
    want = jst.decoder_apply(tree["decoder"], jcfg, x, mask, mu, ts, c)
    got = tst.decoder_apply(tp["decoder"], tcfg, _t(x), _t(mask), _t(mu), _t(ts), _t(c))
    _close(got, want)


@pytest.mark.parametrize("solver,guidance", [("euler", 0.5), ("heun", 0.5), ("euler", 0.0)])
def test_cfm_solve(model, solver, guidance):
    jcfg, tcfg, tree, tp = model
    rng = np.random.default_rng(7)
    lengths, t = [48, 30], 48
    mask = _mask(lengths, t)
    mu = rng.standard_normal((2, t, 32)).astype(np.float32) * mask
    z = rng.standard_normal((2, t, 16)).astype(np.float32)
    spks = tree["spk_emb"][[0, 4]]
    kw = dict(n_timesteps=4, guidance_scale=guidance, solver=solver)
    want = jst.cfm_solve(tree, jcfg, mu, mask, rng=jax.random.PRNGKey(0), z=z, spks=spks, **kw)
    got = tst.cfm_solve(tp, tcfg, _t(mu), _t(mask), z=_t(z), spks=_t(spks), **kw)
    _close(got, want, 2e-5)


@pytest.fixture(scope="module")
def encoded(model):
    """Both packages' encode_for_synth on one batch with a pause marker
    (phone_duration_extra 20 on one token)."""
    jcfg, tcfg, tree, tp = model
    x, lengths, bert, sid = _text_inputs([32, 21], 32, 8)
    pde = np.zeros((2, 32), np.float32)
    pde[0, 5] = pde[1, 3] = 20.0
    kw = dict(length_scale=1.1)
    enc_j = jst.encode_for_synth(tree, jcfg, x, lengths, sid, bert, phone_duration_extra=pde, **kw)
    enc_t = tst.encode_for_synth(tp, tcfg, _t(x), _t(lengths), _t(sid), _t(bert),
                                 phone_duration_extra=_t(pde), **kw)
    return (x, lengths, bert, sid, pde), jax.device_get(enc_j), enc_t


def test_encode_for_synth(encoded):
    _, enc_j, enc_t = encoded
    for k in ("xc", "mu_mel", "x_mask", "pde"):
        _close(enc_t[k], enc_j[k])
    np.testing.assert_array_equal(enc_t["w_round"].numpy(), enc_j["w_round"])
    np.testing.assert_array_equal(enc_t["pred_frames"].numpy(), enc_j["pred_frames"])
    assert enc_j["w_round"][0, 5, 0] == 22.0  # the pause marker's 20 frames * 1.1


@pytest.mark.parametrize("solver", ["euler", "heun"])
def test_decode_from_durations(model, encoded, solver):
    """Temperature 0 (z = 0 on both sides), w_round pinned from JAX; the
    pause token's frames take the first frame's mel."""
    jcfg, tcfg, tree, tp = model
    (_, _, _, sid, _), enc_j, _ = encoded
    fb = int(-(-int(enc_j["pred_frames"].max()) // 64) * 64)
    kw = dict(max_frames=fb, n_timesteps=3, temperature=0.0, solver=solver)
    want = jst.decode_from_durations(tree, jcfg, enc_j, sid, rng=jax.random.PRNGKey(0), **kw)
    got = tst.decode_from_durations(tp, tcfg, {k: _t(v) for k, v in enc_j.items()}, _t(sid), **kw)
    np.testing.assert_array_equal(got["mel_lengths"].numpy(), np.asarray(want["mel_lengths"]))
    for k in ("mel", "mel_enc", "attn"):
        _close(got[k], want[k], 2e-5)
    start = int(enc_j["w_round"][0, :5, 0].sum())
    pause = got["decoder_outputs"][0, start:start + 22]
    assert torch.equal(pause, got["decoder_outputs"][0, :1].expand_as(pause))


def test_synthesise_is_the_split_path(model, encoded):
    """The single-pass path equals encode_for_synth + decode_from_durations
    (with z given: the same noise on both)."""
    _, tcfg, _, tp = model
    (x, lengths, bert, sid, pde), _, enc_t = encoded
    fb = 1024
    z = torch.from_numpy(np.random.default_rng(9).standard_normal((2, fb, 16)).astype(np.float32))
    kw = dict(max_frames=fb, n_timesteps=2, temperature=0.7, z=z)
    fused = tst.synthesise(tp, tcfg, _t(x), _t(lengths), _t(sid), _t(bert),
                           phone_duration_extra=_t(pde), length_scale=1.1, **kw)
    split = tst.decode_from_durations(tp, tcfg, enc_t, _t(sid), **kw)
    for k in ("mel", "mel_lengths"):
        assert torch.equal(fused[k], split[k])


def test_config_from_bundle_block():
    cfg = tst.StableTTSConfig.from_dict(dataclasses.asdict(jst.StableTTSConfig(**CFG)))
    assert cfg == tst.StableTTSConfig(**CFG)
    assert tst.d_rope_of(64) == 32 and tst.d_rope_of(96) == 48 and tst.d_rope_of(16) == 8
