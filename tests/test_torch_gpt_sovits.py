"""The GPT-SoVITS slice of the PyTorch port vs the JAX package.

The AR model (teacher-forced logits, the prefill and the KV-cached step,
greedy ``ar_infer``/``ar_infer_batch`` with ``min_new`` and padded text,
the sampling filter), SoVITS (latent extraction, the mel style encoder,
the MRTE text encoder on short and long texts, the speaker-conditioned
HiFiGAN generator with padded-frame masking, bucketed ``sovits_decode``),
``pipelines.clone_tts``/``clone_tts_long`` and the text frontend, on the
CPU at test widths. One parameter tree in the bundle layout from the
port's numpy inits (shapes held to the JAX inits'), the flows' zero
``post`` convs perturbed and the AR's EOS column set near its favourite
token's (so that EOS is drawn mid-decode); inputs from a seeded numpy
generator; the prior's normal draw fed as ``jax.random.normal`` makes it.
The JAX functions run under ``jax.jit`` (inside the JAX pipelines too,
patched for this module only): op by op, JAX compiles each operation once
a shape, several times slower on the CPU. Tolerances (f32 on both sides, sums in other orders): logits 1e-4;
style vector, prior and text encoder 1e-5 on valid rows; waveforms 1e-4 x
the JAX waveform's peak; a bucketed decode vs the unpadded one 1e-6 x
peak; tokens, n, codes and the text frontend exactly.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vosk_tts_tpu import pipelines as jpipe
from vosk_tts_tpu.models import gpt_sovits as jg
from vosk_tts_tpu.models import hubert as jh
from vosk_tts_tpu.models import vits2 as jv
from vosk_tts_tpu.ops import attention as jatt
from vosk_tts_tpu.text import cleaner as jcleaner
from vosk_tts_tpu.text import en_g2p as jen
from vosk_tts_tpu_torch import pipelines as tpipe
from vosk_tts_tpu_torch.models import gpt_sovits as tg
from vosk_tts_tpu_torch.models import hubert as th
from vosk_tts_tpu_torch.models import vits2 as tv
from vosk_tts_tpu_torch.ops import attention as tatt
from vosk_tts_tpu_torch.text import cleaner as tcleaner
from vosk_tts_tpu_torch.text import en_g2p as ten
from vosk_tts_tpu_torch.utils.params import (ar_init, hubert_init, perturb_zero_init, sovits_init,
                                             to_port_layout, to_torch)

AR = dict(embedding_dim=32, hidden_dim=32, num_head=4, num_layers=2, vocab_size=17,
          phoneme_vocab_size=360, bert_dim=24, eos=16, ff_mult=4)
SOVITS = dict(spec_channels=65, inter_channels=32, hidden_channels=32, filter_channels=48,
              n_layers=4, upsample_initial_channel=64, upsample_rates=(4, 4),
              upsample_kernel_sizes=(16, 16), gin_channels=32, ssl_dim=16, n_codes=16,
              n_symbols=360, mrte_hidden=32, style_hidden=16)
HUBERT = dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2, intermediate_size=32,
              conv_dim=(8, 8), conv_kernel=(10, 4), conv_stride=(5, 4),
              num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=2)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


def _close_wav(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    peak = float(np.abs(want).max())
    assert peak > 1e-6
    assert float(np.abs(got - want).max()) <= rel * peak


def _shapes(tree):
    return jax.tree_util.tree_map(np.shape, tree)


_SAMPLING = ("cfg", "max_new", "min_new", "top_k", "top_p", "temperature", "repetition_penalty")
J = {"ar_infer": jax.jit(jg.ar_infer, static_argnames=_SAMPLING),
     "ar_infer_batch": jax.jit(jg.ar_infer_batch, static_argnames=_SAMPLING),
     "sovits_decode": jax.jit(jg.sovits_decode, static_argnames=("cfg", "noise_scale")),
     "hubert_apply": jax.jit(jh.hubert_apply, static_argnames=("cfg",))}


@pytest.fixture(autouse=True, scope="module")
def _jax_jit():
    """The JAX pipelines call the jitted functions while this module runs."""
    with pytest.MonkeyPatch.context() as mp:
        for name, fn in J.items():
            mp.setattr(jh if name == "hubert_apply" else jg, name, fn)
        yield


@pytest.fixture(scope="module")
def ar():
    """The AR tree with the EOS column of ``predict`` set to -0.2 x the
    column of the token the random model favours (2) plus noise: EOS then
    wins after a few steps on some inputs, never on others."""
    tcfg = tg.ARConfig(**AR)
    tree = ar_init(tcfg, seed=0)
    w = tree["predict"]["w"]
    w[:, 16] = -0.2 * w[:, 2] + 0.3 * np.random.default_rng(1).standard_normal(32).astype(np.float32)
    return jg.ARConfig(**AR), tcfg, tree, to_torch(to_port_layout(tree), "cpu")


@pytest.fixture(scope="module")
def sovits():
    tcfg = tg.SoVITSConfig(**SOVITS)
    tree = perturb_zero_init(sovits_init(tcfg, seed=2), seed=3)
    return jg.SoVITSConfig(**SOVITS), tcfg, tree, to_torch(to_port_layout(tree), "cpu")


@pytest.fixture(scope="module")
def hubert():
    tcfg = th.HubertConfig(**HUBERT)
    tree = hubert_init(tcfg, seed=4)
    return jh.HubertConfig(**HUBERT), tcfg, tree, to_torch(to_port_layout(tree), "cpu")


def _ar_inputs(seed, b=1, tx=6, t_p=4, lens=None):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 11, (b, tx))
    if lens is not None:
        for r, n in enumerate(lens):
            x[r, n:] = 0
    return x, rng.standard_normal((b, tx, 24)).astype(np.float32), rng.integers(0, 16, (b, t_p))


def test_numpy_inits_have_the_jax_shapes(ar, sovits):
    key = jax.random.PRNGKey(0)
    jcfg, _, tree, _ = ar
    assert _shapes(tree) == _shapes(jax.eval_shape(lambda k: jg.ar_init(k, jcfg), key))
    jcfg, _, tree, _ = sovits
    assert _shapes(tree) == _shapes(jax.eval_shape(lambda k: jg.sovits_init(k, jcfg), key))


# ---------------------------------------------------------------------------
# AR
# ---------------------------------------------------------------------------


def test_teacher_forced_logits_prefill_and_step(ar):
    """ar_logits vs JAX's _ar_logits (padded x and y); the prefill's logits
    and each cached step's, fed the same codes, are that pass's logits."""
    jcfg, tcfg, tree, tp = ar
    x, bert, y = _ar_inputs(5, b=2, tx=7, t_p=9)
    x_lens, y_lens = np.array([7, 5]), np.array([9, 6])
    want, _ = jax.jit(jg._ar_logits, static_argnums=1)(
        tree, jcfg, jnp.asarray(x, jnp.int32), jnp.asarray(x_lens, jnp.int32),
                            jnp.asarray(y, jnp.int32), jnp.asarray(y_lens, jnp.int32),
                            jnp.asarray(bert))
    got = tg.ar_logits(tp, tcfg, _t(x), _t(x_lens), _t(y), _t(y_lens), _t(bert))
    assert got.shape == want.shape == (2, 9, 17)
    _close(got, want, 1e-4)

    t_p = 4  # prefill over the first 4 codes, then step through the next 4
    d = tg.Decode(tp, tcfg, _t(x), _t(x_lens), _t(bert), _t(y[:, :t_p]), max_new=5, top_k=1)
    want = np.asarray(want)
    logits0 = want[:, t_p - 1].copy()
    logits0[:, jcfg.eos] = -np.inf
    _close(d.logits, logits0, 1e-4)
    for i in range(1, 5):
        d.tokens[:, i - 1] = _t(y[:, t_p + i - 1])  # teacher forcing
        d.step()
        valid = t_p + i - 1 < y_lens  # the pass masks y past y_lens; the step does not
        _close(d.logits[valid], want[valid, t_p + i - 1], 1e-4)


@pytest.mark.parametrize("seed,min_new", [(2, 0), (2, 5), (0, 0)])
def test_ar_infer_greedy(ar, seed, min_new):
    """Greedy tokens and n equal JAX's: a stop at EOS (seed 2), the same
    text with min_new past it (the EOS is written and fed back), no stop
    (seed 0)."""
    jcfg, tcfg, tree, tp = ar
    x, bert, prompts = _ar_inputs(seed)
    want, want_n = J["ar_infer"](tree, jcfg, jnp.asarray(x, jnp.int32), jnp.asarray(bert),
                                 jnp.asarray(prompts, jnp.int32), rng=jax.random.PRNGKey(1),
                                 max_new=12, min_new=min_new, top_k=1)
    got, n = tg.ar_infer(tp, tcfg, _t(x), _t(bert), _t(prompts), max_new=12, min_new=min_new,
                         top_k=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(n) == int(want_n)
    eos_at = np.flatnonzero(np.asarray(want)[0] == jcfg.eos)
    expected = {(2, 0): (3, [3] + list(range(4, 12))), (2, 5): (12, [3]), (0, 0): (12, [])}
    assert (int(n), eos_at.tolist()) == expected[seed, min_new]  # (2, 5): an EOS fed back


def test_ar_infer_padded_text(ar):
    """A text right-padded to a bucket with x_len gives the unpadded
    tokens, in both packages."""
    jcfg, tcfg, tree, tp = ar
    x, bert, prompts = _ar_inputs(1, tx=9, lens=[6])
    bert[:, 6:] = 0
    want, want_n = J["ar_infer"](tree, jcfg, jnp.asarray(x, jnp.int32), jnp.asarray(bert),
                                 jnp.asarray(prompts, jnp.int32), rng=jax.random.PRNGKey(1),
                                 max_new=12, top_k=1, x_len=6)
    got, n = tg.ar_infer(tp, tcfg, _t(x), _t(bert), _t(prompts), max_new=12, top_k=1, x_len=6)
    alone, n_alone = tg.ar_infer(tp, tcfg, _t(x[:, :6]), _t(bert[:, :6]), _t(prompts), max_new=12,
                                 top_k=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), alone.numpy())
    assert int(n) == int(want_n) == int(n_alone)


@pytest.mark.parametrize("min_new", [0, 5])
def test_ar_infer_batch_greedy(ar, min_new):
    """Batched greedy tokens and n equal JAX's (n: each row's first EOS,
    a fed-back one included) and each row's tokens equal it run alone."""
    jcfg, tcfg, tree, tp = ar
    lens = [6, 9, 4, 9]
    x, bert, prompts = _ar_inputs(0, b=4, tx=9, lens=lens)
    x[1], bert[1], prompts[1] = _ar_inputs(2, tx=9)
    want, want_n = J["ar_infer_batch"](tree, jcfg, jnp.asarray(x, jnp.int32),
                                       jnp.asarray(lens, jnp.int32), jnp.asarray(bert),
                                       jnp.asarray(prompts, jnp.int32), rng=jax.random.PRNGKey(5),
                                       max_new=12, min_new=min_new, top_k=1)
    got, n = tg.ar_infer_batch(tp, tcfg, _t(x), _t(lens), _t(bert), _t(prompts), max_new=12,
                               min_new=min_new, top_k=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(n.numpy(), np.asarray(want_n))
    assert len(set(n.tolist())) > 1  # rows stop at different steps
    for r, length in enumerate(lens):
        alone, _ = tg.ar_infer(tp, tcfg, _t(x[r:r + 1]), _t(bert[r:r + 1]), _t(prompts[r:r + 1]),
                               max_new=12, min_new=min_new, top_k=1, x_len=length)
        np.testing.assert_array_equal(got[r].numpy(), alone[0].numpy())


def test_steps_after_every_row_stopped_change_nothing(ar):
    """On the card the host reads the stop flags every CHECK_EVERY tokens,
    so up to CHECK_EVERY - 1 steps run after the last row stopped: they
    leave the tokens and the stop steps as they were."""
    _, tcfg, _, tp = ar
    x, bert, prompts = _ar_inputs(2, b=2)
    d = tg.Decode(tp, tcfg, _t(x), _t([6, 4]), _t(bert), _t(prompts), max_new=40, top_k=1)
    tokens, stop = (t.clone() for t in d.run())
    assert bool(d.done.all()) and int(d.i) < 40 - tg.CHECK_EVERY
    for _ in range(tg.CHECK_EVERY - 1):
        d.step()
    assert torch.equal(d.tokens, tokens) and torch.equal(d.stop, stop)


def _filter_numpy(logits, prev_mask, top_k, top_p, repetition_penalty, temperature):
    """gpt_sovits.py:251-273's filter, transcribed to numpy."""
    logits = logits.astype(np.float32)
    if repetition_penalty != 1.0:
        pen = np.where(logits < 0, logits * repetition_penalty, logits / repetition_penalty)
        logits = np.where(prev_mask, pen, logits).astype(np.float32)
    if top_p < 1.0:
        order = np.argsort(-logits, kind="stable")
        s = logits[order].astype(np.float64)
        p = np.exp(s - s.max())
        remove_sorted = np.cumsum(p / p.sum()) > top_p
        remove_sorted[0] = False
        remove = np.zeros_like(remove_sorted)
        remove[order] = remove_sorted
        logits = np.where(remove, -np.inf, logits)
    logits = logits / max(temperature, 1e-5)
    if top_k > 0:
        logits = np.where(logits < np.sort(logits)[-top_k], -np.inf, logits)
    return logits.astype(np.float32)


@pytest.mark.parametrize("top_k,top_p,penalty,temperature",
                         [(15, 1.0, 1.35, 1.0), (5, 0.6, 1.35, 0.7), (0, 0.8, 1.0, 1.3),
                          (1, 1.0, 1.35, 1.0)])
def test_sampling_filter_and_draws(top_k, top_p, penalty, temperature):
    """The port's filtered logits equal a numpy transcription of the JAX
    filter (the same -inf support; finite values within 1e-6), and each of
    500 JAX draws lies in the port's support."""
    rng = np.random.default_rng(top_k)
    logits = (rng.standard_normal((3, 40)) * 2).astype(np.float32)
    logits[0, 7] = logits[0, 3]  # a tie
    prev = rng.random((3, 40)) < 0.3
    kw = dict(top_k=top_k, top_p=top_p, repetition_penalty=penalty, temperature=temperature)
    got = tg.filter_logits(_t(logits), _t(prev), **kw).numpy()
    for r in range(3):
        want = _filter_numpy(logits[r], prev[r], top_k, top_p, penalty, temperature)
        np.testing.assert_array_equal(np.isfinite(got[r]), np.isfinite(want))
        _close(got[r][np.isfinite(want)], want[np.isfinite(want)], 1e-6)
        draw = jax.vmap(lambda k: jg.sample_logits(k, jnp.asarray(logits[r]), jnp.asarray(prev[r]),
                                                   **kw))
        draws = np.asarray(draw(jax.random.split(jax.random.PRNGKey(r), 500)))
        assert np.isfinite(got[r][draws]).all()
        g = tg.gumbel((500, 40), torch.Generator().manual_seed(r), "cpu")
        ours = tg.sample_logits(_t(logits[r]).expand(500, -1), _t(prev[r]).expand(500, -1), g, **kw)
        assert np.isfinite(got[r][ours.numpy()]).all()


# ---------------------------------------------------------------------------
# SoVITS
# ---------------------------------------------------------------------------


def test_extract_latent_and_style_encoder(sovits):
    jcfg, tcfg, tree, tp = sovits
    rng = np.random.default_rng(6)
    ssl = rng.standard_normal((2, 37, 16)).astype(np.float32)
    want = jax.jit(jg.sovits_extract_latent, static_argnums=1)(tree, jcfg, ssl)
    got = tg.sovits_extract_latent(tp, tcfg, _t(ssl))
    assert got.shape == want.shape == (2, 18)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    spec = rng.standard_normal((2, 30, 65)).astype(np.float32)
    mask = (np.arange(30)[None, :] < np.array([[30], [21]])).astype(np.float32)[..., None]
    want = jax.jit(jg.mel_style_encoder_apply, static_argnums=1)(tree["ref_enc"], jcfg,
                                                                spec * mask, mask)
    got = tg.mel_style_encoder_apply(tp["ref_enc"], tcfg, _t(spec * mask), _t(mask))
    assert got.shape == want.shape == (2, 32)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("phones", [5, 20])
def test_text_encoder_with_mrte(sovits, phones):
    """The prior on valid rows, texts of 5 phones (below 2w+1 = 9: JAX's
    unbanded relative path) and 20, codes of two lengths in one batch; and
    MRTE's cross-attention alone."""
    jcfg, tcfg, tree, tp = sovits
    rng = np.random.default_rng(phones)
    t_q = 24
    q = rng.standard_normal((2, t_q, 16)).astype(np.float32)
    y_len = np.array([24, 17], np.int32)
    text = rng.integers(0, 360, (2, phones))
    t_len = np.array([phones, phones - 2], np.int32)
    ge = rng.standard_normal((2, 32)).astype(np.float32)
    _, m_j, logs_j, mask_j = jax.jit(jg._sovits_enc_p, static_argnums=(1, 4))(
        tree["enc_p"], jcfg, q, y_len, t_q, text, t_len, ge)
    _, m_t, logs_t, mask_t = tg._sovits_enc_p(tp["enc_p"], tcfg, _t(q), _t(y_len), _t(text),
                                              _t(t_len), _t(ge))
    _close(mask_t, mask_j, 0)
    mask = np.asarray(mask_j)
    _close(m_t.numpy() * mask, np.asarray(m_j) * mask, 1e-5)
    _close(logs_t.numpy() * mask, np.asarray(logs_j) * mask, 1e-5)

    c = rng.standard_normal((2, phones, 32)).astype(np.float32)
    x = rng.standard_normal((2, t_q, 32)).astype(np.float32)
    am = (mask[:, :, 0][:, :, None] * (np.arange(phones)[None, :] < t_len[:, None])[:, None, :])
    want = jax.jit(jatt.mha_apply, static_argnames="n_heads")(
        tree["enc_p"]["mrte"]["attn"], x, c, am[:, None], n_heads=4)
    got = tatt.mha_apply(tp["enc_p"]["mrte"]["attn"], _t(x), _t(c), _t(am[:, None]), n_heads=4)
    _close(got, want, 1e-5)


def test_mha_refuses_unported_forms():
    """Banded cross-attention raises (windowless self-attention is ported:
    tests/test_torch_vits2_variants.py)."""
    x, c = torch.zeros(1, 4, 8), torch.zeros(1, 3, 8)
    with pytest.raises(NotImplementedError, match="ported"):
        tatt.mha_apply({}, x, c, n_heads=2, window_size=4)


def test_hifigan_generator_with_speaker_and_lengths(sovits):
    jcfg, tcfg, tree, tp = sovits
    rng = np.random.default_rng(7)
    z = rng.standard_normal((2, 20, 32)).astype(np.float32)
    g = rng.standard_normal((2, 1, 32)).astype(np.float32)
    lengths = np.array([20, 13], np.int32)
    want, _ = jax.jit(jv.generator_apply, static_argnums=1)(tree["dec"], jcfg.as_vits2(), z, g,
                                                           x_lengths=lengths)
    got, got_mb = tv.generator_apply(tp["dec"], tcfg.as_vits2(), _t(z), _t(g),
                                     x_lengths=_t(lengths))
    assert got_mb is None
    assert got.shape == (2, 20 * 16, 1)
    for r, n in enumerate(lengths * 16):
        _close_wav(got[r, :n], np.asarray(want)[r, :n])


def test_sovits_decode(sovits):
    """Bucketed codes vs JAX with the prior's draw fed, and vs the port's
    own unpadded decode (1e-6 x peak on the valid samples). The shapes are
    clone_tts's; the codes past n are EOS (one past the codebook), as an AR
    row that stopped leaves them."""
    jcfg, tcfg, tree, tp = sovits
    rng = np.random.default_rng(8)
    n, bucket = 23, 32
    codes = rng.integers(0, 16, (1, bucket))
    codes[:, n:] = 16
    text = rng.integers(0, 360, (1, 16))
    refer = rng.standard_normal((1, 25, 65)).astype(np.float32)
    args = lambda f, c: (f(c), f(text), f(np.array([16], np.int32)), f(refer),
                         f(np.array([25], np.int32)))
    key = jax.random.PRNGKey(9)
    want = J["sovits_decode"](tree, jcfg, *args(jnp.asarray, codes), rng=key, noise_scale=0.5,
                              code_lengths=jnp.asarray([n], jnp.int32))
    noise = np.asarray(jax.random.normal(key, (1, 2 * bucket, 32), jnp.float32))
    got = tg.sovits_decode(tp, tcfg, *args(_t, codes), noise=_t(noise), noise_scale=0.5,
                           code_lengths=_t(np.array([n], np.int32)))
    upf = tg.upsample_factor(tcfg)
    assert upf == jg.upsample_factor(jcfg) == 32 and got.shape == (1, bucket * upf)
    _close_wav(got[:, :n * upf], np.asarray(want)[:, :n * upf])
    exact = tg.sovits_decode(tp, tcfg, *args(_t, codes[:, :n]), noise=_t(noise[:, :2 * n]),
                             noise_scale=0.5)
    _close_wav(got[:, :n * upf], exact, rel=1e-6)


# ---------------------------------------------------------------------------
# Pipelines
# ---------------------------------------------------------------------------


def test_clone_tts(ar, sovits, hubert):
    """max_new 32, so that the codes fill the 32-code bucket."""
    ja, ta, atree, ap = ar
    js, ts, stree, sp = sovits
    jh_cfg, th_cfg, htree, hp = hubert
    rng = np.random.default_rng(10)
    phonemes = rng.integers(0, 300, 16)
    bert = rng.standard_normal((16, 24)).astype(np.float32)
    ref_wav = (rng.standard_normal(8000) * 0.1).astype(np.float32)
    ref_spec = rng.standard_normal((25, 65)).astype(np.float32)
    want, want_n = jpipe.clone_tts(atree, ja, stree, js, htree, jh_cfg, phonemes, bert, ref_wav,
                                   ref_spec, rng=jax.random.PRNGKey(3), top_k=1, max_new=32,
                                   noise_scale=0.0)
    got, n = tpipe.clone_tts(ap, ta, sp, ts, hp, th_cfg, phonemes, bert, ref_wav, ref_spec,
                             device="cpu", top_k=1, max_new=32, noise_scale=0.0)
    assert n == want_n and got.dtype == np.float32
    _close_wav(got, want)


def test_clone_tts_long(ar, sovits, hubert):
    """Five sentences (a short one merged into its successor) with a prompt
    text, max_batch 4: the three short chunks decode as one group padded to
    four rows (the pad row repeats row 0), the long one alone, in both
    stages; the audio is joined in text order."""
    ja, ta, atree, ap = ar
    js, ts, stree, sp = sovits
    jh_cfg, th_cfg, htree, hp = hubert
    rng = np.random.default_rng(11)
    ref_wav = (rng.standard_normal(3200) * 0.1).astype(np.float32)  # + 0.3 s: clone_tts's shape
    ref_spec = rng.standard_normal((25, 65)).astype(np.float32)
    text = ("Привет мир. Да. Как дела. Сегодня хорошая погода, и мы идём гулять в парк. "
            "Поезд уходит.")
    kw = dict(prompt_text="Мама мыла раму.", top_k=1, max_new=12, noise_scale=0.0, max_batch=4)
    want, want_n = jpipe.clone_tts_long(atree, ja, stree, js, htree, jh_cfg, text, ref_wav,
                                        ref_spec, frontend=jcleaner.Cleaner(),
                                        rng=jax.random.PRNGKey(4), **kw)
    got, n = tpipe.clone_tts_long(ap, ta, sp, ts, hp, th_cfg, text, ref_wav, ref_spec,
                                  frontend=tcleaner.Cleaner(), device="cpu", **kw)
    assert n == want_n and got.shape == want.shape and got.dtype == np.float32
    _close_wav(got, want)


def test_clone_entry_points_default_to_the_card(ar, sovits, hubert, monkeypatch):
    """Without a card, device=None raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    models = [m for trio in (ar, sovits, hubert) for m in (trio[3], trio[1])]
    ref = np.zeros(3200, np.float32), np.zeros((25, 65), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpipe.clone_tts(*models, np.arange(5), np.zeros((5, 24), np.float32), *ref)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpipe.clone_tts_long(*models, "Привет мир.", *ref, frontend=tcleaner.Cleaner())


# ---------------------------------------------------------------------------
# Text frontend
# ---------------------------------------------------------------------------


def test_text_frontend_equals_the_jax_copy():
    assert tcleaner.gpt_sovits_symbols() == jcleaner.gpt_sovits_symbols()
    assert len(tcleaner.gpt_sovits_symbols()) == 351
    ru = {"мир": "mj i1 r"}
    en = {"hello": ["HH", "AH0", "L", "OW1"], "world": ["W", "ER1", "L", "D"]}
    jc, tc = jcleaner.Cleaner(ru_dict=ru, en_extra=en), tcleaner.Cleaner(ru_dict=ru, en_extra=en)
    cases = [("Привет, мир! Съешь ещё этих булок.", "ru"), ("Hello world: the cat's hat.", "en"),
             ("Snowboarding zyxwvut quizzically brr", "en"), ("hello", "zh")]
    for text, lang in cases:
        assert tc.clean_text(text, lang) == jc.clean_text(text, lang)
        assert tc.to_ids(tc.clean_text(text, lang)[0]) == jc.to_ids(jc.clean_text(text, lang)[0])
    for word in ("zyxwvut", "quizzically", "photosynthesis", "brr", "xylophonist's"):
        assert ten.EnglishG2P().word_phones(word) == jen.EnglishG2P().word_phones(word)
    assert ten.EnglishG2P()._neural() is not None  # the OOV words above went through it
    for text in ("Один. Два. Три четыре. Пять.", "Да. Нет. Может быть, завтра.", "Без точки",
                 "\nПривет.\n"):
        assert tpipe.cut_text(text) == jpipe.cut_text(text)
    assert tpipe.bucket_len(33, tpipe.CODE_BUCKETS) == jpipe.bucket_len(33, jpipe.CODE_BUCKETS)
    assert (tpipe.CODE_BUCKETS, tpipe.PHONE_BUCKETS, tpipe.SPLITS) == \
        (jpipe.CODE_BUCKETS, jpipe.PHONE_BUCKETS, jpipe.SPLITS)


def test_neural_g2p_artifact_is_a_byte_identical_copy():
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    a = (root / "vosk_tts_tpu" / "text" / "g2p_en_lstm.npz").read_bytes()
    b = (root / "vosk_tts_tpu_torch" / "text" / "g2p_en_lstm.npz").read_bytes()
    assert a == b and len(a) > 1_000_000
