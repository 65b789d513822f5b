"""A parameter that no loss reaches decays as under optax, in every AdamW trainer.

torch's AdamW skips a parameter whose ``.grad`` is None; optax's ``adamw``
gives it a zero gradient, whose update is the decay ``-lr * wd * p`` alone.
The port's trainers give such a parameter a zero gradient before each step
(``vits2_train.fill_missing_grads``).

* Two port steps against two JAX steps of a 2-layer, speaker-conditioned
  VITS2 (its text encoder's ``spk_emb`` joins at layer 2, which does not
  exist, so no loss reaches it): every leaf whose JAX gradient is exactly
  0 in both steps ends within 1e-6 relative (to the JAX value's largest
  magnitude) of the JAX leaf. The learning rate is 1e-2, so two steps
  decay such a leaf by 2e-4 relative.
* For each AdamW trainer (VITS2 G, D, durD; QuickVC G, D; GPT-SoVITS S1
  with AdamW, S2 G, D), no parameter of an optimizer has ``grad is None``
  when its step runs (a step pre-hook on every optimizer), at small widths
  on the CPU.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from vosk_tts_tpu.models import vits2 as jv
from vosk_tts_tpu.train import vits2_train as jt
from vosk_tts_tpu_torch.models import gpt_sovits as tg
from vosk_tts_tpu_torch.models import quickvc as tq
from vosk_tts_tpu_torch.models import vits2 as tv
from vosk_tts_tpu_torch.train import gpt_sovits_train as tgt
from vosk_tts_tpu_torch.train import vc_train as tvc
from vosk_tts_tpu_torch.train import vits2_train as tt
from vosk_tts_tpu_torch.utils import params as P
from vosk_tts_tpu_torch.utils.checkpoint import _flatten

# the shipped flags at small widths, with 2 text-encoder layers: spk_emb unreached
CFG = dict(n_vocab=20, spec_channels=80, segment_size=8, inter_channels=32, hidden_channels=32,
           filter_channels=64, n_layers=2, upsample_initial_channel=64, n_speakers=4,
           gin_channels=16, n_flows=1, posterior_wn_layers=4, sdp_n_flows=1)
TRAIN = dict(disc_periods=(3,), disc_spec_ffts=(256,), learning_rate=1e-2)
B, TX, TF, HOP = 2, 12, 40, 256
X_LENGTHS, MEL_LENGTHS = (12, 9), (40, 31)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def _t(a):
    return torch.tensor(np.asarray(a))


def _mask(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]


def _batch(seed):
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((B, TF * HOP)) * 0.3).astype(np.float32)
    for i, n in enumerate(MEL_LENGTHS):
        wav[i, n * HOP:] = 0.0
    mel = rng.standard_normal((B, TF, 80)).astype(np.float32) * _mask(MEL_LENGTHS, TF)
    return {"x": rng.integers(1, 20, size=(B, TX)).astype(np.int32),
            "x_lengths": np.asarray(X_LENGTHS, np.int32), "mel": mel,
            "mel_lengths": np.asarray(MEL_LENGTHS, np.int32), "wav": wav,
            "sid": np.asarray([1, 3], np.int32)}


def _port_batch(batch):
    return {k: _t(v).long() if k in ("x", "sid") else _t(v) for k, v in batch.items()}


def _jax_noise(key, cfg):
    """forward_train's draws from ``key``, as the JAX package makes them
    (tests/test_torch_train.py)."""
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


def _vits2_trees(jcfg, tcfg):
    return {"g": P.perturb_zero_init(P.synthesizer_init(jcfg, 0), seed=3),
            "d": P.mpmsd_init(1, tuple(tcfg.disc_periods), tuple(tcfg.disc_spec_ffts)),
            "dur": P.duration_disc_init(2, jcfg.hidden_channels, jcfg.hidden_channels, 3)}


def test_unreached_leaf_decays_as_optax():
    """Two VITS2 steps, JAX and the port, from the same trees, batches and
    draws: the leaves no loss reaches (JAX gradient exactly 0 in both
    steps; the text encoder's ``spk_emb`` among them) end equal to JAX's,
    which moved from their initial values."""
    jcfg, jtcfg = jv.VITS2Config(**CFG), jt.TrainConfig(**TRAIN)
    trees = _vits2_trees(jcfg, jtcfg)
    batches = [_batch(0), _batch(1)]
    keys = [jax.random.PRNGKey(1), jax.random.PRNGKey(2)]
    make = jt.make_optimizer
    jt.make_optimizer = _recording(make)
    try:
        step, opt = jax.jit(jt.make_train_step(jcfg, jtcfg)), jt.make_optimizer(jtcfg)
        state = {"step": jnp.zeros((), jnp.int32),
                 **{f"params_{k}": v for k, v in trees.items()},
                 **{f"opt_{k}": opt.init(v) for k, v in trees.items()}}
        zero = {k: None for k in trees}
        for batch, key in zip(batches, keys):
            state, _ = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
            for k in trees:
                flat = _flatten(jax.device_get(state[f"opt_{k}"][1]))
                now = {p for p, g in flat.items() if not np.any(g)}
                zero[k] = now if zero[k] is None else zero[k] & now
    finally:
        jt.make_optimizer = make
    want = {k: _flatten(jax.device_get(state[f"params_{k}"])) for k in trees}

    tstate = tt.init_train_state(tv.VITS2Config(**CFG), tt.TrainConfig(**TRAIN), device="cpu",
                                 trees={k: P.to_port_layout(v) for k, v in trees.items()})
    tstep = tt.make_train_step(tv.VITS2Config(**CFG), tt.TrainConfig(**TRAIN))
    for batch, key in zip(batches, keys):
        tstep(tstate, _port_batch(batch),
              noise={k: _t(v) for k, v in _jax_noise(key, jcfg).items()})

    assert any("enc_p" in p and "spk_emb" in p for p in zero["g"]), sorted(zero["g"])
    init = {k: _flatten(v) for k, v in trees.items()}
    for k in trees:
        got = _flatten(P.from_port_layout(tstate.params[k].numpy_tree(), P.LINEARS))
        for path in sorted(zero[k]):
            w = want[k][path]
            scale = float(np.abs(w).max())
            assert scale > 0, path
            moved = float(np.abs(w - init[k][path]).max())
            assert moved > 1e-5 * scale, (k, path, moved, scale)  # decayed: 2e-4 relative
            err = float(np.abs(got[path] - w).max())
            assert err <= 1e-6 * scale, (k, path, err, scale)


# ---------------------------------------------------------------------------
# No optimizer steps over a parameter without a gradient
# ---------------------------------------------------------------------------


def _no_missing_grads(state):
    """A step pre-hook on each optimizer of ``state``: records the names of
    the optimizers that stepped and fails a step over a None gradient."""
    stepped = []

    def hook(name):
        def check(opt, args, kwargs):
            missing = sum(p.grad is None for g in opt.param_groups for p in g["params"])
            assert missing == 0, f"{name}: {missing} parameters without a gradient"
            stepped.append(name)
        return check

    for name, opt in state.opt.items():
        opt.register_step_pre_hook(hook(name))
    return stepped


def test_vits2_steps_see_every_gradient():
    mcfg, tcfg = tv.VITS2Config(**CFG), tt.TrainConfig(**TRAIN)
    state = tt.init_train_state(mcfg, tcfg, device="cpu",
                                trees={k: P.to_port_layout(v)
                                       for k, v in _vits2_trees(mcfg, tcfg).items()})
    stepped = _no_missing_grads(state)
    tt.make_train_step(mcfg, tcfg)(state, _port_batch(_batch(0)),
                                   generator=torch.Generator().manual_seed(0))
    assert stepped == ["d", "dur", "g"]


VC_SR, VC_HOP, VC_FILT, VC_MEL, VC_T = 3200, 32, 128, 20, 24
QUICKVC = dict(spec_channels=VC_FILT // 2 + 1, n_mel_channels=VC_MEL, segment_size=8,
               inter_channels=16, hidden_channels=16, ssl_dim=8, gin_channels=16,
               resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
               upsample_rates=(2,), upsample_initial_channel=32, upsample_kernel_sizes=(4,))


def test_vc_steps_see_every_gradient():
    mcfg = tq.QuickVCConfig(**QUICKVC)
    tcfg = tvc.VCTrainConfig(sampling_rate=VC_SR, filter_length=VC_FILT, hop_length=VC_HOP,
                             win_length=VC_FILT, n_mel_channels=VC_MEL)
    state = tvc.init_train_state(mcfg, tcfg, seed=0, device="cpu")
    stepped = _no_missing_grads(state)
    rng = np.random.default_rng(0)
    batch = {"c": rng.standard_normal((B, VC_T, 8)),
             "spec": np.abs(rng.standard_normal((B, VC_T, QUICKVC["spec_channels"]))),
             "mel": rng.standard_normal((B, VC_T, VC_MEL)) - 3,
             "wav": rng.standard_normal((B, VC_T * VC_HOP)) * 0.3}
    tvc.make_train_step(mcfg, tcfg)(state, {k: _t(v.astype(np.float32)) for k, v in batch.items()},
                                    generator=torch.Generator().manual_seed(0))
    assert stepped == ["d", "g"]


AR = dict(embedding_dim=32, hidden_dim=32, num_head=4, num_layers=2, vocab_size=17,
          phoneme_vocab_size=64, bert_dim=8, eos=16)


def test_s1_adamw_step_sees_every_gradient():
    mcfg = tg.ARConfig(**AR)
    tcfg = tgt.S1TrainConfig(optimizer="adamw", learning_rate=1e-3, warmup_steps=0,
                             total_steps=100)
    state = tgt.init_s1_state(mcfg, tcfg, seed=0, device="cpu")
    stepped = _no_missing_grads(state)
    rng = np.random.default_rng(1)
    batch = {"x": _t(rng.integers(0, 64, (B, 10))).long(),
             "x_lengths": torch.tensor([10, 7]), "y": _t(rng.integers(0, 16, (B, 12))).long(),
             "y_lengths": torch.tensor([12, 9]),
             "bert": _t(rng.standard_normal((B, 10, 8)).astype(np.float32))}
    tgt.make_s1_step(mcfg, tcfg)(state, batch)
    assert stepped == ["ar"]


S2_SR, S2_HOP, S2_FILT, S2_MEL, S2_TF, S2_TT = 3200, 32, 128, 20, 24, 12
SOVITS = dict(spec_channels=S2_FILT // 2 + 1, segment_size=8, inter_channels=16,
              hidden_channels=16, filter_channels=32, n_heads=2, n_layers=2,
              resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
              upsample_rates=(4, 4, 2), upsample_initial_channel=32,
              upsample_kernel_sizes=(8, 8, 4), gin_channels=16, ssl_dim=16, n_codes=16,
              n_symbols=64, mrte_hidden=16, style_hidden=8)


def test_s2_steps_see_every_gradient():
    mcfg = tg.SoVITSConfig(**SOVITS)
    tcfg = tgt.S2TrainConfig(sampling_rate=S2_SR, filter_length=S2_FILT, hop_length=S2_HOP,
                             win_length=S2_FILT, n_mel_channels=S2_MEL)
    state = tgt.init_s2_state(mcfg, tcfg, seed=0, device="cpu")
    stepped = _no_missing_grads(state)
    rng = np.random.default_rng(2)
    batch = {"ssl": _t(rng.standard_normal((B, S2_TF, 16)).astype(np.float32)),
             "spec": _t(np.abs(rng.standard_normal((B, S2_TF, SOVITS["spec_channels"])))
                        .astype(np.float32)),
             "spec_lengths": torch.tensor([S2_TF, 19]),
             "text": _t(rng.integers(1, 60, (B, S2_TT))).long(),
             "text_lengths": torch.tensor([S2_TT, 7]),
             "wav": _t((rng.standard_normal((B, S2_TF * S2_HOP)) * 0.3).astype(np.float32))}
    tgt.make_s2_step(mcfg, tcfg)(state, batch, generator=torch.Generator().manual_seed(0))
    assert stepped == ["d", "g"]
