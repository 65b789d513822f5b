"""GPT-SoVITS stage-1 training (the AR) of the PyTorch port vs the JAX package,
on the CPU.

A narrow AR (2 layers x 32, 4 heads, 17 codes with EOS 16, 64 phones, 8-dim
BERT rows) from the port's numpy ``ar_init`` (shapes held to the JAX init's
by ``jax.eval_shape``), inputs from a seeded numpy generator with padded
text and code rows. The JAX references run under ``jax.jit``; the DPO
spans are the JAX ``randint`` draws, fed to the port as ``ids=``.

Tolerances (f32 on both sides, sums in other orders):

* ``ar_forward_train``'s and ``ar_forward_train_dpo``'s loss 1e-5
  relative, the accuracy equal; ``make_reject_y`` equal; ``dpo_loss`` 1e-6
  relative;
* the DPO term of ``ar_forward_train_dpo`` on its own (~1e-3 of the loss,
  under the loss's 1e-5): the chosen and rejected rows' log-probability
  sums it is given 1e-5 relative, the term 1e-4 relative, its gradient in
  every tensor within 1e-4 of the largest;
* ScaledAdam against the JAX ``scaled_adam`` over 10 steps with
  ``clipping_update_period`` 4 (threshold refreshes at steps 4 and 8, the
  clip biting on two grown gradients, size updates at steps 3 and 7, a
  parameter above ``param_max_rms``, zero biases below ``param_min_rms``,
  a scalar above ``scalar_max``): every leaf within 1e-5 of its largest
  magnitude after each step, the threshold within 1e-5 relative;
* ``warmup_cosine_lr``, locked and nominal: 1e-6 relative;
* one S1 step (ScaledAdam, AdamW, DPO): the loss 1e-5 relative, the
  accuracy equal, every parameter within 1e-5 of its largest magnitude
  plus 1e-7, save the key third of each qkv bias: its gradient is 0 in
  exact arithmetic, and a first step on its float noise moves it by up
  to lr x 0.1 x 1e-5 (ScaledAdam, within the 1e-7) or lr (AdamW, held to
  2 lr);
* ``S1Dataset`` batches through ``ShuffleBatcher``: equal to the JAX
  package's; the driver on the CPU for 2 steps, STATE_2 restored into a
  zeroed state exactly (parameters, ScaledAdam state), the bundle-layout
  ``AR_2.npz`` loaded back by ``to_port_layout`` equal to the state's tree,
  a resumed run's step 3.
"""

import hashlib
import json

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from vosk_tts_tpu.models import gpt_sovits as jg
from vosk_tts_tpu.train import gpt_sovits_data as jdata
from vosk_tts_tpu.train import gpt_sovits_train as jtrain
from vosk_tts_tpu.train import scaled_adam as jsa
from vosk_tts_tpu_torch.models import gpt_sovits as tg
from vosk_tts_tpu_torch.train import gpt_sovits_data as tdata
from vosk_tts_tpu_torch.train import gpt_sovits_train as ttrain
from vosk_tts_tpu_torch.train import run_gpt_sovits as trun
from vosk_tts_tpu_torch.train import scaled_adam as tsa
from vosk_tts_tpu_torch.train.driver_common import resume_state
from vosk_tts_tpu_torch.utils import params as P
from vosk_tts_tpu_torch.utils.checkpoint import _flatten, load_params

AR = dict(embedding_dim=32, hidden_dim=32, num_head=4, num_layers=2, vocab_size=17,
          phoneme_vocab_size=64, bert_dim=8, eos=16)
B, TX, TY = 3, 10, 12
X_LENS, Y_LENS = (10, 7, 4), (12, 9, 5)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def _t(a):
    return torch.tensor(np.asarray(a))


def _rel(got, want, tol, what="", atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale + atol + 1e-30, (what, err, scale)
    return err / max(scale, 1e-30)


@pytest.fixture(scope="module")
def ar():
    tree = P.ar_init(tg.ARConfig(**AR), seed=0)
    want = jax.eval_shape(lambda k: jg.ar_init(k, jg.ARConfig(**AR)), jax.random.PRNGKey(0))
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    assert jax.tree.map(np.shape, tree) == jax.tree.map(lambda a: a.shape, want)
    return tree


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    x = rng.integers(1, 60, (B, TX)).astype(np.int32)
    y = rng.integers(0, 16, (B, TY)).astype(np.int32)
    for i in range(B):
        x[i, X_LENS[i]:] = 0
        y[i, Y_LENS[i]:] = 16  # the dataset pads codes with EOS
    return {"x": x, "x_lengths": np.array(X_LENS, np.int32), "y": y,
            "y_lengths": np.array(Y_LENS, np.int32),
            "bert": rng.standard_normal((B, TX, 8)).astype(np.float32)}


def _args(tree, b, torch_side):
    keys = ("x", "x_lengths", "y", "y_lengths", "bert")
    if torch_side:
        return (P.to_torch(P.to_port_layout(tree), "cpu"), tg.ARConfig(**AR),
                *(_t(b[k]).long() if k != "bert" else _t(b[k]) for k in keys))
    return (tree, jg.ARConfig(**AR), *(jnp.asarray(b[k]) for k in keys))


def test_ar_forward_train(ar, batch):
    jloss, jacc = jax.jit(jg.ar_forward_train, static_argnums=1)(*_args(ar, batch, False))
    with torch.no_grad():
        loss, acc = tg.ar_forward_train(*_args(ar, batch, True))
    _rel(loss, jloss, 1e-5, "loss")
    assert float(acc) == float(jacc)


def test_make_reject_y_and_dpo_loss(batch):
    key = jax.random.PRNGKey(3)
    jr, jl = jax.jit(jg.make_reject_y)(key, jnp.asarray(batch["y"]),
                                       jnp.asarray(batch["y_lengths"]))
    ids = np.asarray(jax.random.randint(key, (B, 2), 0, TY))
    assert len({tuple(sorted(r)) for r in ids}) == B  # three different spans
    r, rl = tg.make_reject_y(_t(batch["y"]).long(), _t(batch["y_lengths"]).long(), ids=_t(ids))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(rl.numpy(), np.asarray(jl))
    rng = np.random.default_rng(4)
    a, b = (rng.standard_normal(5).astype(np.float32) * 20 for _ in range(2))
    _rel(tg.dpo_loss(_t(a), _t(b)), jg.dpo_loss(jnp.asarray(a), jnp.asarray(b)), 1e-6, "dpo")


def test_ar_forward_train_dpo(ar, batch):
    key = jax.random.PRNGKey(5)
    jloss, jacc = jax.jit(jg.ar_forward_train_dpo, static_argnums=1)(*_args(ar, batch, False),
                                                                     rng=key)
    ids = _t(jax.random.randint(key, (B, 2), 0, TY))
    with torch.no_grad():
        loss, acc = tg.ar_forward_train_dpo(*_args(ar, batch, True), ids=ids)
    _rel(loss, jloss, 1e-5, "dpo loss")
    assert float(acc) == float(jacc)


def _tensor_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _tensor_leaves(sub, f"{prefix}{name}/").items()}
    if isinstance(tree, (list, tuple)):
        return _tensor_leaves(dict(enumerate(tree)), prefix)
    return {prefix.rstrip("/"): tree}


def test_dpo_term_against_jax(ar, batch, monkeypatch):
    """The DPO term alone: beside the summed CE it is ~1e-3 of the loss,
    below the loss's tolerance, so its inputs and gradient are held here."""
    key = jax.random.PRNGKey(5)

    def jterm(tree, x, xl, y, yl, bert):
        cfg = jg.ARConfig(**AR)
        chosen = jg._batch_logps(*jg._ar_logits(tree, cfg, x, xl, y, yl, bert))
        r_y, r_lens = jg.make_reject_y(key, y, yl)
        rejected = jg._batch_logps(*jg._ar_logits(tree, cfg, x, xl, r_y, r_lens, bert))
        return jg.dpo_loss(chosen, rejected, beta=0.2), (chosen, rejected)

    tree, _, *inputs = _args(ar, batch, False)
    (jval, (jchosen, jrej)), jgrad = jax.device_get(
        jax.jit(jax.value_and_grad(jterm, has_aux=True))(tree, *inputs))
    seen, dpo_loss = [], tg.dpo_loss

    def recording(chosen, rejected, beta=0.2):
        seen.append((chosen, rejected))
        return dpo_loss(chosen, rejected, beta)

    monkeypatch.setattr(tg, "dpo_loss", recording)
    params, *rest = _args(ar, batch, True)
    leaves = _tensor_leaves(params)
    for p in leaves.values():
        p.requires_grad_(True)
    tg.ar_forward_train_dpo(params, *rest, ids=_t(jax.random.randint(key, (B, 2), 0, TY)))
    (chosen, rejected), = seen
    # per-row sums of 12 (chosen) and 24 (rejected) log-probabilities of ~-2.8:
    # one wrong target or mask moves a row by ~3, the f32 sums agree to ~1e-6
    _rel(chosen, jchosen, 1e-5, "chosen logps")
    _rel(rejected, jrej, 1e-5, "rejected logps")
    term = dpo_loss(chosen, rejected)
    _rel(term, jval, 1e-4, "dpo term")
    grads = dict(zip(leaves, torch.autograd.grad(term, list(leaves.values()),
                                                 allow_unused=True)))
    want = _flatten(P.to_port_layout(jgrad))
    assert set(grads) == set(want)
    top = max(float(np.abs(v).max()) for v in want.values())
    worst = 0.0
    for k, g in grads.items():  # every tensor within 1e-4 of the term's largest gradient
        g = torch.zeros(want[k].shape) if g is None else g
        err = float(np.abs(g.numpy() - want[k]).max())
        assert err <= 1e-4 * top, (k, err, top)
        worst = max(worst, err / top)
    print(f"DPO term {float(term.detach()):.3e}: worst gradient {worst:.3e} "
          f"of the largest ({top:.3e})")


# ---------------------------------------------------------------------------
# ScaledAdam and its schedule
# ---------------------------------------------------------------------------


def test_scaled_adam_against_jax(ar):
    tree = jax.tree.map(np.copy, ar)
    tree["layers"][0]["ln1"]["gamma"] *= 5.0  # rms 5 > param_max_rms 3
    tree["audio_alpha"] = np.float32(12.0)  # clamped to scalar_max 10
    rng = np.random.default_rng(6)
    grads = []
    for i in range(10):
        scale = 8.0 if i in (5, 9) else 1.0  # the clip bites after the refresh at 4 and 8
        grads.append(jax.tree.map(
            lambda a: (rng.standard_normal(np.shape(a)) * scale).astype(np.float32), tree))
    opt = jsa.scaled_adam(learning_rate=0.01, clipping_update_period=4)
    update = jax.jit(opt.update)
    jp, jst = tree, opt.init(tree)
    leaves = P.to_torch(P.to_port_layout(tree), "cpu")
    flat = _flatten(leaves)
    params = {k: torch.nn.Parameter(_t(v)) for k, v in flat.items()}
    topt = tsa.ScaledAdam(list(params.values()), lr=0.01, clipping_update_period=4)
    for i, g in enumerate(grads):
        u, jst = update(g, jst, jp)
        jp = optax.apply_updates(jp, u)
        for k, v in _flatten(P.to_port_layout(g)).items():
            params[k].grad = _t(v)
        topt.step()
        want = _flatten(P.to_port_layout(jax.device_get(jp)))
        worst = max(_rel(params[k], want[k], 1e-5, f"step {i} {k}") for k in want)
        threshold = float(jst.model_norm_threshold)
        if i < 4:  # no refresh yet
            assert threshold == float(topt.global_state["model_norm_threshold"]) == np.inf
        else:
            _rel(topt.global_state["model_norm_threshold"], threshold, 1e-5, f"threshold {i}")
            _rel(topt.global_state["model_norms"], jst.model_norms, 1e-5, f"norms {i}")
        if i in (5, 9):  # the clip bites: this step's norm is over the threshold
            assert float(jst.model_norms[i % 4]) > threshold
    assert float(params["audio_alpha"].detach()) <= 10.0 + 0.01
    print(f"ScaledAdam: worst leaf {worst:.3e} of its max after 10 steps")


def test_warmup_cosine_lr():
    steps = np.array([0, 1, 49, 50, 51, 120, 200, 260], np.int32)
    for locked in (0.002, None):
        want = jsa.warmup_cosine_lr(0.0, 0.01, 0.002, 50, 200, locked=locked)
        got = tsa.warmup_cosine_lr(0.0, 0.01, 0.002, 50, 200, locked=locked)
        for s in steps:
            _rel(got(torch.tensor(int(s))), want(jnp.asarray(s)), 1e-6, f"{locked} {s}")


# ---------------------------------------------------------------------------
# One S1 step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["scaled_adam", "adamw", "dpo"])
def test_s1_step(ar, batch, kind):
    fields = {"if_dpo": kind == "dpo"}
    if kind == "adamw":  # no warmup: the first step's learning rate is the peak
        fields.update(optimizer="adamw", learning_rate=1e-3, warmup_steps=0, total_steps=100)
    jcfg, tcfg = jtrain.S1TrainConfig(**fields), ttrain.S1TrainConfig(**fields)
    key = jax.random.PRNGKey(7)
    jstate = {"step": jnp.zeros((), jnp.int32), "params": ar,
              "opt": jtrain.make_s1_optimizer(jcfg).init(ar)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    new, metrics = jax.device_get(jax.jit(jtrain.make_s1_step(jg.ARConfig(**AR), jcfg))(
        jstate, jb, key))
    state = ttrain.init_s1_state(tg.ARConfig(**AR), tcfg, device="cpu",
                                 tree=P.to_port_layout(ar))
    tb = {k: _t(v).long() if k != "bert" else _t(v) for k, v in batch.items()}
    noise = {"reject_ids": _t(jax.random.randint(key, (B, 2), 0, TY))}
    out = ttrain.make_s1_step(tg.ARConfig(**AR), tcfg)(state, tb, noise=noise)
    assert state.step == 1 and set(out) == set(metrics) == {"loss", "acc"}
    _rel(out["loss"], metrics["loss"], 1e-5, "loss")
    assert float(out["acc"]) == float(metrics["acc"])
    want = _flatten(P.to_port_layout(new["params"]))
    leaves = state.params["ar"].leaves()
    assert set(leaves) == set(want)
    moved = max(float(np.abs(np.asarray(want[k]) - _flatten(P.to_port_layout(ar))[k]).max())
                for k in want)
    assert moved > 0
    # the key third of each qkv bias has gradient 0 in exact arithmetic: a step
    # on its float noise moves it by at most AdamW's lr (ScaledAdam's 2e-9)
    key_atol = 2 * fields["learning_rate"] if kind == "adamw" else 1e-7
    worst = 0.0
    for k, p in leaves.items():
        if k.endswith("qkv/b"):
            d = AR["hidden_dim"]
            _rel(p[d:2 * d], want[k][d:2 * d], 1e-5, k, atol=key_atol)
            p, want[k] = torch.cat([p[:d], p[2 * d:]]), np.concatenate([want[k][:d],
                                                                        want[k][2 * d:]])
        worst = max(worst, _rel(p, want[k], 1e-5, k, atol=1e-7))
    print(f"S1 step ({kind}): worst parameter {worst:.3e} of its max")


# ---------------------------------------------------------------------------
# Data pipeline and driver
# ---------------------------------------------------------------------------

PHONES = ["p_rj_i1_vj_e0_t", "mj_i1_r", "k_a1_k", "dj_e0_l_a0", "s_o1_n"]


@pytest.fixture(scope="module")
def s1_corpus(tmp_path_factory):
    """Eight rows: six kept by the filters (BERT rows for three of them), one
    too slow (phones a second under 3), one with no codes."""
    root = tmp_path_factory.mktemp("s1_corpus")
    rng = np.random.default_rng(8)
    meta, sem = [], []
    id_map = jdata.plain_symbol_map()
    for i in range(8):
        words = [PHONES[(i + j) % len(PHONES)] for j in range(2 + i % 3)]
        aligned = " ".join(words)
        n_phones = len(jdata.text_to_ids_aligned(aligned, id_map))
        n_codes = 300 if i == 6 else int(n_phones * 25 / rng.uniform(6, 15))
        meta.append(f"wavs/u{i}.wav|0|text {i}|{aligned}")
        if i != 7:
            sem.append(f"u{i}\t" + " ".join(str(c) for c in rng.integers(0, 16, n_codes)))
        if i % 2 == 0 and i != 6:
            np.save(root / f"u{i}.bert.npy",
                    rng.standard_normal((n_phones, 8)).astype(np.float32))
    (root / "meta.csv").write_text("\n".join(meta) + "\n", encoding="utf-8")
    (root / "semantic.tsv").write_text("\n".join(sem) + "\n", encoding="utf-8")
    return root


def _dcfg(cls, root):
    return cls(metadata=str(root / "meta.csv"), semantic=str(root / "semantic.tsv"),
               wav_dir=str(root), bert_dim=8, pad_val=16)


def test_s1_dataset_and_batches(s1_corpus):
    jds, tds = jdata.S1Dataset(_dcfg(jdata.S1DataConfig, s1_corpus)), \
        tdata.S1Dataset(_dcfg(tdata.S1DataConfig, s1_corpus))
    assert len(tds) == len(jds) == 6
    assert [it[0] for it in tds.items] == [it[0] for it in jds.items]
    assert len(jdata.S1Dataset(_dcfg(jdata.S1DataConfig, s1_corpus), apply_filters=False)) == 7
    jb, tb = jdata.ShuffleBatcher(jds, 4), tdata.ShuffleBatcher(tds, 4)
    assert tb.num_batches() == jb.num_batches()
    for epoch in (0, 1):
        for got, want in zip(tb.epoch(epoch), jb.epoch(epoch), strict=True):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert np.abs(got["bert"]).sum() > 0 and (np.abs(got["bert"]).sum((1, 2)) == 0).any()


def _driver_cfg(root, **train):
    return {"data": {"metadata": str(root / "meta.csv"), "semantic": str(root / "semantic.tsv"),
                     "wav_dir": str(root)},
            "model": AR,
            "train": {"batch_size": 4, "epochs": 100, "log_interval": 1, "save_interval": 100,
                      **train}}


def _fingerprint(state):
    digest = lambda t: hashlib.sha1(t.detach().cpu().numpy().tobytes()).hexdigest()
    opt = state.opt["ar"]
    return {"step": state.step, "params": [digest(p) for p in state.params["ar"].parameters()],
            "opt": [[digest(v) for v in st.values()] for st in opt.state.values()],
            "global": [digest(v) for v in opt.global_state.values()]}


def test_s1_driver_and_resume(s1_corpus, tmp_path):
    cfg_path = tmp_path / "s1.json"
    cfg_path.write_text(json.dumps(_driver_cfg(s1_corpus)), encoding="utf-8")
    model_dir = tmp_path / "model"
    args = ["--stage", "s1", "-c", str(cfg_path), "-m", str(model_dir), "--device", "cpu"]
    first, m1 = trun.main(args + ["--max-steps", "2"])
    assert first.step == 2 and set(m1) == {"loss", "acc"} and np.isfinite(m1["loss"])
    _, mcfg, tcfg = trun.build_s1(_driver_cfg(s1_corpus))
    assert mcfg == tg.ARConfig(**AR) and tcfg == ttrain.S1TrainConfig()
    assert isinstance(first.opt["ar"], tsa.ScaledAdam)
    # the bundle-layout AR tree: to_port_layout loads it back as the state's tree
    back = _flatten(P.to_port_layout(load_params(model_dir / "AR_2.npz")))
    leaves = first.params["ar"].leaves()
    assert set(back) == set(leaves)
    for k, p in leaves.items():
        np.testing.assert_array_equal(back[k], p.detach().numpy(), err_msg=k)
    saved = _fingerprint(first)
    for p in first.params["ar"].parameters():
        p.data.zero_()
    for st in first.opt["ar"].state.values():
        for v in st.values():
            v.zero_()
    first.opt["ar"].global_state["step"].zero_()
    first.step = 0
    assert resume_state(str(model_dir), first) is not None
    assert _fingerprint(first) == saved
    resumed, m2 = trun.main(args + ["--max-steps", "3"])
    assert resumed.step == 3 and int(resumed.opt["ar"].global_state["step"]) == 3
    assert np.isfinite(m2["loss"])


def test_s1_driver_dpo_halves_the_batch(s1_corpus, tmp_path, monkeypatch):
    sizes = []

    class Recording(tdata.ShuffleBatcher):
        def collate(self, idxs, rng):
            sizes.append(len(idxs))
            return super().collate(idxs, rng)

    monkeypatch.setattr(trun, "ShuffleBatcher", Recording)
    cfg_path = tmp_path / "dpo.json"
    cfg_path.write_text(json.dumps(_driver_cfg(s1_corpus, if_dpo=True)), encoding="utf-8")
    state, metrics = trun.main(["--stage", "s1", "-c", str(cfg_path), "-m", str(tmp_path / "m"),
                                "--device", "cpu", "--max-steps", "1"])
    assert state.step == 1 and np.isfinite(metrics["loss"]) and sizes == [2]


def test_driver_needs_cuda_without_device(s1_corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg_path = tmp_path / "s1.json"
    cfg_path.write_text(json.dumps(_driver_cfg(s1_corpus)), encoding="utf-8")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trun.main(["--stage", "s1", "-c", str(cfg_path), "-m", str(tmp_path / "m")])
