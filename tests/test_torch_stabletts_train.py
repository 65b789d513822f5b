"""StableTTS/Matcha CFM training of the PyTorch port vs the JAX package, on
the CPU.

A small configuration (2 text-encoder and 2 decoder layers, widths 32-64).
The Matcha tree has the structure and shapes of the JAX ``matcha_init``
tree (checked against its ``jax.eval_shape``), drawn by the port's numpy
init with the zero-initialised adaLN-Zero projections and CFG fakes
perturbed (as initialised every DiT block is the identity). The JAX draws
of ``forward_train`` (the CFG-dropout uniform, the CFM time uniform and z)
are reproduced from the same key and fed to the port as ``noise=``; the
dropout rate is set between the two rows' uniforms, so one row takes the
learned fakes. The JAX reference is one accumulation cycle of its
``optax.MultiSteps`` step (4 micro-steps) as one jitted scan, the gradient
each micro-step gave the optimizer recorded; the first micro-step gives the
forward's losses and the gradient, the alignment is JAX's
``generate_path`` of the durations.

Tolerances (f32 on both sides, sums in other orders): ``duration_loss``,
``cfm_loss`` and ``forward_train``'s losses and alignment 1e-4 of the JAX
value's largest magnitude; one micro-step's gradients, compared in the
bundle layout through ``stabletts.bundle_layout``, 1e-3 of each tensor's
largest magnitude (the mel encoder, whose output neither loss reads,
exactly 0 on both sides; a tensor whose JAX gradient is below 1e-6 x the
tree's largest held to that floor); a 4-micro-step accumulation cycle: the
parameters unmoved (exactly) after micro-steps 1-3; after the 4th, the
whole tree within 1e-5 relative L2 of the JAX step's, the mel encoder
(read by neither loss: gradient 0) unmoved on both sides, and each element
within 0.1 lr of JAX's (AdamW's first step moves an element by at most lr,
by about lr x sign(g); where the averaged g is near AdamW's eps, or float
noise as at the unroped features of the key biases, whose gradient is 0 in
exact arithmetic, the step depends on g's last digits). The data
pipeline on the same files: equal text streams, BERT rows, durations and
batches, mels within 1e-5; ``make_bert_fn`` within 1e-5 on a tiny BERT
bundle; the driver on the CPU for one cycle, then a resume.
"""

import json
import shutil
import wave

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from vosk_tts_tpu.models import bert as jbert
from vosk_tts_tpu.models import stabletts as jst
from vosk_tts_tpu.ops import commons as jcommons
from vosk_tts_tpu.train import run_stabletts as jrun
from vosk_tts_tpu.train import stabletts_data as jdata
from vosk_tts_tpu.train import stabletts_train as jtrain
from vosk_tts_tpu_torch.models import stabletts as tst
from vosk_tts_tpu_torch.train import run_stabletts as trun
from vosk_tts_tpu_torch.train import stabletts_data as tdata
from vosk_tts_tpu_torch.train import stabletts_train as ttrain
from vosk_tts_tpu_torch.train.driver_common import resume_state
from vosk_tts_tpu_torch.utils import params as P
from vosk_tts_tpu_torch.utils.checkpoint import _flatten, _unflatten, save_params

CFG = dict(n_spks=3, spk_emb_dim=8, hidden_channels=32, filter_channels=64, n_heads=2, n_layers=2,
           phone_emb_dim=16, punc_emb_dim=2, bert_dim=16, bert_proj_dim=8, dec_hidden=32,
           dec_filter=64, dec_layers=2, dec_heads=2)
B, TX, TF = 2, 12, 40
X_LENGTHS, MEL_LENGTHS = (12, 9), (40, 31)
LR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def _t(a):
    return torch.tensor(np.asarray(a))


def _rel(got, want, tol, what="", floor=0.0):
    """max |got - want| <= tol x max |want| (+ ``floor``); returns the
    error over max |want|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale + floor + 1e-12, (what, err, scale)
    return err / max(scale, 1e-30)


def _batch():
    rng = np.random.default_rng(0)
    xm = np.arange(TX)[None, :] < np.asarray(X_LENGTHS)[:, None]
    ym = np.arange(TF)[None, :] < np.asarray(MEL_LENGTHS)[:, None]
    return {"x": (rng.integers(1, 200, (B, 5, TX)) * xm[:, None]).astype(np.int32),
            "x_lengths": np.asarray(X_LENGTHS, np.int32),
            "mel": (rng.standard_normal((B, TF, 80)) * ym[..., None]).astype(np.float32),
            "mel_lengths": np.asarray(MEL_LENGTHS, np.int32),
            "sid": np.asarray([1, 2], np.int32),
            "bert": (rng.standard_normal((B, TX, 16)) * xm[..., None]).astype(np.float32),
            "durations": (rng.integers(1, 5, (B, TX)) * xm).astype(np.int32)}


def _jax_noise(key):
    """forward_train's draws from ``key``, as the JAX package makes them
    (the time uniform before its 0.98 cut)."""
    r_cfg, r_cfm = jax.random.split(key)
    r_t, r_z = jax.random.split(r_cfm)
    return {"cfg": np.asarray(jax.random.uniform(r_cfg, (B, 1))),
            "t": np.asarray(jax.random.uniform(r_t, (B, 1, 1))),
            "z": np.asarray(jax.random.normal(r_z, (B, TF, 80)))}


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


def _port_batch(batch):
    return {k: _t(v).long() if k in ("x", "sid") else _t(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def setup():
    jcfg = jst.StableTTSConfig(**CFG)
    tree = P.perturb_matcha_zero_init(P.matcha_init(tst.StableTTSConfig(**CFG), 0), seed=1)
    want = jax.eval_shape(lambda k: jst.matcha_init(k, jcfg), jax.random.PRNGKey(0))
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    assert jax.tree.map(np.shape, tree) == jax.tree.map(lambda a: a.shape, want)
    batch = _batch()
    keys = jax.random.split(jax.random.PRNGKey(1), 4)
    noise = _jax_noise(keys[0])
    u = noise["cfg"][:, 0]
    cfg_dropout = float(u.min() + u.max()) / 2  # one row keeps its speaker, one takes the fakes
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    # one accumulation cycle of the JAX step (4 micro-steps, one key each) as
    # one compiled scan, the gradient each micro-step gave the optimizer recorded
    tcfg = jtrain.StableTrainConfig(cfg_dropout=cfg_dropout)
    make = jtrain.make_optimizer
    jtrain.make_optimizer = _recording(make)
    try:
        step, opt = jtrain.make_train_step(jcfg, tcfg), jtrain.make_optimizer(tcfg)

        def run(params, batch, keys):
            state = {"step": jnp.zeros((), jnp.int32), "params": params, "opt": opt.init(params)}

            def body(state, key):
                state, metrics = step(state, batch, key)
                return state, (metrics, state["opt"][1])
            state, (metrics, grads) = jax.lax.scan(body, state, keys)
            return state["params"], metrics, jax.tree.map(lambda g: g[0], grads)

        params, metrics, grads = jax.jit(run)(tree, jb, keys)
    finally:
        jtrain.make_optimizer = make
    metrics = jax.device_get(metrics)
    x_mask = (np.arange(TX)[None] < np.asarray(X_LENGTHS)[:, None]).astype(np.float32)
    y_mask = (np.arange(TF)[None] < np.asarray(MEL_LENGTHS)[:, None]).astype(np.float32)
    attn = jcommons.generate_path(batch["durations"].astype(np.float32), x_mask, y_mask)
    return {"jcfg": jcfg, "cfg": tst.StableTTSConfig(**CFG), "tree": tree, "batch": batch,
            "noise": noise, "cfg_dropout": cfg_dropout,
            "forward": {"diff_loss": metrics["diff_loss"][0], "dur_loss": metrics["dur_loss"][0],
                        "attn": np.asarray(attn)},
            "grads": jax.device_get(grads), "cycle_keys": keys,
            "cycle_params": jax.device_get(params),
            "cycle_metrics": [{k: float(v[i]) for k, v in metrics.items()} for i in range(4)]}


def test_duration_loss():
    rng = np.random.default_rng(3)
    mu = rng.standard_normal((3, 11, 50)).astype(np.float32) * 2
    lens = np.asarray([11, 8, 5], np.int32)
    mask = (np.arange(11)[None] < lens[:, None]).astype(np.float32)[..., None]
    dur = (rng.integers(0, 70, (3, 11)) * mask[..., 0]).astype(np.float32)  # some above 49
    want = jax.jit(jst.duration_loss)(mu, dur, mask, lens)
    got = tst.duration_loss(_t(mu), _t(dur), _t(mask), _t(lens))
    print(f"duration_loss: {_rel(got, want, 1e-4):.3e} relative")


def test_cfm_loss(setup):
    cfg, tree = setup["cfg"], setup["tree"]
    rng = np.random.default_rng(4)
    x1 = rng.standard_normal((B, TF, 80)).astype(np.float32)
    mask = (np.arange(TF)[None] < np.asarray(MEL_LENGTHS)[:, None]).astype(np.float32)[..., None]
    mu = rng.standard_normal((B, TF, 32)).astype(np.float32)
    spks = rng.standard_normal((B, 8)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = jax.jit(lambda p, *a: jst.cfm_loss(p, setup["jcfg"], *a, rng=key))(tree, x1, mask, mu,
                                                                              spks)
    r_t, r_z = jax.random.split(key)
    noise = {"t": _t(jax.random.uniform(r_t, (B, 1, 1))), "z": _t(jax.random.normal(r_z, x1.shape))}
    got = tst.cfm_loss(P.to_torch(tst.port_layout(tree), "cpu"), cfg, _t(x1), _t(mask), _t(mu),
                       _t(spks), noise=noise)
    print(f"cfm_loss: {_rel(got, want, 1e-4):.3e} relative")


def test_dense_attention_route_matches_kernel_route_on_valid_rows(setup):
    """flash=False (dense, query x key mask) and the kernel's route (its plain
    version here: keys masked) agree on the valid rows."""
    blk = P.to_torch(tst.port_layout(setup["tree"]), "cpu")["decoder"]["blocks"][0]["dit"]["attn"]
    x = torch.randn(B, TF, 32, generator=torch.Generator().manual_seed(7))
    kv = torch.tensor(MEL_LENGTHS, dtype=torch.int32)
    dense = tst.dit_mha_apply(blk, x, kv, n_heads=2, flash=False)
    plain = tst.dit_mha_apply(blk, x, kv, n_heads=2)
    for i, n in enumerate(MEL_LENGTHS):
        _rel(dense[i, :n], plain[i, :n].numpy(), 1e-5, i)


def test_forward_train(setup):
    want = setup["forward"]
    pb = _port_batch(setup["batch"])
    with torch.no_grad():
        got = tst.forward_train(P.to_torch(tst.port_layout(setup["tree"]), "cpu"), setup["cfg"],
                                pb["x"], pb["x_lengths"], pb["mel"], pb["mel_lengths"], pb["sid"],
                                pb["bert"], pb["durations"], cfg_dropout=setup["cfg_dropout"],
                                noise={k: _t(v) for k, v in setup["noise"].items()})
    np.testing.assert_array_equal(got["attn"].numpy(), np.asarray(want["attn"]))
    errs = {k: _rel(got[k], want[k], 1e-4, k) for k in ("dur_loss", "diff_loss")}
    print(f"forward_train: {errs} relative")


def _port_state(setup):
    return ttrain.init_train_state(setup["cfg"], ttrain.StableTrainConfig(
        cfg_dropout=setup["cfg_dropout"]), device="cpu", tree=tst.port_layout(setup["tree"]))


def _bundle_grads(state, tensors):
    """A list of tensors in the state's parameter order -> the bundle layout."""
    paths = list(state.params["g"].leaves())
    return _flatten(tst.bundle_layout(_unflatten({p: t.detach().numpy()
                                                  for p, t in zip(paths, tensors)})))


def test_micro_step_gradients(setup):
    """The first micro-step's gradient (the running mean after one term)."""
    state = _port_state(setup)
    metrics = ttrain.make_train_step(setup["cfg"], ttrain.StableTrainConfig(
        cfg_dropout=setup["cfg_dropout"]))(state, _port_batch(setup["batch"]),
                                           noise={k: _t(v) for k, v in setup["noise"].items()})
    want_loss = float(setup["forward"]["diff_loss"] + setup["forward"]["dur_loss"])
    _rel(metrics["loss"], np.float32(want_loss), 1e-4, "loss")
    got = _bundle_grads(state, state.acc)
    want = _flatten(setup["grads"])
    assert set(got) == set(want)
    unread = sorted(p for p, w in want.items() if not np.any(w))  # the mel encoder
    assert unread and all(p.startswith("text_encoder/encoder/") for p in unread), unread
    assert all(not np.any(got[p]) for p in unread)
    floor = 1e-6 * max(float(np.abs(w).max()) for w in want.values())
    tiny = sorted(p for p, w in want.items() if float(np.abs(w).max()) < floor and p not in unread)
    worst = max(_rel(got[p], w, 1e-3, p) for p, w in want.items()
                if p not in tiny and p not in unread)
    for p in tiny:
        _rel(got[p], want[p], 1e-3, p, floor=floor)
    print(f"gradients: worst {worst:.3e} of a tensor's max; {len(unread)} tensors of the unread "
          f"mel encoder exactly 0; {len(tiny)} held to the floor {floor:.3e}: {tiny}")


def test_accumulation_cycle_matches_multisteps(setup):
    state = _port_state(setup)
    step = ttrain.make_train_step(setup["cfg"], ttrain.StableTrainConfig(
        cfg_dropout=setup["cfg_dropout"]))
    pb = _port_batch(setup["batch"])
    p0 = [p.detach().clone() for p in state.params["g"].parameters()]
    for i, key in enumerate(setup["cycle_keys"]):
        m = step(state, pb, noise={k: _t(v) for k, v in _jax_noise(key).items()})
        _rel(m["loss"], np.float32(setup["cycle_metrics"][i]["loss"]), 1e-4, f"loss {i}")
        if i < 3:
            assert all(torch.equal(a, b) for a, b in zip(p0, state.params["g"].parameters())), i
    assert state.step == 4 and all(float(a.abs().max()) == 0 for a in state.acc)
    got = _bundle_grads(state, list(state.params["g"].parameters()))
    want = _flatten(setup["cycle_params"])
    assert set(got) == set(want)
    grads = _flatten(setup["grads"])
    # the mel encoder's output is read by neither loss: gradient 0, unmoved on both sides
    unread = sorted(p for p, g in grads.items() if not np.any(g))
    assert unread and all(p.startswith("text_encoder/encoder/") for p in unread), unread
    for p in unread:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)
    before = _flatten(setup["tree"])
    assert all(not np.array_equal(got[p], before[p]) for p in got if p not in unread)
    l2 = lambda xs: float(np.sqrt(sum(np.sum(np.square(x.astype(np.float64))) for x in xs)))
    tree_err = l2([got[p] - want[p] for p in want]) / l2(list(want.values()))
    assert tree_err <= 1e-5, tree_err
    step_err = {p: float(np.abs(got[p] - w).max()) / LR for p, w in want.items()}
    worst = max(step_err, key=step_err.get)
    assert step_err[worst] <= 0.1, (worst, step_err[worst])
    print(f"after the cycle: relative L2 of the whole tree {tree_err:.3e}; an element's step "
          f"within {step_err[worst]:.3e} lr of JAX's ({worst}); {len(unread)} unread tensors "
          f"unmoved")


# ---------------------------------------------------------------------------
# Data pipeline, BERT rows, driver
# ---------------------------------------------------------------------------

SR, HOP = 22050, 256
ALIGNED = ["m_a1 vj_i1_r", "d_o1_m u1", "s_a0_d m_i1_r a1"]
TEXTS = ["привет мир", "дом у", "сад мир а"]
LETTERS = "абвгдежзийклмнопрстуфхцчшщъыьэюяё"
VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + list(LETTERS) + ["##" + c for c in LETTERS]
         + ["при", "##вет", "мир", "дом", ",", ".", "!", "-"])
BERT_CFG = dict(vocab_size=len(VOCAB), hidden_size=16, num_hidden_layers=3, num_attention_heads=2,
                intermediate_size=32, max_position_embeddings=64, type_vocab_size=2)


def _write_wav(path, n_samples, seed):
    data = (np.random.default_rng(seed).standard_normal(n_samples) * 3000).astype(np.int16)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(SR)
        f.writeframes(data.tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three utterances (wav, .lab durations that sum to each mel's frames,
    metadata) and a BERT bundle, written twice: one copy for each package,
    so that neither reads the other's mel cache."""
    root = tmp_path_factory.mktemp("stabletts_corpus")
    src = root / "src"
    src.mkdir()
    lines = []
    for i, (text, aligned) in enumerate(zip(TEXTS, ALIGNED)):
        _write_wav(src / f"utt{i}.wav", HOP * (40 + 8 * i), seed=i)
        lines.append(f"utt{i}|{i % 2}|{text}|{aligned}")
    (src / "metadata.csv").write_text("\n".join(lines) + "\n", encoding="utf-8")
    ds = tdata.StableTTSDataset(tdata.StableDataConfig(metadata=str(src / "metadata.csv"),
                                                       wav_dir=str(src)))
    for i in range(len(ds)):
        t, n_frames = ds.text_streams(i)[0].shape[0], ds.mel(i).shape[0]
        durs = [n_frames // t] * t
        durs[-1] += n_frames - sum(durs)
        (src / f"utt{i}.lab").write_text("\n".join(f"p {j} {d}" for j, d in enumerate(durs)) + "\n",
                                         encoding="utf-8")
    bert = src / "bert"
    bert.mkdir()
    save_params(bert / "params.npz", P.bert_init(jbert.BertConfig(**BERT_CFG), 8))
    (bert / "config.json").write_text(json.dumps(BERT_CFG))
    (bert / "vocab.txt").write_text("\n".join(VOCAB), encoding="utf-8")
    for side in ("jax", "port"):
        shutil.copytree(src, root / side, ignore=shutil.ignore_patterns("*.npy"))
    return root


def _data_cfg(cls, root, **kw):
    return cls(metadata=str(root / "metadata.csv"), wav_dir=str(root), n_spks=2, **kw)


def test_parse_lab_dataset_and_collate(corpus):
    jds = jdata.StableTTSDataset(_data_cfg(jdata.StableDataConfig, corpus / "jax"))
    tds = tdata.StableTTSDataset(_data_cfg(tdata.StableDataConfig, corpus / "port"))
    assert jds.items == [(str(corpus / "jax" / f"utt{i}.wav"), i % 2, TEXTS[i], ALIGNED[i])
                         for i in range(3)] and jds.lengths == tds.lengths
    for i in range(3):
        lab = corpus / "port" / f"utt{i}.lab"
        assert tdata.parse_lab(str(lab)) == jdata.parse_lab(str(lab))
        for a, b in zip(tds.text_streams(i), jds.text_streams(i)):
            np.testing.assert_array_equal(a, b)
        _rel(tds.mel(i), jds.mel(i), 1e-5, f"mel {i}")
    jb = jdata.StableBatcher(jds, 2)
    tb = tdata.StableBatcher(tds, 2)
    assert tb.num_batches() == jb.num_batches() and tb.order == jb.order
    for epoch in (0, 1):
        for got, want in zip(tb.epoch(epoch), jb.epoch(epoch), strict=True):
            assert set(got) == set(want)
            for k in want:
                if k == "mel":
                    _rel(got[k], want[k], 1e-5, k)
                else:
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            # the collate's clipping keeps every row's durations inside its frames
            assert (got["durations"].sum(axis=1) <= got["mel_lengths"]).all()


def test_make_bert_fn(corpus):
    bert_dir = corpus / "port" / "bert"
    got_fn, want_fn = trun.make_bert_fn(bert_dir, "cpu"), jrun.make_bert_fn(str(bert_dir))
    for text in TEXTS + ["При+вет, мир! Дом - сад."]:
        got, want = got_fn(text), want_fn(text)
        assert got.shape == want.shape and got.shape[0] >= 4, text
        _rel(got, want, 1e-5, text)


def _driver_cfg(root):
    return {"data": {"training_files": str(root / "metadata.csv"), "wav_dir": str(root),
                     "n_spks": 2},
            "model": {k: v for k, v in CFG.items() if k != "n_spks"},
            "train": {"batch_size": 3, "epochs": 100, "log_interval": 1, "save_interval": 100,
                      "learning_rate": 1e-3}}


def test_driver_and_resume(corpus, tmp_path):
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(_driver_cfg(corpus / "port")), encoding="utf-8")
    model_dir = tmp_path / "model"
    args = ["-c", str(cfg_path), "-m", str(model_dir), "--device", "cpu",
            "--bert-dir", str(corpus / "port" / "bert")]
    first, m1 = trun.main(args + ["--max-steps", "4"])
    assert first.step == 4 and set(m1) == {"loss", "diff_loss", "dur_loss"}
    assert all(np.isfinite(v) for v in m1.values())
    assert (model_dir / "STATE_4.pt").exists()
    dcfg, mcfg, tcfg = trun.build_configs(_driver_cfg(corpus / "port"))
    assert tcfg.accumulate == 4 and mcfg.bert_dim == dcfg.bert_dim == 16
    restored = ttrain.init_train_state(mcfg, tcfg, seed=99, device="cpu")
    assert resume_state(str(model_dir), restored) is not None
    assert restored.step == 4
    for a, b in zip(first.params["g"].parameters(), restored.params["g"].parameters()):
        assert torch.equal(a, b)
    sa, sb = first.opt["g"].state_dict()["state"], restored.opt["g"].state_dict()["state"]
    assert sa.keys() == sb.keys() and all(torch.equal(sa[i][n], sb[i][n]) for i in sa
                                          for n in ("step", "exp_avg", "exp_avg_sq"))
    second, m2 = trun.main(args + ["--max-steps", "6"])
    assert second.step == 6 and all(np.isfinite(v) for v in m2.values())


def test_driver_needs_cuda_without_device(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(_driver_cfg(corpus / "port")), encoding="utf-8")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trun.main(["-c", str(cfg_path), "-m", str(tmp_path / "m")])
