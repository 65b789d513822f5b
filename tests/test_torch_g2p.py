"""The English G2P's training half (text/neural_g2p.py: ``init_params``,
``encoder_apply``, ``teacher_logits``, ``flatten_for_npz``) and its tools
(``train_g2p``, ``lts_error_analysis``) vs the JAX package's, on the CPU.

The tools run once each as a subprocess with ``--device cpu`` (the JAX
side's tools/*.py loaded as modules and run in process) on a synthetic
CMUdict (tests/torch_ref_layout.py: a seeded letter-to-phone rule; no
CMUdict is in the repository). Tolerances (f32 on both sides):
``encoder_apply`` and ``teacher_logits`` 1e-5 x the largest value; five
``train`` steps against optax as stated in that test; ``flatten_for_npz``
predicting the same phones in both ``NeuralG2P``s; ``align`` equal on
random pairs; the error-analysis report equal to the JAX tool's, line for
line.
"""

import random
import sys

import numpy as np

import jax
import jax.numpy as jnp
import optax
import torch

from vosk_tts_tpu.text import neural_g2p as JNG
from vosk_tts_tpu_torch.text import neural_g2p as TNG
from vosk_tts_tpu_torch.tools import lts_error_analysis as tlts
from vosk_tts_tpu_torch.tools import train_g2p as ttg

import torch_ref_layout as R
from test_torch_tools import _flat, _jax_tool, _peak_close, _tool, _torch_threads  # noqa: F401

PHONES = TNG.phone_vocab()


def _np_tree(params):
    return {k: {n: t.detach().numpy() for n, t in v.items()} if isinstance(v, dict)
            else v.detach().numpy() for k, v in params.items()}


def _rows(n, seed):
    return list(R.synthetic_lexicon(n, seed).items())


def test_g2p_teacher_logits():
    assert PHONES == JNG.phone_vocab()
    params = TNG.init_params(torch.Generator().manual_seed(0), n_phones=len(PHONES))
    wid, pin, _ = ttg.pack(_rows(6, 1) + [("a", ("EY1",))], PHONES)
    got = TNG.teacher_logits(params, torch.from_numpy(wid), torch.from_numpy(pin)).numpy()
    want = np.asarray(JNG.teacher_logits_jax(_np_tree(params), jnp.asarray(wid), jnp.asarray(pin)))
    _peak_close(got, want, 1e-5, "logits")
    enc, mask = TNG.encoder_apply(params, torch.from_numpy(wid))
    jenc, jmask = JNG.encoder_apply_jax(_np_tree(params), jnp.asarray(wid))
    _peak_close(enc.numpy(), np.asarray(jenc), 1e-5, "encoder")
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


def test_train_g2p_matches_optax():
    """Five steps of ``train`` (one epoch of 5 x 16 rows) against optax's
    chain(clip_by_global_norm(1), adam(cosine_decay_schedule)) from the same
    init on the same batches: every step's loss 1e-5 relative; the first
    step's gradient, each leaf within 1e-5 of its largest magnitude; the
    parameters after the 5 steps, each leaf within 1e-5 of its largest
    magnitude plus 1e-2 lr. Adam divides each element's gradient by its own
    running RMS, so an element whose gradients cancel or change sign
    between steps turns their f32 rounding (the two packages sum in other
    orders) into a step error of up to lr; 1e-2 lr bounds that over five
    steps (the largest seen is 7.8e-3 lr, on ``out``)."""
    batch, lr = 16, 2e-3
    rows = _rows(5 * batch, 2)
    gen = torch.Generator().manual_seed(7)
    init = _np_tree(TNG.init_params(gen, n_phones=len(PHONES)))
    order = torch.randperm(len(rows), generator=gen).numpy()
    ((_, params, losses),) = list(ttg.train(rows, PHONES, epochs=1, batch=batch, lr=lr,
                                            device="cpu",
                                            generator=torch.Generator().manual_seed(7)))
    wid, pin, tgt = ttg.pack(rows, PHONES)
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(optax.cosine_decay_schedule(lr, 5)))

    def loss_fn(p, w, i, t):
        logits = JNG.teacher_logits_jax(p, w, i)
        mask = ((t > 0) | (t == 2)).astype(jnp.float32)
        nll = -jnp.take_along_axis(jax.nn.log_softmax(logits, axis=-1), t[..., None], axis=-1)[..., 0]
        return jnp.sum(nll * mask) / jnp.maximum(jnp.sum(mask), 1)

    @jax.jit
    def step(p, o, w, i, t):
        loss, g = jax.value_and_grad(loss_fn)(p, w, i, t)
        up, o = opt.update(g, o, p)
        return optax.apply_updates(p, up), o, loss, g

    p = jax.tree_util.tree_map(jnp.asarray, init)
    o = opt.init(p)
    want_losses = []
    for j in range(5):
        idx = order[j * batch: (j + 1) * batch]
        p, o, loss, g = step(p, o, wid[idx], pin[idx], tgt[idx])
        want_losses.append(float(loss))
        if j == 0:
            first_grad = _flat(jax.tree_util.tree_map(np.asarray, g))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)

    leaves = {k: torch.tensor(a, requires_grad=True) for k, a in _flat(init).items()}
    t_init = {k: {n: leaves[f"/{k}/{n}"] for n in v} if isinstance(v, dict) else leaves[f"/{k}"]
              for k, v in init.items()}
    idx = order[:batch]
    loss = ttg.loss_fn(t_init, *(torch.from_numpy(a[idx]) for a in (wid, pin, tgt)))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    for k, want in first_grad.items():
        _peak_close(grads[k].numpy(), want, 1e-5, f"gradient {k}")

    got, want = _flat(_np_tree(params)), _flat(jax.tree_util.tree_map(np.asarray, p))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-5 * float(np.abs(want[k]).max()) + 1e-2 * lr, err_msg=k)


def test_flatten_for_npz_predicts_the_same(tmp_path):
    params = TNG.init_params(torch.Generator().manual_seed(1), n_phones=len(PHONES))
    np.savez(tmp_path / "mine.npz", **TNG.flatten_for_npz(params, PHONES))
    np.savez(tmp_path / "theirs.npz", **JNG.flatten_for_npz(_np_tree(params), PHONES))
    a, b = TNG.NeuralG2P(tmp_path / "mine.npz"), JNG.NeuralG2P(tmp_path / "theirs.npz")
    for w in [w for w, _ in _rows(20, 3)] + ["hello", "it's"]:
        assert a.predict(w) == b.predict(w), w


def test_train_g2p_cli(tmp_path):
    """The CLI on a synthetic CMUdict of 6000 words: 3000 + 400 held out,
    2000 dev, the rest trained for one epoch; the artifact loads and
    predicts."""
    R.write_cmudict(tmp_path, R.synthetic_lexicon(6000, 5))
    out = _tool("train_g2p", "--dict-dir", tmp_path, "--epochs", 1, "--batch", 256,
                "--out", tmp_path / "g2p.npz", "--device", "cpu")
    assert "FINAL held-out PER" in out and "*saved" in out, out
    phones = TNG.NeuralG2P(tmp_path / "g2p.npz").predict("hello")
    assert all(p in PHONES for p in phones)


def test_lts_align():
    rng = random.Random(0)
    jlts = _jax_tool("lts_error_analysis")
    syms = ["AA", "B", "K", "IY", "T", "S"]
    for _ in range(200):
        a = [rng.choice(syms) for _ in range(rng.randint(0, 8))]
        b = [rng.choice(syms) for _ in range(rng.randint(0, 8))]
        assert tlts.align(a, b) == jlts.align(a, b), (a, b)


def test_lts_error_analysis_report(tmp_path, capsys):
    lexicon = R.synthetic_lexicon(400, 6)
    lexicon["thing"] = ("TH", "IH1", "NG")  # one word read from the dictionary by the G2P too
    R.write_cmudict(tmp_path, lexicon)
    got = _tool("lts_error_analysis", "--dict-dir", tmp_path, "--n", 120, "--top", 10)
    jlts = _jax_tool("lts_error_analysis")
    jlts.REF_TEXT = str(tmp_path)
    argv = sys.argv
    sys.argv = ["lts_error_analysis.py", "--n", "120", "--top", "10"]
    try:
        jlts.main()
    finally:
        sys.argv = argv
    want = capsys.readouterr().out
    assert "error categories" in want and got == want
