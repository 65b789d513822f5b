"""The port's converters and data tools (vosk_tts_tpu_torch/tools/) vs the JAX
package's, on the CPU (``--device cpu``).

Each port tool runs once as a subprocess (``python -m
vosk_tts_tpu_torch.tools.<name>``); the JAX side runs its functions in
process (its tools/*.py loaded as modules). Trees are the port's numpy
inits at small widths, written in the reference's naming by
tests/torch_ref_layout.py. Tolerances (f32 on both sides):

* converters: ``params.npz`` leaf for leaf equal to the JAX reader's tree
  (both fold with the same numpy arithmetic), ``config.json`` equal;
* ``make_demo_bundle``: leaf paths and shapes equal to ``jax.eval_shape``
  of the JAX init, ``config.json`` equal to the JAX tool's;
* HuBERT features (``vc_encode_dataset``, ``gpt_sovits_prepare``) 1e-4 x
  peak of the JAX ``hubert_apply``; semantic codes and the tsv equal;
* ``compute_stats`` 1e-6 relative; MAS durations equal to the JAX
  ``mas_durations``' on the same tree, or, where a tie breaks the other
  way, the log-prior summed along both paths within 1e-5 relative.

The G2P tools are tests/test_torch_g2p.py's.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vosk_tts_tpu import api as japi
from vosk_tts_tpu.models import gpt_sovits as jgs
from vosk_tts_tpu.models import hubert as jhub
from vosk_tts_tpu.models import quickvc as jqvc
from vosk_tts_tpu.models import stabletts as jst
from vosk_tts_tpu.models import vits2 as jv
from vosk_tts_tpu.text import plain_symbol_map
from vosk_tts_tpu.utils import torch_params as jtp
from vosk_tts_tpu_torch import api as tapi
from vosk_tts_tpu_torch.models import gpt_sovits as tgs
from vosk_tts_tpu_torch.models import hubert as thub
from vosk_tts_tpu_torch.models import quickvc as tqvc
from vosk_tts_tpu_torch.models import stabletts as tst
from vosk_tts_tpu_torch.models import vits2 as tv
from vosk_tts_tpu_torch.tools import stabletts_bootstrap as tboot
from vosk_tts_tpu_torch.train import stabletts_train as ttrain
from vosk_tts_tpu_torch.train.stabletts_data import StableBatcher, StableTTSDataset
from vosk_tts_tpu_torch.train.run_stabletts import build_configs
from vosk_tts_tpu_torch.utils import params as P
from vosk_tts_tpu_torch.utils.checkpoint import load_params, save_full_state, save_params

import torch_ref_layout as R

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch threads here; the JAX executables this module compiled are
    dropped after it (a test worker runs other modules next)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def _tool(name, *args):
    """``python -m vosk_tts_tpu_torch.tools.<name> args``; its stdout."""
    r = subprocess.run([sys.executable, "-m", f"vosk_tts_tpu_torch.tools.{name}", *map(str, args)],
                       capture_output=True, text=True, cwd=ROOT, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2"})
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _flat(tree, path=""):
    if tree is None:
        return {path: None}
    if isinstance(tree, dict):
        return {p: a for k, v in tree.items() for p, a in _flat(v, f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: a for i, v in enumerate(tree) for p, a in _flat(v, f"{path}/{i}").items()}
    return {path: np.asarray(tree)}


def _equal_trees(got, want):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), sorted(set(g) ^ set(w))[:8]
    for p in w:
        assert (g[p] is None and w[p] is None) or np.array_equal(g[p], w[p]), p


def _save_pth(path, sd):
    torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                "iteration": 7}, path)


def _write_wav(path, n_samples, sr, seed):
    data = (np.random.default_rng(seed).standard_normal(n_samples) * 3000).astype(np.int16)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(data.tobytes())


def _peak_close(got, want, rel, what=""):
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()),
                               err_msg=what)


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------

VITS2_SMALL = dict(inter_channels=32, hidden_channels=32, filter_channels=64, n_layers=2,
                   n_flows=2, upsample_initial_channel=32, n_speakers=4, gin_channels=16,
                   spec_channels=13, posterior_wn_layers=2, use_transformer_flows=True,
                   transformer_flow_type="pre_conv2", decoder_type="mb_istft",
                   use_spk_conditioned_encoder=True, segment_size=8)


def _bundle_config(family, cfg, sample_rate):
    """The config.json the JAX tool writes."""
    return {"model_type": family, "sample_rate": sample_rate,
            "phoneme_id_map": {k: [v] for k, v in plain_symbol_map().items()},
            "inference": {"noise_level": 0.8, "speech_rate": 1.0, "duration_noise_level": 0.8},
            "model": json.loads(json.dumps(dataclasses.asdict(cfg)))}


def test_convert_checkpoint_vits2(tmp_path):
    cfg = tv.VITS2Config(**VITS2_SMALL)
    tree = P.perturb_zero_init(P.synthesizer_init(cfg, seed=0), seed=1)
    sd = R.vits2_state_dict(tree, cfg)
    _save_pth(tmp_path / "G_7.pth", sd)
    ref = R.vits2_reference_config(cfg)
    (tmp_path / "ref.json").write_text(json.dumps(ref), encoding="utf-8")
    (tmp_path / "dictionary").write_text("привет 1.0 p rj i0 vj e1 t\n", encoding="utf-8")
    _tool("convert_checkpoint", tmp_path / "G_7.pth", tmp_path / "ref.json", tmp_path / "bundle",
          "--dictionary", tmp_path / "dictionary")

    jcfg = jv.VITS2Config.from_reference_json(ref["model"], ref["data"], ref["train"])
    _equal_trees(load_params(tmp_path / "bundle" / "params.npz"), jtp.vits2_from_state_dict(sd, jcfg))
    got = json.loads((tmp_path / "bundle" / "config.json").read_text(encoding="utf-8"))
    assert got == _bundle_config("vits2", jcfg, 22050)
    assert (tmp_path / "bundle" / "dictionary").read_text(encoding="utf-8").startswith("привет")

    model = tapi.Model(model_path=tmp_path / "bundle", device="cpu")
    wav = tapi.Synth(model).synth_audio("привет мир", speaker_id=1)
    assert len(wav) > 0 and np.isfinite(wav).all() and np.abs(wav).max() > 0


@pytest.mark.parametrize("family", ["quickvc", "sovits"])
def test_convert_checkpoint_families(tmp_path, family):
    """QuickVC and SoVITS take the default config: a small-width tree with
    the default's structure (layer counts, upsampling) converts under it."""
    if family == "quickvc":
        small = tqvc.QuickVCConfig(hidden_channels=32, inter_channels=32, ssl_dim=24,
                                   spec_channels=13, gin_channels=16, upsample_initial_channel=32,
                                   n_mel_channels=12)
        sd = R.quickvc_state_dict(R.randomize(P.quickvc_init(small, seed=0), 1), small)
        want = jtp.quickvc_from_state_dict(sd, jqvc.QuickVCConfig())
        jcfg = jqvc.QuickVCConfig()
    else:
        small = tgs.SoVITSConfig(hidden_channels=32, inter_channels=32, filter_channels=64,
                                 spec_channels=13, gin_channels=16, ssl_dim=24,
                                 upsample_initial_channel=32, n_codes=17, n_symbols=20,
                                 mrte_hidden=32, style_hidden=16)
        sd = R.sovits_state_dict(R.randomize(P.sovits_init(small, seed=0), 1), small)
        want = jtp.sovits_from_state_dict(sd, jgs.SoVITSConfig())
        jcfg = jgs.SoVITSConfig()
    _save_pth(tmp_path / "G_7.pth", sd)
    (tmp_path / "ref.json").write_text(json.dumps({"data": {"sampling_rate": 32000}}))
    from vosk_tts_tpu_torch.tools import convert_checkpoint

    convert_checkpoint.main([str(tmp_path / "G_7.pth"), str(tmp_path / "ref.json"),
                             str(tmp_path / "out"), "--family", family])
    _equal_trees(load_params(tmp_path / "out" / "params.npz"), want)
    got = json.loads((tmp_path / "out" / "config.json").read_text(encoding="utf-8"))
    assert got == _bundle_config(family, jcfg, 32000)


HUBERT_HF = {"model_type": "hubert", "conv_dim": [32, 32, 32], "conv_kernel": [10, 3, 2],
             "conv_stride": [5, 2, 2], "hidden_size": 32, "num_hidden_layers": 2,
             "num_attention_heads": 4, "intermediate_size": 64, "num_conv_pos_embeddings": 16,
             "num_conv_pos_embedding_groups": 4, "layer_norm_eps": 1e-5,
             "feat_extract_norm": "group", "do_stable_layer_norm": False}


def _hubert_tree():
    return P.hubert_init(thub.HubertConfig.from_hf(HUBERT_HF), seed=3)


def test_convert_hubert(tmp_path):
    """pytorch_model.bin (the tool as a subprocess) and model.safetensors
    (in process) give the same bundle, JAX's reader's tree."""
    tree = _hubert_tree()
    sd = R.hubert_state_dict(tree, "parametrizations")
    for name in ("bin", "st"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "config.json").write_text(json.dumps(HUBERT_HF))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "bin" / "pytorch_model.bin")
    R.write_safetensors(tmp_path / "st" / "model.safetensors", sd)
    _tool("convert_hubert", tmp_path / "bin", tmp_path / "out_bin")
    from vosk_tts_tpu_torch.tools import convert_hubert

    convert_hubert.main([str(tmp_path / "st"), str(tmp_path / "out_st")])
    want = jhub.hubert_from_state_dict(dict(sd), jhub.HubertConfig.from_hf(HUBERT_HF))
    for out in ("out_bin", "out_st"):
        _equal_trees(load_params(tmp_path / out / "params.npz"), want)
        assert json.loads((tmp_path / out / "config.json").read_text()) == HUBERT_HF
    (tmp_path / "bin" / "pytorch_model.bin").unlink()
    with pytest.raises(FileNotFoundError, match="no model.safetensors"):
        convert_hubert.main([str(tmp_path / "bin"), str(tmp_path / "x")])


def test_make_demo_bundle(tmp_path):
    _tool("make_demo_bundle", tmp_path / "demo", "--seed", 3)
    jtool = _jax_tool("make_demo_bundle")
    jcfg = jtool.small_config()
    shapes = jax.eval_shape(lambda: jv.synthesizer_init(jax.random.PRNGKey(0), jcfg))
    got = _flat(load_params(tmp_path / "demo" / "params.npz"))
    want = _flat(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    assert got.keys() == want.keys()
    assert all((got[p] is None and want[p] is None) or got[p].shape == want[p].shape for p in want)
    config = json.loads((tmp_path / "demo" / "config.json").read_text(encoding="utf-8"))
    assert config == _bundle_config("vits2", jcfg, 22050)
    assert (tmp_path / "demo" / "dictionary").read_text(encoding="utf-8").startswith("привет")
    model = japi.Model(model_path=str(tmp_path / "demo"))
    assert json.loads(json.dumps(dataclasses.asdict(model.model_config))) == config["model"]


# ---------------------------------------------------------------------------
# HuBERT features: vc_encode_dataset, gpt_sovits_prepare
# ---------------------------------------------------------------------------


def test_vc_encode_dataset_and_gpt_sovits_prepare(tmp_path):
    tree = _hubert_tree()
    (tmp_path / "hubert").mkdir()
    save_params(tmp_path / "hubert" / "params.npz", tree)
    (tmp_path / "hubert" / "config.json").write_text(json.dumps(HUBERT_HF))
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    for i, n in enumerate((8000, 12800)):
        _write_wav(wavs / f"utt{i}.wav", n, 16000, seed=i)
    sovits = tgs.SoVITSConfig(ssl_dim=32, n_codes=24, hidden_channels=32, inter_channels=32,
                              filter_channels=64, spec_channels=13, gin_channels=16,
                              upsample_initial_channel=32, n_symbols=20, mrte_hidden=32,
                              style_hidden=16)
    s_tree = P.sovits_init(sovits, seed=4)
    save_params(tmp_path / "sovits.npz", s_tree)

    _tool("vc_encode_dataset", tmp_path / "hubert", wavs, "--device", "cpu")
    _tool("gpt_sovits_prepare", tmp_path / "hubert", tmp_path / "sovits.npz", wavs,
          tmp_path / "semantic.tsv", "--device", "cpu")

    jcfg = jhub.HubertConfig.from_hf(HUBERT_HF)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    hubert = jax.jit(lambda wav: jhub.hubert_apply(jtree, jcfg, wav))
    js = jax.tree_util.tree_map(jnp.asarray, {k: s_tree[k] for k in ("ssl_proj", "codebook")})
    lines = []
    for i in range(2):
        data = np.frombuffer(wave.open(str(wavs / f"utt{i}.wav")).readframes(-1), np.int16)
        want = np.asarray(hubert(jnp.asarray(data / 32768.0)[None]))[0]
        _peak_close(np.load(wavs / f"utt{i}.cv.npy"), want, 1e-4, "cv")
        _peak_close(np.load(wavs / f"utt{i}.ssl.npy"), want, 1e-4, "ssl")
        codes = np.asarray(jgs.sovits_extract_latent(js, jgs.SoVITSConfig(), jnp.asarray(want)[None]))[0]
        assert len(codes) == want.shape[0] // 2
        lines.append(f"utt{i}\t" + " ".join(map(str, codes.tolist())))
    assert (tmp_path / "semantic.tsv").read_text(encoding="utf-8") == "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# stabletts_bootstrap
# ---------------------------------------------------------------------------

ST_CFG = dict(n_spks=3, spk_emb_dim=8, hidden_channels=32, filter_channels=64, n_heads=2,
              n_layers=2, phone_emb_dim=16, punc_emb_dim=2, bert_dim=16, bert_proj_dim=8,
              dec_hidden=32, dec_filter=64, dec_layers=2, dec_heads=2)
ALIGNED = ["m_a1 vj_i1_r", "d_o1_m u1", "s_a0_d m_i1_r a1"]
TEXTS = ["привет мир", "дом у", "сад мир а"]


def _stabletts_corpus(root):
    for i, (text, aligned) in enumerate(zip(TEXTS, ALIGNED)):
        _write_wav(root / f"utt{i}.wav", 256 * (40 + 8 * i), 22050, seed=i)
    (root / "metadata.csv").write_text(
        "\n".join(f"utt{i}|{i % 2}|{t}|{a}" for i, (t, a) in enumerate(zip(TEXTS, ALIGNED)))
        + "\n", encoding="utf-8")
    return {"data": {"training_files": str(root / "metadata.csv"), "wav_dir": str(root),
                     "n_spks": 2},
            "model": {k: v for k, v in ST_CFG.items() if k != "n_spks"},
            "train": {"batch_size": 3}}


def _path_score(log_prior, durations):
    """The log-prior summed along the monotonic path that ``durations`` spell."""
    out = []
    for lp, d in zip(log_prior, durations):
        frames = np.repeat(np.arange(len(d)), d)
        out.append(float(np.asarray(lp, np.float64)[np.arange(len(frames)), frames].sum()))
    return np.asarray(out)


def test_stabletts_bootstrap(tmp_path):
    cfg_json = _stabletts_corpus(tmp_path)
    (tmp_path / "config.json").write_text(json.dumps(cfg_json), encoding="utf-8")
    got = json.loads(_tool("stabletts_bootstrap", "stats", "-c", tmp_path / "config.json",
                           "--device", "cpu"))
    want = _jax_tool("stabletts_bootstrap").compute_stats(cfg_json)
    for k in ("mel_mean", "mel_std"):
        assert abs(got[k] - want[k]) <= 1e-6 * abs(want[k]), (k, got[k], want[k])

    # durations from a STATE written by the trainer, the adaLN-Zero projections perturbed
    dcfg, mcfg, tcfg = build_configs(cfg_json)
    bundle_tree = P.perturb_matcha_zero_init(P.matcha_init(mcfg, seed=5), seed=6)
    state = ttrain.init_train_state(mcfg, tcfg, device="cpu", tree=tst.port_layout(bundle_tree))
    save_full_state(str(tmp_path / "model"), "STATE", 0, {**state.state_dict(), "epoch": 0})
    _tool("stabletts_bootstrap", "durations", "-c", tmp_path / "config.json", "-m",
          tmp_path / "model", "--batch-size", 3, "--device", "cpu")

    ds = StableTTSDataset(dataclasses.replace(dcfg, load_durations=False))
    batch = StableBatcher(ds, 3).collate(list(range(3)))
    batch.pop("durations")
    tbatch = {k: torch.from_numpy(v).long() if k in ("x", "sid") else torch.from_numpy(v)
              for k, v in batch.items()}
    tparams = P.to_torch(tst.port_layout(bundle_tree), "cpu")
    mine = tboot.mas_durations(tparams, mcfg, tbatch).numpy()
    jcfg = jst.StableTTSConfig(**{f.name: getattr(mcfg, f.name)
                                  for f in dataclasses.fields(jst.StableTTSConfig)})
    jparams = jax.tree_util.tree_map(jnp.asarray, bundle_tree)
    jtool = _jax_tool("stabletts_bootstrap")
    theirs = np.asarray(jax.jit(lambda b: jtool.mas_durations(jparams, jcfg, b))(
        {k: jnp.asarray(v) for k, v in batch.items()}))
    log_prior = tboot.mel_log_prior(tparams, mcfg, tbatch)[0].numpy()
    for row in range(3):
        t, nf = int(batch["x_lengths"][row]), int(batch["mel_lengths"][row])
        lab = [int(line.split()[-1]) for line in (tmp_path / f"utt{row}.lab").read_text().splitlines()]
        assert lab == mine[row, :t].tolist() and sum(lab) == nf
        if not np.array_equal(mine[row, :t], theirs[row, :t]):  # a tie taken the other way
            s_mine, s_theirs = _path_score(log_prior[row:row + 1, :nf, :t],
                                           [mine[row, :t]]), _path_score(
                log_prior[row:row + 1, :nf, :t], [theirs[row, :t]])
            assert abs(s_mine - s_theirs) <= 1e-5 * abs(s_theirs), (row, s_mine, s_theirs)
