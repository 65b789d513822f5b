"""bf16 serving of the four model families in the PyTorch port.

The JAX package serves bf16 by handing its model functions a bf16 tree
(bench.py, tests/test_bf16_serving.py); the port does the same: the trees
are cast by ``to_torch(tree, device, dtype=torch.bfloat16)`` and the same
serving functions run from them, bf16 end to end. This file takes
tests/test_bf16_serving.py's small configurations, protocol and gates, and
holds the port's bf16 to the port's f32 (which the other test_torch_* files
hold to the JAX package): durations from an f32 encode are fed to both
precisions' decode; the bf16 encode's predicted frames must be within
max(2, 6%) of f32's. One VITS2 case also holds the port's bf16 decode to
the JAX package's bf16 decode of the same tree, at noise 0.

The dtype-flow test records the input dtypes of every convolution, linear
and matrix product (a ``TorchFunctionMode``) in the bf16 VITS2 and QuickVC
graphs: none may be f32, where a silent upcast (an f32 table, mask or
``arange`` meeting a bf16 activation) would show. A C.1 test checks that
``Model`` turns TF32 off.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.overrides import TorchFunctionMode

from vosk_tts_tpu.models import vits2 as jv
from vosk_tts_tpu_torch import api as tapi
from vosk_tts_tpu_torch.models import gpt_sovits as tg
from vosk_tts_tpu_torch.models import quickvc as tq
from vosk_tts_tpu_torch.models import stabletts as tst
from vosk_tts_tpu_torch.models import vits2 as tv
from vosk_tts_tpu_torch.models import vocoder as tvoc
from vosk_tts_tpu_torch.ops import ddsconv_fused as tddf
from vosk_tts_tpu_torch.ops import flash_attention as tfa
from vosk_tts_tpu_torch.text import plain_symbol_map
from vosk_tts_tpu_torch.utils.checkpoint import save_params
from vosk_tts_tpu_torch.utils.params import (ar_init, matcha_init, perturb_matcha_zero_init,
                                             perturb_zero_init, quickvc_init, sovits_init,
                                             synthesizer_init, to_port_layout, to_torch,
                                             vocos_init)

BF16, F32 = torch.bfloat16, torch.float32

VITS2 = dict(
    n_vocab=20, spec_channels=13, segment_size=8, inter_channels=32, hidden_channels=32,
    filter_channels=64, n_heads=2, n_layers=3, kernel_size=3, p_dropout=0.0, resblock="1",
    resblock_kernel_sizes=(3, 7, 11), resblock_dilation_sizes=((1, 3, 5),) * 3,
    upsample_rates=(4, 4), upsample_initial_channel=64, upsample_kernel_sizes=(16, 16),
    gen_istft_n_fft=16, gen_istft_hop_size=4, subbands=4, n_speakers=4, gin_channels=16,
    use_sdp=True, use_spk_conditioned_encoder=True, use_transformer_flows=True,
    transformer_flow_type="pre_conv2", decoder_type="mb_istft", istft_mode="torch")
STABLE = dict(
    n_vocab=30, n_feats=8, n_spks=4, spk_emb_dim=16, hidden_channels=32, filter_channels=64,
    n_heads=2, n_layers=2, kernel_size=3, p_dropout=0.0, phone_emb_dim=12, punc_emb_dim=4,
    bert_dim=24, bert_proj_dim=4, dp_out_channels=50, dec_hidden=32, dec_filter=64,
    dec_layers=2, dec_heads=2, dec_kernel=3)
VOCOS = dict(input_channels=8, dim=32, intermediate_dim=64, num_layers=2, n_fft=16, hop_length=4)
QUICKVC = dict(spec_channels=65, inter_channels=32, hidden_channels=32,
               upsample_initial_channel=64, gin_channels=16, ssl_dim=24)
SOVITS = dict(spec_channels=65, inter_channels=32, hidden_channels=32, filter_channels=64,
              n_layers=4, upsample_initial_channel=64, upsample_rates=(4, 4),
              upsample_kernel_sizes=(16, 16), gin_channels=32, ssl_dim=16, n_codes=20,
              n_symbols=30, mrte_hidden=32, style_hidden=16, segment_size=8)
AR = dict(embedding_dim=32, hidden_dim=32, num_head=4, num_layers=2, vocab_size=40,
          phoneme_vocab_size=30, bert_dim=24, eos=39)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    err = np.sum((ref - got) ** 2)
    return np.inf if err == 0 else float(10.0 * np.log10(np.sum(ref**2) / err))


def _np(t):
    return t.detach().float().numpy()


def _frames_close(pred16, pred32):
    for a, b in zip(pred16.tolist(), pred32.tolist()):
        assert abs(a - b) <= max(2, int(0.06 * b)), (a, b)


def _cast(enc, dtype):
    """An encode's f32 outputs in ``dtype`` (masks, means), the rest as is."""
    return {k: v.to(dtype) if v.is_floating_point() and k != "w_ceil" else v
            for k, v in enc.items()}


class DtypeRecorder(TorchFunctionMode):
    """The floating input dtypes of every conv, linear and matrix product.
    A kernel's plain version (the CPU's stand-in for a kernel that reads
    bf16 operands and accumulates in f32) is recorded as one product on its
    inputs, and what it computes inside is not."""

    OPS = {torch.nn.functional.conv1d, torch.nn.functional.conv2d,
           torch.nn.functional.conv_transpose1d, torch.nn.functional.linear, torch.matmul,
           torch.bmm, torch.einsum, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.mm}

    def __init__(self):
        super().__init__()
        self.seen = []
        self.inside = 0

    def kernel(self, name, plain):
        def run(*args, **kwargs):
            floating = [a for a in args if isinstance(a, torch.Tensor) and a.is_floating_point()]
            self.seen.append((name, tuple(str(a.dtype) for a in floating)))
            self.inside += 1
            try:
                return plain(*args, **kwargs)
            finally:
                self.inside -= 1
        return run

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.OPS and not self.inside:
            flat = [a for a in list(args) + list(kwargs.values()) if isinstance(a, torch.Tensor)]
            flat += [a for x in args if isinstance(x, (list, tuple)) for a in x
                     if isinstance(a, torch.Tensor)]
            self.seen.append((getattr(func, "__name__", str(func)),
                              tuple(str(a.dtype) for a in flat if a.is_floating_point())))
        return func(*args, **kwargs)


# ---------------------------------------------------------------------------
# VITS2
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vits2_model():
    cfg = tv.VITS2Config(**VITS2)
    tree = perturb_zero_init(synthesizer_init(cfg, seed=0), seed=1)
    port = to_port_layout(tree)
    return cfg, tree, to_torch(port, "cpu"), to_torch(port, "cpu", BF16)


def _vits2_inputs():
    rng = np.random.default_rng(1234)
    x = torch.from_numpy(rng.integers(1, VITS2["n_vocab"], size=(2, 16)).astype(np.int64))
    return x, torch.tensor([16, 11], dtype=torch.int32), torch.tensor([2, 1], dtype=torch.int32)


def _vits2_run(cfg, p32, p16):
    x, xl, sid = _vits2_inputs()
    gen = lambda: torch.Generator().manual_seed(5)
    enc32 = tv.encode_for_infer(p32, cfg, x, xl, sid, generator=gen())
    enc16 = tv.encode_for_infer(p16, cfg, x, xl, sid, generator=gen())
    out32 = tv.decode_from_durations(p32, cfg, enc32, sid, generator=gen(), max_frames=64)
    out16 = tv.decode_from_durations(p16, cfg, _cast(enc32, BF16), sid, generator=gen(),
                                     max_frames=64)
    return enc32, enc16, out32, out16


def test_vits2_bf16_serving(vits2_model):
    """tests/test_bf16_serving.py:83 and :90-94: frames within max(2, 6%),
    a bf16 waveform, equal lengths, decode SNR > 12 dB."""
    cfg, _, p32, p16 = vits2_model
    enc32, enc16, out32, out16 = _vits2_run(cfg, p32, p16)
    assert enc16["m_p"].dtype == BF16 and enc16["x_mask"].dtype == BF16
    _frames_close(enc16["pred_frames"], enc32["pred_frames"])
    assert out16["wav"].dtype == BF16
    assert torch.equal(out16["wav_lengths"], out32["wav_lengths"])
    for i, n in enumerate(out32["wav_lengths"].tolist()):
        s = snr_db(_np(out32["wav"][i, :n, 0]), _np(out16["wav"][i, :n, 0]))
        assert s > 12.0, f"row {i}: bf16 VITS2 decode SNR {s:.1f} dB"


def test_vits2_bf16_decode_matches_jax_bf16(vits2_model):
    """The same bundle-layout tree in bf16 through the JAX package's decode
    (XLA on the CPU) and the port's, on the port's f32 durations, noise 0:
    two bf16 graphs that round at other places. Measured 30.4 dB."""
    cfg, tree, p32, p16 = vits2_model
    x, xl, sid = _vits2_inputs()
    enc32 = tv.encode_for_infer(p32, cfg, x, xl, sid, noise_scale_w=0.0)
    enc = _cast(enc32, BF16)
    got = tv.decode_from_durations(p16, cfg, enc, sid, max_frames=64, noise_scale=0.0)["wav"]
    jtree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    jenc = {"m_p": jnp.asarray(_np(enc["m_p"]), jnp.bfloat16),
            "logs_p": jnp.asarray(_np(enc["logs_p"]), jnp.bfloat16),
            "x_mask": jnp.asarray(_np(enc["x_mask"]), jnp.bfloat16),
            "w_ceil": jnp.asarray(_np(enc["w_ceil"]), jnp.bfloat16)}
    want = jv.decode_from_durations(jtree, jv.VITS2Config(**VITS2), jenc,
                                    jnp.asarray(sid.numpy()), rng=jax.random.PRNGKey(0),
                                    max_frames=64, noise_scale=0.0)
    assert want["wav"].dtype == jnp.bfloat16 and got.dtype == BF16
    n = np.asarray(want["wav_lengths"])
    for i in range(2):
        s = snr_db(np.asarray(want["wav"], np.float32)[i, :n[i], 0], _np(got[i, :n[i], 0]))
        assert s > 20.0, f"row {i}: port bf16 vs JAX bf16 decode SNR {s:.1f} dB"


def test_bf16_graphs_have_no_f32_product(vits2_model, quickvc_model, monkeypatch):
    """Every conv, linear and matmul of the bf16 VITS2 encode and decode and
    of the bf16 QuickVC ``infer``, and every kernel, takes bf16 operands only."""
    cfg, _, p32, p16 = vits2_model
    x, xl, sid = _vits2_inputs()
    enc32 = tv.encode_for_infer(p32, cfg, x, xl, sid)
    rec = DtypeRecorder()
    for module, name in ((tfa, "banded_attention_plain"), (tfa, "global_attention_plain"),
                         (tddf, "ddsconv_plain")):
        monkeypatch.setattr(module, name, rec.kernel(name, getattr(module, name)))
    with rec:
        tv.encode_for_infer(p16, cfg, x, xl, sid, generator=torch.Generator().manual_seed(0))
        tv.decode_from_durations(p16, cfg, _cast(enc32, BF16), sid, max_frames=64,
                                 generator=torch.Generator().manual_seed(0))
        qcfg, q32, q16, c, tgt, noise = quickvc_model
        tq.infer(q16, qcfg, c.to(BF16), tgt.to(BF16), noise=noise.to(BF16))
    assert len(rec.seen) > 100
    kernels = {name for name, _ in rec.seen if name.endswith("_plain")}
    assert kernels == {"banded_attention_plain", "ddsconv_plain"}, kernels
    upcast = [(name, dts) for name, dts in rec.seen if any(d != "torch.bfloat16" for d in dts)]
    assert not upcast, upcast[:10]


# ---------------------------------------------------------------------------
# StableTTS + Vocos
# ---------------------------------------------------------------------------


def test_stabletts_bf16_serving():
    """tests/test_bf16_serving.py:128, :145 and :150: frames within max(2,
    6%); on f32 durations, 4 Euler steps at temperature 0: relative mel
    error < 0.12 and, after Vocos, SNR > 10 dB."""
    cfg = tst.StableTTSConfig(**STABLE)
    tree = tst.port_layout(perturb_matcha_zero_init(matcha_init(cfg, seed=1), seed=2))
    p32, p16 = to_torch(tree, "cpu"), to_torch(tree, "cpu", BF16)
    vcfg = tvoc.VocosConfig(**VOCOS)
    vtree = to_port_layout(vocos_init(vcfg, seed=2))
    rng = np.random.default_rng(1234)
    b, t = 1, 12
    x = torch.from_numpy(rng.integers(0, cfg.n_vocab, size=(b, 5, t)).astype(np.int64))
    xl = torch.tensor([t], dtype=torch.int32)
    bert = torch.from_numpy(rng.standard_normal((b, t, cfg.bert_dim)).astype(np.float32))
    sid = torch.tensor([1], dtype=torch.int32)
    enc32 = tst.encode_for_synth(p32, cfg, x, xl, sid, bert)
    enc16 = tst.encode_for_synth(p16, cfg, x, xl, sid, bert.to(BF16))
    _frames_close(enc16["pred_frames"], enc32["pred_frames"])
    out32 = tst.decode_from_durations(p32, cfg, enc32, sid, max_frames=64, n_timesteps=4,
                                      temperature=0.0)
    out16 = tst.decode_from_durations(p16, cfg, _cast(enc32, BF16), sid, max_frames=64,
                                      n_timesteps=4, temperature=0.0)
    nf = int(out32["mel_lengths"][0])
    assert int(out16["mel_lengths"][0]) == nf and out16["mel"].dtype == BF16
    mel32, mel16 = _np(out32["mel"][0, :nf]), _np(out16["mel"][0, :nf])
    rel = np.mean(np.abs(mel32 - mel16)) / (np.std(mel32) + 1e-8)
    assert rel < 0.12, f"bf16 StableTTS mel error {rel:.4f}"
    wav32 = tvoc.vocos_apply(to_torch(vtree, "cpu"), vcfg, out32["mel"])
    wav16 = tvoc.vocos_apply(to_torch(vtree, "cpu", BF16), vcfg, out16["mel"])
    assert wav16.dtype == BF16
    n = nf * vcfg.hop_length
    s = snr_db(_np(wav32[0, :n]), _np(wav16[0, :n]))
    assert s > 10.0, f"bf16 StableTTS+Vocos SNR {s:.1f} dB"


# ---------------------------------------------------------------------------
# QuickVC, GPT-SoVITS
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quickvc_model():
    cfg = tq.QuickVCConfig(**QUICKVC)
    tree = to_port_layout(perturb_zero_init(quickvc_init(cfg, seed=3), seed=4))
    rng = np.random.default_rng(1234)
    c = torch.from_numpy(rng.standard_normal((1, 40, 24)).astype(np.float32))
    tgt = torch.from_numpy(rng.standard_normal((1, 200, 80)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((1, 40, cfg.inter_channels)).astype(np.float32))
    return cfg, to_torch(tree, "cpu"), to_torch(tree, "cpu", BF16), c, tgt, noise


def test_quickvc_bf16_serving(quickvc_model):
    """tests/test_bf16_serving.py:171-173: the whole VC graph (LSTM speaker
    embedding, posterior, reverse flow, ms-iSTFT decode) in bf16: a bf16
    waveform, SNR > 15 dB against f32 on the same draw."""
    cfg, p32, p16, c, tgt, noise = quickvc_model
    w32 = tq.infer(p32, cfg, c, tgt, noise=noise)
    w16 = tq.infer(p16, cfg, c.to(BF16), tgt.to(BF16), noise=noise.to(BF16))
    assert w16.dtype == BF16 and w16.shape == w32.shape
    s = snr_db(_np(w32), _np(w16))
    assert s > 15.0, f"bf16 QuickVC SNR {s:.1f} dB"


def test_gpt_sovits_bf16_serving():
    """tests/test_bf16_serving.py:201: SoVITS decode SNR > 15 dB on the same
    draw; the AR decode in bf16 gives valid tokens (its sampled integers may
    flip at near-ties, so they are not compared)."""
    cfg = tg.SoVITSConfig(**SOVITS)
    tree = to_port_layout(perturb_zero_init(sovits_init(cfg, seed=5), seed=6))
    rng = np.random.default_rng(1234)
    codes = torch.from_numpy(rng.integers(0, 20, size=(1, 20)).astype(np.int64))
    text = torch.from_numpy(rng.integers(0, 30, size=(1, 9)).astype(np.int64))
    refer = torch.from_numpy(rng.standard_normal((1, 30, 65)).astype(np.float32))
    tl, rl = torch.tensor([9], dtype=torch.int32), torch.tensor([30], dtype=torch.int32)
    w32 = tg.sovits_decode(to_torch(tree, "cpu"), cfg, codes, text, tl, refer, rl,
                           generator=torch.Generator().manual_seed(6))
    w16 = tg.sovits_decode(to_torch(tree, "cpu", BF16), cfg, codes, text, tl, refer.to(BF16), rl,
                           generator=torch.Generator().manual_seed(6))
    assert w16.dtype == BF16
    s = snr_db(_np(w32), _np(w16))
    assert s > 15.0, f"bf16 SoVITS decode SNR {s:.1f} dB"

    acfg = tg.ARConfig(**AR)
    ap = to_torch(to_port_layout(ar_init(acfg, seed=7)), "cpu", BF16)
    phones = torch.from_numpy(rng.integers(0, 30, size=(1, 8)).astype(np.int64))
    abert = torch.from_numpy(rng.standard_normal((1, 8, acfg.bert_dim)).astype(np.float32))
    prompt = torch.from_numpy(rng.integers(0, 39, size=(1, 5)).astype(np.int64))
    tokens, n = tg.ar_infer(ap, acfg, phones, abert.to(BF16), prompt,
                            generator=torch.Generator().manual_seed(8), max_new=12, top_k=3)
    assert tokens.shape == (1, 12) and (tokens >= 0).all() and (tokens < 40).all()
    assert 0 <= int(n) <= 12


# ---------------------------------------------------------------------------
# C.1: the entry points choose f32
# ---------------------------------------------------------------------------


def test_model_turns_tf32_off(tmp_path):
    """With both TF32 flags set, building a Model (on the CPU) leaves them
    False: the port's f32 is what the tests hold to the JAX package."""
    cfg = tv.VITS2Config(**VITS2)
    save_params(tmp_path / "params.npz", synthesizer_init(cfg, seed=0))
    with open(tmp_path / "config.json", "w", encoding="utf-8") as f:
        json.dump({"model_type": "vits2", "sample_rate": 22050,
                   "phoneme_id_map": {k: [v] for k, v in plain_symbol_map().items()},
                   "model": dataclasses.asdict(cfg)}, f)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        model = tapi.Model(tmp_path, device="cpu")
        assert model.device.type == "cpu"
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
