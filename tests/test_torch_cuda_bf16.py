"""bf16 serving of the port's model families on the card, at bench.py's widths.

Marked ``cuda``: each test skips where there is no NVIDIA GPU. This file
imports no JAX, so on a machine with the card and without JAX it runs as
``python -m pytest tests/test_torch_cuda_bf16.py -m cuda --noconftest -s``.
Each family runs at its default (full-width) configuration, random weights
from a seed, from the f32 tree and from the same tree cast by
``to_torch(..., dtype=torch.bfloat16)``, on f32-pinned durations, with the
gates of tests/test_bf16_serving.py. chip_smoke.py's ``[bf16]`` runs
VITS2Config() (bench.py's workload), a pre_conv variant and the kernels;
here:

* StableTTS: StableTTSConfig() + VocosConfig(), B2, bench.py's 10 Euler
  steps (``N_STEPS``), temperature 0: relative mel error < 0.12, SNR > 10
  dB after Vocos, kernel 3's bf16 launches counted;
* QuickVC: QuickVCConfig() ``infer``: a bf16 waveform, SNR > 15 dB;
* SoVITS: ``sovits_decode`` at SoVITSConfig(): SNR > 15 dB, kernel 1's
  bf16 launches counted (12 a call);
* the AR: ``ar_infer`` at ARConfig() from a bf16 tree (its decode step a
  CUDA graph): valid tokens, no dtype error;
* ROADMAP C.1: ``vc_encode_dataset`` run as a process (the port's entry
  points turn TF32 off) against the same tool in process with TF32 off,
  at a HubertConfig()-width bundle: the f32 parity limit, 1e-5 x peak
  (with cuDNN's TF32 on in the process, such features read 8.428e-4 x
  peak off the CPU's);
* the bf16 rows of the kernel table (chip_smoke.bf16_kernel_cases), each
  kernel within chip_smoke.BF16_TOL of its plain bf16 version;
* the bf16 global kernel (TMA and wgmma) against its plain bf16 version
  within chip_smoke.BF16_TOL in each form (RoPE, packed, separate) at D 48,
  64 and 96 and T 37, 65 and 129 with kv_len 0, 1, T and ragged in one
  batch; at grids of 128-row and of 64-row blocks; and a view that TMA
  cannot load (a start off 16 bytes, a row stride off 8 values) raises
  ValueError before any launch.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from vosk_tts_tpu_torch.models import gpt_sovits, hubert, quickvc, stabletts
from vosk_tts_tpu_torch.models import vocoder as voc
from vosk_tts_tpu_torch.ops import flash_attention as fa
from vosk_tts_tpu_torch.tools import vc_encode_dataset
from vosk_tts_tpu_torch.utils.checkpoint import save_params
from vosk_tts_tpu_torch.utils.params import (ar_init, hubert_init, matcha_init,
                                             perturb_matcha_zero_init, perturb_zero_init,
                                             quickvc_init, sovits_init, to_port_layout, to_torch,
                                             vocos_init)

pytestmark = pytest.mark.cuda

BF16 = torch.bfloat16
N_STEPS = 10  # bench.py's CFM steps


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _trees(tree, dev):
    return to_torch(tree, dev), to_torch(tree, dev, BF16)


def test_stabletts_vocos_bf16(dev):
    cfg, vcfg = stabletts.StableTTSConfig(), voc.VocosConfig()
    p32, p16 = _trees(stabletts.port_layout(
        perturb_matcha_zero_init(matcha_init(cfg, seed=1), seed=2)), dev)
    v32, v16 = _trees(to_port_layout(vocos_init(vcfg, seed=3)), dev)
    rng = np.random.default_rng(4)
    b, t = 2, 96
    x = rng.integers(0, p32["text_encoder"]["punc_emb"].shape[0], (b, 5, t))
    x[:, 0] = rng.integers(1, cfg.n_vocab, (b, t))
    x = torch.as_tensor(x, device=dev)
    xl = torch.tensor([t, 71], dtype=torch.int32, device=dev)
    sid = torch.tensor([1, 2], device=dev)
    bert = torch.as_tensor(rng.standard_normal((b, t, cfg.bert_dim)).astype(np.float32), device=dev)
    with torch.inference_mode():
        enc32 = stabletts.encode_for_synth(p32, cfg, x, xl, sid, bert)
        enc16 = stabletts.encode_for_synth(p16, cfg, x, xl, sid, bert.to(BF16))
        for a, c in zip(enc16["pred_frames"].tolist(), enc32["pred_frames"].tolist()):
            assert abs(a - c) <= max(2, int(0.06 * c)), (a, c)
        fb = chip_smoke.api.pick_ms_frame_bucket(int(enc32["pred_frames"].max()), t)
        fa.GLOBAL_ROPE_KERNEL_BF16.launches = fa.GLOBAL_ROPE_KERNEL.launches = 0
        out16 = stabletts.decode_from_durations(p16, cfg, chip_smoke.bf16_cast(enc32), sid,
                                                max_frames=fb, n_timesteps=N_STEPS,
                                                temperature=0.0)
        assert (fa.GLOBAL_ROPE_KERNEL_BF16.launches, fa.GLOBAL_ROPE_KERNEL.launches) == \
            (N_STEPS * cfg.dec_layers, 0)
        out32 = stabletts.decode_from_durations(p32, cfg, enc32, sid, max_frames=fb,
                                                n_timesteps=N_STEPS, temperature=0.0)
        wav32 = voc.vocos_apply(v32, vcfg, out32["mel"])
        wav16 = voc.vocos_apply(v16, vcfg, out16["mel"])
    assert out16["mel"].dtype == BF16 and wav16.dtype == BF16
    assert torch.equal(out16["mel_lengths"], out32["mel_lengths"])
    for i, nf in enumerate(out32["mel_lengths"].tolist()):
        m32, m16 = out32["mel"][i, :nf].float(), out16["mel"][i, :nf].float()
        rel = float((m32 - m16).abs().mean() / (m32.std() + 1e-8))
        n = nf * vcfg.hop_length
        snr = chip_smoke.snr_db(wav32[i, :n], wav16[i, :n])
        print(f"[cuda bf16] StableTTSConfig() + VocosConfig() row {i}: {nf} frames, mel error "
              f"{rel:.4f} (gate 0.12), Vocos SNR {snr:.2f} dB (gate 10)")
        assert rel < 0.12 and snr > 10.0


def test_quickvc_bf16(dev):
    cfg = quickvc.QuickVCConfig()
    p32, p16 = _trees(to_port_layout(perturb_zero_init(quickvc_init(cfg, seed=5), seed=6)), dev)
    g = torch.Generator(device=dev).manual_seed(7)
    c = torch.randn(1, 250, cfg.ssl_dim, generator=g, device=dev)
    tgt = torch.randn(1, 300, 80, generator=g, device=dev)
    noise = torch.randn(1, 250, cfg.inter_channels, generator=g, device=dev)
    with torch.inference_mode():
        w32 = quickvc.infer(p32, cfg, c, tgt, noise=noise)
        w16 = quickvc.infer(p16, cfg, c.to(BF16), tgt.to(BF16), noise=noise.to(BF16))
    assert w16.dtype == BF16 and w16.shape == w32.shape
    snr = chip_smoke.snr_db(w32, w16)
    print(f"[cuda bf16] QuickVCConfig() infer, 250 frames: SNR {snr:.2f} dB (gate 15)")
    assert snr > 15.0


def test_sovits_and_ar_bf16(dev):
    cfg = gpt_sovits.SoVITSConfig()
    p32, p16 = _trees(to_port_layout(perturb_zero_init(sovits_init(cfg, seed=8), seed=9)), dev)
    rng = np.random.default_rng(10)
    codes = torch.as_tensor(rng.integers(0, cfg.n_codes, (1, 200)), device=dev)
    text = torch.as_tensor(rng.integers(1, cfg.n_symbols, (1, 40)), device=dev)
    refer = torch.as_tensor(rng.standard_normal((1, 200, cfg.spec_channels)).astype(np.float32),
                            device=dev)
    tl, rl = (torch.tensor([n], dtype=torch.int32, device=dev) for n in (40, 200))
    g = torch.Generator(device=dev).manual_seed(11)
    noise = torch.randn(1, 2 * 200, cfg.inter_channels, generator=g, device=dev)
    with torch.inference_mode():
        w32 = gpt_sovits.sovits_decode(p32, cfg, codes, text, tl, refer, rl, noise=noise)
        fa.KERNEL_BF16.launches = fa.KERNEL.launches = 0
        w16 = gpt_sovits.sovits_decode(p16, cfg, codes, text, tl, refer.to(BF16), rl,
                                       noise=noise.to(BF16))
        assert (fa.KERNEL_BF16.launches, fa.KERNEL.launches) == (12, 0)
    assert w16.dtype == BF16
    snr = chip_smoke.snr_db(w32, w16)
    print(f"[cuda bf16] SoVITSConfig() sovits_decode, 200 codes: SNR {snr:.2f} dB (gate 15)")
    assert snr > 15.0

    acfg = gpt_sovits.ARConfig()
    ap = to_torch(to_port_layout(ar_init(acfg, seed=12)), dev, BF16)
    phones = torch.as_tensor(rng.integers(0, acfg.phoneme_vocab_size, (1, 32)), device=dev)
    bert = torch.as_tensor(rng.standard_normal((1, 32, acfg.bert_dim)).astype(np.float32),
                           device=dev).to(BF16)
    prompt = torch.as_tensor(rng.integers(0, acfg.eos, (1, 20)), device=dev)
    with torch.inference_mode():
        tokens, n = gpt_sovits.ar_infer(ap, acfg, phones, bert, prompt,
                                        generator=torch.Generator(device=dev).manual_seed(13),
                                        max_new=48, top_k=5)
    assert tokens.shape == (1, 48) and 0 <= int(n) <= 48
    assert bool((tokens >= 0).all() and (tokens < acfg.vocab_size).all())
    print(f"[cuda bf16] ARConfig() ar_infer from a bf16 tree: n {int(n)}, tokens valid")


def test_entry_point_process_is_f32(dev, tmp_path):
    """ROADMAP C.1: the tool as a process (torch's defaults: cuDNN TF32 on,
    until the tool's entry point turns it off) against the tool in process
    with TF32 off, on the card."""
    cfg = hubert.HubertConfig()
    (tmp_path / "hubert").mkdir()
    save_params(tmp_path / "hubert" / "params.npz", hubert_init(cfg, seed=14))
    (tmp_path / "hubert" / "config.json").write_text(json.dumps(chip_smoke.hubert_hf_config(cfg)))
    rng = np.random.default_rng(15)
    for side in ("proc", "inproc"):
        (tmp_path / side).mkdir()
    for i, seconds in enumerate((2.0, 5.0)):
        chip_smoke.write_voice(str(tmp_path / "proc" / f"w{i}.wav"), rng, int(seconds * 16000),
                               16000)
        data = (tmp_path / "proc" / f"w{i}.wav").read_bytes()
        (tmp_path / "inproc" / f"w{i}.wav").write_bytes(data)
    r = subprocess.run([sys.executable, "-m", "vosk_tts_tpu_torch.tools.vc_encode_dataset",
                        str(tmp_path / "hubert"), str(tmp_path / "proc")],
                       capture_output=True, text=True, cwd=chip_smoke.ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    vc_encode_dataset.main([str(tmp_path / "hubert"), str(tmp_path / "inproc")])
    # what cuDNN's TF32 (torch's default, before the entry points turned it off) moves
    hub = hubert.load_bundle(tmp_path / "hubert", dev)
    wav = chip_smoke.load_wav(str(tmp_path / "proc" / "w1.wav"))[0] / 32768.0
    flags = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        with torch.inference_mode():
            tf32 = hub(torch.as_tensor(wav, device=dev)[None])[0].float().cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = flags
    for i in range(2):
        got, want = (np.load(tmp_path / side / f"w{i}.cv.npy") for side in ("proc", "inproc"))
        assert got.shape == want.shape
        err = float(np.abs(got - want).max()) / float(np.abs(want).max())
        print(f"[cuda bf16] C.1: vc_encode_dataset as a process vs in process (TF32 off), "
              f"w{i}: {err:.3e} x peak (limit 1e-5)")
        assert err <= 1e-5
    print(f"[cuda bf16] C.1: the same HubertConfig() features with cuDNN TF32 on: "
          f"{float(np.abs(tf32 - want).max()) / float(np.abs(want).max()):.3e} x peak off")


def test_bf16_kernel_rows(dev):
    """The bf16 rows of PERF.md's kernel table: each bf16 wrapper at the
    main paths' shapes against its plain bf16 version, kernel, plain and
    library (SDPA bf16) ms and the bound."""
    print("\n| kernel | shape | rel err | kernel ms | graph ms | plain ms | library ms | "
          "library graph ms | bound ms | by |")
    for name, cases in chip_smoke.bf16_kernel_cases().items():
        for c in cases:
            print(f"| {name} | {c['shape']} | {c['rel_err']:.3e} | {c.get('ms', 'n/a')} | "
                  f"{c.get('graph_ms')} | {c.get('plain_ms', 'n/a')} | {c.get('library_ms')} | "
                  f"{c.get('library_graph_ms')} | {c.get('bound_ms')} | {c.get('bound_by')} |")
            assert c["rel_err"] <= chip_smoke.BF16_TOL, (name, c)


def _global_inputs(dev, b, t, h, d, lengths, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(b, t, 3 * h * d, generator=g, device=dev).to(BF16)
    return qkv, torch.tensor(lengths, dtype=torch.int32, device=dev)


def _run_global(form, qkv, kv_len, h, d):
    """The form's wrapper and the plain bf16 version on the same q, k, v."""
    c, sm = h * d, d**-0.5
    q, k, v = (qkv[..., i * c:(i + 1) * c] for i in range(3))
    d_rope = stabletts.d_rope_of(d) if form == "rope" else 0
    if form == "rope":
        got = fa.global_flash_attention_rope(qkv, kv_len, n_heads=h, sm_scale=sm, d_rope=d_rope)
    elif form == "packed":
        got = fa.global_flash_attention_packed(qkv, kv_len, n_heads=h, sm_scale=sm)
    else:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        got = fa.global_flash_attention(q, k, v, kv_len, n_heads=h, sm_scale=sm)
    want = fa.global_attention_plain(q, k, v, kv_len, n_heads=h, sm_scale=sm, d_rope=d_rope)
    return got, want


# kv_len 0, 1, T and ragged in one batch; T ragged against the 64-key tiles and
# the 64- and 128-row blocks; the three head widths the port serves (D48 the
# flow attention, D64 and D96 the DiT)
@pytest.mark.parametrize("t", [37, 65, 129])
@pytest.mark.parametrize("d", [48, 64, 96])
@pytest.mark.parametrize("form", ["rope", "packed", "separate"])
def test_global_bf16_kernel_matches_plain(dev, form, d, t):
    h = 2
    qkv, kv_len = _global_inputs(dev, 4, t, h, d, [0, 1, t, 2 * t // 3], 60 + t + d)
    got, want = _run_global(form, qkv, kv_len, h, d)
    torch.cuda.synchronize()
    assert got.dtype == BF16 and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())
    print(f"[cuda bf16] global {form} B4 H{h} T{t} D{d}: {err:.3e} x max|out|")
    assert err <= chip_smoke.BF16_TOL


# grids of 128-row blocks (two consumer warpgroups), one with a block whose
# second warpgroup's rows all lie past T, and a small grid of 64-row blocks
@pytest.mark.parametrize("form,b,h,t,d", [("rope", 16, 4, 256, 64), ("packed", 32, 4, 129, 96),
                                         ("separate", 16, 2, 1000, 48), ("rope", 2, 4, 512, 96)])
def test_global_bf16_kernel_block_rows(dev, form, b, h, t, d):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = fa.global_block_rows(b, h, t, sms)
    lengths = [t - (7 * i) % t for i in range(b)]
    qkv, kv_len = _global_inputs(dev, b, t, h, d, lengths, 70 + b)
    got, want = _run_global(form, qkv, kv_len, h, d)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())
    print(f"[cuda bf16] global {form} B{b} H{h} T{t} D{d}, {rows}-row blocks: {err:.3e}")
    assert err <= chip_smoke.BF16_TOL


@pytest.mark.parametrize("fault", ["start", "stride"])
def test_global_bf16_kernel_refuses_what_tma_cannot_load(dev, fault):
    """A view that does not start on 16 bytes, or whose row stride is not a
    multiple of 8 values: ValueError, before any launch."""
    h, d, t = 2, 64, 64
    c = h * d
    wide = torch.zeros(2, t, 3 * c + 8 if fault == "start" else 3 * c + 1, dtype=BF16, device=dev)
    qkv = wide[..., 1:1 + 3 * c] if fault == "start" else wide[..., :3 * c]
    kv_len = torch.tensor([t, t], dtype=torch.int32, device=dev)
    before = fa.GLOBAL_PACKED_KERNEL_BF16.launches
    with pytest.raises(ValueError, match="TMA"):
        fa.global_flash_attention_packed(qkv, kv_len, n_heads=h, sm_scale=d**-0.5)
    assert fa.GLOBAL_PACKED_KERNEL_BF16.launches == before
