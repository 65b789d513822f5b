#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vosk_tts_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
result line is printed):

1. device: requires CUDA (no CPU run), prints the card's name and power
   limit, turns TF32 off for matmuls and cuDNN convolutions (f32 parity);
2. build: compiles every CUDA kernel of the serving path from
   vosk_tts_tpu_torch/csrc/ with nvcc for sm_90a, all sources at once;
3. kernels vs plain: each kernel's wrapper on card tensors at the shapes
   the serving path gives it, held against its plain PyTorch version on the
   same inputs, then timed with CUDA events beside that plain version and
   its bound (the larger of bytes over 3.35 TB/s and f32 operations over
   67 TFLOP/s, the H100 SXM's published peaks at 700 W);
4. main path: a full-width MB-iSTFT-VITS2 bundle (VITS2Config(), random
   weights from a seed, zero-initialised projections perturbed) answers 3
   requests through Model/Synth.synth_audio and one synth_batch of 16 texts
   on the card; the launch counts of every kernel over that run must match
   10 banded-attention and 4 DDSConv launches per synthesis call;
5. card vs CPU: one request's encode_for_infer and decode_from_durations
   on the card (kernels) and on the CPU (plain versions, fed the card's
   durations), noise scales 0, compared within stated tolerances.

The lines before the last: the kernels' JSON record, then the
``nvidia-smi --query-gpu=name,power.limit`` line. The last line:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from vosk_tts_tpu_torch import api  # noqa: E402  (fails outside a checkout of the repo)
from vosk_tts_tpu_torch.models import vits2  # noqa: E402
from vosk_tts_tpu_torch.ops import ddsconv_fused as ddf  # noqa: E402
from vosk_tts_tpu_torch.ops import flash_attention as fa  # noqa: E402
from vosk_tts_tpu_torch.text import plain_symbol_map  # noqa: E402
from vosk_tts_tpu_torch.utils import cuda_build  # noqa: E402
from vosk_tts_tpu_torch.utils.checkpoint import save_params  # noqa: E402
from vosk_tts_tpu_torch.utils.params import perturb_zero_init, synthesizer_init  # noqa: E402

PEAK_F32_FLOPS = 67e12   # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
SEED = 0

TEXTS = [
    "Привет мир!",
    "Сегодня хорошая погода, и мы идём гулять в парк.",
    "Как дела? Давно не виделись, расскажи, что у тебя нового.",
    "Съешь же ещё этих мягких французских булок, да выпей чаю.",
    "Я помню чудное мгновенье: передо мной явилась ты.",
    "Москва — столица России.",
    "В лесу родилась ёлочка, в лесу она росла.",
    "Поезд отправляется через пять минут.",
    "Спасибо за покупку!",
    "Пожалуйста, повторите ещё раз, я не расслышал.",
    "Завтра обещают дождь и сильный ветер.",
    "Мама мыла раму.",
    "Откройте дверь, пожалуйста.",
    "Эта книга о приключениях капитана и его команды в далёких морях.",
    "Добрый вечер.",
    "Нажмите кнопку, чтобы продолжить.",
]


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of fn over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def attention_case(b, t, lengths, iters, plain_iters, seed):
    h, d, w = 2, 96, 4
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b, h, t, d, generator=g, device=dev) for _ in range(3))
    q = q * d**-0.5
    rel_k, rel_v = (torch.randn(1, 2 * w + 1, d, generator=g, device=dev) * d**-0.5
                    for _ in range(2))
    kv_len = torch.tensor(lengths, dtype=torch.int32, device=dev)
    args = (q, k, v, rel_k, rel_v, kv_len)
    got = fa.banded_flash_attention(*args, window=w)
    want = fa.banded_attention_plain(*args, window=w)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    out = {"shape": f"B{b} H{h} T{t} D{d}", "max_abs_err": err}
    if iters:
        out["ms"] = cuda_ms(lambda: fa.banded_flash_attention(*args, window=w), iters)
        out["plain_ms"] = cuda_ms(lambda: fa.banded_attention_plain(*args, window=w),
                                  plain_iters)
        valid_keys = sum(lengths)  # masked keys contribute exactly 0: not needed work
        flops = 4 * h * d * t * valid_keys + 4 * b * h * t * (2 * w + 1) * d
        nbytes = 4 * (4 * b * h * t * d + 2 * (2 * w + 1) * d + b)
        out["bound_ms"], out["bound_by"] = bound(flops, nbytes)
    return out


def ddsconv_case(b, t, lengths, iters, plain_iters, seed):
    c, n_layers, k = 256, 3, 3
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    params = {"sep_w": rnd(n_layers, c, k, scale=3**-0.5), "sep_b": rnd(n_layers, c, scale=0.1),
              "pw_w": rnd(n_layers, c, c, scale=c**-0.5), "pw_b": rnd(n_layers, c, scale=0.1),
              "norm1_g": 1 + rnd(n_layers, c, scale=0.1), "norm1_b": rnd(n_layers, c, scale=0.1),
              "norm2_g": 1 + rnd(n_layers, c, scale=0.1), "norm2_b": rnd(n_layers, c, scale=0.1)}
    x = rnd(b, t, c)
    mask = (torch.arange(t, device=dev)[None, :] < torch.tensor(lengths, device=dev)[:, None])
    mask = mask.to(torch.float32)[..., None]
    got = ddf.ddsconv_fused(x, mask, params)
    want = ddf.ddsconv_plain(x, mask, params)
    torch.cuda.synchronize()
    out = {"shape": f"B{b} T{t} C{c} L{n_layers}", "max_abs_err": float((got - want).abs().max())}
    if iters:
        out["ms"] = cuda_ms(lambda: ddf.ddsconv_fused(x, mask, params), iters)
        out["plain_ms"] = cuda_ms(lambda: ddf.ddsconv_plain(x, mask, params), plain_iters)
        rows = sum(lengths)  # masked rows are zero in the output: not needed work
        flops = 2 * rows * c * c * n_layers + rows * c * n_layers * (2 * k + 20)
        nbytes = 4 * (2 * b * t * c + b * t + n_layers * (c * c + c * k + 6 * c))
        out["bound_ms"], out["bound_by"] = bound(flops, nbytes)
    return out


def write_bundle(path, cfg, tree):
    save_params(os.path.join(path, "params.npz"), tree)
    with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as f:
        json.dump({"model_type": "vits2", "sample_rate": 22050, "seed": SEED,
                   "phoneme_id_map": {k: [v] for k, v in plain_symbol_map().items()},
                   "inference": {"noise_level": 0.8, "speech_rate": 1.0,
                                 "duration_noise_level": 0.8},
                   "model": dataclasses.asdict(cfg)}, f, ensure_ascii=False)
    with open(os.path.join(path, "dictionary"), "w", encoding="utf-8") as f:
        f.write("привет 1.0 p rj i0 vj e1 t\nмир 1.0 mj i1 r\n")


def main_path(model):
    """3 requests through Synth.synth_audio and one synth_batch of 16 texts.
    Returns the number of synthesis calls."""
    synth = api.Synth(model)
    up = model.model_config.upsample_factor
    audio_s, elapsed_s, calls = 0.0, 0.0, 0
    for text in TEXTS[:3]:
        t0 = time.perf_counter()
        audio = synth.synth_audio(text)
        dt = time.perf_counter() - t0
        calls += 1
        dur = len(audio) / model.sample_rate
        audio_s, elapsed_s = audio_s + dur, elapsed_s + dt
        print(f"[main] synth_audio {len(audio)} samples ({dur:.2f} s audio) in {dt:.3f} s, "
              f"RTF {dt / dur:.4f}")
        check(audio.dtype == np.int16 and len(audio) > 0 and np.any(audio != 0)
              and len(audio) % up == 0, f"bad audio for {text!r}")
    print(f"[main] RTF over the 3 requests: {elapsed_s / audio_s:.4f}")
    t0 = time.perf_counter()
    batch = synth.synth_batch(TEXTS)
    dt = time.perf_counter() - t0
    calls += 1
    dur = sum(len(a) for a in batch) / model.sample_rate
    print(f"[main] synth_batch of {len(batch)}: {dur:.2f} s audio in {dt:.3f} s, "
          f"RTF {dt / dur:.4f}")
    check(len(batch) == len(TEXTS) and all(
        a.dtype == np.int16 and len(a) > 0 and np.any(a != 0) and len(a) % up == 0
        for a in batch), "bad batch audio")
    return calls


def parity(model, cpu_model):
    """One request's encode_for_infer + decode_from_durations on ``model``'s
    device and on the CPU (fed the first run's durations), noise scales 0."""
    up = model.model_config.upsample_factor
    ids = api.encode_plain(model, TEXTS[1])
    bucket = next(b for b in api.TEXT_BUCKETS if b >= len(ids))
    x = np.zeros((1, bucket), np.int64)
    x[0, :len(ids)] = ids
    runs = []
    for m in (model, cpu_model):
        dev = m.device
        xs = torch.as_tensor(x, device=dev)
        xl = torch.tensor([len(ids)], dtype=torch.int32, device=dev)
        sid = torch.tensor([3], device=dev)
        with torch.inference_mode():
            enc = m.synthesizer.encode_for_infer(xs, xl, sid, noise_scale_w=0.0)
            if runs:  # the card's durations: ceil(exp(.)) turns 1 ulp into a frame
                enc["w_ceil"] = runs[0][0]["w_ceil"].to(dev)
            pred = int(enc["w_ceil"].sum())
            fb = api.pick_frame_bucket(pred, bucket)
            dec = m.synthesizer.decode_from_durations(
                enc, sid, max_frames=fb, noise_scale=0.0,
                gen_frames=api.pick_gen_frames(pred, fb))
        runs.append(({k: v.cpu() for k, v in enc.items()}, {k: v.cpu() for k, v in dec.items()}))
    (enc_g, dec_g), (enc_c, dec_c) = runs
    n = int(dec_g["wav_lengths"][0])
    check(n == int(dec_c["wav_lengths"][0]) == pred * up,
          "wav_lengths differ from the predicted frames")
    trimmed = api.audio_float_to_int16(dec_g["wav"][0, :n, 0].numpy())
    check(len(trimmed) == n and np.isfinite(dec_g["wav"].numpy()).all(), "bad waveform")
    mask = enc_g["x_mask"]
    errs = {k: float(((enc_g[k] - enc_c[k]) * mask).abs().max()) for k in ("m_p", "logs_p")}
    errs["wav"] = float((dec_g["wav"][0, :n] - dec_c["wav"][0, :n]).abs().max())
    errs["w_ceil_frames_differ"] = float((enc_g["w_ceil"] != enc_c["w_ceil"]).sum())
    scale = float(dec_c["wav"][0, :n].abs().max())
    # f32 on both sides; cuDNN, cuBLAS and the kernels sum in other orders than the CPU
    tols = {"m_p": 1e-3, "logs_p": 1e-3, "wav": 1e-3 * scale + 1e-6}
    print(f"[parity] {model.device} vs CPU, {n} samples (|wav| max {scale:.4f}): {errs}, "
          f"tol {tols}")
    for k, tol in tols.items():
        check(errs[k] <= tol, f"{model.device} vs CPU: {k} differs by {errs[k]} > {tol}")


def profile_requests(model):
    """Where the device time goes: torch.profiler over one warm synth_audio
    and one warm synth_batch of 16. Prints the device-busy share of the wall
    time and the kernels with the most device time (not part of the pass
    criteria: a trace without device events is reported as not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    synth = api.Synth(model)
    for name, run in (("synth_audio", lambda: synth.synth_audio(TEXTS[2])),
                      ("synth_batch16", lambda: synth.synth_batch(TEXTS))):
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kern)
        if not kern:
            print(f"[profile] {name}: no device events in the trace (device time not measured)")
            continue
        print(f"[profile] {name}: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
              f"({100 * busy_us / wall_us:.1f}%), {sum(e.count for e in kern)} kernel launches")
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on the card",
              file=sys.stderr)
        return 1

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {kind} x{count}; {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    print("[device] TF32 off for matmul and cuDNN convolutions (f32 parity with the plain versions)")

    # 2. build
    kernels = {"banded_attention": fa.KERNEL, "ddsconv": ddf.KERNEL}
    t0 = time.perf_counter()
    cuda_build.build(list(kernels.values()))
    print(f"[build] {len(kernels)} kernels in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    for name, k in kernels.items():
        k.fn()
        log = k.library.with_suffix(".log")
        usage = [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln] \
            if log.exists() else []
        print(f"[build] {name}: {k.library.name} {'; '.join(usage)}")

    # 3. kernels vs plain on the card
    att_tol, dds_tol = 1e-4, 1e-4
    # batched text (B16 T256) and flow (B16 T2048) shapes, then single-request
    # shapes: a 64-token text bucket, a 512-frame flow bucket, a ragged T=37
    att = [attention_case(16, 256, [256 - 9 * i for i in range(16)], 50, 20, 1),
           attention_case(16, 2048, [2048 - 97 * i for i in range(16)], 10, 3, 3),
           attention_case(1, 64, [53], 50, 20, 6),
           attention_case(1, 512, [437], 50, 20, 7),
           attention_case(1, 37, [37], 0, 0, 2)]
    dds = [ddsconv_case(16, 256, [256 - 13 * i for i in range(16)], 50, 20, 4),
           ddsconv_case(1, 64, [53], 50, 20, 8),
           ddsconv_case(1, 37, [30], 0, 0, 5)]
    for name, shapes, tol in (("banded_attention", att, att_tol), ("ddsconv", dds, dds_tol)):
        for c in shapes:
            print(f"[kernel] {name} {json.dumps(c)} tol {tol}")
            check(np.isfinite(c["max_abs_err"]) and c["max_abs_err"] <= tol,
                  f"{name} at {c['shape']} disagrees with its plain version: {c['max_abs_err']}")

    # 4. the main path at full width, then 5. one request on the card and on the CPU
    cfg = vits2.VITS2Config()
    tree = perturb_zero_init(synthesizer_init(cfg, seed=SEED), seed=SEED + 1)
    with tempfile.TemporaryDirectory(prefix="vits2-full-") as bundle:
        write_bundle(bundle, cfg, tree)
        del tree
        model = api.Model(bundle)
        check(model.device.type == "cuda", "Model() did not default to the card")
        for k in kernels.values():
            k.launches = 0
        calls = main_path(model)
        launches = {name: k.launches for name, k in kernels.items()}
        expected = {"banded_attention": 10 * calls, "ddsconv": 4 * calls}
        print(f"[main] launches over {calls} synthesis calls: {launches} (expected {expected})")
        check(launches == expected, f"kernel launches {launches} != {expected}")
        print(f"[main] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        profile_requests(model)
        parity(model, api.Model(bundle, device="cpu"))

    # the record: each kernel's largest batched shape, launches from the main path
    replaces = {"banded_attention": "vosk_tts_tpu/ops/flash_attention.py:56",
                "ddsconv": "vosk_tts_tpu/ops/ddsconv_fused.py:63"}
    cases = {"banded_attention": att, "ddsconv": dds}
    main_case = {"banded_attention": att[1], "ddsconv": dds[0]}
    record = [{"name": name, "route": "cuda", "source": os.path.relpath(k.source, ROOT),
               "replaces": replaces[name], "launches": launches[name],
               "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
               **{key: main_case[name][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
               "library_ms": None, "shape": main_case[name]["shape"]}
              for name, k in kernels.items()]
    print(json.dumps({"kernels": record}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
