#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vosk_tts_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
result line is printed):

1. device: requires CUDA (no CPU run), prints the card's name and power
   limit, turns TF32 off for matmuls and cuDNN convolutions
   (``utils/precision.full_float32``, which every entry point of the port
   calls: f32 parity);
2. build: compiles every CUDA kernel of the serving and training paths
   from vosk_tts_tpu_torch/csrc/ with nvcc for sm_90a, one nvcc per
   source, all started together;
3. kernels vs plain: each kernel's wrapper on card tensors at the shapes
   the serving paths give it, held against its plain PyTorch version on the
   same inputs, then timed with CUDA events beside that plain version (the
   DDSConv kernel and its plain version as calls replayed from a CUDA graph,
   so that the host's cost of a call is out of their times), its
   bound (the larger of bytes over 3.35 TB/s and operations over
   495/3 TFLOP/s, the H100 SXM's published HBM and TF32 tensor-core peaks
   at 700 W, the TF32 rate divided by the three products of the 3xTF32
   split that keeps f32 accuracy) and, for the global attention, one
   library call (scaled_dot_product_attention) on the same inputs; the
   count of tensor-core instructions (HMMA, HGMMA) in each library's SASS
   is printed, and must not be 0 for any of them; each DDSConv case prints
   the launch geometry the built kernel's plan gives it (grid, cluster
   size, row tile, dynamic shared bytes, product, weight stages, clusters
   resident at once, waves), and a single request's shapes must spread
   over 16 SMs or more; kernel 5 (global attention over separate q, k, v)
   also at the windowless flow attention's shapes (C 96 = 2 heads x 48, B16
   T2048 and B1 T397 with valid lengths below T). The f32 global attention
   (kernels 3-5) takes its TMA route (3xTF32 ``wgmma`` on tiles that TMA
   loads) at every case, a strided view of the packed projection too; its
   times are also replayed from a CUDA graph (``graph_ms``, SDPA's
   ``library_graph_ms``); the ``[build]`` line counts the TF32 HGMMA and
   the UTMALDG in its functions, neither may be 0. Every launch check below
   holds the f32 general route's count (layouts TMA cannot load) at 0;
   3b. bf16 (``[bf16]``): the bf16 entry point of each of the five
   kernels (``*_bf16`` symbols: one bf16 ``mma.sync`` m16n8k16 a fragment
   in the banded attention, bf16 ``wgmma`` on tiles that TMA loads in the
   global attention (kernels 3-5), bf16 ``wgmma`` m64n32k16 in DDSConv;
   the ``[build]`` line counts the BF16 HMMA/HGMMA and the TMA loads
   (UTMALDG) in the bf16 functions: tensor-core instructions must not be
   0, and the global attention's must be HGMMA beside UTMALDG) against
   its plain bf16 version within BF16_TOL x max |out| at the f32 cases'
   batched shape, a B1/B2 shape and a ragged T=37 (kernels 4-5 also at
   B2 T512 and B16 T1024 D48), timed beside it (kernels 3-5 also replayed
   from a CUDA graph, ``graph_ms``: the device's time without the host's),
   its bound (BF16_BOUND_FORMULA: 989 TFLOP/s, the dense bf16 tensor-core
   peak) and, for kernels 3-5, SDPA in bf16 with a boolean key mask; then
   bench.py's VITS2 workload (B16 at text buckets
   64/128/256 with 56/120/250 real tokens) at VITS2Config() from a bf16
   tree (``to_torch(..., dtype=torch.bfloat16)``) and from the f32 one
   through encode_for_infer and decode_from_durations, noise 0: every
   row's frames within max(2, 6%) of f32's, a bf16 waveform of the f32
   lengths on the f32 durations with SNR > 12 dB every row, exactly 6 + 4
   launches of the bf16 banded attention and 4 of the bf16 DDSConv a batch
   and none of another kernel, bf16 and f32 ms a bucket (CUDA events) and
   the peak memory; the same at a ``pre_conv`` VITS2Config() (kernel 5's
   bf16 path: 8 launches a decode; each batch's frames within 6%) and a
   StableTTSConfig() B2 synthesis from a bf16 tree (68 launches of kernel
   3's bf16 wrapper). Every launch check of the phases below also holds
   the bf16 wrappers at 0;
4. VITS2 main path: a full-width MB-iSTFT-VITS2 bundle (VITS2Config(),
   random weights from a seed, zero-initialised projections perturbed)
   answers 3 requests through Model/Synth.synth_audio and one synth_batch of
   16 texts on the card; the launch counts over that run must match 10
   banded-attention and 4 DDSConv launches per synthesis call; then one
   request's encode_for_infer and decode_from_durations on the card and on
   the CPU (fed the card's durations), noise scales 0, within stated
   tolerances;
   4b. serving (``[serve]``): 32 requests from 16 client threads (texts,
   rates 0.8/1.0/1.25 and speakers cycling) through the dynamic batcher
   (serving/batcher.py, max_batch 8, 5 ms wait), once to warm up, once
   measured (audio seconds per wall second, p50/p95 latency, batches and
   decode groups; launches must be 6 banded attention and 4 DDSConv per
   encode call plus 4 banded attention per decode group), once under
   torch.profiler (device busy share); then 4 of them at noise 0 in one
   batch held to Synth.synth_audio and to themselves alone at the batch's
   decode geometry (serve_parity); then ``[serve-grpc]``, where grpc and
   protobuf import: make_server on 127.0.0.1 and 4 concurrent requests
   through SynthesizerClient (WAV header, 22050 Hz, frame count);
   4c. VITS2 voice conversion (``[vits2-vc]``): Synthesizer.voice_conversion
   on the full-width bundle, speaker 0 -> 3, y the port's log-mel of two
   ``[main]`` waveforms (one padded row in a batch of two); 8 banded
   attention launches a call (the 4 flows forward and in reverse), the
   card's waveforms held to the CPU's as in ``[parity]``, and the banded
   attention kernel against its plain version at that shape;
5. multistream main path: a full-width multistream_v3 bundle
   (StableTTSConfig(), HiFiGAN v1, ruBERT-base-wide BertConfig(), random
   weights from a seed with the adaLN-Zero projections and CFG fakes
   perturbed, a synthetic WordPiece vocabulary) answers 3 requests through
   Model/Synth.synth_audio and runs one batch of the 16 texts at model level
   (encode_for_synth, decode_from_durations, hifigan_apply); the launch
   counts over that run must be 68 global RoPE attention launches per
   synthesis call (2 x 4 encoder layers + 10 Euler steps x 6 decoder
   layers) and none of the other kernels; then the shortest text's passes
   and vocoder on the card and on the CPU (fed the card's durations),
   temperature 0, within stated tolerances;
   5b. serving (``[ms-serve]``): 8 requests from 8 threads as in 4b (BERT
   runs in the client threads), launches 8 global RoPE attention per
   encode call and 60 per decode group; the parity of 4 of them at
   temperature 0; ``[serve-grpc]``: one multistream request over the wire
   (or ``[serve-grpc] not run: <module> is not installed``);
   5c. the VITS2 variants (``[variants ...]``): four full-width bundles
   (VITS2Config() widths, random weights from the seed, projections
   perturbed, 256 samples a frame): ``pre_conv`` + ``istft`` (upsampling
   8 x 8), ``fft`` + ``hifigan`` (8 x 8 x 2 x 2),
   ``mono_layer_inter_residual`` + ``ms_istft``/onnx + the deterministic
   duration predictor, ``mono_layer_post_residual`` + ``mb_istft``/onnx
   (fused tail); each answers 3 requests through Model/Synth.synth_audio
   (the first also a synth_batch of 16), launches held per synthesis call
   to 6 of kernel 1, 4 of kernel 2 with the SDP (else 0) and 8 of kernel 5
   for pre_conv and the mono flows (4 flows x 2 windowless layers, else
   0); one request profiled; one request card vs CPU as ``[parity]``;
   on the ``pre_conv`` bundle ``voice_conversion`` B2 as ``[vits2-vc]``
   with 16 launches of kernel 5 a call, and kernel 5 against its plain
   version at that shape;
   5d. the multistream vocoders (``[ms-vocoders ...]``): the ``[ms-main]``
   bundle written with a Vocos() vocoder (head scaled by 0.1) and with a
   BigVGANConfig() vocoder: 3 requests each (RTF, 68 launches of kernel 3
   a call, no other kernel), the vocoder alone on a 32-frame mel on the
   card and on the CPU within 1e-3 x peak, one request profiled;
6. voice conversion (``[vc]``): pipelines.convert_voice at full width
   (ContentVec/HuBERT 12 x 768 and QuickVC with its 512-channel ms-iSTFT
   generator, random weights from the seed), a 10 s source and a 5 s
   target at 16 kHz: RTF, each stage's time between CUDA events, the busy
   share and launches under torch.profiler, no hand-written kernel
   launched; then a 3 s source on the card and on the CPU within 1e-3 x
   peak, equal lengths;
7. zero-shot cloning (``[clone]``): GPT-SoVITS at full width (ARConfig()
   24 x 512, SoVITSConfig() with its 512-channel HiFiGAN at 32 kHz,
   HubertConfig(); random weights from the seed, couplings perturbed), a
   5 s reference: 3 Russian requests through pipelines.clone_tts (RTF,
   launches: exactly 12 banded attention a sovits_decode call, nothing
   else); at bench.py's shapes (text 128, prompt 64, 256 new tokens with
   min_new = max_new) the prefill, the decode step eager and replayed from
   its CUDA graph (ms a token; greedy tokens of the two equal), AR tokens/s
   at B1 and B8 through ar_infer/ar_infer_batch, sovits_decode at 512 codes
   with a 200-frame reference (ms, audio s per s); busy share under
   torch.profiler, peak memory; the card against the CPU under greedy
   decoding, 32 tokens, noise 0: equal prompt codes, tokens and n,
   teacher-forced logits within 1e-4 x max |logit|, the waveform within
   1e-3 x peak; the banded attention kernel against its plain version at
   the clone shapes (B1 T1024, B1 T128, and a 5-phone text);
8. long-text cloning (``[clone-long]``): pipelines.clone_tts_long on a
   six-sentence paragraph, max_batch 8, greedy: chunks, tokens, audio
   seconds, wall, AR and decode groups, 12 banded attention launches a
   decode group; each row of each batched AR decode equal to its text run
   alone through ar_infer on the card;
9. VITS2 GAN training (``[train]``): a synthetic corpus from the seed (48
   utterances of 2-6 s at 22.05 kHz, texts of TEXTS through the port's
   G2P) and the reference config.json at full width (VITS2Config(),
   TrainConfig(): periods 2/3/5/7/11, spectral FFTs 1024/2048/512, the
   duration discriminator; batch 24, 32-frame segments);
   train.run_vits2.main for 3 steps, its STATE_3 restored into a fresh
   state (step, params, AdamW state equal), a resumed run for one more
   step, finite losses; over those 4 steps the MAS kernel launches 4 times
   and kernels 1-2 none (training takes their differentiable routes), and
   one step of the timed five launches MAS once; ms a step by CUDA events
   after 2 warm-up steps, steps/s, segment audio s per s, peak memory, one
   step under torch.profiler (busy share, launches, top kernels); the MAS
   kernel exactly equal to its plain version at the step's shape and at
   B24 T_y 800 T_x 200, with times and bound; one f32 step at B2 on the
   card and on the CPU (fed the card's alignment) from the same params,
   noise and batch: losses within 1e-3 relative, the largest gradient
   difference of each network printed; the exported G_*.npz written as a
   bundle and served through Model (10 banded attention and 4 DDSConv
   launches); one bf16 step with finite losses;
10. StableTTS CFM training (``[train-stabletts]``): a synthetic corpus from
   the seed (36 utterances of 2-8 s at 22.05 kHz, texts of TEXTS with
   their phones from the port's G2P as the aligned text, kaldi ``.lab``
   durations that sum to each mel's frames) and a BertConfig() (12 x 768)
   bundle with the synthetic vocabulary, at full width (StableTTSConfig(),
   StableTrainConfig(): accumulate 4, clip 5); train.run_stabletts.main
   with ``--bert-dir`` for 8 micro-steps (two updates), its STATE_8
   restored into a fresh state (step, params, AdamW state and accumulated
   gradients equal), no hand-written kernel launched; micro-steps and
   optimizer steps at batch 6 by CUDA events, peak memory, one of each
   under torch.profiler; one accumulation cycle at B2 on the card and on
   the CPU in f32 and f64 from the same tree and draws
   (``[train-stabletts-parity]``: losses 1e-3 relative, the applied
   gradient 1e-2 relative L2 of the f64 step's); the trained tree (the
   serving layout) synthesises one request through stabletts.synthesise
   with 68 launches of kernel 3;
11. QuickVC GAN training (``[train-vc]``): 72 utterances of 3-6 s at 16
   kHz with ``.cv.npy`` sidecars from a full-width HubertConfig() on the
   card, at full width (QuickVCConfig(): 641 spectral channels, ms-iSTFT;
   VCTrainConfig(); batch 64, max_speclen 512); train.run_vc.main for 3
   steps, its STATE_3 restored into a fresh state, no hand-written kernel
   launched; steps by CUDA events, peak memory, one under torch.profiler;
   one B2 step on the card and on the CPU in f32 and f64 with the D
   learning rate 0 (``[train-vc-parity]``: losses 1e-3 relative, G and D
   gradients 1e-2 relative L2 of the f64 step's);
12. GPT-SoVITS S1 training (``[train-s1]``): 48 rows of TEXTS' aligned
   phones with 2-8 s of random 25 Hz codes (phone rates inside the
   filters' [3, 25]/s, so every row is kept; ``.bert.npy`` rows for half),
   at full width (ARConfig() 24 x 512, S1TrainConfig(): ScaledAdam locked
   at lr 0.002), batch 8 (the 128-phone and 256-code buckets);
   train.run_gpt_sovits.main --stage s1 for 3 steps, its STATE_3 restored
   into a fresh state (parameters, ScaledAdam's per-parameter and global
   state equal), no hand-written kernel launched; steps by CUDA events
   (steps/s, semantic tokens/s), peak memory, one profiled; one DPO step
   at the halved batch; ``[train-s1-parity]``: a ScaledAdam step and a DPO
   step at B2 on the card, in f32 and f64 on the CPU (spans pinned): the
   loss 1e-3 relative, the gradient 1e-2 relative L2 of the f64 step's;
13. GPT-SoVITS S2 training (``[train-s2]``): 36 utterances of 2-8 s at 32
   kHz with seeded 768-wide ``.ssl.npy`` features at 50 Hz, at full width
   (SoVITSConfig(), S2TrainConfig(): hop 640, 32-frame segments, 128
   mels), batch 8; run_gpt_sovits --stage s2 for one step (the codebook's
   k-means: ``vq inited`` and the cluster-size sum printed), resumed to
   step 3 (both runs in deterministic algorithms), STATE_3 restored into a fresh state (EMA buffers included), no
   hand-written kernel launched in a step; steps timed and profiled; the
   trained tree (the bundle layout, its codebook the EMA's) decodes one
   utterance through ``sovits_decode`` on the card, 12 launches of kernel
   1, within 1e-3 x peak of the CPU's decode of the same codes, and kernel
   1 against its plain version at that SSL encoder shape;
   ``[train-s2-parity]``: one step at B2 from STATE_3's trees and fresh
   EMA buffers on the card (deterministic algorithms), in f32 and f64 on
   the CPU (k-means rows, posterior noise, slice starts pinned; D lr 0):
   losses 1e-3 relative (one that is 0 in exact arithmetic, 1e-6
   absolute), G and D gradients 1e-2 relative L2 of the f64 step's, the
   EMA buffers card vs CPU 1e-5 relative, summed over each group of codes
   that k-means starts equal (which of them takes a row falls by
   rounding), and the same check failing two faults planted in the card's
   EMA step (a decay off by 0.01, one row moved to another group's code);
14. VITS2 variant training (``[train-variants ...]``, run after 9, on a
   corpus written as 9's): each of six variants at VITS2Config() widths
   (``plain`` +
   ``ms_istft``, ``pre_conv`` + ``istft``, ``pre_conv2`` + ``mb_istft``/onnx
   + ``dp_apply``, ``fft`` + ``hifigan``, ``mono_layer_inter_residual`` +
   ``ms_istft``/onnx + ``dp_apply``, ``mono_layer_post_residual`` +
   ``istft``/onnx; 256 samples a frame each) with TrainConfig(): run_vits2
   --max-steps 2 at B24 (MAS 2 launches, no other kernel), 2 steps timed
   (MAS once a step), peak memory; G_2.npz served through
   Model/Synth with per_synthesis_call's launches of kernels 1, 2 and 5
   and the CPU's length; ``[... parity]``: one B2 step card vs CPU (every
   lr but G's 0; the card, as in every VITS2 parity step, in deterministic
   algorithms: ROADMAP C.4): losses 1e-3 relative, and for the ``dp_apply`` variants
   the G, D and durD gradients against a CPU f64 step, 1e-2 relative L2;
15. the WavLM/SLM loss (``[train-slm]``): a WavLMConfig() directory
   (base-plus 12 x 768, 94 M parameters, from wavlm_init; config.json in
   the Hugging Face form) and run_vits2 --wavlm-dir at full width, B24: 3
   steps, STATE_3 restored (the WavLM discriminator and its AdamW state
   included), a resumed step, MAS 4 launches and nothing else; 3 steps
   timed and one profiled; ``resample`` 22050 -> 16000 card vs CPU within
   1e-5 x peak; ``[train-slm-parity]``: one B2 step card vs CPU f32 and f64
   with the full-width WavLM (every lr but G's 0): every loss (with
   ``loss_slm_disc``, ``loss_lm``, ``loss_lm_gen``) 1e-3 relative, the G,
   D, durD and WavLM-discriminator gradients 1e-2 relative L2 of the f64
   step's;
16. evaluation (``[eval]``): the ``[main]`` bundle again (the same seed)
   through the eval harness on the card: tools.build_examples (5
   speakers) and batch_synthesize (5 speakers x 2 texts) to WAVs (22050 Hz
   int16, nonzero), eval_rtf over the 16 TEXTS, each stage in a
   profiling.StageTimer; launches exactly per_synthesis_call's a call and no
   other kernel; speaker_similarity and frechet_audio_distance with the
   default (committed artifact) embedder on the card; lstm_embedder card vs
   CPU 1e-4 absolute; ``python -m vosk_tts_tpu_torch.tools.eval_tts`` with
   ``--ref-dir`` at the batch_synthesize WAVs, its JSON line parsed;
17. Whisper content features (``[whisper]``): WhisperEncConfig() ("small",
   12 x 768, 1500 positions, ~88 M parameters from whisper_init):
   get_content of a 10 s and a 29.9 s waveform (shapes), card vs CPU
   log-mel 1e-4 absolute and features 1e-3 x peak (f32, TF32 off); a call
   timed between CUDA events and by profiling.device_timeit, within 25%;
   peak memory, one call profiled; profiling.trace writes a non-empty file
   and device_stats lists the card; no hand-written kernel;
18. the GE2E speaker encoder (``[ge2e]``): train_speaker_encoder at its
   defaults on the card (400 steps): the loss falls, steps/s, the held-out
   check of tests/test_speaker_embedder.py (same > 0.75, same > cross +
   0.15); ``python -m vosk_tts_tpu_torch.tools.train_speaker_embedder
   --steps 400 --out <tmp>`` on the card, its artifact loaded;
   ``[ge2e-parity]``: one step from the trained tree card vs CPU f32 and
   f64: the loss 1e-4 relative, the gradients 1e-2 relative L2 of the f64
   step's;
19. data- and tensor-parallel training and ``synth_batch`` over replicas
   (``[dist]``, vosk_tts_tpu_torch/parallel/): (a) a data-parallel VITS2
   step of two ranks (this script with ``--dist-rank``, both on cuda:0
   with LOCAL_WORLD_SIZE 2, so ``mesh.initialize`` joins them over gloo:
   NCCL refuses two ranks on one card) at VITS2Config() and
   TrainConfig(), global B24 = 2 x 12 of ``[train]``'s corpus, draws
   pinned per row, against the 1-rank B24 step, both in deterministic
   algorithms: every loss 1e-3 relative, each network's gradients 1e-2
   relative L2, the ranks' gradients and parameters equal, MAS once a
   rank; (b) ``run_vits2 --distributed`` as one NCCL rank (torchrun's
   environment) for 2 steps, STATE_2 restored, a resumed step; (c) the
   generator tensor-parallel over a model axis of 2 (each rank half of
   the sharded weights) at VITS2Config() width against the unsharded one,
   1e-3 x peak; (d) ``Synth.synth_batch`` of 5 texts (padded to 6) over two
   replicas on cuda:0 against one, noise 0: equal lengths, 1e-3 x peak,
   20 launches of kernel 1 and 8 of kernel 2. Any rank that fails, exits
   non-zero or outlives DIST_TIMEOUT (its group times out too) fails the
   phase;
20. the checkpoint converters and data tools (``[tools]``,
   vosk_tts_tpu_torch/tools/, each run as a user runs it where it is a
   command): (a) ``make_demo_bundle --full`` served by ``Model`` (no device
   argument) for 3 requests, 10 + 4 launches of kernels 1-2 a call,
   ``parity`` against the CPU; (b) a VITS2Config() tree (pre_conv2 flows)
   written as a reference ``G_7.pth`` with weight-norm pairs split
   (tests/torch_ref_layout.py), ``convert_checkpoint`` back to the tree
   (folded leaves 1e-6 relative, every other leaf equal), served with
   (a)'s launches, its int16 waveform within 1 step of the source
   bundle's on the source's durations at noise 0; (c) an HF HuBERT
   directory at HubertConfig() width as ``pytorch_model.bin`` and as
   ``model.safetensors`` through ``convert_hubert`` (equal bundles), then
   ``vc_encode_dataset`` and ``gpt_sovits_prepare`` (a SoVITSConfig() npz)
   over 2, 5 and 10 s wavs on the card against the CPU: features 1e-3 x
   peak, semantic codes equal but for ties (both candidates' distances
   within 1e-5 relative, at most 1% of codes); (d) ``stabletts_bootstrap``:
   the mel statistics of 8 wavs card vs CPU 1e-5 relative, and durations
   from a StableTTSConfig() ``STATE_0.pt`` with BertConfig() rows: every
   row's durations sum to its frames, kernel 3 2 x 4 and MAS once a batch,
   the card's paths scored under the CPU's log-prior within 1e-5 of the
   CPU's best paths; (e) ``train_g2p.train`` at its default widths on a
   synthetic 4096-word lexicon, B256, 208 steps on the card: the loss
   halves, step 0 within 1e-4 of the CPU's, the exported artifact loads
   in ``NeuralG2P`` and predicts. Each phase prints its wall time.

The lines before the last: the kernels' JSON record (the five f32
wrappers, kernel 1 at the clone shapes, the five bf16 wrappers, MAS),
then the ``nvidia-smi --query-gpu=name,power.limit`` line. The last line:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import contextlib
import dataclasses
import hashlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import wave
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from vosk_tts_tpu_torch import api  # noqa: E402  (fails outside a checkout of the repo)
from vosk_tts_tpu_torch import pipelines  # noqa: E402
from vosk_tts_tpu_torch.eval import harness, speaker_embed, speaker_train  # noqa: E402
from vosk_tts_tpu_torch.models import (bert, bigvgan, gpt_sovits, hubert, quickvc,  # noqa: E402
                                        stabletts, vits2, wavlm, whisper)
from vosk_tts_tpu_torch.models import vocoder as voc  # noqa: E402
from vosk_tts_tpu_torch.ops import ddsconv_fused as ddf  # noqa: E402
from vosk_tts_tpu_torch.ops import flash_attention as fa  # noqa: E402
from vosk_tts_tpu_torch.ops import mas  # noqa: E402
from vosk_tts_tpu_torch.ops import rvq  # noqa: E402
from vosk_tts_tpu_torch.ops.resample import resample  # noqa: E402
from vosk_tts_tpu_torch.ops.stft import mel_spectrogram, spectrogram  # noqa: E402
from vosk_tts_tpu_torch.serving import batcher as batcher_mod  # noqa: E402
from vosk_tts_tpu_torch.serving.batcher import BatchSynthesizer  # noqa: E402
from vosk_tts_tpu_torch.text import Cleaner, multistream_symbol_map, plain_symbol_map  # noqa: E402
from vosk_tts_tpu_torch.text import convert  # noqa: E402
from vosk_tts_tpu_torch.train import (gpt_sovits_data, gpt_sovits_train,  # noqa: E402
                                      run_gpt_sovits, run_stabletts, run_vc, run_vits2,
                                      stabletts_data, stabletts_train, vc_data, vc_train)
from vosk_tts_tpu_torch.text import neural_g2p  # noqa: E402
from vosk_tts_tpu_torch.tools import build_examples, convert_hubert, gpt_sovits_prepare  # noqa: E402
from vosk_tts_tpu_torch.tools import stabletts_bootstrap, train_g2p, vc_encode_dataset  # noqa: E402
from vosk_tts_tpu_torch.train import vits2_train as tt  # noqa: E402
from vosk_tts_tpu_torch.train.data import (BucketBatcher, TTSDataset, load_wav,  # noqa: E402
                                           text_to_ids_aligned)
from vosk_tts_tpu_torch.train.gpt_sovits_data import ShuffleBatcher  # noqa: E402
from vosk_tts_tpu_torch.train.driver_common import resume_state, to_device  # noqa: E402
from vosk_tts_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from vosk_tts_tpu_torch.utils import cuda_build, profiling  # noqa: E402
from vosk_tts_tpu_torch.utils.checkpoint import load_params, save_params  # noqa: E402
from vosk_tts_tpu_torch.utils.precision import full_float32  # noqa: E402
from vosk_tts_tpu_torch.utils.torch_params import read_state_dict  # noqa: E402
from vosk_tts_tpu_torch.models.tree import TreeModule  # noqa: E402
from vosk_tts_tpu_torch.utils.params import (ar_init, bert_init, bigvgan_init,  # noqa: E402
                                             hifigan_init, hubert_init, matcha_init,
                                             perturb_matcha_zero_init, perturb_zero_init,
                                             quickvc_init, sovits_init, synthesizer_init,
                                             to_port_layout, to_torch, vocos_init, wavlm_init,
                                             whisper_init)

# H100 SXM at 700 W: TF32 tensor cores 495 TFLOP/s dense, a third of it for
# f32-accurate products (3xTF32: three TF32 products per f32 product); HBM3
PEAK_3XTF32_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12
BOUND_FORMULA = "max(operations / (495e12/3 FLOP/s, 3xTF32), bytes / 3.35e12 B/s)"
# the bf16 kernels: one bf16 product a fragment on the dense bf16 tensor cores
PEAK_BF16_FLOPS = 989e12
BF16_BOUND_FORMULA = "max(operations / (989e12 FLOP/s, bf16), bytes / 3.35e12 B/s)"
BF16 = torch.bfloat16
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


def graph_ms(fn, iters, warmup=2):
    """Mean device time of fn over ``iters`` calls captured in one CUDA graph
    and replayed (CUDA events): the host's cost of each call is out of the
    time, where cuda_ms of a kernel of tens of microseconds would time the
    wrapper's Python instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes, dtype=torch.float32):
    """The least time in ms for ``flops`` operations (f32-accurate, or bf16
    products) and ``nbytes`` moved, and which of the two bounds it
    (BOUND_FORMULA, BF16_BOUND_FORMULA)."""
    peak = PEAK_BF16_FLOPS if dtype == BF16 else PEAK_3XTF32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def errors(got, want, dtype):
    """max |got - want| and, for bf16, that over max |want| (the bf16
    cases' tolerance is relative: a few bf16 ulps of the output's peak)."""
    err = float((got.float() - want.float()).abs().max())
    out = {"max_abs_err": err}
    if dtype == BF16:
        out["rel_err"] = err / float(want.float().abs().max())
    return out


def attention_case(b, t, lengths, iters, plain_iters, seed, dtype=torch.float32):
    h, d, w = 2, 96, 4
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b, h, t, d, generator=g, device=dev) for _ in range(3))
    q = q * d**-0.5
    rel_k, rel_v = (torch.randn(1, 2 * w + 1, d, generator=g, device=dev) * d**-0.5
                    for _ in range(2))
    kv_len = torch.tensor(lengths, dtype=torch.int32, device=dev)
    args = tuple(a.to(dtype) for a in (q, k, v, rel_k, rel_v)) + (kv_len,)
    got = fa.banded_flash_attention(*args, window=w)
    want = fa.banded_attention_plain(*args, window=w)
    torch.cuda.synchronize()
    check(got.dtype == dtype, f"banded attention returned {got.dtype} for {dtype}")
    out = {"shape": f"B{b} H{h} T{t} D{d}", "dtype": str(dtype)[6:], **errors(got, want, dtype)}
    if iters:
        out["ms"] = cuda_ms(lambda: fa.banded_flash_attention(*args, window=w), iters)
        out["plain_ms"] = cuda_ms(lambda: fa.banded_attention_plain(*args, window=w),
                                  plain_iters)
        valid_keys = sum(lengths)  # masked keys contribute exactly 0: not needed work
        flops = 4 * h * d * t * valid_keys + 4 * b * h * t * (2 * w + 1) * d
        nbytes = args[0].element_size() * (4 * b * h * t * d + 2 * (2 * w + 1) * d) + 4 * b
        out["bound_ms"], out["bound_by"] = bound(flops, nbytes, dtype)
    return out


def ddsconv_case(b, t, lengths, iters, plain_iters, seed, dtype=torch.float32):
    """The DDSConv kernel at one shape against its plain version, with the
    launch geometry its plan gives; timed (``iters`` calls in a CUDA graph,
    graph_ms) beside the plain version."""
    c, n_layers, k = 256, 3, 3
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    params = {"sep_w": rnd(n_layers, c, k, scale=3**-0.5), "sep_b": rnd(n_layers, c, scale=0.1),
              "pw_w": rnd(n_layers, c, c, scale=c**-0.5), "pw_b": rnd(n_layers, c, scale=0.1),
              "norm1_g": 1 + rnd(n_layers, c, scale=0.1), "norm1_b": rnd(n_layers, c, scale=0.1),
              "norm2_g": 1 + rnd(n_layers, c, scale=0.1), "norm2_b": rnd(n_layers, c, scale=0.1)}
    x = rnd(b, t, c).to(dtype)
    params = {n: a.to(dtype) for n, a in params.items()}
    mask = (torch.arange(t, device=dev)[None, :] < torch.tensor(lengths, device=dev)[:, None])
    mask = mask.to(dtype)[..., None]
    got = ddf.ddsconv_fused(x, mask, params)
    want = ddf.ddsconv_plain(x, mask, params)
    torch.cuda.synchronize()
    check(got.dtype == dtype, f"ddsconv returned {got.dtype} for {dtype}")
    out = {"shape": f"B{b} T{t} C{c} L{n_layers}", "dtype": str(dtype)[6:],
           **errors(got, want, dtype)}
    plan = ddf.kernel_plan(b, t, c, n_layers, k, dtype)
    clusters = plan["grid"][0] * plan["grid"][1] // plan["cluster"]
    out |= {"grid": list(plan["grid"]), "cluster": plan["cluster"],
            "ctas": plan["grid"][0] * plan["grid"][1], "row_tile": plan["row_tile"],
            "smem_bytes": plan["smem_bytes"], "product": plan["product"],
            "weight_stages": plan["stages"], "max_active_clusters": plan["max_active_clusters"],
            "waves": -(-clusters // plan["max_active_clusters"])}
    if b == 1:
        check(out["ctas"] >= 16, f"ddsconv B1 T{t} launches {out['ctas']} CTAs, fewer than 16")
    if iters:
        out["ms"] = graph_ms(lambda: ddf.ddsconv_fused(x, mask, params), iters)
        out["plain_ms"] = graph_ms(lambda: ddf.ddsconv_plain(x, mask, params), plain_iters)
        rows = sum(lengths)  # masked rows are zero in the output: not needed work
        flops = 2 * rows * c * c * n_layers + rows * c * n_layers * (2 * k + 20)
        nbytes = x.element_size() * (2 * b * t * c + b * t + n_layers * (c * c + c * k + 6 * c))
        out["bound_ms"], out["bound_by"] = bound(flops, nbytes, dtype)
    return out


def global_case(form, b, t, d, lengths, iters, plain_iters, seed, h=4, dtype=torch.float32):
    """The global attention kernel in one of its forms ("rope": the DiT's
    fused projection with RoPE on d_rope = (d//2)//2*2 features; "strided":
    the same as a view into wider rows, 16-byte aligned; "packed";
    "separate") against its plain version, timed beside it and beside
    scaled_dot_product_attention on the same q, k, v with a boolean key mask
    (for "rope" on q and k rotated beforehand: the rotation is not in the
    library's time), both also replayed from a CUDA graph (``graph_ms``,
    ``library_graph_ms``), which leaves the host's cost of a call out. In
    f32 the route the wrapper took ("tma" or "general", by the general
    route's launch count)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    c, sm = h * d, d**-0.5
    d_rope = stabletts.d_rope_of(d) if form in ("rope", "strided") else 0
    kv_len = torch.tensor(lengths, dtype=torch.int32, device=dev)
    if form == "strided":  # the packed projection 8 values into rows 40 values wider
        qkv = torch.randn(b, t, 3 * c + 40, generator=g, device=dev).to(dtype)[..., 8:8 + 3 * c]
    else:
        qkv = torch.randn(b, t, 3 * c, generator=g, device=dev).to(dtype)
    q, k, v = (qkv[..., i * c:(i + 1) * c] for i in range(3))
    if form == "separate":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        run = lambda: fa.global_flash_attention(q, k, v, kv_len, n_heads=h, sm_scale=sm)
    elif form == "packed":
        run = lambda: fa.global_flash_attention_packed(qkv, kv_len, n_heads=h, sm_scale=sm)
    else:
        run = lambda: fa.global_flash_attention_rope(qkv, kv_len, n_heads=h, sm_scale=sm,
                                                     d_rope=d_rope)
    plain = lambda: fa.global_attention_plain(q, k, v, kv_len, n_heads=h, sm_scale=sm,
                                              d_rope=d_rope)
    general = fa.GLOBAL_GENERAL_KERNEL.launches
    got, want = run(), plain()
    torch.cuda.synchronize()
    check(got.dtype == dtype, f"global attention returned {got.dtype} for {dtype}")
    out = {"shape": f"B{b} H{h} T{t} D{d} d_rope{d_rope}", "dtype": str(dtype)[6:],
           **errors(got, want, dtype)}
    if dtype == torch.float32:
        out["route"] = "general" if fa.GLOBAL_GENERAL_KERNEL.launches > general else "tma"
    if iters:
        out["ms"] = cuda_ms(run, iters)
        out["plain_ms"] = cuda_ms(plain, plain_iters)
        flops = 4 * h * d * t * sum(lengths)  # keys past kv_len add exactly 0: not needed work
        out["bound_ms"], out["bound_by"] = bound(flops, qkv.element_size() * (4 * b * t * c), dtype)
        heads = lambda a: a.reshape(b, t, h, d).transpose(1, 2).contiguous()
        lq, lk, lv = heads(q), heads(k), heads(v)
        if d_rope:
            cos, sin = fa.rope_tables(t, d_rope, dev)
            lq, lk = (fa.apply_rope(a, cos, sin).to(dtype) for a in (lq, lk))
        mask = (torch.arange(t, device=dev)[None, :] < kv_len[:, None])[:, None, None, :]
        lib = lambda: F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask, scale=sm)
        lib_out = lib().transpose(1, 2).reshape(b, t, c)
        out["library_err"] = float((lib_out.float() - want.float()).abs().max())
        out["library_ms"] = cuda_ms(lib, iters)
        del lib_out
        # replayed from a CUDA graph: the device's time without the host's
        out["graph_ms"] = graph_ms(run, iters)
        out["library_graph_ms"] = graph_ms(lib, iters)
    return out


def tensor_core_instructions(library):
    """Counts of HMMA and HGMMA instructions and of TMA tile loads
    (UTMALDG) in a built library's SASS (cuobjdump), in all its functions
    and, as "bf16", in the bf16 instantiations (function names with bf16 or
    bfloat16): the products whose operands are BF16, and the TMA loads; as
    "tf32", the HGMMA with TF32 operands and the UTMALDG of the f32 global
    attention's TMA route (global_attention_tf32_kernel); None where the
    toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "--dump-sass", str(library)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    counts = {name: len(re.findall(rf"\b{name}\.", sass)) for name in ("HMMA", "HGMMA")}
    counts["UTMALDG"] = len(re.findall(r"\bUTMALDG\b", sass))  # TMA tile loads
    # SASS lists each function under "Function : <mangled name>"
    bf16_sass = "".join(part for part in re.split(r"\n\s*Function : ", sass)[1:]
                        if re.match(r"\S*(bf16|bfloat16)", part))
    counts["bf16"] = {name: len(re.findall(rf"\b{name}\.\S*BF16", bf16_sass))
                      for name in ("HMMA", "HGMMA")}
    counts["bf16"]["UTMALDG"] = len(re.findall(r"\bUTMALDG\b", bf16_sass))
    tf32_sass = "".join(part for part in re.split(r"\n\s*Function : ", sass)[1:]
                        if re.match(r"\S*global_attention_tf32_kernel", part))
    counts["tf32"] = {"HGMMA": len(re.findall(r"\bHGMMA\.\S*TF32", tf32_sass)),
                      "UTMALDG": len(re.findall(r"\bUTMALDG\b", tf32_sass))}
    return counts


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


def main_path(model, tag="main", with_batch=True):
    """3 requests through Synth.synth_audio and (with ``with_batch``) one
    synth_batch of 16 texts. Returns the number of synthesis calls and the
    3 requests' audio."""
    synth = api.Synth(model)
    up = model.model_config.upsample_factor
    audio_s, elapsed_s, calls, audios = 0.0, 0.0, 0, []
    for text in TEXTS[:3]:
        t0 = time.perf_counter()
        audio = synth.synth_audio(text)
        audios.append(audio)
        dt = time.perf_counter() - t0
        calls += 1
        dur = len(audio) / model.sample_rate
        audio_s, elapsed_s = audio_s + dur, elapsed_s + dt
        print(f"[{tag}] synth_audio {len(audio)} samples ({dur:.2f} s audio) in {dt:.3f} s, "
              f"RTF {dt / dur:.4f}")
        check(audio.dtype == np.int16 and len(audio) > 0 and np.any(audio != 0)
              and len(audio) % up == 0, f"[{tag}] bad audio for {text!r}")
    print(f"[{tag}] RTF over the 3 requests: {elapsed_s / audio_s:.4f}")
    if not with_batch:
        return calls, audios
    t0 = time.perf_counter()
    batch = synth.synth_batch(TEXTS)
    dt = time.perf_counter() - t0
    calls += 1
    dur = sum(len(a) for a in batch) / model.sample_rate
    print(f"[{tag}] synth_batch of {len(batch)}: {dur:.2f} s audio in {dt:.3f} s, "
          f"RTF {dt / dur:.4f}")
    check(len(batch) == len(TEXTS) and all(
        a.dtype == np.int16 and len(a) > 0 and np.any(a != 0) and len(a) % up == 0
        for a in batch), f"[{tag}] bad batch audio")
    check(torch.cuda.device_count() > 1 or not synth._replicas,
          f"[{tag}] synth_batch on one card ran on a copy of the model's synthesizer")
    return calls, audios


def parity(model, cpu_model, tag="parity"):
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
    print(f"[{tag}] {model.device} vs CPU, {n} samples (|wav| max {scale:.4f}): {errs}, "
          f"tol {tols}")
    for k, tol in tols.items():
        check(errs[k] <= tol, f"{model.device} vs CPU: {k} differs by {errs[k]} > {tol}")


def trace(run, record_shapes=False):
    """torch.profiler over one call of ``run``: (the device's events by
    kernel, wall us, the profile); no events where the trace holds no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # user annotations (the optimizers' "Optimizer.step#AdamW.step" ranges) are
    # spans over kernels, not kernels: counting them would count time twice
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.")], wall_us, prof


def profile_requests(runs):
    """Where the device time goes: torch.profiler over each warm run of
    ``runs`` ((name, callable) pairs). Prints the device-busy share of the
    wall time and the kernels with the most device time (not part of the
    pass criteria: a trace without device events is reported as not
    measured)."""
    for name, run in runs:
        run()
        torch.cuda.synchronize()
        kern, wall_us, _ = trace(run)
        busy_us = sum(e.self_device_time_total for e in kern)
        if not kern:
            print(f"[profile] {name}: no device events in the trace (device time not measured)")
            continue
        print(f"[profile] {name}: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
              f"({100 * busy_us / wall_us:.1f}%), {sum(e.count for e in kern)} kernel launches")
        for kname in ("banded_attention_kernel", "global_attention_tf32_kernel",
                      "global_attention_kernel", "ddsconv_kernel"):
            att = [e for e in kern if kname in e.key]
            if att:
                us = sum(e.self_device_time_total for e in att)
                print(f"[profile]   {kname}: {us / 1e3:.3f} ms x{sum(e.count for e in att)}, "
                      f"{100 * us / busy_us:.1f}% of device busy")
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:110]}")


MS_VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ",", ".", "!", "?", ":", ";", "-", '"']
            + list("абвгдежзийклмнопрстуфхцчшщъыьэюяё")
            + ["##" + ch for ch in "абвгдежзийклмнопрстуфхцчшщъыьэюяё"])


def vocoder_tree(vocoder):
    """(the ``vocoder_config`` block or None, the bundle-layout tree) of a
    vocoder at its published width from the seed: HiFiGAN v1, Vocos() (its
    head scaled by 0.1, so that the waveform is not clipped to +-1 almost
    everywhere, which would hide any difference) or BigVGANConfig()."""
    if vocoder == "vocos":
        cfg = voc.VocosConfig()
        tree = vocos_init(cfg, seed=SEED + 2)
        tree["head"]["w"] = tree["head"]["w"] * np.float32(0.1)
        return dataclasses.asdict(cfg), tree
    if vocoder == "bigvgan":
        cfg = bigvgan.BigVGANConfig()
        return dataclasses.asdict(cfg), bigvgan_init(cfg, seed=SEED + 2)
    return None, hifigan_init(voc.hifigan_v1_config(), seed=SEED + 2)


def write_bert(path, bcfg):
    """A BERT bundle directory (params.npz, config.json, vocab.txt): random
    weights from the seed and the synthetic WordPiece vocabulary MS_VOCAB."""
    os.makedirs(path)
    save_params(os.path.join(path, "params.npz"), bert_init(bcfg, seed=SEED + 3))
    with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as f:
        json.dump(dataclasses.asdict(bcfg), f)
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(MS_VOCAB))


def write_ms_bundle(path, vocoder="hifigan"):
    """A full-width multistream_v3 bundle: StableTTSConfig(), the
    ``vocoder`` (vocoder_tree) and ruBERT-base-wide BertConfig() with random
    weights from the seed, the zero-initialised leaves perturbed, and a
    synthetic WordPiece vocabulary (specials, punctuation, the Russian
    letters and their ## forms)."""
    cfg, bcfg = stabletts.StableTTSConfig(), bert.BertConfig()
    vcfg, vtree = vocoder_tree(vocoder)
    save_params(os.path.join(path, "params.npz"), {
        "matcha": perturb_matcha_zero_init(matcha_init(cfg, seed=SEED), seed=SEED + 1),
        "vocoder": vtree})
    write_bert(os.path.join(path, "bert"), bcfg)
    with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as f:
        json.dump({"model_type": "multistream_v3", "sample_rate": 22050, "hop_length": 256,
                   "vocoder": vocoder, "seed": SEED, "phoneme_id_map": multistream_symbol_map(),
                   "inference": {"noise_level": 0.8, "speech_rate": 1.0, "n_timesteps": 10},
                   "model": dataclasses.asdict(cfg),
                   **({"vocoder_config": vcfg} if vcfg else {})}, f, ensure_ascii=False)
    with open(os.path.join(path, "dictionary"), "w", encoding="utf-8") as f:
        f.write("привет 1.0 p rj i0 vj e1 t\nмир 1.0 mj i1 r\n")


def ms_batch(model, texts, generator):
    """The 16 texts as one batch at model level: front end per text, then
    encode_for_synth, decode_from_durations and the vocoder with B = 16.
    Returns the int16 audio of each text."""
    x, xl, brt, pde, bucket = api.multistream_inputs(model, texts)
    n = len(texts)
    dev = model.device
    x, xl, brt, pde = (torch.as_tensor(a, device=dev) for a in (x, xl, brt, pde))
    sid = torch.zeros(n, dtype=torch.int64, device=dev)
    with torch.inference_mode():
        enc = model.matcha.encode_for_synth(x, xl, sid, brt, phone_duration_extra=pde)
        fb = api.pick_ms_frame_bucket(int(enc["pred_frames"].max()), bucket)
        out = model.matcha.decode_from_durations(enc, sid, max_frames=fb, n_timesteps=10,
                                                 temperature=0.8, generator=generator)
        wav = api.vocoder_apply(model, out["mel"]).cpu().numpy()
        lengths = (out["mel_lengths"] * model.config["hop_length"]).cpu().numpy()
    return [api.audio_float_to_int16(wav[i, :lengths[i]]) for i in range(n)], fb


def ms_main_path(model, tag="ms-main", with_batch=True):
    """3 requests through Synth.synth_audio and (with ``with_batch``) one
    batch of the 16 texts at model level. Returns the number of synthesis
    calls."""
    synth = api.Synth(model)
    audio_s, elapsed_s, calls = 0.0, 0.0, 0
    for text in TEXTS[:3]:
        t0 = time.perf_counter()
        audio = synth.synth_audio(text)
        dt = time.perf_counter() - t0
        calls += 1
        dur = len(audio) / model.sample_rate
        audio_s, elapsed_s = audio_s + dur, elapsed_s + dt
        print(f"[{tag}] synth_audio {len(audio)} samples ({dur:.2f} s audio) in {dt:.3f} s, "
              f"RTF {dt / dur:.4f}")
        check(audio.dtype == np.int16 and len(audio) > 0 and np.any(audio != 0)
              and len(audio) % 256 == 0, f"[{tag}] bad multistream audio for {text!r}")
    print(f"[{tag}] RTF over the 3 requests: {elapsed_s / audio_s:.4f}")
    if not with_batch:
        return calls
    t0 = time.perf_counter()
    batch, fb = ms_batch(model, TEXTS, synth.generator)
    dt = time.perf_counter() - t0
    calls += 1
    dur = sum(len(a) for a in batch) / model.sample_rate
    print(f"[ms-main] batch of {len(batch)} (frame bucket {fb}, CFG batch {2 * len(batch)}): "
          f"{dur:.2f} s audio in {dt:.3f} s, RTF {dt / dur:.4f}")
    check(len(batch) == len(TEXTS) and all(
        a.dtype == np.int16 and len(a) > 0 and np.any(a != 0) and len(a) % 256 == 0
        for a in batch), "bad multistream batch audio")
    return calls


def ms_parity(model, cpu_model):
    """The shortest text's encode_for_synth, decode_from_durations and
    vocoder on ``model``'s device and on the CPU (fed the card's w_round and
    the same BERT rows), temperature 0 (z = 0)."""
    text = min(TEXTS, key=len)
    x, xl, brt, pde, bucket = api.multistream_inputs(model, [text])
    runs = []
    for m in (model, cpu_model):
        dev = m.device
        xs, xls, brts, pdes = (torch.as_tensor(a, device=dev) for a in (x, xl, brt, pde))
        sid = torch.zeros(1, dtype=torch.int64, device=dev)
        with torch.inference_mode():
            enc = m.matcha.encode_for_synth(xs, xls, sid, brts, phone_duration_extra=pdes)
            w_own = enc["w_round"].cpu()
            if runs:  # the card's durations: round() turns 1 ulp into a frame
                enc["w_round"] = runs[0]["w_round"].to(dev)
            fb = api.pick_ms_frame_bucket(int(enc["w_round"].sum()), bucket)
            out = m.matcha.decode_from_durations(enc, sid, max_frames=fb, n_timesteps=10,
                                                 temperature=0.0)
            wav = api.vocoder_apply(m, out["mel"])
        runs.append({"w_round": w_own, "x_mask": enc["x_mask"].cpu(),
                     "mu_mel": enc["mu_mel"].cpu(), "mel": out["mel"].cpu(),
                     "n": int(out["mel_lengths"][0]) * 256, "wav": wav.cpu()})
    g, c = runs
    n = g["n"]
    check(n == c["n"] and n > 0 and np.isfinite(g["wav"].numpy()).all(), "bad multistream output")
    errs = {"mu_mel": float(((g["mu_mel"] - c["mu_mel"]) * g["x_mask"]).abs().max()),
            "mel": float((g["mel"] - c["mel"]).abs().max()),
            "wav": float((g["wav"][0, :n] - c["wav"][0, :n]).abs().max()),
            "w_round_frames_differ": float((g["w_round"] != c["w_round"]).sum())}
    peaks = {k: float(c[k][..., :n].abs().max()) if k == "wav" else float(c[k].abs().max())
             for k in ("mu_mel", "mel", "wav")}
    # f32 on both sides; cuDNN, cuBLAS and the kernel sum in other orders than the CPU
    tols = {k: 1e-3 * peaks[k] + 1e-6 for k in peaks}
    print(f"[ms-parity] {model.device} vs CPU, {text!r}, {n} samples, peaks {peaks}: {errs}, "
          f"tol {tols}")
    for k, tol in tols.items():
        check(errs[k] <= tol, f"{model.device} vs CPU: {k} differs by {errs[k]} > {tol}")


SERVE_RATES = (0.8, 1.0, 1.25)


def serve_requests(n, n_speakers):
    """(text, speaker, rate) for n requests: texts (phrase to paragraph),
    rates and speakers cycling; the text cleaned as the gRPC server cleans
    it (strip, em dash to hyphen)."""
    return [(re.sub("—", "-", TEXTS[i % len(TEXTS)].strip()), i % max(1, n_speakers),
             SERVE_RATES[i % len(SERVE_RATES)]) for i in range(n)]


def instrument(batcher):
    """Count the batcher's batches (their sizes) and decode groups, and keep
    each batch's pass-one dict, by wrapping its methods on the instance (as
    tests/test_serving.py does). Read after the futures are done."""
    seen = {"batches": [], "groups": 0, "enc": []}
    run_batch = batcher._run_batch
    batcher._run_batch = lambda items: (seen["batches"].append(len(items)), run_batch(items))[1]
    decode_name = "_ms_decode_runner" if batcher.multistream else "_decode_runner"
    decode = getattr(batcher, decode_name)

    def counted_decode(*args):
        seen["groups"] += 1
        return decode(*args)

    setattr(batcher, decode_name, counted_decode)
    encode_name = "_ms_encode_runner" if batcher.multistream else "_encode_runner"
    encode = getattr(batcher, encode_name)

    def kept_encode():
        run = encode()

        def keep(*args):
            enc = run(*args)
            seen["enc"].append(enc)
            return enc

        return keep

    setattr(batcher, encode_name, kept_encode)
    return seen


def drive(batcher, requests, n_threads):
    """Closed-loop clients: thread j submits requests j, j + n_threads, ...
    through submit_text, each after the previous one's audio came back.
    Returns (int16 audio per request, latency per request in s, wall s)."""
    audios, latency, errors = [None] * len(requests), [0.0] * len(requests), []

    def client(j):
        try:
            for i in range(j, len(requests), n_threads):
                text, sid, rate = requests[i]
                t0 = time.perf_counter()
                audios[i] = batcher.submit_text(text, sid=sid, speech_rate=rate).result(timeout=600)
                latency[i] = time.perf_counter() - t0
        except Exception as e:  # reported below, fails the phase
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(j,)) for j in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    check(not errors and not any(t.is_alive() for t in threads), f"serving clients failed: {errors}")
    return audios, np.asarray(latency), wall


def serve_phase(tag, model, kernels, requests, n_threads, per_encode, per_decode, multiple):
    """``requests`` from ``n_threads`` client threads through
    BatchSynthesizer(model, max_batch=8) (the server's default, 5 ms wait):
    once to warm every shape, once measured (launch counts set to 0 just
    before, read just after, held to ``per_encode``/``per_decode`` launches
    per encode call and decode group for each kernel named there, 0 for the
    others), once under torch.profiler for the device's busy share. Returns
    the measured run's launches."""
    batcher = BatchSynthesizer(model, max_batch=8)
    try:
        _, _, warm = drive(batcher, requests, n_threads)
        seen = instrument(batcher)
        for k in kernels.values():
            k.launches = 0
        audios, latency, wall = drive(batcher, requests, n_threads)
        got = {name: k.launches for name, k in kernels.items()}
        batches, encodes, groups = list(seen["batches"]), len(seen["enc"]), seen["groups"]
        kern, busy_wall_us, _ = trace(lambda: drive(batcher, requests, n_threads))
    finally:
        batcher.close()
    check(not batcher._thread.is_alive(), f"[{tag}] the batcher's worker did not stop")
    for (text, _, _), a in zip(requests, audios):
        check(a is not None and a.dtype == np.int16 and len(a) > 0 and np.any(a != 0)
              and len(a) % multiple == 0, f"[{tag}] bad audio for {text!r}")
    expected = {name: per_encode.get(name, 0) * encodes + per_decode.get(name, 0) * groups
                for name in kernels}
    audio_s = sum(len(a) for a in audios) / model.sample_rate
    print(f"[{tag}] {len(requests)} requests from {n_threads} threads, max_batch 8, 5 ms wait: "
          f"{audio_s:.2f} s audio in {wall:.3f} s wall (warm-up run {warm:.3f} s), "
          f"{audio_s / wall:.2f} audio s per wall s")
    print(f"[{tag}] latency p50 {np.percentile(latency, 50):.4f} s, p95 "
          f"{np.percentile(latency, 95):.4f} s, max {latency.max():.4f} s")
    print(f"[{tag}] {len(batches)} batches (sizes {batches}, mean {np.mean(batches):.2f}), "
          f"{encodes} encode calls, {groups} decode groups")
    if not kern:
        print(f"[{tag}] profiled run: no device events in the trace (busy share not measured)")
    else:
        busy_us = sum(e.self_device_time_total for e in kern)
        print(f"[{tag}] profiled run: wall {busy_wall_us / 1e3:.3f} ms, device busy "
              f"{busy_us / 1e3:.3f} ms ({100 * busy_us / busy_wall_us:.1f}%), "
              f"{sum(e.count for e in kern)} kernel launches")
    print(f"[{tag}] launches: {got} (expected {expected}: per encode call {per_encode}, per "
          f"decode group {per_decode})")
    check(got == expected, f"[{tag}] kernel launches {got} != {expected}")
    return got


def alone(model, text, sid, rate, fb, gen):
    """One request through the passes at B = 1 and its own text bucket (as
    Synth.synth_audio runs it), decoded at the frame bucket ``fb`` and
    generator frames ``gen`` of the batch's decode group; noise 0. Returns
    (int16 audio, pass-one durations (T,))."""
    dev = model.device
    if model.model_type in api.MULTISTREAM_TYPES:
        x, xl, brt, pde, _ = (torch.as_tensor(a, device=dev) if isinstance(a, np.ndarray) else a
                              for a in api.multistream_inputs(model, [text]))
        sid_t = torch.tensor([sid], device=dev)
        n_steps = int(model.config.get("inference", {}).get("n_timesteps", 10))
        enc = api.make_multistream_encode_runner(model)(x, xl, sid_t, brt, pde, 1.0 / rate)
        wav, mel_lengths = api.make_multistream_decode_runner(model, fb, n_steps)(enc, sid_t, None,
                                                                                 0.0)
        n = int(mel_lengths[0]) * model.config.get("hop_length", 256)
        return api.audio_float_to_int16(wav[0, :n].cpu().numpy()), enc["w_round"][0, :, 0].cpu()
    ids = api.encode_plain(model, text)
    bucket = next(b for b in api.TEXT_BUCKETS if b >= len(ids))
    x = torch.zeros((1, bucket), dtype=torch.int64, device=dev)
    x[0, :len(ids)] = torch.tensor(ids, device=dev)
    xl = torch.tensor([len(ids)], dtype=torch.int32, device=dev)
    sid_t = torch.tensor([sid], device=dev)
    enc = api.make_vits2_encode_runner(model)(x, xl, sid_t, None, 1.0 / rate, 0.0)
    out = api.make_vits2_decode_runner(model, fb, gen)(enc, sid_t, None, 0.0)
    n = int(out["wav_lengths"][0])
    return api.audio_float_to_int16(out["wav"][0, :n, 0].cpu().numpy()), enc["w_ceil"][0].cpu()


# More zero frames after an utterance than the generator's (and HiFiGAN
# v1's) receptive field reaches at the frame rate (about 24 frames by their
# kernel sizes, dilations and upsampling; tests/test_torch_serving.py's
# test_decode_tail_sets_last_frames: 16 already leave 1e-6 of the peak).
RECEPTIVE_FRAMES = 32


def serve_parity(tag, model, requests):
    """``requests`` at noise 0 (and duration noise 0) served in one batch
    (a 1 s window, so that the four land together), each held to
    Synth.synth_audio of the same text, speaker and rate on the card: the
    same length, and within 1e-3 x peak (plus one int16 step: both sides
    truncate float audio) where the request alone takes the batch's decode
    geometry or both decodes leave RECEPTIVE_FRAMES zero frames or more
    after it. The generator and vocoder are not mask-aware: the last frames
    of an utterance depend on how many zero frames follow it in the decode
    call (its group's frame bucket or generator frames), so each row is
    also held, at the same tolerance, to itself alone at the batch's
    geometry (``alone``). A length that differs is reported with the
    phones whose durations differ (a duration on an integer's edge: ceil or
    round of a value within an ulp of it)."""
    multistream = model.model_type in api.MULTISTREAM_TYPES
    batcher = BatchSynthesizer(model, max_batch=8, max_wait_ms=1000.0)
    seen = instrument(batcher)
    try:
        futures = [batcher.submit_text(t, sid=s, speech_rate=r, noise_level=0.0,
                                       duration_noise_level=0.0) for t, s, r in requests]
        got = [f.result(timeout=600) for f in futures]
    finally:
        batcher.close()
    check(seen["batches"] == [len(requests)], f"[{tag}] not served in one batch: {seen['batches']}")
    enc = seen["enc"][0]
    preds = [int(p) for p in enc["pred_frames"][: len(requests)]]
    lengths = [len(api.encode_multistream(model, t)[0]) if multistream else
               len(api.encode_plain(model, t)) for t, _, _ in requests]
    bucket = next(b for b in api.TEXT_BUCKETS if b >= max(lengths))
    geometry = {i: (fb, gen) for idx, fb, gen in
                batcher_mod.split_decode_groups(preds, bucket, multistream=multistream) for i in idx}
    synth = api.Synth(model)
    durations = enc["w_round"][..., 0] if multistream else enc["w_ceil"]
    for i, ((text, sid, rate), a) in enumerate(zip(requests, got)):
        want = synth.synth_audio(text, speaker_id=sid, noise_level=0.0, speech_rate=rate,
                                 duration_noise_level=0.0)
        fb, gen = geometry[i]
        solo, solo_dur = alone(model, text, sid, rate, fb, gen)
        if not len(a) == len(solo) == len(want):
            row = durations[i, :lengths[i]].cpu()
            diff = [(p, float(row[p]), float(solo_dur[p])) for p in range(lengths[i])
                    if row[p] != solo_dur[p]]
            raise SmokeFailure(f"[{tag}] {text!r}: {len(a)} samples batched, {len(solo)} alone, "
                               f"{len(want)} from synth_audio; phones (index, frames batched, "
                               f"frames alone) {diff}")
        peak = int(np.abs(want.astype(np.int32)).max())
        tol = 1e-3 * peak + 1
        err_solo = int(np.abs(a.astype(np.int32) - solo.astype(np.int32)).max())
        err_synth = int(np.abs(a.astype(np.int32) - want.astype(np.int32)).max())
        frames = len(a) // (256 if multistream else model.model_config.upsample_factor)
        own_bucket = next(b for b in api.TEXT_BUCKETS if b >= lengths[i])
        if multistream:
            own = (api.pick_ms_frame_bucket(frames, own_bucket), None)
        else:
            own_fb = api.pick_frame_bucket(frames, own_bucket)
            own = (own_fb, api.pick_gen_frames(frames, own_fb))
        tail = lambda g: (g[0] if g[1] is None else g[1]) - frames
        print(f"[{tag}] {text[:32]!r} sid {sid} rate {rate}: {len(a)} samples, peak {peak}, "
              f"tol {tol:.1f}; batched vs alone at the batch's geometry (frames {fb}, gen {gen}, "
              f"{tail((fb, gen))} zero frames after): {err_solo}; vs synth_audio (frames {own[0]}, "
              f"gen {own[1]}, {tail(own)} zero frames after): {err_synth}")
        check(err_solo <= tol, f"[{tag}] {text!r}: batched differs from alone by {err_solo} > {tol}")
        if own == (fb, gen) or min(tail(own), tail((fb, gen))) >= RECEPTIVE_FRAMES:
            check(err_synth <= tol,
                  f"[{tag}] {text!r}: batched differs from synth_audio by {err_synth} > {tol}")


def wire_missing():
    """The wire's modules (grpc, google.protobuf) that do not import here."""
    import importlib

    missing = []
    for name in ("grpc", "google.protobuf"):
        try:
            importlib.import_module(name)
        except ImportError:
            missing.append(name)
    return missing


def serve_grpc(model, requests, multiple):
    """make_server on 127.0.0.1, port 0, and ``requests`` sent at once from
    as many threads through SynthesizerClient: each answer a WAV (RIFF
    header, 22050 Hz, mono 16-bit) whose frame count is its data's, a
    multiple of ``multiple``."""
    import io
    import wave

    from vosk_tts_tpu_torch.serving.client import SynthesizerClient
    from vosk_tts_tpu_torch.serving.server import make_server

    server, servicer, port = make_server(model, interface="127.0.0.1", port=0, threads=8)
    server.start()
    client = SynthesizerClient(f"127.0.0.1:{port}")
    results, errors = [None] * len(requests), []

    def one(i):
        text, sid, rate = requests[i]
        try:
            results[i] = client.synthesize(text, speaker_id=sid, speech_rate=rate)
        except Exception as e:  # reported below, fails the phase
            errors.append(repr(e))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(requests))]
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        client.close()
        server.stop(0).wait(30)
        servicer.batcher.close()
    wall = time.perf_counter() - t0
    check(not errors and not any(t.is_alive() for t in threads), f"[serve-grpc] failed: {errors}")
    for (text, _, _), data in zip(requests, results):
        check(data[:4] == b"RIFF", f"[serve-grpc] no RIFF header for {text!r}")
        with wave.open(io.BytesIO(data)) as f:
            shape = (f.getframerate(), f.getnchannels(), f.getsampwidth(), f.getnframes())
        check(shape[:3] == (22050, 1, 2) and shape[3] == (len(data) - 44) // 2 > 0
              and shape[3] % multiple == 0, f"[serve-grpc] bad WAV {shape} for {text!r}")
    print(f"[serve-grpc] {model.model_type}: {len(requests)} concurrent requests on 127.0.0.1:{port} "
          f"in {wall:.3f} s, WAV frames {[(len(d) - 44) // 2 for d in results]}")


def vits2_vc(model, cpu_model, kernels, long_audio, short_audio, tag="vits2-vc",
             per_call=(("banded_attention", 8),)):
    """``[vits2-vc]``: Synthesizer.voice_conversion on the full-width VITS2
    bundle, speaker 0 -> 3. y is the port's log-mel (the bundle's
    spec_channels bins; n_fft 1024, hop 256 at 22.05 kHz) of two ``[main]``
    waveforms as a batch of two, the shorter one padded; the same posterior
    noise on the card and on the CPU. Three calls on the card with the
    launch counts set to 0 just before and read just after (``per_call``:
    for pre_conv2, 8 banded attention launches a call: 4 flows x 2
    directions x 1 layer, nothing else), the last two timed; the card's
    waveforms held to the CPU's over each row's valid samples as
    ``[parity]`` holds them. Returns (launches, (T, T_short))."""
    cfg = model.model_config
    up = cfg.upsample_factor
    mels = [mel_spectrogram(torch.as_tensor(a.astype(np.float32) / 32768.0)[None], 1024,
                            cfg.spec_channels, 22050, 256, 1024, 0.0, None)[0]
            for a in (long_audio, short_audio)]
    t, t_short = mels[0].shape[0], mels[1].shape[0]
    check(t_short < t, f"[{tag}] the rows are not of two lengths: {t}, {t_short}")
    y = torch.zeros(2, t, cfg.spec_channels)
    y[0], y[1, :t_short] = mels[0], mels[1]
    lengths = torch.tensor([t, t_short], dtype=torch.int32)
    sid_src, sid_tgt = torch.tensor([0, 0]), torch.tensor([3, 3])
    noise = torch.randn(2, t, cfg.inter_channels, generator=torch.Generator().manual_seed(SEED + 7))
    args = lambda dev: [a.to(dev) for a in (y, lengths, sid_src, sid_tgt)]
    dev = model.device
    for k in kernels.values():
        k.launches = 0
    walls = []
    with torch.inference_mode():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wav, mask = model.synthesizer.voice_conversion(*args(dev), noise=noise.to(dev))
            wav = wav.cpu()
            walls.append(time.perf_counter() - t0)
    got = {name: k.launches for name, k in kernels.items()}
    expected = {name: 0 for name in kernels} | {name: n * 3 for name, n in per_call}
    audio_s = (t + t_short) * up / 22050
    print(f"[{tag}] voice_conversion B2 (frames {t} and {t_short}, speaker 0 -> 3): "
          f"{audio_s:.2f} s audio; wall {', '.join(f'{w:.4f}' for w in walls)} s "
          f"(the first warms up), RTF {min(walls[1:]) / audio_s:.4f}")
    print(f"[{tag}] launches over 3 calls: {got} (expected {expected})")
    check(got == expected, f"[{tag}] kernel launches {got} != {expected}")
    with torch.inference_mode():
        want, mask_c = cpu_model.synthesizer.voice_conversion(*args("cpu"), noise=noise)
    check(wav.shape == want.shape == (2, t * up, 1) and np.isfinite(wav.numpy()).all(),
          f"[{tag}] bad output {tuple(wav.shape)}")
    check(torch.equal(mask.cpu(), mask_c), f"[{tag}] the masks differ")
    for i, n in enumerate((t * up, t_short * up)):
        err = float((wav[i, :n] - want[i, :n]).abs().max())
        peak = float(want[i, :n].abs().max())
        tol = 1e-3 * peak + 1e-6
        print(f"[{tag}] row {i}: {n} samples, card vs CPU {err:.3e} (peak {peak:.4f}, "
              f"tol {tol:.3e})")
        check(peak > 0 and err <= tol, f"[{tag}] row {i} differs by {err} > {tol}")
    with torch.inference_mode():
        profile_requests([(f"{tag} voice_conversion", lambda: model.synthesizer.voice_conversion(
            *args(dev), noise=noise.to(dev)))])
    return got, (t, t_short)


#: ``[variants]``: full-width VITS2 bundles that, with ``[main]``'s pre_conv2 +
#: mb_istft and QuickVC's plain couplings + ms_istft, cover every flow type,
#: decoder and iSTFT mode, and the deterministic duration predictor. Each
#: generator makes 256 samples a frame, as the reference's configurations
#: of its decoder do: iSTFT-VITS upsamples (8, 8) before its hop of 4,
#: HiFiGAN-VITS (8, 8, 2, 2); the multiband decoders (4, 4) x 4 x 4 subbands
VARIANTS = (
    ("pre_conv+istft", dict(transformer_flow_type="pre_conv", decoder_type="istft",
                            upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16))),
    ("fft+hifigan", dict(transformer_flow_type="fft", decoder_type="hifigan",
                         upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4))),
    ("mono_inter+ms_istft/onnx+dp", dict(transformer_flow_type="mono_layer_inter_residual",
                                         decoder_type="ms_istft", istft_mode="onnx",
                                         use_sdp=False)),
    ("mono_post+mb_istft/onnx", dict(transformer_flow_type="mono_layer_post_residual",
                                     decoder_type="mb_istft", istft_mode="onnx")),
)


def per_synthesis_call(cfg):
    """Kernel launches of one synthesis call (encode + decode) of a VITS2
    configuration: kernel 1 in every text-encoder layer and, for pre_conv2,
    once a flow; kernel 2 four times with the SDP; kernel 5 in the two
    windowless layers of each pre_conv or mono flow."""
    ftype = vits2.flow_type(cfg)
    windowless = ftype == "pre_conv" or ftype.startswith("mono_layer")
    return {"banded_attention": cfg.n_layers + (cfg.n_flows if ftype == "pre_conv2" else 0),
            "ddsconv": 4 if cfg.use_sdp else 0,
            "global_attention": 2 * cfg.n_flows if windowless else 0}


BF16_TOL = 2e-2  # bf16 kernel vs its plain bf16 version: max |diff| / max |out|, ~5 bf16 ulps
# bench.py's VITS2 workload (WORKLOAD, BATCH): (text bucket, real tokens) at B16
BF16_WORKLOAD = ((64, 56), (128, 120), (256, 250))
BF16_BATCH = 16


def snr_db(ref, got):
    ref, got = ref.double(), got.double()
    err = float(((ref - got) ** 2).sum())
    return float("inf") if err == 0 else 10.0 * np.log10(float((ref ** 2).sum()) / err)


def bf16_kernel_cases():
    """Each bf16 kernel against its plain bf16 version on the card: the f32
    cases' batched shape, a B1 or B2 shape, and a ragged T=37; kernels 4-5
    also at B2 T512 (a grid of 64-row blocks) and B16 T1024 D48."""
    return {
        "banded_attention_bf16": [
            attention_case(16, 256, [256 - 9 * i for i in range(16)], 50, 20, 41, dtype=BF16),
            attention_case(1, 512, [437], 50, 20, 42, dtype=BF16),
            attention_case(1, 37, [37], 0, 0, 43, dtype=BF16)],
        "ddsconv_bf16": [
            ddsconv_case(16, 256, [256 - 13 * i for i in range(16)], 50, 20, 44, dtype=BF16),
            ddsconv_case(1, 128, [120], 50, 20, 45, dtype=BF16),
            ddsconv_case(1, 37, [30], 0, 0, 46, dtype=BF16)],
        "global_attention_rope_bf16": [
            global_case("rope", 16, 256, 64, [256 - 11 * i for i in range(16)], 50, 20, 47,
                        dtype=BF16),
            global_case("rope", 2, 512, 96, [437, 437], 50, 20, 48, dtype=BF16),
            global_case("rope", 2, 37, 96, [37, 20], 0, 0, 49, dtype=BF16)],
        "global_attention_packed_bf16": [
            global_case("packed", 16, 1024, 96, [1024 - 41 * i for i in range(16)], 20, 5, 50,
                        dtype=BF16),
            global_case("packed", 1, 37, 96, [30], 0, 0, 51, dtype=BF16),
            global_case("packed", 2, 512, 96, [437, 437], 50, 20, 54, dtype=BF16)],
        "global_attention_bf16": [
            global_case("separate", 16, 2048, 48, [2048 - 97 * i for i in range(16)], 10, 3, 52,
                        h=2, dtype=BF16),
            global_case("separate", 1, 397, 48, [355], 50, 20, 53, h=2, dtype=BF16),
            global_case("separate", 16, 1024, 48, [1024 - 41 * i for i in range(16)], 20, 5, 55,
                        h=2, dtype=BF16)]}


def vits2_bf16_inputs(rng, text_bucket, n_real, cfg, dev):
    x = rng.integers(1, cfg.n_vocab, (BF16_BATCH, text_bucket))
    x[:, n_real:] = 0
    return (torch.as_tensor(x, device=dev),
            torch.full((BF16_BATCH,), n_real, dtype=torch.int32, device=dev),
            torch.arange(BF16_BATCH, device=dev) % cfg.n_speakers)


def bf16_cast(enc):
    """An f32 encode's outputs for a bf16 decode: the means and the mask in
    bf16, the durations (f32 frame counts) as they are."""
    return {k: v.to(BF16) if v.is_floating_point() and k != "w_ceil" else v
            for k, v in enc.items()}


def vits2_bf16_workload(tag, cfg, kernels, smi, per_encode, per_decode, seed, rows_gated=True,
                        dev=torch.device("cuda")):
    """bench.py's VITS2 workload through the serving functions from a bf16
    tree and from the f32 one, noise scales 0: durations within max(2, 6%)
    of f32's (tests/test_bf16_serving.py:83) every row (``rows_gated``),
    else each batch's total within 6% and the rows outside the per-row
    gate printed; a bf16 waveform of the f32 run's lengths on the f32
    durations with SNR > 12 dB (:94) every row; launches a batch exactly
    ``per_encode`` + ``per_decode`` of the bf16 kernels and nothing else.
    Prints each bucket's bf16 and f32 ms (CUDA events) and the peak memory;
    returns the launches."""
    t0 = time.perf_counter()
    tree = to_port_layout(perturb_zero_init(synthesizer_init(cfg, seed=seed), seed=seed + 1))
    p32, p16 = to_torch(tree, dev), to_torch(tree, dev, BF16)
    del tree
    print(f"[{tag}] {cfg.transformer_flow_type} + {cfg.decoder_type} trees (f32, bf16) made in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    total = {n: 0 for n in kernels}
    torch.cuda.reset_peak_memory_stats()
    for text_bucket, n_real in BF16_WORKLOAD:
        x, xl, sid = vits2_bf16_inputs(rng, text_bucket, n_real, cfg, dev)
        with torch.inference_mode():
            enc = lambda p: vits2.encode_for_infer(p, cfg, x, xl, sid, noise_scale_w=0.0)
            enc32 = enc(p32)
            pred32 = enc32["pred_frames"].cpu()
            fb = api.pick_frame_bucket(int(pred32.max()), text_bucket)
            gen = api.pick_gen_frames(int(pred32.max()), fb)
            dec = lambda p, e: vits2.decode_from_durations(p, cfg, e, sid, max_frames=fb,
                                                           noise_scale=0.0, gen_frames=gen)
            enc16_in = bf16_cast(enc32)
            zeroed(kernels)
            enc16 = enc(p16)
            out16 = dec(p16, enc16_in)
            torch.cuda.synchronize()
            got = launches_now(kernels)
            out32 = dec(p32, enc32)
            want = {n: 0 for n in kernels} | {n: per_encode.get(n, 0) + per_decode.get(n, 0)
                                              for n in set(per_encode) | set(per_decode)}
            check(got == want, f"[{tag}] t{text_bucket}: launches {got} != {want}")
            total = {n: total[n] + got[n] for n in kernels}
            pred16 = enc16["pred_frames"].cpu()
            outside = [(int(a), int(b)) for a, b in zip(pred16, pred32)
                       if abs(int(a) - int(b)) > max(2, int(0.06 * int(b)))]
            check(enc16["m_p"].dtype == BF16 and out16["wav"].dtype == BF16,
                  f"[{tag}] t{text_bucket}: a bf16 run returned {enc16['m_p'].dtype}, "
                  f"{out16['wav'].dtype}")
            frames_ok = (not outside if rows_gated else
                         abs(int(pred16.sum()) - int(pred32.sum())) <= 0.06 * int(pred32.sum()))
            check(frames_ok, f"[{tag}] t{text_bucket}: bf16 frames {pred16.tolist()} vs f32 "
                  f"{pred32.tolist()}")
            check(torch.equal(out16["wav_lengths"], out32["wav_lengths"]),
                  f"[{tag}] t{text_bucket}: lengths differ")
            n = out32["wav_lengths"].tolist()
            snr = [snr_db(out32["wav"][i, :n[i], 0], out16["wav"][i, :n[i], 0])
                   for i in range(BF16_BATCH)]
            check(all(np.isfinite(out16["wav"].float().cpu().numpy()).ravel()),
                  f"[{tag}] t{text_bucket}: bf16 waveform not finite")
            check(min(snr) > 12.0, f"[{tag}] t{text_bucket}: bf16 decode SNR {min(snr):.2f} dB "
                  f"(gate 12)")
            ms = {"enc16": cuda_ms(lambda: enc(p16), 3, 1),
                  "dec16": cuda_ms(lambda: dec(p16, enc16_in), 3, 1),
                  "enc32": cuda_ms(lambda: enc(p32), 3, 1),
                  "dec32": cuda_ms(lambda: dec(p32, enc32), 3, 1)}
        frames = int(pred32.clamp(max=fb).sum())
        print(f"[{tag}] t{text_bucket} ({n_real} tokens) B{BF16_BATCH}: frame bucket {fb}, "
              f"gen {gen}; frames bf16 {pred16.tolist()} f32 {pred32.tolist()} (rows outside "
              f"max(2, 6%): {outside}); SNR on f32 "
              f"durations min {min(snr):.2f} mean {np.mean(snr):.2f} dB; launches {got}; "
              f"encode ms bf16 {ms['enc16']:.4f} f32 {ms['enc32']:.4f}, decode ms bf16 "
              f"{ms['dec16']:.4f} f32 {ms['dec32']:.4f} ({frames * 256 / 22050:.2f} s audio); "
              f"{smi}")
    print(f"[{tag}] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (both trees)")
    del p32, p16
    torch.cuda.empty_cache()
    return total


def stabletts_bf16(tag, kernels, smi, cfg=None, dev=torch.device("cuda")):
    """StableTTSConfig() from a bf16 tree, B2, 10 Euler steps, temperature
    0, on the f32 run's durations: a bf16 mel, launches of kernel 3's bf16
    wrapper exactly 2 x 4 + 10 x 6, nothing else (the gates are the `cuda`
    test file's)."""
    cfg = cfg or stabletts.StableTTSConfig()
    tree = stabletts.port_layout(perturb_matcha_zero_init(matcha_init(cfg, seed=SEED),
                                                          seed=SEED + 1))
    p32, p16 = to_torch(tree, dev), to_torch(tree, dev, BF16)
    del tree
    rng = np.random.default_rng(SEED)
    b, t = 2, 128
    x = rng.integers(0, p32["text_encoder"]["punc_emb"].shape[0], (b, 5, t))
    x[:, 0] = rng.integers(1, cfg.n_vocab, (b, t))
    x = torch.as_tensor(x, device=dev)
    xl = torch.tensor([t, 97], dtype=torch.int32, device=dev)
    sid = torch.tensor([0, 3], device=dev)
    bert = torch.randn(b, t, cfg.bert_dim, generator=torch.Generator(device=dev).manual_seed(SEED),
                       device=dev)
    with torch.inference_mode():
        enc32 = stabletts.encode_for_synth(p32, cfg, x, xl, sid, bert)
        fb = api.pick_ms_frame_bucket(int(enc32["pred_frames"].max()), t)
        zeroed(kernels)
        enc16 = stabletts.encode_for_synth(p16, cfg, x, xl, sid, bert.to(BF16))
        out16 = stabletts.decode_from_durations(p16, cfg, bf16_cast(enc32), sid, max_frames=fb,
                                                n_timesteps=10, temperature=0.0)
        torch.cuda.synchronize()
        got = launches_now(kernels)
        out32 = stabletts.decode_from_durations(p32, cfg, enc32, sid, max_frames=fb,
                                                n_timesteps=10, temperature=0.0)
    want = {n: 0 for n in kernels} | {"global_attention_rope_bf16":
                                      2 * cfg.n_layers + 10 * cfg.dec_layers}
    check(got == want, f"[{tag}] launches {got} != {want}")
    nf = int(out32["mel_lengths"][0])
    mel32, mel16 = out32["mel"][0, :nf].float(), out16["mel"][0, :nf].float()
    rel = float((mel32 - mel16).abs().mean() / (mel32.std() + 1e-8))
    check(out16["mel"].dtype == BF16 and torch.isfinite(mel16).all(), f"[{tag}] bad bf16 mel")
    print(f"[{tag}] StableTTSConfig() B2 T{t}, 10 Euler steps, temperature 0, frame bucket {fb}: "
          f"bf16 frames {enc16['pred_frames'].tolist()} vs f32 {enc32['pred_frames'].tolist()}; "
          f"on f32 durations row 0 mel error {rel:.4f} (the cuda tests gate 0.12); launches {got}; "
          f"{smi}")
    return got


def bf16_phase(kernels, smi):
    """[bf16]: (a) each bf16 kernel against its plain bf16 version at the
    main paths' shapes, timed beside it, its bound and, for the global
    kernels, SDPA in bf16; (b) bench.py's VITS2 workload at VITS2Config()
    from a bf16 tree (vits2_bf16_workload), then a pre_conv variant (kernel
    5's path) and StableTTSConfig() (kernel 3's path). Returns (the cases,
    the launches of each bf16 wrapper on its path, the launches of the
    checks)."""
    t0 = time.perf_counter()
    bf = {n: k for n, k in kernels.items() if n.endswith("_bf16")}
    zeroed(kernels)
    cases = bf16_kernel_cases()
    check_launches = launches_now(bf)
    for name, shapes in cases.items():
        for c in shapes:
            print(f"[bf16] kernel {name} {json.dumps(c)} tol {BF16_TOL} x max|out|; {smi}")
            check(np.isfinite(c["rel_err"]) and c["rel_err"] <= BF16_TOL,
                  f"{name} at {c['shape']} disagrees with its plain version: {c['rel_err']}")
    print(f"[bf16] kernel checks in {time.perf_counter() - t0:.1f} s; launches {check_launches}")
    main = vits2_bf16_workload("bf16", vits2.VITS2Config(), kernels, smi,
                               {"banded_attention_bf16": 6, "ddsconv_bf16": 4},
                               {"banded_attention_bf16": 4}, SEED)
    # kernel 5's path; its encode is [bf16]'s above on another tree: the batch's
    # frames are gated, its rows printed
    pre_conv = vits2_bf16_workload("bf16 pre_conv",
                                   vits2.VITS2Config(transformer_flow_type="pre_conv"), kernels,
                                   smi, {"banded_attention_bf16": 6, "ddsconv_bf16": 4},
                                   {"global_attention_bf16": 8}, SEED + 2, rows_gated=False)
    ms = stabletts_bf16("bf16 stabletts", kernels, smi)
    launches = {n: main[n] + pre_conv[n] + ms[n] for n in bf}
    print(f"[bf16] launches on the bf16 paths: VITS2 {main}, pre_conv {pre_conv}, StableTTS {ms}")
    print(f"[bf16] wall {time.perf_counter() - t0:.1f} s")
    return cases, launches, check_launches


def variants_phase(kernels):
    """``[variants]``: each of VARIANTS at full width (VITS2Config() widths,
    random weights from the seed, zero-initialised projections perturbed)
    answers 3 requests through Model/Synth.synth_audio on the card (the
    first bundle also one synth_batch of the 16 texts), with the launch
    counts set to 0 just before and held to per_synthesis_call just after;
    one request on the card and on the CPU fed the card's durations, noise
    0 (``parity``); one synth_audio profiled; on the first bundle
    (``pre_conv``: windowless flow attention) ``voice_conversion`` B2 as in
    ``[vits2-vc]``, 16 launches of kernel 5 a call. Returns (the launches of
    each kernel over the main paths, the launches over the voice
    conversions, (T, T_short) of the voice conversion)."""
    launches, vc_launches, vc_shape = {name: 0 for name in kernels}, None, None
    for i, (name, over) in enumerate(VARIANTS):
        cfg = vits2.VITS2Config(**over)
        tag = f"variants {name}"
        t0 = time.perf_counter()
        tree = perturb_zero_init(synthesizer_init(cfg, seed=SEED + 50 + i), seed=SEED + 60 + i)
        with tempfile.TemporaryDirectory(prefix="vits2-variant-") as bundle:
            write_bundle(bundle, cfg, tree)
            del tree
            model = api.Model(bundle)
            print(f"[{tag}] full-width bundle written and loaded in "
                  f"{time.perf_counter() - t0:.1f} s")
            check(model.device.type == "cuda", f"[{tag}] Model() did not default to the card")
            for k in kernels.values():
                k.launches = 0
            calls, audios = main_path(model, tag=tag, with_batch=i == 0)
            got = {n: k.launches for n, k in kernels.items()}
            expected = {n: 0 for n in kernels} | {
                n: c * calls for n, c in per_synthesis_call(cfg).items()}
            print(f"[{tag}] launches over {calls} synthesis calls: {got} (expected {expected})")
            check(got == expected, f"[{tag}] kernel launches {got} != {expected}")
            launches = {n: launches[n] + got[n] for n in kernels}
            synth = api.Synth(model)
            profile_requests([(f"{tag} synth_audio", lambda: synth.synth_audio(TEXTS[2]))])
            cpu_model = api.Model(bundle, device="cpu")
            parity(model, cpu_model, tag=f"{tag} parity")
            if i == 0:
                longest, second = sorted(audios, key=len)[:0:-1]
                vc_launches, vc_shape = vits2_vc(model, cpu_model, kernels, longest, second,
                                                 tag=f"{tag} vc",
                                                 per_call=(("global_attention", 16),))
            del model, synth, cpu_model
        torch.cuda.empty_cache()
    return launches, vc_launches, vc_shape


def ms_vocoders_phase(kernels):
    """``[ms-vocoders]``: the ``[ms-main]`` multistream_v3 bundle written
    with the Vocos() and with the BigVGANConfig() vocoder (vocoder_tree):
    3 requests each through Model/Synth.synth_audio (RTF; 68 launches of
    kernel 3 a call, no other kernel), the vocoder alone on a 32-frame mel
    on the card and on the CPU (1e-3 x peak), one request profiled."""
    for vocoder in ("vocos", "bigvgan"):
        tag = f"ms-vocoders {vocoder}"
        with tempfile.TemporaryDirectory(prefix=f"ms-v3-{vocoder}-") as bundle:
            t0 = time.perf_counter()
            write_ms_bundle(bundle, vocoder)
            model = api.Model(bundle)
            print(f"[{tag}] full-width multistream_v3 bundle written and loaded in "
                  f"{time.perf_counter() - t0:.1f} s ({vocoder}: {model.vocoder_config})")
            check(model.device.type == "cuda" and model.vocoder_type == vocoder,
                  f"[{tag}] the bundle did not load on the card with its vocoder")
            for k in kernels.values():
                k.launches = 0
            calls = ms_main_path(model, tag=tag, with_batch=False)
            got = {n: k.launches for n, k in kernels.items()}
            expected = {n: 0 for n in kernels} | {"global_attention_rope": 68 * calls}
            print(f"[{tag}] launches over {calls} synthesis calls: {got} (expected {expected})")
            check(got == expected, f"[{tag}] kernel launches {got} != {expected}")
            mel = torch.randn(1, 32, model.model_config.n_feats,
                              generator=torch.Generator().manual_seed(SEED + 9))
            # the same vocoder on the CPU: what api.vocoder_apply reads of a Model
            cpu_vocoder = SimpleNamespace(vocoder_type=model.vocoder_type,
                                          vocoder_config=model.vocoder_config,
                                          vocoder=TreeModule(model.vocoder.numpy_tree()))
            with torch.inference_mode():
                got_wav = api.vocoder_apply(model, mel.to(model.device)).cpu()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = api.vocoder_apply(cpu_vocoder, mel)
                cpu_s = time.perf_counter() - t0
            peak = float(want.abs().max())
            err = float((got_wav - want).abs().max())
            tol = 1e-3 * peak + 1e-6
            print(f"[{tag}] vocoder alone, 32 mel frames -> {want.shape[-1]} samples: card vs "
                  f"CPU {err:.3e} (peak {peak:.4f}, tol {tol:.3e}; the CPU took {cpu_s:.2f} s)")
            check(got_wav.shape == want.shape and np.isfinite(got_wav.numpy()).all()
                  and peak > 0 and err <= tol, f"[{tag}] the vocoder differs by {err} > {tol}")
            synth = api.Synth(model)
            profile_requests([(f"{tag} synth_audio", lambda: synth.synth_audio(TEXTS[2]))])
            del model, synth
        torch.cuda.empty_cache()


def vc_phase(kernels):
    """``[vc]``: pipelines.convert_voice at full width: HubertConfig() (12 x
    768, 512-channel extractor) and QuickVCConfig() (hidden 192, 16
    posterior WN layers, gin 256, 512-channel ms-iSTFT generator at 16 kHz,
    3 x 256 LSTM), random weights from the seed (couplings perturbed), a
    10 s source and a 5 s target at 16 kHz. One warm call, three timed
    (host clock; RTF over the source's seconds), the stages between CUDA
    events, one call under torch.profiler (busy share, launches); no
    hand-written kernel on this path (HuBERT's attention is a plain
    matmul, as in the JAX package). Then a 3 s source on the card and on
    the CPU with the same posterior noise: equal lengths (320 samples a
    ContentVec frame), within 1e-3 x peak."""
    hcfg, qcfg = hubert.HubertConfig(), quickvc.QuickVCConfig()
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    htree = to_port_layout(hubert_init(hcfg, seed=SEED + 4))
    qtree = to_port_layout(perturb_zero_init(quickvc_init(qcfg, seed=SEED + 5), seed=SEED + 6))
    hub_c, vc_c = hubert.Hubert(hcfg, htree), quickvc.QuickVC(qcfg, qtree)
    hub, vc = hubert.Hubert(hcfg, htree).to(dev), quickvc.QuickVC(qcfg, qtree).to(dev)
    del htree, qtree
    n_params = lambda m: sum(b.numel() for b in m.buffers())
    print(f"[vc] HuBERT {n_params(hub) / 1e6:.1f} M and QuickVC {n_params(vc) / 1e6:.1f} M "
          f"weights built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 8)
    src = (rng.standard_normal(10 * 16000) * 0.1).astype(np.float32)
    tgt = (rng.standard_normal(5 * 16000) * 0.1).astype(np.float32)
    frames = hcfg.n_frames(len(src))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    convert = lambda s, **kw: pipelines.convert_voice(vc.params, qcfg, hub.params, hcfg, s, tgt,
                                                      **kw)
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    wav = convert(src, generator=gen)
    first = time.perf_counter() - t0
    check(wav.shape == (frames * 320,) and np.isfinite(wav).all() and np.abs(wav).max() > 0,
          f"[vc] bad waveform {wav.shape} (expected {frames * 320} samples)")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        convert(src, generator=gen)
        walls.append(time.perf_counter() - t0)
    got = {name: k.launches for name, k in kernels.items()}
    print(f"[vc] convert_voice 10 s source ({frames} ContentVec frames), 5 s target: "
          f"{len(wav)} samples; wall {first:.4f} s first, then "
          f"{', '.join(f'{w:.4f}' for w in walls)} s, RTF {min(walls) / 10:.4f}")
    check(all(v == 0 for v in got.values()), f"[vc] a hand-written kernel launched: {got}")

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    noise = torch.randn(1, frames, qcfg.inter_channels, generator=gen, device=dev)
    with torch.inference_mode():
        s_t, t_t = (torch.as_tensor(a, device=dev)[None] for a in (src, tgt))
        v = qcfg.as_vits2()
        torch.cuda.synchronize()
        ev[0].record()
        c = hub(s_t)
        ev[1].record()
        g = vc.embed_utterance(mel_spectrogram(t_t, 1280, 80, 16000, 320, 1280, 0.0, None))
        g = g[:, None, :]
        ev[2].record()
        z_p, _, _, mask = vits2.posterior_apply(
            vc.params["enc_p"], qcfg.as_vits2(spec_channels=qcfg.ssl_dim, gin=0), c,
            torch.tensor([frames], dtype=torch.int32, device=dev), noise=noise)
        z = vits2.flow_block_apply(vc.params["flow"], v, z_p, mask, g, reverse=True)
        ev[3].record()
        staged = vits2.generator_apply(vc.params["dec"], v, z * mask, g)[0][0, :, 0]
        ev[4].record()
    torch.cuda.synchronize()
    stages = {name: ev[i].elapsed_time(ev[i + 1]) for i, name in enumerate(
        ("hubert", "speaker embedding", "posterior + flow", "generator"))}
    whole = convert(src, noise=noise)
    err = float(np.abs(staged.cpu().numpy() - whole).max())
    print(f"[vc] stages between CUDA events (ms; a stage's span on the device, gaps included): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f"; staged run vs convert_voice {err:.3e}")
    check(err <= 1e-5 * float(np.abs(whole).max()), f"[vc] staged run differs by {err}")

    profile_requests([("vc convert_voice", lambda: convert(src, generator=gen))])
    print(f"[vc] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    src3 = src[:3 * 16000]
    frames3 = hcfg.n_frames(len(src3))
    noise3 = torch.randn(1, frames3, qcfg.inter_channels,
                         generator=torch.Generator().manual_seed(SEED + 9))
    card = convert(src3, noise=noise3.to(dev))
    t0 = time.perf_counter()
    cpu = pipelines.convert_voice(vc_c.params, qcfg, hub_c.params, hcfg, src3, tgt, device="cpu",
                                  noise=noise3)
    cpu_s = time.perf_counter() - t0
    peak = float(np.abs(cpu).max())
    err = float(np.abs(card - cpu).max()) if card.shape == cpu.shape else float("inf")
    tol = 1e-3 * peak
    print(f"[vc] parity, 3 s source: card {card.shape[0]} and CPU {cpu.shape[0]} samples "
          f"(expected {frames3 * 320}), max abs err {err:.3e} (peak {peak:.4f}, tol {tol:.3e}); "
          f"the CPU took {cpu_s:.1f} s")
    check(card.shape == cpu.shape == (frames3 * 320,) and peak > 0 and err <= tol,
          f"[vc] card vs CPU: {err} > {tol} or lengths differ")


def clone_models():
    """Full-width GPT-SoVITS and ContentVec trees (port layout, numpy) from
    the seed: ARConfig(), SoVITSConfig() (couplings perturbed),
    HubertConfig()."""
    cfgs = gpt_sovits.ARConfig(), gpt_sovits.SoVITSConfig(), hubert.HubertConfig()
    trees = (to_port_layout(ar_init(cfgs[0], seed=SEED + 10)),
             to_port_layout(perturb_zero_init(sovits_init(cfgs[1], seed=SEED + 11), seed=SEED + 12)),
             to_port_layout(hubert_init(cfgs[2], seed=SEED + 13)))
    return cfgs, trees


def clone_phase(kernels, cfgs, trees):
    """``[clone]``: see the module docstring (phase 7). Returns (kernel 1's
    launches over the main path, its cases at the clone shapes)."""
    (acfg, scfg, hcfg), dev = cfgs, torch.device("cuda")
    ap, sp, hp = (to_torch(t, dev) for t in trees)
    n_params = lambda tree: sum(a.size for a in tree_leaves(tree))
    print(f"[clone] AR {n_params(trees[0]) / 1e6:.1f} M, SoVITS {n_params(trees[1]) / 1e6:.1f} M, "
          f"HuBERT {n_params(trees[2]) / 1e6:.1f} M weights")
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(SEED + 14)
    ref16 = (rng.standard_normal(5 * 16000) * 0.1).astype(np.float32)
    ref32 = torch.as_tensor((rng.standard_normal(5 * 32000) * 0.1).astype(np.float32))[None]
    ref_spec = spectrogram(ref32, 2048, 640, 2048)[0].numpy()  # (frames, 1025)
    cleaner = Cleaner()
    ids = lambda text: np.asarray(cleaner.to_ids(cleaner.clean_text(text, "ru")[0]), np.int64)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    clone = lambda text, **kw: pipelines.clone_tts(
        ap, acfg, sp, scfg, hp, hcfg, ids(text), np.zeros((len(ids(text)), acfg.bert_dim), np.float32),
        ref16, ref_spec, generator=gen, max_new=256, **kw)
    upf = gpt_sovits.upsample_factor(scfg)

    # the main path: 3 requests, launch counts from 0
    clone(TEXTS[2])  # warm-up (cuDNN algorithms, the nvcc-built kernel's first load)
    for k in kernels.values():
        k.launches = 0
    decodes = []
    record = recording(gpt_sovits, "sovits_decode", decodes)
    try:
        for text in (TEXTS[1], TEXTS[3], TEXTS[13]):
            t0 = time.perf_counter()
            wav, n = clone(text)
            dt = time.perf_counter() - t0
            dur = len(wav) / 32000
            print(f"[clone] clone_tts {len(ids(text))} phones -> {n} tokens, {dur:.2f} s audio in "
                  f"{dt:.3f} s, RTF {dt / dur:.4f}")
            check(wav.dtype == np.float32 and len(wav) == n * upf and np.isfinite(wav).all()
                  and np.abs(wav).max() > 0, f"[clone] bad waveform for {text!r}")
    finally:
        record()
    got = {name: k.launches for name, k in kernels.items()}
    expected = {name: 0 for name in kernels} | {"banded_attention": 12 * len(decodes)}
    print(f"[clone] launches over 3 requests ({len(decodes)} sovits_decode calls): {got} "
          f"(expected {expected})")
    check(got == expected, f"[clone] kernel launches {got} != {expected}")
    launches = got["banded_attention"]

    # bench.py's shapes (bench.py:267): text 128, prompt 64, 256 new tokens
    tx, tp, new = 128, 64, 256
    x = torch.as_tensor(rng.integers(0, 300, (8, tx)), device=dev)
    xl = torch.full((8,), tx, dtype=torch.int64, device=dev)
    bert_z = torch.zeros(8, tx, acfg.bert_dim, device=dev)
    prompts = torch.as_tensor(rng.integers(0, 1024, (8, tp)), device=dev)
    with torch.inference_mode():
        pf = cuda_ms(lambda: gpt_sovits.prefill(ap, acfg, x[:1], xl[:1], bert_z[:1], prompts[:1],
                                                max_new=new), 10)
        dec = lambda: gpt_sovits.Decode(ap, acfg, x[:1], xl[:1], bert_z[:1], prompts[:1],
                                        max_new=new, min_new=new, top_k=1)
        eager = dec()
        eager_ms = cuda_ms(eager.step, 32)
        replayed = dec()
        t0 = time.perf_counter()
        graph = replayed.capture()
        torch.cuda.synchronize()
        capture_ms = 1e3 * (time.perf_counter() - t0)
        graph_tok_ms = cuda_ms(graph.replay, 200)
        same = torch.equal(eager.tokens[:, :35], replayed.tokens[:, :35])
    print(f"[clone] B1 prefill (text {tx}, prompt {tp}) {pf:.3f} ms; decode step eager "
          f"{eager_ms:.4f} ms/token, replayed {graph_tok_ms:.4f} ms/token "
          f"(capture with its eager warm-up step {capture_ms:.1f} ms); greedy tokens 0-34 of the "
          f"two equal: {same}")
    check(same, "[clone] the replayed decode step's greedy tokens differ from the eager step's")
    for b in (1, 8):
        run = (lambda: gpt_sovits.ar_infer(ap, acfg, x[:1], bert_z[:1], prompts[:1], generator=gen,
                                           max_new=new, min_new=new)) if b == 1 else \
              (lambda: gpt_sovits.ar_infer_batch(ap, acfg, x, xl, bert_z, prompts, generator=gen,
                                                 max_new=new, min_new=new))
        with torch.inference_mode():
            run()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                toks, _ = run()
                toks.cpu()
                walls.append(time.perf_counter() - t0)
        print(f"[clone] AR B{b}: {b * new} tokens in {', '.join(f'{w:.4f}' for w in walls)} s "
              f"(prefill, capture and replays), {b * new / min(walls):.1f} tokens/s")

    tc, tr = 512, 200
    codes = torch.as_tensor(rng.integers(0, 1024, (1, tc)), device=dev)
    text = torch.as_tensor(rng.integers(0, 300, (1, tx)), device=dev)
    refer = torch.as_tensor(ref_spec[:tr], device=dev)[None]
    ints = lambda v: torch.tensor([v], dtype=torch.int32, device=dev)
    decode = lambda: gpt_sovits.sovits_decode(sp, scfg, codes, text, ints(tx), refer, ints(tr),
                                              generator=gen, code_lengths=ints(tc))
    with torch.inference_mode():
        dec_ms = cuda_ms(decode, 5)
    audio_s = tc * upf / 32000
    print(f"[clone] sovits_decode {tc} codes (text {tx}, reference {tr} frames): {dec_ms:.3f} ms "
          f"for {audio_s:.2f} s audio, {audio_s / (dec_ms / 1e3):.1f} audio s per s")
    with torch.inference_mode():
        profile_requests([("clone_tts", lambda: clone(TEXTS[1])),
                          ("sovits_decode 512 codes", decode)])
    print(f"[clone] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the card against the CPU: greedy, 32 tokens, noise 0
    apc, spc, hpc = (to_torch(t, "cpu") for t in trees)
    t0 = time.perf_counter()
    x1 = ids(TEXTS[1])
    runs = []
    for a, s_, h, d in ((ap, sp, hp, dev), (apc, spc, hpc, torch.device("cpu"))):
        with torch.inference_mode():
            ssl = hubert.hubert_apply(h, hcfg, torch.as_tensor(ref16, device=d)[None])
            pr = gpt_sovits.sovits_extract_latent(s_, scfg, ssl)
            xs = torch.as_tensor(x1, device=d)[None]
            bz = torch.zeros(1, len(x1), acfg.bert_dim, device=d)
            p0 = runs[0]["prompts"].to(d) if runs else pr  # both AR runs on the card's codes
            tok, n = gpt_sovits.ar_infer(a, acfg, xs, bz, p0, max_new=32, top_k=1)
            y = torch.cat([p0, runs[0]["tok"].to(d) if runs else tok], dim=1)
            logits = gpt_sovits.ar_logits(a, acfg, xs, torch.tensor([len(x1)], device=d), y,
                                          torch.tensor([y.shape[1]], device=d), bz)
            codes32 = runs[0]["tok"].to(d) if runs else tok
            wav = gpt_sovits.sovits_decode(s_, scfg, codes32, xs,
                                           torch.tensor([len(x1)], dtype=torch.int32, device=d),
                                           torch.as_tensor(ref_spec, device=d)[None],
                                           torch.tensor([ref_spec.shape[0]], dtype=torch.int32,
                                                        device=d), noise_scale=0.0)
        runs.append({"prompts": pr.cpu(), "tok": tok.cpu(), "n": int(n), "logits": logits.cpu(),
                     "wav": wav.cpu()})
    g, c = runs
    code_diff = int((g["prompts"] != c["prompts"]).sum())
    logit_err = float((g["logits"] - c["logits"]).abs().max())
    logit_scale = float(c["logits"].abs().max())
    wav_err = float((g["wav"] - c["wav"]).abs().max())
    peak = float(c["wav"].abs().max())
    print(f"[clone] parity card vs CPU ({time.perf_counter() - t0:.1f} s): prompt codes differ at "
          f"{code_diff} of {g['prompts'].numel()}; greedy tokens equal "
          f"{torch.equal(g['tok'], c['tok'])}, n {g['n']} and {c['n']}; teacher-forced logits "
          f"{logit_err:.3e} (max |logit| {logit_scale:.3f}, tol {1e-4 * logit_scale:.3e}); "
          f"waveform at 32 codes {wav_err:.3e} (peak {peak:.4f}, tol {1e-3 * peak:.3e})")
    check(code_diff == 0, "[clone] the card's prompt codes differ from the CPU's")
    check(torch.equal(g["tok"], c["tok"]) and g["n"] == c["n"], "[clone] tokens or n differ")
    check(logit_err <= 1e-4 * logit_scale, f"[clone] logits differ by {logit_err}")
    check(peak > 0 and np.isfinite(g["wav"].numpy()).all() and wav_err <= 1e-3 * peak,
          f"[clone] waveform differs by {wav_err}")

    cases = [attention_case(1, 1024, [1024], 50, 20, 31), attention_case(1, tx, [tx], 50, 20, 32),
             attention_case(1, 5, [5], 0, 0, 33)]
    return launches, cases


def clone_long_phase(kernels, cfgs, trees):
    """``[clone-long]``: see the module docstring (phase 8). Returns kernel
    1's launches over the run."""
    (acfg, scfg, hcfg), dev = cfgs, torch.device("cuda")
    ap, sp, hp = (to_torch(t, dev) for t in trees)
    rng = np.random.default_rng(SEED + 15)
    ref16 = (rng.standard_normal(5 * 16000) * 0.1).astype(np.float32)
    ref32 = torch.as_tensor((rng.standard_normal(5 * 32000) * 0.1).astype(np.float32))[None]
    ref_spec = spectrogram(ref32, 2048, 640, 2048)[0].numpy()
    paragraph = " ".join(TEXTS[i] for i in (1, 3, 4, 6, 7, 10))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ar_calls, dec_calls = [], []
    for k in kernels.values():
        k.launches = 0
    restore = [recording(gpt_sovits, "ar_infer_batch", ar_calls),
               recording(gpt_sovits, "sovits_decode", dec_calls)]
    try:
        t0 = time.perf_counter()
        wav, n = pipelines.clone_tts_long(ap, acfg, sp, scfg, hp, hcfg, paragraph, ref16, ref_spec,
                                          frontend=Cleaner(), generator=gen, top_k=1, max_new=256,
                                          max_batch=8)
        wall = time.perf_counter() - t0
    finally:
        for r in restore:
            r()
    got = {name: k.launches for name, k in kernels.items()}
    expected = {name: 0 for name in kernels} | {"banded_attention": 12 * len(dec_calls)}
    dur = len(wav) / 32000
    chunks = len(pipelines.cut_text(paragraph))
    print(f"[clone-long] {chunks} chunks, {n} tokens, {dur:.2f} s audio in {wall:.3f} s "
          f"(RTF {wall / dur:.4f}; the first call of its shapes); AR groups "
          f"{[tuple(a[2].shape) for a, _, _ in ar_calls]}, decode groups "
          f"{[tuple(a[2].shape) for a, _, _ in dec_calls]}; launches {got} (expected {expected})")
    check(np.isfinite(wav).all() and np.abs(wav).max() > 0 and chunks == 6,
          "[clone-long] bad output")
    check(got == expected, f"[clone-long] kernel launches {got} != {expected}")
    rows = 0
    with torch.inference_mode():
        for args, kw, (toks, _) in ar_calls:
            params, cfg, x, xl, bert_z, prompts = args
            for r in range(x.shape[0]):
                alone, _ = gpt_sovits.ar_infer(
                    params, cfg, x[r:r + 1], bert_z[r:r + 1], prompts[r:r + 1], x_len=int(xl[r]),
                    **{k: v for k, v in kw.items() if k != "generator"})
                check(torch.equal(alone[0], toks[r]),
                      f"[clone-long] batched AR row {r} differs from its text run alone")
                rows += 1
    print(f"[clone-long] {rows} batched AR rows (pad rows included) equal their texts run alone "
          f"(greedy)")
    return got["banded_attention"]


def recording(module, name, log):
    """Replace ``module.name`` by a wrapper that appends (args, kwargs,
    result) of each call to ``log``; returns the function that restores it."""
    fn = getattr(module, name)

    def rec(*args, **kwargs):
        out = fn(*args, **kwargs)
        log.append((args, kwargs, out))
        return out

    setattr(module, name, rec)
    return lambda: setattr(module, name, fn)


def tree_leaves(tree):
    """The array leaves of a nested dict/list tree."""
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in tree_leaves(v)]
    return [] if tree is None else [np.asarray(tree)]


# ---------------------------------------------------------------------------
# 9. VITS2 GAN training at full width
# ---------------------------------------------------------------------------

TRAIN_SEED = SEED + 40
TRAIN_UTTERANCES = 48


def write_voice(path, rng, n_samples, sr):
    """A wav of ``n_samples`` at ``sr`` from ``rng``: five harmonics of a
    wandering f0 under a syllable-rate envelope, plus noise."""
    t = np.arange(n_samples) / sr
    f0 = rng.uniform(90, 220) * (1 + 0.2 * np.sin(2 * np.pi * rng.uniform(0.2, 0.8) * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum(np.sin(k * phase) / k for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3, 6) * t + rng.uniform(0, 2 * np.pi))
    x = 0.3 * voiced * env + 0.02 * rng.standard_normal(len(t))
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((np.clip(x, -1, 1) * 20000).astype(np.int16).tobytes())


def write_corpus(root, n=TRAIN_UTTERANCES):
    """n utterances of 2-6 s at 22.05 kHz made from the seed (five harmonics
    of a wandering f0 under a syllable-rate envelope, plus noise), each with
    one of TEXTS (through the port's G2P, the data pipeline's g2p mode) and
    a speaker; the metadata file ``meta.csv``."""
    rng = np.random.default_rng(TRAIN_SEED)
    lines = []
    for i in range(n):
        path = os.path.join(root, f"u{i:02d}.wav")
        write_voice(path, rng, int(rng.uniform(2.0, 6.0) * 22050), 22050)
        text = TEXTS[i % len(TEXTS)].replace(" —", ",")  # the G2P has no dash symbol
        lines.append(f"{path}|{(7 * i) % 200}|{text}|{text}")
    with open(os.path.join(root, "meta.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")


def train_config(root):
    """The reference config.json of the shipped VITS2 (mb_istft_vits2_multi's
    flags) at its full width: every width is the reader's default, the
    flags are set; batch 24 (run_vits2's default), 8192-sample segments
    (32 frames)."""
    return {
        "train": {"batch_size": 24, "epochs": 1000, "log_interval": 1, "eval_interval": 10 ** 6,
                  "segment_size": 8192, "seed": TRAIN_SEED},
        "data": {"training_files": os.path.join(root, "meta.csv"), "sampling_rate": 22050,
                 "filter_length": 1024, "hop_length": 256, "win_length": 1024,
                 "n_mel_channels": 80, "g2p_text": True, "n_speakers": 200,
                 "use_mel_posterior_encoder": True},
        "model": {"use_mel_posterior_encoder": True, "mb_istft_vits": True,
                  "use_transformer_flows": True, "transformer_flow_type": "pre_conv2",
                  "use_spk_conditioned_encoder": True, "use_sdp": True, "gin_channels": 256,
                  "use_duration_discriminator": True},
    }


def same_state(a, b):
    """Equal step, parameters, AdamW state (step, moments) and, for the
    StableTTS trainer, accumulated gradients of two TrainStates."""
    if a.step != b.step or a.params.keys() != b.params.keys():
        return False
    if any(not torch.equal(x, y) for x, y in zip(getattr(a, "acc", []), getattr(b, "acc", []))):
        return False
    for k in a.params:
        for x, y in zip(a.params[k].parameters(), b.params[k].parameters()):
            if not torch.equal(x, y):
                return False
        sa, sb = a.opt[k].state_dict()["state"], b.opt[k].state_dict()["state"]
        if sa.keys() != sb.keys():
            return False
        for i in sa:
            if any(not torch.equal(sa[i][n].cpu(), sb[i][n].cpu())
                   for n in ("step", "exp_avg", "exp_avg_sq")):
                return False
    return True


def mas_case(args, shape, iters, plain_iters):
    """The MAS kernel against its plain version on (neg_cent, t_ys, t_xs):
    exactly equal; times and the bound (neg_cent's valid rows read once, the
    path written once)."""
    neg_cent, t_ys, t_xs = args
    got = mas.mas_path(*args)
    want = mas.maximum_path_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"mas kernel differs from its plain version at {shape}")
    b, t_y, t_x = neg_cent.shape
    nbytes = 4 * int((t_ys.long() * t_xs.long()).sum()) + 4 * b * t_y * t_x
    bound_ms, bound_by = bound(0, nbytes)
    return {"shape": shape, "max_abs_err": float((got - want).abs().max()),
            "ms": cuda_ms(lambda: mas.mas_path(*args), iters),
            "plain_ms": cuda_ms(lambda: mas.maximum_path_plain(*args), plain_iters, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by}


def grad_errors(a, ref):
    """A network's gradients against a reference: the largest max|g_a - g_ref|
    / max|g_ref| over its tensors (a tensor whose reference gradient is below
    1e-6 x the network's largest, 0 in exact arithmetic as the attention key
    biases, is taken over that floor) and its path, and the relative L2 error
    of all its gradients together."""
    ga = {p: t.grad for p, t in a.leaves().items() if t.grad is not None}
    gr = {p: t.grad.to(ga[p].device) for p, t in ref.leaves().items() if p in ga}
    floor = 1e-6 * max(float(g.abs().max()) for g in gr.values())
    errs = {p: float((ga[p] - g).abs().max()) / max(float(g.abs().max()), floor)
            for p, g in gr.items()}
    where = max(errs, key=errs.get)
    l2 = (sum(float((ga[p] - g).double().pow(2).sum()) for p, g in gr.items())
          / sum(float(g.double().pow(2).sum()) for g in gr.values())) ** 0.5
    return errs[where], where, l2


# the card's f32 gradients against the CPU's f64 step: the limit of each
# network's relative L2 error, all its tensors together. The H100 readings
# (PERF.md section 2) reach 1e-3; a wrong backward is off by 1e-1 or more;
# a ReLU kink crossed on one side only moves one row of one weight.
PARITY_GRAD_L2 = 1e-2


def parity_noise(mcfg, pair, seed):
    """The noise of one parity step of the B2 batch ``pair``, drawn from
    ``seed`` (CPU tensors)."""
    t_x, t_y = pair["x"].shape[1], pair["mel"].shape[1]
    rng = np.random.default_rng(seed)
    noise = {"posterior": rng.standard_normal((2, t_y, mcfg.inter_channels)),
             "e_q": rng.standard_normal((2, t_x, 2)), "z": rng.standard_normal((2, t_x, 2))}
    noise = {k: torch.tensor(v.astype(np.float32)) for k, v in noise.items()}
    noise["ids_slice"] = torch.tensor(
        (rng.uniform(size=2) * np.maximum(pair["mel_lengths"] - mcfg.segment_size + 1, 1)
         ).astype(np.int32))
    return noise


def parity_step(mcfg, tcfg, trees, pair, noise, device, dtype=None, slm=None, attn=None):
    """One train step of ``pair`` from ``trees`` on ``device`` (every lr but
    G's 0; ``dtype`` the compute dtype, ``slm`` as train_parity's), fed the
    alignment ``attn``, or with none found first with no gradient and the
    step left to find its own. Returns (the state, its gradients kept; the
    losses; the alignment on the CPU)."""
    state = tt.init_train_state(mcfg, tcfg, device=device, trees=trees)
    for k, opt in state.opt.items():
        if k != "g":
            for group in opt.param_groups:
                group["lr"] = 0.0
    batch = to_device(pair, device)
    nz = {k: v.to(device) for k, v in noise.items()}
    if attn is None:
        with torch.no_grad():
            attn = vits2.forward_train(state.params["g"].params, mcfg, batch["x"],
                                       batch["x_lengths"], batch["mel"], batch["mel_lengths"],
                                       batch["sid"], noise=nz)["attn"]
    else:
        nz["attn"] = attn.to(device)
    wl = None if slm is None else wavlm.WavLM(*slm).to(device)
    step = tt.make_train_step(mcfg, tcfg, compute_dtype=dtype, slm=wl)
    losses = {k: float(v) for k, v in step(state, batch, noise=nz).items()}
    return state, losses, attn.cpu()


def train_parity(mcfg, tcfg, trees, pair, seed, dev, tag="train-parity", f64=True, slm=None):
    """One train step of the B2 batch ``pair`` (numpy) in f32 on the card, in
    f32 on the CPU and (with ``f64``) in f64 on the CPU (a differentiable
    cast of the f32 parameters, as the bf16 step), from the same trees, noise
    and alignment (the card's); ``slm`` (a WavLMConfig and its port-layout
    tree) turns on the WavLM/SLM branch on every side. Every learning rate
    but G's is 0, so G's loss runs through the same discriminators on every
    side (AdamW's first step moves each parameter by about lr x sign(grad):
    float noise in a near-zero D gradient would become a D parameter that
    differs by ~lr).

    The card steps in deterministic algorithms, so that its gradients from
    given trees are the same in every run: in torch's default ones their
    last bits change from step to step (train_parity_probe.py). One run
    read D gradients 1.153e-2 relative L2 off the f64 step where others
    read ~1e-5 (ROADMAP C.4, not explained).

    Checks the card's losses against the CPU's f32 ones (1e-3 relative), and
    each network's gradients, all together, against the f64 step
    (PARITY_GRAD_L2). A single tensor is not held to a limit: the f32 step
    is badly conditioned in places (a weight gradient summed from terms that
    nearly cancel; ReLU kinks near 0), so one tensor's error can reach a few
    1e-2 of its own max on either f32 side; each network's worst tensor is
    printed."""
    t_x, t_y = pair["x"].shape[1], pair["mel"].shape[1]
    noise = parity_noise(mcfg, pair, seed)
    sides, t0 = {}, time.perf_counter()
    cpu = torch.device("cpu")
    with deterministic():
        sides["card"] = parity_step(mcfg, tcfg, trees, pair, noise, dev, slm=slm)
    for name, dtype in (("CPU", None), ("CPU f64", torch.float64))[:2 if f64 else 1]:
        sides[name] = parity_step(mcfg, tcfg, trees, pair, noise, cpu, dtype, slm,
                                  attn=sides["card"][2])
    (card, got, _), (ref, want, _) = sides["card"], sides["CPU"]
    exact = sides["CPU f64"][1] if f64 else "not run"
    rel = {k: abs(got[k] - w) / max(abs(w), 1e-30) for k, w in want.items()}
    lr0 = ", ".join(k for k in card.opt if k != "g")
    print(f"[{tag}] one step, B2 T_x {t_x} T_y {t_y}, card f32 vs CPU f32"
          f"{' and f64' if f64 else ''} (the CPU's and the card's "
          f"{time.perf_counter() - t0:.1f} s, fed the card's alignment; {lr0} lr 0): losses "
          f"card {got}, CPU {want}, CPU f64 {exact}, card vs CPU f32 relative differences {rel} "
          f"(tol 1e-3)")
    check(set(got) == set(want) and all(r <= 1e-3 for r in rel.values()),
          f"[{tag}] card vs CPU losses differ: {rel}")
    if not f64:
        return
    ref64 = sides["CPU f64"][0]
    for k in card.params:
        (e_card, w_card, l2_card), (e_cpu, w_cpu, l2_cpu) = \
            grad_errors(card.params[k], ref64.params[k]), grad_errors(ref.params[k], ref64.params[k])
        e_pair, w_pair, l2_pair = grad_errors(card.params[k], ref.params[k])
        print(f"[{tag}] {k} gradients against the f64 step: relative L2, all tensors "
              f"together, card {l2_card:.3e} (tol {PARITY_GRAD_L2}), CPU f32 {l2_cpu:.3e}; "
              f"largest max|err| / max|f64| a tensor card {e_card:.3e} ({w_card}), CPU f32 "
              f"{e_cpu:.3e} ({w_cpu}); card vs CPU f32: L2 {l2_pair:.3e}, largest a tensor "
              f"{e_pair:.3e} ({w_pair})")
        check(l2_card <= PARITY_GRAD_L2,
              f"[{tag}] card {k} gradients differ from the f64 step: relative L2 {l2_card}")


def train_phase(kernels, smi, dev=torch.device("cuda")):
    """``[train]``: run_vits2 at full width on a synthetic corpus (3 steps,
    then a resume for one more), a timed and a profiled step, MAS against
    its plain version, card against CPU at B2, the exported generator served
    through Model, one bf16 step. Each timing line ends with ``smi``, the
    card's name and power limit. Returns (MAS launches over run_vits2's
    runs, MAS cases)."""
    all_kernels = {**kernels, "mas": mas.KERNEL}
    with tempfile.TemporaryDirectory(prefix="vits2-train-") as root:
        t0 = time.perf_counter()
        write_corpus(root)
        cfg_path = os.path.join(root, "config.json")
        with open(cfg_path, "w", encoding="utf-8") as f:
            json.dump(train_config(root), f)
        mcfg, tcfg, dcfg = run_vits2.build_configs(train_config(root))
        check(mcfg == vits2.VITS2Config() and tcfg == tt.TrainConfig(),
              f"the training config is not the full-width default: {mcfg} {tcfg}")
        print(f"[train] {TRAIN_UTTERANCES} utterances of 2-6 s written in "
              f"{time.perf_counter() - t0:.1f} s; VITS2Config() and TrainConfig() (periods "
              f"{tcfg.disc_periods}, spectral FFTs {tcfg.disc_spec_ffts}), batch 24, "
              f"segment {mcfg.segment_size} frames")
        model_dir = os.path.join(root, "model")

        # run_vits2: 3 steps, then a resume for one more
        for k in all_kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        first, m1 = run_vits2.main(["-c", cfg_path, "-m", model_dir, "--max-steps", "3"])
        t_first = time.perf_counter() - t0
        check(first.step == 3 and m1 and all(np.isfinite(v) for v in m1.values()),
              f"run_vits2: step {first.step}, metrics {m1}")
        print(f"[train] run_vits2 --max-steps 3 in {t_first:.1f} s (init, mels, 3 steps, "
              f"save): last step {m1}")
        restored = tt.init_train_state(mcfg, tcfg, seed=TRAIN_SEED + 1, device=dev)
        resume_state(model_dir, restored)
        check(same_state(first, restored), "STATE_3 did not restore the step, the params and "
              "the optimizer state")
        del restored, first
        t0 = time.perf_counter()
        state, m2 = run_vits2.main(["-c", cfg_path, "-m", model_dir, "--max-steps", "4"])
        check(state.step == 4 and m2 and all(np.isfinite(v) for v in m2.values()),
              f"resumed run_vits2: step {state.step}, metrics {m2}")
        print(f"[train] resumed from STATE_3 (step, params and AdamW state equal to the "
              f"saved ones), one more step in {time.perf_counter() - t0:.1f} s: {m2}")
        got = {n: k.launches for n, k in all_kernels.items()}
        expected = {n: 0 for n in all_kernels} | {"mas": 4}
        print(f"[train] launches over run_vits2's 4 steps: {got} (expected {expected})")
        check(got == expected, f"kernel launches {got} != {expected}")
        main_launches = got["mas"]

        # one batch of the corpus, timed steps
        batch_np = next(BucketBatcher(TTSDataset(dcfg), 24).epoch(0))
        batch = to_device(batch_np, dev)
        b, t_x = batch_np["x"].shape
        t_y = batch_np["mel"].shape[1]
        step = tt.make_train_step(mcfg, tcfg)
        gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
        for _ in range(2):
            step(state, batch, generator=gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        times, host = [], []
        for i in range(5):
            if i == 0:
                for k in all_kernels.values():
                    k.launches = 0
            t0 = time.perf_counter()
            start.record()
            metrics = step(state, batch, generator=gen)
            end.record()
            end.synchronize()
            host.append(1e3 * (time.perf_counter() - t0))
            times.append(start.elapsed_time(end))
            if i == 0:
                got = {n: k.launches for n, k in all_kernels.items()}
                check(got == {n: 0 for n in all_kernels} | {"mas": 1},
                      f"one train step launched {got}: expected MAS once, nothing else")
            vals = {k: float(v) for k, v in metrics.items()}
            check(all(np.isfinite(v) for v in vals.values()), f"a loss is not finite: {vals}")
            print(f"[train] timed step {i + 1}/5, B{b} T_x {t_x} T_y {t_y}: {times[-1]:.3f} ms "
                  f"(CUDA events), {host[-1]:.3f} ms (host clock); {smi}")
        seg_s = b * mcfg.segment_size * tcfg.hop_length / tcfg.sampling_rate
        ms = float(np.mean(times))
        print(f"[train] launches in one step: {got}")
        print(f"[train] mean {ms:.3f} ms a step: {1e3 / ms:.3f} steps/s; "
              f"{seg_s * 1e3 / ms:.2f} segment audio s per s ({seg_s:.3f} s a step); "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}; last "
              f"losses { {k: round(v, 4) for k, v in vals.items()} }")
        kern, wall_us, _ = trace(lambda: step(state, batch, generator=gen))
        if kern:
            busy_us = sum(e.self_device_time_total for e in kern)
            print(f"[train] profile of one step: wall {wall_us / 1e3:.3f} ms, device busy "
                  f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%), "
                  f"{sum(e.count for e in kern)} kernel launches; {smi}")
            for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
                print(f"[train]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
                      f"{e.key[:110]}")
        else:
            print("[train] profile: no device events in the trace (device time not measured)")

        # MAS at the step's shapes and at B24 T_y 800 T_x 200
        log = []
        restore = recording(mas, "mas_path", log)
        try:
            step(state, batch, generator=gen)
        finally:
            restore()
        cases = [mas_case(log[0][0], f"B{b} T_y {t_y} T_x {t_x} (the step's)", 50, 2)]
        g = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
        args = (torch.randn(24, 800, 200, generator=g, device=dev) * 3,
                torch.tensor([800 - 8 * i for i in range(24)], dtype=torch.int32, device=dev),
                torch.tensor([200 - 2 * i for i in range(24)], dtype=torch.int32, device=dev))
        cases.append(mas_case(args, "B24 T_y 800 T_x 200", 50, 1))
        for c in cases:
            print(f"[kernel] mas {json.dumps(c)} tol 0 (exact)")

        # card against the CPU: one f32 step at full width, B2, for two pairs of rows
        trees = {k: m.numpy_tree() for k, m in state.params.items()}
        for i in range(2):
            train_parity(mcfg, tcfg, trees, {k: v[2 * i:2 * i + 2] for k, v in batch_np.items()},
                         TRAIN_SEED + i, dev)
        del trees

        # the exported generator, served
        g_path = ckpt.latest_checkpoint(model_dir, "G_")
        with tempfile.TemporaryDirectory(prefix="vits2-trained-") as bundle:
            write_bundle(bundle, mcfg, load_params(g_path))
            model = api.Model(bundle)
            for k in all_kernels.values():
                k.launches = 0
            audio = api.Synth(model).synth_audio(TEXTS[1])
            got = {n: k.launches for n, k in all_kernels.items()}
            check(audio.dtype == np.int16 and len(audio) > 0 and np.any(audio != 0),
                  "the exported generator gave no audio")
            check(got == {n: 0 for n in all_kernels} | {"banded_attention": 10, "ddsconv": 4},
                  f"serving the export launched {got}")
            print(f"[train] {os.path.basename(g_path)} (the bundle layout) served through "
                  f"Model: {len(audio)} samples, launches {got}")
            del model

        # mixed precision: one bf16 step
        bf16 = tt.make_train_step(mcfg, tcfg, compute_dtype=torch.bfloat16)
        t0 = time.perf_counter()
        vals = {k: float(v) for k, v in bf16(state, batch, generator=gen).items()}
        print(f"[train] one bf16 step in {1e3 * (time.perf_counter() - t0):.1f} ms (host "
              f"clock, first call); {smi}: {vals}")
        check(all(np.isfinite(v) for v in vals.values()), f"a bf16 loss is not finite: {vals}")
        del state
    return main_launches, cases


# ---------------------------------------------------------------------------
# 14-15. VITS2 variant training and the WavLM/SLM loss at full width
# ---------------------------------------------------------------------------

#: a trained variant's export served on the card against the CPU: the
#: largest sample difference, in int16 steps (the rounding of a value on
#: either side of a step, twice)
SERVE_INT16_TOL = 2

#: the six variants the port serves, as the reference config.json's model
#: block sets them (the port also reads ``istft_mode``), each decoder at 256
#: samples a frame
TRAIN_VARIANTS = (
    ("plain+ms_istft", {"use_transformer_flows": False, "ms_istft_vits": True}),
    ("pre_conv+istft", {"transformer_flow_type": "pre_conv", "istft_vits": True,
                        "upsample_rates": [8, 8], "upsample_kernel_sizes": [16, 16]}),
    ("pre_conv2+mb_istft/onnx+dp", {"mb_istft_vits": True, "istft_mode": "onnx",
                                    "use_sdp": False}),
    ("fft+hifigan", {"transformer_flow_type": "fft", "upsample_rates": [8, 8, 2, 2],
                     "upsample_kernel_sizes": [16, 16, 4, 4]}),
    ("mono_inter+ms_istft/onnx+dp", {"transformer_flow_type": "mono_layer_inter_residual",
                                     "ms_istft_vits": True, "istft_mode": "onnx",
                                     "use_sdp": False}),
    ("mono_post+istft/onnx", {"transformer_flow_type": "mono_layer_post_residual",
                              "istft_vits": True, "istft_mode": "onnx", "upsample_rates": [8, 8],
                              "upsample_kernel_sizes": [16, 16]}),
)
#: the fields a variant sets; every other one stays VITS2Config()'s
VARIANT_FIELDS = ("use_transformer_flows", "transformer_flow_type", "decoder_type", "istft_mode",
                  "use_sdp", "upsample_rates", "upsample_kernel_sizes")


def variant_train_config(root, over):
    """train_config with the shipped decoder flag dropped and ``over`` set."""
    cfg = train_config(root)
    cfg["model"] = {**{k: v for k, v in cfg["model"].items() if k != "mb_istft_vits"}, **over}
    return cfg


def corpus_batch(dcfg, dev):
    """The first B24 batch of the corpus (numpy, and on ``dev``)."""
    batch_np = next(BucketBatcher(TTSDataset(dcfg), 24).epoch(0))
    return batch_np, to_device(batch_np, dev)


def train_variants_phase(kernels, smi, root, dev=torch.device("cuda")):
    """``[train-variants]``: each of TRAIN_VARIANTS at full width
    (VITS2Config() widths, TrainConfig(), the ``[train]`` corpus in
    ``root``): run_vits2 --max-steps 2 at B24 (MAS 2 launches, no other
    kernel); 2 steps timed by CUDA events (MAS once a step); G_2.npz (the
    bundle layout) served through Model/Synth on the card (TEXTS[0], noise
    0), its launches held to per_synthesis_call, its length equal to the
    CPU's; one B2 step card vs CPU (every lr but G's 0), the gradients
    against a CPU f64 step for the ``dp_apply`` variants; the time of each
    part. Returns (MAS launches over the run_vits2 runs, the serving
    launches of each kernel)."""
    all_kernels = {**kernels, "mas": mas.KERNEL}
    mas_launches, serve = 0, {n: 0 for n in kernels}
    batch_np = batch = None
    for i, (name, over) in enumerate(TRAIN_VARIANTS):
        tag = f"train-variants {name}"
        t_phase = time.perf_counter()
        cfg = variant_train_config(root, over)
        cfg_path = os.path.join(root, f"variant{i}.json")
        with open(cfg_path, "w", encoding="utf-8") as f:
            json.dump(cfg, f)
        mcfg, tcfg, dcfg = run_vits2.build_configs(cfg)
        base = dataclasses.replace(mcfg, **{k: getattr(vits2.VITS2Config(), k)
                                            for k in VARIANT_FIELDS})
        check(base == vits2.VITS2Config() and tcfg == tt.TrainConfig()
              and mcfg.upsample_factor == tcfg.hop_length,
              f"[{tag}] not the full-width default: {mcfg} {tcfg}")
        if batch is None:
            batch_np, batch = corpus_batch(dcfg, dev)
        model_dir = os.path.join(root, f"variant{i}")
        expected = zeroed(all_kernels) | {"mas": 2}
        t0 = time.perf_counter()
        state, m = run_vits2.main(["-c", cfg_path, "-m", model_dir, "--max-steps", "2"])
        got = launches_now(all_kernels)
        check(state.step == 2 and m and all(np.isfinite(v) for v in m.values()),
              f"[{tag}] run_vits2: step {state.step}, metrics {m}")
        check(got == expected, f"[{tag}] run_vits2's 2 steps launched {got}, expected {expected}")
        mas_launches += got["mas"]
        print(f"[{tag}] {vits2.flow_type(mcfg)} flows, {mcfg.decoder_type} decoder "
              f"({mcfg.istft_mode} iSTFT), {'SDP' if mcfg.use_sdp else 'dp_apply'}; run_vits2 "
              f"--max-steps 2 at B24 in {time.perf_counter() - t0:.1f} s: launches {got}; last "
              f"{m}")

        b, t_x = batch_np["x"].shape
        seg_s = b * mcfg.segment_size * tcfg.hop_length / tcfg.sampling_rate
        t_run = time.perf_counter() - t0
        t0 = time.perf_counter()
        timed_steps(tag, tt.make_train_step(mcfg, tcfg), state, batch,
                    torch.Generator(device=dev).manual_seed(TRAIN_SEED), 2, smi, all_kernels,
                    seg_s=seg_s, per_step={"mas": 1}, profile=False)
        t_timed, t0 = time.perf_counter() - t0, time.perf_counter()

        # the exported generator, served on the card and on the CPU
        g_path = ckpt.latest_checkpoint(model_dir, "G_")
        check(os.path.basename(g_path) == "G_2.npz", f"[{tag}] the export is {g_path}")
        with tempfile.TemporaryDirectory(prefix="vits2-variant-trained-") as bundle:
            write_bundle(bundle, mcfg, load_params(g_path))
            model = api.Model(bundle)
            kw = dict(speaker_id=3, noise_level=0.0, duration_noise_level=0.0)
            expected = zeroed(all_kernels) | per_synthesis_call(mcfg)
            audio = api.Synth(model).synth_audio(TEXTS[0], **kw)
            got = launches_now(all_kernels)
            cpu_audio = api.Synth(api.Model(bundle, device="cpu")).synth_audio(TEXTS[0], **kw)
            diff = int(np.abs(audio.astype(np.int32) - cpu_audio.astype(np.int32)).max()) \
                if len(audio) == len(cpu_audio) else None
            print(f"[{tag}] G_2.npz (the bundle layout) served through Model/Synth: "
                  f"{len(audio)} samples (CPU {len(cpu_audio)}, largest difference {diff} int16), "
                  f"launches {got} (expected {expected})")
            check(got == expected, f"[{tag}] serving the export launched {got} != {expected}")
            check(len(audio) == len(cpu_audio) > 0 and np.any(audio != 0)
                  and diff <= SERVE_INT16_TOL,
                  f"[{tag}] the export's audio: {len(audio)} samples, CPU {len(cpu_audio)}, "
                  f"largest difference {diff} int16 (tol {SERVE_INT16_TOL})")
            serve = {n: serve[n] + got[n] for n in kernels}
            del model
        t_serve, t0 = time.perf_counter() - t0, time.perf_counter()

        trees = {k: mod.numpy_tree() for k, mod in state.params.items()}
        train_parity(mcfg, tcfg, trees, {k: v[:2] for k, v in batch_np.items()},
                     TRAIN_SEED + 20 + i, dev, tag=f"{tag} parity", f64=not mcfg.use_sdp)
        del state, trees
        torch.cuda.empty_cache()
        print(f"[{tag}] done in {time.perf_counter() - t_phase:.1f} s: run_vits2 {t_run:.1f}, "
              f"timed steps {t_timed:.1f}, serving {t_serve:.1f}, parity "
              f"{time.perf_counter() - t0:.1f} s")
    return mas_launches, serve


SLM_SEED = SEED + 70


def train_slm_phase(kernels, smi, root, dev=torch.device("cuda")):
    """``[train-slm]``: a WavLMConfig() (base-plus, 12 x 768) directory from
    wavlm_init (config.json in the Hugging Face form, params.npz in the
    bundle layout); run_vits2 --wavlm-dir at full width (the shipped
    configuration, B24): 3 steps, STATE_3 restored into a fresh state (the
    WavLM discriminator and its AdamW state included), a resumed step; 3
    steps timed and one profiled; ``resample`` card vs CPU on the batch's
    waveforms (1e-5 x peak); ``[train-slm-parity]``: one B2 step card vs
    CPU f32 and f64 with WavLM at full width (every lr but G's 0): losses
    1e-3 relative, every network's gradients 1e-2 relative L2 of the f64
    step's. Returns MAS's launches over the run_vits2 runs."""
    all_kernels = {**kernels, "mas": mas.KERNEL}
    tag = "train-slm"
    wcfg = wavlm.WavLMConfig()
    wdir = os.path.join(root, "wavlm")
    os.makedirs(wdir)
    t0 = time.perf_counter()
    tree = wavlm_init(wcfg, SLM_SEED)
    save_params(os.path.join(wdir, "params.npz"), tree)
    with open(os.path.join(wdir, "config.json"), "w", encoding="utf-8") as f:
        json.dump(wcfg.to_hf(), f)
    n_params = sum(a.size for a in tree_leaves(tree))
    print(f"[{tag}] WavLMConfig() ({wcfg.num_hidden_layers} x {wcfg.hidden_size}, "
          f"{n_params / 1e6:.2f} M parameters) written in {time.perf_counter() - t0:.1f} s")
    cfg = train_config(root)
    cfg_path = os.path.join(root, "slm.json")
    with open(cfg_path, "w", encoding="utf-8") as f:
        json.dump(cfg, f)
    mcfg, tcfg, dcfg = run_vits2.build_configs(cfg)
    tcfg = dataclasses.replace(tcfg, use_slm=True)
    model_dir = os.path.join(root, "slm")
    args = ["-c", cfg_path, "-m", model_dir, "--wavlm-dir", wdir]

    expected = zeroed(all_kernels) | {"mas": 4}
    t0 = time.perf_counter()
    first, m1 = run_vits2.main(args + ["--max-steps", "3"])
    check(first.step == 3 and "wd" in first.params
          and all(np.isfinite(m1[k]) for k in ("loss_slm_disc", "loss_lm", "loss_lm_gen")),
          f"[{tag}] run_vits2 --wavlm-dir: step {first.step}, metrics {m1}")
    print(f"[{tag}] run_vits2 --wavlm-dir --max-steps 3 in {time.perf_counter() - t0:.1f} s "
          f"(init, mels, 3 steps, save): last step {m1}")
    slm_dims = dict(slm_hidden=wcfg.hidden_size, slm_layers=wcfg.num_hidden_layers + 1)
    restored = tt.init_train_state(mcfg, tcfg, seed=TRAIN_SEED + 1, device=dev, **slm_dims)
    resume_state(model_dir, restored)
    check(same_state(first, restored), f"[{tag}] STATE_3 did not restore the state (the WavLM "
          "discriminator's params and AdamW state included)")
    del restored, first
    t0 = time.perf_counter()
    state, m2 = run_vits2.main(args + ["--max-steps", "4"])
    got = launches_now(all_kernels)
    check(state.step == 4 and all(np.isfinite(v) for v in m2.values()),
          f"[{tag}] resumed run_vits2: step {state.step}, metrics {m2}")
    check(got == expected, f"[{tag}] run_vits2's 4 steps launched {got}, expected {expected}")
    print(f"[{tag}] resumed from STATE_3 (equal to the saved state), one more step in "
          f"{time.perf_counter() - t0:.1f} s: {m2}; launches over the 4 steps {got}")

    batch_np, batch = corpus_batch(dcfg, dev)
    b = batch_np["x"].shape[0]
    slm = run_vits2.load_wavlm(wdir, dev)
    timed_steps(tag, tt.make_train_step(mcfg, tcfg, slm=slm), state, batch,
                torch.Generator(device=dev).manual_seed(SLM_SEED), 3, smi, all_kernels,
                seg_s=b * mcfg.segment_size * tcfg.hop_length / tcfg.sampling_rate,
                per_step={"mas": 1})

    # the resampler card vs CPU on the batch's first segments
    y = batch["wav"][:, :mcfg.segment_size * tcfg.hop_length]
    got_r = resample(y, tcfg.sampling_rate, 16000)
    want_r = resample(y.cpu(), tcfg.sampling_rate, 16000)
    err, peak = float((got_r.cpu() - want_r).abs().max()), float(want_r.abs().max())
    print(f"[{tag}] resample {tuple(y.shape)} 22050 -> 16000 Hz {tuple(got_r.shape)}: card vs "
          f"CPU max abs {err:.3e}, peak {peak:.3f} (tol 1e-5 x peak)")
    check(got_r.shape == want_r.shape and err <= 1e-5 * peak, f"[{tag}] resample differs: {err}")

    trees = {k: mod.numpy_tree() for k, mod in state.params.items()}
    del state, slm
    torch.cuda.empty_cache()
    train_parity(mcfg, tcfg, trees, {k: v[:2] for k, v in batch_np.items()}, SLM_SEED, dev,
                 tag="train-slm-parity", slm=(wcfg, to_port_layout(tree)))
    return got["mas"]


# ---------------------------------------------------------------------------
# 10-11. StableTTS CFM training and QuickVC GAN training at full width
# ---------------------------------------------------------------------------

STABLE_UTTERANCES = 36
VC_UTTERANCES = 72
_WORDS = re.compile(r'([ ,.?!;:"()])')


def aligned_text(text):
    """``text`` with every word replaced by its phones from the port's G2P,
    joined by underscores (the multistream trainer's pre-aligned text);
    spaces and punctuation kept."""
    return "".join(w if w == "" or _WORDS.fullmatch(w) else "_".join(convert(w).split())
                   for w in _WORDS.split(text.lower()))


def write_stabletts_corpus(root, n=STABLE_UTTERANCES):
    """n utterances of 2-8 s at 22.05 kHz (write_voice), each with one of
    TEXTS, its aligned phones and a speaker; then each utterance's ``.lab``
    durations (kaldi lines, a random split of its mel frames over its
    phone streams, each at least one frame); the metadata ``meta.csv``."""
    rng = np.random.default_rng(TRAIN_SEED + 10)
    lines = []
    for i in range(n):
        path = os.path.join(root, f"s{i:02d}.wav")
        write_voice(path, rng, int(rng.uniform(2.0, 8.0) * 22050), 22050)
        text = TEXTS[i % len(TEXTS)].replace(" —", ",")
        lines.append(f"{path}|{(5 * i) % 128}|{text}|{aligned_text(text)}")
    meta = os.path.join(root, "meta.csv")
    with open(meta, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    ds = stabletts_data.StableTTSDataset(stabletts_data.StableDataConfig(metadata=meta))
    for i in range(len(ds)):
        t, frames = ds.text_streams(i)[0].shape[0], ds.mel(i).shape[0]
        durs = 1 + np.floor(rng.dirichlet(np.ones(t)) * (frames - t)).astype(np.int64)
        durs[-1] += frames - durs.sum()
        with open(ds.items[i][0][:-4] + ".lab", "w", encoding="utf-8") as f:
            f.write("\n".join(f"p {j} {d}" for j, d in enumerate(durs)) + "\n")
    return meta


def profile_step(tag, run, smi):
    """torch.profiler (shapes recorded) over one call of ``run`` (a train
    step): wall, device busy share, launches, the top kernels, and the
    convolutions (forward and backward) with the most device time, by input
    shapes."""
    kern, wall_us, prof = trace(run, record_shapes=True)
    if not kern:
        print(f"[{tag}] profile: no device events in the trace (device time not measured)")
        return
    busy_us = sum(e.self_device_time_total for e in kern)
    print(f"[{tag}] wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"({100 * busy_us / wall_us:.1f}%), {sum(e.count for e in kern)} kernel launches; {smi}")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[{tag}]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:110]}")
    convs = [e for e in prof.key_averages(group_by_input_shape=True)
             if e.key in ("aten::convolution", "aten::convolution_backward")]
    for e in sorted(convs, key=lambda e: -e.device_time_total)[:4]:
        print(f"[{tag}]   conv {e.device_time_total / 1e3:8.3f} ms x{e.count:<4d} {e.key} "
              f"{str(e.input_shapes)[:120]}")


def event_ms(run):
    """(ms between CUDA events around one call of ``run``, its result)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def launches_now(all_kernels):
    return {n: k.launches for n, k in all_kernels.items()}


def zeroed(all_kernels):
    for k in all_kernels.values():
        k.launches = 0
    return {n: 0 for n in all_kernels}


def check_losses(tag, got, want, exact=None, zero=()):
    """Card losses against the CPU's f32 ones: 1e-3 relative; the losses in
    ``zero`` (0 in exact arithmetic, float noise on each side) 1e-6
    absolute."""
    rel = {k: abs(got[k] - w) / max(abs(w), 1e-30) for k, w in want.items()}
    print(f"[{tag}] losses card {got}, CPU {want}"
          + (f", CPU f64 {exact}" if exact else "") + f": relative differences {rel} (tol 1e-3"
          + (f"; {', '.join(zero)} 1e-6 absolute" if zero else "") + ")")
    check(all(np.isfinite(v) for v in got.values())
          and all(abs(got[k] - want[k]) <= 1e-6 if k in zero else r <= 1e-3
                  for k, r in rel.items()), f"[{tag}] card vs CPU losses differ: {rel}")


def check_grads(tag, nets, sides):
    """Each network's gradients (.grad, all tensors together) on the card
    against the CPU's f64 step: relative L2 within PARITY_GRAD_L2; the CPU's
    f32 step's is printed beside it."""
    card, cpu, f64 = sides
    for k in nets:
        e_card, w_card, l2_card = grad_errors(card.params[k], f64.params[k])
        _, _, l2_cpu = grad_errors(cpu.params[k], f64.params[k])
        print(f"[{tag}] {k} gradients against the f64 step: relative L2 card {l2_card:.3e} (tol "
              f"{PARITY_GRAD_L2}), CPU f32 {l2_cpu:.3e}; largest a tensor card {e_card:.3e} "
              f"({w_card})")
        check(l2_card <= PARITY_GRAD_L2, f"[{tag}] card {k} gradients differ from the f64 step: "
              f"relative L2 {l2_card}")


def stabletts_parity(mcfg, tcfg, tree, pair, seed, dev):
    """One accumulation cycle (4 micro-steps) of the B2 batch ``pair`` in f32
    on the card, in f32 and in f64 on the CPU, from the same tree, draws
    (the second row takes the CFG fakes) and batch: each micro-step's losses
    card vs CPU within 1e-3 relative, and the averaged, clipped gradient the
    cycle applied (.grad) within PARITY_GRAD_L2 of the f64 step's."""
    rng = np.random.default_rng(seed)
    t_f = pair["mel"].shape[1]
    noise = [{"cfg": torch.tensor([[0.5], [0.05]], dtype=torch.float32),
              "t": torch.tensor(rng.uniform(size=(2, 1, 1)).astype(np.float32)),
              "z": torch.tensor(rng.standard_normal((2, t_f, mcfg.n_feats)).astype(np.float32))}
             for _ in range(tcfg.accumulate)]
    sides, losses, t0 = [], [], time.perf_counter()
    for device, dtype in ((dev, None), (torch.device("cpu"), None),
                          (torch.device("cpu"), torch.float64)):
        state = stabletts_train.init_train_state(mcfg, tcfg, device=device, tree=tree)
        step = stabletts_train.make_train_step(mcfg, tcfg, compute_dtype=dtype)
        batch = to_device(pair, device)
        losses.append([{k: float(v) for k, v in step(state, batch, noise={
            k: v.to(device) for k, v in nz.items()}).items()} for nz in noise])
        sides.append(state)
    print(f"[train-stabletts-parity] one cycle of {tcfg.accumulate} micro-steps, B2 T_x "
          f"{pair['x'].shape[2]} T_f {t_f}, card f32 vs CPU f32 and f64 (the CPU's and the "
          f"card's {time.perf_counter() - t0:.1f} s)")
    for i in range(tcfg.accumulate):
        check_losses("train-stabletts-parity", losses[0][i], losses[1][i], losses[2][i])
    check_grads("train-stabletts-parity", ("g",), sides)


def train_stabletts_phase(kernels, smi, dev=torch.device("cuda")):
    """``[train-stabletts]``: run_stabletts at full width on a synthetic
    corpus (8 micro-steps, two accumulation cycles), STATE_8 restored into a
    fresh state, timed micro-steps and optimizer steps, profiles, card
    against CPU over one cycle at B2, the trained tree serving one request
    through kernel 3."""
    all_kernels = {**kernels, "mas": mas.KERNEL}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="stabletts-train-") as root:
        t0 = time.perf_counter()
        bert_dir = os.path.join(root, "bert")
        write_bert(bert_dir, bert.BertConfig())
        meta = write_stabletts_corpus(root)
        cfg = {"data": {"training_files": meta},
               "train": {"batch_size": 6, "epochs": 1000, "log_interval": 1,
                         "save_interval": 10 ** 6, "seed": TRAIN_SEED}}
        cfg_path = os.path.join(root, "config.json")
        with open(cfg_path, "w", encoding="utf-8") as f:
            json.dump(cfg, f)
        dcfg, mcfg, tcfg = run_stabletts.build_configs(cfg)
        full = dataclasses.replace(stabletts.StableTTSConfig(), mel_mean=dcfg.mel_mean,
                                   mel_std=dcfg.mel_std)
        check(mcfg == full and tcfg == stabletts_train.StableTrainConfig(),
              f"the training config is not the full-width default: {mcfg} {tcfg}")
        print(f"[train-stabletts] {STABLE_UTTERANCES} utterances of 2-8 s, their .lab durations "
              f"and a BertConfig() bundle written in {time.perf_counter() - t0:.1f} s; "
              f"StableTTSConfig() and StableTrainConfig() (accumulate {tcfg.accumulate}, clip "
              f"{tcfg.grad_clip}, lr {tcfg.learning_rate}), batch 6")
        model_dir = os.path.join(root, "model")

        expected = zeroed(all_kernels)
        t0 = time.perf_counter()
        args = ["-c", cfg_path, "-m", model_dir, "--bert-dir", bert_dir]
        state, metrics = run_stabletts.main(args + ["--max-steps", "8"])
        got = launches_now(all_kernels)
        check(state.step == 8 and metrics and all(np.isfinite(v) for v in metrics.values()),
              f"run_stabletts: step {state.step}, metrics {metrics}")
        print(f"[train-stabletts] run_stabletts --max-steps 8 in {time.perf_counter() - t0:.1f} s "
              f"(init, BERT rows, mels, 8 micro-steps = 2 updates, save): last {metrics}; "
              f"launches {got}")
        check(got == expected, f"[train-stabletts] hand-written kernels launched: {got}")
        fresh = stabletts_train.init_train_state(mcfg, tcfg, seed=TRAIN_SEED + 1, device=dev)
        resume_state(model_dir, fresh)
        check(same_state(state, fresh), "[train-stabletts] STATE_8 did not restore the step, the "
              "params, the AdamW state and the accumulated gradients")
        print("[train-stabletts] STATE_8 restored into a fresh state: step, params, AdamW state "
              "and accumulated gradients equal")
        del fresh

        bert_fn = run_stabletts.make_bert_fn(bert_dir, dev)
        ds = stabletts_data.StableTTSDataset(dcfg, bert_fn=bert_fn)
        batch_np = next(stabletts_data.StableBatcher(ds, 6).epoch(0))
        batch = to_device(batch_np, dev)
        b, _, t_x = batch_np["x"].shape
        t_f = batch_np["mel"].shape[1]
        audio_s = float(batch_np["mel_lengths"].sum()) * dcfg.hop_length / dcfg.sampling_rate
        step = stabletts_train.make_train_step(mcfg, tcfg)
        gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
        for _ in range(tcfg.accumulate):
            step(state, batch, generator=gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        expected = zeroed(all_kernels)
        micro, update = [], []
        for _ in range(2 * tcfg.accumulate):
            last = state.step % tcfg.accumulate == tcfg.accumulate - 1
            ms, out = event_ms(lambda: step(state, batch, generator=gen))
            (update if last else micro).append(ms)
            vals = {k: float(v) for k, v in out.items()}
            check(all(np.isfinite(v) for v in vals.values()), f"a loss is not finite: {vals}")
        got = launches_now(all_kernels)
        check(got == expected, f"[train-stabletts] a step launched a hand-written kernel: {got}")
        cycle = 3 * np.mean(micro) + np.mean(update)
        print(f"[train-stabletts] B{b} T_x {t_x} T_f {t_f} ({audio_s:.2f} s of mel): micro-step "
              f"{', '.join(f'{m:.3f}' for m in micro)} ms, optimizer step "
              f"{', '.join(f'{m:.3f}' for m in update)} ms (CUDA events); a cycle of "
              f"{tcfg.accumulate} {cycle:.3f} ms: {1e3 * tcfg.accumulate / cycle:.3f} "
              f"micro-steps/s, {audio_s * 1e3 / np.mean(micro + update):.2f} mel audio s per s; "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {got}; "
              f"{smi}; last losses {vals}")
        profile_step("train-stabletts micro-step", lambda: step(state, batch, generator=gen), smi)
        for _ in range(tcfg.accumulate - 2):
            step(state, batch, generator=gen)
        profile_step("train-stabletts optimizer step", lambda: step(state, batch, generator=gen),
                     smi)

        tree = state.params["g"].numpy_tree()
        pair = {k: v[:2] for k, v in batch_np.items()}
        nx, nf = int(pair["x_lengths"].max()), int(pair["mel_lengths"].max())
        pair = {**pair, "x": pair["x"][:, :, :nx], "bert": pair["bert"][:, :nx],
                "durations": pair["durations"][:, :nx], "mel": pair["mel"][:, :nf]}
        stabletts_parity(mcfg, tcfg, tree, pair, TRAIN_SEED + 2, dev)
        del tree

        # the trained tree (the serving layout) synthesises one request through kernel 3
        x, rows = ds.text_streams(0)
        inputs = (torch.tensor(x.T[None], device=dev), torch.tensor([x.shape[0]], device=dev),
                  torch.tensor([1], device=dev), torch.tensor(rows[None], device=dev))
        expected = zeroed(all_kernels) | {"global_attention_rope": 2 * mcfg.n_layers
                                          + 10 * mcfg.dec_layers}
        with torch.no_grad():
            out = stabletts.synthesise(state.params["g"].params, mcfg, *inputs, max_frames=1024,
                                       n_timesteps=10, generator=gen)
        torch.cuda.synchronize()
        got = launches_now(all_kernels)
        mel = out["mel"]
        check(mel.shape == (1, 1024, mcfg.n_feats) and bool(torch.isfinite(mel).all())
              and got == expected, f"[train-stabletts] serving the trained tree: {mel.shape}, "
              f"launches {got} (expected {expected})")
        print(f"[train-stabletts] the trained tree served one request through "
              f"stabletts.synthesise: {int(out['mel_lengths'][0])} frames, launches {got}")
        del state
    print(f"[train-stabletts] phase wall {time.perf_counter() - t_phase:.1f} s")


def write_vc_corpus(root, dev, n=VC_UTTERANCES):
    """n utterances of 3-6 s at 16 kHz (write_voice), each with its ``.cv.npy``
    sidecar: the last hidden state of a full-width HubertConfig() model
    (random weights from the seed) on the card; the file list ``train.txt``."""
    hcfg = hubert.HubertConfig()
    hub = hubert.Hubert(hcfg, to_port_layout(hubert_init(hcfg, seed=SEED + 4))).to(dev)
    rng = np.random.default_rng(TRAIN_SEED + 20)
    paths = []
    for i in range(n):
        path = os.path.join(root, f"v{i:03d}.wav")
        write_voice(path, rng, int(rng.uniform(3.0, 6.0) * 16000), 16000)
        wav, _ = load_wav(path)
        with torch.inference_mode():
            c = hub(torch.tensor(wav[None] / 32768.0, device=dev))[0]
        np.save(path[:-4] + ".cv.npy", c.float().cpu().numpy())
        paths.append(path)
    with open(os.path.join(root, "train.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(paths) + "\n")
    del hub
    torch.cuda.empty_cache()
    return os.path.join(root, "train.txt")


def vc_parity(mcfg, tcfg, trees, pair, seed, dev):
    """One step of the B2 batch ``pair`` in f32 on the card, in f32 and in
    f64 on the CPU, from the same trees, draws and batch, the D learning
    rate 0 on every side (as ``[train-parity]``): losses card vs CPU within
    1e-3 relative; G and D gradients within PARITY_GRAD_L2 of the f64 step's."""
    rng = np.random.default_rng(seed)
    t = pair["c"].shape[1]
    noise = {k: torch.tensor(rng.standard_normal((2, t, mcfg.inter_channels)).astype(np.float32))
             for k in ("posterior_p", "posterior_q")}
    noise["ids_slice"] = torch.tensor((rng.uniform(size=2) * max(t - mcfg.segment_size + 1, 1)
                                       ).astype(np.int32))
    sides, losses, t0 = [], [], time.perf_counter()
    for device, dtype in ((dev, None), (torch.device("cpu"), None),
                          (torch.device("cpu"), torch.float64)):
        state = vc_train.init_train_state(mcfg, tcfg, device=device, trees=trees)
        for group in state.opt["d"].param_groups:
            group["lr"] = 0.0
        step = vc_train.make_train_step(mcfg, tcfg, compute_dtype=dtype)
        losses.append({k: float(v) for k, v in step(state, to_device(pair, device), noise={
            k: v.to(device) for k, v in noise.items()}).items()})
        sides.append(state)
    print(f"[train-vc-parity] one step, B2 T {t}, card f32 vs CPU f32 and f64 (the CPU's and the "
          f"card's {time.perf_counter() - t0:.1f} s; D lr 0)")
    check_losses("train-vc-parity", *losses)
    check_grads("train-vc-parity", ("g", "d"), sides)


def train_vc_phase(kernels, smi, dev=torch.device("cuda")):
    """``[train-vc]``: run_vc at full width on a synthetic 16 kHz corpus with
    ContentVec sidecars (3 steps, then STATE_3 restored into a fresh state),
    timed steps, a profile, card against CPU at B2."""
    all_kernels = {**kernels, "mas": mas.KERNEL}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="vc-train-") as root:
        t0 = time.perf_counter()
        file_list = write_vc_corpus(root, dev)
        cfg = {"data": {"training_files": file_list, "max_speclen": 512},
               "train": {"batch_size": 64, "epochs": 1000, "log_interval": 1,
                         "eval_interval": 10 ** 6, "seed": TRAIN_SEED}}
        cfg_path = os.path.join(root, "config.json")
        with open(cfg_path, "w", encoding="utf-8") as f:
            json.dump(cfg, f)
        dcfg, mcfg, tcfg = run_vc.build_configs(cfg)
        check(mcfg == quickvc.QuickVCConfig() and tcfg == vc_train.VCTrainConfig(),
              f"the training config is not the full-width default: {mcfg} {tcfg}")
        print(f"[train-vc] {VC_UTTERANCES} utterances of 3-6 s and their HubertConfig() "
              f".cv.npy written in {time.perf_counter() - t0:.1f} s; QuickVCConfig() "
              f"({mcfg.spec_channels} spectral channels, {mcfg.decoder_type}) and VCTrainConfig(), "
              f"batch 64, max_speclen {dcfg.max_speclen}")
        model_dir = os.path.join(root, "model")

        expected = zeroed(all_kernels)
        t0 = time.perf_counter()
        state, metrics = run_vc.main(["-c", cfg_path, "-m", model_dir, "--max-steps", "3"])
        got = launches_now(all_kernels)
        check(state.step == 3 and metrics and all(np.isfinite(v) for v in metrics.values()),
              f"run_vc: step {state.step}, metrics {metrics}")
        print(f"[train-vc] run_vc --max-steps 3 in {time.perf_counter() - t0:.1f} s (init, "
              f"spectrograms, 3 steps, save): last {metrics}; launches {got}")
        check(got == expected, f"[train-vc] hand-written kernels launched: {got}")
        fresh = vc_train.init_train_state(mcfg, tcfg, seed=TRAIN_SEED + 1, device=dev)
        resume_state(model_dir, fresh)
        check(same_state(state, fresh), "[train-vc] STATE_3 did not restore the step, the params "
              "and the AdamW state")
        print("[train-vc] STATE_3 restored into a fresh state: step, params and AdamW state equal")
        del fresh

        batch_np = next(ShuffleBatcher(vc_data.VCDataset(dcfg), 64).epoch(0))
        batch = to_device(batch_np, dev)
        b, t = batch_np["c"].shape[:2]
        seg_s = b * mcfg.segment_size * tcfg.hop_length / tcfg.sampling_rate
        step = vc_train.make_train_step(mcfg, tcfg)
        gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
        step(state, batch, generator=gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        expected = zeroed(all_kernels)
        times = []
        for _ in range(3):
            ms, out = event_ms(lambda: step(state, batch, generator=gen))
            times.append(ms)
            vals = {k: float(v) for k, v in out.items()}
            check(all(np.isfinite(v) for v in vals.values()), f"a loss is not finite: {vals}")
        got = launches_now(all_kernels)
        check(got == expected, f"[train-vc] a step launched a hand-written kernel: {got}")
        ms = float(np.mean(times))
        print(f"[train-vc] B{b} T {t} (segments of {mcfg.segment_size} frames): a step "
              f"{', '.join(f'{m:.3f}' for m in times)} ms (CUDA events), mean {ms:.3f}: "
              f"{1e3 / ms:.3f} steps/s, {seg_s * 1e3 / ms:.2f} segment audio s per s; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {got}; {smi}; "
              f"last losses {vals}")
        profile_step("train-vc step", lambda: step(state, batch, generator=gen), smi)

        trees = {k: m.numpy_tree() for k, m in state.params.items()}
        vc_parity(mcfg, tcfg, trees, {k: v[:2] for k, v in batch_np.items()}, TRAIN_SEED + 3, dev)
        del trees, state
    print(f"[train-vc] phase wall {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# 12-13. GPT-SoVITS training at full width: S1 (the AR), S2 (SoVITS)
# ---------------------------------------------------------------------------

S1_UTTERANCES = 48
S2_UTTERANCES = 36


def same_tensors(a, b):
    """Two nested dicts/lists of tensors and plain values (state dicts) equal,
    tensors exactly."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_tensors(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tensors(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a.cpu(), b.cpu())
    return a == b


def gpt_text(i):
    """(TEXTS[i % 16] as the G2P has it, its aligned phones, the phone ids)."""
    text = TEXTS[i % len(TEXTS)].replace(" —", ",")
    aligned = aligned_text(text)
    return text, aligned, text_to_ids_aligned(aligned, plain_symbol_map())


def write_s1_corpus(root, bert_dim):
    """S1_UTTERANCES rows: TEXTS' aligned phones with 2-8 s of random 25 Hz codes, the
    phone rate drawn in [6, 15]/s (the length clipped to 2-8 s keeps it in
    the filters' [3, 25]), ``.bert.npy`` rows for every other one; the
    metadata ``meta.csv`` and ``semantic.tsv``."""
    rng = np.random.default_rng(TRAIN_SEED + 30)
    meta, sem = [], []
    for i in range(S1_UTTERANCES):
        text, aligned, ids = gpt_text(i)
        n_codes = int(25 * np.clip(len(ids) / rng.uniform(6.0, 15.0), 2.0, 8.0))
        meta.append(f"u{i:02d}.wav|0|{text}|{aligned}")
        sem.append(f"u{i:02d}\t" + " ".join(str(c) for c in rng.integers(0, 1024, n_codes)))
        if i % 2 == 0:
            np.save(os.path.join(root, f"u{i:02d}.bert.npy"),
                    rng.standard_normal((len(ids), bert_dim)).astype(np.float32))
    for name, lines in (("meta.csv", meta), ("semantic.tsv", sem)):
        with open(os.path.join(root, name), "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")


def write_s2_corpus(root):
    """S2_UTTERANCES utterances of 2-8 s at 32 kHz (write_voice), each with ``.ssl.npy``
    features at 50 Hz (seeded N(0, 1), 768 wide: no SSL model runs) and
    TEXTS' aligned phones; the metadata ``meta.csv``."""
    rng = np.random.default_rng(TRAIN_SEED + 31)
    lines = []
    for i in range(S2_UTTERANCES):
        path = os.path.join(root, f"v{i:02d}.wav")
        n_samples = int(rng.uniform(2.0, 8.0) * 32000)
        write_voice(path, rng, n_samples, 32000)
        np.save(path[:-4] + ".ssl.npy",
                rng.standard_normal((n_samples // 640, 768)).astype(np.float32))
        text, aligned, _ = gpt_text(i)
        lines.append(f"{path}|0|{text}|{aligned}")
    with open(os.path.join(root, "meta.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return os.path.join(root, "meta.csv")


def timed_steps(tag, step, state, batch, gen, n, smi, all_kernels, tokens=None, seg_s=None,
                per_step=None, profile=True):
    """One warm-up step, then n steps between CUDA events: ms, steps/s, tokens
    or segment audio s per s, peak memory, launches (none of the hand-written
    kernels, but ``per_step``'s counts a step); then, with ``profile``, one
    step profiled. Returns the mean ms."""
    step(state, batch, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    expected = zeroed(all_kernels) | {k: c * n for k, c in (per_step or {}).items()}
    times = []
    for _ in range(n):
        ms, out = event_ms(lambda: step(state, batch, generator=gen))
        times.append(ms)
        vals = {k: float(v) for k, v in out.items()}
        check(all(np.isfinite(v) for v in vals.values()), f"[{tag}] a loss is not finite: {vals}")
    got = launches_now(all_kernels)
    check(got == expected, f"[{tag}] {n} steps launched {got}, expected {expected}")
    ms = float(np.mean(times))
    rate = (f"{tokens * 1e3 / ms:.1f} semantic tokens/s ({tokens} a step)" if tokens is not None
            else f"{seg_s * 1e3 / ms:.2f} segment audio s per s")
    print(f"[{tag}] a step {', '.join(f'{m:.3f}' for m in times)} ms (CUDA events), mean "
          f"{ms:.3f}: {1e3 / ms:.3f} steps/s, {rate}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches over {n} steps {got}; "
          f"{smi}; last {vals}")
    if profile:
        profile_step(f"{tag} step", lambda: step(state, batch, generator=gen), smi)
    return ms


def parity_sides(make_state, make_step, pair, noise, dev, d_lr0=False):
    """One step of ``pair`` in f32 on the card, in f32 and in f64 on the CPU,
    each from ``make_state(device)``: (the three states, their metrics as
    floats)."""
    sides, losses = [], []
    for device, dtype in ((dev, None), (torch.device("cpu"), None),
                          (torch.device("cpu"), torch.float64)):
        state = make_state(device)
        if d_lr0:
            for group in state.opt["d"].param_groups:
                group["lr"] = 0.0
        out = make_step(dtype)(state, to_device(pair, device),
                               noise={k: v.to(device) for k, v in noise.items()})
        losses.append({k: float(v) for k, v in out.items()})
        sides.append(state)
    return sides, losses


def s1_parity(mcfg, tree, pair, seed, dev):
    """``[train-s1-parity]``: one ScaledAdam step and one DPO step (spans
    pinned) of the B2 pair on the card, in f32 and in f64 on the CPU, from
    the same tree: the loss card vs CPU f32 within 1e-3 relative (the
    accuracy printed: one flipped argmax moves it by 1 / (B Ty)), the
    applied gradient within PARITY_GRAD_L2 of the f64 step's."""
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    for dpo in (False, True):
        tag = "train-s1-parity" + (" dpo" if dpo else "")
        tcfg = gpt_sovits_train.S1TrainConfig(if_dpo=dpo)
        noise = {"reject_ids": torch.tensor(rng.integers(0, pair["y"].shape[1], (2, 2)))}
        sides, losses = parity_sides(
            lambda d: gpt_sovits_train.init_s1_state(mcfg, tcfg, device=d, tree=tree),
            lambda dt: gpt_sovits_train.make_s1_step(mcfg, tcfg, compute_dtype=dt), pair, noise,
            dev)
        print(f"[{tag}] one step, B2 T_x {pair['x'].shape[1]} T_y {pair['y'].shape[1]}, card f32 "
              f"vs CPU f32 and f64 (all three sides so far {time.perf_counter() - t0:.1f} s); "
              f"accuracy card {losses[0]['acc']}, CPU {losses[1]['acc']}")
        check_losses(tag, *({"loss": m["loss"]} for m in losses))
        check_grads(tag, ("ar",), sides)


def train_s1_phase(kernels, smi, dev=torch.device("cuda")):
    """``[train-s1]``: run_gpt_sovits --stage s1 at full width (ARConfig(),
    S1TrainConfig(): ScaledAdam) on a synthetic corpus, 3 steps, STATE_3
    restored into a fresh state, timed steps at batch 8, one DPO step at
    the halved batch, the card against the CPU at B2."""
    all_kernels = {**kernels, "mas": mas.KERNEL}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="s1-train-") as root:
        mcfg = gpt_sovits.ARConfig()
        write_s1_corpus(root, mcfg.bert_dim)
        cfg = {"data": {"metadata": os.path.join(root, "meta.csv"),
                        "semantic": os.path.join(root, "semantic.tsv"), "wav_dir": root},
               "train": {"batch_size": 8, "epochs": 1000, "log_interval": 1,
                         "save_interval": 10 ** 6, "seed": TRAIN_SEED}}
        cfg_path = os.path.join(root, "config.json")
        with open(cfg_path, "w", encoding="utf-8") as f:
            json.dump(cfg, f)
        dcfg, mcfg, tcfg = run_gpt_sovits.build_s1(cfg)
        check(mcfg == gpt_sovits.ARConfig() and tcfg == gpt_sovits_train.S1TrainConfig(),
              f"the training config is not the full-width default: {mcfg} {tcfg}")
        ds = gpt_sovits_data.S1Dataset(dcfg)
        check(len(ds) == S1_UTTERANCES, f"[train-s1] the filters dropped rows: {len(ds)}")
        model_dir = os.path.join(root, "model")

        expected = zeroed(all_kernels)
        t0 = time.perf_counter()
        args = ["--stage", "s1", "-c", cfg_path, "-m", model_dir]
        state, metrics = run_gpt_sovits.main(args + ["--max-steps", "3"])
        got = launches_now(all_kernels)
        check(state.step == 3 and metrics and all(np.isfinite(v) for v in metrics.values())
              and state.params["ar"].device.type == "cuda",
              f"run_gpt_sovits s1: step {state.step}, metrics {metrics}")
        check(got == expected, f"[train-s1] hand-written kernels launched: {got}")
        print(f"[train-s1] {S1_UTTERANCES} rows of 2-8 s of codes ({len(ds)} kept by the "
              f"filters, BERT rows for half); ARConfig() ({mcfg.num_layers} x "
              f"{mcfg.hidden_dim}) and S1TrainConfig() ({tcfg.optimizer}), batch 8: "
              f"run_gpt_sovits --stage s1 --max-steps 3 in {time.perf_counter() - t0:.1f} s: "
              f"last {metrics}; launches {got}")
        fresh = gpt_sovits_train.init_s1_state(mcfg, tcfg, seed=TRAIN_SEED + 1, device=dev)
        resume_state(model_dir, fresh)
        check(same_tensors(state.state_dict(), fresh.state_dict()),
              "[train-s1] STATE_3 did not restore the step, the params and the ScaledAdam state")
        print("[train-s1] STATE_3 restored into a fresh state: step, params and ScaledAdam state "
              "(per-parameter and global) equal")
        del fresh

        batch_np = next(ShuffleBatcher(ds, 8).epoch(0))
        b, t_x = batch_np["x"].shape
        t_y = batch_np["y"].shape[1]
        gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
        print(f"[train-s1] B{b} T_x {t_x} T_y {t_y} (joint T {t_x + t_y})")
        timed_steps("train-s1", gpt_sovits_train.make_s1_step(mcfg, tcfg), state,
                    to_device(batch_np, dev), gen, 3, smi, all_kernels,
                    tokens=int(batch_np["y_lengths"].sum()))
        half = {k: v[:b // 2] for k, v in batch_np.items()}
        dpo = gpt_sovits_train.make_s1_step(mcfg, dataclasses.replace(tcfg, if_dpo=True))
        torch.cuda.reset_peak_memory_stats()
        dpo(state, to_device(half, dev), generator=gen)
        ms, out = event_ms(lambda: dpo(state, to_device(half, dev), generator=gen))
        vals = {k: float(v) for k, v in out.items()}
        check(all(np.isfinite(v) for v in vals.values()), f"[train-s1] DPO loss: {vals}")
        print(f"[train-s1] one DPO step at the halved batch B{b // 2} (the rejection's pass on "
              f"2 T_y = {2 * t_y}): {ms:.3f} ms (CUDA events, after one warm-up); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}; {vals}")

        tree = state.params["ar"].numpy_tree()
        del state
        torch.cuda.empty_cache()
        pair = {k: v[:2] for k, v in batch_np.items()}
        nx, ny = int(pair["x_lengths"].max()), int(pair["y_lengths"].max())
        pair = {**pair, "x": pair["x"][:, :nx], "bert": pair["bert"][:, :nx],
                "y": pair["y"][:, :ny]}
        s1_parity(mcfg, tree, pair, TRAIN_SEED + 32, dev)
    print(f"[train-s1] phase wall {time.perf_counter() - t_phase:.1f} s")


def s2_parity(mcfg, tcfg, trees, pair, seed, dev):
    """``[train-s2-parity]``: one S2 step of the B2 pair from ``trees`` and
    fresh EMA buffers (so k-means runs) on the card, in f32 and in f64 on the CPU,
    from the same trees and draws (the k-means initial rows, the posterior
    normal, the slice starts), D's learning rate 0: losses card vs CPU f32
    within 1e-3 relative, G and D gradients within PARITY_GRAD_L2 of the
    f64 step's, the EMA buffers card vs CPU f32 within 1e-5 relative,
    summed over each group of codes that k-means starts equal; a loss that
    the f64 step puts below 1e-9 (the commitment loss where every k-means
    row drew a code of its own: 0 in exact arithmetic), 1e-6 absolute.

    A B2 pair has fewer rows than the codebook has codes (and its padded
    frames are equal rows), so k-means starts codes at equal values: the
    argmin between equal codes falls by rounding, which differs between the
    card and the CPU, so which of them takes a row, or how equal rows split
    among them, is arbitrary. A group's sums do not depend on it (every
    code of a group keeps the group's value); each code's own difference is
    printed. The grouped check must fail two faults planted in the card's
    EMA step: a decay off by 0.01, and one row's count and features moved
    to a code of another group."""
    rng = np.random.default_rng(seed)
    t_f = pair["spec"].shape[1]
    n = min(2 * (t_f // 2), 500)  # the rows k-means samples from
    noise = {"kmeans_ids": torch.tensor(rng.permutation(n)[:mcfg.n_codes] if n >= mcfg.n_codes
                                        else rng.integers(0, n, mcfg.n_codes)),
             "posterior": torch.tensor(rng.standard_normal((2, t_f, mcfg.inter_channels))
                                       .astype(np.float32)),
             "ids_slice": torch.tensor((rng.uniform(size=2) * np.maximum(
                 pair["spec_lengths"] - mcfg.segment_size + 1, 1)).astype(np.int32))}
    real, real_ema, initial, ema_args = rvq.kmeans_init, rvq.ema_step, [], []

    def kmeans_init(state, x, **kw):  # each side's initial means, kept on the host
        initial.append(x[:kw.get("max_samples", 500)][kw["ids"].to(x.device).long()].cpu())
        return real(state, x, **kw)

    def ema_step(state, x, **kw):  # each side's inputs, for the planted faults below
        ema_args.append((state, x, kw))
        return real_ema(state, x, **kw)

    t0 = time.perf_counter()
    rvq.kmeans_init, rvq.ema_step = kmeans_init, ema_step
    try:
        sides, losses = parity_sides(
            lambda d: gpt_sovits_train.init_s2_state(mcfg, tcfg, device=d, trees=trees),
            lambda dt: gpt_sovits_train.make_s2_step(mcfg, tcfg, compute_dtype=dt), pair, noise,
            dev, d_lr0=True)
    finally:
        rvq.kmeans_init, rvq.ema_step = real, real_ema
    print(f"[train-s2-parity] one step, B2 T_f {t_f}, card f32 vs CPU f32 and f64 (the three "
          f"{time.perf_counter() - t0:.1f} s; D lr 0; k-means from fresh buffers)")
    # with fewer k-means rows than codes every row can draw a code of its own,
    # and the first step's commitment loss is then 0 in exact arithmetic
    check_losses("train-s2-parity", *losses,
                 zero=tuple(k for k, v in losses[2].items() if abs(v) < 1e-9))
    check_grads("train-s2-parity", ("g", "d"), sides)
    each = {k: float((sides[0].vq[k].cpu() - v).abs().max()) / max(float(v.abs().max()), 1e-30)
            for k, v in sides[1].vq.items()}
    group = equal_codes(initial[0], initial[1])
    rel = grouped_rel(sides[0].vq, sides[1].vq, group)
    # where the card's run may differ: the trained trees, each side's initial
    # means (digests), and how many distinct rows each side's means hold
    print(f"[train-s2-parity] digests: trees {digest(trees['g'])}, initial means "
          f"card {digest(initial[0])} CPU {digest(initial[1])}; distinct initial means card "
          f"{len(torch.unique(initial[0], dim=0))} CPU {len(torch.unique(initial[1], dim=0))}")
    print(f"[train-s2-parity] EMA buffers card vs CPU f32, summed over each group of codes that "
          f"start equal ({int(group.max()) + 1} groups, {mcfg.n_codes} codes): relative {rel} "
          f"(tol 1e-5); code by code {each}")
    check(all(r <= 1e-5 for r in rel.values()), f"[train-s2-parity] EMA buffers differ: {rel}")

    # the grouped check must see a fault in the card's EMA step: a decay off
    # by 0.01; one row's count and features moved to a code of another group
    state, x, kw = ema_args[0]
    x0 = x[0].detach()
    c = int(rvq.quantize(state["embed"], x0[None])[0])
    c2 = int(torch.nonzero(group != group[c])[0, 0])
    w = 1 - kw["decay"]
    moved = {k: v.clone() for k, v in sides[0].vq.items()}
    moved["cluster_size"][c] -= w
    moved["cluster_size"][c2] += w
    moved["embed_avg"][c] -= w * x0
    moved["embed_avg"][c2] += w * x0
    planted = {"decay": grouped_rel(real_ema(state, x, **{**kw, "decay": kw["decay"] - 0.01}),
                                    sides[1].vq, group),
               "moved row": grouped_rel(moved, sides[1].vq, group)}
    print(f"[train-s2-parity] planted faults in the card's EMA step, grouped: {planted} (each must "
          f"exceed 1e-5)")
    check(all(max(r.values()) > 1e-5 for r in planted.values()),
          f"[train-s2-parity] the grouped EMA check misses a planted fault: {planted}")


def digest(*trees):
    """The first 12 hex digits of a SHA-1 over the bytes of the trees' leaves
    (numpy arrays or CPU tensors)."""
    h = hashlib.sha1()
    for a in tree_leaves(list(trees)):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:12]


def grouped_rel(got, want, group):
    """``cluster_size`` and ``embed_avg`` of two EMA states, each summed
    over the codes of a ``group`` label (K,): the largest difference
    relative to ``want``'s largest group sum."""
    n_groups = int(group.max()) + 1

    def by_group(v):
        v = v.detach().cpu().double()
        return torch.zeros((n_groups,) + v.shape[1:], dtype=v.dtype).index_add_(0, group, v)

    return {k: float((by_group(got[k]) - by_group(want[k])).abs().max())
            / max(float(by_group(want[k]).abs().max()), 1e-30)
            for k in ("cluster_size", "embed_avg")}


def equal_codes(*initial):
    """Group labels (K,) of codes whose initial means (K, D) are equal on
    any side: the components of "equal on the card or on the CPU"."""
    labels = torch.arange(initial[0].shape[0])
    while True:
        old = labels.clone()
        for means in initial:
            inverse = torch.unique(means, dim=0, return_inverse=True)[1]
            low = torch.full((int(inverse.max()) + 1,), labels.numel()).scatter_reduce(
                0, inverse, labels, "amin")
            labels = torch.minimum(labels, low[inverse])
        if torch.equal(labels, old):
            return torch.unique(labels, return_inverse=True)[1]


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms (cuDNN's too) inside the block: the
    card's S2 step otherwise sums weight and embedding gradients in an
    order that varies from run to run, so the trees the parity starts from
    differed in every run. An op with no deterministic form warns
    (``warn_only``: reflection padding's backward); cuBLAS on one stream is
    deterministic, which is what its workspace setting asks for."""
    old = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
           os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old[0])
        torch.backends.cudnn.deterministic = old[1]
        if old[2] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")


def train_s2_phase(kernels, smi, dev=torch.device("cuda")):
    """``[train-s2]``: run_gpt_sovits --stage s2 at full width (SoVITSConfig(),
    S2TrainConfig(): 32 kHz, hop 640, 32-frame segments) on a synthetic
    corpus, one step (k-means) then a resumed run to step 3, STATE_3 restored
    into a fresh state, timed steps at batch 8, the card against the CPU at
    B2, then the trained tree's ``sovits_decode`` on the card (12 launches
    of kernel 1) against the CPU. Returns (kernel 1's launches over that
    decode, its case at the decode's SSL-encoder shape)."""
    all_kernels = {**kernels, "mas": mas.KERNEL}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="s2-train-") as root:
        t0 = time.perf_counter()
        meta = write_s2_corpus(root)
        cfg = {"data": {"metadata": meta},
               "train": {"batch_size": 8, "epochs": 1000, "log_interval": 1,
                         "save_interval": 10 ** 6, "seed": TRAIN_SEED}}
        cfg_path = os.path.join(root, "config.json")
        with open(cfg_path, "w", encoding="utf-8") as f:
            json.dump(cfg, f)
        dcfg, mcfg, tcfg = run_gpt_sovits.build_s2(cfg)
        check(mcfg == gpt_sovits.SoVITSConfig() and tcfg == dataclasses.replace(
            gpt_sovits_train.S2TrainConfig(), n_mel_channels=128),
            f"the training config is not the full-width default: {mcfg} {tcfg}")
        print(f"[train-s2] {S2_UTTERANCES} utterances of 2-8 s at 32 kHz with 768-wide .ssl.npy "
              f"written in {time.perf_counter() - t0:.1f} s; SoVITSConfig() and S2TrainConfig() "
              f"(hop {tcfg.hop_length}, segment {mcfg.segment_size} frames = "
              f"{mcfg.segment_size * tcfg.hop_length} samples, {tcfg.n_mel_channels} mels), "
              f"batch 8")
        model_dir = os.path.join(root, "model")

        expected = zeroed(all_kernels)
        t0 = time.perf_counter()
        args = ["--stage", "s2", "-c", cfg_path, "-m", model_dir]
        # run_gpt_sovits's steps in deterministic algorithms, so the trees that
        # [train-s2-parity] starts from are the same in every run
        with deterministic():
            first, m1 = run_gpt_sovits.main(args + ["--max-steps", "1"])
        check(first.step == 1 and first.vq_inited and bool(first.vq["inited"] > 0),
              f"[train-s2] after one step: step {first.step}, inited {first.vq['inited']}")
        print(f"[train-s2] run_gpt_sovits --stage s2 --max-steps 1 in "
              f"{time.perf_counter() - t0:.1f} s (init, spectrograms, k-means, 1 step, save): "
              f"vq inited {float(first.vq['inited'])}, cluster-size sum "
              f"{float(first.vq['cluster_size'].sum()):.4f}; {m1}")
        del first
        t0 = time.perf_counter()
        with deterministic():
            state, metrics = run_gpt_sovits.main(args + ["--max-steps", "3"])
        got = launches_now(all_kernels)
        check(state.step == 3 and metrics and all(np.isfinite(v) for v in metrics.values())
              and state.params["g"].device.type == "cuda",
              f"run_gpt_sovits s2: step {state.step}, metrics {metrics}")
        check(got == expected, f"[train-s2] hand-written kernels launched: {got}")
        print(f"[train-s2] resumed from STATE_1 to step 3 in {time.perf_counter() - t0:.1f} s: "
              f"last {metrics}; launches over both runs {got}")
        fresh = gpt_sovits_train.init_s2_state(mcfg, tcfg, seed=TRAIN_SEED + 1, device=dev)
        resume_state(model_dir, fresh)
        check(same_tensors(state.state_dict(), fresh.state_dict()) and fresh.vq_inited,
              "[train-s2] STATE_3 did not restore the step, the params, the AdamW states and "
              "the EMA buffers")
        print("[train-s2] STATE_3 restored into a fresh state: step, params, AdamW states and "
              "EMA buffers equal")
        del fresh
        trees = {k: m.numpy_tree() for k, m in state.params.items()}  # STATE_3's, for the parity

        ds = gpt_sovits_data.S2Dataset(dcfg)
        batch_np = next(ShuffleBatcher(ds, 8).epoch(0))
        b, t_f = batch_np["spec"].shape[:2]
        gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
        print(f"[train-s2] B{b} T_f {t_f} T_text {batch_np['text'].shape[1]}")
        timed_steps("train-s2", gpt_sovits_train.make_s2_step(mcfg, tcfg), state,
                    to_device(batch_np, dev), gen, 3, smi, all_kernels,
                    seg_s=b * mcfg.segment_size * tcfg.hop_length / tcfg.sampling_rate)

        # the trained tree (the bundle layout, its codebook the EMA's) decodes
        # one utterance on the card through kernel 1, and on the CPU
        tree = to_port_layout(state.bundle_tree())
        del state
        torch.cuda.empty_cache()
        i = int(np.argmin(batch_np["spec_lengths"]))
        n_f = int(batch_np["spec_lengths"][i])
        n_t = int(batch_np["text_lengths"][i])
        rng = np.random.default_rng(TRAIN_SEED + 33)
        runs = []
        for d in (dev, torch.device("cpu")):
            sp = to_torch(tree, d)
            with torch.inference_mode():
                codes = gpt_sovits.sovits_extract_latent(
                    sp, mcfg, torch.as_tensor(batch_np["ssl"][i:i + 1, :n_f], device=d))
                if not runs:
                    noise = torch.tensor(rng.standard_normal(
                        (1, 2 * codes.shape[1], mcfg.inter_channels)).astype(np.float32))
                    expected = zeroed(all_kernels) | {"banded_attention": 12}
                # both decode the card's codes (a near-tie may pick another code)
                wav = gpt_sovits.sovits_decode(
                    sp, mcfg, runs[0][0].to(d) if runs else codes,
                    torch.as_tensor(batch_np["text"][i:i + 1, :n_t], device=d),
                    torch.tensor([n_t], device=d),
                    torch.as_tensor(batch_np["spec"][i:i + 1, :n_f], device=d),
                    torch.tensor([n_f], device=d), noise=noise.to(d))
                if not runs:
                    torch.cuda.synchronize()
                    got = launches_now(all_kernels)
            runs.append((codes.cpu(), wav.cpu()))
        (codes_g, wav_g), (codes_c, wav_c) = runs
        err, peak = float((wav_g - wav_c).abs().max()), float(wav_c.abs().max())
        print(f"[train-s2] the trained tree's sovits_decode, {codes_g.shape[1]} codes, text "
              f"{n_t}, reference {n_f} frames: launches {got} (expected {expected}); codes card "
              f"vs CPU differ at {int((codes_g != codes_c).sum())}; waveform {err:.3e} (peak "
              f"{peak:.4f}, tol {1e-3 * peak:.3e})")
        check(got == expected, f"[train-s2] sovits_decode launched {got}, expected {expected}")
        check(peak > 0 and bool(torch.isfinite(wav_g).all()) and err <= 1e-3 * peak,
              f"[train-s2] the trained tree's waveform differs by {err}")
        t_ssl = 2 * codes_g.shape[1]
        case = attention_case(1, t_ssl, [t_ssl], 50, 20, 34)

        j = np.argsort(batch_np["spec_lengths"])[:2]
        pair = {k: v[j] for k, v in batch_np.items()}
        nf, nt = int(pair["spec_lengths"].max()), int(pair["text_lengths"].max())
        nf += nf % 2
        pair = {**pair, "ssl": pair["ssl"][:, :nf], "spec": pair["spec"][:, :nf],
                "text": pair["text"][:, :nt], "wav": pair["wav"][:, :nf * tcfg.hop_length]}
        with deterministic():
            s2_parity(mcfg, tcfg, trees, pair, TRAIN_SEED + 34, dev)
    print(f"[train-s2] phase wall {time.perf_counter() - t_phase:.1f} s")
    return got["banded_attention"], case


# ---------------------------------------------------------------------------
# 16-18. evaluation, Whisper content features and the GE2E speaker encoder
# ---------------------------------------------------------------------------


def wav_ok(path):
    """A WAV that opens with ``wave``: 22050 Hz mono int16, not all zeros."""
    with wave.open(str(path)) as f:
        ok = f.getframerate() == 22050 and f.getsampwidth() == 2 and f.getnchannels() == 1
        data = np.frombuffer(f.readframes(f.getnframes()), np.int16)
    return ok and len(data) > 0 and bool(np.any(data != 0))


def held_out(embedder):
    """tests/test_speaker_embedder.py's held-out voices (rng 999): the
    (same-voice, cross-voice) mean similarities under ``embedder``."""
    rng = np.random.default_rng(999)
    va, vb, vc = (speaker_train.synthetic_voice(rng) for _ in range(3))
    a = [speaker_train.synthetic_utterance(rng, va) for _ in range(3)]
    b = [speaker_train.synthetic_utterance(rng, vb) for _ in range(3)]
    c = [speaker_train.synthetic_utterance(rng, vc) for _ in range(2)]
    same = harness.speaker_similarity([(a[0], a[1]), (a[1], a[2]), (b[0], b[1]), (c[0], c[1])],
                                      embedder=embedder)
    cross = harness.speaker_similarity([(a[0], b[0]), (a[1], b[1]), (b[2], c[0]), (a[2], c[1])],
                                       embedder=embedder)
    return same.value, cross.value


def module_json(args, timeout=600):
    """``python -m <args>`` from the checkout's root (it runs on the card by
    default); returns its stdout's lines. Fails on a non-zero exit."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True, cwd=ROOT,
                       timeout=timeout)
    check(r.returncode == 0, f"python -m {args[0]} exited {r.returncode}: {r.stderr[-2000:]}")
    return r.stdout.strip().splitlines(), time.perf_counter() - t0


def eval_phase(kernels, smi):
    """``[eval]``: the ``[main]`` bundle (VITS2Config(), the same seed) on the
    card through the eval harness: ``tools.build_examples`` (5 speakers) and
    ``batch_synthesize`` (5 speakers x 2 TEXTS) to WAVs, ``eval_rtf`` over
    the 16 TEXTS, each stage in a ``profiling.StageTimer``; kernel launches
    exactly per_synthesis_call's a call (10 of kernel 1, 4 of kernel 2) and
    no other kernel; ``speaker_similarity`` and ``frechet_audio_distance``
    with the default (artifact) embedder on the card; ``lstm_embedder`` on
    the card against the CPU (1e-4 absolute on the unit-norm embedding);
    ``python -m vosk_tts_tpu_torch.tools.eval_tts`` with ``--ref-dir`` at the
    batch_synthesize WAVs, its JSON line parsed. Returns the launches."""
    t_phase = time.perf_counter()
    all_kernels = {**kernels, "mas": mas.KERNEL}
    cfg = vits2.VITS2Config()
    tree = perturb_zero_init(synthesizer_init(cfg, seed=SEED), seed=SEED + 1)
    timer = profiling.StageTimer(sample_rate=22050)
    with tempfile.TemporaryDirectory(prefix="eval-") as root:
        bundle = os.path.join(root, "bundle")
        os.makedirs(bundle)
        write_bundle(bundle, cfg, tree)
        del tree
        model = api.Model(bundle)
        check(model.device.type == "cuda", "[eval] Model() did not default to the card")
        synth = api.Synth(model)
        synth.synth_audio(TEXTS[0])  # the first request's one-off costs, out of the stages
        expected = zeroed(all_kernels)
        with timer.stage("build_examples"), contextlib.redirect_stdout(io.StringIO()):
            ex = build_examples.main([bundle, os.path.join(root, "examples"), "--speakers",
                                      "0,1,2,3,4", "--text", TEXTS[1]])
        with timer.stage("batch_synthesize"):
            refs = harness.batch_synthesize(synth, TEXTS[:2], os.path.join(root, "ref"))
        paths = ex + refs
        check(len(ex) == 5 and len(refs) == 10 and all(wav_ok(p) for p in paths),
              f"[eval] bad WAVs among {paths}")
        with timer.stage("eval_rtf"):
            rtf = harness.eval_rtf(synth, TEXTS)
        timer.add_audio(int(round(rtf.extra["audio_sec"] * 22050)))
        calls = len(ex) + len(refs) + 1 + len(TEXTS)  # eval_rtf warms up on one text
        got = launches_now(all_kernels)
        expected |= {n: c * calls for n, c in per_synthesis_call(cfg).items()}
        print(f"[eval] {len(paths)} WAVs (22050 Hz int16, nonzero); eval_rtf over "
              f"{len(TEXTS)} texts: RTF {rtf.value:.4f}, {rtf.extra['audio_sec_per_sec']:.2f} "
              f"audio s/s, {rtf.extra['audio_sec']:.2f} s audio; launches over {calls} synthesis "
              f"calls {got} (expected {expected})")
        check(np.isfinite(rtf.value) and rtf.value > 0, f"[eval] RTF {rtf.value}")
        check(got == expected, f"[eval] kernel launches {got} != {expected}")

        def load(p):
            with wave.open(p) as f:
                return np.frombuffer(f.readframes(f.getnframes()), np.int16) / 32768.0

        wavs = {os.path.basename(p): load(p) for p in refs}
        check(harness._default_embedder() is not speaker_embed.mfcc_f0_embedding,
              "[eval] the default embedder is not the committed artifact")
        with timer.stage("speaker_similarity", sync=torch.zeros(1, device=model.device)):
            same = harness.speaker_similarity([(wavs[f"spk{s}_0000.wav"], wavs[f"spk{s}_0001.wav"])
                                               for s in range(5)])
            cross = harness.speaker_similarity([(wavs[f"spk{s}_0000.wav"],
                                                 wavs[f"spk{(s + 1) % 5}_0000.wav"])
                                                for s in range(5)])
        with timer.stage("frechet_audio_distance"):
            fad = harness.frechet_audio_distance([wavs[f"spk{s}_0000.wav"] for s in range(5)],
                                                 [wavs[f"spk{s}_0001.wav"] for s in range(5)])
        print(f"[eval] artifact embedder on the card (random-weight voices): same speaker, "
              f"two texts {same.value:.4f} (min {same.extra['min']:.4f}); next speaker, one text "
              f"{cross.value:.4f}; FAD {fad.value:.4f} ({fad.extra})")
        check(all(np.isfinite(v) and -1.0 - 1e-6 <= v <= 1.0 + 1e-6
                  for v in (same.value, cross.value)) and np.isfinite(fad.value)
              and fad.value >= 0, "[eval] bad similarity or FAD")

        wav = wavs["spk2_0001.wav"]
        emb_g = speaker_train.lstm_embedder()(wav, 22050)
        emb_c = speaker_train.lstm_embedder(device="cpu")(wav, 22050)
        err = float(np.abs(emb_g - emb_c).max())
        print(f"[eval] lstm_embedder card vs CPU on one WAV: max abs err {err:.3e} (tol 1e-4), "
              f"norms {np.linalg.norm(emb_g):.6f}, {np.linalg.norm(emb_c):.6f}")
        check(emb_g.shape == (64,) and err <= 1e-4, f"[eval] embedder card vs CPU differs by {err}")
        report = timer.report()
        print(f"[eval] StageTimer: {json.dumps(report)}")
        del model, synth
        torch.cuda.empty_cache()

        texts = os.path.join(root, "texts.txt")
        with open(texts, "w", encoding="utf-8") as f:
            f.write("\n".join(TEXTS[:2]) + "\n")
        lines, wall = module_json(["vosk_tts_tpu_torch.tools.eval_tts", bundle, "--texts", texts,
                                   "--out", os.path.join(root, "tool"), "--speakers", "0,1,2,3,4",
                                   "--ref-dir", os.path.join(root, "ref")])
        res = json.loads(lines[-1])
        print(f"[eval] python -m vosk_tts_tpu_torch.tools.eval_tts (on the card, {wall:.1f} s "
              f"with the process' start): {json.dumps(res, ensure_ascii=False)}")
        check(res["n_wavs"] == 10 and res["rtf"] > 0 and np.isfinite(
            res["speaker_similarity_avg"]) and -1 - 1e-6 <= res["speaker_similarity_min"] <= 1,
            f"[eval] eval_tts printed {res}")
    print(f"[eval] phase wall {time.perf_counter() - t_phase:.1f} s")
    return got


def whisper_phase(kernels, smi, dev=torch.device("cuda")):
    """``[whisper]``: WhisperEncConfig() ("small": 12 x 768, FFN 3072, 1500
    positions) from ``whisper_init`` on the card: get_content of a 10 s and
    a 29.9 s 16 kHz waveform; the log-mel and the features against the CPU
    (1e-4 absolute, 1e-3 x peak; f32, TF32 off); a call (log-mel +
    encoder at 30 s) timed between CUDA events and by
    ``profiling.device_timeit``, within 25% of each other; peak memory; one
    call under torch.profiler; ``profiling.trace`` writes a non-empty file;
    ``device_stats`` lists the card with bytes in use. No hand-written
    kernel on this path (the JAX encoder's attention is plain XLA)."""
    t_phase = time.perf_counter()
    all_kernels = {**kernels, "mas": mas.KERNEL}
    cfg = whisper.WhisperEncConfig()
    t0 = time.perf_counter()
    tree = to_port_layout(whisper_init(cfg, seed=SEED + 90))
    enc_c = TreeModule(tree)
    enc = TreeModule(tree).to(dev)
    n_params = sum(b.numel() for b in enc.buffers())
    print(f"[whisper] WhisperEncConfig() {n_params / 1e6:.2f} M parameters built in "
          f"{time.perf_counter() - t0:.1f} s")
    del tree
    rng = np.random.default_rng(SEED + 91)

    def voice(seconds):
        t = np.arange(int(seconds * 16000)) / 16000
        return (0.3 * np.sin(2 * np.pi * 180 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 0.9 * t))
                + 0.05 * rng.standard_normal(len(t))).astype(np.float32)

    wavs = {10.0: voice(10.0), 29.9: voice(29.9)}
    expected = zeroed(all_kernels)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        for s, w in wavs.items():
            feats = whisper.get_content(enc.params, cfg, w)
            torch.cuda.synchronize()
            check(feats.shape == (1, len(w) // 160 // 2, cfg.d_model)
                  and feats.device.type == dev.type and bool(torch.isfinite(feats).all()),
                  f"[whisper] bad features {feats.shape}")
            print(f"[whisper] get_content {s} s: {tuple(feats.shape)}")
        check(launches_now(all_kernels) == expected, "[whisper] a hand-written kernel launched")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30

        w = wavs[29.9]
        mel_g = whisper.whisper_log_mel(torch.tensor(whisper.pad_or_trim(w), device=dev)[None])
        mel_c = whisper.whisper_log_mel(torch.tensor(whisper.pad_or_trim(w))[None])
        t0 = time.perf_counter()
        feat_c = whisper.get_content(enc_c.params, cfg, w)
        cpu_s = time.perf_counter() - t0
        feat_g = whisper.get_content(enc.params, cfg, w).cpu()
        mel_err = float((mel_g.cpu() - mel_c).abs().max())
        peak = float(feat_c.abs().max())
        err = float((feat_g - feat_c).abs().max())
        print(f"[whisper] card vs CPU at 29.9 s: log-mel {mel_err:.3e} (tol 1e-4), features "
              f"{err:.3e} (peak {peak:.4f}, tol {1e-3 * peak:.3e}); the CPU took {cpu_s:.1f} s")
        check(mel_err <= 1e-4 and err <= 1e-3 * peak, "[whisper] card vs CPU differs")

        x0 = torch.tensor(whisper.pad_or_trim(w), device=dev)[None]
        call = lambda x: whisper.whisper_encoder_apply(enc.params, cfg,
                                                       whisper.whisper_log_mel(x))
        event = cuda_ms(lambda: call(x0), 10)
        # carry -> carry: the waveform plus a vanishing multiple of the features' mean
        per, t1, t2 = profiling.device_timeit(lambda x: x + 1e-30 * call(x).mean(), x0,
                                              n1=2, n2=10, reps=3)
        d, f, t = cfg.d_model, cfg.encoder_ffn_dim, cfg.max_source_positions
        flops = (2 * 3 * (2 * t * cfg.num_mel_bins * d + t * d * d)  # the two convs
                 + cfg.encoder_layers * 2 * t * (4 * d * d + 2 * d * f + 2 * t * d))
    print(f"[whisper] a call (log-mel + encoder, 30 s window): {event:.3f} ms between CUDA "
          f"events; device_timeit {1e3 * per:.3f} ms an iteration (t_2 {1e3 * t1:.3f}, t_10 "
          f"{1e3 * t2:.3f} ms); ~{flops / 1e12:.3f} TFLOP f32 ({flops / (event * 1e-3) / 1e12:.1f} "
          f"TFLOP/s); peak memory {peak_gib:.2f} GiB; {smi}")
    check(abs(1e3 * per - event) <= 0.25 * event,
          f"[whisper] device_timeit {1e3 * per} ms vs CUDA events {event} ms")
    with torch.inference_mode():
        profile_requests([("whisper get_content 29.9 s",
                           lambda: whisper.get_content(enc.params, cfg, w))])
        with tempfile.TemporaryDirectory(prefix="whisper-trace-") as d:
            with profiling.trace(d):
                whisper.get_content(enc.params, cfg, wavs[10.0])
            files = [os.path.join(d, f) for f in os.listdir(d)]
            sizes = [os.path.getsize(f) for f in files]
        print(f"[whisper] profiling.trace wrote {len(files)} file(s) of {sizes} bytes")
        check(len(files) == 1 and sizes[0] > 0, "[whisper] profiling.trace wrote no trace")
    stats = profiling.device_stats()
    print(f"[whisper] device_stats {stats}")
    check(len(stats) == 1 and stats[0]["bytes_in_use"] > 0, f"[whisper] device_stats {stats}")
    del enc, enc_c
    torch.cuda.empty_cache()
    print(f"[whisper] phase wall {time.perf_counter() - t_phase:.1f} s")


def ge2e_parity(tree, seed, dev):
    """``[ge2e-parity]``: one GE2E step's loss and gradients (B 8 x 4
    windows) on the card, on the CPU in f32 and in f64, from the same tree
    and batch: the loss 1e-4 relative card vs CPU f32; the gradients (all
    tensors together) 1e-2 relative L2 of the f64 step's."""
    rng = np.random.default_rng(seed)
    voices = [speaker_train.synthetic_voice(rng) for _ in range(8)]
    wavs = np.stack([speaker_train.synthetic_utterance(rng, v) for v in voices for _ in range(4)])
    with torch.no_grad():
        mels = speaker_train._mels(torch.as_tensor(wavs))[:, :speaker_train.PARTIAL_FRAMES]
    batch = mels.reshape(8, 4, *mels.shape[1:])
    sides = {}
    for name, d, dtype in (("card", dev, torch.float32), ("cpu", torch.device("cpu"),
                                                          torch.float32),
                           ("f64", torch.device("cpu"), torch.float64)):
        m = TreeModule(tree, trainable=True).to(device=d, dtype=dtype)
        loss = speaker_train.batch_loss(m.params, batch.to(device=d, dtype=dtype))
        loss.backward()
        sides[name] = (float(loss.detach()), [p.grad.cpu().double() for p in m.parameters()])

    def rel_l2(a, b):
        return (sum(float((x - y).pow(2).sum()) for x, y in zip(a, b))
                / sum(float(y.pow(2).sum()) for y in b)) ** 0.5

    loss_err = abs(sides["card"][0] - sides["cpu"][0]) / abs(sides["cpu"][0])
    g_card, g_cpu = rel_l2(sides["card"][1], sides["f64"][1]), rel_l2(sides["cpu"][1],
                                                                      sides["f64"][1])
    print(f"[ge2e-parity] B8x4 x {speaker_train.PARTIAL_FRAMES} frames: loss card "
          f"{sides['card'][0]:.6f}, CPU f32 {sides['cpu'][0]:.6f}, f64 {sides['f64'][0]:.6f} "
          f"(card vs CPU {loss_err:.3e}, tol 1e-4); gradients against f64, relative L2: card "
          f"{g_card:.3e}, CPU f32 {g_cpu:.3e} (tol {PARITY_GRAD_L2})")
    check(loss_err <= 1e-4 and g_card <= PARITY_GRAD_L2,
          f"[ge2e-parity] loss {loss_err} or gradients {g_card} off")


def ge2e_phase(kernels, smi, dev=torch.device("cuda")):
    """``[ge2e]``: train_speaker_encoder at its defaults on the card (64 voices
    x 6 utterances, B 8 x 4 windows of 80 frames, hidden 64, emb 64, 2
    layers, 400 steps): the first and last loss (the last below the first),
    steps/s over steps 0-350 (the host clock between the loss reads of the
    log, each a synchronisation); the held-out check of
    tests/test_speaker_embedder.py on the card-trained embedder (same >
    0.75, same > cross + 0.15); ``python -m
    vosk_tts_tpu_torch.tools.train_speaker_embedder --steps 400 --out <tmp>``
    on the card, whose artifact ``lstm_embedder`` loads; then
    ``[ge2e-parity]`` from the trained tree. No hand-written kernel."""
    t_phase = time.perf_counter()
    all_kernels = {**kernels, "mas": mas.KERNEL}
    expected = zeroed(all_kernels)
    logs = []
    t0 = time.perf_counter()
    params, extra = speaker_train.train_speaker_encoder(
        SEED, log=lambda m: logs.append((time.perf_counter(), m)), device=dev)
    wall = time.perf_counter() - t0
    first = float(logs[0][1].rsplit(" ", 1)[1])
    steps_s = 350 / (logs[-1][0] - logs[0][0])
    print(f"[ge2e] train_speaker_encoder defaults on the card: {wall:.1f} s with the corpus; "
          f"loss first {first:.4f}, last {extra['loss']:.4f}; {steps_s:.1f} steps/s "
          f"({1e3 / steps_s:.3f} ms a step, steps 0-350); {smi}")
    check(np.isfinite(extra["loss"]) and extra["loss"] < first,
          f"[ge2e] the loss did not fall: {first} -> {extra['loss']}")
    check(launches_now(all_kernels) == expected, "[ge2e] a hand-written kernel launched")
    same, cross = held_out(speaker_train.lstm_embedder(params, device=dev))
    print(f"[ge2e] held-out voices, the card-trained embedder on the card: same {same:.4f}, "
          f"cross {cross:.4f} (need same > 0.75 and same > cross + 0.15)")
    check(same > 0.75 and same > cross + 0.15, f"[ge2e] held-out same {same}, cross {cross}")

    with tempfile.TemporaryDirectory(prefix="ge2e-") as d:
        out = os.path.join(d, "speaker_encoder.npz")
        lines, wall = module_json(["vosk_tts_tpu_torch.tools.train_speaker_embedder", "--steps",
                                   "400", "--out", out])
        print(f"[ge2e] python -m vosk_tts_tpu_torch.tools.train_speaker_embedder --steps 400 "
              f"(on the card, {wall:.1f} s with the process' start): {lines[-2]}; {lines[-1]}")
        e = speaker_train.lstm_embedder(speaker_train.load_artifact(out)["params"], device=dev)(
            np.asarray(speaker_train.synthetic_utterance(np.random.default_rng(7),
                       speaker_train.synthetic_voice(np.random.default_rng(8)))), 22050)
        check(e.shape == (64,) and abs(float(np.linalg.norm(e)) - 1) < 1e-5,
              "[ge2e] the tool's artifact does not embed")
    ge2e_parity(to_port_layout(params), SEED + 95, dev)
    print(f"[ge2e] phase wall {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# 19. Data- and tensor-parallel training, synth_batch over replicas
# ---------------------------------------------------------------------------

DIST_SEED = SEED + 90
#: seconds: the ranks' group (each collective) and the wait for the ranks
DIST_TIMEOUT = 300
#: the tensor-parallel generator's input: rows and frames (x 256 samples)
DIST_TP_B, DIST_TP_T = 2, 128


def flat_grads(module):
    """A network's gradients, flattened in its parameters' order, on the host."""
    return torch.cat([p.grad.reshape(-1) for p in module.parameters()]).cpu()


def digest_of(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))


def dist_rank(rank: int, root: str) -> int:
    """One of the two ranks of ``[dist]`` (a) and (c), both on ``cuda:0``
    over gloo (NCCL refuses two ranks on one card; gloo's CUDA collectives
    are all_reduce and broadcast, all the port's collectives use):
    (a) the data-parallel VITS2 step on this rank's 12 rows of the B24
    batch in ``inputs.pt``, draws pinned per row, in deterministic
    algorithms; (c) the generator tensor-parallel over a model axis of 2.
    Writes ``rank{rank}.pt``."""
    from vosk_tts_tpu_torch.parallel import mesh as pmesh
    from vosk_tts_tpu_torch.parallel import tp as ptp
    import datetime

    full_float32()
    # two ranks on one card, as torchrun --nproc-per-node 2 names them:
    # initialize picks gloo, since NCCL refuses them
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2")
    dev = pmesh.initialize(f"file://{root}/store", 2, rank, device="cuda",
                           timeout=datetime.timedelta(seconds=DIST_TIMEOUT))
    check(torch.distributed.get_backend() == "gloo",
          f"[dist] two ranks on one card joined over {torch.distributed.get_backend()}")
    inputs = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    mcfg, tcfg = inputs["mcfg"], inputs["tcfg"]
    out = {}

    # (a) the data-parallel step
    grid = pmesh.make_grid()
    rows = slice(12 * rank, 12 * rank + 12)
    with deterministic():
        state = tt.init_train_state(mcfg, tcfg, device=dev, trees=inputs["trees"])
        step = tt.make_train_step(mcfg, tcfg, dp=grid.data)
        batch = to_device({k: v[rows] for k, v in inputs["batch"].items()}, dev)
        noise = {k: v[rows].to(dev) for k, v in inputs["noise"].items()}
        mas.KERNEL.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(state, batch, noise=noise)
        torch.cuda.synchronize()
        out["step_ms"] = 1e3 * (time.perf_counter() - t0)
        out["mas_launches"] = mas.KERNEL.launches
        out["metrics"] = {k: float(v) for k, v in metrics.items()}
        grads = {k: flat_grads(m) for k, m in state.params.items()}
        out["digest"] = {k: digest_of([g]) for k, g in grads.items()}
        out["params_digest"] = {k: digest_of(m.parameters()) for k, m in state.params.items()}
        if rank == 0:
            out["grads"] = grads
    del state, grads
    torch.cuda.empty_cache()

    # (c) the tensor-parallel generator
    tp_grid = pmesh.make_grid(n_data=1, n_model=2)
    local, tp = ptp.shard_generator_params(inputs["trees"]["g"]["dec"], tp_grid.model)
    dec = TreeModule(local).to(dev)
    z, g = inputs["tp_z"].to(dev), inputs["tp_g"].to(dev)
    with torch.no_grad():
        wav = vits2.generator_apply(dec.params, mcfg, z, g, tp=tp)[0]
        out["tp_ms"] = float(np.median([event_ms(lambda: vits2.generator_apply(
            dec.params, mcfg, z, g, tp=tp))[0] for _ in range(5)]))
    out["tp_out"] = wav.cpu()
    out["tp_weights"] = sum(t.numel() for t in dec.buffers())
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    pmesh.shutdown()
    return 0


def run_ranks(root, n):
    """``n`` ranks of this script (``--dist-rank``), each waited for at most
    DIST_TIMEOUT s; every one is stopped before this returns. Fails unless
    every rank exits 0."""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist-rank", str(r),
                               "--dist-root", root], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(n)]
    logs = []
    try:
        deadline = time.monotonic() + DIST_TIMEOUT
        for p in procs:
            try:
                logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
            except subprocess.TimeoutExpired:
                logs.append("(timed out)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            print(f"[dist] rank {r} exited {p.returncode}; the end of its output:\n{log[-3000:]}")
        check(p.returncode == 0, f"[dist] rank {r} failed (exit {p.returncode})")


@contextlib.contextmanager
def torchrun_env(world: int = 1):
    """torchrun's environment for rank 0 of ``world`` on this host, a free
    port for its store; the old environment is put back after."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": str(world), "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dist_phase(kernels, smi, dev=torch.device("cuda")):
    """``[dist]``: (a) a 2-rank data-parallel VITS2 step (VITS2Config(),
    TrainConfig(), global B24 = 2 x 12 of [train]'s corpus, draws pinned per
    row) against the 1-rank B24 step, both in deterministic algorithms, with
    ``[train-parity]``'s gates: every loss within 1e-3 relative, each
    network's gradients within PARITY_GRAD_L2 relative L2, MAS launched once
    a rank, the two ranks' gradients and parameters equal; (b) ``run_vits2
    --distributed`` as one NCCL rank for 2 steps, then a resume from its
    STATE_2 for one more; (c) the generator tensor-parallel over a model axis
    of 2 at VITS2Config() width against the unsharded one (1e-3 x peak);
    (d) ``synth_batch`` of 5 texts (padded to 6) over two replicas on
    ``cuda:0`` against one replica, noise 0: equal lengths, 1e-3 x peak, 10
    banded attention and 4 DDSConv launches a replica. Returns the launches
    (MAS over the ranks' steps, kernels 1-2 over (d)'s two-replica call)."""
    all_kernels = {**kernels, "mas": mas.KERNEL}
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="dist-") as root:
        t0 = time.perf_counter()
        write_corpus(root)
        cfg_path = os.path.join(root, "config.json")
        with open(cfg_path, "w", encoding="utf-8") as f:
            json.dump(train_config(root), f)
        mcfg, tcfg, dcfg = run_vits2.build_configs(train_config(root))
        check(mcfg == vits2.VITS2Config() and tcfg == tt.TrainConfig(),
              f"[dist] the training config is not the full-width default: {mcfg} {tcfg}")
        batch_np = next(BucketBatcher(TTSDataset(dcfg), 24).epoch(0))
        b, t_x = batch_np["x"].shape
        t_y = batch_np["mel"].shape[1]
        rng = np.random.default_rng(DIST_SEED)
        noise = {k: torch.tensor(rng.standard_normal(shape).astype(np.float32)) for k, shape in
                 (("posterior", (b, t_y, mcfg.inter_channels)), ("e_q", (b, t_x, 2)),
                  ("z", (b, t_x, 2)))}
        noise["ids_slice"] = torch.tensor((rng.uniform(size=b) * np.maximum(
            batch_np["mel_lengths"] - mcfg.segment_size + 1, 1)).astype(np.int64))
        trees = tt.init_trees(mcfg, tcfg, DIST_SEED)  # the flows' projections perturbed
        trees["g"] = to_port_layout(perturb_zero_init(synthesizer_init(mcfg, DIST_SEED),
                                                      seed=DIST_SEED + 1))
        tp_z = torch.tensor(rng.standard_normal((DIST_TP_B, DIST_TP_T, mcfg.inter_channels))
                            .astype(np.float32))
        tp_g = torch.tensor(rng.standard_normal((DIST_TP_B, 1, mcfg.gin_channels))
                            .astype(np.float32))
        torch.save({"mcfg": mcfg, "tcfg": tcfg, "trees": trees, "batch": batch_np,
                    "noise": noise, "tp_z": tp_z, "tp_g": tp_g}, os.path.join(root, "inputs.pt"))
        print(f"[dist] [train]'s corpus and B{b} batch (T_x {t_x}, T_y {t_y}), full-width "
              f"trees and pinned draws in {time.perf_counter() - t0:.1f} s")

        # (a) the 1-rank B24 step, the reference of the 2-rank step
        with deterministic():
            state = tt.init_train_state(mcfg, tcfg, device=dev, trees=trees)
            step = tt.make_train_step(mcfg, tcfg)
            mas.KERNEL.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = {k: float(v) for k, v in step(state, to_device(batch_np, dev),
                                                  noise={k: v.to(dev) for k, v in
                                                         noise.items()}).items()}
            torch.cuda.synchronize()
            ms_one = 1e3 * (time.perf_counter() - t0)
            check(mas.KERNEL.launches == 1, f"[dist] the 1-rank step launched MAS "
                                            f"{mas.KERNEL.launches} times")
            ref = {k: flat_grads(m) for k, m in state.params.items()}
        del state
        torch.cuda.empty_cache()
        # (c)'s reference: the unsharded generator
        dec = TreeModule(trees["g"]["dec"]).to(dev)
        with torch.no_grad():
            wav_ref = vits2.generator_apply(dec.params, mcfg, tp_z.to(dev), tp_g.to(dev))[0]
            tp_ref_ms = float(np.median([event_ms(lambda: vits2.generator_apply(
                dec.params, mcfg, tp_z.to(dev), tp_g.to(dev)))[0] for _ in range(5)]))
        wav_ref, dec_weights = wav_ref.cpu(), sum(t.numel() for t in dec.buffers())
        del dec, trees
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        run_ranks(root, 2)
        ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        t_ranks = time.perf_counter() - t0
        got = ranks[0]["metrics"]
        rel = {k: abs(got[k] - w) / max(abs(w), 1e-30) for k, w in want.items()}
        print(f"[dist] (a) 2 ranks x B12 on cuda:0 (gloo) vs 1 rank x B24, deterministic "
              f"algorithms: losses 2 ranks {got}, 1 rank {want}, relative differences {rel} "
              f"(tol 1e-3); step {ranks[0]['step_ms']:.1f} / {ranks[1]['step_ms']:.1f} ms a "
              f"rank vs {ms_one:.1f} ms (host clock, first step, both ranks on one card); "
              f"the ranks' process wall {t_ranks:.1f} s; {smi}")
        check(set(got) == set(want) and all(r <= 1e-3 for r in rel.values()),
              f"[dist] the 2-rank step's losses differ from the 1-rank step's: {rel}")
        check(ranks[0]["metrics"] == ranks[1]["metrics"], "[dist] the ranks' losses differ")
        for k, g in ref.items():
            l2 = rel_l2(ranks[0]["grads"][k], g)
            print(f"[dist] (a) {k} gradients (reduced, rank 0) vs the 1-rank step: relative "
                  f"L2 {l2:.3e} (tol {PARITY_GRAD_L2}); equal on both ranks: "
                  f"{ranks[0]['digest'][k] == ranks[1]['digest'][k]}")
            check(l2 <= PARITY_GRAD_L2, f"[dist] {k} gradients differ: relative L2 {l2}")
        check(ranks[0]["digest"] == ranks[1]["digest"]
              and ranks[0]["params_digest"] == ranks[1]["params_digest"],
              "[dist] the ranks' gradients or parameters after the step differ")
        mas_launches = [r["mas_launches"] for r in ranks]
        check(mas_launches == [1, 1], f"[dist] MAS launches a rank {mas_launches} != [1, 1]")
        out["mas"] = sum(mas_launches)

        # (c) the tensor-parallel generator
        peak = float(wav_ref.abs().max())
        errs = [float((r["tp_out"] - wav_ref).abs().max()) for r in ranks]
        print(f"[dist] (c) generator at VITS2Config() width (upsample_initial_channel "
              f"{mcfg.upsample_initial_channel}), model axis 2 on cuda:0 (gloo), B{DIST_TP_B} "
              f"{DIST_TP_T} frames: max |TP - unsharded| {errs} (peak {peak:.4f}, tol 1e-3 x "
              f"peak); weights a rank {ranks[0]['tp_weights']} of {dec_weights}; "
              f"{ranks[0]['tp_ms']:.3f} ms (TP, CUDA events, median of 5, both ranks on one "
              f"card) vs {tp_ref_ms:.3f} ms unsharded; {smi}")
        check(all(e <= 1e-3 * peak for e in errs), f"[dist] the TP generator differs: {errs}")
        check(ranks[0]["tp_weights"] < dec_weights, "[dist] the TP ranks hold every weight")
        del ranks, ref

        # (b) run_vits2 --distributed as one NCCL rank, then a resume
        model_dir = os.path.join(root, "model")
        args = ["-c", cfg_path, "-m", model_dir, "--distributed"]
        mas.KERNEL.launches = 0
        with torchrun_env():
            t0 = time.perf_counter()
            first, m1 = run_vits2.main(args + ["--max-steps", "2"])
            t_first = time.perf_counter() - t0
            check(first.step == 2 and m1 and all(np.isfinite(v) for v in m1.values()),
                  f"[dist] run_vits2 --distributed: step {first.step}, metrics {m1}")
            check(not torch.distributed.is_initialized(), "[dist] run_vits2 left the group up")
            restored = tt.init_train_state(mcfg, tcfg, seed=DIST_SEED + 2, device=dev)
            resume_state(model_dir, restored)
            check(same_state(first, restored), "[dist] STATE_2 did not restore the state")
            del restored, first
            t0 = time.perf_counter()
            state, m2 = run_vits2.main(args + ["--max-steps", "3"])
            check(state.step == 3 and all(np.isfinite(v) for v in m2.values()),
                  f"[dist] resumed run_vits2 --distributed: step {state.step}, metrics {m2}")
            del state
        check(mas.KERNEL.launches == 3, f"[dist] MAS launched {mas.KERNEL.launches} times in "
                                        f"run_vits2's 3 steps")
        print(f"[dist] (b) run_vits2 --distributed, one NCCL rank (torchrun's environment): 2 "
              f"steps in {t_first:.1f} s (init, mels, steps, save), STATE_2 restored (params, "
              f"AdamW state equal), a resumed step in {time.perf_counter() - t0:.1f} s: {m2}; "
              f"{smi}")
    torch.cuda.empty_cache()

    # (d) synth_batch over two replicas on cuda:0 against one
    cfg = vits2.VITS2Config()
    with tempfile.TemporaryDirectory(prefix="dist-bundle-") as bundle:
        write_bundle(bundle, cfg, perturb_zero_init(synthesizer_init(cfg, seed=DIST_SEED),
                                                    seed=DIST_SEED + 3))
        synth = api.Synth(api.Model(bundle))
        kw = dict(noise_level=0.0, duration_noise_level=0.0, speaker_ids=[0, 3, 7, 1, 2])
        texts = TEXTS[:5]
        for devices in (["cuda:0"], ["cuda:0", "cuda:0"]):  # warm-up (the replica made)
            synth.synth_batch(texts, devices=devices, **kw)
        t0 = time.perf_counter()
        one = synth.synth_batch(texts, devices=["cuda:0"], **kw)
        t_one = time.perf_counter() - t0
        for k in all_kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        two = synth.synth_batch(texts, devices=["cuda:0", "cuda:0"], **kw)
        t_two = time.perf_counter() - t0
        got = {n: k.launches for n, k in all_kernels.items()}
        expected = {n: 0 for n in all_kernels} | {"banded_attention": 20, "ddsconv": 8}
        peak = max(float(np.abs(a.astype(np.float64)).max()) for a in one)
        err = max(float(np.abs(a.astype(np.float64) - w).max()) for a, w in zip(two, one))
        print(f"[dist] (d) synth_batch of {len(texts)} texts (padded to 6) over 2 replicas on "
              f"cuda:0 vs 1, noise 0: lengths {[len(a) for a in two]} vs "
              f"{[len(a) for a in one]}, max |diff| {err:.0f} int16 steps (peak {peak:.0f}, "
              f"tol 1e-3 x peak); {t_two * 1e3:.1f} ms vs {t_one * 1e3:.1f} ms (host clock); "
              f"launches {got} (expected {expected}); {smi}")
        check([len(a) for a in two] == [len(a) for a in one], "[dist] synth_batch lengths differ")
        check(err <= 1e-3 * peak, f"[dist] synth_batch over 2 replicas differs: {err}")
        check(got == expected, f"[dist] synth_batch launches {got} != {expected}")
        out |= {n: got[n] for n in ("banded_attention", "ddsconv")}
        del synth
    torch.cuda.empty_cache()
    print(f"[dist] wall {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 20. The checkpoint converters and the data tools
# ---------------------------------------------------------------------------

TOOLS_SEED = SEED + 110
TOOLS_WAV_SECONDS = (2.0, 5.0, 10.0)
BOOTSTRAP_UTTERANCES, BOOTSTRAP_BATCH = 8, 4
G2P_WORDS, G2P_BATCH, G2P_EPOCHS = 4096, 256, 13  # 16 steps an epoch: 208 steps


def tool(name, *args):
    """``python -m vosk_tts_tpu_torch.tools.<name> args`` (on the card
    unless ``--device cpu`` is among them): (its stdout's lines, wall s)."""
    return module_json([f"vosk_tts_tpu_torch.tools.{name}", *map(str, args)])


def match_folded(got, want, n_folded):
    """``got`` against the source tree ``want``: equal structure and shapes,
    every leaf exact but at most ``n_folded`` (the folded weight-norm
    pairs), each within 1e-6 of its largest magnitude. Returns (leaves,
    inexact leaves, the largest of their errors over that magnitude)."""
    g, w = flat_paths(got), flat_paths(want)
    check(g.keys() == w.keys(), f"converted tree paths differ: {sorted(set(g) ^ set(w))[:4]}")
    inexact, worst = 0, 0.0
    for p, b in w.items():
        a = g[p]
        check((a is None) == (b is None) and (a is None or a.shape == b.shape), f"leaf {p} differs")
        if a is not None and not np.array_equal(a, b):
            inexact += 1
            worst = max(worst, float(np.abs(a - b).max()) / float(np.abs(b).max()))
    check(inexact <= n_folded and worst <= 1e-6,
          f"{inexact} leaves differ (of {n_folded} folded), the worst by {worst:.3e} of its max")
    return len(w), inexact, worst


def flat_paths(tree, path=""):
    if tree is None:
        return {path: None}
    if isinstance(tree, dict):
        return {p: a for k, v in tree.items() for p, a in flat_paths(v, f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: a for i, v in enumerate(tree) for p, a in flat_paths(v, f"{path}/{i}").items()}
    return {path: np.asarray(tree)}


def served(tag, bundle, kernels, smi):
    """``Model(bundle)`` (no device: the card) answering main_path's 3
    requests; the launches over them must be ``per_synthesis_call``'s a
    call (VITS2Config(): 10 of kernel 1, 4 of kernel 2). Returns (the
    model, the audio, the launches)."""
    model = api.Model(bundle)
    check(model.device.type == "cuda", f"[{tag}] Model() did not default to the card")
    zeroed(kernels)
    calls, audios = main_path(model, tag=tag, with_batch=False)
    got = launches_now(kernels)
    want = {n: 0 for n in kernels} | {n: c * calls for n, c in
                                      per_synthesis_call(model.model_config).items()}
    print(f"[{tag}] launches over {calls} synthesis calls: {got} (expected {want}); {smi}")
    check(got == want, f"[{tag}] kernel launches {got} != {want}")
    return model, audios, got


def fed_int16(models, text, sid=3):
    """``text`` through each model's encode_for_infer and
    decode_from_durations at noise 0, every model fed the first one's
    durations: the int16 waveforms (as parity() runs them)."""
    ids = api.encode_plain(models[0], text)
    bucket = next(b for b in api.TEXT_BUCKETS if b >= len(ids))
    x = np.zeros((1, bucket), np.int64)
    x[0, :len(ids)] = ids
    out, w_ceil = [], None
    for m in models:
        dev = m.device
        with torch.inference_mode():
            enc = m.synthesizer.encode_for_infer(
                torch.as_tensor(x, device=dev), torch.tensor([len(ids)], dtype=torch.int32,
                                                             device=dev),
                torch.tensor([sid], device=dev), noise_scale_w=0.0)
            if w_ceil is None:
                w_ceil = enc["w_ceil"].cpu()
            enc["w_ceil"] = w_ceil.to(dev)
            pred = int(w_ceil.sum())
            fb = api.pick_frame_bucket(pred, bucket)
            dec = m.synthesizer.decode_from_durations(enc, torch.tensor([sid], device=dev),
                                                      max_frames=fb, noise_scale=0.0,
                                                      gen_frames=api.pick_gen_frames(pred, fb))
        n = int(dec["wav_lengths"][0])
        out.append(api.audio_float_to_int16(dec["wav"][0, :n, 0].cpu().numpy()))
    return out


def hubert_hf_config(cfg):
    """An HF ``config.json`` dict for ``HubertConfig`` ``cfg`` (the keys
    ``HubertConfig.from_hf`` reads, the base layout's flags)."""
    d = {f.name: (list(v) if isinstance(v, tuple) else v)
         for f in dataclasses.fields(cfg) for v in [getattr(cfg, f.name)]}
    return {"model_type": "hubert", "feat_extract_norm": "group", "do_stable_layer_norm": False,
            **d}


def tools_phase(kernels, smi, dev=torch.device("cuda")):
    """``[tools]``: (a) ``make_demo_bundle --full`` served on the card (3
    requests, 10 + 4 launches a call, ``parity`` against the CPU); (b) a
    VITS2Config() tree written as a reference ``G_7.pth`` (weight-norm pairs
    split) converted by ``convert_checkpoint`` back to the tree (folded
    weights 1e-6 relative, the rest exact) and served as the source bundle
    is, within 1 int16 step of it, with (a)'s launches; (c) an HF HuBERT
    directory at HubertConfig() width as ``pytorch_model.bin`` and
    ``model.safetensors`` through ``convert_hubert`` (equal bundles), then
    ``vc_encode_dataset`` and ``gpt_sovits_prepare`` (SoVITSConfig()) on the
    card against the CPU over 2, 5 and 10 s wavs; (d)
    ``stabletts_bootstrap``'s ``compute_stats`` card vs CPU and
    ``run_durations`` from a StableTTSConfig() STATE_0.pt with BertConfig()
    features, 8 launches of kernel 3 and one of MAS a batch; (e)
    ``train_g2p.train`` at its default widths on a synthetic lexicon. Each
    stage prints its wall. Returns the launches of (a), (b) and (d)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_ref_layout as R  # numpy only: reference-named state dicts, a synthetic lexicon

    t_phase = time.perf_counter()
    all_kernels = {**kernels, "mas": mas.KERNEL}
    out = {}
    with tempfile.TemporaryDirectory(prefix="tools-") as root:
        # (a) the demo bundle
        t0 = time.perf_counter()
        demo = os.path.join(root, "demo")
        _, wall = tool("make_demo_bundle", demo, "--full", "--seed", TOOLS_SEED)
        with open(os.path.join(demo, "config.json"), encoding="utf-8") as f:
            check(vits2.VITS2Config.from_dict(json.load(f)["model"]) == vits2.VITS2Config(),
                  "[tools demo] the bundle is not VITS2Config()")
        model, _, out["demo"] = served("tools demo", demo, all_kernels, smi)
        parity(model, api.Model(demo, device="cpu"), tag="tools demo parity")
        del model
        print(f"[tools demo] make_demo_bundle --full ({wall:.1f} s) served and held to the CPU "
              f"in {time.perf_counter() - t0:.1f} s; {smi}")

        # (b) a reference VITS2 checkpoint through convert_checkpoint
        t0 = time.perf_counter()
        cfg = vits2.VITS2Config()
        tree = perturb_zero_init(synthesizer_init(cfg, seed=TOOLS_SEED + 1), seed=TOOLS_SEED + 2)
        sd = R.vits2_state_dict(tree, cfg)
        n_folded = sum(k.endswith(".weight_v") for k in sd)
        torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}, "iteration": 7},
                   os.path.join(root, "G_7.pth"))
        with open(os.path.join(root, "ref.json"), "w", encoding="utf-8") as f:
            json.dump(R.vits2_reference_config(cfg), f)
        converted, source = os.path.join(root, "converted"), os.path.join(root, "source")
        _, wall = tool("convert_checkpoint", os.path.join(root, "G_7.pth"),
                       os.path.join(root, "ref.json"), converted)
        n, inexact, worst = match_folded(load_params(os.path.join(converted, "params.npz")), tree,
                                         n_folded)
        with open(os.path.join(converted, "config.json"), encoding="utf-8") as f:
            check(vits2.VITS2Config.from_dict(json.load(f)["model"]) == cfg,
                  "[tools convert] the converted config is not the source's")
        print(f"[tools convert] G_7.pth ({len(sd)} tensors, {n_folded} weight-norm pairs) "
              f"converted in {wall:.1f} s: {n} leaves, {inexact} folded ones not bit-equal, the "
              f"largest by {worst:.3e} of its max (tol 1e-6), every other leaf equal")
        os.makedirs(source)
        write_bundle(source, cfg, tree)
        del tree, sd
        conv_model, _, out["convert"] = served("tools convert", converted, all_kernels, smi)
        src_model = api.Model(source)
        steps = []
        for text in TEXTS[:3]:
            a, b = fed_int16([src_model, conv_model], text)
            steps.append(int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max()))
        print(f"[tools convert] converted vs source bundle on the card, 3 texts at noise 0 on "
              f"the source's durations: max |diff| {steps} int16 steps (tol 1); "
              f"{time.perf_counter() - t0:.1f} s")
        check(max(steps) <= 1, f"[tools convert] the converted bundle's audio differs: {steps}")
        del src_model, conv_model

        # (c) HuBERT: convert_hubert, vc_encode_dataset, gpt_sovits_prepare
        t0 = time.perf_counter()
        hcfg = hubert.HubertConfig()
        htree = hubert_init(hcfg, seed=TOOLS_SEED + 3)
        hsd = R.hubert_state_dict(htree, "parametrizations")
        for name in ("bin", "st"):
            os.makedirs(os.path.join(root, name))
            with open(os.path.join(root, name, "config.json"), "w", encoding="utf-8") as f:
                json.dump(hubert_hf_config(hcfg), f)
        torch.save({k: torch.from_numpy(v) for k, v in hsd.items()},
                   os.path.join(root, "bin", "pytorch_model.bin"))
        R.write_safetensors(os.path.join(root, "st", "model.safetensors"), hsd)
        check(all(np.array_equal(a, hsd[k]) for k, a in read_state_dict(
            os.path.join(root, "st", "model.safetensors")).items()),
            "[tools hubert] the safetensors reader does not give the written tensors")
        _, w_bin = tool("convert_hubert", os.path.join(root, "bin"), os.path.join(root, "hubert"))
        w_st = time.perf_counter()
        convert_hubert.main([os.path.join(root, "st"), os.path.join(root, "hubert_st")])
        w_st = time.perf_counter() - w_st
        a, b = (load_params(os.path.join(root, d, "params.npz")) for d in ("hubert", "hubert_st"))
        check(all(np.array_equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
              and flat_paths(a).keys() == flat_paths(b).keys(),
              "[tools hubert] the .bin and .safetensors bundles differ")
        pos = np.abs(a["pos_conv"]["w"] - htree["pos_conv"]["w"]).max() / np.abs(
            htree["pos_conv"]["w"]).max()
        a["pos_conv"] = htree["pos_conv"]
        match_folded(a, htree, 0)
        # the fold's norm sums 768 x 48 squares in f32 (as the JAX package's does)
        print(f"[tools hubert] convert_hubert of pytorch_model.bin ({w_bin:.1f} s, a process) and "
              f"model.safetensors ({w_st:.1f} s, in process): equal bundles, every leaf equal to the source's "
              f"but the folded positional conv, within {pos:.3e} of its max (tol 1e-5)")
        check(pos <= 1e-5, f"[tools hubert] the positional conv folds {pos:.3e} off")
        del htree, hsd, a, b
        rng = np.random.default_rng(TOOLS_SEED + 4)
        sides = {}
        for side in ("card", "cpu"):
            os.makedirs(os.path.join(root, f"wavs_{side}"))
        for i, seconds in enumerate(TOOLS_WAV_SECONDS):
            write_voice(os.path.join(root, "wavs_card", f"w{i}.wav"), rng, int(seconds * 16000),
                        16000)
            shutil.copy(os.path.join(root, "wavs_card", f"w{i}.wav"),
                        os.path.join(root, "wavs_cpu", f"w{i}.wav"))
        scfg = gpt_sovits.SoVITSConfig()
        save_params(os.path.join(root, "sovits.npz"), sovits_init(scfg, seed=TOOLS_SEED + 5))
        # in process, with this script's f32 settings (TF32 off: a fresh process would
        # take torch's default, TF32 in cuDNN's convolutions)
        hub, walls = os.path.join(root, "hubert"), {}
        for side, extra in (("card", []), ("cpu", ["--device", "cpu"])):
            t1 = time.perf_counter()
            vc_encode_dataset.main([hub, os.path.join(root, f"wavs_{side}"), *extra])
            gpt_sovits_prepare.main([hub, os.path.join(root, "sovits.npz"),
                                     os.path.join(root, f"wavs_{side}"),
                                     os.path.join(root, f"{side}.tsv"), *extra])
            walls[side] = time.perf_counter() - t1
        codes = {}
        for side in ("card", "cpu"):
            with open(os.path.join(root, f"{side}.tsv"), encoding="utf-8") as f:
                codes[side] = [np.asarray(line.split("\t")[1].split(), np.int64)
                               for line in f.read().splitlines()]
        errs = []
        for i in range(len(TOOLS_WAV_SECONDS)):
            for ext in (".cv.npy", ".ssl.npy"):
                g, c = (np.load(os.path.join(root, f"wavs_{s}", f"w{i}{ext}")) for s in ("card",
                                                                                          "cpu"))
                check(g.shape == c.shape == (hcfg.n_frames(int(TOOLS_WAV_SECONDS[i] * 16000)),
                                             hcfg.hidden_size), f"[tools hubert] {ext} shape")
                errs.append(float(np.abs(g - c).max()) / float(np.abs(c).max()))
        print(f"[tools hubert] vc_encode_dataset and gpt_sovits_prepare over "
              f"{sum(TOOLS_WAV_SECONDS):.0f} s of audio, on the card {walls['card']:.1f} s, on "
              f"the CPU {walls['cpu']:.1f} s: .cv.npy and .ssl.npy card vs CPU {max(errs):.3e} x "
              f"peak (tol 1e-3)")
        check(max(errs) <= 1e-3, f"[tools hubert] features card vs CPU {max(errs):.3e} x peak")
        sovits = to_port_layout({k: load_params(os.path.join(root, "sovits.npz"))[k]
                                 for k in ("ssl_proj", "codebook")})
        differ, total = [], 0
        for i, (g, c) in enumerate(zip(codes["card"], codes["cpu"])):
            check(len(g) == len(c), "[tools hubert] code counts differ")
            total += len(g)
            for j in np.flatnonzero(g != c):
                # the two candidates' squared distances from the CPU's latent, in f64
                ssl = torch.from_numpy(np.load(os.path.join(root, "wavs_cpu",
                                                            f"w{i}.ssl.npy"))).double()[None]
                x = torch.nn.functional.conv1d(
                    ssl.transpose(1, 2), torch.from_numpy(sovits["ssl_proj"]["w"]).double(),
                    torch.from_numpy(sovits["ssl_proj"]["b"]).double(), stride=2)[0, :, j]
                book = torch.from_numpy(sovits["codebook"]).double()
                d = [float((x - book[k]).square().sum()) for k in (g[j], c[j])]
                differ.append((i, int(j), int(g[j]), int(c[j]), d))
        print(f"[tools hubert] semantic codes card vs CPU: {total - len(differ)} of {total} "
              f"equal; differing (wav, frame, card, CPU, distances): {differ}")
        check(len(differ) <= 0.01 * total and all(abs(d[0] - d[1]) <= 1e-5 * max(d)
                                                  for *_, d in differ),
              f"[tools hubert] codes differ beyond ties: {differ}")
        print(f"[tools hubert] {time.perf_counter() - t0:.1f} s; {smi}")

        # (d) stabletts_bootstrap: the mel statistics, MAS durations
        t0 = time.perf_counter()
        corpus = os.path.join(root, "stabletts")
        os.makedirs(corpus)
        meta = write_stabletts_corpus(corpus, n=BOOTSTRAP_UTTERANCES)
        bert_dir = os.path.join(root, "bert")
        write_bert(bert_dir, bert.BertConfig())
        full = stabletts.StableTTSConfig()
        cfg_json = {"data": {"training_files": meta, "n_spks": full.n_spks,
                             "mel_mean": full.mel_mean, "mel_std": full.mel_std},
                    "train": {"batch_size": BOOTSTRAP_BATCH}}
        stats = {d: stabletts_bootstrap.compute_stats(cfg_json, d) for d in (dev, "cpu")}
        rel = max(abs(stats[dev][k] - stats["cpu"][k]) / abs(stats["cpu"][k])
                  for k in ("mel_mean", "mel_std"))
        print(f"[tools bootstrap] stats over {BOOTSTRAP_UTTERANCES} wavs: card {stats[dev]}, "
              f"CPU {stats['cpu']}, {rel:.3e} relative (tol 1e-5)")
        check(rel <= 1e-5, f"[tools bootstrap] stats card vs CPU {rel:.3e}")
        _, mcfg, tcfg = run_stabletts.build_configs(cfg_json)
        check(mcfg == full, "[tools bootstrap] not StableTTSConfig()")
        model_dir = os.path.join(root, "stabletts_model")
        state = stabletts_train.init_train_state(mcfg, tcfg, seed=TOOLS_SEED + 6, device=dev)
        ckpt.save_full_state(model_dir, "STATE", 0, {**state.state_dict(), "epoch": 0})
        del state
        bert_fns = {d: run_stabletts.make_bert_fn(bert_dir, d) for d in (dev, "cpu")}
        expected = zeroed(all_kernels)
        t1 = time.perf_counter()
        written = stabletts_bootstrap.run_durations(cfg_json, model_dir, BOOTSTRAP_BATCH,
                                                    bert_fns[dev], device=dev)
        wall = time.perf_counter() - t1
        batches = -(-BOOTSTRAP_UTTERANCES // BOOTSTRAP_BATCH)
        out["durations"] = launches_now(all_kernels)
        expected |= {"global_attention_rope": 2 * mcfg.n_layers * batches, "mas": batches}
        print(f"[tools bootstrap] run_durations on the card ({wall:.1f} s, BERT rows included): "
              f"{written} .lab files; launches {out['durations']} (expected {expected})")
        check(written == BOOTSTRAP_UTTERANCES and out["durations"] == expected,
              "[tools bootstrap] durations: files or launches")
        # the card's paths scored under the CPU's log-prior against the CPU's own best paths
        dcfg = dataclasses.replace(run_stabletts.build_configs(cfg_json)[0], load_durations=False)
        ds = stabletts_data.StableTTSDataset(dcfg, bert_fn=bert_fns["cpu"])
        batcher = stabletts_data.StableBatcher(ds, BOOTSTRAP_BATCH)
        params = stabletts_bootstrap.load_tree(model_dir, mcfg, "cpu")
        worst, flipped = 0.0, 0
        for j in range(0, len(batcher.order), BOOTSTRAP_BATCH):
            idxs = batcher.order[j: j + BOOTSTRAP_BATCH]
            batch = to_device({k: v for k, v in batcher.collate(idxs).items() if k != "durations"},
                              "cpu")
            with torch.inference_mode():
                prior, mask = stabletts_bootstrap.mel_log_prior(params, mcfg, batch)
                best = mas.maximum_path(prior, mask)
            for row, i in enumerate(idxs):
                lab = stabletts_data.parse_lab(ds.items[i][0][:-4] + ".lab")
                nf, t = int(batch["mel_lengths"][row]), int(batch["x_lengths"][row])
                check(sum(lab) == nf and len(lab) == t, "[tools bootstrap] a .lab misses frames")
                frames = np.repeat(np.arange(t), lab)
                p = prior[row, :nf, :t].double().numpy()
                card = p[np.arange(nf), frames].sum()
                cpu = float((best[row, :nf, :t].double().numpy() * p).sum())
                flipped += int(not np.array_equal(best[row, :nf, :t].sum(0).int().numpy(), lab))
                worst = max(worst, abs(card - cpu) / abs(cpu))
        print(f"[tools bootstrap] the card's paths under the CPU's log-prior vs the CPU's best "
              f"paths: {worst:.3e} relative (tol 1e-5); {flipped} of {written} rows take another "
              f"path on the CPU; phase part {time.perf_counter() - t0:.1f} s; {smi}")
        check(worst <= 1e-5, f"[tools bootstrap] path scores differ by {worst:.3e}")
        del params, bert_fns

    # (e) the English G2P
    t0 = time.perf_counter()
    rows = list(R.synthetic_lexicon(G2P_WORDS, TOOLS_SEED + 7).items())
    phones = neural_g2p.phone_vocab()
    zeroed(all_kernels)
    losses, params = [], None
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _, params, epoch_losses in train_g2p.train(
            rows, phones, epochs=G2P_EPOCHS, batch=G2P_BATCH, lr=2e-3, device=dev,
            generator=torch.Generator().manual_seed(TOOLS_SEED)):
        losses += epoch_losses
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / len(losses)
    gen = torch.Generator().manual_seed(TOOLS_SEED)
    init = neural_g2p.init_params(gen, n_phones=len(phones))
    idx = torch.randperm(len(rows), generator=gen)[:G2P_BATCH].numpy()
    wid, pin, tgt = (torch.from_numpy(a[idx]) for a in train_g2p.pack(rows, phones))
    with torch.no_grad():
        cpu0 = float(train_g2p.loss_fn(init, wid, pin, tgt))
    first, last = losses[0], float(np.mean(losses[-16:]))
    print(f"[tools g2p] train at emb 128, encoder 128, decoder 256, batch {G2P_BATCH}: "
          f"{len(losses)} steps on {G2P_WORDS} words, {ms:.3f} ms a step (CUDA events, with "
          f"the host's epoch loop); loss {first:.4f} -> {last:.4f} (the last epoch's mean; must "
          f"halve); step 0 card {first:.6f} vs CPU {cpu0:.6f} ({abs(first - cpu0) / cpu0:.2e} "
          f"relative, tol 1e-4); launches {launches_now(all_kernels)}; {smi}")
    check(last <= 0.5 * first, f"[tools g2p] the loss fell {first} -> {last}, not by half")
    check(abs(first - cpu0) <= 1e-4 * cpu0, f"[tools g2p] step 0 card {first} vs CPU {cpu0}")
    with tempfile.TemporaryDirectory(prefix="g2p-") as d:
        np.savez(os.path.join(d, "g2p.npz"), **neural_g2p.flatten_for_npz(params, phones))
        g2p = neural_g2p.NeuralG2P(os.path.join(d, "g2p.npz"))
        words = [w for w, _ in rows[:200]]
        hits = sum(g2p.predict(w) == list(ph) for w, ph in rows[:200])
        check(all(p in phones for w in words for p in g2p.predict(w)),
              "[tools g2p] the artifact predicts phones outside the alphabet")
    print(f"[tools g2p] the exported artifact loads in NeuralG2P: {hits} of 200 training words "
          f"exact; {time.perf_counter() - t0:.1f} s")
    print(f"[tools] phase wall {time.perf_counter() - t_phase:.1f} s; {smi}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on the card",
              file=sys.stderr)
        return 1

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    full_float32()
    print(f"[device] {kind} x{count}; {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    print("[device] TF32 off for matmul and cuDNN convolutions (utils/precision.full_float32, "
          "as every entry point of the port sets it)")

    # 2. build; the f32 and the bf16 wrappers and the f32 global attention's
    # general route: every launch check below holds all eleven counts
    f32_kernels = {"banded_attention": fa.KERNEL, "ddsconv": ddf.KERNEL,
                   "global_attention_rope": fa.GLOBAL_ROPE_KERNEL,
                   "global_attention_packed": fa.GLOBAL_PACKED_KERNEL,
                   "global_attention": fa.GLOBAL_KERNEL}
    bf16_kernels = {"banded_attention_bf16": fa.KERNEL_BF16, "ddsconv_bf16": ddf.KERNEL_BF16,
                    "global_attention_rope_bf16": fa.GLOBAL_ROPE_KERNEL_BF16,
                    "global_attention_packed_bf16": fa.GLOBAL_PACKED_KERNEL_BF16,
                    "global_attention_bf16": fa.GLOBAL_KERNEL_BF16}
    kernels = {**f32_kernels, **bf16_kernels, "global_attention_general": fa.GLOBAL_GENERAL_KERNEL}
    t0 = time.perf_counter()
    cuda_build.build(list(kernels.values()) + [mas.KERNEL])
    print(f"[build] {len({k.source for k in kernels.values()}) + 1} sources for "
          f"{len(kernels) + 1} wrappers in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    for name, k in {**kernels, "mas": mas.KERNEL}.items():
        k.fn()
        log = k.library.with_suffix(".log")
        usage = [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln] \
            if log.exists() else []
        print(f"[build] {name}: {k.library.name} {'; '.join(usage)}")
    # MAS is a serial recurrence with no product: no tensor-core instruction to count
    for source in sorted({k.library for k in kernels.values()}):
        counts = tensor_core_instructions(source)
        if counts is None:
            print(f"[build] {source.name}: no cuobjdump; tensor-core instructions not counted")
            continue
        print(f"[build] {source.name}: SASS tensor-core instructions {counts} (bf16: those with "
              f"BF16 operands in the bf16 instantiations)")
        check(counts["HMMA"] + counts["HGMMA"] > 0, f"{source.name} has no tensor-core instruction")
        check(counts["bf16"]["HMMA"] + counts["bf16"]["HGMMA"] > 0,
              f"{source.name}'s bf16 symbols have no bf16 tensor-core instruction")
        if source == fa.GLOBAL_KERNEL_BF16.library:  # wgmma on tiles that TMA loads
            check(counts["bf16"]["HGMMA"] > 0 and counts["bf16"]["UTMALDG"] > 0,
                  f"global_attention_bf16 has no BF16 HGMMA or no UTMALDG: {counts['bf16']}")
            check(counts["tf32"]["HGMMA"] > 0 and counts["tf32"]["UTMALDG"] > 0,
                  f"global_attention_f32 has no TF32 HGMMA or no UTMALDG: {counts['tf32']}")

    # 3. kernels vs plain on the card
    att_tol, dds_tol = 1e-4, 1e-4
    # batched text (B16 T256) and flow (B16 T2048) shapes, then single-request
    # shapes: a 64-token text bucket, a 512-frame flow bucket, a ragged T=37
    att = [attention_case(16, 256, [256 - 9 * i for i in range(16)], 50, 20, 1),
           attention_case(16, 2048, [2048 - 97 * i for i in range(16)], 10, 3, 3),
           attention_case(1, 64, [53], 50, 20, 6),
           attention_case(1, 512, [437], 50, 20, 7),
           attention_case(1, 37, [37], 0, 0, 2)]
    # DDSConv: the batched text shape, the profiled request's 128-token text
    # bucket, a 64-token bucket, a ragged T=37
    dds = [ddsconv_case(16, 256, [256 - 13 * i for i in range(16)], 50, 20, 4),
           ddsconv_case(1, 128, [120], 50, 20, 9),
           ddsconv_case(1, 64, [53], 50, 20, 8),
           ddsconv_case(1, 37, [30], 0, 0, 5)]
    # the global kernel: the CFM decoder's batched shape (16 requests, CFG-doubled),
    # the text encoders' batched shape, single-request shapes (the decoder's
    # for one request of ~1436 frames: CFG-doubled, the 2048 frame bucket), a
    # ragged T=37, and the two d_rope = 0 forms (no path calls them)
    dec_lens = [2048 - 61 * i for i in range(16)] * 2
    glo = {"global_attention_rope": [
               global_case("rope", 32, 2048, 96, dec_lens, 10, 3, 11),
               global_case("rope", 16, 256, 64, [256 - 11 * i for i in range(16)], 50, 20, 12),
               global_case("rope", 2, 512, 96, [437, 437], 50, 20, 13),
               global_case("rope", 2, 2048, 96, [1436, 1436], 20, 5, 18),
               global_case("rope", 1, 64, 64, [53], 50, 20, 14),
               global_case("rope", 2, 37, 96, [37, 20], 0, 0, 15),
               # a view into wider rows, 16-byte aligned: TMA's edge of layouts
               global_case("strided", 2, 512, 96, [437, 300], 0, 0, 24)],
           "global_attention_packed": [global_case("packed", 16, 1024, 96,
                                                   [1024 - 41 * i for i in range(16)], 20, 5, 16),
                                       # the decoder's shape without RoPE: what the rotation costs
                                       global_case("packed", 32, 2048, 96, dec_lens, 10, 3, 19)],
           # kernel 5 at the windowless flow attention's shapes (C 96 = 2 heads
           # x 48: a batch of 16 at the 2048-frame bucket, one request), then
           # the DiT's width
           "global_attention": [global_case("separate", 16, 2048, 48,
                                            [2048 - 97 * i for i in range(16)], 10, 3, 20, h=2),
                                global_case("separate", 1, 397, 48, [355], 50, 20, 22, h=2),
                                global_case("separate", 16, 1024, 96,
                                            [1024 - 41 * i for i in range(16)], 20, 5, 17)]}
    glo_tol = 1e-4
    for name, shapes, tol in (("banded_attention", att, att_tol), ("ddsconv", dds, dds_tol),
                              *((n, c, glo_tol) for n, c in glo.items())):
        for c in shapes:
            print(f"[kernel] {name} {json.dumps(c)} tol {tol}")
            check(np.isfinite(c["max_abs_err"]) and c["max_abs_err"] <= tol,
                  f"{name} at {c['shape']} disagrees with its plain version: {c['max_abs_err']}")
            check(c.get("route", "tma") == "tma", f"{name} at {c['shape']} took the general route")

    # 3b. the bf16 kernels and bf16 serving (the JAX package's bench.py precision)
    bf16_cases, bf16_launches, bf16_check_launches = bf16_phase(kernels, smi)
    torch.cuda.empty_cache()

    # 4. the VITS2 main path at full width, then one request on the card and on the CPU
    cfg = vits2.VITS2Config()
    tree = perturb_zero_init(synthesizer_init(cfg, seed=SEED), seed=SEED + 1)
    launches = {}
    with tempfile.TemporaryDirectory(prefix="vits2-full-") as bundle:
        write_bundle(bundle, cfg, tree)
        del tree
        model = api.Model(bundle)
        check(model.device.type == "cuda", "Model() did not default to the card")
        for k in kernels.values():
            k.launches = 0
        calls, audios = main_path(model)
        got = {name: k.launches for name, k in kernels.items()}
        expected = {name: 0 for name in kernels} | {"banded_attention": 10 * calls,
                                                    "ddsconv": 4 * calls}
        print(f"[main] launches over {calls} synthesis calls: {got} (expected {expected})")
        check(got == expected, f"kernel launches {got} != {expected}")
        launches |= {n: got[n] for n in ("banded_attention", "ddsconv")}
        print(f"[main] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        synth = api.Synth(model)
        profile_requests([("synth_audio", lambda: synth.synth_audio(TEXTS[2])),
                          ("synth_batch16", lambda: synth.synth_batch(TEXTS))])
        cpu_model = api.Model(bundle, device="cpu")
        parity(model, cpu_model)

        # 4b. serving: the dynamic batcher at the server's defaults, then the wire
        reqs = serve_requests(32, cfg.n_speakers)
        serve_launches = serve_phase("serve", model, kernels, reqs, 16,
                                     {"banded_attention": 6, "ddsconv": 4}, {"banded_attention": 4},
                                     cfg.upsample_factor)
        serve_parity("serve", model, reqs[:4])
        missing = wire_missing()
        if not missing:
            serve_grpc(model, reqs[:4], cfg.upsample_factor)

        # 4c. VITS2 voice conversion: the banded attention in both flow directions
        longest, second = sorted(audios, key=len)[:0:-1]
        vc_launches, (t, t_short) = vits2_vc(model, cpu_model, kernels, longest, second)
        vc_case = attention_case(2, t, [t, t_short], 50, 20, 21)
        print(f"[kernel] banded_attention {json.dumps(vc_case)} tol {att_tol}")
        check(np.isfinite(vc_case["max_abs_err"]) and vc_case["max_abs_err"] <= att_tol,
              f"banded_attention at {vc_case['shape']} disagrees with its plain version")
        att.append(vc_case)
        del model, synth, cpu_model
    torch.cuda.empty_cache()

    # 5. the multistream_v3 main path at full width, then the card against the CPU
    with tempfile.TemporaryDirectory(prefix="ms-v3-full-") as bundle:
        t0 = time.perf_counter()
        write_ms_bundle(bundle)
        model = api.Model(bundle)
        print(f"[ms-main] full-width multistream_v3 bundle written and loaded in "
              f"{time.perf_counter() - t0:.1f} s")
        check(model.device.type == "cuda", "Model() did not default to the card")
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        calls = ms_main_path(model)
        got = {name: k.launches for name, k in kernels.items()}
        expected = {name: 0 for name in kernels} | {"global_attention_rope": 68 * calls}
        print(f"[ms-main] launches over {calls} synthesis calls: {got} (expected {expected})")
        check(got == expected, f"kernel launches {got} != {expected}")
        launches |= {n: got[n] for n in glo}
        print(f"[ms-main] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        synth = api.Synth(model)
        profile_requests([("ms synth_audio", lambda: synth.synth_audio(TEXTS[2])),
                          ("ms batch16", lambda: ms_batch(model, TEXTS, synth.generator))])
        ms_parity(model, api.Model(bundle, device="cpu"))

        # 5b. serving the multistream bundle: BERT in the client threads
        ms_reqs = serve_requests(8, model.model_config.n_spks)
        serve_launches |= {n: c for n, c in serve_phase(
            "ms-serve", model, kernels, ms_reqs, 8, {"global_attention_rope": 8},
            {"global_attention_rope": 60}, 256).items() if n in glo}
        serve_parity("ms-serve", model, ms_reqs[:4])
        if missing:
            print(f"[serve-grpc] not run: {missing[0]} is not installed")
        else:
            serve_grpc(model, ms_reqs[:1], 256)
        del model, synth
    torch.cuda.empty_cache()

    # 5c. the VITS2 variants at full width: kernel 5 on the windowless flow attention
    var_launches, var_vc_launches, (t, t_short) = variants_phase(kernels)
    launches["global_attention"] = var_launches["global_attention"]
    var_case = global_case("separate", 2, t, 48, [t, t_short], 50, 20, 23, h=2)
    print(f"[kernel] global_attention (variants vc) {json.dumps(var_case)} tol {glo_tol}")
    check(np.isfinite(var_case["max_abs_err"]) and var_case["max_abs_err"] <= glo_tol,
          f"global_attention at {var_case['shape']} disagrees with its plain version")
    check(var_case["route"] == "tma", f"global_attention at {var_case['shape']} took the "
          "general route")
    glo["global_attention"].append(var_case)

    # 5d. the multistream bundle with the Vocos and BigVGAN vocoders
    ms_vocoders_phase(kernels)
    torch.cuda.empty_cache()

    # 6. voice conversion: full-width ContentVec/HuBERT + QuickVC
    vc_phase(kernels)
    torch.cuda.empty_cache()

    # 7-8. zero-shot cloning: full-width GPT-SoVITS
    t0 = time.perf_counter()
    cfgs, trees = clone_models()
    print(f"[clone] full-width AR, SoVITS and HuBERT trees made in {time.perf_counter() - t0:.1f} s")
    clone_launches, clone_cases = clone_phase(kernels, cfgs, trees)
    for c in clone_cases:
        print(f"[kernel] banded_attention (clone) {json.dumps(c)} tol {att_tol}")
        check(np.isfinite(c["max_abs_err"]) and c["max_abs_err"] <= att_tol,
              f"banded_attention at {c['shape']} disagrees with its plain version")
    torch.cuda.empty_cache()
    long_launches = clone_long_phase(kernels, cfgs, trees)
    del cfgs, trees
    torch.cuda.empty_cache()

    # 9. VITS2 GAN training at full width
    train_launches, mas_cases = train_phase(kernels, smi)
    torch.cuda.empty_cache()

    # 14-15. every variant trains; the WavLM/SLM loss
    with tempfile.TemporaryDirectory(prefix="vits2-train-more-") as root:
        t0 = time.perf_counter()
        write_corpus(root)
        variant_mas, variant_serve = train_variants_phase(kernels, smi, root)
        print(f"[train-variants] wall {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        slm_mas = train_slm_phase(kernels, smi, root)
        print(f"[train-slm] wall {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # 10-11. StableTTS CFM training and QuickVC GAN training at full width
    train_stabletts_phase(kernels, smi)
    torch.cuda.empty_cache()
    train_vc_phase(kernels, smi)
    torch.cuda.empty_cache()

    # 12-13. GPT-SoVITS training at full width: S1 (the AR), S2 (SoVITS)
    train_s1_phase(kernels, smi)
    torch.cuda.empty_cache()
    s2_launches, s2_case = train_s2_phase(kernels, smi)
    print(f"[kernel] banded_attention (train-s2 decode) {json.dumps(s2_case)} tol {att_tol}")
    check(np.isfinite(s2_case["max_abs_err"]) and s2_case["max_abs_err"] <= att_tol,
          f"banded_attention at {s2_case['shape']} disagrees with its plain version")
    att.append(s2_case)
    torch.cuda.empty_cache()

    # 16-18. evaluation, Whisper content features, the GE2E speaker encoder
    eval_launches = eval_phase(kernels, smi)
    torch.cuda.empty_cache()
    whisper_phase(kernels, smi)
    ge2e_phase(kernels, smi)
    torch.cuda.empty_cache()

    # 19. data- and tensor-parallel training, synth_batch over two replicas
    dist_launches = dist_phase(kernels, smi)
    torch.cuda.empty_cache()

    # 20. the checkpoint converters and the data tools
    tools_launches = tools_phase(kernels, smi)
    torch.cuda.empty_cache()

    # the record: each kernel's largest batched shape, launches from its main path
    replaces = {"banded_attention": "vosk_tts_tpu/ops/flash_attention.py:56",
                "ddsconv": "vosk_tts_tpu/ops/ddsconv_fused.py:63",
                "global_attention_rope": "vosk_tts_tpu/ops/flash_attention.py:299",
                "global_attention_packed": "vosk_tts_tpu/ops/flash_attention.py:190",
                "global_attention": "vosk_tts_tpu/ops/flash_attention.py:190"}
    cases = {"banded_attention": att, "ddsconv": dds, **glo}
    main_case = {"banded_attention": att[1], "ddsconv": dds[0], **{n: c[0] for n, c in glo.items()}}
    notes = {"global_attention_rope": "library_ms: SDPA on q, k rotated beforehand (rotation "
                                      "not in its time)"}
    record = [{"name": name, "route": "cuda", "source": os.path.relpath(k.source, ROOT),
               "dtype": "float32",
               "replaces": replaces[name], "launches": launches[name],
               "serve_launches": serve_launches[name], "vc_launches": vc_launches[name],
               "variants_launches": var_launches[name],
               "variants_vc_launches": var_vc_launches[name],
               **({"train_s2_launches": s2_launches} if name == "banded_attention" else {}),
               "train_variants_serve_launches": variant_serve[name],
               "eval_launches": eval_launches[name],
               "dist_synth_launches": dist_launches.get(name, 0),
               "tools_demo_launches": tools_launches["demo"][name],
               "tools_convert_launches": tools_launches["convert"][name],
               "tools_durations_launches": tools_launches["durations"][name],
               "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
               **{key: main_case[name][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
               **{key: main_case[name][key] for key in ("graph_ms", "library_graph_ms")
                  if key in main_case[name]},
               "library_ms": main_case[name].get("library_ms"), "shape": main_case[name]["shape"],
               "bound_formula": BOUND_FORMULA,
               **({"note": notes[name]} if name in notes else {})}
              for name, k in f32_kernels.items()]
    # the bf16 wrappers: launches over the [bf16] phase's serving paths (kernel 4 has
    # none, as in f32: check_launches are its check's), numbers at the batched shape
    path = {"banded_attention_bf16": "VITS2Config() and pre_conv encode + decode, B16 x 3 buckets",
            "ddsconv_bf16": "VITS2Config() and pre_conv encode, B16 x 3 buckets",
            "global_attention_rope_bf16": "StableTTSConfig() encode + 10-step decode, B2",
            "global_attention_packed_bf16": "none (as kernel 4 in f32)",
            "global_attention_bf16": "pre_conv VITS2Config() decode, B16 x 3 buckets"}
    record += [{"name": name, "route": "cuda", "source": os.path.relpath(k.source, ROOT),
                "dtype": "bfloat16", "replaces": replaces[name[:-5]],
                "launches": bf16_launches[name], "check_launches": bf16_check_launches[name],
                "path": path[name],
                "max_abs_err": max(c["max_abs_err"] for c in bf16_cases[name]),
                "rel_err": max(c["rel_err"] for c in bf16_cases[name]),
                **{key: bf16_cases[name][0][key] for key in ("ms", "plain_ms", "bound_ms",
                                                             "bound_by")},
                **{key: bf16_cases[name][0][key] for key in ("graph_ms", "library_graph_ms")
                   if key in bf16_cases[name][0]},
                "library_ms": bf16_cases[name][0].get("library_ms"),
                "shape": bf16_cases[name][0]["shape"], "bound_formula": BF16_BOUND_FORMULA,
                **({"note": notes[name[:-5]]} if name[:-5] in notes else {})}
               for name, k in bf16_kernels.items()]
    # kernel 1 at the clone shapes (the SSL encoders' 2 x 512 codes, a 128-phone text)
    record += [{"name": "banded_attention", "route": "cuda", "source": record[0]["source"],
                "replaces": replaces["banded_attention"], "launches": clone_launches,
                "clone_long_launches": long_launches, "max_abs_err": c["max_abs_err"],
                **{key: c[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
                "library_ms": None, "shape": c["shape"], "path": "clone",
                "bound_formula": BOUND_FORMULA} for c in clone_cases[:2]]
    # the port's own kernel (no Pallas counterpart): MAS at the training step's shape
    record.append({"name": "mas", "route": "cuda",
                   "source": os.path.relpath(mas.KERNEL.source, ROOT),
                   "replaces": "vosk_tts_tpu/ops/mas.py:24", "launches": train_launches,
                   "train_variants_launches": variant_mas, "train_slm_launches": slm_mas,
                   "dist_launches": dist_launches["mas"],
                   "tools_durations_launches": tools_launches["durations"]["mas"],
                   "max_abs_err": max(c["max_abs_err"] for c in mas_cases),
                   **{key: mas_cases[0][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
                   "library_ms": None, "shape": mas_cases[0]["shape"], "path": "train",
                   "bound_formula": BOUND_FORMULA,
                   "note": "the JAX package's MAS is a lax.scan wavefront, not a Pallas kernel; "
                           "no PyTorch call computes MAS"})
    print(json.dumps({"kernels": record}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--dist-rank":  # a rank of [dist] (a) and (c)
        sys.exit(dist_rank(int(sys.argv[2]), sys.argv[sys.argv.index("--dist-root") + 1]))
    sys.exit(main())
