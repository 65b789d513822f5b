"""The converters and data tools of the port on the card.

Marked ``cuda``: each test skips where there is no NVIDIA GPU. This file
imports no JAX, so on a machine with the card and without JAX it runs as
``python -m pytest tests/test_torch_cuda_tools.py -m cuda --noconftest``.
TF32 is off (f32 on both sides, other summation orders). Small widths;
chip_smoke.py's ``[tools]`` runs the same at full width.

* ``make_demo_bundle``'s small bundle loads on the card without a device
  argument, a request launches the banded-attention and DDSConv kernels
  as often as chip_smoke's ``per_synthesis_call`` counts (4 DDSConv),
  and chip_smoke's ``parity`` holds it to the CPU (m_p, logs_p 1e-3, the
  waveform 1e-3 x peak on the card's durations);
* a reference ``G_7.pth`` (weight-norm pairs split) through
  ``convert_checkpoint``: served on the card with the same launches, its
  int16 waveform within 1 step of the source bundle's on the source's
  durations at noise 0;
* an HF HuBERT directory as ``pytorch_model.bin`` and ``model.safetensors``
  through ``convert_hubert``: equal bundles; ``vc_encode_dataset`` and
  ``gpt_sovits_prepare`` on the card against the CPU, features 1e-3 x peak
  and equal codes.
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke
import torch_ref_layout as R
from vosk_tts_tpu_torch import api
from vosk_tts_tpu_torch.models import gpt_sovits, hubert, vits2
from vosk_tts_tpu_torch.ops import ddsconv_fused as ddf
from vosk_tts_tpu_torch.ops import flash_attention as fa
from vosk_tts_tpu_torch.tools import (convert_checkpoint, convert_hubert, gpt_sovits_prepare,
                                      make_demo_bundle, vc_encode_dataset)
from vosk_tts_tpu_torch.utils.checkpoint import load_params, save_params
from vosk_tts_tpu_torch.utils.params import (hubert_init, perturb_zero_init, sovits_init,
                                             synthesizer_init)

pytestmark = pytest.mark.cuda

TEXT = "Сегодня хорошая погода, и мы идём гулять в парк."
VITS2_CFG = dict(inter_channels=32, hidden_channels=64, filter_channels=128, n_layers=2,
                 upsample_initial_channel=64, n_speakers=4, gin_channels=16, spec_channels=13)
HUBERT_HF = {"model_type": "hubert", "conv_dim": [64] * 7, "conv_kernel": [10, 3, 3, 3, 3, 2, 2],
             "conv_stride": [5, 2, 2, 2, 2, 2, 2], "hidden_size": 64, "num_hidden_layers": 2,
             "num_attention_heads": 4, "intermediate_size": 128, "num_conv_pos_embeddings": 32,
             "num_conv_pos_embedding_groups": 4, "layer_norm_eps": 1e-5,
             "feat_extract_norm": "group", "do_stable_layer_norm": False}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _served_launches(model):
    """One request's launches of kernels 1 and 2, and chip_smoke's count
    for the bundle's configuration."""
    fa.KERNEL.launches = ddf.KERNEL.launches = 0
    wav = api.Synth(model).synth_audio(TEXT)
    assert wav.dtype == np.int16 and len(wav) > 0 and np.any(wav != 0)
    want = chip_smoke.per_synthesis_call(model.model_config)
    return (fa.KERNEL.launches, ddf.KERNEL.launches), (want["banded_attention"], want["ddsconv"])


def test_demo_bundle_on_the_card(dev, tmp_path):
    make_demo_bundle.main([str(tmp_path / "demo")])
    model = api.Model(tmp_path / "demo")
    assert model.device.type == "cuda"
    got, want = _served_launches(model)
    assert got == want and got[1] == 4
    chip_smoke.parity(model, api.Model(tmp_path / "demo", device="cpu"), tag="demo parity")


def test_converted_checkpoint_on_the_card(dev, tmp_path):
    cfg = vits2.VITS2Config(**VITS2_CFG)
    tree = perturb_zero_init(synthesizer_init(cfg, seed=0), seed=1)
    sd = R.vits2_state_dict(tree, cfg)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}, "iteration": 7},
               tmp_path / "G_7.pth")
    (tmp_path / "ref.json").write_text(json.dumps(R.vits2_reference_config(cfg)))
    convert_checkpoint.main([str(tmp_path / "G_7.pth"), str(tmp_path / "ref.json"),
                             str(tmp_path / "converted")])
    (tmp_path / "source").mkdir()
    chip_smoke.write_bundle(str(tmp_path / "source"), cfg, tree)
    converted, source = api.Model(tmp_path / "converted"), api.Model(tmp_path / "source")
    got, want = _served_launches(converted)
    assert got == want and got[1] == 4
    a, b = chip_smoke.fed_int16([source, converted], TEXT)
    assert len(a) == len(b) and int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max()) <= 1


def test_hubert_tools_on_the_card(dev, tmp_path):
    tree = hubert_init(hubert.HubertConfig.from_hf(HUBERT_HF), seed=2)
    sd = R.hubert_state_dict(tree, "parametrizations")
    for name in ("bin", "st"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "config.json").write_text(json.dumps(HUBERT_HF))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "bin" / "pytorch_model.bin")
    R.write_safetensors(tmp_path / "st" / "model.safetensors", sd)
    convert_hubert.main([str(tmp_path / "bin"), str(tmp_path / "hubert")])
    convert_hubert.main([str(tmp_path / "st"), str(tmp_path / "hubert_st")])
    a, b = (load_params(tmp_path / d / "params.npz") for d in ("hubert", "hubert_st"))
    assert all(np.array_equal(x, y) for x, y in zip(chip_smoke.tree_leaves(a),
                                                     chip_smoke.tree_leaves(b)))

    sovits = gpt_sovits.SoVITSConfig(ssl_dim=64, n_codes=32, hidden_channels=32, inter_channels=32,
                                     filter_channels=64, spec_channels=13, gin_channels=16,
                                     upsample_initial_channel=32, n_symbols=20, mrte_hidden=32,
                                     style_hidden=16)
    save_params(tmp_path / "sovits.npz", sovits_init(sovits, seed=3))
    rng = np.random.default_rng(4)
    for side in ("card", "cpu"):
        (tmp_path / side).mkdir()
    for i, seconds in enumerate((1.0, 2.5)):
        chip_smoke.write_voice(str(tmp_path / "card" / f"w{i}.wav"), rng, int(seconds * 16000), 16000)
        (tmp_path / "cpu" / f"w{i}.wav").write_bytes((tmp_path / "card" / f"w{i}.wav").read_bytes())
    for side, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        vc_encode_dataset.main([str(tmp_path / "hubert"), str(tmp_path / side), *extra])
        gpt_sovits_prepare.main([str(tmp_path / "hubert"), str(tmp_path / "sovits.npz"),
                                 str(tmp_path / side), str(tmp_path / f"{side}.tsv"), *extra])
    for i in range(2):
        for ext in (".cv.npy", ".ssl.npy"):
            g, c = (np.load(tmp_path / side / f"w{i}{ext}") for side in ("card", "cpu"))
            assert g.shape == c.shape
            assert float(np.abs(g - c).max()) <= 1e-3 * float(np.abs(c).max())
    assert (tmp_path / "card.tsv").read_text() == (tmp_path / "cpu.tsv").read_text()
