"""Convert a reference torch checkpoint (``G_*.pth``) into a bundle
(tools/convert_checkpoint.py of the JAX package).

Usage:
  python -m vosk_tts_tpu_torch.tools.convert_checkpoint G_1000.pth config.json OUT_DIR \
      [--family vits2|quickvc|sovits] [--dictionary PATH]

``config.json`` is the reference training config (for VITS2
training/vits2/configs/mb_istft_vits2_multi.json: its model, data and
train blocks give the ``VITS2Config``; QuickVC and SoVITS take their
default configs and the data block's sampling rate). Weight norm is folded
and layouts are transposed to the bundle layout (utils/torch_params.py);
the bundle is ``params.npz``, ``config.json`` (model_type, sample_rate,
phoneme_id_map, inference, model) and the copied dictionary. The
checkpoint is read with ``weights_only=True``. Host code: no device.
"""

import argparse
import dataclasses
import json
import os
import shutil

from ..utils.precision import full_float32


def main(argv=None):
    full_float32()
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint")
    ap.add_argument("config")
    ap.add_argument("out")
    ap.add_argument("--dictionary", default=None)
    ap.add_argument("--family", default="vits2", choices=("vits2", "quickvc", "sovits"),
                    help="reference checkpoint family (G_*.pth of training/vits2, vc/, or "
                         "gpt-sovits stage 2)")
    args = ap.parse_args(argv)

    from ..text import plain_symbol_map
    from ..utils import torch_params as TP
    from ..utils.checkpoint import save_params

    sd = TP.read_state_dict(args.checkpoint)
    with open(args.config, encoding="utf-8") as f:
        ref = json.load(f)
    if args.family == "quickvc":
        from ..models.quickvc import QuickVCConfig

        cfg = QuickVCConfig()
        params = TP.quickvc_from_state_dict(sd, cfg)
    elif args.family == "sovits":
        from ..models.gpt_sovits import SoVITSConfig

        cfg = SoVITSConfig()
        params = TP.sovits_from_state_dict(sd, cfg)
    else:
        from ..models.vits2 import VITS2Config

        cfg = VITS2Config.from_reference_json(ref["model"], ref.get("data"), ref.get("train"))
        params = TP.vits2_from_state_dict(sd, cfg)

    os.makedirs(args.out, exist_ok=True)
    save_params(os.path.join(args.out, "params.npz"), params)
    out_cfg = {
        "model_type": args.family,
        "sample_rate": ref.get("data", {}).get("sampling_rate", 22050),
        "phoneme_id_map": {k: [v] for k, v in plain_symbol_map().items()},
        "inference": {"noise_level": 0.8, "speech_rate": 1.0, "duration_noise_level": 0.8},
        "model": dataclasses.asdict(cfg),
    }
    with open(os.path.join(args.out, "config.json"), "w", encoding="utf-8") as f:
        json.dump(out_cfg, f, ensure_ascii=False, indent=1)
    if args.dictionary:
        shutil.copy(args.dictionary, os.path.join(args.out, "dictionary"))
    print(f"converted {args.checkpoint} -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
