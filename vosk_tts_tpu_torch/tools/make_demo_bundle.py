"""Create a VITS2 bundle with random weights (tools/make_demo_bundle.py of
the JAX package): drives the whole pipeline (frontend -> synthesis -> wav)
where no trained checkpoint is at hand. Trained reference checkpoints
convert into the same layout (``convert_checkpoint``).

Usage:
  python -m vosk_tts_tpu_torch.tools.make_demo_bundle OUT_DIR [--full] [--seed N]

``--full``: the shipped MB-iSTFT-VITS2 architecture (``VITS2Config()``);
default a small one. Weights come from ``utils/params.synthesizer_init``
(numpy, seeded; jax.random draws other numbers, so the values differ from
the JAX tool's while every leaf path and shape and the ``config.json`` are
the same). Host code: no device.
"""

import argparse
import dataclasses
import json
import os

from ..utils.precision import full_float32


def small_config():
    from ..models.vits2 import VITS2Config

    return VITS2Config(inter_channels=96, hidden_channels=96, filter_channels=384, n_layers=4,
                       upsample_initial_channel=256, n_speakers=5, gin_channels=128)


def main(argv=None):
    full_float32()
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from ..models.vits2 import VITS2Config
    from ..text import plain_symbol_map
    from ..utils.checkpoint import save_params
    from ..utils.params import synthesizer_init

    cfg = VITS2Config() if args.full else small_config()
    os.makedirs(args.out, exist_ok=True)
    save_params(os.path.join(args.out, "params.npz"), synthesizer_init(cfg, seed=args.seed))
    config = {
        "model_type": "vits2",
        "sample_rate": 22050,
        "phoneme_id_map": {k: [v] for k, v in plain_symbol_map().items()},
        "inference": {"noise_level": 0.8, "speech_rate": 1.0, "duration_noise_level": 0.8},
        "model": dataclasses.asdict(cfg),
    }
    with open(os.path.join(args.out, "config.json"), "w", encoding="utf-8") as f:
        json.dump(config, f, ensure_ascii=False, indent=1)
    # a tiny dictionary, so that the G2P fallback runs for unseen words
    with open(os.path.join(args.out, "dictionary"), "w", encoding="utf-8") as f:
        f.write("привет 1.0 p rj i0 vj e1 t\nмир 1.0 mj i1 r\n")
    print(f"bundle written to {args.out}")
    return args.out


if __name__ == "__main__":
    main()
