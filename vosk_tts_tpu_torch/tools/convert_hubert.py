"""Convert an HF HuBERT/ContentVec checkpoint directory into a bundle
(tools/convert_hubert.py of the JAX package), without ``transformers``.

Usage:
  python -m vosk_tts_tpu_torch.tools.convert_hubert HF_MODEL_DIR OUT_DIR

HF_MODEL_DIR holds ``config.json`` and ``model.safetensors`` or
``pytorch_model.bin`` (a local snapshot of lengyue233/content-vec-best,
say). OUT_DIR gets ``params.npz`` (the bundle layout; the positional conv's
weight norm folded) and the HF config dict as ``config.json``, which
``HubertConfig.from_hf`` reads back. Host code: no device.
"""

import argparse
import json
import os

from ..utils.precision import full_float32


def main(argv=None):
    full_float32()
    ap = argparse.ArgumentParser()
    ap.add_argument("src")
    ap.add_argument("out")
    args = ap.parse_args(argv)

    from ..models.hubert import HubertConfig, hubert_from_state_dict
    from ..utils.checkpoint import save_params
    from ..utils.torch_params import read_state_dict

    with open(os.path.join(args.src, "config.json"), encoding="utf-8") as f:
        hf = json.load(f)
    cfg = HubertConfig.from_hf(hf)
    weights = next((os.path.join(args.src, n) for n in ("model.safetensors", "pytorch_model.bin")
                    if os.path.exists(os.path.join(args.src, n))), None)
    if weights is None:
        raise FileNotFoundError(f"{args.src}: no model.safetensors or pytorch_model.bin")
    params = hubert_from_state_dict(read_state_dict(weights), cfg)
    os.makedirs(args.out, exist_ok=True)
    save_params(os.path.join(args.out, "params.npz"), params)
    with open(os.path.join(args.out, "config.json"), "w", encoding="utf-8") as f:
        json.dump(hf, f)
    print(f"converted {weights} -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
