"""GPT-SoVITS dataset preparation: SSL features and semantic codes
(tools/gpt_sovits_prepare.py of the JAX package; the reference's
prepare_datasets/2-get-hubert-vosk.py and 3-get-semantic-vosk.py).

Usage:
  python -m vosk_tts_tpu_torch.tools.gpt_sovits_prepare HUBERT_BUNDLE SOVITS_NPZ WAV_DIR \
      OUT_TSV [--device cpu]

For each 16 kHz wav of WAV_DIR (sorted): the ContentVec features as
``<wav>.ssl.npy`` (frames, 768), and a line ``name<TAB>codes`` of OUT_TSV,
the codes being ``sovits_extract_latent`` of those features with the
SoVITS tree of SOVITS_NPZ (bundle layout, ``SoVITSConfig()``; only its
``ssl_proj`` and ``codebook`` are read). Runs on the card unless
``--device cpu`` is given.
"""

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("hubert_bundle")
    ap.add_argument("sovits_npz")
    ap.add_argument("wav_dir")
    ap.add_argument("out_tsv")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..api import resolve_device
    from ..models import gpt_sovits as G
    from ..models.hubert import load_bundle
    from ..train.data import load_wav
    from ..utils.checkpoint import load_params
    from ..utils.params import to_port_layout, to_torch

    device = resolve_device(args.device)
    hubert = load_bundle(args.hubert_bundle, device)
    tree = load_params(args.sovits_npz)
    s_params = to_torch(to_port_layout({k: tree[k] for k in ("ssl_proj", "codebook")}), device)
    s_cfg = G.SoVITSConfig()
    lines = []
    with open(args.out_tsv, "w", encoding="utf-8") as f:
        for name in sorted(os.listdir(args.wav_dir)):
            if not name.endswith(".wav"):
                continue
            path = os.path.join(args.wav_dir, name)
            wav, sr = load_wav(path)
            if sr != 16000:
                raise ValueError(f"{path}: expected 16 kHz, got {sr}")
            with torch.inference_mode():
                ssl = hubert(torch.from_numpy(wav / 32768.0).to(device)[None])
                codes = G.sovits_extract_latent(s_params, s_cfg, ssl)[0].cpu().numpy()
            np.save(path[:-4] + ".ssl.npy", ssl[0].cpu().numpy())
            lines.append(name[:-4] + "\t" + " ".join(map(str, codes.tolist())))
            f.write(lines[-1] + "\n")
            print(f"{name}: {len(codes)} codes")
    return lines


if __name__ == "__main__":
    main()
