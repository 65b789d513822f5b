"""Offline ContentVec encoding of a voice-conversion dataset
(tools/vc_encode_dataset.py of the JAX package; the reference's
vc/encode.py): ``<wav>.cv.npy`` (frames, hidden) beside each 16 kHz wav,
the features ``train/run_vc`` reads.

Usage:
  python -m vosk_tts_tpu_torch.tools.vc_encode_dataset HUBERT_BUNDLE WAV_DIR [--device cpu]

HUBERT_BUNDLE is a directory with ``params.npz`` and ``config.json`` (a
converted HF HuBERT, ``convert_hubert``). Existing ``.cv.npy`` files are
kept. HuBERT runs on the card unless ``--device cpu`` is given.
"""

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("bundle")
    ap.add_argument("wav_dir")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..api import resolve_device
    from ..models.hubert import load_bundle
    from ..train.data import load_wav

    device = resolve_device(args.device)
    hubert = load_bundle(args.bundle, device)
    written = []
    for name in sorted(os.listdir(args.wav_dir)):
        if not name.endswith(".wav"):
            continue
        path = os.path.join(args.wav_dir, name)
        out = path[:-4] + ".cv.npy"
        if os.path.exists(out):
            continue
        wav, sr = load_wav(path)
        if sr != 16000:
            raise ValueError(f"{path}: expected 16 kHz, got {sr}")
        with torch.inference_mode():
            feats = hubert(torch.from_numpy(wav / 32768.0).to(device)[None])[0].cpu().numpy()
        np.save(out, feats)
        written.append(out)
        print(f"{name}: {feats.shape}")
    return written


if __name__ == "__main__":
    main()
