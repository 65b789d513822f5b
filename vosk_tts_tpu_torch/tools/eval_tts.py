"""End-to-end TTS evaluation (tools/eval_tts.py of the JAX package; the
reference's training/vits2/eval.py).

Synthesizes a text list with a bundle, reports RTF and throughput,
optionally the speaker similarity against reference WAVs of the same names
(the default GE2E embedder, on the same device) and the WER through an ASR
command; prints one JSON line.

Usage:
  python -m vosk_tts_tpu_torch.tools.eval_tts BUNDLE --texts texts.txt --out OUT_DIR \
      [--speakers 0,1,2] [--ref-dir REF_WAVS] [--asr-cmd "..."] [--device cpu]
"""

import argparse
import json
import os

from ..utils.precision import full_float32


def main(argv=None):
    full_float32()
    ap = argparse.ArgumentParser()
    ap.add_argument("bundle")
    ap.add_argument("--texts", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--speakers", default="0")
    ap.add_argument("--ref-dir", default=None)
    ap.add_argument("--asr-cmd", default=None,
                    help="shell command, gets wav path appended, prints transcript")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    from ..api import Model, Synth
    from ..eval import batch_synthesize, eval_rtf, speaker_similarity
    from ..eval.harness import transcribe_wer
    from ..train.data import load_wav

    with open(args.texts, encoding="utf-8") as f:
        texts = [line.strip() for line in f if line.strip()]
    model = Model(model_path=args.bundle, device=args.device)
    synth = Synth(model)
    speakers = [int(s) for s in args.speakers.split(",")]

    results = {}
    rtf = eval_rtf(synth, texts, speaker_id=speakers[0])
    results["rtf"] = rtf.value
    results.update({f"rtf_{k}": v for k, v in rtf.extra.items()})

    paths = batch_synthesize(synth, texts, args.out, speakers=speakers)
    results["n_wavs"] = len(paths)

    if args.ref_dir:
        pairs = []
        for p in paths:
            ref = os.path.join(args.ref_dir, os.path.basename(p))
            if os.path.exists(ref):
                g, _ = load_wav(p)
                r, _ = load_wav(ref)
                pairs.append((g / 32768.0, r / 32768.0))
        if pairs:
            sim = speaker_similarity(pairs, sample_rate=model.sample_rate, device=model.device)
            results["speaker_similarity_avg"] = sim.value
            results["speaker_similarity_min"] = sim.extra["min"]

    if args.asr_cmd:
        import subprocess

        def asr(path):
            return subprocess.run(args.asr_cmd.split() + [path], capture_output=True,
                                  text=True, timeout=300).stdout.strip()

        wer = transcribe_wer(paths[: len(texts)], texts, asr)
        results["wer"] = wer.value

    print(json.dumps(results, ensure_ascii=False))
    return results


if __name__ == "__main__":
    main()
