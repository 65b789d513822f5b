"""Train the GE2E LSTM speaker embedder on the synthetic multi-voice corpus
and write its artifact (tools/train_speaker_embedder.py of the JAX package;
eval/speaker_train.py says what it is and is not), then check it on two
held-out voices.

Usage:
  python -m vosk_tts_tpu_torch.tools.train_speaker_embedder [--steps 400] [--seed 0] \
      [--out PATH] [--device cpu]

Without ``--out`` it overwrites the committed artifact
(vosk_tts_tpu_torch/eval/data/speaker_encoder.npz).
"""

import argparse

from ..utils.precision import full_float32


def main(argv=None):
    full_float32()
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    import numpy as np

    from ..api import resolve_device
    from ..eval import speaker_train as ST
    from ..eval.harness import speaker_similarity

    device = resolve_device(args.device)
    params, extra = ST.train_speaker_encoder(args.seed, steps=args.steps, device=device,
                                             log=lambda m: print(m, flush=True))
    out = args.out or ST.ARTIFACT
    ST.save_artifact(out, params, extra)
    print(f"wrote {out} (final ge2e loss {extra['loss']:.4f})")

    # quick self-check: same-voice vs cross-voice margin on held-out voices
    rng = np.random.default_rng(12345)
    emb = ST.lstm_embedder(params, device=device)
    va, vb = ST.synthetic_voice(rng), ST.synthetic_voice(rng)
    a = [ST.synthetic_utterance(rng, va) for _ in range(3)]
    b = [ST.synthetic_utterance(rng, vb) for _ in range(3)]
    same = speaker_similarity([(a[0], a[1]), (a[1], a[2]), (b[0], b[1])], embedder=emb)
    cross = speaker_similarity([(a[0], b[0]), (a[1], b[1]), (a[2], b[2])], embedder=emb)
    print(f"held-out same {same.value:.3f} cross {cross.value:.3f}")
    return out, extra, same.value, cross.value


if __name__ == "__main__":
    main()
