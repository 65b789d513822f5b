"""Multi-voice smoke synthesis (tools/build_examples.py of the JAX package;
the reference's extra/build-examples.sh): one text in each speaker's voice
to OUT_DIR/spk{sid}_0000.wav; prints the paths.

Usage:
  python -m vosk_tts_tpu_torch.tools.build_examples BUNDLE_DIR OUT_DIR \
      [--speakers 0,1,2,3,4] [--text TEXT] [--device cpu]
"""

import argparse

from ..utils.precision import full_float32

TEXT = "Добрый день, это проверка синтеза речи. Сегодня хорошая погода!"


def main(argv=None):
    full_float32()
    ap = argparse.ArgumentParser()
    ap.add_argument("bundle")
    ap.add_argument("out")
    ap.add_argument("--speakers", default="0,1,2,3,4")
    ap.add_argument("--text", default=TEXT)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    from ..api import Model, Synth
    from ..eval import batch_synthesize

    model = Model(model_path=args.bundle, device=args.device)
    synth = Synth(model)
    speakers = [int(s) for s in args.speakers.split(",")]
    paths = batch_synthesize(synth, [args.text], args.out, speakers=speakers)
    print("\n".join(paths))
    return paths


if __name__ == "__main__":
    main()
