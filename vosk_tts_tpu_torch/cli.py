"""Console entry point of the port (vosk_tts_tpu/cli.py flags). Runs on
the card."""

from __future__ import annotations

import argparse
import logging
import sys

from .utils.precision import full_float32


def build_parser():
    p = argparse.ArgumentParser(description="Synthesize input (PyTorch/CUDA vosk-tts)")
    p.add_argument("--model", "-m", type=str, help="model path")
    p.add_argument("--list-models", default=False, action="store_true", help="list available models")
    p.add_argument("--list-languages", default=False, action="store_true", help="list available languages")
    p.add_argument("--model-name", "-n", type=str, help="select model by name")
    p.add_argument("--lang", "-l", default="ru", type=str, help="select model by language")
    p.add_argument("--input", "-i", type=str, help="input string")
    p.add_argument("--speaker", "-s", type=int, help="speaker id for multispeaker model")
    p.add_argument("--speech-rate", "-r", type=float, default=1.0, help="speech rate of the synthesis")
    p.add_argument("--output", "-o", default="out.wav", type=str, help="output filename path")
    p.add_argument("--log-level", default="INFO", help="logging level")
    return p


def main(argv=None):
    full_float32()
    args = build_parser().parse_args(argv)
    logging.getLogger().setLevel(args.log_level.upper())

    from .api import Model, Synth, list_languages, list_models

    if args.list_models:
        list_models()
        return
    if args.list_languages:
        list_languages()
        return
    if not args.input:
        logging.info("Please specify input text or file")
        sys.exit(1)

    model = Model(args.model, args.model_name, args.lang)
    Synth(model).synth(args.input, args.output, args.speaker, speech_rate=args.speech_rate)


if __name__ == "__main__":
    main()
