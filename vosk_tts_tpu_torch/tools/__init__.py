"""Command-line tools of the port, run as ``python -m
vosk_tts_tpu_torch.tools.<name>``: ``eval_tts`` (RTF, speaker similarity,
WER of a bundle), ``build_examples`` (multi-voice smoke synthesis) and
``train_speaker_embedder`` (the GE2E speaker-encoder artifact). Each runs
on the card unless ``--device cpu`` is given."""
