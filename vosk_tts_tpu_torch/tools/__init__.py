"""Command-line tools of the port, run as ``python -m
vosk_tts_tpu_torch.tools.<name>``: ``eval_tts`` (RTF, speaker similarity,
WER of a bundle), ``build_examples`` (multi-voice smoke synthesis),
``train_speaker_embedder`` (the GE2E speaker-encoder artifact), the
converters ``convert_checkpoint`` (a reference VITS2, QuickVC or SoVITS
``G_*.pth``), ``convert_hubert`` (an HF HuBERT/ContentVec directory) and
``make_demo_bundle`` (a random-weight VITS2 bundle), the data tools
``vc_encode_dataset`` (``.cv.npy`` ContentVec features),
``gpt_sovits_prepare`` (``.ssl.npy`` features and ``semantic.tsv`` codes)
and ``stabletts_bootstrap`` (mel statistics, MAS ``.lab`` durations), and
the English G2P's ``train_g2p`` and ``lts_error_analysis``. The tools that
run a model run on the card unless ``--device cpu`` is given; the
converters and the error analysis are host code."""
