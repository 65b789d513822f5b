"""Evaluation harness (vosk_tts_tpu/eval; the extra/tts-test and
training/vits2/eval.py analogue): synthesis and RTF drivers, speaker
similarity, WER, UTMOS and FAD protocols with pluggable scorers, the
MFCC+F0 signature and the GE2E-trained LSTM speaker embedder."""

from .harness import (EvalResult, batch_synthesize, eval_rtf, eval_utmos,
                      frechet_audio_distance, speaker_similarity,
                      transcribe_wer)
from .speaker_embed import mfcc_f0_embedding
