"""vosk_tts_tpu_torch: the PyTorch/CUDA port of vosk_tts_tpu.

It imports torch, numpy and scipy, never JAX or the JAX package. Its CUDA
kernels (csrc/) are built with nvcc at first use on the card; on the CPU
every kernel's plain PyTorch version runs instead."""

__version__ = "0.1.0"
