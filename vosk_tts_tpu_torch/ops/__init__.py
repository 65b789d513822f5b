"""Ops of the port: plain PyTorch tensor functions over channels-last
(B, T, C) activations, plus the wrappers of the hand-written CUDA kernels
(flash_attention, ddsconv_fused)."""
