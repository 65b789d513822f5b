"""The port's float32 precision on the card.

torch runs a float32 cuDNN convolution in TF32 unless told otherwise
(``torch.backends.cudnn.allow_tf32`` defaults to True): about three decimal
digits, where the JAX package computes float32. Every entry point of the
port (``api.Model``, the CLI, the gRPC server, the training drivers, the
tools, each rank of ``parallel``) calls :func:`full_float32` first, so that
what users run is the float32 the tests hold to the JAX package. bf16
serving is unaffected: a bf16 tree runs bf16 products either way.
"""

from __future__ import annotations

import torch


def full_float32() -> None:
    """Turn TF32 off for cuDNN convolutions and for matmuls (process-wide)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
