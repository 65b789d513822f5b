"""Banded relative-position attention: the CUDA kernel's wrapper and its
plain PyTorch version.

Port of vosk_tts_tpu/ops/flash_attention.py::banded_flash_attention (the
Pallas ``_kernel``). Semantics, for q pre-scaled by D^-1/2:

  s[i,j] = q[i].k[j] + [|j-i| <= w] q[i].rel_k[j-i+w]
  s[i,j] = -1e4                                   for j >= kv_len
  p      = softmax_j(s)
  out[i] = sum_j p[i,j] v[j] + sum_{|j-i|<=w} p[i,j] rel_v[j-i+w]

Only keys are masked: a row at or past kv_len still attends to the valid
keys (the caller masks those rows). The XLA path of ``mha_apply`` spreads
such rows uniformly instead, so compare valid rows against it.

The kernel (csrc/banded_attention.cu) takes any T >= 1; the 128-multiple
length gate, the 128-lane D pad and the 128-row band pad of the TPU
version are TPU layouts and are not carried over.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import CudaKernel, I, P

MASK_VALUE = -1e4  # the reference masks with -1e4, not -inf

KERNEL = CudaKernel("banded_attention.cu", "banded_attention_f32",
                    [P, P, P, P, P, P, P, I, I, I, I, I, I, P])


def banded_attention_plain(q, k, v, rel_k, rel_v, kv_len, *, window: int):
    """The plain version: materializes the (B, H, T, T) scores."""
    b, h, t, d = q.shape
    rel_k = rel_k.expand(h, -1, -1) if rel_k.shape[0] == 1 else rel_k
    rel_v = rel_v.expand(h, -1, -1) if rel_v.shape[0] == 1 else rel_v
    scores = torch.matmul(q, k.transpose(-1, -2))
    band = torch.einsum("bhld,hmd->bhlm", q, rel_k)  # (B, H, T, 2w+1)
    for m in range(2 * window + 1):
        off = m - window
        if abs(off) >= t:
            continue
        diag = scores.diagonal(off, -2, -1)  # view: (i, i+off)
        diag += band[..., :t - off, m] if off >= 0 else band[..., -off:, m]
    keys = torch.arange(t, device=q.device)
    scores = scores.masked_fill(keys[None, None, None, :] >= kv_len[:, None, None, None],
                                MASK_VALUE)
    p = torch.softmax(scores, dim=-1)
    out = torch.matmul(p, v)
    p_band = torch.zeros(b, h, t, 2 * window + 1, dtype=p.dtype, device=p.device)
    for m in range(2 * window + 1):
        off = m - window
        if abs(off) >= t:
            continue
        diag = p.diagonal(off, -2, -1)
        if off >= 0:
            p_band[..., :t - off, m] = diag
        else:
            p_band[..., -off:, m] = diag
    return out + torch.einsum("bhlm,hmd->bhld", p_band, rel_v)


def banded_flash_attention(q, k, v, rel_k, rel_v, kv_len, *, window: int):
    """q, k, v: (B, H, T, D), q PRE-SCALED by D^-1/2; rel_k, rel_v:
    (n_rel, 2w+1, D) with n_rel 1 (heads share) or H; kv_len: (B,) valid key
    prefix. Returns (B, H, T, D): the attention output including the
    relative-value term (everything but the output projection).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not q.is_cuda:
        return banded_attention_plain(q, k, v, rel_k, rel_v, kv_len, window=window)
    b, h, t, d = q.shape
    n_rel = rel_k.shape[0]
    for name, a, shape in (("q", q, (b, h, t, d)), ("k", k, (b, h, t, d)),
                           ("v", v, (b, h, t, d)), ("rel_k", rel_k, (n_rel, 2 * window + 1, d)),
                           ("rel_v", rel_v, (n_rel, 2 * window + 1, d))):
        if not a.is_cuda or a.device != q.device or a.dtype != torch.float32:
            raise ValueError(f"banded attention kernel: {name} must be float32 on {q.device}")
        if tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(f"banded attention kernel: {name} must be a contiguous {shape}, "
                             f"got {tuple(a.shape)}")
    if n_rel not in (1, h):
        raise ValueError(f"banded attention kernel: n_rel must be 1 or {h}, got {n_rel}")
    if d > 128:
        raise ValueError(f"banded attention kernel: head dim {d} > 128")
    if kv_len.device != q.device or kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (b,) \
            or not kv_len.is_contiguous():
        raise ValueError("banded attention kernel: kv_len must be a contiguous (B,) int32 "
                         f"tensor on {q.device}")
    out = torch.empty_like(q)
    fn = KERNEL.fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_k.data_ptr(), rel_v.data_ptr(),
                 kv_len.data_ptr(), out.data_ptr(), b, h, t, d, window, n_rel,
                 ctypes.c_void_p(stream))
    KERNEL.check(err)
    KERNEL.launches += 1
    return out
