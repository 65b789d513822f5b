"""Monotonic alignment search: the CUDA kernel's wrapper and its plain version.

The port's own kernel (csrc/mas.cu): the JAX package runs the same DP as a
lax.scan wavefront and a reverse scan (vosk_tts_tpu/ops/mas.py), with no
Pallas kernel. Eagerly in PyTorch that wavefront is a few launches for each
of T_y rows a training step; the kernel is one launch. Semantics (both
versions), per batch row with t_y rows and t_x columns valid:

  v[y][x] = neg_cent[y][x] + max(x == y ? NEG : v[y-1][x],
                                 x == 0 ? (y == 0 ? 0 : NEG) : v[y-1][x-1])
            inside the band max(0, t_x + y - t_y) <= x < min(t_x, y + 1),
            NEG (-1e9) outside it;
  backtrack from (t_y - 1, t_x - 1): the path takes the current column,
  then moves one column left when y > 0, the column is not 0 and (it equals
  y or v[y-1][x] < v[y-1][x-1]); rows at or past t_y are 0.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import CudaKernel, I, P

NEG = -1e9
KERNEL = CudaKernel("mas.cu", "mas_f32", [P, P, P, P, I, I, I, P])


def maximum_path_plain(neg_cent, t_ys, t_xs):
    """The plain version: the recurrence as tensor ops, a row at a time.
    neg_cent (B, T_y, T_x) f32; t_ys, t_xs (B,) int -> path (B, T_y, T_x) f32."""
    b, t_y, t_x = neg_cent.shape
    dev = neg_cent.device
    xs = torch.arange(t_x, device=dev)
    t_ys, t_xs = t_ys.long(), t_xs.long()
    neg = torch.full((), NEG, dtype=torch.float32, device=dev)
    v = torch.full((b, t_x), NEG, dtype=torch.float32, device=dev)
    values = []
    for y in range(t_y):
        stay = torch.where(xs == y, neg, v)
        first = torch.full((b, 1), 0.0 if y == 0 else NEG, dtype=torch.float32, device=dev)
        left = torch.cat([first, v[:, :-1]], dim=1)
        new = neg_cent[:, y] + torch.maximum(stay, left)
        x_lo = (t_xs + y - t_ys).clamp(min=0)
        x_hi = t_xs.clamp(max=y + 1)
        band = (xs[None] >= x_lo[:, None]) & (xs[None] < x_hi[:, None])
        v = torch.where(band, new, neg)
        values.append(v)
    idx = t_xs - 1
    path = torch.zeros((b, t_y, t_x), dtype=torch.float32, device=dev)
    for y in range(t_y - 1, -1, -1):
        active = y < t_ys
        path[:, y] = ((xs[None] == idx[:, None]) & active[:, None]).float()
        if y > 0:
            prev = values[y - 1]
            v_at = prev.gather(1, idx.clamp(min=0)[:, None])[:, 0]
            v_left = prev.gather(1, (idx - 1).clamp(min=0)[:, None])[:, 0]
            move = (idx != 0) & ((idx == y) | (v_at < v_left))
            idx = torch.where(active & move, idx - 1, idx)
    return path


def mas_path(neg_cent, t_ys, t_xs):
    """The path (B, T_y, T_x) f32 for neg_cent (B, T_y, T_x) f32 and the
    valid lengths t_ys, t_xs (B,) int32.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not neg_cent.is_cuda:
        return maximum_path_plain(neg_cent, t_ys, t_xs)
    b, t_y, t_x = neg_cent.shape
    if neg_cent.dtype != torch.float32 or not neg_cent.is_contiguous():
        raise ValueError("mas kernel: neg_cent must be a contiguous float32 (B, T_y, T_x) tensor")
    for name, a in (("t_ys", t_ys), ("t_xs", t_xs)):
        if (a.device != neg_cent.device or a.dtype != torch.int32 or tuple(a.shape) != (b,)
                or not a.is_contiguous()):
            raise ValueError(f"mas kernel: {name} must be a contiguous ({b},) int32 tensor on "
                             f"{neg_cent.device}")
    path = torch.empty_like(neg_cent)
    fn = KERNEL.fn()
    with torch.cuda.device(neg_cent.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(neg_cent.data_ptr(), t_ys.data_ptr(), t_xs.data_ptr(), path.data_ptr(),
                 b, t_y, t_x, ctypes.c_void_p(stream))
    if err == 1:  # cudaErrorInvalidValue: T_x > 4096, or the bits exceed shared memory
        raise ValueError(f"mas kernel: (B, T_y, T_x) = {(b, t_y, t_x)} does not fit its "
                         f"threads or its shared memory")
    KERNEL.check(err)
    KERNEL.launches += 1
    return path


def maximum_path(neg_cent, attn_mask):
    """neg_cent (B, T_y, T_x) log-likelihoods; attn_mask (B, T_y, T_x), the
    y_mask x x_mask outer product. Returns the hard alignment path in
    neg_cent's dtype, times the mask (vosk_tts_tpu/ops/mas.py)."""
    t_ys = (attn_mask[:, :, 0] > 0).sum(dim=1).to(torch.int32)
    t_xs = (attn_mask[:, 0, :] > 0).sum(dim=1).to(torch.int32)
    path = mas_path(neg_cent.float().contiguous(), t_ys, t_xs)
    return path.to(neg_cent.dtype) * attn_mask
