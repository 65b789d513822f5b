"""Mask / alignment / slicing utilities (vosk_tts_tpu/ops/commons.py)."""

from __future__ import annotations

import torch


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x in f32 where its dtype is narrower (bf16, f16), else as it is."""
    return x if x.dtype in (torch.float32, torch.float64) else x.float()


def as_dtype(scale, dtype):
    """A per-row scale tensor in the activations' dtype (a float as it is),
    so that an f32 knob does not promote a bf16 graph."""
    return scale.to(dtype) if isinstance(scale, torch.Tensor) else scale


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """Boolean mask (B, T): True for positions < length."""
    pos = torch.arange(max_length, dtype=lengths.dtype, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def subsequent_mask(length: int, device=None) -> torch.Tensor:
    """Lower-triangular causal mask (1, T, T) float32: 1 where key <= query."""
    return torch.tril(torch.ones((1, length, length), dtype=torch.float32, device=device))


def generate_path(durations: torch.Tensor, x_mask: torch.Tensor, y_mask: torch.Tensor) -> torch.Tensor:
    """Durations (B, Tx) (integral floats), x_mask (B, Tx), y_mask (B, Ty) ->
    (B, Ty, Tx) one-hot monotonic path in x_mask's dtype: frame t belongs to
    token s iff cum[s-1] <= t < cum[s]. The running sum is taken in at
    least f32, where frame counts past 256 are exact (bf16's are not)."""
    t_y = y_mask.shape[1]
    cum = torch.cumsum(at_least_f32(durations * x_mask), dim=-1)
    pos = torch.arange(t_y, dtype=cum.dtype, device=cum.device)
    below = pos[None, :, None] < cum[:, None, :]
    prev = torch.nn.functional.pad(below[:, :, :-1], (1, 0))
    path = below & ~prev
    return path.to(x_mask.dtype) * x_mask[:, None, :] * y_mask[:, :, None]


def fused_gate(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """tanh(first half) * sigmoid(second half) of a + b (channel axis)."""
    s = a + b
    n = s.shape[-1] // 2
    return torch.tanh(s[..., :n]) * torch.sigmoid(s[..., n:])


def intersperse(lst, item):
    """Insert ``item`` between consecutive symbols: [a, b, c] -> [a, 0, b, 0, c]."""
    result = [item] * (len(lst) * 2 - 1)
    result[0::2] = lst
    return result


def slice_segments(x: torch.Tensor, ids_str: torch.Tensor, segment_size: int) -> torch.Tensor:
    """Fixed-size windows: x (B, T, C), ids_str (B,) -> (B, segment_size, C).
    A start is clamped so that its window lies in [0, T), as JAX's
    dynamic_slice clamps it."""
    start = ids_str.long().clamp(0, max(x.shape[1] - segment_size, 0))
    idx = start[:, None] + torch.arange(segment_size, device=x.device)[None, :]
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def rand_slice_segments(x: torch.Tensor, lengths: torch.Tensor, segment_size: int, *,
                        generator: torch.Generator | None = None, ids: torch.Tensor | None = None):
    """Random windows within each row's valid length: start =
    floor(u * max(length - segment_size + 1, 1)) for u uniform in [0, 1)
    from ``generator``, or the given ``ids`` (B,). Returns (segments, ids
    int32)."""
    if ids is None:
        u = torch.rand((x.shape[0],), generator=generator, device=x.device)
        ids_max = (lengths - segment_size + 1).clamp(min=1)
        ids = (u * ids_max.to(u.dtype)).to(torch.int32)
    return slice_segments(x, ids, segment_size), ids
