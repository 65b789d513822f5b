"""The f32 global attention's route rule (ops/flash_attention.global_f32_route).

A pure function of the layout: q, k and v that start on 16 bytes, with
batch and row strides and head dim multiples of 4 values, take the TMA
kernel; any other layout the general kernel. No tensor, no card: the
kernels' own cases run in tests/test_torch_cuda_kernels.py on the card.
"""

import pytest

from vosk_tts_tpu_torch.ops import flash_attention as fa

BASE = 0x7F0000000000  # a 512-byte aligned allocation, as the caching allocator gives


def _packed(c, t, offset=0, extra=0):
    """The addresses and strides of q, k, v in a (B, T, 3C + extra) f32
    projection, viewed ``offset`` values into each row."""
    p = BASE + 4 * offset
    return (p, p + 4 * c, p + 8 * c), t * (3 * c + extra), 3 * c + extra


@pytest.mark.parametrize("layout,d,route", [
    (_packed(384, 512), 96, "tma"),  # the DiT decoder's packed projection, H4 D96
    (_packed(256, 64), 64, "tma"),  # the text encoders', H4 D64
    (((BASE, BASE + 2**20, BASE + 2**21), 2048 * 96, 96), 48, "tma"),  # separate (B, T, C)
    (_packed(384, 512, offset=8, extra=40), 96, "tma"),  # a view 32 bytes into wider rows
    (_packed(384, 512, offset=1, extra=40), 96, "general"),  # 4 bytes off the 16-byte grid
    (_packed(384, 512, offset=2, extra=40), 96, "general"),  # 8 bytes off
    (_packed(74, 50), 37, "general"),  # odd D (2 heads x 37)
    (_packed(384, 512, extra=2), 96, "general"),  # a row stride of 3C + 2 values
    (_packed(384, 512, offset=4, extra=6), 96, "general"),  # aligned starts, odd row stride
    (((BASE, BASE + 16, BASE + 32), 1154, 1152), 96, "general"),  # batch stride 2 mod 4
    (((BASE, BASE + 16, BASE + 32), 1156, 1152), 96, "tma"),  # batch stride 0 mod 4
])
def test_global_f32_route(layout, d, route):
    ptrs, stride_b, stride_t = layout
    assert fa.global_f32_route(ptrs, stride_b, stride_t, d) == route


@pytest.mark.parametrize("b,t", [(1, 1), (2, 37), (16, 256), (32, 2048)])
def test_global_f32_route_ignores_the_shape(b, t):
    """The same layout takes the same route at every batch and length."""
    c = 384
    for offset, want in ((0, "tma"), (8, "tma"), (1, "general")):
        p = BASE + 4 * offset
        ptrs = (p, p + 4 * c, p + 8 * c)
        assert fa.global_f32_route(ptrs, t * (3 * c + 40), 3 * c + 40, 96) == want
