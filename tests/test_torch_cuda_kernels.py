"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where there is no NVIDIA GPU. This file
imports no JAX, so on a machine with the card and without JAX it runs as
``python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest``.
Shapes beyond the serving path's: ragged T down to 1, head dims 32-128
(every NC template) and 37, 40, 72 (not multiples of 32), per-head
relative tables, windows 0 to 64, narrower DDSConv channels; the global
attention kernel in its RoPE, packed (also as a strided view) and separate
forms with d_rope 0 to 64; T and kv_len at the edges of the key tiles, the
copy ring and the query tiles, kv_len 0, and inputs off the 16-byte grid
(the kernels' 4-byte copy path). f32; tolerance 1e-4 absolute (other
summation orders, values of order 1).
"""

import pytest
import torch

from vosk_tts_tpu_torch.ops import ddsconv_fused as ddf
from vosk_tts_tpu_torch.ops import flash_attention as fa


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _refuse(*a, **k):
    raise AssertionError("plain version reached with CUDA tensors")


def _randn(shape, g, dev, misaligned=False):
    """A contiguous f32 tensor; ``misaligned`` puts its first element 4 bytes
    past a 16-byte boundary (the kernels then stage it with 4-byte copies)."""
    n = 1
    for s in shape:
        n *= s
    flat = torch.randn(n + 1, generator=g, device=dev)
    return (flat[1:] if misaligned else flat[:n]).view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d,n_rel,w,lengths,misaligned", [
    (1, 1, 96, 1, 4, [1], False), (2, 5, 32, 2, 4, [5, 2], False),
    (2, 37, 64, 1, 4, [37, 30], False), (1, 130, 128, 2, 4, [99], False),
    (3, 256, 96, 1, 4, [256, 200, 9], False),
    # T and kv_len at the edges of the 32-key tiles, the 2-stage ring and the 64-row query tiles
    (2, 1, 96, 1, 4, [1, 1], False), (2, 63, 96, 1, 4, [63, 1], False),
    (2, 64, 96, 1, 4, [64, 63], False), (2, 65, 96, 2, 4, [65, 64], False),
    (2, 127, 96, 1, 4, [127, 65], False), (2, 129, 96, 1, 4, [129, 127], False),
    (2, 100, 96, 1, 4, [0, 33], False),  # kv_len 0: every key at -1e4, all T keys walked
    # the band straddling a query-tile boundary (T = 130), window 0, 8 and the largest, 64
    (1, 130, 96, 1, 0, [130], False), (2, 130, 96, 2, 8, [130, 97], False),
    (1, 200, 64, 1, 64, [150], False),
    (2, 130, 40, 1, 4, [130, 64], False), (2, 77, 72, 2, 4, [77, 32], False),  # D 8k, not 32k
    (2, 130, 96, 1, 4, [130, 65], True), (1, 70, 72, 1, 8, [70], True)])  # 4-byte copies
def test_banded_attention_kernel(dev, monkeypatch, b, t, d, n_rel, w, lengths, misaligned):
    g = torch.Generator(device=dev).manual_seed(t)
    h = 2
    q, k, v = (_randn((b, h, t, d), g, dev, misaligned) for _ in range(3))
    q = q * d**-0.5
    rel_k, rel_v = (torch.randn(n_rel, 2 * w + 1, d, generator=g, device=dev) for _ in range(2))
    kv_len = torch.tensor(lengths, dtype=torch.int32, device=dev)
    want = fa.banded_attention_plain(q, k, v, rel_k, rel_v, kv_len, window=w)
    monkeypatch.setattr(fa, "banded_attention_plain", _refuse)
    n = fa.KERNEL.launches
    got = fa.banded_flash_attention(q, k, v, rel_k, rel_v, kv_len, window=w)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == n + 1
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,lengths", [(1, 1, 256, [1]), (2, 5, 128, [5, 3]),
                                           (2, 37, 256, [37, 20]), (1, 100, 64, [100]),
                                           (3, 256, 256, [256, 129, 7])])
def test_ddsconv_kernel(dev, monkeypatch, b, t, c, lengths):
    g = torch.Generator(device=dev).manual_seed(t)
    rnd = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    n_layers = 3
    params = {"sep_w": rnd(n_layers, c, 3, scale=0.5), "sep_b": rnd(n_layers, c, scale=0.1),
              "pw_w": rnd(n_layers, c, c, scale=c**-0.5), "pw_b": rnd(n_layers, c, scale=0.1),
              "norm1_g": 1 + rnd(n_layers, c, scale=0.1), "norm1_b": rnd(n_layers, c, scale=0.1),
              "norm2_g": 1 + rnd(n_layers, c, scale=0.1), "norm2_b": rnd(n_layers, c, scale=0.1)}
    x = rnd(b, t, c)
    mask = (torch.arange(t, device=dev)[None] < torch.tensor(lengths, device=dev)[:, None])
    mask = mask.to(torch.float32)[..., None]
    want = ddf.ddsconv_plain(x, mask, params)
    monkeypatch.setattr(ddf, "ddsconv_plain", _refuse)
    n = ddf.KERNEL.launches
    got = ddf.ddsconv_fused(x, mask, params)
    torch.cuda.synchronize()
    assert ddf.KERNEL.launches == n + 1
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("form,b,t,h,d,d_rope,lengths", [
    ("rope", 1, 1, 4, 64, 32, [1]), ("rope", 2, 5, 2, 32, 16, [5, 2]),
    ("rope", 2, 37, 4, 96, 48, [37, 30]), ("rope", 3, 200, 4, 64, 32, [200, 129, 7]),
    ("rope", 1, 130, 2, 128, 64, [99]), ("packed", 2, 100, 4, 96, 0, [100, 61]),
    ("packed", 1, 64, 2, 128, 0, [64]), ("separate", 2, 77, 4, 64, 0, [77, 1]),
    ("separate", 1, 3, 3, 32, 0, [2]), ("strided", 2, 50, 4, 96, 48, [50, 31]),
    # T and kv_len at the edges of the 32-key tiles, the 2-stage ring and the 64-row query tiles
    ("rope", 2, 1, 4, 96, 48, [1, 1]), ("rope", 2, 63, 4, 96, 48, [63, 1]),
    ("rope", 2, 64, 4, 96, 48, [64, 63]), ("rope", 2, 65, 4, 96, 48, [65, 64]),
    ("rope", 2, 127, 4, 96, 48, [127, 65]), ("rope", 2, 129, 4, 96, 48, [129, 127]),
    ("rope", 2, 100, 4, 96, 48, [0, 33]), ("packed", 2, 70, 4, 64, 0, [0, 0]),  # kv_len 0
    ("rope", 2, 130, 4, 40, 20, [130, 64]), ("rope", 1, 90, 2, 72, 36, [90]),  # D 8k, not 32k
    ("separate", 2, 77, 3, 72, 0, [77, 32]),
    ("separate", 1, 50, 2, 37, 0, [50]),  # odd D: 4-byte copies
    ("misaligned", 2, 130, 4, 96, 48, [130, 65]), ("misaligned", 2, 70, 4, 72, 36, [70, 9])])
def test_global_attention_kernel(dev, monkeypatch, form, b, t, h, d, d_rope, lengths):
    g = torch.Generator(device=dev).manual_seed(t + d)
    c = h * d
    kv_len = torch.tensor(lengths, dtype=torch.int32, device=dev)
    sm = d**-0.5
    if form == "separate":
        q, k, v = (torch.randn(b, t, c, generator=g, device=dev) for _ in range(3))
        want = fa.global_attention_plain(q, k, v, kv_len, n_heads=h, sm_scale=sm)
        run, kernel = lambda: fa.global_flash_attention(q, k, v, kv_len, n_heads=h, sm_scale=sm), \
            fa.GLOBAL_KERNEL
    else:
        qkv = torch.randn(b, t, 3 * c, generator=g, device=dev)
        if form == "strided":  # the packed projection as a view into wider rows
            qkv = torch.randn(b, t, 3 * c + 40, generator=g, device=dev)[..., 8:8 + 3 * c]
        if form == "misaligned":  # ... at an offset off the 16-byte grid: 4-byte copies
            qkv = torch.randn(b, t, 3 * c + 40, generator=g, device=dev)[..., 1:1 + 3 * c]
        want = fa.global_attention_plain(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], kv_len,
                                         n_heads=h, sm_scale=sm, d_rope=d_rope)
        if form in ("rope", "strided", "misaligned"):
            run, kernel = lambda: fa.global_flash_attention_rope(
                qkv, kv_len, n_heads=h, sm_scale=sm, d_rope=d_rope), fa.GLOBAL_ROPE_KERNEL
        else:
            run, kernel = lambda: fa.global_flash_attention_packed(
                qkv, kv_len, n_heads=h, sm_scale=sm), fa.GLOBAL_PACKED_KERNEL
    monkeypatch.setattr(fa, "global_attention_plain", _refuse)
    n = kernel.launches
    got = run()
    torch.cuda.synchronize()
    assert kernel.launches == n + 1
    assert got.shape == (b, t, c)
    assert (got - want).abs().max().item() <= 1e-4  # every row, past kv_len too


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.randn(1, 2, 8, 96, device=dev)
    rel = torch.randn(1, 9, 96, device=dev)
    kv_len = torch.tensor([8], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        fa.banded_flash_attention(q.double(), q.double(), q.double(), rel.double(),
                                  rel.double(), kv_len, window=4)
    with pytest.raises(ValueError):
        fa.banded_flash_attention(q.transpose(2, 3), q, q, rel, rel, kv_len, window=4)
    with pytest.raises(ValueError):
        fa.banded_flash_attention(q, q, q, rel, rel, kv_len.long(), window=4)
    x = torch.randn(1, 8, 288, device=dev)  # more channels than the kernel's 256
    params = {k: torch.randn(3, 288, device=dev) for k in (
        "sep_b", "pw_b", "norm1_g", "norm1_b", "norm2_g", "norm2_b")}
    params.update(sep_w=torch.randn(3, 288, 3, device=dev),
                  pw_w=torch.randn(3, 288, 288, device=dev))
    with pytest.raises(ValueError):
        ddf.ddsconv_fused(x, torch.ones(1, 8, 1, device=dev), params)
    with pytest.raises(ValueError):  # weights of another width than x
        ddf.ddsconv_fused(torch.randn(1, 8, 256, device=dev), torch.ones(1, 8, 1, device=dev),
                          params)
    qkv = torch.randn(2, 8, 3 * 256, device=dev)
    lens = torch.tensor([8, 5], dtype=torch.int32, device=dev)
    for bad in (dict(qkv=qkv.double()), dict(kv_len=lens.long()), dict(d_rope=33),
                dict(d_rope=66), dict(n_heads=3), dict(n_heads=1),  # head dim 256 > 128
                dict(qkv=torch.randn(2, 8, 700, device=dev)),  # not 3C wide
                dict(qkv=qkv[:, :, ::2])):  # feature stride 2
        args = dict(qkv=qkv, kv_len=lens, n_heads=4, sm_scale=0.125, d_rope=32) | bad
        with pytest.raises(ValueError):
            fa.global_flash_attention_rope(**args)
    with pytest.raises(ValueError):  # a strided view, not a contiguous (B, T, C)
        fa.global_flash_attention(qkv[..., :256], qkv[..., 256:512], qkv[..., 512:], lens,
                                  n_heads=4, sm_scale=0.125)
