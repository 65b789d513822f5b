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
(the kernels' 4-byte copy path). The f32 global kernel's two routes: TMA
(tiles of 32 keys, a ring of 2-4 stages, blocks of 64 rows, D 8 to 128,
RoPE tables by TMA where d_rope / 2 is a multiple of 4) and general (inputs off the 16-byte grid, odd D), each case checking
which ran; its 3xTF32 ``wgmma`` product alone against f64; each global
kernel (both f32 routes, bf16) writing its whole output and nothing
around it. f32; tolerance 1e-4 absolute (other summation orders, values
of order 1).
"""

import pytest
import torch

from vosk_tts_tpu_torch.ops import ddsconv_fused as ddf
from vosk_tts_tpu_torch.ops import flash_attention as fa
from vosk_tts_tpu_torch.utils.cuda_build import CudaKernel, I, P

#: the f32 global kernel's 3xTF32 wgmma product alone: c (64 x n) = a (64 x 96) . b (n x 96)^T
TF32X3_TILE = CudaKernel("global_attention.cu", "tf32x3_wgmma_tile", [P, P, P, I, P])


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
@pytest.mark.parametrize("b,t,c,lengths,k,n_layers,misaligned", [
    (1, 1, 256, [1], 3, 3, False), (2, 5, 128, [5, 3], 3, 3, False),
    (2, 37, 256, [37, 20], 3, 3, False), (1, 100, 64, [100], 3, 3, False),
    (3, 256, 256, [256, 129, 7], 3, 3, False),
    # T at the edges of the row tile (16 rows at these shapes) and the 13-row halo
    (2, 13, 256, [13, 1], 3, 3, False), (2, 14, 256, [14, 13], 3, 3, False),
    (2, 16, 256, [16, 15], 3, 3, False), (2, 17, 256, [17, 16], 3, 3, False),
    (2, 31, 256, [31, 30], 3, 3, False), (2, 32, 256, [32, 31], 3, 3, False),
    (2, 33, 256, [33, 32], 3, 3, False), (2, 45, 256, [45, 14], 3, 3, False),
    (2, 65, 256, [65, 33], 3, 3, False), (1, 128, 256, [120], 3, 3, False),
    # wider tiles where the clusters fill waves: B4 T128, B16 T256
    (4, 128, 256, [128, 100, 61, 1], 3, 3, False),
    (16, 256, 256, [256 - 13 * i for i in range(16)], 3, 3, False),
    # every cluster size: C 32 (one CTA, no exchange) to 256 (eight)
    (2, 45, 32, [45, 20], 3, 3, False), (2, 70, 64, [70, 3], 3, 3, False),
    (2, 33, 128, [33, 33], 3, 3, False), (2, 65, 192, [65, 40], 3, 3, False),
    (2, 64, 256, [0, 64], 3, 3, False),  # a row of length 0
    (2, 65, 256, [65, 31], 3, 3, True), (2, 40, 192, [40, 17], 3, 3, True),  # x 4 bytes off
    (2, 80, 256, [80, 50], 5, 2, False),  # K 5: halo 12, two weight stages
    (2, 50, 256, [50, 9], 3, 1, False), (1, 33, 64, [33], 5, 1, False),  # one layer
    (2, 40, 256, [40, 22], 3, 4, False),  # L 4: halo 40, a two-stage weight ring
    (1, 70, 128, [61], 1, 5, False),  # K 1: no halo, five layers through the ring
    (1, 40, 32, [33], 801, 1, False),  # K 801: parameters read from device memory
    (1, 40, 32, [37], 29, 2, False)])  # 872 rows: the mma.sync product
def test_ddsconv_kernel(dev, monkeypatch, b, t, c, lengths, k, n_layers, misaligned):
    g = torch.Generator(device=dev).manual_seed(t)
    rnd = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    params = {"sep_w": rnd(n_layers, c, k, scale=0.5), "sep_b": rnd(n_layers, c, scale=0.1),
              "pw_w": rnd(n_layers, c, c, scale=c**-0.5), "pw_b": rnd(n_layers, c, scale=0.1),
              "norm1_g": 1 + rnd(n_layers, c, scale=0.1), "norm1_b": rnd(n_layers, c, scale=0.1),
              "norm2_g": 1 + rnd(n_layers, c, scale=0.1), "norm2_b": rnd(n_layers, c, scale=0.1)}
    x = _randn((b, t, c), g, dev, misaligned)
    mask = (torch.arange(t, device=dev)[None] < torch.tensor(lengths, device=dev)[:, None])
    mask = mask.to(torch.float32)[..., None]
    want = ddf.ddsconv_plain(x, mask, params, kernel_size=k)
    monkeypatch.setattr(ddf, "ddsconv_plain", _refuse)
    n = ddf.KERNEL.launches
    got = ddf.ddsconv_fused(x, mask, params, kernel_size=k)
    torch.cuda.synchronize()
    assert ddf.KERNEL.launches == n + 1
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,n_layers,k", [(1, 64, 256, 3, 3), (1, 128, 256, 3, 3),
                                              (16, 256, 256, 3, 3), (2, 45, 32, 3, 3),
                                              (3, 100, 192, 2, 5), (1, 40, 256, 4, 3),
                                              (1, 64, 32, 1, 801), (2, 64, 32, 2, 29)])
def test_ddsconv_kernel_plan(dev, b, t, c, n_layers, k):
    """The built kernel's plan: a cluster of C/32 CTAs per (batch row, row
    tile of a multiple of 16 rows), the window within shared memory, a
    cluster the card holds; a single request's text buckets (B1 T64, T128
    at C 256) on 16-row tiles, so on 32 and 64 SMs."""
    plan = ddf.kernel_plan(b, t, c, n_layers, k)
    halo = sum(k**i * (k - 1) // 2 for i in range(n_layers))
    assert plan["cluster"] == c // 32 and plan["halo"] == halo
    assert plan["row_tile"] % 16 == 0 and plan["rows"] == plan["row_tile"] + 2 * halo
    assert plan["grid"] == (b * c // 32, -(-t // plan["row_tile"]))
    assert plan["smem_bytes"] <= 227 * 1024 and plan["max_active_clusters"] >= 1
    if (b, c, n_layers, k) == (1, 256, 3, 3):
        assert plan["row_tile"] == 16 and plan["grid"][0] * plan["grid"][1] >= 16


def _pr1_accepts(c, n_layers, k):
    """The shapes the first (f32 SIMT) kernel took: two W0 x C buffers, a
    32 x (C+1) weight tile and the mask window in 227 KB."""
    if c <= 0 or c > 256 or c % 32 or k < 1 or k % 2 == 0 or n_layers < 1:
        return False
    w0 = 32 + (k**n_layers - 1)
    return 4 * (2 * w0 * c + 32 * (c + 1) + w0 + 4) <= 227 * 1024


@pytest.mark.cuda
def test_ddsconv_plan_takes_every_shape_the_first_kernel_took(dev):
    taken = 0
    for c in range(32, 257, 32):
        for k in range(1, 1001, 2):
            for n_layers in range(1, 12):
                if k**n_layers > 2000:
                    break
                if _pr1_accepts(c, n_layers, k):
                    assert ddf.kernel_plan(1, 100, c, n_layers, k)["smem_bytes"] <= 227 * 1024
                    taken += 1
    assert taken > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("c,n_layers,k", [(256, 5, 3), (32, 3, 31), (128, 3, 7)])
def test_ddsconv_refuses_a_window_beyond_shared_memory(dev, c, n_layers, k):
    """Inside check_shape's domain, but the window (a 16-row tile and its
    halo) does not fit 227 KB: the plan refuses, the wrapper raises."""
    params = {"sep_w": torch.zeros(n_layers, c, k, device=dev),
              "pw_w": torch.zeros(n_layers, c, c, device=dev)}
    for name in ("sep_b", "pw_b", "norm1_g", "norm1_b", "norm2_g", "norm2_b"):
        params[name] = torch.zeros(n_layers, c, device=dev)
    ddf.check_shape(c, n_layers, k)
    with pytest.raises(ValueError):
        ddf.kernel_plan(1, 64, c, n_layers, k)
    n = ddf.KERNEL.launches
    with pytest.raises(ValueError):
        ddf.ddsconv_fused(torch.zeros(1, 64, c, device=dev), torch.ones(1, 64, 1, device=dev),
                          params, kernel_size=k)
    assert ddf.KERNEL.launches == n


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
    ("misaligned", 2, 130, 4, 96, 48, [130, 65]), ("misaligned", 2, 70, 4, 72, 36, [70, 9]),
    # the TMA route: T and kv_len at the edges of its 32-key tiles and its ring
    # (3 stages at D96, 2 at D128, 4 at D64 and below), D 8 and 48 (d_rope / 2
    # 2 and 10: tables from global memory, not by TMA)
    ("rope", 2, 31, 4, 96, 48, [31, 30]), ("rope", 2, 32, 4, 96, 48, [32, 31]),
    ("rope", 2, 33, 4, 96, 48, [33, 32]), ("rope", 2, 97, 4, 96, 48, [97, 96]),
    ("rope", 1, 700, 4, 96, 48, [650]), ("rope", 1, 300, 2, 128, 64, [290]),
    ("rope", 2, 33, 4, 64, 32, [33, 1]), ("rope", 2, 33, 2, 8, 4, [33, 31]),
    ("separate", 1, 31, 4, 8, 0, [31]), ("separate", 2, 97, 2, 48, 0, [97, 96]),
    ("separate", 2, 65, 2, 48, 0, [0, 64]),
    # grids of more blocks than SMs, rows past T in the last block
    ("rope", 9, 129, 4, 96, 48, [129, 128, 127, 65, 64, 63, 33, 1, 0]),
    ("packed", 9, 190, 4, 64, 0, [190, 129, 128, 96, 64, 32, 31, 2, 0])])
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
    n, n_general = kernel.launches, fa.GLOBAL_GENERAL_KERNEL.launches
    got = run()
    torch.cuda.synchronize()
    general = form == "misaligned" or d % 4 != 0  # the layouts TMA cannot load
    assert kernel.launches == n + 1
    assert fa.GLOBAL_GENERAL_KERNEL.launches == n_general + general
    assert got.shape == (b, t, c)
    assert (got - want).abs().max().item() <= 1e-4  # every row, past kv_len too


@pytest.mark.cuda
@pytest.mark.parametrize("n", [32, 96])
def test_tf32x3_wgmma_product_meets_f64(dev, n):
    """The f32 global kernel's product (a split in registers, b as hi and lo
    tiles, three TF32 wgmma a k-step) at S's shape (n 32) and P.V's at D96
    (n 96): within 1e-6 of an f64 product, relative to its largest value,
    where one TF32 product alone keeps ~1e-3."""
    g = torch.Generator(device=dev).manual_seed(n)
    a = torch.randn(64, 96, generator=g, device=dev)
    b = torch.randn(n, 96, generator=g, device=dev)
    c = torch.full((64, n), float("nan"), device=dev)
    TF32X3_TILE.check(TF32X3_TILE.fn()(a.data_ptr(), b.data_ptr(), c.data_ptr(), n,
                                       torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    want = a.double() @ b.double().T
    assert (c.double() - want).abs().max().item() <= 1e-6 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("form,dtype,b,t,h,d,lengths", [
    ("rope", torch.float32, 2, 65, 4, 96, [65, 33]), ("separate", torch.float32, 1, 33, 2, 48, [31]),
    ("misaligned", torch.float32, 2, 70, 4, 72, [70, 9]),  # the general route
    ("rope", torch.bfloat16, 2, 129, 4, 96, [129, 64])])
def test_global_attention_writes_only_its_output(dev, monkeypatch, form, dtype, b, t, h, d,
                                                 lengths):
    """Each global kernel writes every value of its (B, T, C) output and
    nothing around it: the output is a view into a buffer 16384 values wider
    on either side, all of it a sentinel (7.0, beyond what a convex
    combination of these v rows reaches), and the sentinel must survive
    around the output and nowhere inside it."""
    g = torch.Generator(device=dev).manual_seed(t)
    c, pad = h * d, 1 << 14
    kv_len = torch.tensor(lengths, dtype=torch.int32, device=dev)
    if form == "separate":
        q, k, v = (torch.randn(b, t, c, generator=g, device=dev) for _ in range(3))
        run = lambda: fa.global_flash_attention(q, k, v, kv_len, n_heads=h, sm_scale=d**-0.5)
    else:
        qkv = torch.randn(b, t, 3 * c + 40, generator=g, device=dev)
        qkv = (qkv[..., 1:1 + 3 * c] if form == "misaligned" else qkv[..., :3 * c]).to(dtype)
        run = lambda: fa.global_flash_attention_rope(qkv, kv_len, n_heads=h, sm_scale=d**-0.5,
                                                     d_rope=d // 2)
    buf = torch.full((2 * pad + b * t * c,), 7.0, dtype=dtype, device=dev)
    empty = torch.empty

    def output_in_buf(*shape, **kw):
        return buf[pad:pad + b * t * c].view(b, t, c) if shape == (b, t, c) else empty(*shape, **kw)

    monkeypatch.setattr(torch, "empty", output_in_buf)
    n_general = fa.GLOBAL_GENERAL_KERNEL.launches
    got = run()
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert got.data_ptr() == buf[pad:].data_ptr()
    assert fa.GLOBAL_GENERAL_KERNEL.launches == n_general + (form == "misaligned")
    assert bool((buf[:pad] == 7.0).all()) and bool((buf[pad + b * t * c:] == 7.0).all())
    assert bool(got.isfinite().all()) and not bool((got == 7.0).any())


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
