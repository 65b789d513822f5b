"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where there is no NVIDIA GPU. This file
imports no JAX, so on a machine with the card and without JAX it runs as
``python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest``.
Shapes beyond the serving path's: ragged T down to 1, head dims 32-128
(every NC template), per-head relative tables, narrower DDSConv channels.
f32; tolerance 1e-4 absolute (other summation orders, values of order 1).
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


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d,n_rel,lengths", [
    (1, 1, 96, 1, [1]), (2, 5, 32, 2, [5, 2]), (2, 37, 64, 1, [37, 30]),
    (1, 130, 128, 2, [99]), (3, 256, 96, 1, [256, 200, 9])])
def test_banded_attention_kernel(dev, monkeypatch, b, t, d, n_rel, lengths):
    g = torch.Generator(device=dev).manual_seed(t)
    h, w = 2, 4
    q, k, v = (torch.randn(b, h, t, d, generator=g, device=dev) for _ in range(3))
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
