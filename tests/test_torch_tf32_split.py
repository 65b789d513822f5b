"""The precision argument of the kernels' 3xTF32 products, on the CPU.

csrc/attention_mma.cuh splits each f32 operand x into hi, x rounded to
TF32 as ``cvt.rna.tf32.f32`` rounds it (to nearest, ties away from zero, 10
mantissa bits kept; the kernels do it with two integer operations), and
lo = x - hi, exact in f32, of which the tensor core reads the top 19 bits
(the 13 low bits cut). It sums a_lo.b_hi + a_hi.b_lo + a_hi.b_hi in f32 on
the tensor cores. Here the rounding and the cut are emulated by bit
masking, each TF32 product (exact in f32: 11 x 11 significant bits) is
summed by an f32 matmul, and the result is held against float64 at the
kernels' real widths and scales (D = 96; q, k, v standard normal, scores
scaled by D^-1/2 as in chip_smoke.py; p a softmax row over 2048 keys). The
error is measured relative to sum_i |a_i b_i|, the scale of a dot
product's rounding. The DDSConv kernel (csrc/ddsconv.cu) takes the same
split for its C x C pointwise products: they are held here at C = 256 over
GELU(LayerNorm) rows, and a whole 3-layer stack whose products are the
emulated 3xTF32 sum is held against float64.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vosk_tts_tpu_torch.ops import ddsconv_fused as ddf
from vosk_tts_tpu_torch.ops.conv import depthwise_conv1d
from vosk_tts_tpu_torch.ops.norm import layer_norm


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, rounding half away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tensor_core_reads(x: torch.Tensor) -> torch.Tensor:
    """An f32 operand as a TF32 mma reads it: the 13 low bits cut."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tensor_core_reads(x - hi)


def products(a, b):
    """a @ b (f32) as the f32 product, one TF32 product and the 3xTF32 sum."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    three = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi  # small terms first, f32 sums
    return {"f32": a @ b, "tf32": a_hi @ b_hi, "3xtf32": three}


def rel_err(got, a, b):
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    return float(((got.double() - exact).abs() / scale).max())


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_rounding_matches_cvt_rna():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-12, -(1 + 2**-11), 1 + 2**-11 - 2**-23,
                      3.0e-3, -7.5], dtype=torch.float32)
    got = tf32_rna(x)
    # ties (1 + 2^-11) round away from zero; just below a tie rounds down
    want = torch.tensor([1.0, 1 + 2**-10, 1 + 2**-10, -(1 + 2**-10), 1.0], dtype=torch.float32)
    assert torch.equal(got[:5], want)
    assert float(((got - x).abs() / x.abs()).max()) <= 2**-11
    assert torch.all(got.view(torch.int32) & 0x1FFF == 0)
    hi, lo = split(x)
    assert torch.equal(tensor_core_reads(hi), hi)
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2**-21


@pytest.mark.parametrize("d", [64, 96])
def test_split_keeps_f32_accuracy_on_scores(rng, d):
    q = torch.from_numpy(rng.standard_normal((64, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((d, 2048)).astype(np.float32))
    q = q * d**-0.5  # the banded kernel's pre-scaled q; global: sm_scale after
    got = products(q, k)
    err = {name: rel_err(s, q, k) for name, s in got.items()}
    assert err["f32"] <= 1e-6
    assert err["3xtf32"] <= 1e-6
    assert float((got["3xtf32"] - got["f32"]).abs().max()) <= 1e-5  # of scores ~N(0, 1)
    # one TF32 product misses the kernels' 1e-4 absolute gate on the scores
    assert float((got["tf32"].double() - q.double() @ k.double()).abs().max()) > 1e-4
    assert err["tf32"] > 1e-4


def test_split_keeps_f32_accuracy_on_pv(rng):
    d, t = 96, 2048
    s = torch.from_numpy(rng.standard_normal((64, t)).astype(np.float32))
    p = torch.softmax(s, dim=-1)
    v = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    got = products(p, v)
    err = {name: rel_err(o, p, v) for name, o in got.items()}
    assert err["f32"] <= 1e-6
    assert err["3xtf32"] <= 1e-6
    # p sums to 1, so one TF32 product stays near 5e-5 here: within the gate
    # alone, but two orders of magnitude off f32, and it adds to the scores'
    assert err["tf32"] > 1e-5


def _gelu_ln_rows(rng, rows, c):
    """GELU(LayerNorm(.)) rows with random affines, as the DDSConv product reads them."""
    y = torch.from_numpy(rng.standard_normal((rows, c)).astype(np.float32))
    g = torch.from_numpy((1 + 0.1 * rng.standard_normal(c)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32))
    return F.gelu(layer_norm(y, g, b))


def test_split_keeps_f32_accuracy_on_ddsconv_pointwise(rng):
    c = 256
    a = _gelu_ln_rows(rng, 58, c)  # one row tile and its halo
    w = torch.from_numpy(rng.standard_normal((c, c)).astype(np.float32)) * c**-0.5
    got = products(a, w.T)  # y @ pw_w^T, pw_w stored (C_out, C_in)
    err = {name: rel_err(o, a, w.T) for name, o in got.items()}
    assert err["f32"] <= 1e-6
    assert err["3xtf32"] <= 1e-6
    exact = a.double() @ w.T.double()
    assert float((got["3xtf32"].double() - exact).abs().max()) <= 2e-6
    # one TF32 product is three orders of magnitude off f32 here
    assert err["tf32"] > 1e-4


def _stack(x, x_mask, params, kernel_size, product):
    """ddsconv_plain with its pointwise products y @ W^T taken by ``product``."""
    for i in range(params["sep_w"].shape[0]):
        dilation = kernel_size**i
        pad = (kernel_size * dilation - dilation) // 2
        y = depthwise_conv1d(x * x_mask, params["sep_w"][i][:, None, :], params["sep_b"][i],
                             padding=pad, dilation=dilation)
        y = F.gelu(layer_norm(y, params["norm1_g"][i], params["norm1_b"][i]))
        y = product(y, params["pw_w"][i].T) + params["pw_b"][i]
        y = F.gelu(layer_norm(y, params["norm2_g"][i], params["norm2_b"][i]))
        x = x + y
    return x * x_mask


def test_split_keeps_f32_accuracy_through_ddsconv_stack(rng):
    """The kernel's arithmetic at chip_smoke.py's widths (C 256, L 3, K 3,
    pw_w scaled by C^-1/2, ragged lengths): within the 1e-4 gate of the
    kernel against its plain version, with an order of magnitude to spare."""
    b, t, c, n_layers, k = 2, 64, 256, 3, 3
    f = lambda *s, scale=1.0: torch.from_numpy(
        (scale * rng.standard_normal(s)).astype(np.float32))
    params = {"sep_w": f(n_layers, c, k, scale=3**-0.5), "sep_b": f(n_layers, c, scale=0.1),
              "pw_w": f(n_layers, c, c, scale=c**-0.5), "pw_b": f(n_layers, c, scale=0.1),
              "norm1_g": 1 + f(n_layers, c, scale=0.1), "norm1_b": f(n_layers, c, scale=0.1),
              "norm2_g": 1 + f(n_layers, c, scale=0.1), "norm2_b": f(n_layers, c, scale=0.1)}
    x = f(b, t, c)
    mask = (torch.arange(t)[None, :] < torch.tensor([t, 41])[:, None]).float()[..., None]
    with torch.no_grad():
        plain = ddf.ddsconv_plain(x, mask, params, kernel_size=k)
        assert torch.equal(_stack(x, mask, params, k, torch.matmul), plain)  # a faithful copy
        exact = ddf.ddsconv_plain(x.double(), mask.double(),
                                  {n: v.double() for n, v in params.items()}, kernel_size=k)
        three = _stack(x, mask, params, k, lambda a, w: products(a, w)["3xtf32"])
        one = _stack(x, mask, params, k, lambda a, w: products(a, w)["tf32"])
    err = {name: float((o.double() - exact).abs().max())
           for name, o in (("f32", plain), ("3xtf32", three), ("tf32", one))}
    assert err["f32"] <= 1e-5
    assert err["3xtf32"] <= 1e-6 + 2 * err["f32"]
    assert err["3xtf32"] <= 1e-4
    # one TF32 product alone misses the gate
    assert err["tf32"] > 1e-4
