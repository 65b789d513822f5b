"""Fused DDSConv stack: the CUDA kernel's wrapper and its plain version.

Port of vosk_tts_tpu/ops/ddsconv_fused.py::ddsconv_fused (the Pallas
``_kernel``), i.e. ``wn.ddsconv_apply`` without conditioning or dropout.
Layer i (dilation K^i): depthwise conv of x * mask plus bias, LayerNorm
(eps 1e-5), exact GELU, pointwise C x C plus bias, LayerNorm, GELU, then
x += y; the residual is not masked between layers and the output is
x * mask. GELU uses a true erf (the JAX kernel's Abramowitz-Stegun erf,
|err| <= 1.5e-7, is a Mosaic workaround).

``params`` is the port's stacked DDSConv tree (utils/params.py):
sep_w (L, C, K), sep_b (L, C), pw_w (L, C_out, C_in), pw_b (L, C),
norm1_g/norm1_b/norm2_g/norm2_b (L, C).

The kernel takes float32 or bfloat16 (x, the mask and every weight in one
dtype, as the JAX ``supported`` gate admits both), a symbol and a launch
count each. In bf16 it follows the JAX kernel's arithmetic: the depthwise
taps read the bf16 x * mask (summed in f32), the LayerNorm statistics and
GELU run in f32, the GELU(LN1) rows are rounded to bf16 for the pointwise
product, which accumulates in f32 and adds the bias before rounding to
bf16, LN2 and GELU run in f32 on that, and the residual rounds to bf16
after each layer (x + y in bf16, as JAX adds them); the output is bf16.
``ddsconv_plain`` repeats that arithmetic for bf16 inputs.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils.cuda_build import CudaKernel, I, P
from .conv import depthwise_conv1d
from .flash_attention import check_dtypes, kernel_for, round_to
from .norm import layer_norm

KERNEL = CudaKernel("ddsconv.cu", "ddsconv_f32", [P] * 11 + [I, I, I, I, I, P])
KERNEL_BF16 = CudaKernel("ddsconv.cu", "ddsconv_bf16", [P] * 11 + [I, I, I, I, I, P])
# the kernel's launch geometry for a shape (ddsconv_plan); launches nothing
PLAN = CudaKernel("ddsconv.cu", "ddsconv_plan", [I] * 6 + [P])
REFUSED = -1  # what both entry points return for a shape the kernel cannot take
MAX_CHANNELS = 256
MAX_HALO = 1 << 20

_WEIGHTS = ("sep_w", "sep_b", "pw_w", "pw_b", "norm1_g", "norm1_b", "norm2_g", "norm2_b")


def _check_kernel_size(params, kernel_size):
    k = params["sep_w"].shape[-1]
    if kernel_size != k:
        raise ValueError(f"kernel_size={kernel_size} does not match the params' kernel size {k}")


def check_shape(c: int, n_layers: int, kernel_size: int) -> None:
    """Raise ValueError unless the kernel's domain holds: C a multiple of 32
    up to 256, an odd kernel size, a layer or more, and a halo (sum over
    the layers of K^i (K-1)/2 rows a side) of at most 2^20 rows. Whether the
    window also fits shared memory and the grid, the built kernel's plan
    says (csrc/ddsconv.cu ``make_plan``; the wrapper raises ValueError then)."""
    k = kernel_size
    if c <= 0 or c > MAX_CHANNELS or c % 32:
        raise ValueError(f"ddsconv kernel: channels must be a multiple of 32 up to "
                         f"{MAX_CHANNELS}, got {c}")
    if k < 1 or k % 2 == 0 or n_layers < 1:
        raise ValueError(f"ddsconv kernel: needs an odd kernel size and a layer, got K={k} "
                         f"L={n_layers}")
    halo, dilation = 0, 1
    for _ in range(n_layers):
        halo += dilation * (k - 1) // 2
        if halo > MAX_HALO:
            raise ValueError(f"ddsconv kernel: halo of more than {MAX_HALO} rows (K={k}, "
                             f"L={n_layers})")
        dilation *= k


def _check(err: int, shape, kernel=KERNEL) -> None:
    if err == REFUSED:
        raise ValueError(f"ddsconv kernel: (B, T, C, L, K) = {shape} does not fit its grid or "
                         f"its shared memory")
    kernel.check(err)


def kernel_plan(b: int, t: int, c: int, n_layers: int, kernel_size: int,
                dtype=torch.float32) -> dict:
    """The launch geometry the built kernel of ``dtype`` takes for a shape
    on the current device (csrc/ddsconv.cu ``make_plan``): a cluster of C/32 CTAs (one
    32-channel slice each) per (batch row, row tile), ``rows`` = row tile +
    2 * halo rows a cluster, the product, the weight stages, whether the
    per-channel parameters are staged in shared memory, the dynamic shared
    bytes and ``max_active_clusters``, the clusters of that geometry the
    card runs at once. Needs the card; raises ValueError for a shape the
    kernel does not take."""
    check_shape(c, n_layers, kernel_size)
    vals = (ctypes.c_int * 10)()
    _check(PLAN.fn()(b, t, c, n_layers, kernel_size, int(dtype == torch.bfloat16),
                     ctypes.cast(vals, ctypes.c_void_p)),
           (b, t, c, n_layers, kernel_size))
    gx, gy, nc, smem, stages, halo, bt, wg, staged, clusters = vals
    return {"grid": (gx, gy), "cluster": nc, "halo": halo, "row_tile": bt,
            "rows": bt + 2 * halo, "product": "wgmma" if wg else "mma", "stages": stages,
            "params_staged": bool(staged), "smem_bytes": smem, "max_active_clusters": clusters}


def ddsconv_plain(x, x_mask, params, *, kernel_size: int = 3):
    """The plain version. x: (B, T, C); x_mask: (B, T, 1). bf16 inputs run
    the kernel's bf16 arithmetic (the module's docstring) in f32 with its
    roundings, and return bf16."""
    _check_kernel_size(params, kernel_size)
    if check_dtypes("ddsconv", x, *(params[n] for n in _WEIGHTS)) == torch.bfloat16:
        return _ddsconv_plain_bf16(x, x_mask, params, kernel_size)
    for i in range(params["sep_w"].shape[0]):
        dilation = kernel_size**i
        pad = (kernel_size * dilation - dilation) // 2
        y = depthwise_conv1d(x * x_mask, params["sep_w"][i][:, None, :], params["sep_b"][i],
                             padding=pad, dilation=dilation)
        y = F.gelu(layer_norm(y, params["norm1_g"][i], params["norm1_b"][i]))
        y = F.linear(y, params["pw_w"][i], params["pw_b"][i])
        y = F.gelu(layer_norm(y, params["norm2_g"][i], params["norm2_b"][i]))
        x = x + y
    return x * x_mask


def _ddsconv_plain_bf16(x, x_mask, params, kernel_size):
    bf16 = torch.bfloat16
    p = {n: params[n].float() for n in _WEIGHTS}
    mask = x_mask.to(bf16)
    for i in range(p["sep_w"].shape[0]):
        dilation = kernel_size**i
        pad = (kernel_size * dilation - dilation) // 2
        y = depthwise_conv1d((x * mask).float(), p["sep_w"][i][:, None, :], p["sep_b"][i],
                             padding=pad, dilation=dilation)
        y = round_to(F.gelu(layer_norm(y, p["norm1_g"][i], p["norm1_b"][i])), bf16)
        y = round_to(F.linear(y, p["pw_w"][i], p["pw_b"][i]), bf16)
        y = F.gelu(layer_norm(y, p["norm2_g"][i], p["norm2_b"][i]))
        x = x + y.to(bf16)
    return x * mask


def ddsconv_fused(x, x_mask, params, *, kernel_size: int = 3):
    """The whole DDSConv stack in one launch. x: (B, T, C); x_mask: (B, T, 1).

    x and every weight share one dtype, float32 or bfloat16 (the output's;
    the mask is taken in it); CPU tensors take the plain version; CUDA
    tensors launch the dtype's kernel."""
    if not x.is_cuda:
        return ddsconv_plain(x, x_mask, params, kernel_size=kernel_size)
    dtype = check_dtypes("ddsconv kernel", x, *(params[n] for n in _WEIGHTS))
    kernel = kernel_for("ddsconv kernel", dtype, KERNEL, KERNEL_BF16)
    _check_kernel_size(params, kernel_size)
    b, t, c = x.shape
    n_layers = params["sep_w"].shape[0]
    if not x.is_contiguous():
        raise ValueError("ddsconv kernel: x must be a contiguous (B, T, C) tensor")
    check_shape(c, n_layers, kernel_size)
    if tuple(x_mask.shape) != (b, t, 1) or x_mask.device != x.device:
        raise ValueError(f"ddsconv kernel: x_mask must be ({b}, {t}, 1) on {x.device}")
    mask = x_mask.reshape(b, t).to(dtype).contiguous()
    shapes = {"sep_w": (n_layers, c, kernel_size), "pw_w": (n_layers, c, c)}
    for name in _WEIGHTS:
        a = params[name]
        want = shapes.get(name, (n_layers, c))
        if a.device != x.device or tuple(a.shape) != want or not a.is_contiguous():
            raise ValueError(f"ddsconv kernel: {name} must be a contiguous {want} tensor on "
                             f"{x.device}")
    out = torch.empty_like(x)
    fn = kernel.fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), mask.data_ptr(), *(params[n].data_ptr() for n in _WEIGHTS),
                 out.data_ptr(), b, t, c, n_layers, kernel_size, ctypes.c_void_p(stream))
    _check(err, (b, t, c, n_layers, kernel_size), kernel)
    kernel.launches += 1
    return out
