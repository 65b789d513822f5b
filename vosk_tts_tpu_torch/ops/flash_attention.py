"""The attention kernels' wrappers and their plain PyTorch versions.

Banded relative-position attention (csrc/banded_attention.cu), port of
vosk_tts_tpu/ops/flash_attention.py::banded_flash_attention (the Pallas
``_kernel``). Semantics, for q pre-scaled by D^-1/2:

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

Global attention (csrc/global_attention.cu), port of the Pallas
``_global_rope_kernel`` (``global_flash_attention_rope``, the StableTTS DiT
attention) and ``_global_kernel`` (``global_flash_attention_packed``,
``global_flash_attention``): one source, ``d_rope = 0`` for the latter two.
Over channels-last (B, T, C) q, k, v with C = n_heads * D:

  q', k'  = q, k with the first d_rope features of each head rotated
            (rotate-half RoPE, theta_j = 10000^(-2j/d_rope), positions 0..T-1)
  s[i,j]  = sm_scale * q'[i].k'[j];   s[i,j] = -30000 for j >= kv_len
  out[i]  = softmax_j(s) . v          -> (B, T, C)

Keys only are masked, as in the TPU kernels; rows at or past kv_len attend
to the valid keys and are masked by the caller. The inputs are the port's
own layout: the unpadded fused projection (B, T, 3C) laid out [q | k | v],
or separate (B, T, C) tensors, read through strides. The TPU version's
128-lane head pad, its sign-permuted q_rot/k_rot sections and its
128-multiple T gate are TPU layouts and are not carried over.

Both kernels take float32 or bfloat16 (every tensor in one dtype, as the
JAX gates ``supported``/``global_supported`` admit both), each dtype a
symbol of its own and a launch count of its own. The global kernel runs
``wgmma`` on tiles that TMA loads (3xTF32 in f32). In f32 the route follows
the layout alone (``global_f32_route``): q, k and v that start on 16 bytes
with batch and row strides and D multiples of 4 values (every serving
path's) take the TMA kernel; any other layout the general kernel
(``cp.async`` tiles, 3xTF32 ``mma.sync``), which counts its launches in
``GLOBAL_GENERAL_KERNEL`` beside the wrapper's count. bf16 has the TMA
kernel only: bf16 q, k and v must start on 16 bytes and have batch and row
strides of multiples of 8 values, else ValueError. In bf16 the products
take bf16 operands and accumulate in f32 (banded: one ``mma.sync``
m16n8k16 a fragment where f32 takes three 3xTF32 products); the
scores, the running max, the
row sums and the output accumulator are f32; p is rounded to bf16 before
p.v (and before p.rel_v); RoPE rotates in f32 from the f32 tables and
rounds the rotated q and k to bf16; the output is bf16. The JAX kernels
keep their score tiles and max in the input dtype, a TPU VPU economy that
is not carried over. The plain versions follow the same arithmetic in
either dtype, and return the input dtype.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import F, CudaKernel, I, L, P

MASK_VALUE = -1e4  # the reference masks with -1e4, not -inf
GLOBAL_MASK_VALUE = -30000.0  # the global kernels' finite key mask

_BANDED_ARGS = [P, P, P, P, P, P, P, I, I, I, I, I, I, P]
KERNEL = CudaKernel("banded_attention.cu", "banded_attention_f32", _BANDED_ARGS)
KERNEL_BF16 = CudaKernel("banded_attention.cu", "banded_attention_bf16", _BANDED_ARGS)

_GLOBAL_ARGS = [P, P, P, P, P, P, P, I, I, I, I, I, L, L, F, P]
_GLOBAL_ARGS_BF16 = _GLOBAL_ARGS[:-1] + [I, P]  # + the query rows a block
#: one source, three wrappers a dtype, each with its own launch count
GLOBAL_ROPE_KERNEL = CudaKernel("global_attention.cu", "global_attention_f32", _GLOBAL_ARGS)
GLOBAL_PACKED_KERNEL = CudaKernel("global_attention.cu", "global_attention_f32", _GLOBAL_ARGS)
GLOBAL_KERNEL = CudaKernel("global_attention.cu", "global_attention_f32", _GLOBAL_ARGS)
#: the f32 general route (layouts TMA cannot load), for all three f32 wrappers:
#: its count is of those launches alone, which the wrapper's count includes
GLOBAL_GENERAL_KERNEL = CudaKernel("global_attention.cu", "global_attention_f32_general",
                                   _GLOBAL_ARGS)
GLOBAL_ROPE_KERNEL_BF16 = CudaKernel("global_attention.cu", "global_attention_bf16",
                                     _GLOBAL_ARGS_BF16)
GLOBAL_PACKED_KERNEL_BF16 = CudaKernel("global_attention.cu", "global_attention_bf16",
                                       _GLOBAL_ARGS_BF16)
GLOBAL_KERNEL_BF16 = CudaKernel("global_attention.cu", "global_attention_bf16", _GLOBAL_ARGS_BF16)
TMA_ENCODE_ERROR = 100000  # the TMA kernels' code for a refused tensor map


def check_dtypes(what: str, *tensors) -> torch.dtype:
    """The one floating dtype of ``tensors``, else ValueError (mixed dtypes,
    or a dtype that is not floating): a plain version runs in any one
    floating dtype."""
    dtypes = {a.dtype for a in tensors}
    dtype = tensors[0].dtype
    if len(dtypes) != 1 or not dtype.is_floating_point:
        raise ValueError(f"{what}: the tensors must share one floating dtype, got "
                         f"{sorted(str(d) for d in dtypes)}")
    return dtype


def kernel_for(what: str, dtype, f32_kernel, bf16_kernel):
    """The kernel of ``dtype`` (float32 or bfloat16), else ValueError."""
    if dtype == torch.float32:
        return f32_kernel
    if dtype == torch.bfloat16:
        return bf16_kernel
    raise ValueError(f"{what}: the kernel takes float32 or bfloat16, got {dtype}")


def round_to(x, dtype):
    """x (f32) rounded to ``dtype`` and back: where the kernel rounds an f32
    value to the bf16 operand of a product (a no-op for float32)."""
    return x if dtype == x.dtype else x.to(dtype).to(x.dtype)


def banded_attention_plain(q, k, v, rel_k, rel_v, kv_len, *, window: int):
    """The plain version: materializes the (B, H, T, T) scores, in f32 for
    bf16 inputs (p rounded to bf16 before the two products with v and
    rel_v, the output bf16)."""
    dtype = check_dtypes("banded attention", q, k, v, rel_k, rel_v)
    if dtype == torch.bfloat16:
        q, k, v, rel_k, rel_v = (a.float() for a in (q, k, v, rel_k, rel_v))
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
    p = round_to(torch.softmax(scores, dim=-1), dtype)
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
    return (out + torch.einsum("bhlm,hmd->bhld", p_band, rel_v)).to(dtype)


def banded_flash_attention(q, k, v, rel_k, rel_v, kv_len, *, window: int):
    """q, k, v: (B, H, T, D), q PRE-SCALED by D^-1/2; rel_k, rel_v:
    (n_rel, 2w+1, D) with n_rel 1 (heads share) or H; kv_len: (B,) valid key
    prefix. Returns (B, H, T, D): the attention output including the
    relative-value term (everything but the output projection).

    All five share one dtype, float32 or bfloat16 (the output's); CPU
    tensors take the plain version; CUDA tensors launch the dtype's kernel."""
    if not q.is_cuda:
        return banded_attention_plain(q, k, v, rel_k, rel_v, kv_len, window=window)
    dtype = check_dtypes("banded attention kernel", q, k, v, rel_k, rel_v)
    kernel = kernel_for("banded attention kernel", dtype, KERNEL, KERNEL_BF16)
    b, h, t, d = q.shape
    n_rel = rel_k.shape[0]
    for name, a, shape in (("q", q, (b, h, t, d)), ("k", k, (b, h, t, d)),
                           ("v", v, (b, h, t, d)), ("rel_k", rel_k, (n_rel, 2 * window + 1, d)),
                           ("rel_v", rel_v, (n_rel, 2 * window + 1, d))):
        if not a.is_cuda or a.device != q.device:
            raise ValueError(f"banded attention kernel: {name} must be on {q.device}")
        if tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(f"banded attention kernel: {name} must be a contiguous {shape}, "
                             f"got {tuple(a.shape)}")
    if n_rel not in (1, h):
        raise ValueError(f"banded attention kernel: n_rel must be 1 or {h}, got {n_rel}")
    if d > 128:
        raise ValueError(f"banded attention kernel: head dim {d} > 128")
    if dtype == torch.bfloat16 and d % 8:
        raise ValueError(f"banded attention kernel: bf16 head dim {d} is not a multiple of 8")
    if kv_len.device != q.device or kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (b,) \
            or not kv_len.is_contiguous():
        raise ValueError("banded attention kernel: kv_len must be a contiguous (B,) int32 "
                         f"tensor on {q.device}")
    out = torch.empty_like(q)
    fn = kernel.fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_k.data_ptr(), rel_v.data_ptr(),
                 kv_len.data_ptr(), out.data_ptr(), b, h, t, d, window, n_rel,
                 ctypes.c_void_p(stream))
    kernel.check(err)
    kernel.launches += 1
    return out


def rope_tables(t: int, d_rope: int, device):
    """(T, d_rope/2) cos and sin of pos * theta_j in f32, with theta_j =
    1 / 10000^(2j/d_rope) (the formula of ``stabletts.rope``)."""
    theta = 1.0 / (10000.0 ** (torch.arange(0, d_rope, 2, dtype=torch.float32, device=device)
                               / d_rope))
    ang = torch.arange(t, dtype=torch.float32, device=device)[:, None] * theta[None, :]
    return torch.cos(ang), torch.sin(ang)


_ROPE_TABLES: dict = {}  # (T, d_rope, device) -> the kernel's tables; T comes from the buckets


def _cached_rope_tables(t: int, d_rope: int, device):
    key = (t, d_rope, device)
    if key not in _ROPE_TABLES:
        _ROPE_TABLES[key] = rope_tables(t, d_rope, device)
    return _ROPE_TABLES[key]


def apply_rope(x, cos, sin):
    """Rotate the first d = 2 * cos.shape[-1] features of x (..., T, D):
    x*cos + rotate_half(x)*sin, rotate_half(x) = (-x[d/2:d], x[:d/2])."""
    d2 = cos.shape[-1]
    d = 2 * d2
    cos2, sin2 = torch.cat([cos, cos], dim=-1), torch.cat([sin, sin], dim=-1)
    xr = x[..., :d]
    neg_half = torch.cat([-xr[..., d2:], xr[..., :d2]], dim=-1)
    return torch.cat([xr * cos2 + neg_half * sin2, x[..., d:]], dim=-1)


def global_attention_plain(q, k, v, kv_len, *, n_heads: int, sm_scale: float, d_rope: int = 0):
    """The plain version of all three global forms: q, k, v (B, T, C), any
    strides; materializes the (B, H, T, T) scores. bf16 inputs: RoPE in f32
    with the rotated q and k rounded to bf16, f32 scores (sm_scale applied
    to them), p rounded to bf16 before p.v, the output bf16."""
    dtype = check_dtypes("global attention", q, k, v)
    b, t, c = q.shape
    d = c // n_heads
    wide = torch.float32 if dtype == torch.bfloat16 else dtype
    heads = lambda a: a.reshape(b, t, n_heads, d).transpose(1, 2).to(wide)
    q, k, v = heads(q), heads(k), heads(v)
    if d_rope:
        cos, sin = rope_tables(t, d_rope, q.device)
        q, k = (round_to(apply_rope(a, cos, sin), dtype) for a in (q, k))
    scores = torch.matmul(q, k.transpose(-1, -2)) * sm_scale
    keys = torch.arange(t, device=q.device)
    scores = scores.masked_fill(keys[None, None, None, :] >= kv_len[:, None, None, None],
                                GLOBAL_MASK_VALUE)
    p = round_to(torch.softmax(scores, dim=-1), dtype)
    return torch.matmul(p, v).transpose(1, 2).reshape(b, t, c).to(dtype)


_SMS: dict = {}  # device -> its streaming multiprocessors


def global_f32_route(ptrs, stride_b: int, stride_t: int, d: int) -> str:
    """Which f32 global kernel takes q, k and v at the addresses ``ptrs``
    with batch and row strides ``stride_b``, ``stride_t`` and head dim
    ``d`` (values): "tma" where TMA can load them (every start on 16 bytes;
    the strides and d multiples of 4 values, 16 bytes), else "general".
    The layout alone decides, never the shape."""
    aligned = all(p % 16 == 0 for p in ptrs)
    return "tma" if aligned and stride_b % 4 == 0 and stride_t % 4 == 0 and d % 4 == 0 \
        else "general"


def global_block_rows(b: int, h: int, t: int, n_sm: int) -> int:
    """Query rows a block of the bf16 global kernel takes (a block an SM):
    64 (one consumer warpgroup) where twice the blocks of 128 rows still
    fit on the card's ``n_sm`` SMs at once, which spreads a small grid over
    twice the SMs; else 128 (two consumer warpgroups)."""
    return 64 if 2 * -(-t // 128) * h * b <= n_sm else 128


def _launch_global(kernels, inputs, ptrs, kv_len, *, b, t, c, n_heads, sm_scale, d_rope,
                   stride_b, stride_t):
    """Check the arguments of the global kernel and launch the one of
    ``kernels`` (float32, bfloat16) for the dtype of ``inputs`` (qkv, or q,
    k and v, as the caller took them and checked their shapes): q, k and v
    are (B, T, C) at the addresses ``ptrs``, with strides (stride_b,
    stride_t, 1). Returns (the output, the kernel launched)."""
    dtype = check_dtypes("global attention kernel", *inputs)
    kernel = kernel_for("global attention kernel", dtype, *kernels)
    if n_heads <= 0 or c % n_heads:
        raise ValueError(f"global attention kernel: {c} channels do not split into {n_heads} heads")
    d = c // n_heads
    if d > 128:
        raise ValueError(f"global attention kernel: head dim {d} > 128")
    if d_rope < 0 or d_rope % 2 or d_rope > d:
        raise ValueError(f"global attention kernel: d_rope {d_rope} must be even and <= {d}")
    device = inputs[0].device
    if any(a.device != device for a in inputs[1:]):
        raise ValueError(f"global attention kernel: q, k and v must be on {device}")
    if kv_len.device != device or kv_len.dtype != torch.int32 or kv_len.shape != (b,) \
            or not kv_len.is_contiguous():
        raise ValueError("global attention kernel: kv_len must be a contiguous (B,) int32 "
                         f"tensor on {device}")
    stride_b = t * stride_t if b == 1 else stride_b  # never read for one item
    launched, block = kernel, ()
    if dtype == torch.float32:
        if global_f32_route(ptrs, stride_b, stride_t, d) == "general":
            launched = GLOBAL_GENERAL_KERNEL
    else:  # bf16: q, k and v arrive by TMA
        if d % 8:
            raise ValueError(f"global attention kernel: bf16 head dim {d} is not a multiple of 8")
        for name, ptr in zip("qkv", ptrs):
            if ptr % 16:
                raise ValueError(f"global attention kernel: bf16 {name} starts at {ptr:#x}, "
                                 "not on 16 bytes, so TMA cannot load it")
        if stride_b % 8 or stride_t % 8:
            raise ValueError(f"global attention kernel: bf16 strides ({stride_b}, {stride_t}) "
                             "are not multiples of 8 values (16 bytes), so TMA cannot load them")
        if device not in _SMS:
            _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
        block = (global_block_rows(b, n_heads, t, _SMS[device]),)
    cos = sin = None
    if d_rope:
        cos, sin = _cached_rope_tables(t, d_rope, device)
    out = torch.empty(b, t, c, dtype=dtype, device=device)
    args = (*ptrs, cos.data_ptr() if d_rope else None, sin.data_ptr() if d_rope else None,
            kv_len.data_ptr(), out.data_ptr(), b, n_heads, t, d, d_rope, stride_b, stride_t,
            sm_scale, *block)
    # the launch on device's current stream with device current (the context
    # switch, a few microseconds, only where it is not)
    if device.index == torch.cuda.current_device():
        err = launched.fn()(*args, torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            err = launched.fn()(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if err >= TMA_ENCODE_ERROR:
        raise RuntimeError(f"{launched.symbol}: cuTensorMapEncodeTiled refused a TMA tensor map "
                           f"(CUresult {err - TMA_ENCODE_ERROR}; 0: it was not found)")
    launched.check(err)
    if launched is GLOBAL_GENERAL_KERNEL:
        launched.launches += 1
    return out, kernel


def _split_packed(qkv):
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"packed attention: qkv must be (B, T, 3C), got {tuple(qkv.shape)}")
    c = qkv.shape[-1] // 3
    return qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]


def _launch_packed(kernels, qkv, kv_len, **kw):
    """_launch_global on the q, k and v sections of a (B, T, 3C) qkv."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3 or qkv.stride(2) != 1:
        raise ValueError("packed attention: qkv must be (B, T, 3C) with unit feature stride, "
                         f"got {tuple(qkv.shape)} with strides {qkv.stride()}")
    b, t, c3 = qkv.shape
    p, step = qkv.data_ptr(), c3 // 3 * qkv.element_size()
    return _launch_global(kernels, (qkv,), (p, p + step, p + 2 * step), kv_len, b=b, t=t,
                          c=c3 // 3, stride_b=qkv.stride(0), stride_t=qkv.stride(1), **kw)


def global_flash_attention_rope(qkv, kv_len, *, n_heads: int, sm_scale: float, d_rope: int):
    """The DiT attention: ``qkv`` (B, T, 3C) is the fused projection's
    output [q | k | v] (any batch and row strides, unit feature stride); RoPE on the first ``d_rope`` features of each q and
    k head; kv_len (B,) the valid key prefix. Returns (B, T, C).

    float32 or bfloat16 (the output's); CPU tensors take the plain version;
    CUDA tensors launch the dtype's kernel. The RoPE tables stay f32."""
    if not qkv.is_cuda:
        return global_attention_plain(*_split_packed(qkv), kv_len, n_heads=n_heads,
                                      sm_scale=sm_scale, d_rope=d_rope)
    out, kernel = _launch_packed((GLOBAL_ROPE_KERNEL, GLOBAL_ROPE_KERNEL_BF16), qkv, kv_len,
                                 n_heads=n_heads, sm_scale=sm_scale, d_rope=d_rope)
    kernel.launches += 1
    return out


def global_flash_attention_packed(qkv, kv_len, *, n_heads: int, sm_scale: float):
    """Masked global attention over a packed (B, T, 3C) [q | k | v], no
    RoPE. Returns (B, T, C).

    float32 or bfloat16 (the output's); CPU tensors take the plain version;
    CUDA tensors launch the dtype's kernel."""
    if not qkv.is_cuda:
        return global_attention_plain(*_split_packed(qkv), kv_len, n_heads=n_heads,
                                      sm_scale=sm_scale)
    out, kernel = _launch_packed((GLOBAL_PACKED_KERNEL, GLOBAL_PACKED_KERNEL_BF16), qkv, kv_len,
                                 n_heads=n_heads, sm_scale=sm_scale, d_rope=0)
    kernel.launches += 1
    return out


def global_flash_attention(q, k, v, kv_len, *, n_heads: int, sm_scale: float):
    """Masked global attention over separate contiguous (B, T, C) q, k, v
    (not pre-scaled), no RoPE. Returns (B, T, C).

    float32 or bfloat16, one dtype (the output's); CPU tensors take the
    plain version; CUDA tensors launch the dtype's kernel."""
    if not q.is_cuda:
        return global_attention_plain(q, k, v, kv_len, n_heads=n_heads, sm_scale=sm_scale)
    b, t, c = q.shape
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.shape != q.shape or a.stride() != (t * c, c, 1):
            raise ValueError(f"global attention kernel: {name} must be a contiguous ({b}, {t}, "
                             f"{c}) tensor")
    out, kernel = _launch_global((GLOBAL_KERNEL, GLOBAL_KERNEL_BF16), (q, k, v),
                                 (q.data_ptr(), k.data_ptr(), v.data_ptr()), kv_len, b=b, t=t,
                                 c=c, n_heads=n_heads, sm_scale=sm_scale, d_rope=0,
                                 stride_b=t * c, stride_t=c)
    kernel.launches += 1
    return out
