"""The bf16 plain versions of the port's kernels vs the JAX Pallas kernels in bf16.

Each JAX kernel admits bfloat16 (``supported``, ``global_supported``,
``ddsconv_fused.supported``); the port's wrappers take bf16 on the CPU
through their plain versions, which repeat the bf16 CUDA kernels'
arithmetic (f32 scores and statistics, p rounded to bf16 before p.v, bf16
out; DDSConv's LayerNorm and GELU in f32). The JAX kernels run in interpret
mode on the same bf16 inputs, made by numpy from a seed. They keep their
score tiles and running max in bf16 (a TPU economy the port leaves out), so
the two differ by bf16 roundings: each tolerance is about twice the largest
error measured here, relative to max |out| (bf16's unit roundoff is 2^-8 =
3.9e-3), and stated beside the case. The wrappers refuse mixed or
non-floating dtypes. The bf16 global kernel's block height
(``global_block_rows``) is a pure function of the shape and the card's SM
count, held here to the rule its source states.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vosk_tts_tpu.models import stabletts as jst
from vosk_tts_tpu.ops import ddsconv_fused as jddf
from vosk_tts_tpu.ops import flash_attention as jfa
from vosk_tts_tpu.ops import wn as jwn
from vosk_tts_tpu_torch.models import stabletts as tst
from vosk_tts_tpu_torch.ops import ddsconv_fused as tddf
from vosk_tts_tpu_torch.ops import flash_attention as tfa
from vosk_tts_tpu_torch.utils.params import to_port_layout, to_torch

BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def _bf16(*arrays):
    """numpy f32 -> (jax bf16, torch bf16) pairs of the same values."""
    return [(jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(BF16)) for a in arrays]


def _rel_err(got, want, rows=None):
    """max |got - want| / max |want| over the valid rows (rows[i]: item i's)."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    if rows is not None:
        got = np.concatenate([got[i, :n] for i, n in enumerate(rows)])
        want = np.concatenate([want[i, :n] for i, n in enumerate(rows)])
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("n_rel", [1, 2])
@pytest.mark.parametrize("t,lengths", [(128, [128, 77]), (256, [256, 131])])
def test_banded_bf16_matches_pallas_interpret(t, lengths, n_rel):
    rng = np.random.default_rng(300 + t + n_rel)
    b, h, d, w = len(lengths), 2, 96, 4
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3))
    q *= d**-0.5
    rel_k, rel_v = (rng.standard_normal((n_rel, 2 * w + 1, d)).astype(np.float32) * d**-0.5
                    for _ in range(2))
    pairs = _bf16(q, k, v, rel_k, rel_v)
    kv_len = np.asarray(lengths, np.int32)
    want = jfa.banded_flash_attention(*(j for j, _ in pairs), jnp.asarray(kv_len), window=w,
                                      interpret=True)
    got = tfa.banded_flash_attention(*(t_ for _, t_ in pairs), torch.from_numpy(kv_len), window=w)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    # measured <= 1.25e-2 (p and the score tiles rounded at other places)
    assert _rel_err(got, want) < 2.5e-2


@pytest.mark.parametrize("d_head,lengths", [(64, [256, 100]), (96, [256, 37])])
def test_separate_bf16_matches_pallas_interpret(d_head, lengths):
    rng = np.random.default_rng(400 + d_head)
    heads = 2
    q, k, v = (rng.standard_normal((len(lengths), 256, heads * d_head)).astype(np.float32)
               for _ in range(3))
    pairs = _bf16(q, k, v)
    kv_len = np.asarray(lengths, np.int32)
    want = jfa.global_flash_attention(*(j for j, _ in pairs), jnp.asarray(kv_len),
                                      n_heads=heads, sm_scale=d_head**-0.5, interpret=True)
    got = tfa.global_flash_attention(*(t_ for _, t_ in pairs), torch.from_numpy(kv_len),
                                     n_heads=heads, sm_scale=d_head**-0.5)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    # measured <= 7.1e-3 (JAX scales the bf16-rounded scores; the port scales in f32)
    assert _rel_err(got, want, lengths) < 1.5e-2


def test_packed_bf16_matches_pallas_interpret():
    rng = np.random.default_rng(407)
    lengths, heads, d_head = [256, 130], 2, 128
    qkv = rng.standard_normal((2, 256, 3 * heads * d_head)).astype(np.float32)
    (jq, tq), = _bf16(qkv)
    kv_len = np.asarray(lengths, np.int32)
    want = jfa.global_flash_attention_packed(jq, jnp.asarray(kv_len), n_heads=heads,
                                             sm_scale=d_head**-0.5, interpret=True)
    got = tfa.global_flash_attention_packed(tq, torch.from_numpy(kv_len), n_heads=heads,
                                            sm_scale=d_head**-0.5)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    # measured 1.34e-2
    assert _rel_err(got, want, lengths) < 2.7e-2


@pytest.mark.parametrize("channels,heads,lengths", [(128, 2, [256, 200]), (192, 2, [256, 77])])
def test_rope_bf16_matches_dit_flash_route(channels, heads, lengths):
    """The DiT attention with in-kernel RoPE, bf16 weights and input: the
    TPU flash route of the JAX package (its 5-section padded projection)
    against the port's ``dit_mha_apply`` (fused projection, kernel 3's
    plain version)."""
    rng = np.random.default_rng(500 + channels)
    params = jax.device_get(jst.dit_mha_init(jax.random.PRNGKey(channels), channels, heads))
    x = rng.standard_normal((len(lengths), 256, channels)).astype(np.float32)
    seq_mask = (np.arange(256)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    want = jst._dit_mha_flash(jparams, jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(seq_mask, jnp.bfloat16), n_heads=heads, interpret=True)
    port = to_torch(tst.fuse_qkv(to_port_layout(params)), "cpu", BF16)
    got = tst.dit_mha_apply(port, torch.from_numpy(x).to(BF16),
                            torch.tensor(lengths, dtype=torch.int32), n_heads=heads)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    # measured <= 2.09e-2 (the projections and the rotation round in bf16 at other places)
    assert _rel_err(got, want, lengths) < 4.2e-2


@pytest.mark.parametrize("t,lengths,c", [(64, [64, 5], 256), (37, [37, 20], 128)])
def test_ddsconv_bf16_matches_pallas_interpret(t, lengths, c):
    rng = np.random.default_rng(600 + t)
    params = jax.device_get(jwn.ddsconv_init(jax.random.PRNGKey(t), c, 3, 3))
    for key in ("norm1", "norm2"):
        for n in params[key]:
            n["gamma"] = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
            n["beta"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]
    x = rng.standard_normal((len(lengths), t, c)).astype(np.float32)
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    want = jddf.ddsconv_fused(jnp.asarray(x, jnp.bfloat16), jnp.asarray(mask, jnp.bfloat16),
                              jparams, kernel_size=3, interpret=True)
    got = tddf.ddsconv_fused(torch.from_numpy(x).to(BF16), torch.from_numpy(mask).to(BF16),
                             to_torch(to_port_layout(params), "cpu", BF16), kernel_size=3)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    # measured <= 8.6e-3 (JAX sums the depthwise taps in bf16, the port in f32)
    assert _rel_err(got, want) < 1.7e-2


def _banded_args(dtypes):
    rng = np.random.default_rng(0)
    shapes = [(1, 2, 16, 8)] * 3 + [(1, 9, 8)] * 2
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dt)
            for s, dt in zip(shapes, dtypes)] + [torch.tensor([16], dtype=torch.int32)]


@pytest.mark.parametrize("dtypes", [
    (BF16, BF16, BF16, torch.float32, torch.float32),  # f32 tables, bf16 activations
    (BF16, torch.float32, BF16, BF16, BF16),
    (torch.int32,) * 5,
])
def test_banded_refuses_mixed_or_integer_dtypes(dtypes):
    with pytest.raises(ValueError, match="dtype"):
        tfa.banded_flash_attention(*_banded_args(dtypes), window=4)


@pytest.mark.parametrize("form", ["separate", "packed", "rope"])
def test_global_refuses_mixed_or_integer_dtypes(form):
    kv_len = torch.tensor([8], dtype=torch.int32)
    if form == "separate":
        q = torch.zeros(1, 8, 16, dtype=BF16)
        with pytest.raises(ValueError, match="dtype"):
            tfa.global_flash_attention(q, q.float(), q, kv_len, n_heads=2, sm_scale=0.25)
        return
    qkv = torch.zeros(1, 8, 48, dtype=torch.int32)
    fn = tfa.global_flash_attention_packed if form == "packed" else \
        lambda *a, **k: tfa.global_flash_attention_rope(*a, d_rope=4, **k)
    with pytest.raises(ValueError, match="dtype"):
        fn(qkv, kv_len, n_heads=2, sm_scale=0.25)


def test_ddsconv_refuses_mixed_dtypes():
    params = to_torch(to_port_layout(jax.device_get(jwn.ddsconv_init(jax.random.PRNGKey(0),
                                                                     32, 3, 3))), "cpu", BF16)
    params["pw_w"] = params["pw_w"].float()  # one f32 weight in a bf16 tree
    x, mask = torch.zeros(1, 8, 32, dtype=BF16), torch.ones(1, 8, 1, dtype=BF16)
    with pytest.raises(ValueError, match="dtype"):
        tddf.ddsconv_fused(x, mask, params, kernel_size=3)


# (B, H, T, rows) on a 132-SM card: 64-row blocks where twice the 128-row grid
# fits on the SMs at once (the DiT's one-request shapes, one flow request),
# else 128 (the batched DiT, the flow batch)
@pytest.mark.parametrize("b,h,t,rows", [(2, 4, 512, 64), (1, 2, 397, 64), (1, 4, 64, 64),
                                        (4, 4, 512, 64), (5, 4, 512, 128), (16, 4, 256, 128),
                                        (16, 4, 1024, 128), (16, 2, 2048, 128), (2, 4, 2048, 128)])
def test_global_block_rows(b, h, t, rows):
    assert tfa.global_block_rows(b, h, t, 132) == rows
    blocks = -(-t // rows) * h * b
    assert blocks <= 132 if rows == 64 else 2 * -(-t // 128) * h * b > 132
    assert tfa.global_block_rows(b, h, t, 2 * blocks * (rows // 64)) == 64  # a card twice as wide
