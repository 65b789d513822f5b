"""Global (DiT) attention of the PyTorch port vs the JAX package.

The port's plain version of the global kernel, in its three forms, is held
against the JAX Pallas kernels in interpret mode: ``global_flash_attention``
(separate q, k, v), ``global_flash_attention_packed`` (packed [q|k|v], dk
128, the TPU layout's head width) and, for the RoPE form, the TPU flash route
of ``stabletts.dit_mha_apply`` (``_dit_mha_flash``, which builds the padded
q_rot/k_rot sections) against the port's ``dit_mha_apply`` on the same
weights. T=256 (the Pallas kernels' 128-multiple gate), ragged lengths,
valid rows only: the kernels mask keys only and spread rows past kv_len
over the valid keys. f32; rtol and atol 2e-5, as tests/test_flash_attention.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vosk_tts_tpu.models import stabletts as jst
from vosk_tts_tpu.ops import flash_attention as jfa
from vosk_tts_tpu_torch.models import stabletts as tst
from vosk_tts_tpu_torch.ops import flash_attention as tfa
from vosk_tts_tpu_torch.utils.params import to_port_layout, to_torch

T = 256
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _valid_rows_close(got, want, lengths):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(got[i, :n], want[i, :n], **TOL)


@pytest.mark.parametrize("d_head,lengths", [(64, [256, 100]), (96, [256, 37])])
def test_separate_matches_pallas_interpret(d_head, lengths):
    rng = np.random.default_rng(d_head)
    heads = 2
    q, k, v = (rng.standard_normal((len(lengths), T, heads * d_head)).astype(np.float32)
               for _ in range(3))
    kv_len = np.asarray(lengths, np.int32)
    want = jfa.global_flash_attention(*(jnp.asarray(a) for a in (q, k, v, kv_len)),
                                      n_heads=heads, sm_scale=d_head**-0.5, interpret=True)
    got = tfa.global_flash_attention(*(torch.from_numpy(a) for a in (q, k, v, kv_len)),
                                     n_heads=heads, sm_scale=d_head**-0.5)
    _valid_rows_close(got, want, lengths)


def test_packed_matches_pallas_interpret():
    rng = np.random.default_rng(7)
    lengths, heads, d_head = [256, 130], 2, 128
    qkv = rng.standard_normal((2, T, 3 * heads * d_head)).astype(np.float32)
    kv_len = np.asarray(lengths, np.int32)
    want = jfa.global_flash_attention_packed(jnp.asarray(qkv), jnp.asarray(kv_len), n_heads=heads,
                                             sm_scale=d_head**-0.5, interpret=True)
    got = tfa.global_flash_attention_packed(torch.from_numpy(qkv), torch.from_numpy(kv_len),
                                            n_heads=heads, sm_scale=d_head**-0.5)
    _valid_rows_close(got, want, lengths)


@pytest.mark.parametrize("channels,heads,lengths", [(128, 2, [256, 200]), (192, 2, [256, 77])])
def test_rope_form_matches_dit_flash_route(channels, heads, lengths):
    """dk 64 (d_rope 32) and dk 96 (d_rope 48): the TPU flash route reads a
    (B, T, 5*H*128) packed projection with sign-permuted rot sections; the
    port a (B, T, 3C) fused projection with the rotation in the kernel."""
    rng = np.random.default_rng(channels)
    params = jst.dit_mha_init(jax.random.PRNGKey(channels), channels, heads)
    x = rng.standard_normal((len(lengths), T, channels)).astype(np.float32)
    seq_mask = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    want = jst._dit_mha_flash(params, jnp.asarray(x), jnp.asarray(seq_mask), n_heads=heads,
                              interpret=True)
    port = to_torch(tst.fuse_qkv(to_port_layout(jax.device_get(params))), "cpu")
    got = tst.dit_mha_apply(port, torch.from_numpy(x), torch.tensor(lengths, dtype=torch.int32),
                            n_heads=heads)
    _valid_rows_close(got, want, lengths)


@pytest.mark.parametrize("t,d,d_rope", [(37, 96, 48), (5, 64, 32), (130, 32, 0)])
def test_plain_forms_agree(t, d, d_rope):
    """The three wrappers' plain paths are one function: the packed and the
    separate forms read the same numbers, and d_rope=0 is no rotation."""
    rng = np.random.default_rng(t)
    b, h = 2, 2
    c = h * d
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3 * c)).astype(np.float32))
    kv_len = torch.tensor([t, max(1, t // 3)], dtype=torch.int32)
    q, k, v = (qkv[..., i * c:(i + 1) * c].contiguous() for i in range(3))
    sep = tfa.global_flash_attention(q, k, v, kv_len, n_heads=h, sm_scale=0.1)
    packed = tfa.global_flash_attention_packed(qkv, kv_len, n_heads=h, sm_scale=0.1)
    rope0 = tfa.global_flash_attention_rope(qkv, kv_len, n_heads=h, sm_scale=0.1, d_rope=0)
    assert torch.equal(sep, packed) and torch.equal(packed, rope0)
    roped = tfa.global_flash_attention_rope(qkv, kv_len, n_heads=h, sm_scale=0.1, d_rope=d_rope)
    rq = tst.rope(q.reshape(b, t, h, d), d_rope, time_axis=1).reshape(b, t, c) if d_rope else q
    rk = tst.rope(k.reshape(b, t, h, d), d_rope, time_axis=1).reshape(b, t, c) if d_rope else k
    np.testing.assert_allclose(roped.numpy(), tfa.global_flash_attention(
        rq, rk, v, kv_len, n_heads=h, sm_scale=0.1).numpy(), rtol=1e-6, atol=1e-6)
