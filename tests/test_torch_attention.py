"""Banded rel-pos attention of the PyTorch port vs the JAX package.

The port's plain version of the banded kernel is held against the JAX
Pallas kernel in interpret mode (all rows: both attend every row to the
valid keys) and against the XLA path of ``mha_apply`` (valid rows only:
the XLA path spreads rows past kv_len uniformly instead). f32 throughout;
tolerances as tests/test_flash_attention.py (rtol 1e-5, atol 2e-5) for one
attention, looser for stacks of layers (summation order differs per layer).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vosk_tts_tpu.ops import attention as jatt
from vosk_tts_tpu.ops import flash_attention as jfa
from vosk_tts_tpu_torch.ops import attention as tatt
from vosk_tts_tpu_torch.ops import flash_attention as tfa
from vosk_tts_tpu_torch.utils.params import to_port_layout, to_torch


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port(tree):
    return to_torch(to_port_layout(jax.device_get(tree)), "cpu")


def _mask(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)


@pytest.mark.parametrize("n_rel", [1, 2])
@pytest.mark.parametrize("t,lengths", [(128, [128, 77]), (256, [256, 131])])
def test_banded_plain_matches_pallas_interpret(t, lengths, n_rel):
    rng = np.random.default_rng(t + n_rel)
    b, h, d, w = len(lengths), 2, 96, 4
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3))
    q *= d**-0.5
    rel_k, rel_v = (rng.standard_normal((n_rel, 2 * w + 1, d)).astype(np.float32) * d**-0.5
                    for _ in range(2))
    kv_len = np.asarray(lengths, np.int32)

    want = jfa.banded_flash_attention(*(jnp.asarray(a) for a in (q, k, v, rel_k, rel_v, kv_len)),
                                      window=w, interpret=True)
    got = tfa.banded_flash_attention(*(torch.from_numpy(a) for a in (q, k, v, rel_k, rel_v,
                                                                     kv_len)), window=w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("t,lengths", [(37, [37, 20]), (64, [64, 9]), (5, [5, 3])])
def test_mha_matches_xla_path(t, lengths):
    """Ragged T (no 128-multiple gate in the port) and ragged kv_len; T=5 is
    below 2w+1, where the XLA path takes its non-banded rel-pos branch."""
    rng = np.random.default_rng(t)
    b, ch, heads, w = len(lengths), 64, 2, 4
    params = jatt.mha_init(jax.random.PRNGKey(t), ch, ch, heads, window_size=w)
    mask = _mask(lengths, t)[..., None]
    x = rng.standard_normal((b, t, ch)).astype(np.float32) * mask
    attn_mask = mask[:, None, :, 0][:, :, None, :] * mask[:, None, :, 0][:, :, :, None]

    want = jatt.mha_apply(params, jnp.asarray(x), jnp.asarray(x), jnp.asarray(attn_mask),
                          n_heads=heads, window_size=w)
    xt = torch.from_numpy(x)
    got = tatt.mha_apply(_port(params), xt, xt, n_heads=heads, window_size=w,
                         kv_len=torch.tensor(lengths, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy() * mask, np.asarray(want) * mask, rtol=1e-5, atol=2e-5)


def test_encoder_matches_xla_path():
    """Three layers with speaker conditioning at layer 2 (the text encoder's
    form); masked output, so every position compares."""
    rng = np.random.default_rng(3)
    b, t, ch, heads, gin = 2, 64, 64, 2, 8
    params = jatt.encoder_init(jax.random.PRNGKey(3), ch, 2 * ch, heads, 3, 3, gin=gin)
    mask = _mask([64, 41], t)[..., None]
    x = rng.standard_normal((b, t, ch)).astype(np.float32) * mask
    g = rng.standard_normal((b, 1, gin)).astype(np.float32)

    want = jatt.encoder_apply(params, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(g),
                              n_heads=heads, kernel_size=3)
    got = tatt.encoder_apply(_port(params), torch.from_numpy(x), torch.from_numpy(mask),
                             torch.from_numpy(g), n_heads=heads, kernel_size=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_ffn_matches():
    rng = np.random.default_rng(4)
    params = jatt.ffn_init(jax.random.PRNGKey(4), 32, 32, 64, 5)
    mask = _mask([40, 17], 40)[..., None]
    x = rng.standard_normal((2, 40, 32)).astype(np.float32)
    want = jatt.ffn_apply(params, jnp.asarray(x), jnp.asarray(mask), kernel_size=5)
    got = tatt.ffn_apply(_port(params), torch.from_numpy(x), torch.from_numpy(mask), kernel_size=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
