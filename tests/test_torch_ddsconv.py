"""Fused DDSConv stack of the PyTorch port vs the JAX package.

The port's plain version is held against the JAX Pallas kernel in
interpret mode and against the XLA ``ddsconv_apply``, with ragged lengths
and random LayerNorm affines. The JAX kernel's GELU uses the
Abramowitz-Stegun erf (|err| <= 1.5e-7 per GELU); the port uses a true erf
like ``ddsconv_apply``, so the interpret comparison allows 2e-5 and the XLA
one 1e-5 (f32, three layers of LayerNorm).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vosk_tts_tpu.ops import ddsconv_fused as jddf
from vosk_tts_tpu.ops import wn as jwn
from vosk_tts_tpu_torch.ops import ddsconv_fused as tddf
from vosk_tts_tpu_torch.ops import wn as twn
from vosk_tts_tpu_torch.utils.params import to_port_layout, to_torch


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _case(t, lengths, c, seed):
    rng = np.random.default_rng(seed)
    params = jax.device_get(jwn.ddsconv_init(jax.random.PRNGKey(seed), c, 3, 3))
    for key in ("norm1", "norm2"):
        for n in params[key]:
            n["gamma"] = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
            n["beta"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]
    x = rng.standard_normal((len(lengths), t, c)).astype(np.float32)
    return params, x, mask


@pytest.mark.parametrize("t,lengths,c", [(37, [37, 20], 256), (64, [64, 5], 256), (8, [8, 3], 128)])
def test_plain_matches_pallas_interpret(t, lengths, c):
    params, x, mask = _case(t, lengths, c, t)
    want = jddf.ddsconv_fused(jnp.asarray(x), jnp.asarray(mask), params, kernel_size=3,
                              interpret=True)
    got = tddf.ddsconv_plain(torch.from_numpy(x), torch.from_numpy(mask),
                             to_torch(to_port_layout(params), "cpu"), kernel_size=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("t,lengths", [(37, [37, 20]), (96, [96, 50])])
def test_apply_matches_xla(t, lengths):
    """wn.ddsconv_apply with conditioning g (the SDP's form): on the CPU the
    wrapper runs the plain version."""
    params, x, mask = _case(t, lengths, 256, 100 + t)
    g = np.random.default_rng(t).standard_normal(x.shape).astype(np.float32)
    want = jwn.ddsconv_apply(params, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(g),
                             kernel_size=3)
    got = twn.ddsconv_apply(to_torch(to_port_layout(params), "cpu"), torch.from_numpy(x),
                            torch.from_numpy(mask), torch.from_numpy(g), kernel_size=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_kernel_size_mismatch_raises():
    params, x, mask = _case(16, [16], 128, 7)
    with pytest.raises(ValueError):
        tddf.ddsconv_fused(torch.from_numpy(x), torch.from_numpy(mask),
                           to_torch(to_port_layout(params), "cpu"), kernel_size=5)


@pytest.mark.parametrize("c,n_layers,k", [
    (256, 3, 3), (32, 3, 3), (192, 2, 5), (256, 1, 3), (256, 12, 1), (256, 5, 3),
    (32, 1, 801), (32, 2, 29), (64, 12, 3)])
def test_check_shape_takes_the_kernels_domain(c, n_layers, k):
    """C a multiple of 32 up to 256, odd K, L >= 1, a halo up to 2^20 rows:
    whether the window then fits shared memory is the built kernel's
    plan's to say (tests/test_torch_cuda_kernels.py)."""
    tddf.check_shape(c, n_layers, k)


@pytest.mark.parametrize("c,n_layers,k", [(288, 3, 3), (48, 3, 3), (0, 3, 3), (-32, 3, 3),
                                          (256, 3, 4), (256, 3, 0), (256, 0, 3), (256, 40, 3),
                                          (32, 3, 1001)])
def test_check_shape_refuses(c, n_layers, k):
    with pytest.raises(ValueError):
        tddf.check_shape(c, n_layers, k)
