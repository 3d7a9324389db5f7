"""The port's ops (``powerpaint_tpu_torch.ops``) against the JAX package's.

On the CPU each wrapper runs its kernel's plain version; these tests hold
that plain version, which is also the kernel's oracle on the card, to the
Pallas kernels it replaces (in interpret mode) and to the JAX package's XLA
formulations, on the same numpy inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from powerpaint_tpu.ops.attention import xla_attention
from powerpaint_tpu.ops.flash_attention import flash_attention as jax_flash
from powerpaint_tpu.ops.groupnorm import group_norm as jax_group_norm
from powerpaint_tpu.ops.groupnorm import layer_norm as jax_layer_norm
from powerpaint_tpu.ops.norms_pallas import group_norm_fused, layer_norm_fused
from powerpaint_tpu_torch.ops import flash_attention as fa
from powerpaint_tpu_torch.ops import norms
from powerpaint_tpu_torch.ops.attention import attention


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


@pytest.mark.parametrize(
    "b,sq,skv,n,d,block",
    [
        (1, 256, 256, 2, 64, 128),   # even blocks
        (2, 300, 300, 2, 40, 128),   # ragged seq, SD head dim 40
        (1, 128, 77, 1, 64, 64),     # cross-attention-like ragged kv
        (1, 512, 512, 4, 160, 256),  # SD mid-block head dim
        (2, 64, 77, 2, 40, 64),      # kv = 77 text tokens at head dim 40
        (1, 256, 256, 1, 512, 128),  # the VAE's one-head D = 512
    ],
)
def test_flash_plain_matches_pallas_and_xla(b, sq, skv, n, d, block):
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(b, s, n, d).astype(np.float32)
               for s in (sq, skv, skv))
    pallas = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       block_q=block, block_kv=block, debug_interpret=True)
    xla = xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = fa.flash_attention_plain(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(xla), atol=2e-5)


def test_attention_dispatch_on_cpu_is_the_plain_version_and_not_counted():
    rng = np.random.RandomState(1)
    q = _t(rng.randn(2, 64, 2, 16))
    k = _t(rng.randn(2, 77, 2, 16))
    before = fa.flash_attention.launches
    out = attention(q, k, k)
    assert fa.flash_attention.launches == before
    torch.testing.assert_close(out, fa.flash_attention_plain(q, k, k),
                               rtol=0, atol=0)


def test_flash_plain_bf16_close_to_fp32():
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(1, 256, 2, 64).astype(np.float32) for _ in range(3))
    ref = np.asarray(xla_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v)))
    out = fa.flash_attention_plain(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                                   _t(v, torch.bfloat16))
    assert out.dtype == torch.bfloat16
    assert np.abs(out.float().numpy() - ref).mean() < 0.02


@pytest.mark.parametrize("shape", [(2, 4096, 320), (1, 77, 768), (3, 100, 640)])
def test_layer_norm_plain_matches_pallas_and_xla(shape):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32) * 3 + 0.5
    g = rng.randn(shape[-1]).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    got = norms.layer_norm(_t(x), _t(g), _t(b), eps=1e-5).numpy()
    for want in (layer_norm_fused(jnp.asarray(x), jnp.asarray(g),
                                  jnp.asarray(b), eps=1e-5, interpret=True),
                 jax_layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                                eps=1e-5)):
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=1e-5)
    # bf16 input, fp32 statistics
    got = norms.layer_norm(_t(x, torch.bfloat16), _t(g), _t(b), eps=1e-5)
    want = jax_layer_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g),
                          jnp.asarray(b), eps=1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=4e-2)


@pytest.mark.parametrize("shape,groups,silu", [
    ((2, 64, 64, 320), 32, True),
    ((2, 64, 64, 320), 32, False),
    ((1, 16, 16, 128), 8, True),
    ((4, 8, 8, 64), 4, False),
])
def test_group_norm_plain_matches_pallas_and_xla(shape, groups, silu):
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype(np.float32) * 2 - 0.3
    g = rng.randn(shape[-1]).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    kw = dict(num_groups=groups, eps=1e-6, silu=silu)
    got = norms.group_norm(_t(x), _t(g), _t(b), **kw).numpy()
    for want in (group_norm_fused(jnp.asarray(x), jnp.asarray(g),
                                  jnp.asarray(b), interpret=True, **kw),
                 jax_group_norm(jnp.asarray(x), jnp.asarray(g),
                                jnp.asarray(b), **kw)):
        np.testing.assert_allclose(got, np.asarray(want), atol=5e-5, rtol=1e-4)


def test_group_norm_plain_bf16():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 32, 32, 64).astype(np.float32)
    g = rng.randn(64).astype(np.float32)
    b = rng.randn(64).astype(np.float32)
    want = jax_group_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g),
                          jnp.asarray(b), num_groups=8, silu=True)
    got = norms.group_norm(_t(x, torch.bfloat16), _t(g), _t(b), num_groups=8,
                           silu=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2)


def test_wrappers_reject_group_mismatch_before_launch():
    with pytest.raises(ValueError):
        norms.group_norm_plain(torch.zeros(1, 4, 30), torch.ones(30),
                               torch.zeros(30), num_groups=32)
