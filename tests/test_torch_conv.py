"""The port's 3x3 convolutions (``powerpaint_tpu_torch.ops.conv``) against
the JAX package's implicit-GEMM Pallas kernels.

On the CPU each wrapper runs its kernel's plain version (GroupNorm + SiLU,
then ``F.conv2d``); these tests hold that plain version, which is also the
CUDA kernel's oracle on the card, to ``conv3x3`` / ``conv3x3_gn_silu`` of
``powerpaint_tpu/ops/conv_pallas.py`` in interpret mode, on the same numpy
inputs and at ``tests/test_conv_pallas.py``'s shapes and tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerpaint_tpu.ops.conv_pallas import conv3x3 as jax_conv3x3
from powerpaint_tpu.ops.conv_pallas import conv3x3_gn_silu as jax_conv3x3_gn_silu
from powerpaint_tpu.ops.conv_pallas import gn_stats as jax_gn_stats
from powerpaint_tpu_torch.models.layers import Conv2D, GroupNorm
from powerpaint_tpu_torch.ops import conv, norms


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (B, H, W, Cin, Cout), as tests/test_conv_pallas.py
SHAPES = [(1, 8, 8, 128, 128), (2, 8, 8, 64, 128), (1, 16, 8, 128, 256)]


def _inputs(shape, seed):
    b, h, w, cin, cout = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    wt = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.randn(cin)).astype(np.float32)
    beta = (0.1 * rng.randn(cin)).astype(np.float32)
    return x, wt, bias, gamma, beta


def _oihw(wt):
    return torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("use_bias", [False, True])
def test_conv3x3_plain_matches_pallas(shape, use_bias):
    x, wt, bias, _, _ = _inputs(shape, 0)
    bias = bias if use_bias else None
    want = jax_conv3x3(jnp.asarray(x), jnp.asarray(wt),
                       bias=None if bias is None else jnp.asarray(bias),
                       interpret=True)
    got = conv.conv3x3(torch.from_numpy(x), _oihw(wt),
                       None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("use_bias", [False, True])
def test_conv3x3_gn_silu_plain_matches_pallas(shape, use_bias):
    x, wt, bias, gamma, beta = _inputs(shape, 1)
    bias = bias if use_bias else None
    want = jax_conv3x3_gn_silu(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(gamma), jnp.asarray(beta),
        16, bias=None if bias is None else jnp.asarray(bias), interpret=True)
    before = conv.conv3x3_gn_silu.launches
    got = conv.conv3x3_gn_silu(
        torch.from_numpy(x), _oihw(wt),
        None if bias is None else torch.from_numpy(bias),
        torch.from_numpy(gamma), torch.from_numpy(beta), num_groups=16,
        eps=1e-5)
    assert conv.conv3x3_gn_silu.launches == before  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)


@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 64), 16),
                                          ((1, 5, 3, 48), 24)])
def test_group_norm_stats_match_jax(shape, groups):
    x = np.random.RandomState(2).randn(*shape).astype(np.float32) * 2 - 0.3
    mean, rstd = norms.group_norm_stats(torch.from_numpy(x), groups, 1e-5)
    want_mean, want_rstd = jax_gn_stats(jnp.asarray(x), groups, 1e-5)
    reps = shape[-1] // groups  # the JAX function broadcasts to (B, C)
    np.testing.assert_allclose(mean.repeat_interleave(reps, 1).numpy(),
                               np.asarray(want_mean), atol=2e-6)
    np.testing.assert_allclose(rstd.repeat_interleave(reps, 1).numpy(),
                               np.asarray(want_rstd), rtol=2e-5)


def test_conv2d_gn_prologue_is_the_unfused_chain():
    """``Conv2D(x, gn=norm)`` computes exactly GroupNorm + SiLU then the
    conv, and refuses a conv the prologue does not fit."""
    rng = np.random.RandomState(3)
    torch.manual_seed(0)
    c = Conv2D(32, 16, 3, padding=1)
    gn = GroupNorm(8, 32, 1e-5)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(1 + 0.1 * rng.randn(32)))
        gn.bias.copy_(torch.from_numpy(0.1 * rng.randn(32)))
    x = torch.from_numpy(rng.randn(2, 8, 8, 32).astype(np.float32))
    want = c(gn(x, silu=True))
    torch.testing.assert_close(c(x, gn=gn), want, rtol=0, atol=0)
    assert c.kernel_weight().is_contiguous(memory_format=torch.channels_last)
    assert "_packed" not in dict(c.state_dict())
    with pytest.raises(ValueError):
        Conv2D(32, 16, 1)(x, gn=gn)
