"""Gradients of the five hand-kernel wrappers (``ops._grad``): each
``torch.autograd.Function`` against autograd of its plain version (bitwise
on the CPU, where the forward is the plain version too), and against
``jax.grad`` of the JAX package's XLA form of the same op (fp32, within
1e-5: the two frameworks sum in other orders). The card's check of the
same Functions, with the hand kernels' forwards, is ``chip_smoke.py``
phase 2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerpaint_tpu.models.layers import Conv2D as JaxConv2D
from powerpaint_tpu.ops.attention import xla_attention
from powerpaint_tpu.ops.groupnorm import group_norm as jax_group_norm
from powerpaint_tpu.ops.groupnorm import layer_norm as jax_layer_norm
from powerpaint_tpu_torch.models.layers import (
    Conv2D,
    GroupNorm,
    cast_for_compute,
    compute_names,
)
from powerpaint_tpu_torch.ops import conv, norms
from powerpaint_tpu_torch.ops import flash_attention as fa

ATOL = RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _grad_mode_on():
    """Autograd on for each test: other test modules of the suite turn it
    off for the whole process when they are imported."""
    with torch.enable_grad():
        yield


def _inputs(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * (0.3 if len(s) == 4 and i == 1 else 1.0)
             ).astype(np.float32) for i, s in enumerate(shapes)]


# name -> (port wrapper, port plain version, JAX XLA form, input shapes,
# Function name); the JAX form takes the same arrays in the JAX layouts
CASES = {
    "flash_attention": (
        lambda q, k, v: fa.flash_attention(q, k, v),
        lambda q, k, v: fa.flash_attention_plain(q, k, v),
        lambda q, k, v: xla_attention(q, k, v),
        [(2, 24, 2, 8), (2, 10, 2, 8), (2, 10, 2, 8)], "FlashAttentionBackward"),
    "conv3x3": (
        lambda x, w, b: conv.conv3x3(x, w, b),
        lambda x, w, b: conv.conv3x3_plain(x, w, b),
        lambda x, w, b: JaxConv2D(6, (3, 3), dtype=jnp.float32).apply(
            {"params": {"kernel": jnp.transpose(w, (2, 3, 1, 0)), "bias": b}}, x),
        [(2, 6, 5, 8), (6, 8, 3, 3), (6,)], "Conv3x3Backward"),
    "conv3x3_gn_silu": (
        lambda x, w, b, g, be: conv.conv3x3_gn_silu(x, w, b, g, be,
                                                    num_groups=4, eps=1e-5),
        lambda x, w, b, g, be: conv.conv3x3_gn_silu_plain(
            x, w, b, g, be, num_groups=4, eps=1e-5),
        lambda x, w, b, g, be: JaxConv2D(6, (3, 3), dtype=jnp.float32).apply(
            {"params": {"kernel": jnp.transpose(w, (2, 3, 1, 0)), "bias": b}},
            x, gn=(g, be, 4, 1e-5)),
        [(2, 6, 5, 8), (6, 8, 3, 3), (6,), (8,), (8,)], "Conv3x3GnSiluBackward"),
    "group_norm": (
        lambda x, g, b: norms.group_norm(x, g, b, num_groups=4, eps=1e-6,
                                         silu=True),
        lambda x, g, b: norms.group_norm_plain(x, g, b, num_groups=4,
                                               eps=1e-6, silu=True),
        lambda x, g, b: jax_group_norm(x, g, b, num_groups=4, eps=1e-6,
                                       silu=True),
        [(2, 5, 3, 16), (16,), (16,)], "GroupNormBackward"),
    "layer_norm": (
        lambda x, g, b: norms.layer_norm(x, g, b, eps=1e-5),
        lambda x, g, b: norms.layer_norm_plain(x, g, b, eps=1e-5),
        lambda x, g, b: jax_layer_norm(x, g, b, eps=1e-5),
        [(3, 7, 24), (24,), (24,)], "LayerNormBackward"),
}


def _torch_grads(fn, arrays, cot):
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]
    out = fn(*ts)
    return out, torch.autograd.grad(out, ts, torch.from_numpy(cot))


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_gradient_is_autograd_of_the_plain_version(name):
    wrapper, plain, _, shapes, fn_name = CASES[name]
    arrays = _inputs(1, *shapes)
    cot = _cot(plain, arrays)
    want_out, want = _torch_grads(plain, arrays, cot)
    got_out, got = _torch_grads(wrapper, arrays, cot)
    assert type(got_out.grad_fn).__name__ == fn_name
    assert torch.equal(got_out, want_out)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _cot(plain, arrays):
    shape = plain(*[torch.from_numpy(a) for a in arrays]).shape
    return np.random.RandomState(9).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_gradient_matches_jax_grad(name):
    wrapper, plain, jax_fn, shapes, _ = CASES[name]
    arrays = _inputs(2, *shapes)
    cot = _cot(plain, arrays)
    _, got = _torch_grads(wrapper, arrays, cot)
    want = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * cot),
                    argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL, err_msg=f"{name} input {i}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_no_function_where_nothing_needs_a_gradient(name):
    """Inference calls the kernel directly: without grad mode, or with no
    input that requires a gradient, the output has no ``grad_fn``."""
    wrapper, _, _, shapes, _ = CASES[name]
    ts = [torch.from_numpy(a) for a in _inputs(3, *shapes)]
    assert wrapper(*ts).grad_fn is None
    with torch.no_grad():
        assert wrapper(*[t.requires_grad_(True) for t in ts]).grad_fn is None


def test_only_the_inputs_that_need_it_get_a_gradient():
    x, w, b, g, be = [torch.from_numpy(a) for a in _inputs(
        4, (1, 4, 4, 8), (6, 8, 3, 3), (6,), (8,), (8,))]
    w.requires_grad_(True)
    out = conv.conv3x3_gn_silu(x, w, b, g, be, num_groups=4, eps=1e-5)
    out.sum().backward()
    assert w.grad is not None and x.grad is None and g.grad is None


def test_training_cast_reaches_the_fp32_masters():
    """``cast_for_compute``: linear and conv weights run in the compute
    dtype, norms stay fp32, and the gradient lands on the fp32 master; a
    conv weight not in channels-last memory is packed differentiably."""
    torch.manual_seed(0)
    conv_mod = Conv2D(8, 6, 3, padding=1)
    names = compute_names(conv_mod)
    assert names == {"weight", "bias"}
    masters = {k: v.detach().clone().requires_grad_(True)
               for k, v in conv_mod.state_dict().items()}
    cast = cast_for_compute(masters, names, torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in cast.values())
    x = torch.randn(1, 4, 4, 8, dtype=torch.bfloat16)
    norm = GroupNorm(4, 8, 1e-5)
    out = torch.func.functional_call(conv_mod, cast, (x,), {"gn": norm})
    out.float().sum().backward()
    assert masters["weight"].grad.dtype == torch.float32
    assert float(masters["weight"].grad.abs().sum()) > 0
    w = masters["weight"].detach().requires_grad_(True)
    assert not w.is_contiguous(memory_format=torch.channels_last)
    out = torch.func.functional_call(conv_mod, {"weight": w,
                                                "bias": masters["bias"]},
                                     (x.float(),), {"gn": norm})
    out.sum().backward()
    assert w.grad is not None and float(w.grad.abs().sum()) > 0
