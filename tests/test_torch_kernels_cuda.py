"""The port's kernels on the card against their plain versions.

Marked ``cuda``: they need an NVIDIA GPU, ``nvcc`` and Triton, and skip
without a card. On the GPU host (which has no JAX, so the suite's
conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from powerpaint_tpu_torch.ops import flash_attention as fa
from powerpaint_tpu_torch.ops import norms

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(dev, *shape, dtype=torch.float32, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("b,sq,skv,n,d", [
    (2, 300, 300, 2, 40), (1, 128, 77, 1, 64), (1, 64, 64, 2, 160),
    (1, 200, 200, 1, 512), (2, 1, 77, 2, 16), (1, 65, 1, 1, 80),
    (2, 70, 33, 3, 20)])  # D = 20: not a multiple of 8, element-wise loads
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
def test_flash_attention_kernel(dev, b, sq, skv, n, d, dtype, atol):
    q = _randn(dev, b, sq, n, d, dtype=dtype, seed=1)
    k = _randn(dev, b, skv, n, d, dtype=dtype, seed=2)
    v = _randn(dev, b, skv, n, d, dtype=dtype, seed=3)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
def test_flash_attention_reads_strided_heads(dev, dtype, atol, offset):
    # packed (B, S, 3, N, D); an offset of one element takes the bf16
    # kernel off its 16-byte loads
    flat = _randn(dev, 2 * 100 * 3 * 4 * 40 + offset, dtype=dtype)
    qkv = flat[offset:].view(2, 100, 3, 4, 40)
    q, k, v = qkv.unbind(2)
    torch.testing.assert_close(fa.flash_attention(q, k, v).float(),
                               fa.flash_attention_plain(q, k, v).float(),
                               atol=atol, rtol=0)


def test_flash_attention_rejects_what_it_cannot_take(dev):
    q = _randn(dev, 1, 8, 1, 16)
    with pytest.raises(ValueError):
        fa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        fa.flash_attention(q, q.transpose(1, 3).contiguous().transpose(1, 3), q)


@pytest.mark.parametrize("shape,groups,silu", [
    ((2, 64, 64, 320), 32, True), ((1, 8, 8, 32), 32, False),
    ((1, 128, 128, 128), 32, True), ((2, 1, 1, 64), 32, True)])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 5e-2)])
def test_group_norm_kernel(dev, shape, groups, silu, dtype, atol):
    x = (_randn(dev, *shape, seed=4) * 2 - 0.3).to(dtype)
    w = 1 + 0.1 * _randn(dev, shape[-1], seed=5)
    b = 0.1 * _randn(dev, shape[-1], seed=6)
    before = norms.group_norm.launches
    got = norms.group_norm(x, w, b, num_groups=groups, eps=1e-6, silu=silu)
    torch.cuda.synchronize()
    assert norms.group_norm.launches == before + 1
    want = norms.group_norm_plain(x, w, b, num_groups=groups, eps=1e-6,
                                  silu=silu)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("shape", [(2, 4096, 320), (4, 77, 768), (3, 5, 1280)])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 5e-2)])
def test_layer_norm_kernel(dev, shape, dtype, atol):
    x = (_randn(dev, *shape, seed=7) * 3 + 0.5).to(dtype)
    w = 1 + 0.1 * _randn(dev, shape[-1], seed=8)
    b = 0.1 * _randn(dev, shape[-1], seed=9)
    before = norms.layer_norm.launches
    got = norms.layer_norm(x, w, b)
    torch.cuda.synchronize()
    assert norms.layer_norm.launches == before + 1
    torch.testing.assert_close(got.float(), norms.layer_norm_plain(x, w, b).float(),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("bad", ["transposed", "fp16"])
def test_norms_reject_what_they_cannot_take(dev, bad):
    x = _randn(dev, 2, 16, 64)
    x = x.transpose(0, 1) if bad == "transposed" else x.half()
    w, b = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    with pytest.raises(ValueError):
        norms.layer_norm(x, w, b)
    with pytest.raises(ValueError):
        norms.group_norm(x, w, b, num_groups=32)
