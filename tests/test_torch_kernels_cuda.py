"""The port's kernels on the card against their plain versions.

Marked ``cuda``: they need an NVIDIA GPU, ``nvcc`` and Triton, and skip
without a card. On the GPU host (which has no JAX, so the suite's
conftest is left out), from the repository's root:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from powerpaint_tpu_torch.ops import conv
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


# (B, H, W, Cin, Cout, groups): UNet levels, a wide up-block concat, the
# ragged tiny widths (groups of 1-2 channels, Cin and Cout off the tiles),
# one pixel, and more pixels than one tile row.
CONV_SHAPES = [(2, 16, 16, 320, 320, 32), (2, 8, 8, 960, 640, 32),
               (1, 8, 8, 48, 40, 24), (2, 8, 8, 32, 64, 32),
               (1, 1, 1, 64, 64, 32), (1, 5, 7, 20, 12, 10),
               (1, 40, 40, 128, 128, 32)]


@pytest.mark.parametrize("shape", CONV_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [True, False], ids=["gn_silu", "plain"])
def test_conv3x3_kernel(dev, shape, dtype, fused):
    b, h, w, cin, cout, groups = shape
    torch.backends.cudnn.allow_tf32 = False
    x = (_randn(dev, b, h, w, cin, seed=10) * 2 - 0.3).to(dtype)
    wt = (_randn(dev, cout, cin, 3, 3, seed=11) / (3 * cin ** 0.5)).to(dtype)
    wt = wt.contiguous(memory_format=torch.channels_last)
    bias = (0.1 * _randn(dev, cout, seed=12)).to(dtype)
    gamma = 1 + 0.1 * _randn(dev, cin, seed=13)
    beta = 0.5 + 0.1 * _randn(dev, cin, seed=14)  # large: catches nonzero padding
    counter = conv.conv3x3_gn_silu if fused else conv.conv3x3
    before = counter.launches
    if fused:
        kw = dict(num_groups=groups, eps=1e-5)
        got = conv.conv3x3_gn_silu(x, wt, bias, gamma, beta, **kw)
        want = conv.conv3x3_gn_silu_plain(x, wt, bias, gamma, beta, **kw)
    else:
        got = conv.conv3x3(x, wt, bias)
        want = conv.conv3x3_plain(x, wt, bias)
    torch.cuda.synchronize()
    assert got.shape == (b, h, w, cout) and got.dtype == dtype
    assert counter.launches == before + 1
    again = (conv.conv3x3_gn_silu(x, wt, bias, gamma, beta, **kw) if fused
             else conv.conv3x3(x, wt, bias))
    assert torch.equal(again, got)  # deterministic, split K included
    # batch-invariant: the first image alone gets the same bits
    first = x[:1].contiguous()
    alone = (conv.conv3x3_gn_silu(first, wt, bias, gamma, beta, **kw) if fused
             else conv.conv3x3(first, wt, bias))
    assert torch.equal(alone, got[:1])
    # fp32: one fp32 sum in another order; bf16: both round the fp32 sum
    # once, one bf16 step (2^-7 of the largest output) where they straddle
    atol = 1e-4 if dtype == torch.float32 else \
        2.0 ** -7 * float(want.float().abs().max()) + 1e-2
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    torch.backends.cudnn.allow_tf32 = True


@pytest.mark.parametrize("shape", CONV_SHAPES + [(2, 16, 16, 2560, 1280, 32)],
                         ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [True, False], ids=["gn_silu", "plain"])
def test_conv3x3_int8_kernel(dev, shape, dtype, fused):
    """The static-scale int8 kernel against its plain version: within
    chip_smoke.int8_check's flip bound (bitwise where no activation sits at
    a rounding boundary), deterministic, batch-invariant."""
    import chip_smoke

    b, h, w, cin, cout, groups = shape
    x = (_randn(dev, b, h, w, cin, seed=16) * 2 - 0.3).to(dtype)
    w_q, w_s = conv.quantize_weights_int8(
        _randn(dev, cout, cin, 3, 3, seed=17) / (3 * cin ** 0.5))
    bias = 0.1 * _randn(dev, cout, seed=18)
    gn = (1 + 0.1 * _randn(dev, cin, seed=19), 0.5 + 0.1 * _randn(dev, cin, seed=20))
    kw = dict(x_scale=8.0 / 127.0)
    if fused:
        kw.update(num_groups=groups, eps=1e-5)
        run = lambda x: conv.conv3x3_gn_silu_int8(x, w_q, w_s, bias, *gn, **kw)
        want = conv.conv3x3_gn_silu_int8_plain(x, w_q, w_s, bias, *gn, **kw)
    else:
        run = lambda x: conv.conv3x3_int8(x, w_q, w_s, bias, **kw)
        want = conv.conv3x3_int8_plain(x, w_q, w_s, bias, **kw)
    counter = conv.conv3x3_gn_silu_int8 if fused else conv.conv3x3_int8
    before = counter.launches
    got = run(x)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert got.shape == (b, h, w, cout) and got.dtype == dtype
    err, ok, _ = chip_smoke.int8_check(got, want, x, w_q, w_s, bias, fused, gn,
                                       groups)
    assert ok, f"max |err| {err} beyond the flip bound"
    assert torch.equal(run(x), got)
    assert torch.equal(run(x[:1].contiguous()), got[:1])


def test_conv3x3_int8_rejects_what_it_cannot_take(dev):
    x = _randn(dev, 1, 8, 8, 32)
    w_q, w_s = conv.quantize_weights_int8(_randn(dev, 16, 32, 3, 3))
    with pytest.raises(ValueError):  # OIHW, not (Cout, 3, 3, Cin)
        conv.conv3x3_int8(x, w_q.permute(0, 3, 1, 2), w_s, x_scale=0.1)
    with pytest.raises(ValueError):
        conv.conv3x3_int8(x, w_q.float(), w_s, x_scale=0.1)
    with pytest.raises(ValueError):
        conv.conv3x3_int8(x.half(), w_q, w_s, x_scale=0.1)
    with pytest.raises(ValueError):
        conv.conv3x3_int8(x, w_q, w_s.double(), x_scale=0.1)


@pytest.mark.parametrize("shape", [(2, 64, 64, 320), (1, 3, 5, 48), (3, 7, 1, 64)])
def test_group_norm_stats_kernel(dev, shape):
    x = _randn(dev, *shape, seed=15) * 2 - 0.3
    groups = 32 if shape[-1] % 32 == 0 else 24
    before = norms.group_norm.launches
    mean, rstd = norms.group_norm_stats(x, groups, 1e-5)
    want_mean, want_rstd = norms.group_norm_stats(x.cpu(), groups, 1e-5)
    assert norms.group_norm.launches == before
    torch.testing.assert_close(mean.cpu(), want_mean, atol=1e-5, rtol=0)
    torch.testing.assert_close(rstd.cpu(), want_rstd, atol=0, rtol=1e-4)


def test_conv3x3_rejects_what_it_cannot_take(dev):
    x = _randn(dev, 1, 8, 8, 16)
    wt = _randn(dev, 16, 16, 3, 3)  # OIHW, not channels-last
    with pytest.raises(ValueError):
        conv.conv3x3(x, wt)
    wt = wt.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError):
        conv.conv3x3(x.half(), wt.half())
    with pytest.raises(ValueError):
        conv.conv3x3(x.permute(0, 2, 1, 3), wt)
