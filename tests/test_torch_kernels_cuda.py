"""The port's kernels on the card against their plain versions.

Marked ``cuda``: they need an NVIDIA GPU and ``nvcc``, and skip without a
card. On the GPU host (which has no JAX, so the suite's
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


# The IP-Adapter's image attention (chip_smoke.IP_ATTN_SHAPES): the UNet's
# queries at its four levels over 4 image tokens, the CFG batch of 2.
IP_ATTN_SHAPES = [(2, 4096, 4, 8, 40), (2, 1024, 4, 8, 80),
                  (2, 256, 4, 8, 160), (2, 64, 4, 8, 160)]


@pytest.mark.parametrize("shape", IP_ATTN_SHAPES, ids=str)
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
def test_flash_attention_over_four_image_tokens(dev, shape, dtype, atol):
    """S_kv = 4, far below a kv stage: the columns past it are masked. In
    bf16 a two-request batch (4 images) gives the first request's bits."""
    b, sq, skv, n, d = shape
    q = _randn(dev, 2 * b, sq, n, d, dtype=dtype, seed=1)
    k = _randn(dev, 2 * b, skv, n, d, dtype=dtype, seed=2)
    v = _randn(dev, 2 * b, skv, n, d, dtype=dtype, seed=3)
    got = fa.flash_attention(q[:b].contiguous(), k[:b].contiguous(),
                             v[:b].contiguous())
    want = fa.flash_attention_plain(q[:b], k[:b], v[:b])
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    if dtype == torch.bfloat16:
        assert torch.equal(fa.flash_attention(q, k, v)[:b], got)


# The main paths' rows (chip_smoke.LN_SHAPES: the UNet's four levels, CLIP),
# the IP-Adapter's (the ViT-H/14 tower's 257 tokens of 1280, one and two
# images; the projection's 4 tokens of 768 under CFG), then C off the
# 16-byte vectors (element loads), one and 2048 channels (the least and the
# most the kernel takes), and a few rows of a wide C.
LN_SHAPES = [(2, 4096, 320), (2, 1024, 640), (2, 256, 1280), (2, 64, 1280),
             (4, 77, 768), (1, 257, 1280), (2, 257, 1280), (4, 4, 768),
             (3, 5, 1280), (3, 7, 300), (2, 9, 77), (5, 1), (3, 2048)]
LN_CS = (320, 640, 1280, 768)  # the main paths' C


def _ln_inputs(dev, shape, dtype, seed=7):
    x = (_randn(dev, *shape, seed=seed) * 3 + 0.5).to(dtype)
    w = 1 + 0.1 * _randn(dev, shape[-1], seed=8)
    b = 0.1 * _randn(dev, shape[-1], seed=9)
    return x, w, b


@pytest.mark.parametrize("shape", LN_SHAPES, ids=str)
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 5e-2)])
def test_layer_norm_kernel(dev, shape, dtype, atol):
    x, w, b = _ln_inputs(dev, shape, dtype)
    before = norms.layer_norm.launches
    got = norms.layer_norm(x, w, b)
    torch.cuda.synchronize()
    assert norms.layer_norm.launches == before + 1
    assert got.shape == x.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), norms.layer_norm_plain(x, w, b).float(),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("shape", [(2, 1024, 640), (3, 7, 300)], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_reads_misaligned_rows(dev, shape, dtype):
    """x one element off 16-byte alignment takes element loads on the same
    lane-to-element map: the same bits as the aligned x."""
    x, w, b = _ln_inputs(dev, shape, dtype)
    flat = torch.cat([x.new_zeros(1), x.flatten()])
    off = flat[1:].view(shape)
    assert off.data_ptr() % 16 != 0 and off.is_contiguous()
    got = norms.layer_norm(off, w, b)
    assert torch.equal(got, norms.layer_norm(x, w, b))
    atol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got.float(), norms.layer_norm_plain(x, w, b).float(),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("shape,small", [((4, 4096, 320), 2), ((4, 1024, 640), 2),
                                         ((4, 256, 1280), 2), ((4, 64, 1280), 2),
                                         ((8, 77, 768), 4)], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_is_batch_invariant_and_deterministic(dev, shape, small, dtype):
    """The UNet's CFG batch of two requests against one, CLIP's 8 rows
    against 4: bitwise, and the same bits on a second run."""
    x, w, b = _ln_inputs(dev, shape, dtype)
    many = norms.layer_norm(x, w, b)
    assert torch.equal(norms.layer_norm(x[:small].contiguous(), w, b), many[:small])
    assert torch.equal(norms.layer_norm(x, w, b), many)


def test_layer_norm_plan_matches_its_source(dev):
    import ctypes

    from powerpaint_tpu_torch.ops import _build

    fn = _build.load("layer_norm").ppt_layer_norm_plan
    fn.restype = None
    out = (ctypes.c_longlong * 4)()
    keys = ("group", "vecs", "threads", "rows")
    for c in LN_CS + (1, 77, 300, 1536, 1537, 2048):
        for esize in (2, 4):
            fn(c, esize, out)
            p = norms.ln_plan(c, esize)
            assert list(out) == [p[k] for k in keys], (c, esize)


@pytest.mark.parametrize("bad", ["transposed", "fp16", "bf16_affine", "too_wide"])
def test_norms_reject_what_they_cannot_take(dev, bad):
    c = norms.LN_MAX_C + 1 if bad == "too_wide" else 64
    x = _randn(dev, 2, 16, c)
    w, b = torch.ones(c, device=dev), torch.zeros(c, device=dev)
    if bad == "transposed":
        x = x.transpose(0, 1)
    elif bad == "fp16":
        x = x.half()
    elif bad == "bf16_affine":
        w, b = w.bfloat16(), b.bfloat16()
    with pytest.raises(ValueError):
        norms.layer_norm(x, w, b)
    if bad != "too_wide":  # GroupNorm takes any C that splits into groups
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
    """The static-scale int8 unit (quantiser, then the wgmma int8 kernel)
    against its plain version: bitwise (the plain version takes its
    statistics from the same kernel's statistics mode and rounds the same
    IEEE operations), deterministic, batch-invariant, one count a unit."""
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
    quantiser = norms.gn_silu_quantize_int8 if fused else norms.quantize_int8
    before, q_before = counter.launches, quantiser.launches
    got = run(x)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert quantiser.launches == q_before + 1
    assert got.shape == (b, h, w, cout) and got.dtype == dtype
    err, ok, _ = chip_smoke.int8_check(got, want, x, w_q, w_s, bias, fused, gn,
                                       groups)
    assert ok, f"max |err| {err} beyond the flip bound"
    assert torch.equal(got, want), f"{int((got != want).sum())} outputs differ"
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


# ---------------------------------------------------------------------------
# the wgmma designs of the bf16 flash attention and conv kernels
# ---------------------------------------------------------------------------


def test_flash_attention_config_matches_its_source(dev):
    import ctypes

    from powerpaint_tpu_torch.ops import _build

    fn = _build.load("flash_attention").ppt_flash_attention_bf16_config
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 6)()
    for d in range(1, 1025):
        assert fn(d, out) == 0
        c = fa.bf16_config(d)
        assert list(out) == [c[k] for k in ("do", "bk", "nwg", "stages", "slices",
                                            "smem")], d
    assert fn(1025, out) != 0


@pytest.mark.parametrize("d", [40, 64, 80, 160, 512, 768, 1024])
@pytest.mark.parametrize("sq,skv", [(300, 77), (77, 300), (129, 129)])
@pytest.mark.parametrize("layout", ["contiguous", "strided heads"])
def test_flash_attention_bf16_head_dims(dev, d, sq, skv, layout):
    """Every head dim the main paths launch (and 64; 768 and 1024 are the
    asymmetric VAE decoders' one head), ragged Sq and Skv off every tile,
    heads read through their strides; a two-image batch is bitwise each
    image alone, and two runs are bitwise equal."""
    n = 1 if d >= 512 else 3

    def make(s, seed):
        if layout == "contiguous":
            return _randn(dev, 2, s, n, d, dtype=torch.bfloat16, seed=seed)
        packed = _randn(dev, 2, s, n, 2, d, dtype=torch.bfloat16, seed=seed)
        return packed[:, :, :, 1]  # head stride 2 d, row stride 2 n d

    q, k, v = make(sq, 21), make(skv, 22), make(skv, 23)
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention_plain(q, k, v)
    atol = 2.0 ** -7 * float(want.float().abs().max()) + 1e-2
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert torch.equal(fa.flash_attention(q, k, v), got)
    for i in range(2):
        alone = fa.flash_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1])
        assert torch.equal(alone, got[i:i + 1])


def test_conv3x3_plan_matches_its_source(dev):
    import ctypes

    from powerpaint_tpu_torch.ops import _build

    fn = _build.load("conv3x3").ppt_conv3x3_bf16_plan
    fn.restype = None
    out = (ctypes.c_longlong * 7)()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for shape in [(2, 64, 64, 320, 320), (2, 16, 16, 2560, 1280), (2, 8, 8, 1280, 1280),
                  (1, 512, 512, 128, 128), (3, 9, 13, 64, 200), (1, 1, 1, 64, 64),
                  (2, 32, 32, 640, 640), (1, 5, 7, 20, 12)]:
        fn(*shape, sms, out)
        p = conv.bf16_plan(*shape, sms=sms)
        assert list(out) == [p[k] for k in ("bn", "tiles", "blocks", "n_tiles", "splits",
                                            "per", "smem")], shape


# (B, H, W, Cin, Cout, groups): Cout off every N tile (200 on a 256 tile, 40
# on 64), W below 8 and off the 8-pixel tile, H = 1, a block whose two
# tiles are two images (8 x 8 x batch 2), split K (deep levels), the VAE's
# wide maps cut small; the asymmetric decoder's widths, 6, 12 and 24
# channels a group (a group off the 8-channel chunks).
WGMMA_CONV_SHAPES = [(2, 9, 13, 64, 200, 32), (2, 8, 5, 96, 40, 32),
                     (2, 1, 19, 128, 64, 32), (2, 8, 8, 320, 320, 32),
                     (2, 8, 8, 1280, 1280, 32), (2, 16, 16, 640, 640, 32),
                     (1, 24, 40, 128, 256, 32), (3, 6, 6, 64, 160, 16),
                     (1, 24, 16, 192, 192, 32), (1, 16, 16, 384, 192, 32),
                     (1, 16, 16, 768, 384, 32)]


@pytest.mark.parametrize("shape", WGMMA_CONV_SHAPES, ids=str)
@pytest.mark.parametrize("fused", [True, False], ids=["gn_silu", "plain"])
def test_conv3x3_bf16_tiles(dev, shape, fused):
    """The bf16 kernel against its plain version where its tiles are
    ragged; beta = 0.5 makes a nonzero SAME pad show; every image of the
    batch alone gets the same bits, and two runs are bitwise equal."""
    b, h, w, cin, cout, groups = shape
    x = (_randn(dev, b, h, w, cin, seed=30) * 2 - 0.3).bfloat16()
    wt = (_randn(dev, cout, cin, 3, 3, seed=31) / (3 * cin ** 0.5)).bfloat16()
    wt = wt.contiguous(memory_format=torch.channels_last)
    bias = (0.1 * _randn(dev, cout, seed=32)).bfloat16()
    gamma = 1 + 0.1 * _randn(dev, cin, seed=33)
    beta = 0.5 + 0.1 * _randn(dev, cin, seed=34)
    kw = dict(num_groups=groups, eps=1e-5)
    if fused:
        run = lambda x: conv.conv3x3_gn_silu(x, wt, bias, gamma, beta, **kw)
        want = conv.conv3x3_gn_silu_plain(x, wt, bias, gamma, beta, **kw)
    else:
        run = lambda x: conv.conv3x3(x, wt, bias)
        want = conv.conv3x3_plain(x, wt, bias)
    torch.backends.cudnn.allow_tf32 = False
    got = run(x)
    torch.cuda.synchronize()
    atol = 2.0 ** -7 * float(want.float().abs().max()) + 1e-2
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    torch.backends.cudnn.allow_tf32 = True
    assert torch.equal(run(x), got)
    for i in range(b):
        assert torch.equal(run(x[i:i + 1].contiguous()), got[i:i + 1])


# ---------------------------------------------------------------------------
# the int8 conv on wgmma s8 + TMA, and GroupNorm in CUDA with its modes
# ---------------------------------------------------------------------------


def test_conv3x3_int8_plan_matches_its_source(dev):
    import ctypes

    from powerpaint_tpu_torch.ops import _build

    fn = _build.load("conv3x3_int8").ppt_conv3x3_int8_plan
    fn.restype = None
    out = (ctypes.c_longlong * 7)()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for shape in [(2, 64, 64, 320, 320), (2, 64, 64, 960, 320), (2, 16, 16, 2560, 1280),
                  (2, 8, 8, 1280, 1280), (1, 256, 256, 128, 256), (1, 5, 7, 32, 12),
                  (3, 9, 13, 64, 200), (1, 1, 1, 64, 64), (2, 32, 32, 1920, 640)]:
        fn(*shape, sms, out)
        p = conv.int8_plan(*shape, sms=sms)
        assert list(out) == [p[k] for k in ("bn", "tiles", "blocks", "n_tiles", "splits",
                                            "per", "smem")], shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [True, False], ids=["gn_silu", "plain"])
def test_conv3x3_int8_main_path_shapes(dev, dtype, fused):
    """Every shape chip_smoke times (Cin off the 128-channel chunk, the
    deep levels' split K, the VAE's map, a ragged one): bitwise the plain
    version, and the first image alone bitwise its slice of the batch."""
    import chip_smoke

    for i, (b, h, w, cin, cout, groups) in enumerate(chip_smoke.INT8_SHAPES):
        x = (_randn(dev, b, h, w, cin, seed=40 + i) * 2 - 0.3).to(dtype)
        w_q, w_s = conv.quantize_weights_int8(
            _randn(dev, cout, cin, 3, 3, seed=50 + i) / (3 * cin ** 0.5))
        bias = 0.1 * _randn(dev, cout, seed=60 + i)
        gn = (1 + 0.1 * _randn(dev, cin, seed=70 + i), 0.5 + 0.1 * _randn(dev, cin, seed=80 + i))
        kw = dict(x_scale=chip_smoke.X_SCALE)
        if fused:
            kw.update(num_groups=groups, eps=1e-5)
            run = lambda x: conv.conv3x3_gn_silu_int8(x, w_q, w_s, bias, *gn, **kw)
            want = conv.conv3x3_gn_silu_int8_plain(x, w_q, w_s, bias, *gn, **kw)
        else:
            run = lambda x: conv.conv3x3_int8(x, w_q, w_s, bias, **kw)
            want = conv.conv3x3_int8_plain(x, w_q, w_s, bias, **kw)
        got = run(x)
        assert torch.equal(got, want), (cin, cout, int((got != want).sum()))
        assert torch.equal(run(x[:1].contiguous()), got[:1]), (cin, cout)


# (B, S, C, groups): the UNet's and BrushNet's maps at 512^2 (resident), the
# VAE's largest (streamed), and ragged ones: groups of 2 channels with rows
# off the 16-byte vector (element copies), a row count below the cluster,
# one row; the asymmetric decoder's widths (6, 12, 24 and 32 channels a
# group; its largest maps stream).
GN_CASES = [(2, 4096, 320, 32), (2, 4096, 960, 32), (2, 1024, 640, 32), (2, 256, 1280, 32),
            (2, 64, 2560, 32), (1, 262144, 128, 32), (1, 65536, 256, 32), (1, 4096, 512, 32),
            (1, 35, 20, 10), (3, 7, 48, 24), (2, 1, 64, 32),
            (1, 4096, 192, 32), (1, 4096, 768, 32), (1, 4096, 1024, 32),
            (1, 262144, 192, 32), (1, 262144, 384, 32), (1, 65536, 768, 32)]


@pytest.mark.parametrize("case", GN_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_modes(dev, case, dtype):
    """Every mode of csrc/group_norm.cu at its form for the shape: the
    statistics bitwise equal across the modes and close to the plain
    ones; the quantising mode bitwise its plain version (which takes the
    statistics mode's bits); the apply mode within one rounding; every
    image alone bitwise its slice of the batch."""
    b, s, c, groups = case
    x = (_randn(dev, b, s, c, seed=90) * 2 - 0.3).to(dtype)
    gamma = 1 + 0.1 * _randn(dev, c, seed=91)
    beta = 0.1 * _randn(dev, c, seed=92)
    eps, x_scale = 1e-5, 8.0 / 127.0
    outs, stats = {}, []
    for mode, kw in ((0, {}), (1, dict(silu=True)), (2, dict(x_scale=x_scale))):
        out, st = norms._launch_gn(x, None if mode == 0 else gamma,
                                   None if mode == 0 else beta, groups, eps, mode, **kw)
        outs[mode] = out
        stats.append(st)
    torch.cuda.synchronize()
    assert torch.equal(stats[0], stats[1]) and torch.equal(stats[0], stats[2])
    mean, rstd = norms.group_norm_stats(x, groups, eps)
    assert torch.equal(mean, stats[0][0]) and torch.equal(rstd, stats[0][1])
    want_mean, want_rstd = norms.group_norm_stats_plain(x, groups, eps)
    torch.testing.assert_close(mean, want_mean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, want_rstd, atol=0, rtol=1e-4)
    q = norms.gn_silu_quantize_int8(x, gamma, beta, num_groups=groups, eps=eps,
                                    x_scale=x_scale)
    want_q = norms.gn_silu_quantize_int8_plain(x, gamma, beta, num_groups=groups, eps=eps,
                                               x_scale=x_scale)
    assert q.dtype == torch.int8 and torch.equal(q, outs[2]) and torch.equal(q, want_q)
    y = norms.group_norm(x, gamma, beta, num_groups=groups, eps=eps, silu=True)
    want_y = norms.group_norm_plain(x, gamma, beta, num_groups=groups, eps=eps, silu=True)
    atol = 1e-4 if dtype == torch.float32 else 2.0 ** -7 * float(want_y.float().abs().max()) + 1e-2
    torch.testing.assert_close(y.float(), want_y.float(), atol=atol, rtol=0)
    assert torch.equal(y, outs[1])
    if b > 1:
        alone = norms.group_norm(x[:1].contiguous(), gamma, beta, num_groups=groups, eps=eps,
                                 silu=True)
        assert torch.equal(alone, y[:1])


@pytest.mark.parametrize("case", GN_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_sequence_parallel_modes(dev, case, dtype):
    """The moments mode (mean, M2) against the plain two-pass moments to
    1e-5; the apply and quantise modes from given statistics against their
    plain versions from the same statistics (the apply within one rounding,
    the quantiser bitwise)."""
    b, s, c, groups = case
    x = (_randn(dev, b, s, c, seed=94) * 2 - 0.3).to(dtype)
    gamma = 1 + 0.1 * _randn(dev, c, seed=95)
    beta = 0.1 * _randn(dev, c, seed=96)
    before = norms.group_norm_moments.launches
    mean, m2 = norms.group_norm_moments(x, groups)
    torch.cuda.synchronize()
    assert norms.group_norm_moments.launches == before + 1
    want_mean, want_m2 = norms.group_norm_moments_plain(x, groups)
    torch.testing.assert_close(mean, want_mean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(m2, want_m2, atol=1e-5, rtol=1e-5)
    stats = (want_mean * 0.9 + 0.05, 1.0 / torch.sqrt(want_m2 / (s * c // groups) + 1e-5))
    y = norms.group_norm(x, gamma, beta, num_groups=groups, eps=1e-5, silu=True,
                         stats=stats)
    want_y = norms.group_norm_plain(x, gamma, beta, num_groups=groups, eps=1e-5,
                                    silu=True, stats=stats)
    atol = 1e-4 if dtype == torch.float32 else 2.0 ** -7 * float(want_y.float().abs().max()) + 1e-2
    torch.testing.assert_close(y.float(), want_y.float(), atol=atol, rtol=0)
    kw = dict(num_groups=groups, eps=1e-5, x_scale=8.0 / 127.0, stats=stats)
    assert torch.equal(norms.gn_silu_quantize_int8(x, gamma, beta, **kw),
                       norms.gn_silu_quantize_int8_plain(x, gamma, beta, **kw))


@pytest.mark.parametrize("b,sq,skv,n,d", [
    (2, 300, 300, 2, 40), (1, 128, 77, 1, 64), (2, 256, 256, 8, 80),
    (1, 200, 200, 1, 512), (1, 65, 130, 1, 768), (2, 70, 33, 3, 20)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_lse_mode(dev, b, sq, skv, n, d, dtype):
    """The log-sum-exp mode: the fp32 output to ``chip_smoke.LSE_OUT_RTOL``
    of its largest value and of its 2-norm, and the log-sum-exp to
    ``chip_smoke.LSE_RTOL`` of the plain version's; the plain mode's
    output unchanged by the new mode's launch."""
    import chip_smoke
    from powerpaint_tpu_torch.parallel.dryrun import attention_errors

    rtol = chip_smoke.LSE_OUT_RTOL[dtype]
    q = _randn(dev, b, sq, n, d, dtype=dtype, seed=4)
    k = _randn(dev, b, skv, n, d, dtype=dtype, seed=5)
    v = _randn(dev, b, skv, n, d, dtype=dtype, seed=6)
    plain_mode = fa.flash_attention(q, k, v)
    before = fa.flash_attention_lse.launches
    out, lse = fa.flash_attention_lse(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention_lse.launches == before + 1
    assert out.dtype == lse.dtype == torch.float32 and lse.shape == (b, n, sq)
    want, want_lse = fa.flash_attention_lse_plain(q, k, v)
    err = attention_errors(out, want)
    assert max(err["max_rel_err"], err["norm_rel_err"]) <= rtol, err
    torch.testing.assert_close(lse, want_lse, atol=0,
                               rtol=chip_smoke.LSE_RTOL[dtype])
    assert torch.equal(fa.flash_attention(q, k, v), plain_mode)
    # the output rounded to the inputs' type is the plain mode's, within
    # one rounding step of the output
    err = attention_errors(out.to(dtype), plain_mode)
    assert max(err["max_rel_err"], err["norm_rel_err"]) <= rtol, err


@pytest.mark.parametrize("b,sq,skv,n,d", [
    (2, 300, 300, 2, 40), (1, 128, 77, 1, 64), (2, 256, 256, 4, 80),
    (1, 64, 200, 2, 160), (1, 200, 200, 1, 512), (1, 65, 130, 1, 1024),
    (2, 70, 33, 3, 20)])
def test_flash_attention_bf16_softmax_mode(dev, b, sq, skv, n, d):
    """The bf16-softmax mode against its plain version at the kernel's
    block of keys, to ``chip_smoke.BSM_RTOL`` of the largest output and of
    the 2-norm (``attention_errors``), ragged Sq and Skv off every tile;
    B1's output on the same inputs, the control, misses that bound; a
    two-image batch is bitwise each image alone, two runs are bitwise
    equal, and the plain mode's output is unchanged."""
    import chip_smoke
    from powerpaint_tpu_torch.parallel.dryrun import attention_errors

    q = _randn(dev, b, sq, n, d, dtype=torch.bfloat16, seed=7)
    k = _randn(dev, b, skv, n, d, dtype=torch.bfloat16, seed=8)
    v = _randn(dev, b, skv, n, d, dtype=torch.bfloat16, seed=9)
    plain_mode = fa.flash_attention(q, k, v)
    before = fa.flash_attention_bf16_softmax.launches
    got = fa.flash_attention_bf16_softmax(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention_bf16_softmax.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = fa.flash_attention_bf16_softmax_plain(q, k, v)
    err = attention_errors(got, want)
    assert chip_smoke.bsm_within(err), err
    control = attention_errors(plain_mode, want)
    assert not chip_smoke.bsm_within(control), control
    assert torch.equal(fa.flash_attention_bf16_softmax(q, k, v), got)
    for i in range(b):
        alone = fa.flash_attention_bf16_softmax(q[i:i + 1], k[i:i + 1], v[i:i + 1])
        assert torch.equal(alone, got[i:i + 1])
    assert torch.equal(fa.flash_attention(q, k, v), plain_mode)


def test_flash_attention_bf16_softmax_refuses_what_it_cannot_take(dev):
    q = _randn(dev, 1, 8, 1, 16)
    before = fa.flash_attention_bf16_softmax.launches
    with pytest.raises(ValueError, match="bf16"):
        fa.flash_attention_bf16_softmax(q, q, q)
    qb = q.to(torch.bfloat16)
    with torch.enable_grad(), pytest.raises(ValueError, match="not differentiable"):
        fa.flash_attention_bf16_softmax(qb.clone().requires_grad_(), qb, qb)
    wide = _randn(dev, 1, 8, 1, fa.BF16_MAX_D + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention_bf16_softmax(wide, wide, wide)
    assert fa.flash_attention_bf16_softmax.launches == before


@pytest.mark.parametrize("n", [1, 7, 4096 * 320, 262144 * 128 + 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_int8_kernel(dev, n, dtype):
    x = (_randn(dev, 1, n, seed=93) * 6).to(dtype)
    x[0, :1] = 0.5 * 8.0 / 127.0  # a value on a rounding boundary: half to even
    before = norms.quantize_int8.launches
    q = norms.quantize_int8(x, x_scale=8.0 / 127.0)
    torch.cuda.synchronize()
    assert norms.quantize_int8.launches == before + 1
    assert q.dtype == torch.int8 and q.shape == x.shape
    assert torch.equal(q, norms.quantize_int8_plain(x, x_scale=8.0 / 127.0))


def test_group_norm_plan_matches_its_source(dev):
    import ctypes

    from powerpaint_tpu_torch.ops import _build

    fn = _build.load("group_norm").ppt_group_norm_plan
    fn.restype = None
    out = (ctypes.c_longlong * 10)()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    keys = ("resident", "span", "spans", "k", "cluster", "rows", "chunks", "sub_rows",
            "smem", "smem2")
    for b, s, c, groups in GN_CASES + [(1, 16384, 512, 32), (2, 1024, 1920, 32),
                                       (1, 65536, 128, 32), (1, 262144, 256, 32)]:
        for esize in (2, 4):
            fn(s, c, groups, esize, sms, out)
            p = norms.gn_plan(s, c, groups, esize, sms=sms)
            assert list(out) == [p[k] for k in keys], (s, c, groups, esize)


def test_group_norm_refuses_what_it_cannot_take(dev):
    x = _randn(dev, 2, 4096, 320)
    gamma, beta = torch.ones(320, device=dev), torch.zeros(320, device=dev)
    with pytest.raises(RuntimeError):  # a cluster of 32 blocks: no card holds it
        norms._launch_gn(x, gamma, beta, 32, 1e-5, 1, cluster=32)
    with pytest.raises(ValueError):  # gamma not fp32
        norms.group_norm(x, gamma.bfloat16(), beta, num_groups=32)
    with pytest.raises(ValueError):  # 320 channels do not split into 24 groups
        norms.group_norm(x, gamma, beta, num_groups=24)
    with pytest.raises(ValueError):
        norms.gn_silu_quantize_int8(x.half(), gamma, beta, num_groups=32, eps=1e-5,
                                    x_scale=0.1)
    with pytest.raises(ValueError):
        norms.quantize_int8(x.transpose(0, 1), x_scale=0.1)
    # the forced cluster the plan would choose anyway launches
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out, _ = norms._launch_gn(x, gamma, beta, 32, 1e-5, 1,
                              cluster=norms.gn_plan(4096, 320, 32, 4, sms=sms)["cluster"])
    torch.testing.assert_close(out, norms.group_norm_plain(x, gamma, beta, eps=1e-5),
                               atol=1e-4, rtol=0)


def test_tiny_controlnet_on_the_card_matches_the_cpu(dev):
    """The tiny ppt-v1 + ControlNet pipeline, fp32, on the card and on the
    CPU with the same weights and noise: the images within the tiny
    references' bound (max 3, mean 0.5 uint8); and one branch forward on
    the card launches each kernel as often as the config implies."""
    import numpy as np

    from powerpaint_tpu_torch.io.weights import init_state
    from powerpaint_tpu_torch.pipelines.controlnet import (
        ControlNetPipeline,
        gating_table,
    )
    from powerpaint_tpu_torch.testing import tiny_v1_controlnet_config
    from powerpaint_tpu_torch.text.prompts import add_task
    from powerpaint_tpu_torch.text.tokenizer import (
        HashTokenizer,
        TokenizerWrapper,
        add_task_tokens,
    )

    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    cfg = tiny_v1_controlnet_config()
    state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    tok = TokenizerWrapper(HashTokenizer(994))
    add_task_tokens(tok)
    rng = np.random.RandomState(1)
    image = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
    mask_u8 = np.zeros((1, 64, 64, 1), np.uint8)
    mask_u8[:, 16:48, 12:40] = 255
    control = ((rng.rand(1, 1, 64, 64, 1) > 0.85) * np.ones(3)).astype(np.uint8) * 255
    g = torch.Generator().manual_seed(7)
    noise = [torch.randn((1, 8, 8, 4), generator=g) for _ in range(3)]
    outs = {}
    try:
        for d in ("cpu", dev):
            pipe = ControlNetPipeline(cfg, state, tok, dtype=torch.float32,
                                      device=d)
            ids = pipe.encode_task(add_task("a dog", "", "text-guided"))[None]
            outs[str(d)] = pipe._generate(
                torch.as_tensor(ids, dtype=torch.long, device=d),
                torch.tensor([0.6], device=d),
                torch.as_tensor(image[None], device=d),
                torch.as_tensor(mask_u8, device=d), torch.tensor([7.5], device=d),
                *[n.to(d) for n in noise], None, num_steps=3, strength_steps=3,
                output_type="uint8", control_u8=torch.as_tensor(control, device=d),
                scales=gating_table(3, [1.0], [0.0], [1.0])).cpu().numpy()
        diff = np.abs(outs["cpu"].astype(np.int32) - outs[str(dev)].astype(np.int32))
        assert diff.max() <= 3 and diff.mean() <= 0.5, (diff.max(), diff.mean())

        counted = {"flash_attention": fa.flash_attention,
                   "layer_norm": norms.layer_norm, "group_norm": norms.group_norm,
                   "group_norm_stats": norms.group_norm_stats,
                   "conv3x3_gn_silu": conv.conv3x3_gn_silu, "conv3x3": conv.conv3x3}
        before = {k: f.launches for k, f in counted.items()}
        with torch.no_grad():
            cond = torch.as_tensor(control[0], device=dev).repeat(2, 1, 1, 1)
            pipe.controlnet[0](torch.zeros(2, 8, 8, 4, device=dev),
                               torch.tensor(500, device=dev),
                               torch.zeros(2, 77, 32, device=dev), cond)
        got = {k: f.launches - before[k] for k, f in counted.items()}
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    u = cfg.controlnet.base
    n_tf = sum(k.startswith("CrossAttn") for k in u.down_block_types) * \
        u.layers_per_block + 1
    n_units = len(u.block_out_channels) * u.layers_per_block + 2
    assert got == {"flash_attention": 2 * n_tf, "layer_norm": 3 * n_tf,
                   "group_norm": n_tf, "group_norm_stats": 2 * n_units,
                   "conv3x3_gn_silu": 2 * n_units, "conv3x3": 0}


@pytest.mark.parametrize("version", ["ppt-v1", "ppt-v2"])
def test_tiny_submit_waits_on_nothing(dev, version):
    """``submit()`` of a tiny pipeline, fp32, under
    ``torch.cuda.set_sync_debug_mode("error")``: no call between the
    entry and the final copy synchronises; ``result()`` is bitwise the
    ``__call__`` image of the same request (v1 also at euler_a's step
    noise)."""
    import numpy as np

    from powerpaint_tpu_torch.io.weights import init_state
    from powerpaint_tpu_torch.pipelines.brushnet import BrushNetPipeline
    from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline
    from powerpaint_tpu_torch.testing import tiny_v1_config, tiny_v2_config
    from powerpaint_tpu_torch.text.tokenizer import (
        HashTokenizer,
        TokenizerWrapper,
        add_task_tokens,
    )

    v1 = version == "ppt-v1"
    cfg = tiny_v1_config() if v1 else tiny_v2_config()
    tok = TokenizerWrapper(HashTokenizer(994))
    add_task_tokens(tok)
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    pipe = (InpaintPipeline if v1 else BrushNetPipeline)(
        cfg, state, tok, dtype=torch.float32, device=dev)
    rng = np.random.RandomState(1)
    image = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
    mask = np.zeros((64, 64), np.float32)
    mask[16:48, 12:40] = 1.0
    for kw in ([dict(), dict(scheduler="euler_a")] if v1 else [dict()]):
        kw = dict(kw, prompt="a dog", num_inference_steps=3, seed=5)
        want = pipe(image, mask, **kw)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = pipe.submit(image, mask, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got = pending.result()
        assert pending.done()
        assert np.array_equal(got, want)


def _dpt_gn_shapes():
    from powerpaint_tpu_torch.core.config import dpt_hybrid_midas_config
    from powerpaint_tpu_torch.models.dpt import gn_shapes

    return list(dict.fromkeys(gn_shapes(dpt_hybrid_midas_config(), 384, 384)))


@pytest.mark.parametrize("s,c", _dpt_gn_shapes(), ids=str)
def test_group_norm_kernel_at_the_dpt_shapes(dev, s, c):
    """Every BiT GroupNorm shape of the DPT-hybrid forward at 384^2: fp32,
    32 groups (2 channels a group at the stem's 192^2 x 64), eps 1e-5, no
    SiLU."""
    x = _randn(dev, 1, s, c, seed=10) * 2 - 0.3
    w = 1 + 0.1 * _randn(dev, c, seed=11)
    b = 0.1 * _randn(dev, c, seed=12)
    kw = dict(num_groups=32, eps=1e-5, silu=False)
    got = norms.group_norm(x, w, b, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, norms.group_norm_plain(x, w, b, **kw),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape", [(2, 257, 1024), (2, 1024)], ids=str)
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 5e-2)])
def test_layer_norm_kernel_at_the_clip_vision_rows(dev, shape, dtype, atol):
    """The safety checker's tower: 257 tokens of 1024, and the pooled class
    token."""
    x, w, b = _ln_inputs(dev, shape, dtype, seed=13)
    got = norms.layer_norm(x, w, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), norms.layer_norm_plain(x, w, b).float(),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("family", ["dpt", "hed", "bodypose", "safety_checker"])
def test_annotator_networks_on_the_card_match_the_cpu(dev, family):
    """Each network at its full published width, random weights, fp32 with
    TF32 off, on the card and on the CPU at a reduced input: within 1e-3
    of the CPU output's largest magnitude (the same fp32 operations in
    another order)."""
    import numpy as np

    from powerpaint_tpu_torch.core.config import (
        dpt_hybrid_midas_config,
        safety_checker_config,
    )
    from powerpaint_tpu_torch.io.weights import (
        load_annotator,
        random_annotator_state,
    )

    config = {"dpt": dpt_hybrid_midas_config(),
              "safety_checker": safety_checker_config()}.get(family)
    state = random_annotator_state(family, torch.Generator().manual_seed(3),
                                   device="cpu", config=config)
    rng = np.random.RandomState(0)
    x = {"dpt": rng.rand(1, 64, 96, 3) * 2 - 1, "hed": rng.rand(1, 64, 96, 3),
         "bodypose": rng.rand(1, 64, 96, 3) - 0.5,
         "safety_checker": rng.randn(1, 224, 224, 3)}[family]
    x = torch.as_tensor(x.astype(np.float32))
    outs = []
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for d in (dev, torch.device("cpu")):
            m = load_annotator(family, {k: v.to(d) for k, v in state.items()},
                               config=config, device=d)
            with torch.no_grad():
                if family == "bodypose":
                    y = torch.cat([f.flatten() for f in m(x.to(d))])
                elif family == "safety_checker":
                    y = m.visual_projection(m.vision_model(x.to(d))[1])
                else:
                    y = m(x.to(d))
            outs.append(y.float().cpu())
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    scale = float(outs[1].abs().max())
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-3 * scale


def _grad_cases(dev):
    x = _randn(dev, 2, 8, 8, 64, seed=11)
    w = (_randn(dev, 32, 64, 3, 3, seed=12) / 24).contiguous(
        memory_format=torch.channels_last)
    b, g, be = (_randn(dev, n, seed=s) * 0.1 for n, s in ((32, 13), (64, 14),
                                                          (64, 15)))
    q, k, v = (_randn(dev, 2, 64, 2, 40, seed=s) for s in (16, 17, 18))
    return {
        "flash_attention": ((q, k, v), fa.flash_attention,
                            fa.flash_attention_plain, "FlashAttentionBackward"),
        "conv3x3": ((x, w, b), conv.conv3x3, conv.conv3x3_plain,
                    "Conv3x3Backward"),
        "conv3x3_gn_silu": (
            (x, w, b, 1 + g, be),
            lambda *a: conv.conv3x3_gn_silu(*a, num_groups=32, eps=1e-5),
            lambda *a: conv.conv3x3_gn_silu_plain(*a, num_groups=32, eps=1e-5),
            "Conv3x3GnSiluBackward"),
        "group_norm": (
            (x, 1 + g, be),
            lambda *a: norms.group_norm(*a, num_groups=32, eps=1e-6, silu=True),
            lambda *a: norms.group_norm_plain(*a, num_groups=32, eps=1e-6,
                                              silu=True),
            "GroupNormBackward"),
        "layer_norm": ((x, 1 + g, be),
                       lambda *a: norms.layer_norm(*a, eps=1e-5),
                       lambda *a: norms.layer_norm_plain(*a, eps=1e-5),
                       "LayerNormBackward"),
    }


@pytest.mark.parametrize("name", ["flash_attention", "conv3x3",
                                  "conv3x3_gn_silu", "group_norm",
                                  "layer_norm"])
def test_kernel_wrappers_carry_their_gradient(dev, name):
    """On a CUDA tensor that requires a gradient, the wrapper's output has
    its Function's ``grad_fn`` (the kernel fills a fresh tensor, which
    alone would cut the graph), the kernel launches once, and the gradient
    is autograd of the plain version (the backward recomputes it): fp32,
    the same arithmetic, within 1e-5."""
    inputs, fn, plain, fn_name = _grad_cases(dev)[name]
    counter = {"flash_attention": fa.flash_attention, "conv3x3": conv.conv3x3,
               "conv3x3_gn_silu": conv.conv3x3_gn_silu,
               "group_norm": norms.group_norm,
               "layer_norm": norms.layer_norm}[name]
    with torch.enable_grad():
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        refs = [t.detach().clone().requires_grad_(True) for t in inputs]
        before = counter.launches
        out = fn(*leaves)
        assert counter.launches == before + 1
        assert type(out.grad_fn).__name__ == fn_name
        want = plain(*refs)
        cot = torch.randn_like(want)
        got = torch.autograd.grad(out, leaves, cot)
        ref = torch.autograd.grad(want, refs, cot)
    torch.cuda.synchronize()
    assert counter.launches == before + 1  # the backward launches no kernel
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=1e-5, rtol=1e-5)
