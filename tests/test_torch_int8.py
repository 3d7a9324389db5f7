"""The port's static-scale int8 W8A8 units against the JAX package's
``POWERPAINT_INT8`` path.

On the CPU the int8 wrappers of ``powerpaint_tpu_torch.ops.conv`` run their
plain versions (the CUDA kernel's oracle on the card). These tests hold
them, the weight quantiser, the site rule and the option to
``powerpaint_tpu/ops/conv_pallas.py`` (interpret mode) and
``powerpaint_tpu/models/layers.py`` on the same numpy inputs; the tiny
pipeline is in ``test_torch_int8_pipeline.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from powerpaint_tpu.core.config import ppt_v1_config as jax_ppt_v1_config
from powerpaint_tpu.core.config import ppt_v2_config as jax_ppt_v2_config
from powerpaint_tpu.ops import conv_pallas
from powerpaint_tpu_torch.core.config import ppt_v1_config, ppt_v2_config
from powerpaint_tpu_torch.io.weights import build_models, init_state
from powerpaint_tpu_torch.models.layers import Conv2D
from powerpaint_tpu_torch.ops import conv, norms
from powerpaint_tpu_torch.pipelines.common import int8_x_scale
from powerpaint_tpu_torch.testing import tiny_v1_config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quantize_weights_matches_jax_bit_for_bit():
    rng = np.random.RandomState(0)
    w = (rng.randn(24, 40, 3, 3) / 20).astype(np.float32)  # OIHW
    w[3] = 0.0  # an all-zero output channel: the 1e-8 floor
    w[5] = w[5].astype(jnp.bfloat16).astype(np.float32)  # bf16-valued
    w_q, scale = conv.quantize_weights_int8(torch.from_numpy(w))
    want_q, want_s = conv_pallas.quantize_weights_int8(
        jnp.asarray(w.transpose(2, 3, 1, 0)))  # HWIO
    assert w_q.dtype == torch.int8 and w_q.shape == (24, 3, 3, 40)
    assert w_q.is_contiguous()
    np.testing.assert_array_equal(w_q.numpy(),
                                  np.asarray(want_q).transpose(3, 0, 1, 2))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want_s))


# (B, H, W, Cin, Cout), as tests/test_conv_pallas.py
SHAPES = [(1, 8, 8, 128, 128), (2, 8, 8, 64, 128), (1, 16, 8, 128, 256)]


def _assert_within_flip_bound(got, want, x, w_q, w_s, bias, fused, gn,
                              groups, x_scale):
    """Both sides sum the int8 products exactly and dequantise with the
    same fp32 operations, so they differ only where an activation within
    1e-3 of a rounding boundary (the two compute it a few fp32 ulps apart)
    quantises to the neighbouring level: chip_smoke.int8_check bounds each
    output by the flips its 3x3 window can see."""
    err, ok, _ = chip_smoke.int8_check(got, want, x, w_q, w_s, bias, fused,
                                       gn, groups, x_scale)
    assert ok, f"max |err| {err} beyond the flip bound"


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("use_bias", [False, True])
def test_conv3x3_int8_plain_matches_pallas(shape, use_bias):
    b, h, w, cin, cout = shape
    rng = np.random.RandomState(1)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    wt = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32) if use_bias else None
    x_scale = float(np.abs(x).max()) / 127.0
    w_q, w_s = conv_pallas.quantize_weights_int8(jnp.asarray(wt))
    want = conv_pallas.conv3x3_int8(
        jnp.asarray(x), w_q, w_s, x_scale,
        bias=None if bias is None else jnp.asarray(bias), interpret=True)
    tq = torch.from_numpy(np.asarray(w_q).transpose(3, 0, 1, 2).copy())
    ts = torch.from_numpy(np.array(w_s))
    tx = torch.from_numpy(x)
    tb = None if bias is None else torch.from_numpy(bias)
    before = conv.conv3x3_int8.launches
    got = conv.conv3x3_int8(tx, tq, ts, tb, x_scale=x_scale)
    assert conv.conv3x3_int8.launches == before  # CPU: the plain version
    _assert_within_flip_bound(got, torch.from_numpy(np.asarray(want)), tx, tq,
                              ts, tb, False, None, 0, x_scale)


def test_conv3x3_gn_silu_int8_plain_matches_pallas():
    b, h, w, cin, cout, groups = 2, 8, 8, 64, 128, 16
    rng = np.random.RandomState(2)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    wt = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.randn(cin)).astype(np.float32)
    beta = (0.5 + 0.1 * rng.randn(cin)).astype(np.float32)  # a pad shows
    bias = rng.randn(cout).astype(np.float32)
    x_scale = 8.0 / 127.0
    w_q, w_s = conv_pallas.quantize_weights_int8(jnp.asarray(wt))
    want = conv_pallas.conv3x3_gn_silu_int8(
        jnp.asarray(x), w_q, w_s, jnp.asarray(gamma), jnp.asarray(beta),
        groups, x_scale, 1e-5, bias=jnp.asarray(bias), interpret=True)
    tq = torch.from_numpy(np.asarray(w_q).transpose(3, 0, 1, 2).copy())
    ts = torch.from_numpy(np.array(w_s))
    tx = torch.from_numpy(x)
    gn = (torch.from_numpy(gamma), torch.from_numpy(beta))
    tb = torch.from_numpy(bias)
    got = conv.conv3x3_gn_silu_int8(tx, tq, ts, tb, *gn, x_scale=x_scale,
                                    num_groups=groups, eps=1e-5)
    _assert_within_flip_bound(got, torch.from_numpy(np.asarray(want)), tx, tq,
                              ts, tb, True, gn, groups, x_scale)


def _all_sites(cfg, h, w):
    """Every GroupNorm-fed conv of one call at an h x w image (chip_smoke's
    enumeration from the config)."""
    sites = chip_smoke.unet_sites(cfg.unet, h // 8, w // 8)
    if cfg.brushnet is not None:
        sites += chip_smoke.unet_sites(cfg.brushnet.base, h // 8, w // 8)
    return sites + (chip_smoke.vae_sites(cfg.vae, h, w, False)
                    + chip_smoke.vae_sites(cfg.vae, h, w, True))


@pytest.mark.parametrize("hw", [(512, 512), (640, 768)], ids=str)
def test_int8_site_is_the_jax_gate(hw):
    sites = set(_all_sites(ppt_v1_config(), *hw) + _all_sites(ppt_v2_config(), *hw))
    for h, w, cin, cout in sites:
        assert conv.int8_site(h, w, cin, cout) == \
            conv_pallas.int8_fused_feasible(1, h, w, cin, cout), (h, w, cin, cout)
    assert any(not conv.int8_site(*s) for s in sites)
    # the same sites from the JAX package's configs
    assert _all_sites(ppt_v1_config(), *hw) == _all_sites(jax_ppt_v1_config(), *hw)
    assert _all_sites(ppt_v2_config(), *hw) == _all_sites(jax_ppt_v2_config(), *hw)


def test_site_enumeration_is_what_the_model_runs():
    """chip_smoke's sites from the config are the (H, W, Cin, Cout) the
    tiny ppt-v1 UNet and VAE hand ``Conv2D(x, gn=...)``, in order."""
    cfg = tiny_v1_config()
    state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    models = build_models(cfg, device="cpu")
    seen = []
    for name, model in models.items():
        model.load_state_dict(state[name])
        for m in model.modules():
            if isinstance(m, Conv2D):
                m.register_forward_pre_hook(
                    lambda mod, args, kw: seen.append(
                        (*args[0].shape[1:], mod.out_channels))
                    if kw.get("gn") is not None else None, with_kwargs=True)
    h, w = 64, 48
    with torch.no_grad():
        models["unet"](torch.randn(2, h // 8, w // 8, 9), torch.tensor(5),
                       torch.randn(2, 77, 32))
        assert seen == chip_smoke.unet_sites(cfg.unet, h // 8, w // 8)
        seen.clear()
        models["vae"].encode(torch.randn(1, h, w, 3))
        assert seen == chip_smoke.vae_sites(cfg.vae, h, w, False)
        seen.clear()
        models["vae"].decode(torch.randn(1, h // 8, w // 8, 4))
        assert seen == chip_smoke.vae_sites(cfg.vae, h, w, True)


def test_the_option_is_read_once_from_the_environment(monkeypatch):
    monkeypatch.delenv("POWERPAINT_INT8", raising=False)
    monkeypatch.delenv("POWERPAINT_INT8_XSCALE", raising=False)
    assert int8_x_scale(None) is None and int8_x_scale(False) is None
    assert int8_x_scale(True) == 8.0 / 127.0
    for value in ("0", "true", " 1"):
        monkeypatch.setenv("POWERPAINT_INT8", value)
        assert int8_x_scale(None) is None
    monkeypatch.setenv("POWERPAINT_INT8", "1")
    monkeypatch.setenv("POWERPAINT_INT8_XSCALE", "4")
    assert int8_x_scale(None) == 4.0 / 127.0
    assert int8_x_scale(False) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_quantisers_are_the_route_they_replace(dtype):
    """The plain quantisers (the card kernel's oracles) against the
    quantise-inside-the-product route the plain int8 units had: the same
    int8 levels, and the plain units bitwise the old route's outputs. The
    CPU wrappers run them and count no launch."""
    rng = np.random.RandomState(3)
    b, h, w, cin, cout, groups = 2, 6, 5, 48, 24, 16
    x = torch.from_numpy((rng.randn(b, h, w, cin) * 2 - 0.3).astype(np.float32)).to(dtype)
    x[0, 0, 0, :4] = torch.tensor([0.5, 1.5, -2.5, 300.0]) * (8.0 / 127.0)  # ties, clip
    gamma = torch.from_numpy((1 + 0.1 * rng.randn(cin)).astype(np.float32))
    beta = torch.from_numpy((0.5 + 0.1 * rng.randn(cin)).astype(np.float32))
    w_q, w_s = conv.quantize_weights_int8(
        torch.from_numpy((rng.randn(cout, cin, 3, 3) / 20).astype(np.float32)))
    bias = torch.from_numpy(rng.randn(cout).astype(np.float32))
    x_scale = 8.0 / 127.0
    inv = float(np.float32(1.0 / x_scale))

    def old_route(y):  # the former _int8_product_plain on fp32 y
        q = torch.clamp(torch.round(y * inv), -127, 127)
        acc = torch.nn.functional.conv2d(q.permute(0, 3, 1, 2).double(),
                                         w_q.permute(0, 3, 1, 2).double(), padding=1)
        out = acc.permute(0, 2, 3, 1).float() * (w_s * x_scale) + bias
        return q, out.to(dtype)

    kw = dict(num_groups=groups, eps=1e-5, x_scale=x_scale)
    y = norms.gn_silu_fp32(x, gamma, beta, num_groups=groups, eps=1e-5)
    for q, (want_q, want) in (
            (norms.gn_silu_quantize_int8_plain(x, gamma, beta, **kw), old_route(y)),
            (norms.quantize_int8_plain(x, x_scale=x_scale), old_route(x.float()))):
        assert q.dtype == torch.int8 and q.shape == x.shape
        assert torch.equal(q.float(), want_q)
    assert [int(v) for v in norms.quantize_int8_plain(x, x_scale=x_scale)[0, 0, 0, :4]] == \
        [0, 2, -2, 127]
    assert torch.equal(conv.conv3x3_gn_silu_int8_plain(x, w_q, w_s, bias, gamma, beta, **kw),
                       old_route(y)[1])
    assert torch.equal(conv.conv3x3_int8_plain(x, w_q, w_s, bias, x_scale=x_scale),
                       old_route(x.float())[1])
    before = (norms.gn_silu_quantize_int8.launches, norms.quantize_int8.launches)
    assert torch.equal(norms.gn_silu_quantize_int8(x, gamma, beta, **kw),
                       norms.gn_silu_quantize_int8_plain(x, gamma, beta, **kw))
    assert torch.equal(norms.quantize_int8(x, x_scale=x_scale),
                       norms.quantize_int8_plain(x, x_scale=x_scale))
    assert (norms.gn_silu_quantize_int8.launches, norms.quantize_int8.launches) == before
