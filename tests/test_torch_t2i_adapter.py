"""The port's T2I-Adapter, the UNet's adapter inputs and
``brushnet_params_from_unet`` against the JAX package's, in fp32 at the
tiny configs.

- ``pixel_unshuffle`` bitwise against the JAX one and torch's NCHW op;
- the adapter tower (diffusers names, ``convert_t2i_adapter``) against the
  JAX ``T2IAdapter``, its features at the tiny UNet's down-block grid;
- the UNet with intrablock features (one inside each cross-attention down
  block, one after the plain down block, a leftover on the mid block) and
  with one and two IP-Adapters, against ONE compiled JAX UNet that takes
  both inputs: zero features and zero scales add exact zeros there, so the
  T2I case runs it with the scales at 0 and the IP cases with zero
  features;
- zero features change no bit, the encoder caches refuse features;
- ``brushnet_params_from_unet`` ``array_equal`` to ``params_from_jax`` of
  the JAX result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from powerpaint_tpu.io import convert as jax_convert
from powerpaint_tpu.models.adapter import T2IAdapter as JaxAdapter
from powerpaint_tpu.models.adapter import pixel_unshuffle as jax_unshuffle
from powerpaint_tpu.models.unet import UNet2DConditionModel as JaxUNet
from powerpaint_tpu.testing import tiny_unet as jax_tiny_unet
from powerpaint_tpu_torch.core.config import BrushNetConfig
from powerpaint_tpu_torch.io import convert
from powerpaint_tpu_torch.io.weights import params_from_jax, random_state
from powerpaint_tpu_torch.models.adapter import T2IAdapter, pixel_unshuffle
from powerpaint_tpu_torch.models.brushnet import BrushNetModel
from powerpaint_tpu_torch.models.unet import UNet2DConditionModel
from powerpaint_tpu_torch.testing import tiny_unet
from test_torch_ip_adapter import DIM, TOKENS, ip_checkpoint


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32 = jnp.float32
ATOL, RTOL = 2e-4, 1e-4  # fp32, the same sums in another order
CHANNELS = tiny_unet(4).block_out_channels  # the tower feeds the tiny UNet


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def _random(model, seed):
    """Numpy weights of ``model`` (built on meta): ``random_state``'s draw,
    every bias and norm affine made live."""
    sd = random_state(model, torch.Generator().manual_seed(seed), "cpu")
    rng = np.random.RandomState(seed)
    return {k: (v.numpy() + 0.1 * rng.randn(*v.shape).astype(np.float32)
                if v.dim() == 1 else v.numpy()) for k, v in sd.items()}


def _load(model, sd):
    model.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True,
                          assign=True)
    return model.eval()


@pytest.mark.parametrize("r", [2, 8])
def test_pixel_unshuffle_is_torchs_and_jaxs(r):
    x = np.random.RandomState(r).randn(2, 16, 24, 3).astype(np.float32)
    got = pixel_unshuffle(_t(x), r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_unshuffle(x, r)))
    nchw = F.pixel_unshuffle(_t(x).permute(0, 3, 1, 2), r)
    assert torch.equal(got, nchw.permute(0, 2, 3, 1))


@pytest.fixture(scope="module")
def tower():
    with torch.device("meta"):
        model = T2IAdapter(CHANNELS, num_res_blocks=2)
    sd = _random(model, 3)
    port = _load(model, convert.convert_t2i_adapter(sd))
    return sd, port


def test_adapter_tower_matches_jax(tower):
    sd, port = tower
    cond = np.random.RandomState(4).rand(2, 64, 64, 3).astype(np.float32)
    want = JaxAdapter(channels=CHANNELS, num_res_blocks=2, dtype=F32).apply(
        {"params": jax_convert.convert_t2i_adapter(sd)}, cond)
    with torch.no_grad():
        got = port(_t(cond))
    assert [tuple(f.shape) for f in got] == [
        (2, 8, 8, 32), (2, 4, 4, 64), (2, 2, 2, 64), (2, 1, 1, 64)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert float(np.abs(np.asarray(w)).max()) > 0.1, i  # live features
        _close(g, w)
    # the JAX tree's names come back through params_from_jax
    back = params_from_jax(jax_convert.convert_t2i_adapter(sd), "t2i_adapter")
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


# ---------------------------------------------------------------------------
# the UNet: intrablock features and image embeddings
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def unet():
    """The tiny base UNet with two IP-Adapters: its numpy state, the merged
    JAX tree, the port UNet, ONE compiled JAX forward that takes the image
    embeddings, their scales and five intrablock features, and inputs."""
    cfg = tiny_unet(4).replace(ip_adapter_dim=DIM,
                               ip_adapter_tokens=(TOKENS, TOKENS))
    with torch.device("meta"):
        base = _random(UNet2DConditionModel(tiny_unet(4)), 0)
    jcfg = jax_tiny_unet(4).replace(ip_adapter_dim=DIM, ip_adapter_tokens=TOKENS)
    tree, sd = jax_convert.convert_unet(base), dict(base)
    for a, seed in enumerate((1, 2)):
        ip_sd = ip_checkpoint(cfg, seed)
        tree = jax_convert.merge_ip_adapter(
            tree, jax_convert.convert_ip_adapter(ip_sd, jcfg, a))
        sd = convert.merge_ip_adapter(sd, convert.convert_ip_adapter(ip_sd, cfg, a))
    with torch.device("meta"):
        model = _load(UNet2DConditionModel(cfg), sd)
    fn = jax.jit(lambda p, s, t, c, e, sc, f: JaxUNet(jcfg, dtype=F32).apply(
        {"params": p}, s, t, c, image_embeds=e, ip_scale=sc,
        down_intrablock_additional_residuals=f))
    rng = np.random.RandomState(6)
    shapes = [(2, 8, 8, 32), (2, 4, 4, 64), (2, 2, 2, 64), (2, 1, 1, 64),
              (2, 1, 1, 64)]  # one per down block, then the mid leftover
    x = dict(sample=rng.randn(2, 8, 8, 4).astype(np.float32),
             t=np.asarray([981, 501], np.int32),
             ctx=rng.randn(2, 77, 32).astype(np.float32),
             e=tuple(rng.randn(2, DIM).astype(np.float32) for _ in range(2)),
             feats=tuple((0.5 * rng.randn(*s)).astype(np.float32) for s in shapes))
    return sd, tree, model, fn, x


def _args(x):
    return _t(x["sample"]), torch.from_numpy(x["t"]), _t(x["ctx"])


def _jax(unet, scales=(0.0, 0.0), feats=None):
    _, tree, _, fn, x = unet
    feats = feats if feats is not None else tuple(np.zeros_like(f) for f in x["feats"])
    return fn(tree, x["sample"], x["t"], x["ctx"], x["e"],
              tuple(np.float32(s) for s in scales), feats)


def test_unet_intrablock_features_match_jax(unet):
    """One feature inside each cross-attention down block, one after the
    plain down block, and a mid-shaped leftover on the mid block."""
    _, _, model, _, x = unet
    feats = [_t(f) for f in x["feats"]]
    with torch.no_grad():
        got = model(*_args(x), down_intrablock_additional_residuals=feats)
        plain = model(*_args(x))
        # the plain block's feature and the mid leftover each count
        no_plain = model(*_args(x), down_intrablock_additional_residuals=[
            *feats[:3], torch.zeros_like(feats[3]), feats[4]])
        no_mid = model(*_args(x), down_intrablock_additional_residuals=feats[:4])
    _close(got, _jax(unet, feats=x["feats"]))
    for other in (plain, no_plain, no_mid):
        assert float((got - other).abs().max()) > 1e-2


@pytest.mark.parametrize("adapters", [1, 2])
def test_unet_with_image_embeds_matches_jax(unet, adapters):
    """One adapter: a UNet built with one, against the JAX UNet with the
    second scale 0; two: the stack with its own scales."""
    sd, _, model, _, x = unet
    scales = (0.7, 1.3) if adapters == 2 else (0.7, 0.0)
    want = _jax(unet, scales)
    if adapters == 1:
        cfg = tiny_unet(4).replace(ip_adapter_dim=DIM)
        with torch.device("meta"):
            model = _load(UNet2DConditionModel(cfg), {
                k: v for k, v in sd.items()
                if not any(s in k for s in (".to_k_ip.1.", ".to_v_ip.1.",
                                            "encoder_hid_proj.1."))})
        embeds, ip_scale = _t(x["e"][0]), 0.7
    else:
        embeds, ip_scale = [_t(e) for e in x["e"]], [0.7, 1.3]
    assert len(model.encoder_hid_proj) == adapters
    with torch.no_grad():
        got = model(*_args(x), image_embeds=embeds, ip_scale=ip_scale)
        plain = model(*_args(x))
    _close(got, want)
    assert float((got - plain).abs().max()) > 1e-2  # the adapters count


def test_zero_features_and_zero_scales_change_no_bit(unet, tower):
    _, _, model, _, x = unet
    _, port_tower = tower
    cond = _t(np.random.RandomState(7).rand(2, 64, 64, 3))
    with torch.no_grad():
        feats = port_tower(cond)
        plain = model(*_args(x))
        assert [f.shape for f in feats] == [f.shape for f in
                                            map(_t, x["feats"][:4])]
        fed = model(*_args(x), down_intrablock_additional_residuals=feats)
        zero = model(*_args(x), down_intrablock_additional_residuals=[
            torch.zeros_like(f) for f in feats])
        off = model(*_args(x), image_embeds=[_t(e) for e in x["e"]],
                    ip_scale=[0.0, 0.0])
    assert float((fed - plain).abs().max()) > 1e-2
    assert torch.equal(zero, plain) and torch.equal(off, plain)


def test_encoder_caches_refuse_intrablock_features(unet):
    _, _, model, _, x = unet
    feats = [_t(f) for f in x["feats"][:4]]
    with torch.no_grad():
        _, cache = model(*_args(x), emit_encoder_cache=True)
        for kw in (dict(emit_encoder_cache=True), dict(encoder_cache=cache)):
            with pytest.raises(ValueError, match="encoder caching"):
                model(*_args(x), down_intrablock_additional_residuals=feats, **kw)


# ---------------------------------------------------------------------------
# A11: a BrushNet initialised from a UNet
# ---------------------------------------------------------------------------


def test_brushnet_params_from_unet_matches_jax():
    cfg = tiny_unet(4)
    with torch.device("meta"):
        unet_sd = _random(UNet2DConditionModel(cfg), 8)
        branch = BrushNetModel(BrushNetConfig(base=cfg))
    template = _random(branch, 9)
    got = convert.brushnet_params_from_unet(unet_sd, template)
    want = params_from_jax(jax_convert.brushnet_params_from_unet(
        jax_convert.convert_unet(unet_sd), jax_convert.convert_brushnet(template)),
        "brushnet")
    assert set(got) == set(want) == set(template)
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(v), want[k], err_msg=k)
    w = np.asarray(got["conv_in_condition.weight"])  # (C, 4 + 5, 3, 3)
    np.testing.assert_array_equal(w[:, :4], unet_sd["conv_in.weight"])
    np.testing.assert_array_equal(w[:, 4:8], unet_sd["conv_in.weight"])
    assert not w[:, 8:].any()
    np.testing.assert_array_equal(got["brushnet_down_blocks.0.weight"],
                                  template["brushnet_down_blocks.0.weight"])
    _load(branch, got)  # every name and shape a BrushNet has
