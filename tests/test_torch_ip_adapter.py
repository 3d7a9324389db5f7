"""The port's IP-Adapter against the JAX package's, in fp32 at the tiny
configs: the decoupled cross-attention, the image projection, the
checkpoint converter and its merge, the attn2 order, the image encode
(``gelu`` and ``quick_gelu`` towers), the v2 directory loader with adapter
files, and the port's own semantics (scale 0, a stack with one scale 0,
the refusals, the controller's pass-through). Two comparisons ride on JAX
compiles made elsewhere, to keep the suite's time: the UNet with one and
two adapters on ``test_torch_t2i_adapter.py``'s one JAX UNet (which takes
both adapters' inputs), and a v2 pipeline call with image embeddings,
within 1e-3 of the JAX call's float image, on
``test_torch_call_surface.py::test_v2_call_surface_matches_jax``'s one JAX
pipeline (the IP-Adapter arguments are part of the reference's call
surface). This file compiles no JAX pipeline.

The IP weights are a synthetic checkpoint in the published layouts (the
nested ``ip-adapter_sd15.bin`` one and flat ``.safetensors`` keys), taken
through each package's converter; the rest are the port's random weights
through the JAX package's converters (``test_torch_brushnet.v2_weights``).
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import powerpaint_tpu.models.clip_text as jax_clip_text
from powerpaint_tpu.core.config import CLIPVisionConfig as JaxVisionConfig
from powerpaint_tpu.core.config import PowerPaintConfig as JaxConfig
from powerpaint_tpu.io import checkpoint as jax_ckpt
from powerpaint_tpu.io import convert as jax_convert
from powerpaint_tpu.models.clip_vision import (
    CLIPVisionModelWithProjection as JaxTower,
)
from powerpaint_tpu.models.projection import ImageProjection as JaxProjection
from powerpaint_tpu.models.transformer import Attention as JaxAttention
from powerpaint_tpu.pipelines.brushnet import BrushNetPipeline as JaxPipeline
from powerpaint_tpu.testing import tiny_unet as jax_tiny_unet
from powerpaint_tpu_torch import controller
from powerpaint_tpu_torch.core.config import (
    CLIPVisionConfig,
    PowerPaintConfig,
    ppt_v2_config,
    vit_h14_image_encoder_config,
)
from powerpaint_tpu_torch.core.validation import InputValidationError
from powerpaint_tpu_torch.io import checkpoint, convert
from powerpaint_tpu_torch.io import safetensors as port_st
from powerpaint_tpu_torch.io.weights import (
    _torch_key,
    build_annotator,
    params_from_jax,
    random_state,
)
from powerpaint_tpu_torch.models.projection import ImageProjection
from powerpaint_tpu_torch.models.transformer import Attention
from powerpaint_tpu_torch.pipelines.brushnet import BrushNetPipeline
from powerpaint_tpu_torch.testing import tiny_unet, tiny_v2_config
from powerpaint_tpu_torch.text.tokenizer import (
    HashTokenizer,
    TokenizerWrapper,
    add_task_tokens,
)
from test_torch_brushnet import v2_weights
from test_torch_checkpoint import write_v2


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
DIM, TOKENS = 16, 4  # the tiny towers' projection; ip-adapter_sd15's tokens
HW = 64


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=RTOL)


def _attn2_width(cfg, path):
    kind, i = path.split(".")[:2]
    if kind == "down_blocks":
        return cfg.block_out_channels[int(i)]
    if kind == "up_blocks":
        return tuple(reversed(cfg.block_out_channels))[int(i)]
    return cfg.block_out_channels[-1]


def ip_checkpoint(cfg, seed, layout="nested"):
    """A synthetic IP-Adapter checkpoint for the UNet config ``cfg``:
    ``ip-adapter_sd15.bin``'s nested layout or the flat safetensors keys,
    lecun-scaled numpy weights, live norm affines."""
    rng = np.random.RandomState(seed)
    d = cfg.cross_attention_dim
    proj = {"proj.weight": rng.randn(TOKENS * d, DIM) / DIM ** 0.5,
            "proj.bias": 0.1 * rng.randn(TOKENS * d),
            "norm.weight": 1 + 0.1 * rng.randn(d),
            "norm.bias": 0.1 * rng.randn(d)}
    adapter = {}
    for idx, path in enumerate(convert.ip_adapter_attn2_paths(cfg)):
        for name in ("to_k_ip", "to_v_ip"):
            adapter[f"{2 * idx + 1}.{name}.weight"] = rng.randn(
                _attn2_width(cfg, path), d) / d ** 0.5
    sd = {"image_proj": proj, "ip_adapter": adapter}
    sd = {g: {k: v.astype(np.float32) for k, v in part.items()}
          for g, part in sd.items()}
    if layout == "flat":
        return {f"{g}.{k}": v for g, part in sd.items() for k, v in part.items()}
    return sd


@pytest.fixture(scope="module")
def weights():
    """The tiny v2 weights (numpy state dicts and JAX trees) and two
    synthetic adapters for its base UNet."""
    sd_np, trees = v2_weights()
    return sd_np, trees, ip_checkpoint(tiny_unet(4), 1), ip_checkpoint(
        tiny_unet(4), 2)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("adapters", [1, 2])
def test_decoupled_attention_matches_jax(adapters):
    dim, ctx_dim, heads, tokens = 16, 24, 4, 4
    rng = np.random.RandomState(3)

    def lin(i, o):
        return {"kernel": (rng.randn(i, o) / i ** 0.5).astype(np.float32)}

    tree = {"to_q": lin(dim, dim), "to_k": lin(ctx_dim, dim),
            "to_v": lin(ctx_dim, dim),
            "to_out": dict(lin(dim, dim),
                           bias=0.1 * rng.randn(dim).astype(np.float32))}
    for a in range(adapters):
        sfx = "" if a == 0 else f"_{a}"
        tree[f"to_k_ip{sfx}"] = lin(ctx_dim, dim)
        tree[f"to_v_ip{sfx}"] = lin(ctx_dim, dim)
    x = rng.randn(2, 64, dim).astype(np.float32)
    ctx = rng.randn(2, 77, ctx_dim).astype(np.float32)
    ips = [rng.randn(2, tokens, ctx_dim).astype(np.float32) for _ in range(adapters)]
    scales = (0.7, 1.3)[:adapters]
    ip_arg = ips[0] if adapters == 1 else tuple(ips)
    sc_arg = scales[0] if adapters == 1 else scales
    want = jax.jit(lambda p, *a: JaxAttention(heads, dim // heads, dtype=F32).apply(
        {"params": p}, *a, ip_scale=sc_arg))(tree, x, ctx, ip_arg)

    model = Attention(dim, heads, dim // heads, ctx_dim, ip_adapters=adapters)
    model.load_state_dict({k: _t(v) for k, v in params_from_jax(tree, "unet").items()})
    got = model(_t(x), _t(ctx), _t(ips[0]) if adapters == 1 else [_t(i) for i in ips],
                sc_arg)
    _close(got, want)
    plain = model(_t(x), _t(ctx))
    assert float((got - plain).abs().max()) > 0.1  # the image tokens count


def test_image_projection_matches_jax():
    rng = np.random.RandomState(4)
    tree = {"image_embeds": {"kernel": rng.randn(DIM, TOKENS * 32).astype(np.float32),
                             "bias": rng.randn(TOKENS * 32).astype(np.float32)},
            "norm": {"scale": (1 + 0.1 * rng.randn(32)).astype(np.float32),
                     "bias": (0.1 * rng.randn(32)).astype(np.float32)}}
    e = rng.randn(2, DIM).astype(np.float32)
    want = JaxProjection(32, TOKENS, dtype=F32).apply({"params": tree}, e)
    model = ImageProjection(DIM, 32, TOKENS)
    model.load_state_dict({k: _t(v) for k, v in params_from_jax(tree, "unet").items()})
    got = model(_t(e))
    assert got.shape == (2, TOKENS, 32)
    _close(got, want)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def test_config_round_trips_the_adapter_fields():
    """``ip_adapter_dim``, the tokens of a stack and the image tower go
    through JSON, and a config the port writes loads in the JAX package
    with the same fields."""
    cfg = ppt_v2_config()
    cfg = cfg.replace(unet=cfg.unet.replace(ip_adapter_dim=1024,
                                            ip_adapter_tokens=(4, 16)),
                      image_encoder=vit_h14_image_encoder_config())
    back = PowerPaintConfig.from_json(cfg.to_json())
    assert back == cfg and back.unet.ip_adapters == (4, 16)
    theirs = JaxConfig.from_json(cfg.to_json())
    assert (theirs.unet.ip_adapter_dim, theirs.unet.ip_adapter_tokens) == (
        1024, (4, 16))
    assert theirs.image_encoder.to_dict() == cfg.image_encoder.to_dict()
    assert PowerPaintConfig.from_json(ppt_v2_config().to_json()).unet.ip_adapters == ()


@pytest.mark.parametrize("layout", ["nested", "flat"])
@pytest.mark.parametrize("adapter_index", [0, 1])
def test_convert_ip_adapter_matches_jax(weights, layout, adapter_index):
    sd_np, trees, _, _ = weights
    port_cfg = tiny_unet(4).replace(ip_adapter_dim=DIM)
    jax_cfg = jax_tiny_unet(4).replace(ip_adapter_dim=DIM)
    ip_sd = ip_checkpoint(port_cfg, 5, layout)
    got = convert.merge_ip_adapter(
        sd_np["unet"], convert.convert_ip_adapter(ip_sd, port_cfg, adapter_index))
    want = params_from_jax(jax_convert.merge_ip_adapter(
        trees["unet"], jax_convert.convert_ip_adapter(ip_sd, jax_cfg,
                                                      adapter_index)), "unet")
    assert set(got) == set(want)
    assert len(got) == len(sd_np["unet"]) + 4 + 2 * 16
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(v), want[k], err_msg=k)


def test_attn2_paths_keep_the_reference_order():
    """Checkpoint ids 1, 3, 5, ... name the down, then up, then mid attn2s
    (diffusers' ``attn_processors`` order), as the JAX package maps them."""
    for cfg in (ppt_v2_config().unet, tiny_unet(4)):
        got = convert.ip_adapter_attn2_paths(cfg)
        assert [p.split(".")[0] for p in got] == (
            ["down_blocks"] * 6 + ["up_blocks"] * 9 + ["mid_block"])
    want = [_torch_key(p) for p in jax_convert.ip_adapter_attn2_paths(
        jax_tiny_unet(4))]
    assert convert.ip_adapter_attn2_paths(tiny_unet(4)) == want


# ---------------------------------------------------------------------------
# the image encode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_encode_one_ip_image_matches_jax(monkeypatch, act):
    """The resize, the CLIP normalisation and the tower, on a tiny tower.
    The JAX package's ``gelu`` is flax's tanh approximation, where
    transformers' (and so the published ViT-H's) is the exact erf form,
    which the port computes (ROADMAP Queue C): the JAX side takes the erf
    form here."""
    if act == "gelu":
        monkeypatch.setattr(jax_clip_text.nn, "gelu",
                            lambda x: jax.nn.gelu(x, approximate=False))
    kw = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=2, image_size=32, patch_size=8,
              projection_dim=DIM, hidden_act=act)
    cfg = CLIPVisionConfig(**kw)
    sd = random_state(build_annotator("clip_vision", cfg),
                      torch.Generator().manual_seed(3), "cpu")
    rng = np.random.RandomState(8)
    sd = {k: (v + 0.1 * torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
              if v.dim() == 1 else v) for k, v in sd.items()}
    tree = jax_convert.convert_clip_vision({k: v.numpy() for k, v in sd.items()})
    jcfg = JaxVisionConfig(**kw)
    stub = types.SimpleNamespace(
        config=types.SimpleNamespace(image_encoder=jcfg),
        params={"image_encoder": tree},
        _encode_ip_image=jax.jit(lambda p, px: JaxTower(jcfg, dtype=F32).apply(
            {"params": p}, px)))
    image = (rng.rand(48, 40, 3) * 255).astype(np.uint8)
    want = JaxPipeline._encode_one_ip_image(stub, image)

    tower = build_annotator("clip_vision", cfg, device="cpu")
    tower.load_state_dict(sd, assign=True)
    port = types.SimpleNamespace(config=types.SimpleNamespace(image_encoder=cfg),
                                 image_encoder=tower.eval(),
                                 device=torch.device("cpu"))
    got = BrushNetPipeline._encode_one_ip_image(port, image)
    assert got.shape == (1, DIM) and got.dtype == torch.float32
    _close(got, want)


# ---------------------------------------------------------------------------
# the v2 pipeline
# ---------------------------------------------------------------------------


def _image_mask():
    rng = np.random.RandomState(0)
    image = (rng.rand(HW, HW, 3) * 255).astype(np.uint8)
    mask = np.zeros((HW, HW), np.float32)
    mask[13:50, 10:45] = 1.0
    return image, mask


def _tokenizer():
    tok = TokenizerWrapper(HashTokenizer(994))
    add_task_tokens(tok)
    return tok


@pytest.fixture(scope="module")
def stack_pipe(weights):
    """The port's tiny v2 pipeline with two adapters and a tiny tower."""
    sd_np, _, sd0, sd1 = weights
    cfg = tiny_v2_config()
    cfg = cfg.replace(unet=cfg.unet.replace(ip_adapter_dim=DIM,
                                            ip_adapter_tokens=(TOKENS, TOKENS)),
                      image_encoder=CLIPVisionConfig(
                          hidden_size=32, intermediate_size=64,
                          num_hidden_layers=2, num_attention_heads=2,
                          image_size=32, patch_size=8, projection_dim=DIM))
    unet = sd_np["unet"]
    for a, sd in enumerate((sd0, sd1)):
        unet = convert.merge_ip_adapter(unet, convert.convert_ip_adapter(
            sd, cfg.unet, a))
    tower = random_state(build_annotator("clip_vision", cfg.image_encoder),
                         torch.Generator().manual_seed(4), "cpu")
    state = dict(sd_np, unet=unet, image_encoder=tower)
    return BrushNetPipeline(cfg, state, _tokenizer(), dtype=torch.float32,
                            device="cpu")


def _call(pipe, **kw):
    image, mask = _image_mask()
    return pipe(image, mask, prompt="a dog", num_inference_steps=2, seed=3,
                output_type="float32", **kw)


def test_scale_zero_and_a_stack_with_one_scale_zero(stack_pipe):
    """Scale 0 gives the image without the adapter, bit for bit; a stack
    of two with the second at 0 gives the first alone."""
    rng = np.random.RandomState(10)
    e0, e1 = (rng.randn(DIM).astype(np.float32) for _ in range(2))
    base = _call(stack_pipe)
    one = _call(stack_pipe, ip_adapter_image_embeds=e0)
    assert np.abs(one - base).max() > 1e-2
    np.testing.assert_array_equal(
        _call(stack_pipe, ip_adapter_image_embeds=e0, ip_adapter_scale=0.0), base)
    np.testing.assert_array_equal(
        _call(stack_pipe, ip_adapter_image_embeds=[e0, e1],
              ip_adapter_scale=[1.0, 0.0]), one)
    both = _call(stack_pipe, ip_adapter_image_embeds=[e0, e1])
    assert np.abs(both - one).max() > 1e-2
    image, _ = _image_mask()
    with_image = _call(stack_pipe, ip_adapter_image=image)
    np.testing.assert_array_equal(
        with_image, _call(stack_pipe, ip_adapter_image_embeds=
                          stack_pipe._encode_one_ip_image(image)))


def test_refusals(stack_pipe, weights):
    image, _ = _image_mask()
    e = np.zeros(DIM, np.float32)
    with pytest.raises(InputValidationError, match="not both"):
        _call(stack_pipe, ip_adapter_image=image, ip_adapter_image_embeds=e)
    with pytest.raises(InputValidationError, match="3 IP-Adapter embeddings"):
        _call(stack_pipe, ip_adapter_image_embeds=[e, e, e])
    sd_np, _, _, _ = weights
    plain = BrushNetPipeline(tiny_v2_config(), sd_np, _tokenizer(),
                             dtype=torch.float32, device="cpu")
    with pytest.raises(InputValidationError, match="needs an image encoder"):
        _call(plain, ip_adapter_image=image)
    with pytest.raises(InputValidationError, match="for a UNet with 0 adapters"):
        _call(plain, ip_adapter_image_embeds=e)


def test_controller_passes_the_adapter_through(stack_pipe):
    image, mask = _image_mask()
    pp = controller.PowerPaint(stack_pipe)
    e = np.random.RandomState(11).randn(DIM).astype(np.float32)
    kw = dict(prompt="a dog", num_inference_steps=2, seed=3)
    base = pp.infer(image, mask, **kw).raw
    assert np.array_equal(pp.infer(image, mask, ip_adapter_image_embeds=e,
                                   ip_adapter_scale=0.0, **kw).raw, base)
    assert not np.array_equal(pp.infer(image, mask, ip_adapter_image=image,
                                       **kw).raw, base)


# ---------------------------------------------------------------------------
# the v2 directory
# ---------------------------------------------------------------------------


def _write_tower(d, cfg_json, seed):
    """``image_encoder/``: transformers names, the ``position_ids`` buffer,
    and ``config.json``."""
    cfg = CLIPVisionConfig(**{k: cfg_json[k] for k in (
        "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "image_size", "patch_size", "projection_dim",
        "hidden_act")})
    sd = random_state(build_annotator("clip_vision", cfg),
                      torch.Generator().manual_seed(seed), "cpu")
    n = (cfg.image_size // cfg.patch_size) ** 2 + 1
    d.mkdir(parents=True)
    port_st.save_file({**sd, "vision_model.embeddings.position_ids":
                       torch.arange(n)[None]}, str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps(cfg_json))


TOWER = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             image_size=32, patch_size=8, projection_dim=DIM,
             layer_norm_eps=1e-5)


@pytest.mark.parametrize("ip_file", ["ip_adapter.safetensors",
                                     "ip-adapter_sd15.bin"])
def test_v2_directory_with_adapter_files_matches_jax(tmp_path, weights, ip_file):
    """The v2 layout with an IP-Adapter file at the root and a tower whose
    ``config.json`` agrees with the JAX loader's shape rule (64 channels a
    head, ``quick_gelu``): every tensor ``array_equal`` to the JAX loader's
    tree, the same adapter shape and tower config, and a call that runs.
    The JAX loader cannot read the published nested ``.bin`` (its torch
    reader takes every value for a tensor: ROADMAP Queue C); there the
    reference is its converters on the file's dicts."""
    sd_np, _, _, _ = weights
    root = tmp_path / "ppt-v2"
    write_v2(root, {f: {k: _t(v) for k, v in sd.items()} for f, sd in sd_np.items()})
    ip_sd = ip_checkpoint(tiny_unet(4), 12)
    if ip_file.endswith(".bin"):
        torch.save({g: {k: _t(v) for k, v in part.items()}
                    for g, part in ip_sd.items()}, root / ip_file)
    else:
        port_st.save_file({f"{g}.{k}": _t(v) for g, part in ip_sd.items()
                           for k, v in part.items()}, str(root / ip_file))
    _write_tower(root / "image_encoder",
                 dict(TOWER, num_attention_heads=1, hidden_act="quick_gelu"), 6)
    got = checkpoint.load_ppt_v2(str(root), config=tiny_v2_config(),
                                 dtype=torch.float32, device="cpu")
    if ip_file.endswith(".bin"):
        with pytest.raises(AttributeError):
            jax_ckpt.load_ppt_v2(str(root), dtype=jnp.float32)
        tower = jax_convert.load_state_dict(
            str(root / "image_encoder" / "model.safetensors"))
        params = {"unet": jax_convert.merge_ip_adapter(
            jax_convert.convert_unet(sd_np["unet"]),
            jax_convert.convert_ip_adapter(ip_sd, jax_tiny_unet(4))),
            "image_encoder": jax_convert.convert_clip_vision(tower)}
        tower_cfg = jax_convert.infer_clip_vision_config(tower)
        dim, tokens = DIM, TOKENS
    else:
        want = jax_ckpt.load_ppt_v2(str(root), dtype=jnp.float32)
        params, tower_cfg = want.params, want.config.image_encoder
        dim, tokens = (want.config.unet.ip_adapter_dim,
                       want.config.unet.ip_adapter_tokens)
    for family in ("unet", "image_encoder"):
        ref = params_from_jax(params[family], family)
        mine = getattr(got, family).state_dict()
        assert set(mine) == set(ref), family
        for k, v in mine.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]),
                                          err_msg=f"{family}.{k}")
    assert (got.config.unet.ip_adapter_dim, got.config.unet.ip_adapter_tokens) == (
        dim, tokens) == (DIM, TOKENS)
    assert got.config.image_encoder.to_dict() == tower_cfg.to_dict()
    image, _ = _image_mask()
    assert _call(got, ip_adapter_image=image).shape == (1, HW, HW, 3)


def test_v2_directory_tower_follows_its_config_json(tmp_path, weights):
    """A tower whose ``config.json`` disagrees with the JAX shape rule, as
    the published ViT-H/14 does (1280 wide, 16 heads of 80, ``gelu``): the
    port builds what the file says, where the JAX loader builds width / 64
    heads and ``quick_gelu`` (ROADMAP Queue C)."""
    sd_np, _, _, _ = weights
    root = tmp_path / "ppt-v2"
    write_v2(root, {f: {k: _t(v) for k, v in sd.items()} for f, sd in sd_np.items()})
    _write_tower(root / "image_encoder",
                 dict(TOWER, num_attention_heads=4, hidden_act="gelu"), 7)
    got = checkpoint.load_ppt_v2(str(root), config=tiny_v2_config(),
                                 dtype=torch.float32, device="cpu")
    tower = got.config.image_encoder
    assert (tower.num_attention_heads, tower.hidden_act) == (4, "gelu")
    assert got.image_encoder.vision_model.encoder.layers[0].self_attn.num_heads == 4
    jax_tower = jax_ckpt.load_ppt_v2(str(root), dtype=jnp.float32).config.image_encoder
    assert (jax_tower.num_attention_heads, jax_tower.hidden_act) == (1, "quick_gelu")
    image, _ = _image_mask()
    assert got._encode_one_ip_image(image).shape == (1, DIM)
    with pytest.raises(ValueError, match="hidden_size 80"):
        convert.infer_clip_vision_config(got.image_encoder.state_dict(),
                                         dict(TOWER, hidden_size=80))
