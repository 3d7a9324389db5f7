"""The port's checkpoint I/O (``powerpaint_tpu_torch.io.safetensors``,
``io.convert``, ``io.checkpoint``) against the JAX package's loaders.

Synthetic files in the published layouts are written from the port's
random tiny weights: a ppt-v1 directory, the ppt-v2 two-directory layout
(its task text encoder a ``.bin``) and its flat form, and an original-SD
single file (the UNet's keys by ``tests/test_single_file.py``'s
``diffusers_unet_to_ldm``, the VAE's by this file's inverse of the LDM
map). Each loader's state dicts must be ``array_equal`` to
``params_from_jax`` of the JAX loader's tree (fp32); no JAX pipeline is
called.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerpaint_tpu.core import safety as jax_safety
from powerpaint_tpu.io import checkpoint as jax_ckpt
from powerpaint_tpu.io import convert as jax_convert
from powerpaint_tpu.testing import tiny_v1_config as jax_tiny_v1_config
from powerpaint_tpu_torch import controller
from powerpaint_tpu_torch.core import safety
from powerpaint_tpu_torch.core.config import ppt_v1_config
from powerpaint_tpu_torch.io import checkpoint, convert
from powerpaint_tpu_torch.io import safetensors as port_st
from powerpaint_tpu_torch.io.weights import (
    build_models,
    init_state,
    load_annotator,
    params_from_jax,
    random_annotator_state,
    random_state,
)
from powerpaint_tpu_torch.models.clip_text import CLIPTextModel
from powerpaint_tpu_torch.pipelines.brushnet import BrushNetPipeline
from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline
from powerpaint_tpu_torch.testing import (
    tiny_asymmetric_vae,
    tiny_clip_vision_config,
    tiny_v1_config,
    tiny_v2_config,
)
from powerpaint_tpu_torch.text.tokenizer import (
    HashTokenizer,
    TokenizerWrapper,
    add_task_tokens,
)
from test_single_file import diffusers_unet_to_ldm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the safetensors format
# ---------------------------------------------------------------------------

DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int8,
          torch.uint8, torch.int32, torch.int64]


def _tensors(dtype):
    g = torch.Generator().manual_seed(3)
    out = {}
    for name, shape in (("b.matrix", (5, 7)), ("a.vector", (3,)),
                        ("scalar", ()), ("empty", (0, 4)), ("cube", (2, 3, 4))):
        x = torch.randn(shape, generator=g) * 50
        out[name] = x.to(dtype) if dtype.is_floating_point else x.round().clamp(
            -128 if dtype != torch.uint8 else 0, 127).to(dtype)
    return out


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k].reshape(-1).view(torch.uint8),
                           b[k].reshape(-1).view(torch.uint8)), k


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_safetensors_is_the_packages_format(tmp_path, dtype):
    """Each dtype both ways: the port's file read by the package (numpy,
    or torch for bf16, which numpy lacks) and the package's file, with its
    ``__metadata__``, read by the port, bit for bit."""
    from safetensors.numpy import load_file as np_load
    from safetensors.torch import load_file as torch_load
    from safetensors.torch import save_file as torch_save

    t = _tensors(dtype)
    ours, theirs = str(tmp_path / "ours.safetensors"), str(tmp_path / "t.safetensors")
    port_st.save_file(t, ours)
    _equal(torch_load(ours), t)
    if dtype != torch.bfloat16:
        got = np_load(ours)
        for k, v in t.items():
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
            assert got[k].dtype == v.numpy().dtype
    torch_save(t, theirs, metadata={"format": "pt"})
    _equal(port_st.load_file(theirs), t)


def test_safetensors_refuses_a_bad_file(tmp_path):
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(b"\x01\x00")
    with pytest.raises(ValueError, match="not a safetensors file"):
        port_st.load_file(str(bad))
    with pytest.raises(ValueError, match="dtype"):
        port_st.save_file({"x": torch.zeros(2, dtype=torch.complex64)},
                          str(tmp_path / "c.safetensors"))


# ---------------------------------------------------------------------------
# synthetic checkpoints in the published layouts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def v1_state():
    return init_state(tiny_v1_config(), torch.Generator().manual_seed(0),
                      device="cpu")


@pytest.fixture(scope="module")
def v2_state():
    return init_state(tiny_v2_config(), torch.Generator().manual_seed(1),
                      device="cpu")


def _save(path, sd):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    port_st.save_file(sd, str(path))


def _with_position_ids(sd):
    """A transformers CLIP state dict carries its ``position_ids`` buffer."""
    return {**sd, "text_model.embeddings.position_ids": torch.arange(77)[None]}


def write_v1(root, state):
    """The reference's ppt-v1 layout; the UNet in fp16."""
    _save(root / "unet" / "diffusion_pytorch_model.safetensors",
          {k: v.half() for k, v in state["unet"].items()})
    _save(root / "text_encoder" / "model.safetensors",
          _with_position_ids(state["text_encoder"]))
    _save(root / "vae" / "diffusion_pytorch_model.safetensors", state["vae"])


def write_v2(root, state, flat=False):
    """The ppt-v2 two-directory layout (or its flat form); the task text
    encoder a ``torch.save`` pickle, as the reference ships it."""
    base = root if flat else root / "realisticVisionV60B1_v51VAE"
    _save(base / "unet" / "diffusion_pytorch_model.safetensors", state["unet"])
    _save(base / "vae" / "diffusion_pytorch_model.safetensors",
          {k: v.half() for k, v in state["vae"].items()})
    _save(base / "text_encoder" / "model.safetensors",
          _with_position_ids(state["text_encoder"]))
    bn = root / "PowerPaint_Brushnet"
    _save(bn / "diffusion_pytorch_model.safetensors", state["brushnet"])
    torch.save(_with_position_ids(state["text_encoder_brushnet"]),
               bn / "pytorch_model.bin")


def diffusers_vae_to_ldm(sd):
    """Test-side inverse of ``ldm_vae_to_diffusers``: diffusers
    AutoencoderKL keys -> LDM ``first_stage_model`` keys."""
    n_up = 1 + max(int(k.split(".")[2]) for k in sd
                   if k.startswith("decoder.up_blocks."))
    attn = {"to_q": "q", "to_k": "k", "to_v": "v", "to_out": "proj_out",
            "group_norm": "norm"}
    out = {}
    for k, v in sd.items():
        p = k.split(".")
        side = p[0]
        if side in ("quant_conv", "post_quant_conv") or p[1] in ("conv_in",
                                                                 "conv_out"):
            out[k] = v
        elif p[1] == "conv_norm_out":
            out[f"{side}.norm_out.{p[2]}"] = v
        elif p[1] in ("down_blocks", "up_blocks"):
            lvl = int(p[2]) if p[1] == "down_blocks" else n_up - 1 - int(p[2])
            blk = f"{side}.{'down' if p[1] == 'down_blocks' else 'up'}.{lvl}"
            if p[3] == "resnets":
                sub = ".".join(p[5:]).replace("conv_shortcut", "nin_shortcut")
                out[f"{blk}.block.{p[4]}.{sub}"] = v
            else:  # downsamplers.0.conv / upsamplers.0.conv
                kind = "downsample" if p[3] == "downsamplers" else "upsample"
                out[f"{blk}.{kind}.{'.'.join(p[5:])}"] = v
        elif p[2] == "resnets":
            out[f"{side}.mid.block_{int(p[3]) + 1}.{'.'.join(p[4:])}"] = v
        else:  # mid_block.attentions.0.<proj>[.0].<param>
            name = attn[p[4]]
            if name in ("q", "k", "v", "proj_out") and p[-1] == "weight":
                v = v[:, :, None, None]
            out[f"{side}.mid.attn_1.{name}.{p[-1]}"] = v
    assert len(out) == len(sd)
    return out


def _plain_text_state(cfg, seed=2):
    with torch.device("meta"):
        model = CLIPTextModel(cfg.text_encoder.replace(num_external_tokens=0))
    return random_state(model, torch.Generator().manual_seed(seed), device="cpu")


def single_file_state(cfg, unet_sd, vae_sd, text_sd):
    sd = {"model.diffusion_model." + k: v
          for k, v in diffusers_unet_to_ldm(unet_sd, cfg.unet).items()}
    sd.update({"first_stage_model." + k: v
               for k, v in diffusers_vae_to_ldm(vae_sd).items()})
    sd.update({"cond_stage_model.transformer." + k: v
               for k, v in _with_position_ids(text_sd).items()})
    return sd


# ---------------------------------------------------------------------------
# the loaders against the JAX loaders
# ---------------------------------------------------------------------------


def _assert_loaded(pipe, jax_params, families, tokenizer=None):
    """Every family's state dict ``array_equal`` to ``params_from_jax`` of
    the JAX loader's tree."""
    for family in families:
        want = params_from_jax(jax_params[family], family, tokenizer=tokenizer)
        got = getattr(pipe, family).state_dict()
        assert set(got) == set(want), (family, set(got) ^ set(want))
        for k, v in got.items():
            assert v.dtype == torch.float32, (family, k)
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k], np.float32),
                                          err_msg=f"{family}.{k}")


def _image(pipe):
    rng = np.random.RandomState(0)
    image = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
    mask = np.zeros((64, 64), np.float32)
    mask[16:48, 16:48] = 1.0
    return pipe(image, mask, prompt="a dog", num_inference_steps=2, seed=1)


def test_v1_directory_matches_jax_and_the_in_memory_pipeline(tmp_path, v1_state):
    root = tmp_path / "ppt-v1"
    write_v1(root, v1_state)
    got = checkpoint.load_ppt_v1(str(root), config=tiny_v1_config(),
                                 dtype=torch.float32, device="cpu")
    want = jax_ckpt.load_ppt_v1(str(root), config=jax_tiny_v1_config(),
                                dtype=jnp.float32)
    _assert_loaded(got, want.params, ("unet", "vae", "text_encoder"))
    assert got.config.text_encoder == tiny_v1_config().text_encoder
    prompt = "a P_obj on P_shape"
    np.testing.assert_array_equal(got.tokenizer(prompt), want.tokenizer(prompt))
    # the image is that of the pipeline built from the state as written
    written = {f: dict(sd) for f, sd in v1_state.items()}
    written["unet"] = {k: v.half() for k, v in written["unet"].items()}
    tok = TokenizerWrapper(HashTokenizer(1024))
    add_task_tokens(tok)
    ref = InpaintPipeline(tiny_v1_config(), written, tok, dtype=torch.float32,
                          device="cpu")
    np.testing.assert_array_equal(_image(got), _image(ref))


@pytest.mark.parametrize("flat", [False, True], ids=["two-directory", "flat"])
def test_v2_layout_matches_jax(tmp_path, v2_state, flat):
    root = tmp_path / "ppt-v2"
    write_v2(root, v2_state, flat=flat)
    got = checkpoint.load_ppt_v2(str(root), config=tiny_v2_config(),
                                 dtype=torch.float32, device="cpu")
    want = jax_ckpt.load_ppt_v2(str(root), dtype=jnp.float32)
    _assert_loaded(got, want.params, ("unet", "vae", "text_encoder", "brushnet",
                                      "text_encoder_brushnet"))
    # the task rows, and so the task tokens, are the BrushNet tower's
    assert (got.config.text_encoder.vocab_size,
            got.config.text_encoder.num_external_tokens) == (
        want.config.text_encoder.vocab_size,
        want.config.text_encoder.num_external_tokens) == (1024, 30)
    np.testing.assert_array_equal(got.tokenizer("P_ctxt a vase"),
                                  want.tokenizer("P_ctxt a vase"))
    if not flat:
        tok = TokenizerWrapper(HashTokenizer(1024))
        add_task_tokens(tok)
        written = {f: dict(sd) for f, sd in v2_state.items()}
        written["vae"] = {k: v.half() for k, v in written["vae"].items()}
        ref = BrushNetPipeline(tiny_v2_config(), written, tok,
                               dtype=torch.float32, device="cpu")
        np.testing.assert_array_equal(_image(got), _image(ref))


def test_single_file_matches_jax(tmp_path, v1_state):
    cfg = tiny_v1_config()
    text = _plain_text_state(cfg)
    path = tmp_path / "sd-inpainting.safetensors"
    port_st.save_file(single_file_state(cfg, v1_state["unet"], v1_state["vae"],
                                        text), str(path))
    got = checkpoint.load_single_file(str(path), config=cfg,
                                      dtype=torch.float32, device="cpu")
    want = jax_ckpt.load_single_file(str(path), config=jax_tiny_v1_config(),
                                     dtype=jnp.float32)
    _assert_loaded(got, want.params, ("unet", "vae", "text_encoder"))
    # the maps give back the names and values the file was made from
    for family, sd in (("unet", v1_state["unet"]), ("vae", v1_state["vae"]),
                       ("text_encoder", text)):
        mine = getattr(got, family).state_dict()
        assert set(mine) == set(sd)
        for k, v in sd.items():
            assert torch.equal(mine[k], v), (family, k)
    # no task rows in a single file: a plain tower, no task tokens
    assert got.config.text_encoder.num_external_tokens == 0
    assert got.tokenizer.num_external_tokens == 0


def test_single_file_takes_a_4_channel_unet(tmp_path, v2_state):
    cfg = tiny_v1_config()
    path = tmp_path / "sd15.safetensors"
    port_st.save_file(single_file_state(cfg, v2_state["unet"], v2_state["vae"],
                                        _plain_text_state(cfg)), str(path))
    got = checkpoint.load_single_file(str(path), config=cfg,
                                      dtype=torch.float32, device="cpu")
    want = jax_ckpt.load_single_file(str(path), config=jax_tiny_v1_config(),
                                     dtype=jnp.float32)
    assert got.config.unet.in_channels == want.config.unet.in_channels == 4
    _assert_loaded(got, want.params, ("unet",))


def test_single_file_maps_at_full_width():
    """The LDM maps at ppt-v1's full width, names and shapes only (meta
    tensors): the port's equal the JAX package's, and give back the port's
    own names."""
    cfg = ppt_v1_config()
    models = build_models(cfg)
    unet = {k: v for k, v in models["unet"].state_dict().items()}
    vae = {k: v for k, v in models["vae"].state_dict().items()}
    ldm_unet = diffusers_unet_to_ldm(unet, cfg.unet)
    ldm_vae = diffusers_vae_to_ldm(vae)
    for ours, theirs, ldm, want in (
            (convert.ldm_unet_to_diffusers, jax_convert.ldm_unet_to_diffusers,
             ldm_unet, unet),
            (convert.ldm_vae_to_diffusers, jax_convert.ldm_vae_to_diffusers,
             ldm_vae, vae)):
        got = {k: tuple(v.shape) for k, v in ours(ldm).items()}
        assert got == {k: tuple(v.shape) for k, v in theirs(ldm).items()}
        assert got == {k: tuple(v.shape) for k, v in want.items()}
    assert len(ldm_unet) == len(unet) and len(ldm_vae) == len(vae)


# ---------------------------------------------------------------------------
# the safety checker, missing parts, what the port refuses
# ---------------------------------------------------------------------------


def test_safety_checker_is_registered_from_the_directory(tmp_path, v1_state):
    """A ``safety_checker/`` directory with weights registers the CLIP
    checker (ppt-v1's default), with the JAX loader's weights; without one
    nothing registers; a registered checker is never replaced."""
    root = tmp_path / "ppt-v1"
    write_v1(root, v1_state)
    sd = random_annotator_state("safety_checker", torch.Generator().manual_seed(4),
                                device="cpu", config=tiny_clip_vision_config())
    sd["concept_embeds_weights"] = torch.full((17,), -2.0)
    safety.register_safety_checker(None)
    jax_safety.register_safety_checker(None)
    try:
        checkpoint.load_ppt_v1(str(root), config=tiny_v1_config(),
                               dtype=torch.float32, device="cpu")
        assert safety.get_safety_checker() is None
        _save(root / "safety_checker" / "model.safetensors", sd)
        checkpoint.load_ppt_v1(str(root), config=tiny_v1_config(),
                               dtype=torch.float32, device="cpu")
        checker = safety.get_safety_checker()
        jax_ckpt.load_ppt_v1(str(root), config=jax_tiny_v1_config(),
                             dtype=jnp.float32)
        want = params_from_jax(jax_safety.get_safety_checker().params,
                               "safety_checker")
        got = checker.model.state_dict()
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        assert checker.config.num_attention_heads == \
            jax_safety.get_safety_checker().config.num_attention_heads
        images = (np.random.RandomState(0).rand(2, 40, 40, 3) * 255).astype(np.uint8)
        out, flags = safety.apply_safety_checker(images)
        assert flags == [True, True] and not out.any()
        checkpoint.load_ppt_v1(str(root), config=tiny_v1_config(),
                               dtype=torch.float32, device="cpu")
        assert safety.get_safety_checker() is checker
    finally:
        safety.register_safety_checker(None)
        jax_safety.register_safety_checker(None)


def _errors(fn_port, fn_jax, exc):
    with pytest.raises(exc) as a:
        fn_port()
    with pytest.raises(exc) as b:
        fn_jax()
    return str(a.value), str(b.value)


@pytest.mark.parametrize("drop", ["unet", "text_encoder", "vae"])
def test_v1_missing_parts_are_named_as_jax(tmp_path, v1_state, drop):
    root = tmp_path / "ppt-v1"
    write_v1(root, v1_state)
    for f in (root / drop).iterdir():
        f.unlink()
    ours, theirs = _errors(
        lambda: checkpoint.load_ppt_v1(str(root), device="cpu"),
        lambda: jax_ckpt.load_ppt_v1(str(root)), FileNotFoundError)
    assert ours == theirs and f"'{drop}'" in ours


@pytest.mark.parametrize("drop", [
    "realisticVisionV60B1_v51VAE/unet", "realisticVisionV60B1_v51VAE/vae",
    "realisticVisionV60B1_v51VAE/text_encoder",
    "PowerPaint_Brushnet/diffusion_pytorch_model.safetensors",
    "PowerPaint_Brushnet/pytorch_model.bin"])
def test_v2_missing_parts_are_named_as_jax(tmp_path, v2_state, drop):
    root = tmp_path / "ppt-v2"
    write_v2(root, v2_state)
    target = root / drop
    for f in (target.iterdir() if target.is_dir() else [target]):
        f.unlink()
    ours, theirs = _errors(
        lambda: checkpoint.load_ppt_v2(str(root), device="cpu"),
        lambda: jax_ckpt.load_ppt_v2(str(root)), FileNotFoundError)
    assert ours == theirs and "missing weights for" in ours


def test_single_file_missing_components_are_named_as_jax(tmp_path, v1_state):
    path = tmp_path / "unet-only.safetensors"
    port_st.save_file({"model.diffusion_model." + k: v for k, v in
                       diffusers_unet_to_ldm(v1_state["unet"],
                                             tiny_v1_config().unet).items()},
                      str(path))
    ours, theirs = _errors(
        lambda: checkpoint.load_single_file(str(path), device="cpu"),
        lambda: jax_ckpt.load_single_file(str(path)), FileNotFoundError)
    assert ours == theirs and "['text_encoder', 'vae']" in ours


def test_asymmetric_vae_is_refused(tmp_path, v1_state, v2_state):
    """ppt-v2 refuses an asymmetric VAE (only the v1 pipeline decodes with
    one, as in the JAX package); ppt-v1 loads it into its conditional
    decode (held to the JAX loader in ``test_torch_vae_extras.py``)."""
    asym = init_state(tiny_v1_config().replace(vae=tiny_asymmetric_vae()),
                      torch.Generator().manual_seed(5), device="cpu")["vae"]
    root = tmp_path / "ppt-v2"
    write_v2(root, v2_state, flat=True)
    _save(root / "vae" / "diffusion_pytorch_model.safetensors", asym)
    with pytest.raises(NotImplementedError, match="ppt-v1 only"):
        checkpoint.load_ppt_v2(str(root), config=tiny_v2_config(), device="cpu")
    root = tmp_path / "ppt-v1"
    write_v1(root, v1_state)
    _save(root / "vae" / "diffusion_pytorch_model.safetensors", asym)
    pipe = checkpoint.load_ppt_v1(str(root), config=tiny_v1_config(),
                                  dtype=torch.float32, device="cpu")
    want = tiny_asymmetric_vae()
    got = pipe.config.vae
    assert got.asymmetric and got.condition_layers == want.condition_layers
    assert (got.up_channels, got.up_layers) == (want.up_channels, want.up_layers)
    assert _image(pipe).shape == (1, 64, 64, 3)


@pytest.mark.parametrize("extra", ["ip_adapter.safetensors",
                                   "image_encoder/model.safetensors"])
def test_ip_adapter_files_are_refused(tmp_path, v2_state, extra):
    """The loader reads adapter files (``test_torch_ip_adapter.py``); one
    that holds no adapter is refused, naming what it lacks: a projection of
    4 rows is no whole number of tokens, a tower has no patch embedding."""
    root = tmp_path / "ppt-v2"
    write_v2(root, v2_state)
    _save(root / extra, {"proj.weight": torch.zeros(4, 8)})
    err = ((ValueError, "no whole number") if extra.startswith("ip_adapter")
           else (KeyError, "patch_embedding"))
    with pytest.raises(err[0], match=err[1]):
        checkpoint.load_ppt_v2(str(root), config=tiny_v2_config(), device="cpu")


@pytest.mark.parametrize("version", ["ppt-v1", "ppt-v2"])
def test_native_directory_is_refused(tmp_path, version):
    (tmp_path / "params").mkdir()
    (tmp_path / "config.json").write_text("{}")
    load = checkpoint.load_ppt_v1 if version == "ppt-v1" else checkpoint.load_ppt_v2
    with pytest.raises(NotImplementedError,
                       match="orbax and tensorstore are not on the card's host"):
        load(str(tmp_path), device="cpu")


def test_annotator_checkpoint_loads_without_the_safetensors_package(
        tmp_path, monkeypatch):
    """``load_annotator(checkpoint=...)`` reads a ``.safetensors`` file
    with the port's reader: the GPU host has no ``safetensors`` package."""
    cfg = tiny_clip_vision_config()
    sd = random_annotator_state("safety_checker", torch.Generator().manual_seed(5),
                                device="cpu", config=cfg)
    path = tmp_path / "checker.safetensors"
    port_st.save_file(sd, str(path))
    for name in [m for m in sys.modules if m.split(".")[0] == "safetensors"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "safetensors", None)
    with pytest.raises(ImportError):
        import safetensors  # noqa: F401
    model = load_annotator("safety_checker", checkpoint=str(path), config=cfg,
                           device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_controller_and_package_load_a_directory(tmp_path, v1_state):
    import powerpaint_tpu_torch

    root = tmp_path / "ppt-v1"
    write_v1(root, v1_state)
    pp = controller.PowerPaint.from_checkpoint(
        str(root), "ppt-v1", dtype=torch.float32, device="cpu",
        config=tiny_v1_config())
    assert isinstance(pp.pipeline, InpaintPipeline)
    assert pp.pipeline.unet.conv_in.weight.device.type == "cpu"
    with pytest.raises(ValueError, match="version"):
        powerpaint_tpu_torch.load(str(root), "ppt-v3", device="cpu")


# ---------------------------------------------------------------------------
# a diffusers ControlNet directory
# ---------------------------------------------------------------------------


def controlnet_state(seed: int = 4):
    """The tiny ControlNet branch's random weights with random biases and
    norm affines (init_state's are 0 and 1), so a swapped or dropped
    vector shows."""
    from powerpaint_tpu_torch.testing import tiny_v1_controlnet_config

    model = build_models(tiny_v1_controlnet_config())["controlnet"]
    sd = random_state(model, torch.Generator().manual_seed(seed), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    return {k: v + 0.1 * torch.randn(v.shape, generator=g) if v.ndim == 1 else v
            for k, v in sd.items()}


def write_controlnet(root, sd, cn_config, fmt="safetensors"):
    """A diffusers ControlNet directory: ``config.json`` with the UNet's
    keys flat beside the conditioning embedding's (diffusers'
    ``ControlNetModel`` form), and the weights, fp16 in safetensors or fp32
    in a ``.bin`` pickle."""
    import dataclasses
    import json

    os.makedirs(root, exist_ok=True)
    config = {"_class_name": "ControlNetModel", "_diffusers_version": "0.27.2",
              **dataclasses.asdict(cn_config.base),
              "in_channels": 4, "class_embed_type": None,
              "conditioning_channels": cn_config.conditioning_channels,
              "conditioning_embedding_out_channels":
                  list(cn_config.conditioning_embedding_out_channels),
              "controlnet_conditioning_channel_order": "rgb"}
    (root / "config.json").write_text(json.dumps(config))
    if fmt == "safetensors":
        _save(root / "diffusion_pytorch_model.safetensors",
              {k: v.half() for k, v in sd.items()})
    else:
        torch.save(sd, root / "diffusion_pytorch_model.bin")


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_controlnet_directory_matches_jax(tmp_path, fmt):
    """``load_controlnet``'s branch is bitwise ``params_from_jax`` of the
    JAX package's ``convert_controlnet`` tree of the file's tensors (cast
    to fp32 as ``_load`` casts them), its config the tiny branch's."""
    from powerpaint_tpu_torch.io.convert import load_state_dict
    from powerpaint_tpu_torch.testing import tiny_v1_controlnet_config

    cn_cfg = tiny_v1_controlnet_config().controlnet
    root = tmp_path / "controlnet"
    write_controlnet(root, controlnet_state(), cn_cfg, fmt)
    model = checkpoint.load_controlnet(str(root), dtype=torch.float32,
                                       device="cpu")
    assert model.config == cn_cfg.replace(
        base=cn_cfg.base.replace(in_channels=4))
    stored = load_state_dict(str(next(root.glob("diffusion_pytorch_model.*"))))
    tree = jax_convert.convert_controlnet(
        {k: v.float().numpy() for k, v in stored.items()})
    want = params_from_jax(tree, "controlnet")
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert v.dtype == torch.float32, k
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_controlnet_directory_missing_parts(tmp_path):
    from powerpaint_tpu_torch.testing import tiny_v1_controlnet_config

    root = tmp_path / "controlnet"
    write_controlnet(root, controlnet_state(),
                     tiny_v1_controlnet_config().controlnet)
    (root / "config.json").unlink()
    with pytest.raises(FileNotFoundError, match="missing config.json"):
        checkpoint.load_controlnet(str(root), device="cpu")
    (root / "diffusion_pytorch_model.safetensors").unlink()
    with pytest.raises(FileNotFoundError,
                       match=r"missing weights for: \['controlnet'\]"):
        checkpoint.load_controlnet(str(root), device="cpu")


def test_controller_builds_the_controlnet_pipeline(tmp_path, v1_state):
    """``from_checkpoint(controlnet_dir=...)``: the ControlNet pipeline
    shares the loaded ppt-v1 models, and its image is bitwise that of a
    ControlNet pipeline built from the same weights in memory; ppt-v2 is
    refused."""
    from powerpaint_tpu_torch.pipelines.controlnet import ControlNetPipeline
    from powerpaint_tpu_torch.testing import tiny_v1_controlnet_config

    root, cn_root = tmp_path / "ppt-v1", tmp_path / "controlnet"
    write_v1(root, v1_state)
    cfg = tiny_v1_controlnet_config()
    cn_sd = controlnet_state()
    write_controlnet(cn_root, cn_sd, cfg.controlnet)
    pp = controller.PowerPaint.from_checkpoint(
        str(root), "ppt-v1", dtype=torch.float32, device="cpu",
        config=tiny_v1_config(), controlnet_dir=str(cn_root))
    cn = pp.controlnet_pipeline
    assert isinstance(cn, ControlNetPipeline) and cn.unet is pp.pipeline.unet
    state = {f: dict(v1_state[f]) for f in ("vae", "text_encoder")}
    state["unet"] = {k: v.half().float() for k, v in v1_state["unet"].items()}
    state["controlnet"] = {k: v.half().float() for k, v in cn_sd.items()}
    want_pipe = ControlNetPipeline(cfg, state, pp.pipeline.tokenizer,
                                   dtype=torch.float32, device="cpu")
    rng = np.random.RandomState(2)
    image = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
    mask = np.zeros((64, 64), np.float32)
    mask[16:48, 16:48] = 1.0
    edges = (np.indices((64, 64)).sum(0) % 9 == 0)[..., None].repeat(3, -1)
    edges = edges.astype(np.uint8) * 255
    kw = dict(prompt="a vase", num_inference_steps=2, seed=1)
    np.testing.assert_array_equal(cn(image, mask, edges, **kw),
                                  want_pipe(image, mask, edges, **kw))
    with pytest.raises(ValueError, match="controlnet_dir needs version"):
        controller.PowerPaint.from_checkpoint(
            str(root), "ppt-v2", device="cpu", controlnet_dir=str(cn_root))
