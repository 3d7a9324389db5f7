"""The port's DPT-hybrid depth network and depth preprocessor against the
JAX package's, in fp32 at the tiny DPT config.

One set of weights: the port's random state with every entry moved by
N(0, 0.05) (zero biases, unit norms and a zero-mean head would leave paths
unexercised), made a JAX tree by the JAX package's ``convert_dpt`` and
carried back to the port by ``params_from_jax``. The depth
map must match within 2e-5 of its largest value, as the JAX package's own
oracle test holds it against HF's torch DPT. The resizes, the position
embedding's resize at a grid the config does not have, the BiT GroupNorm
launch list and the checkpoint-directory loader are held here too.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerpaint_tpu.io.convert import convert_dpt
from powerpaint_tpu.models.dpt import DPTConfig as JaxDPTConfig
from powerpaint_tpu.models.dpt import DPTDepthModel as JaxDPT
from powerpaint_tpu.models.dpt import _resize_align_corners as jax_align_corners
from powerpaint_tpu.tasks import control as jax_control
from powerpaint_tpu_torch.core.config import (
    dpt_config_from_hf_dict,
    dpt_hybrid_midas_config,
)
from powerpaint_tpu_torch.io.weights import (
    load_annotator,
    params_from_jax,
    random_annotator_state,
)
from powerpaint_tpu_torch.models import dpt
from powerpaint_tpu_torch.tasks import control
from powerpaint_tpu_torch.testing import tiny_dpt_config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = tiny_dpt_config()
JAX_CFG = JaxDPTConfig(**CFG.to_dict())


@pytest.fixture(scope="module")
def weights():
    """(JAX tree, port state dict) of one set of tiny DPT weights."""
    rng = np.random.RandomState(0)
    sd = {k: v.numpy() + 0.05 * rng.randn(*v.shape).astype(np.float32)
          for k, v in random_annotator_state(
              "dpt", torch.Generator().manual_seed(0), device="cpu",
              config=CFG).items()}
    tree = convert_dpt(sd)
    return tree, params_from_jax(tree, "dpt", config=CFG)


_jax_dpt = jax.jit(lambda p, x: JaxDPT(JAX_CFG, jnp.float32).apply({"params": p}, x))


def _pixels(h, w, seed=0):
    return np.random.RandomState(seed).rand(1, h, w, 3).astype(np.float32) * 2 - 1


@pytest.mark.parametrize("hw", [(64, 64), (96, 64)], ids=["config grid", "resized grid"])
def test_dpt_matches_jax(weights, hw):
    """At the config's 64 x 64 and at 96 x 64, where the 4 x 4 position
    grid is resized to 6 x 4."""
    tree, sd = weights
    x = _pixels(*hw)
    want = np.asarray(_jax_dpt(tree, jnp.asarray(x)))
    model = load_annotator("dpt", sd, config=CFG, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1,) + hw
    scale = max(np.abs(want).max(), 1e-6)
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-5)


def test_dpt_transposed_conv_resize_matches_jax():
    """A reassembly resize of factor 2 (a transposed conv, which
    hybrid-midas does not have): the port computes the JAX model's map
    under ``params_from_jax``'s weight, which reverses the kernel's taps
    that ``convert_dpt`` leaves as they are (flax's ``ConvTranspose``
    correlates, torch's convolves)."""
    cfg = CFG.replace(reassemble_factors=(1.0, 1.0, 2.0, 0.5))
    rng = np.random.RandomState(2)
    sd = {k: v.numpy() + 0.05 * rng.randn(*v.shape).astype(np.float32)
          for k, v in random_annotator_state(
              "dpt", torch.Generator().manual_seed(2), device="cpu",
              config=cfg).items()}
    tree = convert_dpt(sd, deconv_resize_indices=(2,))
    x = _pixels(64, 64, seed=2)
    want = np.asarray(jax.jit(lambda p, x: JaxDPT(
        JaxDPTConfig(**cfg.to_dict()), jnp.float32).apply({"params": p}, x))(
            tree, jnp.asarray(x)))
    back = params_from_jax(tree, "dpt", config=cfg)
    key = "neck.reassemble_stage.layers.2.resize.weight"
    np.testing.assert_array_equal(back[key], sd[key][:, :, ::-1, ::-1])
    with torch.no_grad():
        got = load_annotator("dpt", back, config=cfg, device="cpu")(
            torch.from_numpy(x)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-5)


def test_dpt_state_round_trips_through_the_jax_converter():
    """The port's names are the ones ``convert_dpt`` reads (HF's): a random
    port state goes to the JAX model's parameter structure and shapes and
    comes back unchanged."""
    tree = jax.eval_shape(JaxDPT(JAX_CFG, jnp.float32).init,
                          jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"]
    sd = {k: v.numpy() for k, v in random_annotator_state(
        "dpt", torch.Generator().manual_seed(1), device="cpu",
        config=CFG).items()}
    back = convert_dpt(sd)

    def shapes(t):
        leaves = jax.tree_util.tree_flatten_with_path(t)[0]
        return {jax.tree_util.keystr(p): np.shape(a) for p, a in leaves}

    got, want = shapes(back), shapes(tree)
    # the one scope the JAX model never creates: the deepest fusion layer's
    # unread residual_layer1
    assert {k for k in got if k not in want} == {
        f"['fusion_0']['residual_layer1']['{c}']['{p}']"
        for c in ("convolution1", "convolution2") for p in ("kernel", "bias")}
    assert {k: got[k] for k in want} == want
    again = params_from_jax(back, "dpt", config=CFG)
    assert set(again) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(again[k], sd[k], err_msg=k)
    for k in ("dpt.embeddings.backbone.bit.embedder.convolution.weight",
              "dpt.encoder.layer.1.attention.output.dense.bias",
              "neck.reassemble_stage.readout_projects.3.0.weight",
              "neck.reassemble_stage.layers.3.resize.weight",
              "neck.fusion_stage.layers.0.residual_layer1.convolution1.weight",
              "dpt.layernorm.weight", "head.head.4.bias"):
        assert k in sd


def test_resize_bicubic_matches_jax_and_torch():
    x = np.random.RandomState(3).rand(2, 17, 23).astype(np.float32)
    got = control.resize_bicubic(torch.from_numpy(x), 40, 64).numpy()
    want = np.asarray(jax_control.resize_bicubic(jnp.asarray(x), 40, 64))
    ref = torch.nn.functional.interpolate(
        torch.from_numpy(x)[:, None], size=(40, 64), mode="bicubic",
        align_corners=False)[:, 0].numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)
    np.testing.assert_allclose(got, ref, atol=2e-6)


@pytest.mark.parametrize("out", [(10, 14), (5, 3), (1, 7)])
def test_resize_align_corners_matches_jax(out):
    x = np.random.RandomState(4).rand(2, 5, 7, 3).astype(np.float32)
    got = dpt.resize_align_corners(torch.from_numpy(x), *out).numpy()
    want = np.asarray(jax.jit(jax_align_corners, static_argnums=(1, 2))(
        jnp.asarray(x), *out))
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((4, 4), (8, 8)), ((4, 4), (6, 4)),
                                     ((24, 24), (9, 13)), ((12, 10), (7, 5))])
def test_resize_bilinear_matches_jax_image_resize(src, dst):
    """The position-embedding and fusion-residual resize, growing and
    shrinking (``jax.image.resize`` antialiases when it shrinks)."""
    x = np.random.RandomState(5).randn(1, *src, 6).astype(np.float32)
    got = dpt.resize_bilinear(torch.from_numpy(x), *dst).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, *dst, 6), "bilinear"))
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_same_pad_is_tensorflow_same():
    """Odd and even sizes at stride 2: the pad lax's "SAME" takes."""
    for n, k in ((8, 7), (9, 7), (8, 3), (9, 3), (8, 1)):
        x = torch.zeros(1, 1, n, n)
        y = dpt.same_pad(x, k, 2)
        total = max((-(-n // 2) - 1) * 2 + k - n, 0)
        assert y.shape[-1] == n + total
        pads = jax.lax.padtype_to_pads((n,), (k,), (2,), "SAME")[0]
        assert (y.shape[-1] - n) == sum(pads)


def test_groupnorm_launches_are_the_config_list(weights, monkeypatch):
    """Each BiT GroupNorm is one ``ops.norms.group_norm`` call in fp32 at
    eps 1e-5 without SiLU, at the (S, C) ``gn_shapes`` lists, in order."""
    from powerpaint_tpu_torch.models import layers

    _, sd = weights
    seen = []
    real = layers.group_norm

    def record(x, gamma, beta, *, num_groups, eps, silu):
        seen.append((x.numel() // (x.shape[0] * x.shape[-1]), x.shape[-1],
                     x.dtype, num_groups, eps, silu))
        return real(x, gamma, beta, num_groups=num_groups, eps=eps, silu=silu)

    monkeypatch.setattr(layers, "group_norm", record)
    model = load_annotator("dpt", sd, config=CFG, device="cpu")
    for h, w in ((64, 64), (80, 48)):
        seen.clear()
        with torch.no_grad():
            model(torch.from_numpy(_pixels(h, w)))
        assert [s[:2] for s in seen] == dpt.gn_shapes(CFG, h, w)
        assert {s[2:] for s in seen} == {(torch.float32, 2, 1e-5, False)}
    full = dpt.gn_shapes(dpt_hybrid_midas_config(), 384, 384)
    assert len(full) == 52 and full[0] == (192 * 192, 64)


def test_depth_preprocessor_matches_jax(weights):
    tree, sd = weights
    img = (np.random.RandomState(0).rand(48, 40, 3) * 255).astype(np.uint8)
    want = jax_control.DPTDepthPreprocessor(
        params=tree, config=JAX_CFG, output_size=(48, 40))(img)
    got = control.DPTDepthPreprocessor(state=sd, config=CFG,
                                       output_size=(48, 40), device="cpu")(img)
    assert got.shape == want.shape == (48, 40, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert got.min() == 0 and got.max() == 255


def test_depth_preprocessor_loads_a_checkpoint_directory(weights, tmp_path):
    """config.json (HF names, HF defaults for what it leaves out) and a
    torch weights file, as Intel/dpt-hybrid-midas ships them."""
    _, sd = weights
    bit = dict(embedding_size=8, hidden_sizes=[8, 16, 32], depths=[1, 1, 1],
               num_groups=2)
    cfg_json = dict(is_hybrid=True, backbone_config=bit, hidden_size=32,
                    num_hidden_layers=2, num_attention_heads=2,
                    intermediate_size=64, image_size=64,
                    backbone_out_indices=[0, 1, 0, 1],
                    neck_hidden_sizes=[8, 16, 32, 32],
                    reassemble_factors=[1, 1, 1, 0.5], fusion_hidden_size=16)
    (tmp_path / "config.json").write_text(json.dumps(cfg_json))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "pytorch_model.bin")
    img = (np.random.RandomState(1).rand(32, 32, 3) * 255).astype(np.uint8)
    from_dir = control.DPTDepthPreprocessor(checkpoint=str(tmp_path),
                                            output_size=(32, 32), device="cpu")
    assert from_dir.config == CFG
    direct = control.DPTDepthPreprocessor(state=sd, config=CFG,
                                          output_size=(32, 32), device="cpu")
    np.testing.assert_array_equal(from_dir(img), direct(img))
    assert dpt_config_from_hf_dict(dict(
        is_hybrid=True, neck_hidden_sizes=[256, 512, 768, 768],
        reassemble_factors=[1, 1, 1, 0.5])) == dpt_hybrid_midas_config()
