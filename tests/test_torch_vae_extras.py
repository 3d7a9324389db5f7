"""The port's VAE extras against the JAX package's, in fp32 at tiny sizes:
the asymmetric VAE's conditional decode (a decoder as wide as its encoder,
and one wider and deeper), its loader, ``decode_tiled``, FreeU's filter,
and one ppt-v1 pipeline call that decodes with the asymmetric VAE under encoder
propagation (``encoder_cache_interval=2``).

One set of weights (the port's random init with every bias and norm
parameter made random too) goes to the JAX models through the JAX
package's converter and back to the port through ``params_from_jax``; the
same numpy inputs go through both.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerpaint_tpu.io import checkpoint as jax_ckpt
from powerpaint_tpu.io.convert import convert_clip_text, convert_unet, convert_vae
from powerpaint_tpu.models.vae import AutoencoderKL as JaxVAE
from powerpaint_tpu.models.vae import decode_tiled as jax_decode_tiled
from powerpaint_tpu.ops import freeu as jax_freeu
from powerpaint_tpu.pipelines.inpaint import InpaintPipeline as JaxPipeline
from powerpaint_tpu.testing import tiny_v1_config as jax_tiny_v1_config
from powerpaint_tpu_torch.core.config import VAEConfig as PortVAEConfig
from powerpaint_tpu_torch.io import checkpoint
from powerpaint_tpu_torch.io.convert import infer_vae_decoder_config
from powerpaint_tpu_torch.io.weights import init_state, load_models, params_from_jax
from powerpaint_tpu_torch.models.vae import decode_tiled
from powerpaint_tpu_torch.ops import freeu
from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline
from powerpaint_tpu_torch.testing import (
    tiny_asymmetric_vae,
    tiny_v1_config,
    tiny_wide_asymmetric_vae,
)
from powerpaint_tpu_torch.text.prompts import add_task
from powerpaint_tpu_torch.text.tokenizer import (
    HashTokenizer,
    TokenizerWrapper,
    add_task_tokens,
)
from test_torch_checkpoint import _save, write_v1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32 = jnp.float32
CONVERT = {"unet": convert_unet, "vae": convert_vae,
           "text_encoder": convert_clip_text}
VAES = {"asymmetric": tiny_asymmetric_vae, "wide": tiny_wide_asymmetric_vae}


def _jax_vae_config(port_cfg: PortVAEConfig):
    """The JAX package's VAEConfig of the same fields."""
    return jax_tiny_v1_config().vae.replace(**{
        k: getattr(port_cfg, k) for k in (
            "block_out_channels", "layers_per_block", "norm_num_groups",
            "asymmetric", "up_block_out_channels", "layers_per_up_block",
            "condition_layers")})


def _weights(config, seed=0):
    """Numpy state dicts of every family of ``config`` with random biases
    and norm affines, the JAX trees of them, and the port's models loaded
    from ``params_from_jax`` of those trees."""
    state = init_state(config, torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.RandomState(seed)
    sd_np = {}
    for family, sd in state.items():
        sd_np[family] = {k: v.numpy() for k, v in sd.items()}
        for k, v in sd_np[family].items():
            if v.ndim == 1:
                sd_np[family][k] = (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
    trees = {f: CONVERT[f](sd) for f, sd in sd_np.items()}
    port_state = {f: params_from_jax(t, f) for f, t in trees.items()}
    models = load_models(config, port_state, device="cpu", dtype=torch.float32)
    return sd_np, trees, models


@pytest.fixture(scope="module")
def vaes():
    """{name: (JAX tree, port VAE)} of both asymmetric VAEs and the plain
    tiny one."""
    out = {}
    for name, make in [("plain", lambda: tiny_v1_config().vae)] + list(VAES.items()):
        _, trees, models = _weights(tiny_v1_config().replace(vae=make()))
        out[name] = (trees["vae"], models["vae"])
    return out


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _masks(hw):
    half = np.ones((1, hw, hw, 1), np.float32)
    half[:, :, : hw // 2] = 0.0  # the left half is known
    return {"half": half, "all_hole": np.ones((1, hw, hw, 1), np.float32)}


# ---------------------------------------------------------------------------
# the asymmetric VAE
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_decode_with_condition(name):
    """The JAX decode of one VAE, compiled once: both masks share its
    shapes."""
    jvae = JaxVAE(_jax_vae_config(VAES[name]()), dtype=F32)
    return jax.jit(lambda p, *a: jvae.apply(p, *a, method="decode_with_condition"))


@pytest.mark.parametrize("mask", ["half", "all_hole"])
@pytest.mark.parametrize("name", list(VAES))
def test_decode_with_condition_matches_jax(vaes, name, mask):
    tree, vae = vaes[name]
    rng = np.random.RandomState(5)
    z = rng.randn(1, 4, 4, 4).astype(np.float32)
    image = (rng.rand(1, 32, 32, 3) * 2 - 1).astype(np.float32)
    m = _masks(32)[mask]
    want = np.asarray(_jax_decode_with_condition(name)(
        {"params": tree}, z, image, m))
    got = vae.decode_with_condition(_t(z), _t(image), _t(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


def test_condition_tower_names_and_shapes(vaes):
    _, vae = vaes["wide"]
    spec = tiny_wide_asymmetric_vae().condition_layers
    sd = vae.state_dict()
    for i, (k, s, ch) in enumerate(spec):
        w = sd[f"decoder.condition_encoder.layers.{i}.weight"]
        assert w.shape[0] == ch and tuple(w.shape[2:]) == (k, k)
        assert vae.decoder.condition_encoder.layers[i].stride == (s, s)
    assert infer_vae_decoder_config(sd) == {"up_block_out_channels": (24, 24, 48, 48),
                                            "layers_per_up_block": 2}


def test_mask_semantics(vaes):
    """As the JAX package's test_decode_with_condition_semantics: with an
    all-hole mask the image cannot reach the output; with a known half it
    does; a change inside the hole alone changes nothing."""
    _, vae = vaes["asymmetric"]
    g = torch.Generator().manual_seed(2)
    z = torch.randn(1, 4, 4, 4, generator=g)
    img_a = torch.randn(1, 32, 32, 3, generator=g)
    img_b = torch.randn(1, 32, 32, 3, generator=g)
    masks = {k: _t(v) for k, v in _masks(32).items()}

    def dec(img, m):
        return vae.decode_with_condition(z, img, m)

    assert torch.equal(dec(img_a, masks["all_hole"]), dec(img_b, masks["all_hole"]))
    assert not torch.allclose(dec(img_a, masks["half"]), dec(img_b, masks["half"]),
                              atol=1e-4)
    img_a_hole = img_a.clone()
    img_a_hole[:, :, 16:] = 7.0
    assert torch.equal(dec(img_a, masks["half"]), dec(img_a_hole, masks["half"]))


def test_the_wrong_decode_raises(vaes):
    z = torch.zeros(1, 4, 4, 4)
    with pytest.raises(ValueError, match="decode_with_condition"):
        vaes["asymmetric"][1].decode(z)
    with pytest.raises(ValueError, match="asymmetric=True"):
        vaes["plain"][1].decode_with_condition(z, torch.zeros(1, 32, 32, 3),
                                               torch.ones(1, 32, 32, 1))


def test_config_round_trips_the_condition_spec():
    cfg = tiny_wide_asymmetric_vae()
    back = PortVAEConfig.from_json(cfg.to_json())
    assert back == cfg and back.condition_layers == cfg.condition_layers
    assert back.up_channels == (24, 24, 48, 48) and back.up_layers == 2
    assert tiny_v1_config().vae.up_channels == tiny_v1_config().vae.block_out_channels


def test_load_ppt_v1_takes_an_asymmetric_vae(tmp_path):
    """A synthetic diffusers ``vae/`` with a wider decoder and a condition
    tower: the loaded tensors are ``params_from_jax`` of the JAX loader's
    tree, and the config is read from the shapes."""
    cfg = tiny_v1_config().replace(vae=tiny_wide_asymmetric_vae())
    state = init_state(cfg, torch.Generator().manual_seed(3), device="cpu")
    root = tmp_path / "ppt-v1"
    write_v1(root, state)
    _save(root / "vae" / "diffusion_pytorch_model.safetensors",
          {k: v.half() for k, v in state["vae"].items()})
    got = checkpoint.load_ppt_v1(str(root), config=tiny_v1_config(),
                                 dtype=torch.float32, device="cpu")
    want = jax_ckpt.load_ppt_v1(str(root), config=jax_tiny_v1_config(),
                                dtype=F32)
    assert got.config.vae == cfg.vae
    assert want.config.vae.condition_layers == cfg.vae.condition_layers
    sd = got.vae.state_dict()
    ref = params_from_jax(jax.tree.map(np.asarray, want.params["vae"]), "vae")
    assert set(sd) == set(ref)
    for k in sd:
        np.testing.assert_array_equal(sd[k].numpy(), ref[k], err_msg=k)


# ---------------------------------------------------------------------------
# decode_tiled
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(24, 24), (24, 16)], ids=str)
def test_decode_tiled_matches_jax(vaes, hw):
    tree, vae = vaes["plain"]
    z = np.random.RandomState(6).randn(1, *hw, 4).astype(np.float32)
    jvae = JaxVAE(jax_tiny_v1_config().vae, dtype=F32)
    want = np.asarray(jax.jit(lambda p, z: jax_decode_tiled(
        jvae, p, z, tile=16, overlap=8))(tree, z))
    got = decode_tiled(vae, _t(z), tile=16, overlap=8).numpy()
    assert got.shape == (1, hw[0] * 8, hw[1] * 8, 3)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


def test_decode_tiled_short_circuits_to_decode(vaes):
    _, vae = vaes["plain"]
    z = _t(np.random.RandomState(7).randn(1, 16, 12, 4))
    assert torch.equal(decode_tiled(vae, z, tile=16, overlap=8), vae.decode(z))


# ---------------------------------------------------------------------------
# FreeU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 7, 9, 5), (2, 8, 6, 4), (1, 1, 1, 3)],
                         ids=["odd", "even", "one_pixel"])
@pytest.mark.parametrize("threshold,scale", [(1, 0.9), (2, 0.2)])
def test_fourier_filter_matches_jax(shape, threshold, scale):
    x = np.random.RandomState(8).randn(*shape).astype(np.float32)
    want = np.asarray(jax_freeu.fourier_filter(jnp.asarray(x), threshold, scale))
    got = freeu.fourier_filter(_t(x), threshold, scale).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# one ppt-v1 call: the asymmetric decode under encoder propagation
# ---------------------------------------------------------------------------

HW, SEED, FIT, GUIDE = 64, 7, 0.6, 7.5


def _inputs():
    rng = np.random.RandomState(0)
    image = (rng.rand(HW, HW, 3) * 255).astype(np.uint8)
    mask = np.zeros((HW, HW), np.float32)
    mask[13:50, 10:45] = 1.0  # edges off the 8-pixel grid
    return image, mask


def _jax_noise(seed):
    """The JAX v1 pipeline's per-image streams: folds 0, 1, 2 of the
    image's key (the initial latent noise and the two VAE sample noises)."""
    key = jax.random.PRNGKey(seed)
    return [torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(key, f), (HW // 8, HW // 8, 4), F32))[None])
        for f in (0, 1, 2)]


@pytest.fixture(scope="module")
def v1_asymmetric():
    cfg = tiny_v1_config().replace(vae=tiny_asymmetric_vae())
    sd_np, trees, _ = _weights(cfg, seed=4)
    tok = TokenizerWrapper(HashTokenizer(994))
    add_task_tokens(tok)
    jcfg = jax_tiny_v1_config().replace(vae=_jax_vae_config(cfg.vae))
    jax_pipe = JaxPipeline(jcfg, trees, tok, dtype=F32)
    port = InpaintPipeline(cfg, sd_np, tok, dtype=torch.float32, device="cpu")
    return jax_pipe, port


def _port_v1(port, steps, interval, output_type="float32"):
    image, mask = _inputs()
    ids = port.encode_task(add_task("a red bench", "", "text-guided"))[None]
    return port._generate(
        torch.from_numpy(ids).long(), torch.tensor([FIT]),
        torch.from_numpy(image[None]),
        torch.from_numpy((mask >= 0.5).astype(np.uint8)[None, ..., None] * 255),
        torch.tensor([GUIDE]), *_jax_noise(SEED), None, num_steps=steps,
        strength_steps=steps, output_type=output_type,
        encoder_cache_interval=interval).numpy()


def test_v1_asymmetric_decode_with_encoder_cache_matches_jax(v1_asymmetric):
    """Six DDIM steps at interval 2 (key steps 0, 2, 4) and the asymmetric
    decode, against the JAX pipeline's float32 image (one compile). Bound:
    1e-3 absolute, an eighth of a uint8 level (the random weights' image
    reaches about 5); fp32 on both sides, the two frameworks summing in
    different orders over six UNet evaluations and the decode."""
    jax_pipe, port = v1_asymmetric
    image, mask = _inputs()
    want = jax_pipe(image, mask, prompt="a red bench", task="text-guided",
                    fitting_degree=FIT, num_inference_steps=6,
                    guidance_scale=GUIDE, seed=SEED, encoder_cache_interval=2,
                    output_type="float32")
    got = _port_v1(port, 6, 2)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-3)
    exact = _port_v1(port, 6, 1)
    assert np.abs(exact - got).max() > 1e-3  # the cached steps differ
