"""The tiny ppt-v1 pipeline with int8 on against the JAX package's with
``POWERPAINT_INT8=1``, unit by unit along the JAX call's trajectory.

On the CPU the JAX package's int8 path needs two test-side patches: its
accelerator gate (``models.layers._on_tpu``) says yes, and its Pallas
kernel is replaced by the same arithmetic in XLA (interpret mode compiles
too slowly for a pipeline). Nothing in the JAX package changes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import powerpaint_tpu.models.layers as jax_layers
from powerpaint_tpu.io.convert import convert_clip_text, convert_unet, convert_vae
from powerpaint_tpu.ops import conv_pallas
from powerpaint_tpu.pipelines.inpaint import InpaintPipeline as JaxPipeline
from powerpaint_tpu.testing import tiny_v1_config as jax_tiny_v1_config
from powerpaint_tpu_torch.io.weights import init_state
from powerpaint_tpu_torch.models.layers import Conv2D
from powerpaint_tpu_torch.ops import conv
from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline
from powerpaint_tpu_torch.testing import tiny_v1_config
from powerpaint_tpu_torch.text.tokenizer import (
    HashTokenizer,
    TokenizerWrapper,
    add_task_tokens,
)
from test_torch_pipeline import FIT, GUIDE, HW, SEED, _inputs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_int8_conv(x, w_q, w_s, gamma, beta, groups, x_scale, eps=1e-5,
                   bias=None):
    """The arithmetic of ``conv_pallas.conv3x3_gn_silu_int8`` in XLA
    (its interpret mode compiles too slowly for a whole pipeline): the
    kernel's statistics, fp32 prologue, quantiser, exact int8 products and
    epilogue."""
    mean, rstd = conv_pallas.gn_stats(x, groups, eps)
    y = (x.astype(jnp.float32) - mean[:, None, None]) * \
        (rstd * gamma)[:, None, None] + beta
    y = y * jax.nn.sigmoid(y)
    q = jnp.clip(jnp.round(y * float(1.0 / x_scale)), -127, 127)
    acc = jax.lax.conv_general_dilated(
        q, w_q.astype(jnp.float32), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)
    acc = acc * (w_s * x_scale)
    if bias is not None:
        acc = acc + bias.astype(jnp.float32)
    return acc.astype(x.dtype)


def test_tiny_v1_int8_pipeline_matches_jax_unit_by_unit(monkeypatch):
    """The tiny ppt-v1 pipeline with int8 on (every ResNet unit is an int8
    site at this size) against the JAX pipeline with POWERPAINT_INT8=1, on
    the same weights and noise.

    Static-scale quantisation turns an fp32 ulp of difference upstream (the
    JAX package's one-pass GroupNorm statistics against the port's
    two-pass, XLA's sigmoid against PyTorch's) into a whole int8 level
    wherever a value sits at a rounding boundary, and the flips compound
    over the layers, so the two images need not be close while the fp32
    pipelines agree. So the pipelines are held
    unit by unit along the JAX call's own trajectory: every int8 unit the
    JAX pipeline runs (2 steps: 44 UNet units a step, 12 in the VAE
    encoder, 20 in the decoder) is recomputed by the port's int8 unit with
    the same weights, on the input JAX gave it, within the flip bound."""
    state = init_state(tiny_v1_config(), torch.Generator().manual_seed(0),
                       device="cpu")
    sd = {f: {k: v.numpy() for k, v in d.items()} for f, d in state.items()}
    tok = TokenizerWrapper(HashTokenizer(994))
    add_task_tokens(tok)
    monkeypatch.setenv("POWERPAINT_INT8", "1")
    monkeypatch.delenv("POWERPAINT_INT8_XSCALE", raising=False)
    monkeypatch.setattr(jax_layers, "_on_tpu", lambda: True)
    units = []

    def recorded(x, w_q, w_s, gamma, beta, groups, x_scale, eps=1e-5,
                 bias=None):
        out = _jax_int8_conv(x, w_q, w_s, gamma, beta, groups, x_scale, eps,
                             bias)
        jax.debug.callback(
            lambda *a: units.append([np.asarray(v) for v in a] + [groups, eps]),
            x, w_q, gamma, beta, out)
        return out

    monkeypatch.setattr(conv_pallas, "conv3x3_gn_silu_int8", recorded)
    params = {"unet": convert_unet(sd["unet"]), "vae": convert_vae(sd["vae"]),
              "text_encoder": convert_clip_text(sd["text_encoder"])}
    jax_pipe = JaxPipeline(jax_tiny_v1_config(), params, tok, dtype=jnp.float32)
    image, mask = _inputs()
    kw = dict(prompt="a red bench", fitting_degree=FIT, num_inference_steps=2,
              guidance_scale=GUIDE, seed=SEED)
    want = jax_pipe(image, mask, **kw)
    assert len(units) == 2 * 44 + 12 + 20

    port = InpaintPipeline(tiny_v1_config(), sd, tok, dtype=torch.float32,
                           device="cpu")  # int8 from the environment
    assert port.int8_x_scale == 8.0 / 127.0
    convs = {}
    for model in (port.unet, port.vae):
        for m in model.modules():
            if isinstance(m, Conv2D) and m.int8_x_scale is not None:
                convs[m.w_q.numpy().tobytes()] = m
    matched = set()
    for x, w_q, gamma, beta, out, groups, eps in units:
        m = convs[np.ascontiguousarray(w_q.transpose(3, 0, 1, 2)).tobytes()]
        matched.add(id(m))
        tx, gn = torch.from_numpy(x), (torch.from_numpy(gamma),
                                       torch.from_numpy(beta))
        got = conv.conv3x3_gn_silu_int8(
            tx, m.w_q, m.w_scale, m.bias_fp32, *gn, x_scale=port.int8_x_scale,
            num_groups=groups, eps=eps)
        err, ok, _ = chip_smoke.int8_check(
            got, torch.from_numpy(out), tx, m.w_q, m.w_scale, m.bias_fp32,
            True, gn, groups, port.int8_x_scale)
        assert ok, f"unit {tuple(x.shape)}: max |err| {err} beyond the flip bound"
    assert len(matched) == len(convs) == 44 + 12 + 20
    # int8 is on: the image differs from the fp32 pipeline's
    fp32 = InpaintPipeline(tiny_v1_config(), sd, tok, dtype=torch.float32,
                           device="cpu", int8=False)
    assert not np.array_equal(fp32(image, mask, **kw), port(image, mask, **kw))
    assert want.shape == (1, HW, HW, 3)
    # the int8 buffers stay out of the state dict
    assert set(port.unet.state_dict()) == set(sd["unet"])
