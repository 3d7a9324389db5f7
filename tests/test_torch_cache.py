"""The port's approximation modes against the JAX package's, in fp32 at
tiny sizes: encoder propagation on the UNet (``emit_encoder_cache`` /
``encoder_cache``) and in the ppt-v1 loop (``encoder_cache_interval``),
the BrushNet branch's cache in the ppt-v2 loop (``branch_cache_interval``,
one JAX pipeline call), FreeU on the UNet, and what refuses a cache: a
UNet given injected down features, the ControlNet pipeline.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerpaint_tpu.models.unet import UNet2DConditionModel as JaxUNet
from powerpaint_tpu.ops import freeu as jax_freeu
from powerpaint_tpu.pipelines.brushnet import BrushNetPipeline as JaxV2Pipeline
from powerpaint_tpu.testing import tiny_v1_config as jax_tiny_v1_config
from powerpaint_tpu.testing import tiny_v2_config as jax_tiny_v2_config
from powerpaint_tpu_torch.io.weights import init_state
from powerpaint_tpu_torch.ops import freeu
from powerpaint_tpu_torch.pipelines.brushnet import (
    BrushNetPipeline,
    cond_scale_table,
)
from powerpaint_tpu_torch.pipelines.controlnet import ControlNetPipeline
from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline
from powerpaint_tpu_torch.testing import (
    tiny_v1_config,
    tiny_v1_controlnet_config,
    tiny_v2_config,
)
from powerpaint_tpu_torch.text.prompts import add_task, v2_prompt_suffix
from powerpaint_tpu_torch.text.tokenizer import (
    HashTokenizer,
    TokenizerWrapper,
    add_task_tokens,
)
from test_torch_brushnet import v2_weights
from test_torch_vae_extras import _inputs, _t, _weights


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32 = jnp.float32
HW, SEED, FIT, GUIDE = 64, 7, 0.6, 7.5


@pytest.fixture(scope="module")
def unet_weights():
    _, trees, models = _weights(tiny_v1_config(), seed=1)
    return trees["unet"], models["unet"]


def _unet_inputs(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 16, 16, 9).astype(np.float32),
            rng.randn(2, 77, 32).astype(np.float32))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# the UNet
# ---------------------------------------------------------------------------


def test_unet_encoder_cache_matches_jax(unet_weights):
    """A key step's output and encoder features, then a step at another
    timestep and sample from those features, against the JAX UNet's (one
    compile of both)."""
    tree, unet = unet_weights
    jax_unet = JaxUNet(jax_tiny_v1_config().unet, dtype=F32)
    sample, ctx = _unet_inputs(10)
    later, _ = _unet_inputs(11)
    t0, t1 = np.asarray([981, 981], np.int32), np.asarray([801, 801], np.int32)

    def key_then_cached(p, s, s1, t0, t1, c):
        out, cache = jax_unet.apply(p, s, t0, c, emit_encoder_cache=True)
        return out, cache, jax_unet.apply(p, s1, t1, c, encoder_cache=cache)

    want, want_cache, want_later = jax.jit(key_then_cached)(
        {"params": tree}, sample, later, t0, t1, ctx)
    got, cache = unet(_t(sample), torch.from_numpy(t0), _t(ctx),
                      emit_encoder_cache=True)
    _close(got, want)
    _close(cache[0], want_cache[0])
    assert len(cache[1]) == len(want_cache[1]) == 12
    for a, b in zip(cache[1], want_cache[1]):
        _close(a, b)
    got = unet(_t(later), torch.from_numpy(t1), _t(ctx), encoder_cache=cache)
    _close(got, want_later)
    # the cached step reads the cache, not the sample
    assert torch.equal(unet(_t(sample), torch.from_numpy(t1), _t(ctx),
                            encoder_cache=cache), got)
    # and a key step's output is the plain forward's
    assert torch.equal(unet(_t(sample), torch.from_numpy(t0), _t(ctx)),
                       unet(_t(sample), torch.from_numpy(t0), _t(ctx),
                            emit_encoder_cache=True)[0])


@pytest.mark.parametrize("mode", ["emit", "reuse"])
@pytest.mark.parametrize("inject", ["controlnet", "brushnet"])
def test_encoder_cache_refuses_injected_down_features(unet_weights, mode, inject):
    _, unet = unet_weights
    sample, ctx = _unet_inputs(12)
    t = torch.tensor(500)
    # refused before they are read, so their shapes do not matter
    name = ("down_block_additional_residuals" if inject == "controlnet"
            else "down_block_add_samples")
    kw = {name: [torch.zeros(1)] * 12}
    kw.update(emit_encoder_cache=True) if mode == "emit" else kw.update(
        encoder_cache=(torch.zeros(2, 2, 2, 64), ()))
    with pytest.raises(ValueError, match="encoder caching"):
        unet(_t(sample), t, _t(ctx), **kw)


def test_unet_with_freeu_matches_jax(unet_weights):
    tree, unet = unet_weights
    sample, ctx = _unet_inputs(9)
    t = np.asarray([981, 501], np.int32)
    jcfg = jax_freeu.FreeUConfig(1.5, 1.6, 0.9, 0.2)
    want = jax.jit(JaxUNet(jax_tiny_v1_config().unet, dtype=F32,
                           freeu=jcfg).apply)({"params": tree}, sample, t, ctx)
    off = unet(_t(sample), torch.from_numpy(t), _t(ctx))
    unet.freeu = freeu.FreeUConfig(1.5, 1.6, 0.9, 0.2)
    try:
        got = unet(_t(sample), torch.from_numpy(t), _t(ctx))
    finally:
        unet.freeu = None
    _close(got, want)
    assert not torch.allclose(got, off, atol=1e-2)
    assert torch.equal(unet(_t(sample), torch.from_numpy(t), _t(ctx)), off)


# ---------------------------------------------------------------------------
# the loops
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tok():
    t = TokenizerWrapper(HashTokenizer(994))
    add_task_tokens(t)
    return t


def _count(module, attr, monkeypatch):
    calls = []
    fn = getattr(module, attr)

    def counted(*a, **k):
        calls.append(1)
        return fn(*a, **k)

    monkeypatch.setattr(module, attr, counted)
    return calls


@pytest.mark.parametrize("interval,encodes", [(0, 4), (2, 2), (3, 2)])
def test_v1_runs_the_encoder_on_key_steps_only(tok, monkeypatch, interval, encodes):
    cfg = tiny_v1_config()
    pipe = InpaintPipeline(cfg, init_state(cfg, torch.Generator().manual_seed(0),
                                           device="cpu"),
                           tok, dtype=torch.float32, device="cpu")
    image, mask = _inputs()
    calls = _count(pipe.unet, "_encode", monkeypatch)
    evals = _count(pipe.unet, "forward", monkeypatch)
    out = pipe(image, mask, prompt="a dog", num_inference_steps=4, seed=3,
               encoder_cache_interval=interval)
    assert len(calls) == encodes and len(evals) == 4
    if interval <= 1:  # the exact loop
        monkeypatch.undo()
        np.testing.assert_array_equal(
            out, pipe(image, mask, prompt="a dog", num_inference_steps=4, seed=3))


def _psnr(a, b):
    """Over float images in [-1, 1] (peak 2), as the JAX package's
    ``tests/test_cache_drift.py`` takes it."""
    return 10 * np.log10(4.0 / float(np.mean((a - b) ** 2)))


@pytest.mark.parametrize("version", ["ppt-v1", "ppt-v2"])
def test_cache_drift_stays_above_the_jax_floors(tok, version):
    """The approximations' error bar: 20 steps at 64 px, the cached images'
    PSNR against the exact loop's above the floors the JAX package pins
    (``tests/test_cache_drift.py``) and falling with the interval."""
    v1 = version == "ppt-v1"
    cfg = tiny_v1_config() if v1 else tiny_v2_config()
    cls = InpaintPipeline if v1 else BrushNetPipeline
    arg = "encoder_cache_interval" if v1 else "branch_cache_interval"
    floors = {2: 24.0, 3: 20.0, 4: 17.0} if v1 else {2: 35.0, 3: 30.0, 4: 27.0}
    pipe = cls(cfg, init_state(cfg, torch.Generator().manual_seed(0), device="cpu"),
               tok, dtype=torch.float32, device="cpu")
    image, _ = _inputs()
    mask = np.zeros((HW, HW), np.float32)
    mask[16:48, 16:48] = 1.0
    kw = dict(prompt="x", num_inference_steps=20, seed=3, output_type="float32")
    exact = pipe(image, mask, **kw)
    psnrs = {n: _psnr(exact, pipe(image, mask, **kw, **{arg: n})) for n in floors}
    assert all(psnrs[n] > floor for n, floor in floors.items()), psnrs
    assert psnrs[2] > psnrs[3] > psnrs[4], psnrs


@pytest.fixture(scope="module")
def v2_pipes(tok):
    sd_np, trees = v2_weights()
    jax_pipe = JaxV2Pipeline(jax_tiny_v2_config(), trees, tok, dtype=F32)
    port = BrushNetPipeline(tiny_v2_config(), sd_np, tok, dtype=torch.float32,
                            device="cpu")
    return jax_pipe, port


def _port_v2(port, steps, interval):
    image, mask = _inputs()
    key = jax.random.PRNGKey(SEED)
    noise = [torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(key, f), (HW // 8, HW // 8, 4), F32))[None])
        for f in (0, 1)]  # the JAX v2 pipeline's streams: folds 0 and 1
    task = "object-removal"
    ids_task, ids_plain = port.encode_task(
        add_task(v2_prompt_suffix("a red bench", task), "", task, "ppt-v2"))
    return port._generate(
        torch.from_numpy(ids_task[None]).long(),
        torch.from_numpy(ids_plain[None]).long(), torch.tensor([FIT]),
        torch.from_numpy(image[None]),
        torch.from_numpy((mask >= 0.5).astype(np.uint8)[None, ..., None] * 255),
        torch.tensor([GUIDE]), cond_scale_table(steps, 1.0, 0.0, 1.0), *noise,
        num_steps=steps, output_type="float32",
        branch_cache_interval=interval).numpy()


def test_v2_branch_cache_matches_jax(v2_pipes):
    """Six UniPC steps with the branch at steps 0, 2, 4, against the JAX
    pipeline's float32 image (one compile); bound as the v1 call's in
    ``test_torch_vae_extras.py``."""
    jax_pipe, port = v2_pipes
    image, mask = _inputs()
    want = jax_pipe(image, mask, prompt="a red bench", task="object-removal",
                    fitting_degree=FIT, num_inference_steps=6,
                    guidance_scale=GUIDE, seed=SEED, branch_cache_interval=2,
                    output_type="float32")
    got = _port_v2(port, 6, 2)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-3)
    assert np.abs(_port_v2(port, 6, 1) - got).max() > 1e-3


@pytest.mark.parametrize("kw", [{}, dict(guess_mode=True),
                                dict(control_guidance_end=0.5)],
                         ids=["plain", "guess_mode", "window"])
def test_v2_runs_the_branch_on_key_steps_only(v2_pipes, monkeypatch, kw):
    _, port = v2_pipes
    image, mask = _inputs()
    calls = _count(port.brushnet, "forward", monkeypatch)
    evals = _count(port.unet, "forward", monkeypatch)
    port(image, mask, prompt="a dog", num_inference_steps=4, seed=3,
         branch_cache_interval=3, **kw)
    assert len(calls) == 2 and len(evals) == 4


def test_controlnet_takes_no_encoder_cache(tok):
    cfg = tiny_v1_controlnet_config()
    pipe = ControlNetPipeline(cfg, init_state(cfg, torch.Generator().manual_seed(0),
                                              device="cpu"),
                              tok, dtype=torch.float32, device="cpu")
    image, mask = _inputs()
    with pytest.raises(TypeError, match="encoder_cache_interval"):
        pipe(image, mask, image, prompt="a dog", num_inference_steps=2,
             encoder_cache_interval=2)
    ids = pipe.encode_task(add_task("a dog", "", "text-guided"))[None]
    noise = [torch.zeros(1, HW // 8, HW // 8, 4)] * 3
    with pytest.raises(ValueError, match="encoder caching"):
        pipe._generate(
            torch.from_numpy(ids).long(), torch.tensor([FIT]),
            torch.from_numpy(image[None]),
            torch.from_numpy((mask >= 0.5).astype(np.uint8)[None, ..., None] * 255),
            torch.tensor([GUIDE]), *noise, None, num_steps=2, strength_steps=2,
            output_type="uint8", encoder_cache_interval=2,
            control_u8=torch.from_numpy(image[None, None]),
            scales=np.ones((2, 1)))
