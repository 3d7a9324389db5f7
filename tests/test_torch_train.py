"""The port's training (``powerpaint_tpu_torch.train``) against the JAX
package's ``train/``, on the CPU at the tiny ppt-v1 config in fp32.

- masks and batches: bitwise (the port rasterises OpenCV's strokes itself);
- the v1 loss and every gradient leaf, given the JAX step's own draws
  (``fold_in(key, step)``, then ``split(.., 4)``), on one set of weights
  (the port's random state with random biases and norm affines, made JAX
  trees by the JAX package's converters): the loss within 1e-5 relative,
  every leaf within 1e-4 of the stack's largest gradient (fp32 sums in
  other orders through four levels; 1e-5 of it is what this config shows);
- the optimizer (``AdamW``) against the JAX package's ``make_optimizer``,
  applied eagerly to the JAX gradients on both sides, for ``v1`` and
  ``task_tokens`` labels, clipped and not, with ``accumulate 2`` and EMA:
  params within 1e-6 relative plus 1e-4 lr per step (only fp32 rounding
  differs, and Adam's step is at most about lr); frozen leaves bitwise;
- LoRA: the port's LoRA gradients against the chain-rule gradient of the
  JAX v1 loss at the merged weights (in gradient units, as above), then two
  steps against the JAX factors moved by ``make_optimizer``, and
  ``export_lora_sd``, within 0.1 lr per step.

The image is 128^2: at 32^2 the tiny UNet's deepest GroupNorms see one
pixel and two channels a group, and their ill conditioning turns fp32
rounding into 1e-3 of a gradient. One JAX compile: the v1 loss's
``jit(value_and_grad)``, shared by a module fixture.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from powerpaint_tpu.io.convert import (
    convert_brushnet,
    convert_clip_text,
    convert_unet,
    convert_vae,
)
from powerpaint_tpu.testing import tiny_v1_config as jax_tiny_v1_config
from powerpaint_tpu.text.tokenizer import HashTokenizer as JaxHashTokenizer
from powerpaint_tpu.text.tokenizer import TokenizerWrapper as JaxTokenizerWrapper
from powerpaint_tpu.text.tokenizer import add_task_tokens as jax_add_task_tokens
from powerpaint_tpu.train import data as jax_data
from powerpaint_tpu.train import masks as jax_masks
from powerpaint_tpu.train.loss import make_v1_loss as jax_make_v1_loss
from powerpaint_tpu.train.lora import apply_lora as jax_apply_lora
from powerpaint_tpu.train.lora import export_lora_sd as jax_export_lora_sd
from powerpaint_tpu.train.lora import init_lora_tree as jax_init_lora_tree
from powerpaint_tpu.train.step import make_optimizer
from powerpaint_tpu.train.step import trainable_mask as jax_trainable_mask
from powerpaint_tpu_torch.io.weights import init_state, params_from_jax
from powerpaint_tpu_torch.testing import tiny_v1_config
from powerpaint_tpu_torch.text.tokenizer import (
    HashTokenizer,
    TokenizerWrapper,
    add_task_tokens,
)
from powerpaint_tpu_torch.train import data, masks
from powerpaint_tpu_torch.train.loss import make_lora_loss, make_v1_loss
from powerpaint_tpu_torch.train.lora import export_lora_sd
from powerpaint_tpu_torch.train.step import (
    AdamW,
    ema_update,
    flatten,
    init_train_state,
    make_train_step,
    trainable_mask,
)

HW = 128
GRAD_ATOL = 1e-4  # of the stack's largest gradient magnitude
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _grad_mode_on():
    """Autograd on for each test: other test modules of the suite turn it
    off for the whole process when they are imported."""
    with torch.enable_grad():
        yield


# ------------------------------------------------------- shared helpers

CONVERT = {"unet": convert_unet, "vae": convert_vae,
           "text_encoder": convert_clip_text, "brushnet": convert_brushnet,
           "text_encoder_brushnet": convert_clip_text}


def tokenizers():
    tok = TokenizerWrapper(HashTokenizer(1024))
    add_task_tokens(tok)
    jtok = JaxTokenizerWrapper(JaxHashTokenizer(1024))
    jax_add_task_tokens(jtok)
    return tok, jtok


def random_stack(cfg, seed=0):
    """(JAX trees, port fp32 state) of one set of weights: the port's random
    state with random biases and norm affines too, through the JAX
    package's converters and back."""
    state = init_state(cfg, torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.RandomState(seed)
    trees = {}
    for family, sd in state.items():
        sd = {k: v.numpy() for k, v in sd.items()}
        for k, v in sd.items():
            if v.ndim == 1:
                sd[k] = (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        trees[family] = CONVERT[family](sd)
    return trees, port_params(trees)


def port_params(trees) -> dict:
    return {f: {k: torch.from_numpy(np.array(v, np.float32))
                for k, v in sd.items()}
            for f, sd in params_from_jax(
                jax.tree.map(np.asarray, trees), "stack").items()}


def jax_draws(key, b, hw, T, names=("lat", "mlat", "t", "eps")):
    """The JAX loss's own draws for ``key`` (its ``split(key, 4)`` order; 5
    keys for distillation), as the port's ``draws``."""
    keys = jax.random.split(key, len(names))
    shape = (b, hw // 8, hw // 8, 4)
    out = {}
    for n, k in zip(names, keys):
        if n in ("t", "i"):
            out[n] = jax.random.randint(k, (b,), 0, T)
        elif n == "w":
            out[n] = jax.random.uniform(k, (b,), jnp.float32, 4.0, 12.0)
        else:
            out[n] = jax.random.normal(k, shape, jnp.float32)
    return {n: torch.from_numpy(np.array(v)).long() if n in ("t", "i")
            else torch.from_numpy(np.array(v)) for n, v in out.items()}


def port_grads(loss_fn, params, batch, draws, families):
    """(loss, metrics, {"family/name": grad}) of ``loss_fn`` over every leaf
    of ``families``."""
    leaves = {f: {k: v.clone().requires_grad_(f in families)
                  for k, v in sd.items()} for f, sd in params.items()}
    loss, metrics = loss_fn(leaves, batch, draws)
    flat = {k: v for k, v in flatten(leaves).items() if v.requires_grad}
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss, metrics, dict(zip(flat, grads))


def assert_grads_match(got: dict, jax_grads: dict, families):
    want = flatten({f: params_from_jax(jax.tree.map(np.asarray, jax_grads[f]), f)
                    for f in families})
    assert set(got) == set(want)
    gmax = max(float(np.abs(w).max()) for w in want.values())
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=0,
                                   atol=GRAD_ATOL * gmax, err_msg=k)


def assert_params_match(got: dict, jax_tree: dict, lr_steps: float):
    """Port params (``{family: sd}`` or flat) against a JAX tree, within
    1e-6 relative plus 1e-4 of lr per step."""
    want = flatten(params_from_jax(jax.tree.map(np.asarray, jax_tree), "stack"))
    got = flatten(got)
    assert set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-6,
                                   atol=1e-4 * lr_steps, err_msg=k)


# ------------------------------------------------------- masks, batches


@pytest.mark.parametrize("kind", [None, "brush", "rect", "border", "mix"])
def test_masks_are_bitwise_the_jax_packages(kind):
    for seed in range(25):
        for h, w in ((32, 32), (64, 48), (96, 160)):
            got = masks.random_mask(np.random.RandomState(seed), h, w, kind)
            want = jax_masks.random_mask(np.random.RandomState(seed), h, w, kind)
            assert np.array_equal(got, want), (kind, seed, h, w)
    got = masks.random_mask(np.random.RandomState(3), 512, 512, kind)
    want = jax_masks.random_mask(np.random.RandomState(3), 512, 512, kind)
    assert np.array_equal(got, want)


def test_strokes_are_opencvs():
    rng = np.random.RandomState(0)
    for _ in range(600):
        h, w = int(rng.choice([16, 64, 100])), int(rng.choice([16, 77, 128]))
        a = (int(rng.randint(w)), int(rng.randint(h)))
        b = (int(rng.randint(w)), int(rng.randint(h)))
        t = int(rng.randint(2, max(4, min(h, w) // 3)))
        r = int(rng.randint(0, 30))
        for draw, ref in ((lambda m: masks.draw_line(m, a, b, t),
                           lambda m: cv2.line(m, a, b, 1.0, t)),
                          (lambda m: masks.draw_disc(m, a, r),
                           lambda m: cv2.circle(m, a, r, 1.0, -1))):
            got, want = np.zeros((h, w), np.float32), np.zeros((h, w), np.float32)
            draw(got)
            ref(want)
            assert np.array_equal(got, want), (h, w, a, b, t, r)
    with pytest.raises(ValueError, match="outside"):
        masks.draw_line(np.zeros((8, 8), np.float32), (0, 0), (8, 3), 3)


def test_coloured_polygon_and_disc_are_opencvs():
    """The rasterisers the masks share with the pose skeleton
    (``tasks.drawing``), with a colour on a 3-channel canvas: a filled
    polygon (integer points, partly off the canvas) and a filled disc."""
    from powerpaint_tpu_torch.tasks import drawing

    rng = np.random.RandomState(1)
    for _ in range(50):
        h, w = int(rng.randint(8, 90)), int(rng.randint(8, 90))
        colour = tuple(int(v) for v in rng.randint(1, 256, 3))
        pts = np.stack([rng.randint(-20, w + 20, 6), rng.randint(-20, h + 20, 6)], 1)
        hull = cv2.convexHull(pts.astype(np.int32))[:, 0]
        centre = (int(rng.randint(-5, w + 5)), int(rng.randint(-5, h + 5)))
        r = int(rng.randint(0, 30))
        got, want = np.zeros((h, w, 3), np.uint8), np.zeros((h, w, 3), np.uint8)
        drawing.fill_convex_poly(got, hull, colour)
        drawing.circle(got, centre, r, colour[::-1])
        cv2.fillConvexPoly(want, hull, colour)
        cv2.circle(want, centre, r, colour[::-1], -1)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("version", ["ppt-v1", "ppt-v2"])
@pytest.mark.parametrize("task", data.TASKS)
def test_batches_are_bitwise_the_jax_packages(version, task):
    tok, jtok = tokenizers()
    got = data.batches(data.SyntheticSource(hw=32, seed=1), tok, 3,
                       version=version, seed=2, tasks=[task])
    want = jax_data.batches(jax_data.SyntheticSource(hw=32, seed=1), jtok, 3,
                            version=version, seed=2, tasks=[task])
    for _ in range(3):
        g, w = next(got), next(want)
        assert set(g) == set(w)
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


# ------------------------------------------------------- the v1 loss


@pytest.fixture(scope="module")
def v1():
    cfg = tiny_v1_config()
    trees, params = random_stack(cfg)
    _, jtok = tokenizers()
    batch = next(jax_data.batches(jax_data.SyntheticSource(hw=HW, seed=11),
                                  jtok, 2, version="ppt-v1", seed=12))
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    vg = jax.jit(jax.value_and_grad(
        jax_make_v1_loss(jax_tiny_v1_config(), dtype=jnp.float32),
        has_aux=True))
    (loss, _), grads = vg(trees, batch, key)
    draws = jax_draws(key, 2, HW, cfg.scheduler.num_train_timesteps)
    return dict(cfg=cfg, trees=trees, params=params, batch=batch, vg=vg,
                key=key, draws=draws, loss=float(loss), grads=grads)


def test_v1_loss_and_every_gradient_match_jax(v1):
    loss, metrics, grads = port_grads(make_v1_loss(v1["cfg"]), v1["params"],
                                      v1["batch"], v1["draws"],
                                      ("unet", "text_encoder"))
    np.testing.assert_allclose(float(loss), v1["loss"], rtol=1e-5)
    assert float(metrics["mse"]) == float(loss)  # no SNR weighting
    assert_grads_match(grads, v1["grads"], ("unet", "text_encoder"))


@pytest.mark.parametrize("mode", ["v1", "task_tokens"])
def test_train_step_grad_norm_is_over_every_leaf(v1, mode):
    """``grad_norm`` is the JAX step's ``optax.global_norm(grads)`` over
    every leaf that gets a gradient: in ``task_tokens`` mode too, though
    only the task rows train."""
    params = {f: {k: v.clone() for k, v in sd.items()}
              for f, sd in v1["params"].items()}
    tx = AdamW(LR, labels=trainable_mask(params, mode))
    state = init_train_state(params, tx)
    step = make_train_step(make_v1_loss(v1["cfg"]), tx)
    _, metrics = step(state, v1["batch"], v1["draws"])
    want = np.sqrt(sum(float(np.sum(np.square(np.asarray(g, np.float64))))
                       for g in jax.tree.leaves(v1["grads"])))
    np.testing.assert_allclose(float(metrics["grad_norm"]), want, rtol=1e-5)
    assert state.step == 1


def _subset(tree):
    """A part of a v1 stack tree with leaves of each kind (the task rows,
    the token table, norms, convs, linears, attention) and a frozen VAE
    conv: the optimizer's arithmetic does not depend on how many leaves
    there are, and JAX compiles its update in seconds for these."""
    return {"unet": {k: tree["unet"][k] for k in (
                "conv_in", "conv_norm_out", "conv_out", "time_embedding",
                "mid_block")},
            "text_encoder": {k: tree["text_encoder"][k] for k in (
                "external_embedding", "final_layer_norm", "layers_1",
                "token_embedding")},
            "vae": {"encoder": {"conv_in": tree["vae"]["encoder"]["conv_in"]}}}


def _port_jax_grads(v1, scale=1.0):
    jg = jax.tree.map(lambda g: np.asarray(g) * np.float32(scale),
                      _subset(v1["grads"]))
    return jg, {k: torch.from_numpy(np.array(v, np.float32))
                for k, v in flatten(params_from_jax(jg, "stack")).items()}


@pytest.mark.parametrize("mode,clip", [("v1", 1.0), ("v1", None),
                                       ("task_tokens", 1.0)])
def test_optimizer_steps_match_optax(v1, mode, clip):
    trees = _subset(v1["trees"])
    tx_j = make_optimizer(LR, clip_norm=clip,
                          labels=jax_trainable_mask(trees, mode))
    opt_j = tx_j.init(trees)
    update_j = jax.jit(tx_j.update)
    params = port_params(trees)
    before = {k: v.clone() for k, v in flatten(params).items()}
    labels = trainable_mask(params, mode)
    tx = AdamW(LR, clip_norm=clip, labels=labels)
    opt = tx.init(params)
    for scale in (1.0, -0.5):
        jg, pg = _port_jax_grads(v1, scale)
        updates, opt_j = update_j(jg, opt_j, trees)
        trees = optax.apply_updates(trees, updates)
        tx.update(pg, opt, params)
    assert_params_match(params, trees, 2 * LR)
    for k, v in flatten(params).items():
        if not labels[k]:
            assert torch.equal(v, before[k]), k
        elif mode == "task_tokens":
            assert not torch.equal(v, before[k]), k
    assert sum(labels.values()) == (3 if mode == "task_tokens" else sum(
        1 for k in labels if not k.startswith("vae/")))


def test_accumulation_and_ema_match_optax(v1):
    """``accumulate 2`` (``optax.MultiSteps``) and EMA 0.9 on every call:
    params move on calls 2 and 4 only, the EMA on all four."""
    trees = _subset(v1["trees"])
    tx_j = make_optimizer(LR, labels=jax_trainable_mask(trees, "v1"),
                          accumulate_steps=2)
    opt_j = tx_j.init(trees)
    ema_j = trees

    @jax.jit
    def update_j(jg, opt_j, trees, ema_j):
        updates, opt_j = tx_j.update(jg, opt_j, trees)
        trees = optax.apply_updates(trees, updates)
        d = jnp.float32(0.9)
        ema_j = jax.tree.map(lambda e, p: e * d + p * (1.0 - d), ema_j, trees)
        return opt_j, trees, ema_j

    params = port_params(trees)
    tx = AdamW(LR, labels=trainable_mask(params, "v1"), accumulate_steps=2)
    state = init_train_state(params, tx, ema=True)
    for call, scale in enumerate((1.0, 0.5, -1.0, 0.25)):
        before = {k: v.clone() for k, v in flatten(params).items()}
        jg, pg = _port_jax_grads(v1, scale)
        opt_j, trees, ema_j = update_j(jg, opt_j, trees, ema_j)
        tx.update(pg, state.opt_state, params)
        ema_update(state.ema, params, 0.9)
        moved = any(not torch.equal(v, before[k])
                    for k, v in flatten(params).items())
        assert moved == (call % 2 == 1), call
    assert_params_match(params, trees, 2 * LR)
    assert_params_match(state.ema, ema_j, 2 * LR)


def _torch_lora(lora_j):
    return {m: {k: torch.from_numpy(np.array(v)) for k, v in f.items()}
            for m, f in params_from_jax(jax.tree.map(np.asarray, lora_j),
                                        "lora").items()}


def test_lora_two_steps_and_export_match_jax(v1):
    """The port's LoRA loss and step against the JAX factors: JAX's
    ``make_optimizer`` on the chain-rule gradient of its v1 loss at the
    merged weights (down (I, r) and up (r, O): dL/d down = G up^T, dL/d up
    = down^T G for the weight gradient G)."""
    trees, vg, key = v1["trees"], v1["vg"], v1["key"]
    lora_j = jax_init_lora_tree(trees["unet"], 4, jax.random.PRNGKey(5))
    lora = _torch_lora(lora_j)
    tx_j = make_optimizer(LR)
    opt_j = tx_j.init(lora_j)
    tx = AdamW(LR)
    state = init_train_state(lora, tx)

    def chain(g_w, f):
        if isinstance(f, dict) and "down" in f and not isinstance(f["down"], dict):
            return {"down": g_w["kernel"] @ f["up"].T,
                    "up": f["down"].T @ g_w["kernel"]}
        return {k: chain(g_w[k], v) for k, v in f.items()}

    merge = jax.jit(lambda lora_j: jax_apply_lora(trees["unet"], lora_j))
    chain_j = jax.jit(chain)

    @jax.jit
    def update(g_lora, lora_j, opt_j):
        updates, opt_j = tx_j.update(g_lora, opt_j, lora_j)
        return optax.apply_updates(lora_j, updates), opt_j

    loss_fn = make_lora_loss(make_v1_loss(v1["cfg"]), v1["params"])
    step = make_train_step(loss_fn, tx)
    for _ in range(2):
        (loss_j, _), g = vg(dict(trees, unet=merge(lora_j)), v1["batch"], key)
        g_lora = chain_j(g["unet"], lora_j)
        # the gradients, in gradient units, before the step
        leaves = {m: {k: t.clone().requires_grad_(True) for k, t in f.items()}
                  for m, f in state.params.items()}
        loss, _ = loss_fn(leaves, v1["batch"], v1["draws"])
        flat = flatten(leaves)
        got = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
        want = flatten(params_from_jax(jax.tree.map(np.asarray, g_lora), "lora"))
        gmax = max(float(np.abs(w).max()) for w in want.values())
        for k, g_k in got.items():
            np.testing.assert_allclose(g_k.numpy(), want[k], rtol=0,
                                       atol=GRAD_ATOL * gmax, err_msg=k)
        lora_j, opt_j = update(g_lora, lora_j, opt_j)
        _, metrics = step(state, v1["batch"], v1["draws"])
        np.testing.assert_allclose(float(metrics["loss"]), float(loss_j),
                                   rtol=1e-5)
    got = export_lora_sd(state.params)
    jax_sd = jax_export_lora_sd(lora_j)
    assert set(got) == set(jax_sd)
    # in lr units after two steps: Adam's normalisation turns the fp32
    # gradient differences (held tightly above) into a share of a step
    # where a moment sits near 0, up to a whole step; elsewhere they stay
    # under 1e-2 of one. Every element within lr per step, and at most 0.5%
    # of them past 1e-2 of it.
    far = total = 0
    for k in got:
        assert got[k].dtype == np.asarray(jax_sd[k]).dtype
        d = np.abs(got[k] - np.asarray(jax_sd[k]))
        assert d.max() <= 2 * LR, k
        far += int((d > 1e-2 * 2 * LR).sum())
        total += d.size
    assert far <= 0.005 * total, (far, total)
