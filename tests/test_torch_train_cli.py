"""The port's train loop and command line on the CPU (tiny configs, fp32):

- ``Trainer``: two steps, a save, a load into a fresh state, one step:
  bitwise three steps straight (params, moments, EMA, counters), with
  accumulation 2 and EMA on;
- ``--tiny --steps 2`` for ``v1``: its ``weights/`` read by the JAX
  package's ``load_ppt_v1`` ``array_equal`` to the port's trained state,
  and by the port's loader; for ``lora``: its ``lora.npz`` as the JAX
  package's ``export_lora_sd`` lays one out, merged by both packages'
  ``io/lora`` with nothing unmatched, and by the port's serve CLI
  (``--lora``); ppt-v2's weights read back by the port's ``load_ppt_v2``;
- ``--mesh`` above the host's card count refused, ``--fsdp`` without
  ``--mesh`` run as one process (as the JAX CLI ignores it),
  ``POWERPAINT_INT8=1`` refused;
- ``--mesh 2 --fsdp`` on two gloo CPU processes: its losses within the
  data-parallel bound of the one-process run's, and its ``state.npz``
  (gathered on rank 0) loaded into a one-process template, within the
  post-Adam bound of the one-process state.

No JAX compile: the JAX side only loads and merges.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerpaint_tpu.io import checkpoint as jax_checkpoint
from powerpaint_tpu.io.lora import merge_lora as jax_merge_lora
from powerpaint_tpu.testing import tiny_v1_config as jax_tiny_v1_config
from powerpaint_tpu_torch.io import checkpoint
from powerpaint_tpu_torch.io.weights import init_state
from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline
from powerpaint_tpu_torch.testing import tiny_v1_config, tiny_v2_config
from powerpaint_tpu_torch.train import cli, data
from powerpaint_tpu_torch.train.loss import draw, make_v1_loss
from powerpaint_tpu_torch.train.lora import load_lora_npz
from powerpaint_tpu_torch.train.step import (
    AdamW,
    flatten,
    init_train_state,
    make_train_step,
    trainable_mask,
)
from powerpaint_tpu_torch.train.trainer import (
    Trainer,
    load_train_state,
    save_train_state,
)
from test_torch_train import CONVERT, LR, random_stack, tokenizers


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


def _run(out, *argv):
    assert cli.main(["--tiny", "--device", "cpu", "--steps", "2",
                     "--batch_size", "2", "--out", str(out), "--log_every",
                     "1", *argv]) == 0
    lines = (out / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2 and all("grad_norm" in ln for ln in lines)


def _trained(out) -> dict:
    with np.load(out / "state.npz") as z:
        trained = {}
        for k in z.files:
            if k.startswith("params/"):
                f, n = k[len("params/"):].split("/", 1)
                trained.setdefault(f, {})[n] = z[k]
    return trained
def test_trainer_resumes_exactly(tmp_path):
    """Two steps, save, load into a fresh state, one step == three steps
    straight, bitwise (params, moments, EMA, counters), with accumulation
    2 and EMA on."""
    cfg = tiny_v1_config()
    tok, _ = tokenizers()
    stream = data.batches(data.SyntheticSource(hw=32, seed=3), tok, 2,
                          version="ppt-v1", seed=4)
    items = [next(stream) for _ in range(3)]
    _, base = random_stack(cfg, seed=1)
    loss_fn = make_v1_loss(cfg)

    def fresh():
        params = {f: {k: v.clone() for k, v in sd.items()}
                  for f, sd in base.items()}
        tx = AdamW(LR, labels=trainable_mask(params, "v1"), accumulate_steps=2)
        state = init_train_state(params, tx, ema=True)
        step = make_train_step(loss_fn, tx, ema_decay=0.9,
                               draw=lambda b, g: draw(cfg, b, g))
        return state, step

    state, step = fresh()
    straight = Trainer(step, state, iter(items), seed=7)
    straight.fit(3, log_every=1)

    state, step = fresh()
    first = Trainer(step, state, iter(items[:2]), seed=7)
    first.fit(2, log_every=0)
    path = str(tmp_path / "state.npz")
    save_train_state(path, first.state)
    state, step = fresh()
    resumed = Trainer(step, load_train_state(path, state), iter(items[2:]),
                      seed=7)
    assert resumed.state.step == 2
    resumed.fit(1, log_every=0)

    for a, b in ((straight.state.params, resumed.state.params),
                 (straight.state.ema, resumed.state.ema),
                 (straight.state.opt_state["mu"], resumed.state.opt_state["mu"]),
                 (straight.state.opt_state["nu"], resumed.state.opt_state["nu"])):
        fa, fb = flatten(a), flatten(b)
        assert all(torch.equal(fa[k], fb[k]) for k in fa)
    assert straight.state.opt_state["count"] == resumed.state.opt_state["count"] == 1
    assert straight.state.step == resumed.state.step == 3


def test_cli_v1_weights_load_in_both_packages(tmp_path):
    out = tmp_path / "run"
    _run(out, "--mode", "v1")
    trained = _trained(out)
    assert set(trained) == {"unet", "vae", "text_encoder"}
    weights = str(out / "weights")
    assert sorted(os.listdir(weights)) == ["text_encoder", "unet", "vae"]
    for family in trained:
        assert (out / "weights" / family / "config.json").exists()

    pipe = jax_checkpoint.load_ppt_v1(weights, config=jax_tiny_v1_config(),
                                      dtype=jnp.float32)
    for family, sd in trained.items():
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b)), pipe.params[family],
            CONVERT[family](sd))

    port = checkpoint.load_ppt_v1(weights, config=tiny_v1_config(),
                                  dtype=torch.float32, device="cpu")
    for family, sd in trained.items():
        got = getattr(port, family).state_dict()
        assert set(got) == set(sd)
        for k, v in sd.items():
            assert np.array_equal(got[k].numpy(), v), (family, k)


def test_cli_lora_loads_through_both_io_loras(tmp_path):
    out = tmp_path / "lora"
    _run(out, "--mode", "lora", "--lora_rank", "2", "--lr", "1e-2")
    sd = load_lora_npz(str(out / "lora.npz"))
    assert any(k.endswith(".lora_A.weight") for k in sd)
    assert all(k.startswith("unet.") for k in sd)
    assert all(sd[k].dtype == np.float32 for k in sd)
    assert all(sd[k].shape == () and sd[k] == 2 for k in sd
               if k.endswith(".alpha"))

    # the JAX package's merge, onto the JAX form of the same random stack
    cfg = tiny_v1_config()
    state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    trees = {f: CONVERT[f]({k: v.numpy() for k, v in state[f].items()})
             for f in ("unet", "text_encoder")}
    merged, unmatched = jax_merge_lora(trees, sd)
    assert unmatched == []
    changed = jax.tree.leaves(jax.tree.map(
        lambda a, b: bool(np.any(np.asarray(a) != np.asarray(b))),
        merged["unet"], trees["unet"]))
    assert any(changed)

    # the port's, through the pipeline's load_lora_weights (--lora's path)
    tok, _ = tokenizers()
    pipe = InpaintPipeline(cfg, state, tok, dtype=torch.float32, device="cpu")
    before = {k: v.clone() for k, v in pipe.unet.state_dict().items()}
    assert pipe.load_lora_weights(str(out / "lora.npz")) == []
    after = pipe.unet.state_dict()
    moved = [k for k in after if not torch.equal(after[k], before[k])]
    assert moved and all(k.endswith("weight") for k in moved)
    want = {f: CONVERT[f]({k: v.numpy() for k, v in
                            getattr(pipe, f).state_dict().items()})
            for f in ("unet",)}
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7),
        merged["unet"], want["unet"])


def test_v2_weights_round_trip(tmp_path):
    """ppt-v2's final weights in the flat reference layout (the branch and
    its task tower under PowerPaint_Brushnet/) read back by the port's
    ``load_ppt_v2``, every tensor equal."""
    cfg = tiny_v2_config()
    state = init_state(cfg, torch.Generator().manual_seed(2), device="cpu")
    root = tmp_path / "weights"
    checkpoint.save_native(str(root), cfg, state)
    assert (root / "PowerPaint_Brushnet" / "text_encoder" / "config.json").exists()
    pipe = checkpoint.load_ppt_v2(str(root), config=cfg, dtype=torch.float32,
                                  device="cpu")
    for family, sd in state.items():
        got = getattr(pipe, family).state_dict()
        assert set(got) == set(sd), family
        for k, v in sd.items():
            assert torch.equal(got[k], v), (family, k)


def test_cli_refuses_the_multi_device_modes_and_int8(monkeypatch, tmp_path):
    with pytest.raises(SystemExit, match="needs 2 cards, one per rank"):
        cli.main(["--tiny", "--mesh", "2"])  # on the card; this host has none
    _run(tmp_path / "fsdp", "--mode", "task_tokens", "--fsdp")  # no mesh
    monkeypatch.setenv("POWERPAINT_INT8", "1")
    with pytest.raises(SystemExit, match="no gradient"):
        cli.main(["--tiny", "--device", "cpu"])


def test_cli_mesh_fsdp_matches_one_process(tmp_path):
    lr = 1e-5  # the v1 default
    one, mesh = tmp_path / "one", tmp_path / "mesh"
    _run(one, "--mode", "v1")
    _run(mesh, "--mode", "v1", "--mesh", "2", "--fsdp")

    def losses(out):
        return [json.loads(ln)["loss"]
                for ln in (out / "metrics.jsonl").read_text().splitlines()]

    np.testing.assert_allclose(losses(mesh), losses(one), rtol=1e-4)
    # the gathered state loads into the one-process template ...
    cfg = tiny_v1_config()
    params = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    tx = AdamW(lr, labels=trainable_mask(params, "v1"))
    state = load_train_state(str(mesh / "state.npz"),
                             init_train_state(params, tx))
    assert state.step == 2 and state.opt_state["count"] == 2
    # ... within the post-Adam bound of the one-process run: 2 lr + slack
    # a step, two steps
    trained_one, trained_mesh = _trained(one), _trained(mesh)
    for family, sd in trained_one.items():
        for k, v in sd.items():
            d = np.abs(trained_mesh[family][k] - v)
            assert d.max() <= 2 * 2.1 * lr, (family, k, d.max())
