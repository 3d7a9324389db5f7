"""The port over a real mesh: ONE spawn of 4 gloo CPU processes (one torch
thread each), every rank running ``parallel.dryrun.world_rank``:

- v1, v2 and v1 + ControlNet at data 2 x model 2 against the one-process
  call of the port, uint8 max <= 2 (the JAX package's
  ``tests/test_sharded_pipeline.py`` bound), each rank returning the
  whole batch, the transformer blocks' attention run at 1 of the 2 heads,
  and ``submit()`` giving the call's images;
- a LoRA merged on that mesh against the same LoRA on one process: the
  images, and every rank's weights bit for bit its piece of the
  one-process weights after the merge, a new scale and the unload;
- a data-parallel v1 step at data 4 against the one-process step: loss
  rtol 1e-4 and the JAX post-Adam bound on the task-token rows
  (``tests/test_train.py``: max 2 lr + slack, 99% within 1e-5 + 1e-3 |b|);
- a ZeRO-3 step at data 4 against the data-parallel step (loss rtol 1e-5,
  the same update bound): each rank holds 1/4 of a large leaf, and the
  layout is kept after the step;
- a ``tensor_parallel=True`` step at data 2 x model 2 against the one
  process;
- the ZeRO-3 and the tensor-parallel state saved (gathered whole, rank 0
  writing the one-process file) and loaded back into a fresh placed
  state, every piece bit for bit;
- sequence parallelism (``dryrun.sp_checks``): the port's ring attention
  at data 4 and at data 2 x model 2 against the JAX package's
  ``ring_self_attention`` on 4 devices (``tests/test_ring_attention.py``'s
  shapes and bounds); GroupNorm, the fused and plain 3x3 convs and the
  cuDNN convs (SAME, both stride-2 paddings, 4x4 stride 2) on each rank's
  rows against the whole tensor; one int8 unit within the flip bound of
  ``tests/test_torch_int8_pipeline.py``; the tiny UNet at data 4
  (``min_seq`` 64: the top three levels ring, the deepest gathers)
  against the JAX UNet on one device (``tests/test_ring_unet.py``'s
  bound, at 32^2 latents, where every level splits four ways); v1, v2
  and v1 + ControlNet at 256^2 with ``sequence_parallel=True`` at data 4,
  and v1 with FreeU at 128^2 on data 2 x model 2, against the port's
  one-process call (uint8 max <= 2, every rank the whole image, submit()
  the same), each refusing a 64^2 canvas with the JAX message.

The one-process sides are held to the JAX package by
``tests/test_torch_pipeline*.py`` and ``tests/test_torch_train*.py``; the
JAX programs here are the ring (one compile each shape) and the tiny
UNet's forward (one compile).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from powerpaint_tpu.io.convert import convert_unet
from powerpaint_tpu.models.unet import UNet2DConditionModel as JaxUNet
from powerpaint_tpu.ops.ring_attention import ring_self_attention
from powerpaint_tpu.parallel.mesh import build_mesh as jax_build_mesh
from powerpaint_tpu.testing import tiny_v1_config as jax_tiny_v1_config
from powerpaint_tpu_torch.io.weights import init_state
from powerpaint_tpu_torch.parallel import dryrun
from powerpaint_tpu_torch.parallel.launch import spawn
from powerpaint_tpu_torch.testing import tiny_v1_config

RANKS = 4
# (B, S, N, D) of the ring checks: data 4 (tests/test_ring_attention.py's
# two shapes), then data 2 x model 2 (its model-parallel case)
RING_SHAPES = [(2, 512, 4, 16), (2, 256, 2, 8), (1, 256, 2, 8)]


def _ring_inputs():
    rng = np.random.RandomState(0)
    return [tuple(rng.randn(*shape).astype(np.float32) for _ in range(3))
            for shape in RING_SHAPES]


def _unet_inputs():
    rng = np.random.RandomState(1)
    return (rng.randn(2, 32, 32, 9).astype(np.float32),
            np.asarray([981, 501], np.int64),
            rng.randn(2, 77, 32).astype(np.float32))


def _jax_references() -> dict:
    """The JAX sides of the sequence-parallel checks: the ring on 4
    devices at each shape, and the tiny UNet on one device with the
    weights ``dryrun.unet_check`` draws."""
    refs = {"ring": []}
    for case, (q, k, v) in enumerate(_ring_inputs()):
        mesh = jax_build_mesh(jax.devices()[:RANKS],
                              model_parallel=2 if case == 2 else 1)
        with mesh:
            refs["ring"].append(np.asarray(jax.jit(
                lambda q, k, v: ring_self_attention(q, k, v, mesh=mesh))(
                    q, k, v)))
    state = init_state(tiny_v1_config(), torch.Generator().manual_seed(0),
                       device="cpu")
    params = convert_unet({k: v.numpy() for k, v in state["unet"].items()})
    sample, t, ctx = _unet_inputs()
    refs["unet"] = np.asarray(jax.jit(JaxUNet(jax_tiny_v1_config().unet,
                                              dtype=jnp.float32).apply)(
        {"params": params}, sample, t.astype(np.int32), ctx))
    return refs


JAX = {}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' results; the JAX references are computed here while the
    ranks run (into ``JAX``)."""
    devices = ["cpu"] * RANKS
    workdir = str(tmp_path_factory.mktemp("world"))
    box = {}

    def run():
        try:
            box["ranks"] = spawn(
                dryrun.world_rank, devices,
                (devices, "gloo", workdir, _ring_inputs(), _unet_inputs()),
                threads=1, timeout=600)
        except BaseException as e:  # raised in the test's thread below
            box["error"] = e

    ranks = threading.Thread(target=run)
    ranks.start()
    try:
        JAX.update(_jax_references())
    finally:
        ranks.join()
    if "error" in box:
        raise box["error"]
    return box["ranks"]


@pytest.mark.parametrize("kind", ["v1", "v2", "cn"])
def test_pipelines_over_data_and_model_match_one_process(world, kind):
    for r in world:
        got = r[kind]
        assert got["shape"] == [2, 32, 32, 3]
        assert got["max"] <= dryrun.U8_MAX, got
        # two heads split two ways: every attention ran one head a rank
        assert {n for n, _ in got["attention_shapes"]} == {1}
        assert got["submit_equal"]  # submit() on the mesh: the same images


def test_every_rank_returns_the_same_images(world):
    for kind in ("v1", "v2", "cn", "lora"):
        assert len({(r[kind]["max"], r[kind]["mean"]) for r in world}) == 1


def test_lora_merged_on_the_mesh_matches_one_process(world):
    for r in world:
        got = r["lora"]
        assert got["unmatched"] == [0, 0]
        assert got["merged"] and got["rescaled"] and got["unloaded"]
        assert got["max"] <= dryrun.U8_MAX, got


def _update_within_bound(update):
    assert update["max"] <= dryrun.STEP_MAX, update
    assert update["tight"] >= dryrun.TIGHT_SHARE, update


@pytest.mark.parametrize("mode", ["dp", "tp"])
def test_train_step_matches_one_process(world, mode):
    for r in world:
        got = r[mode]
        np.testing.assert_allclose(got["loss"], got["ref_loss"],
                                   rtol=dryrun.LOSS_RTOL)
        _update_within_bound(got["update"])
        assert np.isfinite(got["grad_norm"])


def test_tensor_parallel_step_holds_pieces(world):
    for r in world:
        assert r["tp"]["bytes_at_rest"] < r["tp"]["whole_bytes"]
        assert r["dp"]["bytes_at_rest"] == r["dp"]["whole_bytes"]


@pytest.mark.parametrize("mode", ["zero3", "tp"])
def test_a_placed_state_saves_whole_and_loads_back_into_its_pieces(world, mode):
    assert all(r[mode]["resumed_equal"] for r in world)


def test_zero3_step_matches_the_data_parallel_step(world):
    for r in world:
        z, dp = r["zero3"], r["dp"]
        np.testing.assert_allclose(z["loss"], dp["loss"], rtol=1e-5)
        np.testing.assert_allclose(z["grad_norm"], dp["grad_norm"], rtol=1e-5)
        _update_within_bound(z["vs_dp"])
        assert z["big_share"] == 1 / RANKS
        assert z["layout_kept"]
        # the large leaves' parameters and moments: a quarter a rank
        assert z["bytes_at_rest"] * RANKS == z["whole_bytes"]


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", range(len(RING_SHAPES)),
                         ids=["data4_512x4x16", "data4_256x2x8",
                              "data2_model2_256x2x8"])
def test_ring_attention_matches_the_jax_ring(world, case):
    want = JAX["ring"][case]
    for r in world:
        got = r["ring_tp"] if case == 2 else r["ring"][case]
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("op", ["group_norm", "conv3x3_gn_silu", "conv3x3",
                                "conv2d_3x3", "downsample_pad1",
                                "vae_downsample", "conv2d_4x4_s2"])
def test_row_split_ops_match_the_whole_tensor(world, op):
    for r in world:
        assert r["ops"][op] <= 1e-5, (op, r["ops"][op])


def test_an_int8_unit_on_rows_matches_the_unit_whole(world):
    for r in world:
        u = r["ops"]["int8"]
        t = {k: torch.from_numpy(v) for k, v in u.items()}
        err, ok, _ = chip_smoke.int8_check(
            t["got"], t["want"], t["x"], t["w_q"], t["w_s"], t["bias"], True,
            (t["gamma"], t["beta"]), 32, 8.0 / 127.0)
        assert ok, f"max |err| {err} beyond the flip bound"


def test_unet_on_rows_matches_the_jax_unet_on_one_device(world):
    for r in world:
        np.testing.assert_allclose(r["unet"], JAX["unet"], atol=2e-4,
                                   rtol=2e-4)


SP_KINDS = ["v1", "v2", "cn", "tp"]  # rank i runs kind i's one process


@pytest.mark.parametrize("kind", SP_KINDS)
def test_sequence_parallel_pipelines_match_one_process(world, kind):
    hw = 128 if kind == "tp" else 256
    ref = world[SP_KINDS.index(kind)]["sp_" + kind]
    assert ref["max"] <= dryrun.U8_MAX, ref
    for r in world:
        got = r["sp_" + kind]["image"]
        assert got.shape == (1, hw, hw, 3)  # every rank: the whole image
        assert np.array_equal(got, ref["image"])
    assert all(r["sp_v1"]["submit_equal"] for r in world)


@pytest.mark.parametrize("kind", ["v1", "v2", "cn", "tp"])
def test_sequence_parallel_refuses_a_canvas_that_does_not_split(world, kind):
    n = 2 if kind == "tp" else RANKS
    for r in world:
        msg = r["sp_" + kind]["refused"]
        assert msg is not None and msg.startswith("sequence_parallel: image "
                                                  "height 64"), msg
        assert f"{n}-way mesh axis" in msg
