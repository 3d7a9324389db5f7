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
  state, every piece bit for bit.

The one-process sides are held to the JAX package by
``tests/test_torch_pipeline*.py`` and ``tests/test_torch_train*.py``; no
JAX program compiles here.
"""

import numpy as np
import pytest

from powerpaint_tpu_torch.parallel import dryrun
from powerpaint_tpu_torch.parallel.launch import spawn

RANKS = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    devices = ["cpu"] * RANKS
    workdir = str(tmp_path_factory.mktemp("world"))
    return spawn(dryrun.world_rank, devices, (devices, "gloo", workdir),
                 threads=1, timeout=600)


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
