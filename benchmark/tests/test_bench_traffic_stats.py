"""The traffic generator and the end-to-end arithmetic, on the CPU."""

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark import stats
from benchmark.traffic import SERVER_DEFAULTS, Traffic

ROOT = Path(__file__).resolve().parents[1]
MIXES = sorted(p.stem for p in (ROOT / "traffic").glob("*.json"))
SEED = 2 ** 31 + 977


def mix(name):
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_the_same_seed_gives_the_same_requests(name):
    a, b = Traffic(mix(name), SEED, "ddim"), Traffic(mix(name), SEED, "ddim")
    for c, i in ((0, 0), (3, 7), (7, 2)):
        ra, rb = a.request(c, i), b.request(c, i)
        assert np.array_equal(ra["image"], rb["image"])
        assert np.array_equal(ra["mask"], rb["mask"])
        assert ra["kwargs"] == rb["kwargs"]


@pytest.mark.parametrize("name", MIXES)
def test_seeds_change_contents_and_keep_the_work(name):
    a, b = Traffic(mix(name), SEED, "ddim"), Traffic(mix(name), SEED + 1, "ddim")
    ra, rb = a.request(1, 1), b.request(1, 1)
    assert not np.array_equal(ra["image"], rb["image"])
    assert ra["kwargs"]["seed"] != rb["kwargs"]["seed"]
    assert ra["image"].shape == rb["image"].shape == (*a.canvases()[0], 3)
    for key in ("task", "num_inference_steps", "guidance_scale", "scheduler"):
        assert ra["kwargs"][key] == rb["kwargs"][key]


def test_masks_cover_what_the_mix_says():
    spec = mix("closed8-512-text")
    lo, hi = spec["mask"]["cover"]
    t = Traffic(spec, SEED, "ddim")
    covers = [float((m >= 0.5).mean()) for m in t.pools[0][1]]
    assert min(covers) >= lo * 0.9 and max(covers) <= hi * 1.25


def test_the_outpainting_canvas():
    t = Traffic(mix("closed8-768-outpaint"), SEED, "ddim")
    r = t.request(0, 0)
    assert t.canvases() == [(768, 768)] and r["image"].shape == (768, 768, 3)
    m = r["mask"]
    assert m[0, 0] == 1 and m[384, 384] == 0
    # the hole reaches 10 pixels into the image on each side
    assert m[128 + 9, 384] == 1 and m[128 + 10, 384] == 0
    assert (r["image"][:128] == 127).all()


def test_percentile_is_the_nearest_rank():
    values = list(range(1, 101))
    assert stats.percentile(values, 90) == 90
    assert stats.percentile([3.0], 90) == 3.0
    assert stats.percentile([5, 1, 4, 2, 3], 90) == 5


def test_rate_and_tail_over_every_request_with_a_stall():
    # 40 fast requests, then a 5-second stall in which one request waits,
    # in a 10-second window
    reqs = [(0.1 * k, 0.1 * k + 0.5, True) for k in range(40)]
    reqs.append((4.0, 9.5, True))
    reqs.append((4.0, 9.9, False))  # failed: not completed
    reqs.append((9.0, 10.5, True))  # back after the window
    assert stats.rate(reqs, 0.0, 10.0) == pytest.approx(41 / 10.0)
    assert stats.latency_percentile(reqs, 0.0, 10.0, 90) == pytest.approx(0.5)
    assert stats.latency_percentile(reqs, 0.0, 10.0, 99) == pytest.approx(5.5)



def test_a_request_done_as_the_window_opens_is_not_in_it():
    reqs = [(0.0, 1.0, True), (0.5, 2.0, True), (1.0, 3.0, True)]
    assert stats.rate(reqs, 1.0, 3.0) == pytest.approx(2 / 2.0)
    assert [r[1] for r in stats.completed(reqs, 1.0, 3.0)] == [2.0, 3.0]


@pytest.mark.parametrize("name", MIXES)
def test_the_mixes_state_the_servers_defaults(name):
    t = Traffic(mix(name), SEED, "ddim")
    assert t.server == SERVER_DEFAULTS == {"max_batch": 4, "window_ms": 20.0,
                                           "pipeline_depth": 2, "int8": False}


def _open(process, burst=1):
    spec = mix("closed8-512-text")
    spec.update(loop="open", arrivals={"process": process, "rate": 4.0, "burst": burst})
    return spec


def _first(it, n):
    return [next(it) for _ in range(n)]


def test_open_arrivals_send_the_same_gaps_in_another_order_per_seed():
    a = np.array(_first(Traffic(_open("poisson"), SEED, "ddim").arrivals(), 513))
    b = np.array(_first(Traffic(_open("poisson"), SEED + 1, "ddim").arrivals(), 513))
    again = np.array(_first(Traffic(_open("poisson"), SEED, "ddim").arrivals(), 513))
    assert np.array_equal(a, again)
    ga, gb = np.diff(a)[:256], np.diff(b)[:256]
    assert not np.array_equal(ga, gb)
    assert np.allclose(np.sort(ga), np.sort(gb))
    assert a[-1] / 512 == pytest.approx(1 / 4.0, rel=0.15)


def test_bursts_and_a_uniform_process():
    t = _first(Traffic(_open("uniform", burst=3), SEED, "ddim").arrivals(), 9)
    assert t == pytest.approx([0, 0, 0, 0.75, 0.75, 0.75, 1.5, 1.5, 1.5])


def test_a_mix_of_tasks_draws_each_by_its_weight():
    spec = mix("closed8-512-text")
    spec["tasks"] = [{"task": "text-guided", "weight": 3},
                     {"task": "image-outpainting", "weight": 1, "outpaint": [1.5, 1.5]}]
    t = Traffic(spec, SEED, "ddim")
    assert t.canvases() == [(512, 512), (768, 768)]
    reqs = [t.request(c, i) for c in range(8) for i in range(50)]
    outpaint = [r for r in reqs if r["kwargs"]["task"] == "image-outpainting"]
    assert 0.18 < len(outpaint) / len(reqs) < 0.32
    assert all(r["image"].shape == (768, 768, 3) for r in outpaint)
    assert Traffic(spec, SEED, "ddim").request(3, 7)["kwargs"] == t.request(3, 7)["kwargs"]
