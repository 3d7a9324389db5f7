"""The control of the correctness check, on the card at each cell's own size
(canvas, steps, sample): the plain reference computed in fp8
(``reference.lowp``) put in the served system's place must come out not
correct under the cell's limits, on three seeds. Card only:

    python -m pytest --noconftest -m cuda benchmark/tests/test_bench_control_cuda.py
"""

import json
from pathlib import Path

import pytest
import torch

from benchmark import run as harness
from benchmark.check import reference_images, worst
from benchmark.traffic import Traffic
from benchmark.weights import make_state

ROOT = Path(__file__).resolve().parents[2]
SPEC = harness.load_spec(ROOT)
CELLS = [w["name"] for w in SPEC["workloads"]]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


def _load(*parts):
    return json.loads(ROOT.joinpath("benchmark", *parts).read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_fp8_reference_in_the_served_systems_place_is_not_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    wl = next(w for w in SPEC["workloads"] if w["name"] == workload)
    config_file = _load("configs", f"{wl['config']}.json")
    mix = _load("traffic", f"{wl['traffic']}.json")
    limits = _load("limits", f"{workload}.json")
    for seed in SEEDS:
        state = make_state(config_file["config"], seed, "cuda")
        traffic = Traffic(mix, seed, config_file["default_scheduler"])
        reqs = [traffic.request(c, 0) for c in range(int(limits["sample"]))]
        ref = reference_images(config_file["config"], state, "cuda", reqs)
        ctl = reference_images(config_file["config"], state, "cuda", reqs, control=True)
        numbers = worst(list(zip(ctl, ref)), limits)
        print(workload, seed, json.dumps(numbers))
        assert any(v["value"] > v["limit"] for v in numbers.values()), numbers
        del state
        torch.cuda.empty_cache()
