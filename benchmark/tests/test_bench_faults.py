"""The harness driven end to end on the CPU at the tiny configurations (its
look for a card skipped), once sound and once with the timed path broken
underneath in each way a serving cell can break: a sampler step that
returns its state unchanged, half of a batch left out (the other half's
images handed back for it), and each answer altered where it is produced.
A sound run must come out correct, and a broken one not, under the cells'
own limits. A mix that only files describe (an open loop with bursts, two
tasks in one queue) runs through the same harness."""

import copy
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import run as harness
from powerpaint_tpu_torch.testing import tiny_v1_config, tiny_v2_config

ROOT = Path(__file__).resolve().parents[2]
SPEC = harness.load_spec(ROOT)
CELLS = [w["name"] for w in SPEC["workloads"]]
SEED = 2 ** 31 + 41


def shrink(monkeypatch, extra_traffic=None, limits_of=None):
    """Serve the tiny configurations at a small canvas, 4 clients and 3
    steps, by way of the harness's file loader; ``extra_traffic``: mixes
    by name that no file holds; ``limits_of``: limits files by name."""
    real = harness._json

    def small(relative):
        name = Path(relative).stem
        if relative.startswith("benchmark/traffic/") and name in (extra_traffic or {}):
            d = copy.deepcopy(extra_traffic[name])
        elif relative.startswith("benchmark/limits/") and name in (limits_of or {}):
            d = real(f"benchmark/limits/{limits_of[name]}.json")
        else:
            d = real(relative)
        if relative.startswith("benchmark/configs/"):
            d["config"] = (tiny_v2_config() if d["config"].get("brushnet")
                           else tiny_v1_config()).to_dict()
        elif relative.startswith("benchmark/traffic/"):
            d.update(num_inference_steps=3)
            if d["loop"] == "closed":
                d["clients"] = 4
            for e in [d] + d.get("tasks", []):
                if "image" in e:
                    e["image"] = [48, 48] if e.get("outpaint") else [64, 64]
        return d

    monkeypatch.setattr(harness, "_json", small)


def pipeline_class(workload):
    wl = next(w for w in SPEC["workloads"] if w["name"] == workload)
    cfg = harness._json(next(c for c in SPEC["configs"] if c["name"] == wl["config"])["file"])
    module, cls = cfg["pipeline"].rsplit(".", 1)
    return getattr(importlib.import_module(module), cls)


class _Pending:
    def __init__(self, fn):
        self.result = fn


def unchanged_step(monkeypatch, cls):
    monkeypatch.setattr(sys.modules[cls.__module__], "sampler_step",
                        lambda mod, sched, state, eps, i, latents, *a: (latents, state))


def half_batch(monkeypatch, cls):
    submit = cls.submit

    def broken(self, image, mask, **kw):
        if not isinstance(image, list) or len(image) < 2:
            return submit(self, image, mask, **kw)
        k = (len(image) + 1) // 2
        kw = {n: v[:k] if isinstance(v, list) else v for n, v in kw.items()}
        pending = submit(self, image[:k], mask[:k], **kw)
        return _Pending(lambda: np.concatenate([pending.result()] * 2)[:len(image)])

    monkeypatch.setattr(cls, "submit", broken)


def altered_answer(monkeypatch, cls):
    submit = cls.submit

    def broken(self, image, mask, **kw):
        pending = submit(self, image, mask, **kw)
        return _Pending(lambda: pending.result()[..., ::-1].copy())

    monkeypatch.setattr(cls, "submit", broken)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload, monkeypatch):
    shrink(monkeypatch)
    out = harness.run_cell(SPEC, workload, SEED, 3.0, False, "cpu")
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) >= {"images_per_s", "setup_s"}
    assert list(out)[-1] == "check"


@pytest.mark.parametrize("fault", [unchanged_step, half_batch, altered_answer])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    shrink(monkeypatch)
    fault(monkeypatch, pipeline_class(workload))
    out = harness.run_cell(SPEC, workload, SEED, 3.0, False, "cpu")
    assert not out["correct"], out["check"]


OPEN_MIXED = {
    "loop": "open",
    "arrivals": {"process": "poisson", "rate": 6.0, "burst": 2},
    "server": {"max_batch": 2, "window_ms": 10.0},
    "image": [512, 512],
    "mask": {"kinds": ["rect", "stroke"], "cover": [0.1, 0.5]},
    "num_inference_steps": 20, "guidance_scale": 7.5, "scheduler": None,
    "negative_prompt": "", "prompts": ["a red bench", "a lamp"], "fitting_degree": [0.0, 1.0],
    "tasks": [{"task": "text-guided", "weight": 2},
              {"task": "image-outpainting", "weight": 1, "image": [512, 512],
               "outpaint": [1.5, 1.5], "prompts": [""]}],
    "pool": 4,
}


def test_a_mix_of_files_alone_runs_open_loop_and_mixed_tasks(monkeypatch):
    """A new cell as a later change would add it: a ``workloads`` entry, a
    traffic file and a limits file, and no code."""
    spec = copy.deepcopy(SPEC)
    spec["workloads"].append({"name": "ppt-v1.open-mixed", "config": "ppt-v1",
                              "traffic": "open-mixed", "chips": 1, "why": "test"})
    shrink(monkeypatch, {"open-mixed": OPEN_MIXED}, {"ppt-v1.open-mixed": "ppt-v1.serve-512"})
    out = harness.run_cell(spec, "ppt-v1.open-mixed", SEED, 3.0, False, "cpu")
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["metrics"]["images_per_s"]["value"] > 0
