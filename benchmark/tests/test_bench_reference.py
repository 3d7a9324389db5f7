"""The plain reference against the served system at the tiny configurations
on the CPU (float32 on both sides), and its parameter names against the
served system's, at the tiny and the published sizes."""

import numpy as np
import pytest
import torch

from benchmark.reference.models import load
from benchmark.reference.pipelines import generate
from benchmark.traffic import Traffic, reference_request
from benchmark.weights import families_on_meta, make_state
from powerpaint_tpu_torch.core.config import ppt_v1_config, ppt_v2_config
from powerpaint_tpu_torch.io.weights import build_models
from powerpaint_tpu_torch.pipelines.brushnet import BrushNetPipeline
from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline
from powerpaint_tpu_torch.testing import tiny_v1_config, tiny_v2_config
from powerpaint_tpu_torch.text.tokenizer import HashTokenizer, TokenizerWrapper, add_task_tokens

TASKS = ("text-guided", "shape-guided", "object-removal", "image-outpainting")


def _mix(task):
    spec = {"loop": "closed", "clients": 2, "image": [64, 64], "outpaint": None,
            "mask": {"kinds": ["rect", "stroke"], "cover": [0.1, 0.5]}, "task": task,
            "num_inference_steps": 4, "guidance_scale": 7.5, "negative_prompt": "",
            "prompts": ["a red bench", "two cats on a sofa"], "fitting_degree": [0.0, 1.0],
            "pool": 4}
    if task == "image-outpainting":
        spec.update(image=[48, 48], outpaint=[1.5, 1.5])
    return spec


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("version", ["ppt-v1", "ppt-v2"])
def test_reference_is_the_served_batch_request_by_request(version, task):
    cfg = tiny_v1_config() if version == "ppt-v1" else tiny_v2_config()
    pipe_cls, sampler = ((InpaintPipeline, "ddim") if version == "ppt-v1"
                         else (BrushNetPipeline, "unipc"))
    d = cfg.to_dict()
    state = make_state(d, 2 ** 31 + 5, "cpu", dtype=torch.float32)
    tok = TokenizerWrapper(HashTokenizer(cfg.text_encoder.vocab_size))
    add_task_tokens(tok)
    pipe = pipe_cls(cfg, {f: {k: v.clone() for k, v in s.items()} for f, s in state.items()},
                    tok, dtype=torch.float32, device="cpu")
    traffic = Traffic(_mix(task), 77, sampler)
    reqs = [traffic.request(c, i) for c in range(2) for i in range(2)]
    per = {k: [r["kwargs"][k] for r in reqs]
           for k in ("prompt", "negative_prompt", "fitting_degree", "guidance_scale", "seed")}
    out = pipe([r["image"] for r in reqs], [r["mask"] for r in reqs], task=task,
               num_inference_steps=4, scheduler=sampler, **per)
    models = {f: load(m, state[f], "cpu") for f, m in families_on_meta(d).items()}
    for i, r in enumerate(reqs):
        ref = generate(models, d, reference_request(r), "cpu")
        diff = np.abs(out[i].astype(int) - ref.astype(int))
        # float32 on both sides: only the last rounding to uint8 may differ
        assert diff.max() <= 1 and diff.mean() < 0.01, (i, diff.max(), diff.mean())
        assert ref.std() > 20  # an image, not a flat field


@pytest.mark.parametrize("make", [tiny_v1_config, tiny_v2_config, ppt_v1_config, ppt_v2_config])
def test_reference_parameters_are_the_served_systems(make):
    cfg = make()
    ours = families_on_meta(cfg.to_dict())
    theirs = build_models(cfg)
    assert set(ours) == set(theirs)
    for family in ours:
        a = {k: tuple(v.shape) for k, v in ours[family].named_parameters()}
        b = {k: tuple(v.shape) for k, v in theirs[family].named_parameters()}
        assert a == b, family
