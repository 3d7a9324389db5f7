"""The port's host-side copies against the JAX package's originals: config,
prompts and tokenizers, pre- and post-processing, and the call validators.
The port keeps its own copies (it may not import ``powerpaint_tpu``), so
these tests pin each copy to the module it was taken from, on the same
inputs."""

import json

import numpy as np
import pytest

from powerpaint_tpu import testing as jax_testing
from powerpaint_tpu.core import config as jax_config
from powerpaint_tpu.core import validation as jax_validation
from powerpaint_tpu.pipelines.common import check_output_type as jax_check_output_type
from powerpaint_tpu.tasks import postprocess as jax_post
from powerpaint_tpu.tasks import preprocess as jax_pre
from powerpaint_tpu.text import prompts as jax_prompts
from powerpaint_tpu.text import tokenizer as jax_tok
from powerpaint_tpu_torch import testing
from powerpaint_tpu_torch.core import config, validation
from powerpaint_tpu_torch.tasks import postprocess, preprocess
from powerpaint_tpu_torch.text import prompts, tokenizer

PROMPTS = [("a red bench in a park", ""), ("", "blurry, low quality"),
           ("A Cat, sitting!  on a sofa", "dog")]


def _common_fields(ours: dict, theirs: dict) -> dict:
    """``theirs`` restricted to the keys the port's config has, nested."""
    out = {}
    for k, v in ours.items():
        out[k] = (_common_fields(v, theirs[k]) if isinstance(v, dict)
                  else theirs[k])
    return out


@pytest.mark.parametrize("ours,theirs", [
    (config.ppt_v1_config, jax_config.ppt_v1_config),
    (testing.tiny_v1_config, jax_testing.tiny_v1_config),
    (config.ppt_v2_config, jax_config.ppt_v2_config),
    (testing.tiny_v2_config, jax_testing.tiny_v2_config),
], ids=["ppt_v1", "tiny_v1", "ppt_v2", "tiny_v2"])
def test_config_copy_matches(ours, theirs):
    a = ours().to_dict()
    assert a == _common_fields(a, theirs().to_dict())
    # a config serialized by the JAX package loads in the port
    assert config.PowerPaintConfig.from_json(theirs().to_json()) == ours()


@pytest.mark.parametrize("version", ["ppt-v1", "ppt-v2"])
@pytest.mark.parametrize("task", prompts.TASKS)
def test_add_task_matches(task, version):
    assert prompts.TASKS == jax_prompts.TASKS
    for p, n in PROMPTS:
        ours = prompts.add_task(p, n, task, version)
        theirs = jax_prompts.add_task(p, n, task, version)
        assert (ours.promptA, ours.promptB, ours.negative_promptA,
                ours.negative_promptB) == (
            theirs.promptA, theirs.promptB, theirs.negative_promptA,
            theirs.negative_promptB)
        assert prompts.v2_prompt_suffix(p, task) == \
            jax_prompts.v2_prompt_suffix(p, task)


@pytest.mark.parametrize("task", prompts.TASKS)
def test_task_token_ids_match(task):
    ours = tokenizer.TokenizerWrapper(tokenizer.HashTokenizer(994))
    tokenizer.add_task_tokens(ours)
    theirs = jax_tok.TokenizerWrapper(jax_tok.HashTokenizer(994))
    jax_tok.add_task_tokens(theirs)
    for p, n in PROMPTS:
        tp = prompts.add_task(p, n, task)
        rows = [tp.promptA, tp.promptB, tp.negative_promptA, tp.negative_promptB]
        np.testing.assert_array_equal(ours(rows), theirs(rows))


def test_clip_bpe_matches_on_a_synthetic_vocab(tmp_path):
    b2u = tokenizer.bytes_to_unicode()
    assert b2u == jax_tok.bytes_to_unicode()
    vocab = {}
    for c in (b2u[ord(ch)] for ch in "abcdehlotw"):
        vocab[c] = len(vocab)
        vocab[c + "</w>"] = len(vocab)
    for merged in ["he", "lo</w>", "llo</w>", "hello</w>", "cat</w>", "at</w>"]:
        vocab[merged] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    merges = [("h", "e"), ("l", "o</w>"), ("l", "lo</w>"), ("he", "llo</w>"),
              ("a", "t</w>"), ("c", "at</w>")]
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    ours = tokenizer.ClipBPETokenizer.from_dir(str(tmp_path))
    theirs = jax_tok.ClipBPETokenizer.from_dir(str(tmp_path))
    for text in ("hello cat", "Hello,  CAT!", "the cat sat", "", "wéird 中"):
        ids = ours.encode_text(text)
        assert ids == theirs.encode_text(text), text
        assert ours.decode_ids(ids) == theirs.decode_ids(ids)
    # the checkpoint-directory loader picks the BPE and takes the task rows
    ours_w = tokenizer.load_tokenizer(str(tmp_path))
    theirs_w = jax_tok.load_tokenizer(str(tmp_path))
    assert isinstance(ours_w.base, tokenizer.ClipBPETokenizer)
    tokenizer.add_task_tokens(ours_w)
    jax_tok.add_task_tokens(theirs_w)
    ids = ours_w(["hello cat P_obj", "P_ctxt hello"])
    np.testing.assert_array_equal(ids, theirs_w(["hello cat P_obj", "P_ctxt hello"]))
    assert ours_w.decode(ids[0]) == theirs_w.decode(ids[0]) == "hello cat P_obj"


def _image_and_mask(h=40, w=56, seed=0):
    rng = np.random.RandomState(seed)
    image = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    mask = np.zeros((h, w), np.float32)
    mask[h // 4:3 * h // 4, w // 5:w // 2] = 1.0
    return image, mask


@pytest.mark.parametrize("name,args", [
    ("to_numpy_image", lambda im, m: (im,)),
    ("to_numpy_image", lambda im, m: (im[..., 0].astype(np.float32) / 255,)),
    ("to_numpy_mask", lambda im, m: (m * 255,)),
    ("to_numpy_mask", lambda im, m: (np.stack([m] * 3, -1),)),
    ("resize_short_side", lambda im, m: (im, 32)),
    ("pad_to_bucket", lambda im, m: (im, m, 64)),
    ("crop_to_multiple_of_8", lambda im, m: (im[:, :50],)),
    ("outpaint_canvas", lambda im, m: (im, 1.5, 1.0)),
    ("outpaint_canvas", lambda im, m: (im, 1.0, 2.0, 4)),
    ("prepare_inpaint_inputs", lambda im, m: (im, m)),
    ("premask_image_v2", lambda im, m: (im, m)),
    ("resize_to", lambda im, m: (im, m, 48, 64)),
])
def test_preprocess_matches(name, args):
    image, mask = _image_and_mask()
    ours = getattr(preprocess, name)(*args(image, mask))
    theirs = getattr(jax_pre, name)(*args(image, mask))
    if not isinstance(ours, tuple):
        ours, theirs = (ours,), (theirs,)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name,args", [
    ("gaussian_blur", lambda im, m: (m, 3.0)),
    ("blend_result", lambda im, m: (im[::-1].copy(), im, m)),
    ("red_overlay", lambda im, m: (im, m, 0.4)),
    ("latents_image_to_uint8",
     lambda im, m: (im[None].astype(np.float32) / 100 - 1.2,)),
])
def test_postprocess_matches(name, args, monkeypatch):
    # the port has only the numpy path; the JAX package may take its C++ one
    from powerpaint_tpu.tasks import native

    monkeypatch.setattr(native, "native_available", lambda: False)
    image, mask = _image_and_mask(seed=1)
    np.testing.assert_array_equal(getattr(postprocess, name)(*args(image, mask)),
                                  getattr(jax_post, name)(*args(image, mask)))


@pytest.mark.parametrize("check,kwargs", [
    ("check_call_args", dict(task="paint", num_inference_steps=20,
                             guidance_scale=7.5)),
    ("check_call_args", dict(task="text-guided", num_inference_steps=0,
                             guidance_scale=7.5)),
    ("check_call_args", dict(task="text-guided", num_inference_steps=20,
                             guidance_scale=-1.0)),
    ("check_call_args", dict(task="text-guided", num_inference_steps=20,
                             guidance_scale=7.5, strength=1.5)),
    ("check_call_args", dict(task="text-guided", num_inference_steps=20,
                             guidance_scale=7.5, fitting_degree=-0.1)),
    ("check_call_args", dict(task="object-removal", num_inference_steps=45,
                             guidance_scale=0.0, strength=0.3)),
    ("check_call_args", dict(task="text-guided", num_inference_steps=20,
                             guidance_scale=7.5, control_guidance_start=0.6,
                             control_guidance_end=0.4)),
    ("check_call_args", dict(task="text-guided", num_inference_steps=20,
                             guidance_scale=7.5, control_guidance_end=1.2)),
    ("check_call_args", dict(task="shape-guided", num_inference_steps=20,
                             guidance_scale=7.5, control_guidance_start=0.1,
                             control_guidance_end=0.5)),
    ("check_clip_skip", dict(clip_skip=12, num_hidden_layers=12)),
    ("check_clip_skip", dict(clip_skip=11, num_hidden_layers=12)),
    ("check_image_mask", dict(image=np.zeros((64, 60, 3)), mask=np.zeros((64, 60)))),
    ("check_image_mask", dict(image=np.zeros((64, 64, 3)), mask=np.zeros((64, 56)))),
    ("check_image_mask", dict(image=np.zeros((64, 64)), mask=np.zeros((64, 64)))),
    ("check_image_mask", dict(image=np.zeros((64, 64, 3)), mask=np.zeros((64, 64)))),
])
def test_validators_agree(check, kwargs):
    def outcome(fn):
        try:
            fn(**kwargs)
        except ValueError as e:
            return type(e).__name__, str(e)
        return None

    assert outcome(getattr(validation, check)) == \
        outcome(getattr(jax_validation, check))


@pytest.mark.parametrize("output_type", ["uint8", "float32", "latent", "pil", "np"])
def test_output_type_check_agrees(output_type):
    def outcome(fn):
        try:
            fn(output_type)
        except ValueError as e:
            return str(e)
        return None

    assert outcome(validation.check_output_type) == \
        outcome(jax_check_output_type)
