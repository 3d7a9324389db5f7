"""The port's LoRA and textual inversion (``powerpaint_tpu_torch.io.lora``,
``io.convert.load_textual_inversion``) against the JAX package's
``parse_lora``, ``merge_lora`` and ``load_textual_inversion``.

One set of tiny ppt-v1 weights: the port's random state, made JAX trees by
the JAX package's converters; each JAX result is a numpy tree carried back
by ``params_from_jax``. A LoRA file in each key format of ``_SUFFIXES``
covers UNet attention, feed-forward and 1x1 projections, a ResNet conv
(LoCon), two CLIP projections, and modules that must stay unmatched (one
not in the model, a norm, the ``text_encoder_2`` target). No JAX pipeline
is called.
"""

import numpy as np
import pytest
import torch

from powerpaint_tpu.io import convert as jax_convert
from powerpaint_tpu.io import lora as jax_lora
from powerpaint_tpu.text.tokenizer import HashTokenizer as JaxHashTokenizer
from powerpaint_tpu.text.tokenizer import TokenizerWrapper as JaxTokenizerWrapper
from powerpaint_tpu.text.tokenizer import add_task_tokens as jax_add_task_tokens
from powerpaint_tpu_torch.core.validation import InputValidationError
from powerpaint_tpu_torch.io import lora
from powerpaint_tpu_torch.io.safetensors import save_file
from powerpaint_tpu_torch.io.weights import init_state, load_models, params_from_jax
from powerpaint_tpu_torch.ops.conv import quantize_weights_int8
from powerpaint_tpu_torch.pipelines.brushnet import BrushNetPipeline
from powerpaint_tpu_torch.pipelines.controlnet import ControlNetPipeline
from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline
from powerpaint_tpu_torch.testing import (
    tiny_v1_config,
    tiny_v1_controlnet_config,
    tiny_v2_config,
)
from powerpaint_tpu_torch.text.tokenizer import (
    HashTokenizer,
    TokenizerWrapper,
    add_task_tokens,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def state():
    return init_state(tiny_v1_config(), torch.Generator().manual_seed(0),
                      device="cpu")


def _tok():
    tok = TokenizerWrapper(HashTokenizer(1024))
    add_task_tokens(tok)
    return tok


def _jax_tok():
    tok = JaxTokenizerWrapper(JaxHashTokenizer(1024))
    jax_add_task_tokens(tok)
    return tok


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _jax_params(state):
    return {"unet": jax_convert.convert_unet(_np(state["unet"])),
            "text_encoder": jax_convert.convert_clip_text(
                _np(state["text_encoder"]))}


BLOCK = "down_blocks.1.attentions.0.transformer_blocks.0"
UNET_MODULES = [f"{BLOCK}.attn1.to_q", f"{BLOCK}.attn2.to_k",
                f"{BLOCK}.attn1.to_out.0", f"{BLOCK}.ff.net.0.proj",
                f"{BLOCK}.ff.net.2", "down_blocks.1.attentions.0.proj_in",
                "up_blocks.2.resnets.1.conv1"]
TEXT_MODULES = ["text_model.encoder.layers.0.self_attn.q_proj",
                "text_model.encoder.layers.1.mlp.fc1"]
UNMATCHED = [("unet", "down_blocks.0.not_a_module", (4, 32)),
             ("unet", "down_blocks.0.resnets.0.norm1", (4, 32)),
             ("text_encoder_2", "text_model.encoder.layers.0.self_attn.k_proj",
              (4, 32))]


def _factors(shape, rank, seed):
    """down, up of a rank-``rank`` LoRA for a weight of ``shape``."""
    g = torch.Generator().manual_seed(seed)
    o, i = shape[0], shape[1]
    if len(shape) == 4:
        return (torch.randn(rank, i, *shape[2:], generator=g) / i ** 0.5,
                torch.randn(o, rank, 1, 1, generator=g) * 0.1)
    return (torch.randn(rank, i, generator=g) / i ** 0.5,
            torch.randn(o, rank, generator=g) * 0.1)


KOHYA = {"down": "lora_down.weight", "up": "lora_up.weight", "alpha": "alpha"}
PEFT = {"down": "lora_A.weight", "up": "lora_B.weight", "alpha": "alpha"}


def _key(fmt, target, module, kind):
    """The state-dict key of a LoRA factor (kind "down", "up" or "alpha")."""
    if fmt == "kohya":
        prefix = {"unet": "lora_unet_", "text_encoder": "lora_te_",
                  "text_encoder_2": "lora_te2_"}[target]
        return f"{prefix}{module.replace('.', '_')}.{KOHYA[kind]}"
    if fmt == "attn_processor" and target == "unet":
        m = module.rsplit(".", 1)
        proj = module.split(".")[-1]
        if proj in ("to_q", "to_k", "to_v"):
            return f"{m[0]}.processor.{proj}_lora.{kind}.weight"
        if module.endswith("to_out.0"):
            base = module[: -len(".to_out.0")]
            return f"{base}.processor.to_out_lora.{kind}.weight"
        return f"{module}.lora.{kind}.weight"  # a bare path: the UNet's
    if fmt == "peft":
        return f"{target}.{module}.{PEFT[kind]}"
    return f"{target}.{module}.lora.{kind}.weight"  # ".lora.down.weight"


FORMATS = ["peft", "attn_processor", "kohya", "lora_dot"]


def make_lora(fmt, models, rank=4, alpha=2.0):
    """A LoRA state dict in format ``fmt`` over ``UNET_MODULES``,
    ``TEXT_MODULES`` and ``UNMATCHED`` (alpha where the format has it)."""
    sd = {}
    entries = ([("unet", m, tuple(models["unet"].get_submodule(m).weight.shape))
                for m in UNET_MODULES]
               + [("text_encoder", m,
                   tuple(models["text_encoder"].get_submodule(m).weight.shape))
                  for m in TEXT_MODULES] + UNMATCHED)
    for n, (target, module, shape) in enumerate(entries):
        if fmt == "attn_processor" and target != "unet":
            target_fmt = "peft"  # the old format has no text-encoder spelling
        else:
            target_fmt = fmt
        down, up = _factors(shape, rank, seed=n)
        sd[_key(target_fmt, target, module, "down")] = down
        sd[_key(target_fmt, target, module, "up")] = up
        if target_fmt in ("peft", "kohya"):
            sd[_key(target_fmt, target, module, "alpha")] = torch.tensor(alpha)
    return sd


def _copy(state):
    """The pipelines take the state's tensors as their weights where the
    device and dtype agree, and a merge updates weights in place: each
    model here gets its own copy."""
    return {f: {k: v.clone() for k, v in sd.items()} for f, sd in state.items()}


def _models(state):
    return load_models(tiny_v1_config(), _copy(state), device="cpu",
                       dtype=torch.float32)


def _targets(models):
    return {t: models[t] for t in lora.TARGETS}


@pytest.mark.parametrize("fmt", FORMATS)
def test_parse_lora_matches_jax(state, fmt):
    sd = make_lora(fmt, _models(state))
    got = lora.parse_lora(sd)
    want = jax_lora.parse_lora(_np(sd))
    assert list(got) == list(want)
    for key, rec in want.items():
        assert got[key]["alpha"] == rec["alpha"]
        for kind in ("down", "up"):
            np.testing.assert_array_equal(got[key][kind].numpy(), rec[kind])


def _unmatched_modules(unmatched):
    """``target:base`` of each unmatched entry (the note after it names
    each package's own path)."""
    return [u.split(" ")[0] for u in unmatched]


@pytest.mark.parametrize("fmt", FORMATS)
def test_merge_matches_jax(state, fmt):
    """The merged weights within 1e-6 of the JAX merge's, every other weight
    untouched, the same modules unmatched."""
    models = _models(state)
    sd = make_lora(fmt, models)
    unmatched = lora.merge_lora(_targets(models), sd, 0.7)
    merged, jax_unmatched = jax_lora.merge_lora(_jax_params(state), _np(sd), 0.7)
    assert _unmatched_modules(unmatched) == _unmatched_modules(jax_unmatched)
    # the JAX tree has no "mlp" level, and its kohya matching no alias for
    # one: a kohya text-encoder LoRA's mlp_fc1 matches nothing in either
    mlp = int(fmt == "kohya")
    assert len(unmatched) == len(UNMATCHED) + mlp
    changed = 0
    for target in lora.TARGETS:
        want = params_from_jax(merged[target], target)
        for k, v in models[target].state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=1e-6,
                                       err_msg=k)
            changed += not np.array_equal(v.numpy(), state[target][k].numpy())
    assert changed == len(UNET_MODULES) + len(TEXT_MODULES) - mlp


def test_lora_shape_mismatch_raises_before_any_merge(state):
    models = _models(state)
    sd = make_lora("kohya", models)
    name = "lora_unet_" + UNET_MODULES[0].replace(".", "_")
    sd[name + ".lora_up.weight"] = torch.zeros(7, 4)
    before = models["unet"].get_submodule(UNET_MODULES[1]).weight.clone()
    with pytest.raises(ValueError, match="LoRA delta shape"):
        lora.merge_lora(_targets(models), sd)
    with pytest.raises(ValueError, match="LoRA delta shape"):
        jax_lora.merge_lora(_jax_params(state), _np(sd))
    assert torch.equal(models["unet"].get_submodule(UNET_MODULES[1]).weight,
                       before)
    with pytest.raises(ValueError, match="unmatched"):
        lora.merge_lora(_targets(_models(state)), make_lora("peft", models),
                        strict=True)


@pytest.fixture(scope="module")
def v1_pipe(state):
    return InpaintPipeline(tiny_v1_config(), _copy(state), _tok(),
                           dtype=torch.float32, device="cpu")


def _request():
    rng = np.random.RandomState(0)
    image = (rng.rand(48, 48, 3) * 255).astype(np.uint8)
    mask = np.zeros((48, 48), np.float32)
    mask[12:36, 12:36] = 1.0
    return image, mask


def _call(pipe, prompt="a dog", **kw):
    image, mask = _request()
    extra = ([np.zeros((48, 48, 3), np.uint8)]
             if isinstance(pipe, ControlNetPipeline) else [])
    return pipe(image, mask, *extra, prompt=prompt, num_inference_steps=2,
                seed=1, output_type="float32", **kw)


def _weights(pipe):
    return {f"{t}.{k}": v.clone() for t in lora.TARGETS
            for k, v in getattr(pipe, t).state_dict().items()}


def test_pipeline_lora_scale_per_call_and_unload(v1_pipe, state, monkeypatch):
    """``load_lora_weights`` / ``set_lora_scale`` / ``unload_lora_weights``
    against the JAX merges; ``cross_attention_kwargs={"scale": s}`` runs the
    call at s and puts every weight back bit for bit; at the current scale
    it merges nothing."""
    pipe = v1_pipe
    base_w = _weights(pipe)
    base = _call(pipe)
    sd = make_lora("peft", {t: getattr(pipe, t) for t in lora.TARGETS})
    unmatched = pipe.load_lora_weights(sd, scale=1.0)
    assert len(unmatched) == len(UNMATCHED)
    try:
        styled = _call(pipe)
        assert not np.array_equal(styled, base)
        merged_w = _weights(pipe)

        at_03 = _call(pipe, cross_attention_kwargs={"scale": 0.3})
        assert all(torch.equal(v, merged_w[k]) for k, v in _weights(pipe).items())
        np.testing.assert_array_equal(_call(pipe), styled)
        assert not np.array_equal(at_03, styled)

        monkeypatch.setattr(lora._Plan, "merge", None)  # any merge fails
        np.testing.assert_array_equal(
            _call(pipe, cross_attention_kwargs={"scale": 1.0}), styled)
        monkeypatch.undo()

        pipe.set_lora_scale(0.3)
        np.testing.assert_array_equal(_call(pipe), at_03)
        want, _ = jax_lora.merge_lora(_jax_params(state), _np(sd), 0.3)
        for t in lora.TARGETS:
            ref = params_from_jax(want[t], t)
            for k, v in getattr(pipe, t).state_dict().items():
                np.testing.assert_allclose(v.numpy(), ref[k], rtol=0,
                                           atol=1e-6, err_msg=k)
    finally:
        pipe.unload_lora_weights()
    for k, v in _weights(pipe).items():  # exact in fp32 to the rounding
        np.testing.assert_allclose(v.numpy(), base_w[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    with pytest.raises(RuntimeError, match="no LoRA"):
        pipe.set_lora_scale(0.5)


@pytest.fixture(scope="module")
def pipes(state):
    cn_state = init_state(tiny_v1_controlnet_config(),
                          torch.Generator().manual_seed(0), device="cpu")
    v2_state = init_state(tiny_v2_config(), torch.Generator().manual_seed(0),
                          device="cpu")
    return {"v2": BrushNetPipeline(tiny_v2_config(), v2_state, _tok(),
                                   dtype=torch.float32, device="cpu"),
            "cn": ControlNetPipeline(tiny_v1_controlnet_config(), cn_state,
                                     _tok(), dtype=torch.float32, device="cpu")}


@pytest.mark.parametrize("name", ["v1", "v2", "cn"])
def test_cross_attention_kwargs_is_checked(v1_pipe, pipes, name, monkeypatch):
    pipe = v1_pipe if name == "v1" else pipes[name]
    monkeypatch.setattr(pipe, "_generate", None)  # any device work fails
    with pytest.raises(InputValidationError, match="requires a loaded LoRA"):
        _call(pipe, cross_attention_kwargs={"scale": 0.5})
    with pytest.raises(InputValidationError, match="unsupported"):
        _call(pipe, cross_attention_kwargs={"scale": 0.5, "temperature": 2})


@pytest.mark.parametrize("name", ["v2", "cn"])
def test_lora_touches_only_the_unet_and_the_text_encoder(state, pipes, name):
    """On ppt-v2 the base UNet and the plain tower (not the BrushNet or its
    task tower); on the ControlNet pipeline not the branch; the per-call
    scale there too."""
    pipe = pipes[name]
    others = {n: {k: v.clone() for k, v in getattr(pipe, n).state_dict().items()}
              for n in ("vae", "brushnet" if name == "v2" else "controlnet")}
    sd = make_lora("kohya", {t: getattr(pipe, t) for t in lora.TARGETS})
    before = _weights(pipe)
    base = _call(pipe)
    pipe.load_lora_weights(sd, scale=0.8)
    try:
        styled = _call(pipe)
        assert not np.array_equal(styled, base)
        _call(pipe, cross_attention_kwargs={"scale": 0.2})
        np.testing.assert_array_equal(_call(pipe), styled)
        for n, sd_before in others.items():
            for k, v in getattr(pipe, n).state_dict().items():
                assert torch.equal(v, sd_before[k]), (n, k)
        changed = sum(not torch.equal(v, before[k])
                      for k, v in _weights(pipe).items())
        assert changed == len(UNET_MODULES) + len(TEXT_MODULES) - 1  # mlp
    finally:
        pipe.unload_lora_weights()


def test_int8_weights_follow_the_merge(state):
    """A LoCon on int8 ResNet units: each touched conv's int8 weights are
    quantised again from the merged weight, after a merge, a per-call
    scale (restored bit for bit) and an unload."""
    pipe = InpaintPipeline(tiny_v1_config(), _copy(state), _tok(),
                           dtype=torch.float32, device="cpu", int8=True)
    convs = ["up_blocks.2.resnets.1.conv1", "down_blocks.0.resnets.0.conv2",
             "mid_block.resnets.1.conv1"]
    sd = {}
    for n, name in enumerate(convs):
        w = pipe.unet.get_submodule(name).weight
        down, up = _factors(tuple(w.shape), 4, seed=n)
        sd[f"lora_unet_{name.replace('.', '_')}.lora_down.weight"] = down
        sd[f"lora_unet_{name.replace('.', '_')}.lora_up.weight"] = up

    def assert_requantised():
        for name in convs:
            m = pipe.unet.get_submodule(name)
            w_q, w_scale = quantize_weights_int8(m.weight)
            assert torch.equal(m.w_q, w_q) and torch.equal(m.w_scale, w_scale)

    before = {n: pipe.unet.get_submodule(n).w_q.clone() for n in convs}
    assert pipe.load_lora_weights(sd, scale=1.0) == []
    assert_requantised()
    assert all(not torch.equal(pipe.unet.get_submodule(n).w_q, before[n])
               for n in convs)
    merged = {n: pipe.unet.get_submodule(n).w_q.clone() for n in convs}
    _call(pipe, cross_attention_kwargs={"scale": 0.4})
    assert all(torch.equal(pipe.unet.get_submodule(n).w_q, merged[n])
               for n in convs)
    pipe.unload_lora_weights()
    assert_requantised()


# ---------------------------------------------------------------------------
# textual inversion
# ---------------------------------------------------------------------------


def _ti_file(tmp_path, layout, dim):
    g = torch.Generator().manual_seed(9)
    if layout == "a1111":  # {"<token>": (n, D)} in a torch pickle
        path = tmp_path / "cat-toy.pt"
        torch.save({"<cat-toy>": torch.randn(2, dim, generator=g)}, path)
        return str(path), None, "<cat-toy>"
    path = tmp_path / "sks.safetensors"
    save_file({"emb_params": torch.randn(1, dim, generator=g)}, str(path))
    return str(path), "<sks>", "<sks>"


@pytest.mark.parametrize("layout", ["a1111", "emb_params"])
def test_textual_inversion_matches_jax(state, tmp_path, layout):
    """Both layouts: the tokenizer's ids and the text tower's table as the
    JAX package's, a prompt with the token changes the image, one without
    it encodes bit for bit as before."""
    from powerpaint_tpu.io.convert import load_state_dict as jax_load

    pipe = InpaintPipeline(tiny_v1_config(), _copy(state), _tok(),
                           dtype=torch.float32, device="cpu")
    path, token, used = _ti_file(tmp_path, layout, 32)
    plain_ids = torch.as_tensor(pipe.tokenizer(["a dog on a bench"]),
                                dtype=torch.long)
    with torch.no_grad():
        plain_before = pipe.text_encoder(plain_ids)
    base = _call(pipe, prompt=f"a photo of {used}")

    pipe.add_textual_inversion(path, token=token)
    jtok = _jax_tok()
    tree = jax_convert.load_textual_inversion(
        jtok, _jax_params(state)["text_encoder"], jax_load(path), token=token)
    prompt = f"a photo of {used} on a bench"
    np.testing.assert_array_equal(pipe.tokenizer(prompt), jtok(prompt))
    want = params_from_jax(tree, "text_encoder", tokenizer=jtok)
    got = pipe.text_encoder.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    with torch.no_grad():
        assert torch.equal(pipe.text_encoder(plain_ids), plain_before)
    assert not np.array_equal(_call(pipe, prompt=f"a photo of {used}"), base)


def test_textual_inversion_on_a_plain_tower_and_on_ppt_v2(state, pipes,
                                                          tmp_path):
    """A plain table becomes the task-token table around it (as the JAX
    tree gains an ``external_embedding``); on ppt-v2 the token goes to the
    BrushNet's task tower, and the plain tower reads the clamped ids."""
    from powerpaint_tpu.io.convert import load_state_dict as jax_load
    from powerpaint_tpu_torch.io.convert import load_textual_inversion

    cfg = tiny_v2_config()
    plain = load_models(cfg, init_state(cfg, torch.Generator().manual_seed(2),
                                        device="cpu"),
                        device="cpu", dtype=torch.float32)["text_encoder"]
    sd_before = {k: v.numpy() for k, v in plain.state_dict().items()}
    path, token, used = _ti_file(tmp_path, "a1111", 32)
    tok = TokenizerWrapper(HashTokenizer(1024))
    name, rows = load_textual_inversion(tok, torch.load(path), token=token, dim=32)
    plain.add_token_rows(name, rows)
    jtok = JaxTokenizerWrapper(JaxHashTokenizer(1024))
    tree = jax_convert.load_textual_inversion(
        jtok, jax_convert.convert_clip_text(sd_before), jax_load(path))
    want = params_from_jax(tree, "text_encoder", tokenizer=jtok)
    got = plain.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)

    v2 = pipes["v2"]
    base = _call(v2, prompt=f"a photo of {used}")
    v2.add_textual_inversion(path)
    table = v2.text_encoder_brushnet.text_model.embeddings.token_embedding
    assert table.names[-1] == "<cat-toy>"
    assert not np.array_equal(_call(v2, prompt=f"a photo of {used}"), base)
