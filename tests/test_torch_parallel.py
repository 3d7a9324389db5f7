"""The port's mesh rules (``powerpaint_tpu_torch.parallel``) against the JAX
package's ``parallel/mesh.py``, in one process, with no JAX compile:

- the tensor-parallel table: for every ``Linear`` of the tiny v1, v2 (with
  an IP-Adapter) and ControlNet stacks (the JAX sharded tests' widths), the
  port's cut at tp = 2 against JAX ``param_spec`` of the same leaf, named
  through ``powerpaint_tpu.io.convert``; the deliberate departures (the
  IP-Adapter's k/v split by heads, GEGLU's interleaved rows, a module whose
  heads tp does not divide kept whole) are listed and asserted as such;
- the ZeRO-3 leaf choice: the set of leaves ``fsdp_layout`` splits over 8
  ranks against the set JAX ``fsdp_shardings`` splits on the 8-device CPU
  mesh;
- simulated ranks: for tp in {2, 4}, each rank's local ``Attention`` (with
  two IP-Adapters), ``FeedForward``, CLIP attention and CLIP MLP, their
  row-parallel sums left unreduced, summed over the ranks equal the whole
  module to fp32 rounding;
- the backend choice, the mesh's refusals and the pipelines' refusal of
  sequence parallelism.
"""

import copy

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from powerpaint_tpu.io import convert as jax_convert
from powerpaint_tpu.parallel import mesh as jax_mesh
from powerpaint_tpu_torch.core.config import CLIPTextConfig
from powerpaint_tpu_torch.io.weights import build_models
from powerpaint_tpu_torch.models.clip_text import CLIPAttention, CLIPMLP
from powerpaint_tpu_torch.models.transformer import Attention, FeedForward
from powerpaint_tpu_torch.parallel import mesh
from powerpaint_tpu_torch.parallel.launch import free_port
from powerpaint_tpu_torch.testing import (
    tiny_clip_vision_config,
    tiny_v1_config,
    tiny_v1_controlnet_config,
    tiny_v2_config,
)
from powerpaint_tpu_torch.train.step import flatten

CONVERT = {"unet": jax_convert.convert_unet, "vae": jax_convert.convert_vae,
           "text_encoder": jax_convert.convert_clip_text,
           "text_encoder_brushnet": jax_convert.convert_clip_text,
           "brushnet": jax_convert.convert_brushnet,
           "controlnet": jax_convert.convert_controlnet,
           "image_encoder": jax_convert.convert_clip_vision}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ip_v2_config():
    cfg = tiny_v2_config()
    return cfg.replace(unet=cfg.unet.replace(ip_adapter_dim=16,
                                             ip_adapter_tokens=4),
                       image_encoder=tiny_clip_vision_config())


CONFIGS = {"v1": tiny_v1_config, "v2": ip_v2_config,
           "controlnet": tiny_v1_controlnet_config}


def jax_paths(family: str, model: torch.nn.Module) -> dict:
    """{port state-dict key: JAX tree path}: every tensor filled with its
    own index, converted by the JAX package's converter, and read back
    from the leaves (a leaf made of several tensors maps to each)."""
    keys = list(model.state_dict())
    sd = {k: np.full(tuple(v.shape), i, np.float32)
          for i, (k, v) in enumerate(model.state_dict().items())}
    tree = CONVERT[family](sd)
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in kp)
        for i in np.unique(np.asarray(leaf)):
            out[keys[int(i)]] = f"{family}/{path}"
    return out


def port_cut(split) -> tuple:
    """A port Split (or None) as (dim in the JAX leaf, halves)."""
    return None if split is None else (split.dim, split.halves)


def jax_cut(path: str, torch_dim: int):
    """JAX ``param_spec`` of a leaf as the port dim it splits (a kernel's
    (in, out) is the torch weight's (out, in) transposed)."""
    spec = tuple(jax_mesh.param_spec(path))
    if jax_mesh.MODEL_AXIS not in spec:
        return None
    d = spec.index(jax_mesh.MODEL_AXIS)
    return d if torch_dim == 1 else 1 - d


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tensor_parallel_table_matches_jax_param_spec(name):
    models = build_models(CONFIGS[name]())
    if name == "controlnet":
        models["controlnet"] = models["controlnet"]
    departures = {"ip_kv": 0, "geglu": 0, "whole": 0}
    checked = 0
    for family, model in models.items():
        plan = mesh.tp_plan(model, 2)
        paths = jax_paths(family, model)
        for mod_name, m in model.named_modules():
            if not isinstance(m, torch.nn.Linear):
                continue
            for pname, p in m.named_parameters(recurse=False):
                key = f"{mod_name}.{pname}"
                want = jax_cut(paths[key], p.dim())
                got = plan.get(key)
                checked += 1
                if got is not None and got.halves:
                    departures["geglu"] += 1  # same dim, interleaved rows
                    assert want == got.dim == 0, key
                elif ".to_k_ip." in key or ".to_v_ip." in key:
                    departures["ip_kv"] += 1  # split by heads; JAX whole
                    assert want is None and port_cut(got) == (0, False), key
                elif got is None and want is not None:
                    departures["whole"] += 1  # heads tp does not divide
                    assert family == "vae" and ".attentions." in key, key
                else:
                    assert (None if got is None else got.dim) == want, key
    assert checked > 100
    assert departures["geglu"] > 0 and departures["whole"] > 0
    assert (departures["ip_kv"] > 0) == (name == "v2")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fsdp_leaf_choice_matches_jax_fsdp_shardings(name):
    from jax.sharding import Mesh as JaxMesh

    devices = jax.devices()[:8]
    jmesh = JaxMesh(np.array(devices).reshape(8, 1),
                    (jax_mesh.DATA_AXIS, jax_mesh.MODEL_AXIS))
    models = build_models(CONFIGS[name]())
    for family, model in models.items():
        paths = jax_paths(family, model)
        state = model.state_dict()
        tree = CONVERT[family]({k: np.zeros(tuple(v.shape), np.float32)
                                for k, v in state.items()})
        shardings = jax_mesh.fsdp_shardings(jmesh, tree)
        jax_split = {
            "/".join(str(getattr(k, "key", k)) for k in kp)
            for kp, s in jax.tree_util.tree_flatten_with_path(
                shardings, is_leaf=lambda x: hasattr(x, "spec"))[0]
            if jax_mesh.DATA_AXIS in tuple(s.spec)}
        layout = mesh.fsdp_layout(state, 8)
        port_split = {paths[k].split("/", 1)[1] for k, d in layout.items()
                      if d is not None}
        assert port_split == jax_split, (family, port_split ^ jax_split)


class Rank:
    """A stand-in model group for one simulated rank: its all-reduce is
    the identity, so a row-parallel output is that rank's partial sum."""

    backend = "none"

    def __init__(self, index: int, size: int):
        self.index, self.size = index, size

    def all_reduce(self, x, op="sum"):
        return x.clone()


def simulated(module, tp: int, *args, **kw):
    """Each simulated rank's output of ``module`` split ``tp`` ways."""
    outs = []
    for r in range(tp):
        m = copy.deepcopy(module)
        mesh.shard_model(m, Rank(r, tp))
        outs.append(m(*args, **kw))
    return outs


def assert_sums(outs, whole, bias):
    """Every rank added the whole bias once: the partial sums add up to
    the whole output plus (tp - 1) biases."""
    got = sum(o - bias for o in outs) + bias
    torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-5)


def _init(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    return module.eval()


@pytest.mark.parametrize("tp", [2, 4])
@torch.no_grad()
def test_simulated_ranks_sum_to_the_whole_modules(tp):
    g = torch.Generator().manual_seed(tp)
    x = torch.randn(2, 6, 32, generator=g)
    ctx = torch.randn(2, 5, 16, generator=g)
    ips = [torch.randn(2, 4, 16, generator=g) for _ in range(2)]

    attn = _init(Attention(32, 8, 4, context_dim=16, ip_adapters=2), 1)
    whole = attn(x, ctx, ips, [1.0, 0.5])
    outs = simulated(attn, tp, x, ctx, ips, [1.0, 0.5])
    assert all(o.shape == whole.shape for o in outs)
    assert_sums(outs, whole, attn.to_out[0].bias)

    self_attn = _init(Attention(32, 8, 4), 2)
    assert_sums(simulated(self_attn, tp, x), self_attn(x),
                self_attn.to_out[0].bias)

    ff = _init(FeedForward(32), 3)
    assert_sums(simulated(ff, tp, x), ff(x), ff.net[2].bias)

    cfg = CLIPTextConfig(hidden_size=32, intermediate_size=64,
                         num_attention_heads=8, num_hidden_layers=1)
    causal = torch.full((6, 6), -1e9).triu(1)
    clip_attn = _init(CLIPAttention(cfg), 4)
    assert_sums(simulated(clip_attn, tp, x, causal), clip_attn(x, causal),
                clip_attn.out_proj.bias)
    mlp = _init(CLIPMLP(cfg), 5)
    assert_sums(simulated(mlp, tp, x), mlp(x), mlp.fc2.bias)


def test_a_module_whose_heads_tp_does_not_divide_stays_whole():
    attn = Attention(24, 3, 8)
    assert mesh.tp_plan(attn, 2) == {}
    mesh.shard_model(attn, Rank(0, 2))
    assert attn.tp is None and attn.num_heads == 3
    assert attn.to_q.weight.shape == (24, 24)


def test_geglu_pieces_join_back_whole():
    split = mesh.Split(0, 4, halves=True)
    full = torch.arange(16.0).reshape(16, 1)  # h rows 0-7, gate rows 8-15
    pieces = [split.piece(full, r) for r in range(4)]
    assert pieces[1].flatten().tolist() == [2.0, 3.0, 10.0, 11.0]
    assert torch.equal(split.join(torch.cat(pieces)), full)


def test_backend_choice_refuses_what_cannot_run():
    assert mesh.choose_backend(["cpu"] * 4) == "gloo"
    assert mesh.choose_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert mesh.choose_backend(["cuda:0", "cuda:0"], "gloo") == "gloo"
    for devices, backend in ((["cuda:0", "cuda:0"], None),
                             (["cuda:0", "cuda:0"], "nccl")):
        with pytest.raises(ValueError, match="ask for backend='gloo'"):
            mesh.choose_backend(devices, backend)
    with pytest.raises(ValueError, match="NCCL needs every rank on a card"):
        mesh.choose_backend(["cpu", "cpu"], "nccl")
    with pytest.raises(ValueError, match="every rank on the CPU"):
        mesh.choose_backend(["cpu", "cuda:0"])


def test_fsdp_dim_is_the_largest_divisible_dim():
    assert mesh.fsdp_dim((64, 64, 3, 3), 8) == 0  # a tie: output features
    assert mesh.fsdp_dim((32, 1024), 8) == 1
    assert mesh.fsdp_dim((320, 4), 8) is None  # under 2**14 elements
    assert mesh.fsdp_dim((129, 127), 8) is None  # no divisible dim


def test_the_mesh_lays_ranks_out_and_refuses_an_uneven_split():
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="3 devices not divisible by tp=2"):
            mesh.build_mesh(["cpu"] * 3, model_parallel=2)
        m = mesh.build_mesh(["cpu"])
        assert m.shape == {"data": 1, "model": 1} and m.tp is None
        assert (m.data_index, m.model_index, m.backend) == (0, 0, "gloo")
        assert m.data_share(3) == slice(0, 3)
        x = torch.arange(6.0).reshape(2, 3)
        assert torch.equal(m.data.all_gather(x, 1), x)
        assert torch.equal(m.data.reduce_scatter(x, 0, "mean"), x)
    finally:
        dist.destroy_process_group()

