"""The flash kernel's bf16-softmax mode (``flash_attention_bf16_softmax``)
against the TPU kernel it ports, ``scripts/perf_attn_bf16.py::_flash_bf16``.

The script is imported by path, unedited, and its kernel run in Pallas's
TPU interpret mode on the CPU; the port's plain version runs at the same
block of keys (the running max moves per block, so the function depends on
it). Inputs are numpy seed-0 normals, rounded to bf16 on both sides.

The one step whose rounding belongs to the backend is p = exp2 of the bf16
s - m_new. XLA's bf16 ``exp2`` on the CPU is exp(x * ln 2) with the product
and the result each rounded to bf16 (``_exp2_xla_cpu``, held to
``jnp.exp2`` below), many bf16 ulps from exp2 in fp32 on most inputs; the
card's bf16x2 instruction cuts exp2 in fp32 toward zero (the plain
version's default). With the interpreter's rounding the plain version is
the JAX kernel's output to within fp32 summation order: both relative
errors of ``attention_errors`` (the largest |difference| over the largest
|output|, and the 2-norms' ratio) read at most 0.00079 and 3.3e-5 here,
against a bound of 2^-9 and 2^-12. Dense fp32 softmax attention, and the
plain version with the card's rounding, read 0.0054-0.0155 and
0.0054-0.0064: each must fail the same bound, so the bound tells the bf16
softmax from the fp32 one and the interpreter's exp2 from the card's.

The interpreter fills what a partial block reads past the array with NaN by
default; on the TPU that part of the buffer holds earlier, finite data,
which the kernel's masked columns multiply by p = 0. So the interpreter is
asked for zeros there (``uninitialized_memory="zero"``).
"""

import functools
import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from powerpaint_tpu_torch.ops import flash_attention as fa
from powerpaint_tpu_torch.parallel.dryrun import attention_errors

SCRIPT = pathlib.Path(__file__).resolve().parent.parent / "scripts" / "perf_attn_bf16.py"
# (G, S, D, block_q, block_kv): the script's two head dims, blocks smaller
# than S (two kv blocks a row), and a ragged S (the last block masked)
CASES = [(2, 256, 40, 128, 64), (2, 200, 40, 64, 64), (2, 128, 80, 128, 128)]
# (max_rel_err, norm_rel_err) of the plain version against the JAX kernel
RTOL = (2.0 ** -9, 2.0 ** -12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _script():
    """The script as a module. Its import points JAX's compilation cache at
    a directory of its own; the setting is put back."""
    before = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location("perf_attn_bf16", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    return mod


def _inputs(g, s, d):
    rng = np.random.default_rng(0)
    return [rng.standard_normal((g, s, d)).astype(np.float32) for _ in range(3)]


def _exp2_xla_cpu(x: torch.Tensor) -> torch.Tensor:
    """XLA's bf16 exp2 on the CPU: exp(x * ln 2), the product and the
    result each rounded to bf16."""
    ln2 = torch.tensor(math.log(2.0), dtype=torch.bfloat16)
    return torch.exp((x * ln2).float()).to(torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _outputs(case):
    """(JAX kernel, plain version with the interpreter's exp2, plain version
    with the card's, dense fp32 softmax) outputs, (G, S, D) fp32 tensors."""
    g, s, d, bq, bk = case
    q, k, v = _inputs(g, s, d)
    scale = 1.0 / math.sqrt(d)
    with pltpu.force_tpu_interpret_mode(
            pltpu.InterpretParams(uninitialized_memory="zero")):
        got = _script()._flash_bf16(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                    scale, bq, bk)
    got = torch.from_numpy(np.array(got.astype(jnp.float32)))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16)[:, :, None] for x in (q, k, v))
    cpu = fa.flash_attention_bf16_softmax_plain(tq, tk, tv, scale, block_kv=bk,
                                                exp2=_exp2_xla_cpu)
    card = fa.flash_attention_bf16_softmax_plain(tq, tk, tv, scale, block_kv=bk)
    dense = fa.flash_attention_plain(tq.float(), tk.float(), tv.float(), scale)
    return got, cpu[:, :, 0].float(), card[:, :, 0].float(), dense[:, :, 0]


def _within(got, want) -> bool:
    err = attention_errors(got, want)
    return err["max_rel_err"] <= RTOL[0] and err["norm_rel_err"] <= RTOL[1]


def _ulp(x: float) -> float:
    """One bf16 ulp (8 significant bits) at magnitude ``x``."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def test_xla_cpu_bf16_exp2_is_emulated_exactly():
    x = torch.linspace(-40.0, 0.0, 20001).to(torch.bfloat16)
    want = jnp.exp2(jnp.asarray(x.float().numpy(), jnp.bfloat16))
    assert torch.equal(_exp2_xla_cpu(x).float(),
                       torch.from_numpy(np.array(want.astype(jnp.float32))))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "g{}_s{}_d{}_bq{}_bk{}".format(*c))
def test_plain_version_matches_the_jax_kernel(case):
    """The plain version at the interpreter's exp2 within ``RTOL`` of the
    JAX kernel; dense fp32 softmax and the plain version at the card's
    exp2, the controls, outside it."""
    got, cpu, card, dense = _outputs(case)
    assert torch.isfinite(got).all() and torch.isfinite(cpu).all()
    assert _within(cpu, got), attention_errors(cpu, got)
    for control in (dense, card):
        assert not _within(control, got), attention_errors(control, got)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "g{}_s{}_d{}_bq{}_bk{}".format(*c))
def test_both_stay_near_the_fp32_softmax(case):
    """The JAX kernel and the plain version at the card's exp2 both within
    4 bf16 ulps of the largest output of dense fp32 softmax attention on
    the same bf16 inputs (the script's error measure)."""
    got, _, card, dense = _outputs(case)
    bound = 4 * _ulp(float(dense.abs().max()))
    assert (got - dense).abs().max() <= bound
    assert (card - dense).abs().max() <= bound


def test_a_cpu_call_runs_the_plain_version_uncounted():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 70, 2, 40, generator=g).to(torch.bfloat16)
               for _ in range(3))
    before = fa.flash_attention_bf16_softmax.launches
    got = fa.flash_attention_bf16_softmax(q, k, v, scale=0.2)
    assert fa.flash_attention_bf16_softmax.launches == before
    want = fa.flash_attention_bf16_softmax_plain(q, k, v, 0.2)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    # at the kernel's block of keys (128 at D = 40), not at another
    other = fa.flash_attention_bf16_softmax_plain(q, k, v, 0.2, block_kv=32)
    assert fa.bf16_config(40)["bk"] == 128 and not torch.equal(got, other)


def test_fp32_and_gradient_inputs_raise():
    q = torch.randn(1, 8, 1, 16)
    with pytest.raises(ValueError, match="bf16"):
        fa.flash_attention_bf16_softmax(q, q, q)
    qb = q.to(torch.bfloat16).requires_grad_()
    # autograd on: other test modules of the suite turn it off when imported
    with torch.enable_grad(), pytest.raises(ValueError, match="not differentiable"):
        fa.flash_attention_bf16_softmax(qb, qb.detach(), qb.detach())
