"""Sequence parallelism in one process (no spawn): the pieces the ranks
compose, held to the JAX package, and the one-process call.

- ``flash_attention_lse_plain`` and ``ops.ring_attention.merge_partial``
  folding 2 and 4 key blocks against the JAX package's ``_block_attend``
  fold and its ``xla_attention``, fp32;
- ``ops.norms.merge_moments`` of the parts' moments against the whole
  tensor's, and GroupNorm from given statistics against the plain one;
- the height check's message against the JAX pipeline's;
- ``sequence_parallel=True`` without a mesh: the one-process images bit
  for bit (the JAX pipelines ignore the option there), each pipeline.

The multi-rank checks (the ring over 4 ranks, halos, the pipelines at
data 4) ride the one spawn of ``tests/test_torch_parallel_world.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerpaint_tpu.core.validation import (
    InputValidationError as JaxInputValidationError,
)
from powerpaint_tpu.ops.attention import xla_attention
from powerpaint_tpu.ops.ring_attention import _block_attend
from powerpaint_tpu.parallel.mesh import build_mesh as jax_build_mesh
from powerpaint_tpu.pipelines.inpaint import InpaintPipeline as JaxInpaint
from powerpaint_tpu.testing import tiny_v1_config as jax_tiny_v1_config
from powerpaint_tpu.text.tokenizer import (
    HashTokenizer as JaxHashTokenizer,
    TokenizerWrapper as JaxTokenizerWrapper,
    add_task_tokens as jax_add_task_tokens,
)
from powerpaint_tpu_torch.core.validation import InputValidationError
from powerpaint_tpu_torch.ops import norms
from powerpaint_tpu_torch.ops.flash_attention import flash_attention_lse_plain
from powerpaint_tpu_torch.ops.ring_attention import merge_partial
from powerpaint_tpu_torch.parallel import dryrun, sequence


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, b=2, s=64, n=2, d=8):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, s, n, d).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("blocks", [2, 4])
def test_lse_blocks_merge_as_the_jax_block_fold(blocks):
    q, k, v = _qkv(blocks)
    b, s, n, d = q.shape
    scale = 1.0 / np.sqrt(d)
    # the JAX package's fold over the key blocks, as ring_self_attention's
    m = jnp.full((b, n, s, 1), -jnp.inf, jnp.float32)
    ll = jnp.zeros((b, n, s, 1), jnp.float32)
    acc = jnp.zeros((b, s, n, d), jnp.float32)
    for kb, vb in zip(np.split(k, blocks, 1), np.split(v, blocks, 1)):
        m, ll, acc = _block_attend(jnp.asarray(q), jnp.asarray(kb),
                                   jnp.asarray(vb), scale, m, ll, acc)
    want = np.asarray(acc / jnp.transpose(ll, (0, 2, 1, 3)))
    tq = torch.from_numpy(q)
    out = lse = None
    for kb, vb in zip(np.split(k, blocks, 1), np.split(v, blocks, 1)):
        o_b, l_b = flash_attention_lse_plain(tq, torch.from_numpy(kb),
                                             torch.from_numpy(vb))
        out, lse = (o_b, l_b) if out is None else merge_partial(out, lse, o_b, l_b)
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(xla_attention(q, k, v)),
                               atol=2e-5, rtol=1e-4)
    # the whole log-sum-exp: the fold's m + log(l)
    whole = np.asarray((m + jnp.log(ll))[..., 0])
    np.testing.assert_allclose(lse.numpy(), whole, atol=1e-5, rtol=1e-5)


def test_lse_plain_is_the_plain_attention_and_its_logsumexp():
    q, k, v = _qkv(7, s=40)
    out, lse = flash_attention_lse_plain(*map(torch.from_numpy, (q, k, v)))
    assert out.dtype == lse.dtype == torch.float32
    assert tuple(lse.shape) == (2, 2, 40)
    logits = np.einsum("bqnd,bknd->bnqk", q, k) / np.sqrt(8.0)
    mx = logits.max(-1, keepdims=True)
    want = (mx + np.log(np.exp(logits - mx).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(xla_attention(q, k, v)),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("parts", [2, 4, 8])
def test_chan_merge_of_the_parts_is_the_whole_tensors_moments(parts):
    rng = np.random.RandomState(parts)
    x = torch.from_numpy((rng.randn(2, 32, 8, 64) * 3 + 1.5).astype(np.float32))
    pieces = [norms.group_norm_moments_plain(p, 32) for p in x.chunk(parts, 1)]
    count = x.shape[1] // parts * 8 * 2
    mean, m2 = norms.merge_moments(torch.stack([p[0] for p in pieces]),
                                   torch.stack([p[1] for p in pieces]), count)
    want_mean, want_m2 = norms.group_norm_moments_plain(x, 32)
    torch.testing.assert_close(mean, want_mean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(m2, want_m2, atol=1e-5, rtol=1e-5)
    want_rstd = norms.group_norm_stats_plain(x, 32, 1e-5)[1]
    rstd = 1.0 / torch.sqrt(m2 / float(count * parts) + 1e-5)
    torch.testing.assert_close(rstd, want_rstd, atol=0, rtol=1e-5)


def test_group_norm_from_given_statistics_is_the_plain_group_norm():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 16, 8, 64).astype(np.float32))
    gamma = torch.from_numpy(1 + 0.1 * rng.randn(64).astype(np.float32))
    beta = torch.from_numpy(0.1 * rng.randn(64).astype(np.float32))
    stats = norms.group_norm_stats_plain(x, 32, 1e-5)
    kw = dict(num_groups=32, eps=1e-5, silu=True)
    want = norms.group_norm_plain(x, gamma, beta, **kw)
    torch.testing.assert_close(norms.group_norm(x, gamma, beta, stats=stats, **kw),
                               want, atol=1e-6, rtol=0)
    q = norms.gn_silu_quantize_int8(x, gamma, beta, num_groups=32, eps=1e-5,
                                    x_scale=8.0 / 127.0, stats=stats)
    assert torch.equal(q, norms.gn_silu_quantize_int8_plain(
        x, gamma, beta, num_groups=32, eps=1e-5, x_scale=8.0 / 127.0))


def test_the_height_check_says_what_the_jax_pipeline_says():
    """The JAX v1 pipeline on a 4-device mesh with sequence_parallel
    refuses a 64^2 canvas before any compile; the port's check gives the
    same message, and lets a canvas through whose levels all split."""
    tok = JaxTokenizerWrapper(JaxHashTokenizer(vocab_size=1024))
    jax_add_task_tokens(tok)
    mesh = jax_build_mesh(jax.devices()[:4], model_parallel=1)
    pipe = JaxInpaint(jax_tiny_v1_config(), {}, tok, dtype=jnp.float32,
                      mesh=mesh, sequence_parallel=True, sp_min_seq=16)
    img = np.zeros((64, 64, 3), np.uint8)
    with pytest.raises(JaxInputValidationError) as jax_err:
        pipe(img, np.zeros((64, 64), np.float32), prompt="a cat",
             num_inference_steps=2)
    levels = len(jax_tiny_v1_config().unet.block_out_channels)
    with pytest.raises(InputValidationError) as err:
        sequence.check_height(64, 4, levels)
    assert str(err.value) == str(jax_err.value)
    sequence.check_height(256, 4, levels)


@pytest.mark.parametrize("kind", ["v1", "v2", "cn"])
def test_sequence_parallel_without_a_mesh_is_the_one_process_call(kind):
    cfg, state, tok = dryrun.stack(kind, "cpu")
    img, mask = dryrun.inputs(64)
    kw = dict(prompt="a cat", num_inference_steps=2, seed=3)
    if kind == "cn":
        kw["control_image"] = dryrun.edges(64)
    plain = dryrun.pipeline(kind, cfg, state, tok, torch.float32, device="cpu")
    sp = dryrun.pipeline(kind, cfg, state, tok, torch.float32, device="cpu",
                         sequence_parallel=True, sp_min_seq=16)
    assert np.array_equal(sp(img, mask, **kw), plain(img, mask, **kw))
