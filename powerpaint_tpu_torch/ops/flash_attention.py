"""Non-causal flash attention over (B, S, N, D) tensors.

``flash_attention`` is the wrapper of the hand-written CUDA kernel in
``csrc/flash_attention.cu``, which replaces the TPU kernel
``powerpaint_tpu/ops/flash_attention.py::_flash_kernel``. For a CUDA
tensor it launches the kernel or raises; for a CPU tensor it runs
``flash_attention_plain``, the same function in plain PyTorch (the CPU path
and the kernel's oracle). What bounds the kernel on the card and what its
design does about it is written at the top of the ``.cu`` source. Where an
input requires a gradient, the call goes through ``FlashAttention``, whose
backward recomputes the plain version (``ops._grad``).

``flash_attention_lse`` is the same kernel's log-sum-exp mode, for ring
attention's partial results (``ops.ring_attention``): the output in fp32
whatever the inputs' type, and each query row's log-sum-exp (B, N, Sq) in
fp32, natural-log units, so that partial results over blocks of keys
merge without a rounding to bf16 at each merge. Its plain version is
``flash_attention_lse_plain``.

``flash_attention_bf16_softmax`` is the kernel's bf16-softmax mode, the
port of ``scripts/perf_attn_bf16.py::_bf16_kernel`` (another function: the
softmax in bf16), for ``scripts/torch_perf_attn_bf16.py``'s experiment; no
pipeline calls it. Its plain version, ``flash_attention_bf16_softmax_plain``,
repeats that kernel's roundings over blocks of keys.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Optional

import torch

from powerpaint_tpu_torch.ops import _build
from powerpaint_tpu_torch.ops._grad import needs_grad, recompute_function

_LOG2E = math.log2(math.e)
BF16_MAX_D = 1024  # the bf16 kernel's widest head (csrc/flash_attention.cu)
NEG_BF16 = -3e38  # the bf16-softmax mode's mask and first running max: finite


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention with fp32 logits and softmax, probabilities cast
    to v's dtype, fp32 P @ V, result in q's dtype (the JAX package's
    ``xla_attention``). q: (B, Sq, N, D); k, v: (B, Skv, N, D)."""
    d = q.shape[-1]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    probs = torch.softmax(logits * scale, dim=-1).to(v.dtype)
    out = torch.einsum("bnqk,bknd->bqnd", probs.float(), v.float())
    return out.to(q.dtype)


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: Optional[float] = None):
    """(out, lse): ``flash_attention_plain``'s output left in fp32, (B, Sq,
    N, D), and ``torch.logsumexp`` of each query row's fp32 scaled logits,
    (B, N, Sq) fp32. The probabilities are rounded to v's dtype before
    P @ V, as the plain version rounds them."""
    d = q.shape[-1]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None]).to(v.dtype)
    out = torch.einsum("bnqk,bknd->bqnd", probs.float(), v.float())
    return out, lse


def exp2_bf16_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """bf16 2**x as the card's ``ex2.approx.ftz.bf16x2`` gives it: exp2 in
    fp32 cut toward zero to bf16, subnormals flushed to 0 (on an H100 the
    mode's output agrees with this rounding and not with round-to-nearest:
    ``scripts/torch_perf_attn_bf16.py`` reads both)."""
    e = torch.exp2(x.float())
    e = torch.where(e < 2.0 ** -126, torch.zeros_like(e), e)
    return (e.view(torch.int32) & -65536).view(torch.float32).to(torch.bfloat16)


def flash_attention_bf16_softmax_plain(q: torch.Tensor, k: torch.Tensor,
                                        v: torch.Tensor,
                                        scale: Optional[float] = None,
                                        block_kv: Optional[int] = None,
                                        exp2: Callable = exp2_bf16_toward_zero):
    """``scripts/perf_attn_bf16.py::_flash_bf16`` step by step over blocks of
    ``block_kv`` keys (None: the kernel's, ``bf16_config(d)["bk"]``): q times
    scale * log2 e rounded to bf16; per block the fp32 scores rounded to
    bf16, the running max in bf16, alpha = exp2 of the bf16 difference
    m_prev - m_new in fp32, p = ``exp2`` of the bf16 s - m_new (bf16 to
    bf16: the one step whose rounding is the backend's; the default is the
    card's), fp32 sums of p and of p v; out = acc / l (1 where l = 0) in
    q's dtype. The running max moves per block, so the result depends on
    ``block_kv``. q: (B, Sq, N, D); k, v: (B, Skv, N, D)."""
    bf16 = torch.bfloat16
    b, sq, n, d = q.shape
    skv = k.shape[1]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    block_kv = bf16_config(d)["bk"] if block_kv is None else block_kv
    qs = (q.float().transpose(1, 2) * (scale * _LOG2E)).to(bf16).float()
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    m = torch.full((b, n, sq, 1), NEG_BF16, dtype=bf16, device=q.device)
    l = torch.zeros((b, n, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, n, sq, d), dtype=torch.float32, device=q.device)
    for kv0 in range(0, skv, block_kv):
        s = (qs @ kf[:, :, kv0:kv0 + block_kv].transpose(-1, -2)).to(bf16)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new).float())
        p = exp2(s - m_new).float()
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p @ vf[:, :, kv0:kv0 + block_kv]
        m = m_new
    out = acc / torch.where(l == 0, torch.ones_like(l), l)
    return out.transpose(1, 2).to(q.dtype)


def bf16_config(d: int) -> dict:
    """The bf16 kernel's shape for head dim ``d``, as ``bf16_config`` in
    ``csrc/flash_attention.cu`` chooses it (a card test holds the two
    together): output columns per z slice (``do``), kv rows per stage
    (``bk``), consumer warpgroups of 64 q rows (``nwg``), ring stages,
    slices, and the dynamic shared memory in bytes."""
    if not 0 < d <= BF16_MAX_D:
        raise ValueError(f"the bf16 kernel takes head dims 1..{BF16_MAX_D}, "
                         f"got {d}")
    for top, cfg in ((40, (40, 128, 2, 3)), (64, (64, 128, 2, 3)),
                     (80, (80, 128, 2, 2)), (160, (160, 64, 2, 2)),
                     (256, (256, 64, 2, 2)), (512, (256, 32, 1, 2)),
                     (768, (256, 32, 1, 2)), (1024, (256, 16, 1, 2))):
        if d <= top:
            break
    do, bk, nwg, stages = cfg
    # q k^T runs over the shape's largest head dim padded to 16 (zeros past d)
    qb = -(-(-(-top // 16) * 16) // 64)  # 64-column blocks of q and k
    vb = -(-do // 64)
    smem = 1024 + 128 * (nwg * qb * 64 + stages * (qb + vb) * bk) + 16 * stages
    return dict(do=do, bk=bk, nwg=nwg, stages=stages, slices=-(-d // do),
                smem=smem)


# mode -> (library, entry); the bf16-softmax mode is a library of its own
_ENTRIES = {"plain": ("flash_attention", "ppt_flash_attention"),
            "lse": ("flash_attention", "ppt_flash_attention_lse"),
            "bf16_softmax": ("flash_attention_bf16_softmax",
                             "ppt_flash_attention_bf16_softmax")}


@functools.lru_cache(maxsize=None)
def _kernel(mode: str = "plain"):
    lib, entry = _ENTRIES[mode]
    fn = getattr(_build.load(lib), entry)
    fn.restype = ctypes.c_int
    # the bf16-softmax entry takes bf16 only: no dtype flag
    fn.argtypes = [ctypes.c_void_p] * (5 if mode == "lse" else 4) + [
        ctypes.c_int] * (5 if mode == "bf16_softmax" else 6) + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
    return fn


def _launch(q, k, v, scale: float, mode: str = "plain"):
    b, sq, n, d = q.shape
    skv = k.shape[1]
    lse = mode == "lse"
    out = torch.empty((b, sq, n, d), dtype=torch.float32 if lse else q.dtype,
                      device=q.device)
    strides = (ctypes.c_longlong * 12)(*[
        s for t in (q, k, v, out) for s in (t.stride(0), t.stride(1), t.stride(2))
    ])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    if lse:
        row_lse = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
        args.append(row_lse.data_ptr())
    if mode != "bf16_softmax":
        args.append(int(q.dtype == torch.bfloat16))
    err = _kernel(mode)(*args, b, n, sq, skv, d, strides, float(scale * _LOG2E),
                        stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    return (out, row_lse) if lse else out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention over (B, S, N, D): q (B, Sq, N, D), k and v (B, Skv, N, D).

    CUDA tensors go to the kernel (fp32 or bf16, one dtype, last dim
    contiguous, all on one device); CPU tensors to the plain version.
    Differentiable in q, k and v."""
    if needs_grad(q, k, v):
        return FlashAttention.apply({"scale": scale}, q, k, v)
    return _flash_attention(q, k, v, scale=scale)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes (B, S, N, D) tensors")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or \
            k.shape[2:] != q.shape[2:]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes fp32 or bf16 of one dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one CUDA device")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention needs the head dim contiguous")
    if q.dtype == torch.bfloat16 and q.shape[-1] > BF16_MAX_D:
        raise ValueError(f"the bf16 kernel takes head dims up to {BF16_MAX_D}, "
                         f"got {q.shape[-1]}")


def _flash_attention(q, k, v, scale=None):
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, scale)
    _check(q, k, v)
    d = q.shape[-1]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    out = _launch(q, k, v, scale)
    flash_attention.launches += 1
    return out


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: Optional[float] = None):
    """(out, lse) of attention over (B, S, N, D): out (B, Sq, N, D) in fp32
    and lse (B, N, Sq) fp32, each query row's log-sum-exp of its scaled
    logits in natural-log units. CUDA tensors go to the kernel's
    log-sum-exp mode (the inputs ``flash_attention`` takes), CPU tensors to
    ``flash_attention_lse_plain``. Not differentiable."""
    if not q.is_cuda:
        return flash_attention_lse_plain(q, k, v, scale)
    _check(q, k, v)
    scale = (1.0 / math.sqrt(q.shape[-1])) if scale is None else scale
    out = _launch(q, k, v, scale, mode="lse")
    flash_attention_lse.launches += 1
    return out


def flash_attention_bf16_softmax(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, *,
                                  scale: Optional[float] = None) -> torch.Tensor:
    """Attention over (B, S, N, D) bf16 tensors with the softmax in bf16
    (``flash_attention_bf16_softmax_plain``'s function at the kernel's
    block of keys): CUDA tensors go to the kernel's bf16-softmax mode, CPU
    tensors to the plain version. bf16 only, head dims up to ``BF16_MAX_D``;
    not differentiable (the TPU kernel has no backward)."""
    if needs_grad(q, k, v):
        raise ValueError("flash_attention_bf16_softmax is not differentiable")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the bf16-softmax mode takes bf16 only, got {q.dtype}")
    if not q.is_cuda:
        return flash_attention_bf16_softmax_plain(q, k, v, scale)
    _check(q, k, v)
    scale = (1.0 / math.sqrt(q.shape[-1])) if scale is None else scale
    out = _launch(q, k, v, scale, mode="bf16_softmax")
    flash_attention_bf16_softmax.launches += 1
    return out


FlashAttention = recompute_function("FlashAttention", _flash_attention,
                                    flash_attention_plain)
flash_attention.launches = 0
flash_attention_lse.launches = 0
flash_attention_bf16_softmax.launches = 0
