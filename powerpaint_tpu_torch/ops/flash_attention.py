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
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from powerpaint_tpu_torch.ops import _build
from powerpaint_tpu_torch.ops._grad import needs_grad, recompute_function

_LOG2E = math.log2(math.e)
BF16_MAX_D = 1024  # the bf16 kernel's widest head (csrc/flash_attention.cu)


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


@functools.lru_cache(maxsize=None)
def _kernel(lse: bool = False):
    lib = _build.load("flash_attention")
    fn = lib.ppt_flash_attention_lse if lse else lib.ppt_flash_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * (5 if lse else 4) + [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
    return fn


def _launch(q, k, v, scale: float, lse: bool = False):
    b, sq, n, d = q.shape
    skv = k.shape[1]
    out = torch.empty((b, sq, n, d), dtype=torch.float32 if lse else q.dtype,
                      device=q.device)
    strides = (ctypes.c_longlong * 12)(*[
        s for t in (q, k, v, out) for s in (t.stride(0), t.stride(1), t.stride(2))
    ])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    if lse:
        row_lse = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
        ptrs.append(row_lse.data_ptr())
    err = _kernel(lse)(*ptrs, int(q.dtype == torch.bfloat16), b, n, sq, skv, d,
                       strides, float(scale * _LOG2E), stream)
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
    out = _launch(q, k, v, scale, lse=True)
    flash_attention_lse.launches += 1
    return out


FlashAttention = recompute_function("FlashAttention", _flash_attention,
                                    flash_attention_plain)
flash_attention.launches = 0
flash_attention_lse.launches = 0
