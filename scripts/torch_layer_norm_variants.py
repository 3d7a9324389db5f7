#!/usr/bin/env python3
"""Time ``powerpaint_tpu_torch/csrc/layer_norm.cu`` against edited copies of
itself on one NVIDIA GPU, at the LayerNorm rows of the port's main paths.

    python3 scripts/torch_layer_norm_variants.py

Each variant is the kept source with one design choice undone (the text
edits are below; the script stops if one no longer applies):

- ``kept``: the source as it is;
- ``no_pdl``: launched without programmatic dependent launch;
- ``no_prefetch``: the next row set loaded after this one is stored;
- ``gamma_at_use``: gamma and beta loaded after the statistics, not held;
- ``vecs2`` / ``vecs1``: at most 2 / 1 16-byte vectors a thread (more
  threads a row).

All are built with the port's nvcc flags, one nvcc each in parallel, into
``powerpaint_tpu_torch/_build/variants/``, and called through the same C
entry point on the same bf16 inputs. Besides them: the Triton kernel the port
used before its CUDA kernel (one program a row, BLOCK = next power of two
>= C; run only where ``triton`` imports), ``torch.nn.functional.layer_norm``,
an empty kernel (the floor of one launch in a CUDA graph), and each variant
after a residual add (``torch.add``, the kernel before every LayerNorm of a
transformer block), where the dependent launch overlaps a kernel that does
not trigger it. Times are CUDA-graph device times of 20 calls
(``chip_smoke.graph_ms``), each variant timed twice, in the order
A B ... B A. Every variant must match the plain version (bf16 tolerance of
``chip_smoke``) and be bitwise batch-invariant; the script fails otherwise.
Prints JSON lines, the card's ``nvidia-smi`` name and power limit first.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from powerpaint_tpu_torch.ops import _build, norms  # noqa: E402

SRC = (_build.CSRC / "layer_norm.cu").read_text()
OUT = _build.BUILD_DIR / "variants"

PREFETCH = ("    if (next < a.sets) load_row<T, N, VEC_IO>(raw, a, next * per_block + slot, t);\n",
            "")
LOOP_END = ("    s = next;\n  }\n}",
            "    s = next;\n    load_row<T, N, VEC_IO>(raw, a, s * per_block + slot, t);\n  }\n}")
GAMMA = ("  load_affine<N, VEC, VEC_IO>(gm, bt, a, t);\n", "")
GAMMA_USE = ("    uint4 out[N];\n",
             "    load_affine<N, VEC, VEC_IO>(gm, bt, a, t);\n    uint4 out[N];\n")
PDL = ("attr[0].val.programmaticStreamSerializationAllowed = 1;",
       "attr[0].val.programmaticStreamSerializationAllowed = 0;")
VECS = "constexpr int TARGET_VECS = 3;"

VARIANTS = {
    "kept": (),
    "no_pdl": (PDL,),
    "no_prefetch": (PREFETCH, LOOP_END),
    "gamma_at_use": (GAMMA, GAMMA_USE),
    "vecs2": ((VECS, VECS.replace("3", "2")),),
    "vecs1": ((VECS, VECS.replace("3", "1")),),
}
EMPTY = """
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int ppt_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""


def build() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {"empty": EMPTY}
    for name, edits in VARIANTS.items():
        text = SRC
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"variant {name}: the edit no longer applies: {old!r}")
            text = text.replace(old, new)
        sources[name] = text
    procs = {}
    for name, text in sources.items():
        src = OUT / f"ln_{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(OUT / f"libln_{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"libln_{name}.so"))
        if name == "empty":
            lib.ppt_empty.argtypes = [ctypes.c_void_p]
            libs[name] = lib.ppt_empty
            continue
        fn = lib.ppt_layer_norm
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        libs[name] = fn
    return libs


def triton_layer_norm():
    """The Triton kernel the port used before (one program a row), or None."""
    try:
        import triton
        import triton.language as tl
    except ImportError:
        return None

    @triton.jit
    def kernel(X, Y, W, B, C, eps, BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        m = cols < C
        x = tl.load(X + row * C + cols, mask=m, other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=0) / C
        d = tl.where(m, x - mean, 0.0)
        var = tl.sum(d * d, axis=0) / C
        rstd = 1.0 / tl.sqrt(var + eps)
        w = tl.load(W + cols, mask=m, other=0.0).to(tl.float32)
        bias = tl.load(B + cols, mask=m, other=0.0).to(tl.float32)
        tl.store(Y + row * C + cols, (d * rstd * w + bias).to(Y.dtype.element_ty), mask=m)

    def run(x, w, b, out, eps):
        c = x.shape[-1]
        kernel[(x.numel() // c,)](x, out, w, b, c, eps, BLOCK=1 << (c - 1).bit_length(),
                                  num_warps=4 if c <= 1024 else 8)

    return run


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    libs = build()
    tri = triton_layer_norm()
    dev = torch.device("cuda", 0)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    gen = torch.Generator(device=dev).manual_seed(0)
    names = list(VARIANTS) + (["triton"] if tri else [])
    for shape, eps in cs.LN_SHAPES:
        c = shape[-1]
        x = (torch.randn(shape, generator=gen, device=dev) * 3 + 0.5).to(torch.bfloat16)
        big = torch.randn((2 * shape[0],) + shape[1:], generator=gen,
                          device=dev).to(torch.bfloat16)
        w = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
        b = 0.1 * torch.randn(c, generator=gen, device=dev)
        want = norms.layer_norm_plain(x, w, b, eps=eps)
        tol = cs.tolerance(torch.bfloat16, want)
        out, res = torch.empty_like(x), torch.empty_like(x)

        def call(name, src=x, dst=out):
            if name == "triton":
                return tri(src, w, b, dst, eps)
            err = libs[name](src.data_ptr(), w.data_ptr(), b.data_ptr(), dst.data_ptr(),
                             src.numel() // c, c, eps, 1, stream())
            if err:
                sys.exit(f"{name}: CUDA error {err}")

        row = dict(shape=list(shape), ms={}, after_add_ms={})
        for name in names + names[::-1]:
            call(name)
            torch.cuda.synchronize()
            err = float((out.float() - want.float()).abs().max())
            if err > tol:
                sys.exit(f"{name} {shape}: max |err| {err} beyond {tol}")
            row["ms"].setdefault(name, []).append(cs.graph_ms(lambda n=name: call(n)))
            if name == "triton":
                continue
            row["after_add_ms"].setdefault(name, []).append(cs.graph_ms(
                lambda n=name: (torch.add(x, x, out=res), call(n, res))))
        for name in VARIANTS:
            many, few = torch.empty_like(big), torch.empty_like(x)
            call(name, big, many)
            call(name, big[: shape[0]], few)
            if not torch.equal(many[: shape[0]], few):
                sys.exit(f"{name} {shape}: batch-variant")
        row["add_alone_ms"] = cs.graph_ms(lambda: torch.add(x, x, out=res))
        row["empty_kernel_ms"] = cs.graph_ms(lambda: libs["empty"](stream()))
        wl, bl = w.to(torch.bfloat16), b.to(torch.bfloat16)
        row["library_ms"] = cs.graph_ms(
            lambda: torch.nn.functional.layer_norm(x, (c,), wl, bl, eps))
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
