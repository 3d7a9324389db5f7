// LayerNorm over the last axis of a (rows, C) tensor for Hopper (sm_90a),
// bound with ctypes.
//
// Replaces the TPU kernel powerpaint_tpu/ops/norms_pallas.py::_ln_kernel
// (layer_norm_fused): y = (x - mean) * rsqrt(var + eps) * gamma + beta per
// row, statistics in fp32, gamma and beta fp32, y in x's dtype (fp32 or
// bf16). The TPU kernel takes the one-pass E[x^2] - mean^2; this one keeps
// two passes over the row, as the plain version does.
//
// What bounds it: bytes. At (2, 4096, 320) bf16 a read and a write of x is
// 10.5 MB, 0.0031 ms at 3.35 TB/s, against a few operations an element. At
// the main paths' other maps (128 to 2048 rows) the time is the launch and
// the latency of one load, two reductions and one store, so the chain of
// dependent steps a thread takes for a row has to be short.
//
// Design.
// - A row lives in the registers of a group of G threads, at most
//   TARGET_VECS 16-byte vectors a thread: a power of two up to 32 lanes of
//   one warp where that holds the row (C 320 bf16: 16 lanes, 8 rows a
//   block of 128; C 640 and 768: a warp, 4 rows a block), else whole warps,
//   a block a row (C 1280 bf16: 2 warps; C 2048 fp32: 6). Thread t of a
//   group holds vectors t, t + G, t + 2G, ... so neighbouring threads read
//   neighbouring 16 bytes.
// - Mean and variance are two passes over the registers: in the thread, a
//   fixed interleave of four sums over its elements; across the group, a
//   butterfly of shuffles (every lane ends with the same bits); across the
//   warps of a row, one float a warp through shared memory and a block
//   barrier, summed in warp order. A group within a warp takes no barrier
//   and no shared memory. Explicit _rn intrinsics, so nothing is contracted
//   into an FMA differently in one instantiation than in another.
// - 16-byte loads and stores where the row's byte length and every pointer
//   are 16-byte aligned (one instantiation), element loads otherwise (a
//   second), on the same thread-to-element map. The map, and with it every
//   rounding, depends on C and the element size alone: never on the row
//   count, the batch, the alignment or the grid, so the kernel is
//   batch-invariant and deterministic bit for bit.
// - gamma and beta are loaded once a thread, into registers, while the
//   block walks its rows with a grid stride; once a row is in fp32
//   registers, the loads of the block's next row are issued into the
//   registers it came from, so they are in flight while this row is
//   reduced and stored.
// - The grid is one wave at most: the SMs times the blocks an SM holds at
//   the compiled register count (asked of the occupancy API once per
//   instantiation), so every main-path map but the largest is in flight at
//   once, and there each block takes two row sets at most.
// - Programmatic dependent launch: the kernel waits (griddepcontrol.wait)
//   for the kernel before it before it reads anything, and lets the next
//   one launch at once, so the launch overlaps the tail of the kernel before.
// - C is at most MAX_C = 2048 elements.
// scripts/torch_layer_norm_variants.py times this design on the card against
// copies with one choice undone (PERF.md has the numbers): without the
// dependent launch each map takes about 0.5 us more; without the prefetch,
// or with fewer vectors a thread, (2, 4096, 320) is slower; gamma and beta
// loaded at use tie at the smaller maps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TARGET_VECS = 3;          // 16-byte vectors a thread holds, at most
constexpr int MAX_C = 2048;
constexpr int WARP_ROWS_THREADS = 128;  // a block where a row takes part of a warp
constexpr int MAX_THREADS = 256;        // a block where a row takes whole warps
constexpr int MIN_BLOCKS = 2;           // __launch_bounds__: at most 128 registers a thread

// How a row of C elements is cut (mirrored by ops/norms.py::ln_plan).
struct Plan {
  int group;    // threads holding one row
  int vecs;     // 16-byte vectors a thread holds
  int threads;  // threads a block
  int rows;     // rows a block holds at once: threads / group
};

Plan plan_ln(int C, int esize) {
  Plan p{};
  const int nv = (C + 16 / esize - 1) / (16 / esize);
  int group = 1;
  while (group < 32 && group * TARGET_VECS < nv) group *= 2;
  if (group * TARGET_VECS < nv) group = 32 * ((nv + 32 * TARGET_VECS - 1) / (32 * TARGET_VECS));
  p.group = group;
  p.vecs = (nv + group - 1) / group;
  p.threads = group > 32 ? group : WARP_ROWS_THREADS;
  p.rows = p.threads / group;
  return p;
}

struct Args {
  const void* x;
  const float* gamma;
  const float* beta;
  void* y;
  long long rows;
  long long sets;  // row sets: ceil(rows / plan.rows)
  int C;
  int group;
  int shift;  // log2(group) where group <= 32
  float eps;
};

// Element k of a 16-byte vector, in fp32.
template <typename T>
__device__ __forceinline__ float get(const uint4& v, int k);
template <>
__device__ __forceinline__ float get<float>(const uint4& v, int k) {
  return __uint_as_float((&v.x)[k]);
}
template <>
__device__ __forceinline__ float get<bf16>(const uint4& v, int k) {
  const uint32_t w = (&v.x)[k >> 1];
  return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
}

// Elements k, k + 1 of a 16-byte vector from fp32, rounded to T.
template <typename T>
__device__ __forceinline__ void put2(uint4& v, int k, float a, float b);
template <>
__device__ __forceinline__ void put2<float>(uint4& v, int k, float a, float b) {
  (&v.x)[k] = __float_as_uint(a);
  (&v.x)[k + 1] = __float_as_uint(b);
}
template <>
__device__ __forceinline__ void put2<bf16>(uint4& v, int k, float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
  (&v.x)[k >> 1] = *reinterpret_cast<const uint32_t*>(&h);
}

// This thread's vectors of `row`, zeros past C and past the last row:
// 16-byte loads (VEC_IO: C a whole number of vectors, x aligned), else
// element loads into the same places.
template <typename T, int N, bool VEC_IO>
__device__ __forceinline__ void load_row(uint4 (&r)[N], const Args& a, long long row, int t) {
  constexpr int VEC = 16 / sizeof(T);
  const bool in = row < a.rows;
  const T* xr = static_cast<const T*>(a.x) + row * a.C;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int e0 = (j * a.group + t) * VEC;
    r[j] = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (VEC_IO) {
      if (in && e0 < a.C) r[j] = __ldg(reinterpret_cast<const uint4*>(xr + e0));
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        if (!in || e0 + k >= a.C) continue;
        if constexpr (sizeof(T) == 4)
          (&r[j].x)[k] = __ldg(reinterpret_cast<const unsigned int*>(xr) + e0 + k);
        else
          (&r[j].x)[k >> 1] |=
              (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(xr) + e0 + k)
              << (16 * (k & 1));
      }
    }
  }
}

template <typename T, int N, bool VEC_IO>
__device__ __forceinline__ void store_row(const uint4 (&r)[N], const Args& a, long long row,
                                          int t) {
  constexpr int VEC = 16 / sizeof(T);
  T* yr = static_cast<T*>(a.y) + row * a.C;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int e0 = (j * a.group + t) * VEC;
    if constexpr (VEC_IO) {
      if (e0 < a.C) *reinterpret_cast<uint4*>(yr + e0) = r[j];
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        if (e0 + k >= a.C) continue;
        if constexpr (sizeof(T) == 4)
          reinterpret_cast<unsigned int*>(yr)[e0 + k] = (&r[j].x)[k];
        else
          reinterpret_cast<unsigned short*>(yr)[e0 + k] =
              (unsigned short)((&r[j].x)[k >> 1] >> (16 * (k & 1)));
      }
    }
  }
}

// gamma and beta of this thread's elements (zeros past C), four at a time.
template <int N, int VEC, bool VEC_IO>
__device__ __forceinline__ void load_affine(float (&gm)[N * VEC], float (&bt)[N * VEC],
                                            const Args& a, int t) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int e0 = (j * a.group + t) * VEC;
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      float4 gv = make_float4(0.f, 0.f, 0.f, 0.f), bv = gv;
      if constexpr (VEC_IO) {
        if (e0 + k < a.C) {
          gv = __ldg(reinterpret_cast<const float4*>(a.gamma + e0 + k));
          bv = __ldg(reinterpret_cast<const float4*>(a.beta + e0 + k));
        }
      } else {
        float* gp = &gv.x;
        float* bp = &bv.x;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (e0 + k + i < a.C) {
            gp[i] = __ldg(a.gamma + e0 + k + i);
            bp[i] = __ldg(a.beta + e0 + k + i);
          }
      }
      const int i = j * VEC + k;
      gm[i] = gv.x, gm[i + 1] = gv.y, gm[i + 2] = gv.z, gm[i + 3] = gv.w;
      bt[i] = bv.x, bt[i + 1] = bv.y, bt[i + 2] = bv.z, bt[i + 3] = bv.w;
    }
  }
}

// The sum of v over the row's group, the same bits in every thread: a
// butterfly over the group's lanes (up to a warp), then, for a row of
// several warps (the whole block), one value a warp through `part` in warp
// order. Two slots of `part` alternate (mean, variance): each slot is read
// before the next barrier, and written again only after it.
__device__ __forceinline__ float row_sum(float v, int group, float* part) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < group) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (group <= 32) return v;
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  v = part[0];
#pragma unroll
  for (int w = 1; w < MAX_THREADS / 32; ++w)
    if (w < group / 32) v = __fadd_rn(v, part[w]);
  return v;
}

template <typename T, int N, bool VEC_IO>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS) ln_kernel(const Args a) {
  constexpr int VEC = 16 / sizeof(T), E = N * VEC;
  static_assert(E <= 32, "the valid mask is 32 bits");
  __shared__ float part[2][MAX_THREADS / 32];
  const bool warps = a.group > 32;  // a row takes the whole block
  const int t = warps ? (int)threadIdx.x : (int)threadIdx.x & (a.group - 1);
  const int slot = warps ? 0 : (int)threadIdx.x >> a.shift;
  const int per_block = warps ? 1 : (int)blockDim.x >> a.shift;
  long long s = blockIdx.x;  // the grid is at most a.sets blocks
  // Launched with programmatic stream serialization: the kernel before may
  // still be running. Nothing of global memory is read before it is done;
  // the next kernel, if launched so too, may start now and waits likewise.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" :::);

  uint4 raw[N];
  load_row<T, N, VEC_IO>(raw, a, s * per_block + slot, t);
  float gm[E], bt[E];
  load_affine<N, VEC, VEC_IO>(gm, bt, a, t);
  // bit i = j * VEC + k: element (j * group + t) * VEC + k is in the row
  uint32_t valid = 0;
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if ((j * a.group + t) * VEC + (VEC_IO ? 0 : k) < a.C) valid |= 1u << (j * VEC + k);
  const float c = (float)a.C;

  for (;;) {
    const long long row = s * per_block + slot;
    float v[E];
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[j * VEC + k] = get<T>(raw[j], k);
    const long long next = s + gridDim.x;
    if (next < a.sets) load_row<T, N, VEC_IO>(raw, a, next * per_block + slot, t);

    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < E; ++i) acc[i & 3] = __fadd_rn(acc[i & 3], v[i]);
    const float mean = __fdiv_rn(
        row_sum(__fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3])), a.group, part[0]),
        c);
    acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      v[i] = (valid >> i) & 1 ? __fsub_rn(v[i], mean) : 0.f;
      acc[i & 3] = __fmaf_rn(v[i], v[i], acc[i & 3]);
    }
    const float var = __fdiv_rn(
        row_sum(__fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3])), a.group, part[1]),
        c);
    const float rstd = rsqrtf(__fadd_rn(var, a.eps));

    uint4 out[N];
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int k = 0; k < VEC; k += 2) {
        const int i = j * VEC + k;
        put2<T>(out[j], k, __fmaf_rn(__fmul_rn(v[i], rstd), gm[i], bt[i]),
                __fmaf_rn(__fmul_rn(v[i + 1], rstd), gm[i + 1], bt[i + 1]));
      }
    if (row < a.rows) store_row<T, N, VEC_IO>(out, a, row, t);
    if (next >= a.sets) break;
    s = next;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Blocks of `threads` an SM holds for this instantiation, asked once.
template <typename T, int N, bool VEC_IO>
int resident_blocks(int threads) {
  static int cache[MAX_THREADS / 32 + 1] = {};
  int& n = cache[threads / 32];
  if (n == 0 && (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ln_kernel<T, N, VEC_IO>,
                                                               threads, 0) != cudaSuccess ||
                 n <= 0))
    n = 1;
  return n;
}

// One wave at most; programmatic dependent launch, so the launch and the
// prologue overlap the end of the kernel before (see ln_kernel).
template <typename T, int N, bool VEC_IO>
cudaError_t launch(const Args& a, const Plan& p, cudaStream_t s) {
  const long long wave = (long long)hopper::sm_count() * resident_blocks<T, N, VEC_IO>(p.threads);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)std::min<long long>(a.sets, wave), 1, 1);
  cfg.blockDim = dim3(p.threads, 1, 1);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, ln_kernel<T, N, VEC_IO>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, bool VEC_IO>
cudaError_t dispatch(const Args& a, const Plan& p, cudaStream_t s) {
  static_assert(TARGET_VECS <= 3, "one instantiation for each vector count");
  switch (p.vecs) {
    case 1: return launch<T, 1, VEC_IO>(a, p, s);
    case 2: return launch<T, 2, VEC_IO>(a, p, s);
    case 3: return launch<T, 3, VEC_IO>(a, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The plan for rows of C elements of `esize` bytes: out[0..3] = group, vecs,
// threads, rows.
extern "C" void ppt_layer_norm_plan(int C, int esize, long long* out) {
  const Plan p = plan_ln(C, esize);
  const long long v[4] = {p.group, p.vecs, p.threads, p.rows};
  for (int i = 0; i < 4; ++i) out[i] = v[i];
}

// x, y: (rows, C) fp32 or bf16 (is_bf16), contiguous; gamma, beta: (C) fp32.
// C from 1 to 2048. Returns the CUDA error code.
extern "C" int ppt_layer_norm(const void* x, const float* gamma, const float* beta, void* y,
                              long long rows, int C, float eps, int is_bf16, void* stream) {
  if (rows <= 0 || C <= 0 || C > MAX_C || x == nullptr || gamma == nullptr || beta == nullptr ||
      y == nullptr)
    return (int)cudaErrorInvalidValue;
  const int esize = is_bf16 ? 2 : 4;
  const Plan p = plan_ln(C, esize);
  const bool vec = (C * esize) % 16 == 0 && aligned16(x) && aligned16(y) && aligned16(gamma) &&
                   aligned16(beta);
  int shift = 0;
  while ((1 << shift) < p.group) ++shift;
  const Args a{x, gamma, beta, y, rows, (rows + p.rows - 1) / p.rows, C, p.group, shift, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)(vec ? dispatch<bf16, true>(a, p, s) : dispatch<bf16, false>(a, p, s));
  return (int)(vec ? dispatch<float, true>(a, p, s) : dispatch<float, false>(a, p, s));
}
