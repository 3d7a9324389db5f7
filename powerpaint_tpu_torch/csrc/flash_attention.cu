// Non-causal flash attention forward for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel powerpaint_tpu/ops/flash_attention.py::_flash_kernel
// (launched by _flash_bnsd's pl.pallas_call). Same function: online-softmax
// attention with fp32 running max, denominator and accumulator, the softmax
// scale times log2(e) folded into q and exp2 in place of exp, ragged q rows
// and kv columns masked.
//
// Common design (first versions: simple and right, not yet at the bound):
// - One block of 128 threads per (batch*head, 64-row q tile, slice of
//   head-dim output columns). The TPU's sequential kv grid axis is a loop
//   over 64-row kv tiles inside the block; m, l and the output accumulator
//   live in registers for the whole loop.
// - (B, S, N, D) is read through its strides (D contiguous), so the host
//   needs no transpose copy. q rows >= Sq and kv rows >= Skv are loaded as
//   zeros; their scores are masked to -1e30 and their rows never stored.
// - The TPU's ones-column on v is gone: each row keeps its own l.
// - The output columns are split over gridDim.z in slices of 8*NC columns,
//   NC chosen per D (40 -> one slice of 40, 80 -> 80, 160 -> two of 80,
//   512 -> four of 128), so the accumulator stays at most 64 floats per
//   thread. A slice recomputes the scores; at D = 512 (the VAE's one-head
//   attention) that is the price of fitting in registers, where a 64x512
//   fp32 accumulator would not.
//
// bf16 (the main path): flash_bf16_kernel runs both products on the tensor
// cores with mma.sync m16n8k16 (bf16 operands, fp32 accumulation). Each of
// the 4 warps owns 16 q rows. q (pre-scaled, rounded to bf16 as the TPU
// kernel does) and k tiles sit row-major in shared memory with the head dim
// zero-padded to a multiple of 16 (40 -> 48); v is stored transposed so
// that each B fragment is one 32-bit shared load. The score fragments are
// exponentiated in registers and reused as the A operand of P @ V (the
// m16n8 accumulator layout of two adjacent score tiles is the m16k16
// operand layout), so P never goes through shared memory. Global loads are
// 16 bytes wide where D and the strides are multiples of 8. Bound on the
// card: the tensor-core rate at SD head dims, but this version is held
// back by what it does not overlap: tile loads are synchronous (no
// cp.async / TMA pipeline) and mma.sync reaches only part of the wgmma
// rate.
//
// fp32 (checks and the CPU-comparable reference): flash_f32_kernel does all
// arithmetic as fp32 FMA on the CUDA cores (67 TFLOP/s on an H100 SXM), a
// 4x8 register tile of scores per thread fed from shared memory in
// head-dim chunks of 32, so any D works.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // kv rows per tile
constexpr int THREADS = 128;  // 4 warps
constexpr float NEG_BIG = -1e30f;

struct Strides {
  long long b, s, n;
};

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMA
// ---------------------------------------------------------------------------

constexpr int DC = 32;  // head-dim chunk for the score product

template <int NC>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         (BQ * (DC + 1) + BK * (DC + 1) + BQ * (BK + 1) + BK * (8 * NC + 1));
}

template <int NC>
__global__ void __launch_bounds__(THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int N,
                 int Sq, int Skv, int D, Strides qs, Strides ks, Strides vs,
                 Strides os, float scale_log2) {
  constexpr int DO = 8 * NC;  // output columns of this block
  extern __shared__ float smem_f32[];
  float* Qs = smem_f32;            // [BQ][DC + 1]
  float* Ks = Qs + BQ * (DC + 1);  // [BK][DC + 1]
  float* Ps = Ks + BK * (DC + 1);  // [BQ][BK + 1]
  float* Vs = Ps + BQ * (BK + 1);  // [BK][DO + 1]

  // thread (ty, tx) owns rows 4*ty..4*ty+3 and kv columns / output columns
  // tx + 8*j; row max and row sum reduce over the 8 tx lanes
  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / N;
  const int h = blockIdx.y % N;
  const int d0 = blockIdx.z * DO;
  const float* qb = q + b * qs.b + h * qs.n;
  const float* kb = k + b * ks.b + h * ks.n;
  const float* vb = v + b * vs.b + h * vs.n;
  float* ob = o + b * os.b + h * os.n;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int kv0 = 0; kv0 < Skv; kv0 += BK) {
    // ---- scores s = (q * scale * log2 e) @ k^T for this kv tile ----
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;

    for (int dc0 = 0; dc0 < D; dc0 += DC) {
      __syncthreads();  // earlier readers of Qs/Ks/Ps/Vs are done
      for (int idx = tid; idx < BQ * DC; idx += THREADS) {
        const int r = idx / DC, c = idx % DC;
        const int qi = q0 + r, d = dc0 + c;
        Qs[r * (DC + 1) + c] =
            (qi < Sq && d < D) ? qb[qi * qs.s + d] * scale_log2 : 0.f;
      }
      for (int idx = tid; idx < BK * DC; idx += THREADS) {
        const int r = idx / DC, c = idx % DC;
        const int ki = kv0 + r, d = dc0 + c;
        Ks[r * (DC + 1) + c] = (ki < Skv && d < D) ? kb[ki * ks.s + d] : 0.f;
      }
      __syncthreads();
      const int dlen = min(DC, D - dc0);
#pragma unroll 8
      for (int c = 0; c < dlen; ++c) {
        float a[4], bk[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * (DC + 1) + c];
#pragma unroll
        for (int j = 0; j < 8; ++j) bk[j] = Ks[(tx + 8 * j) * (DC + 1) + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
      }
    }

    // ---- online softmax in log2 units ----
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_BIG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (kv0 + tx + 8 * j >= Skv) s[i][j] = NEG_BIG;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        s[i][j] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }

    // ---- acc += p @ v[:, d0:d0+DO] ----
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) Ps[(ty * 4 + i) * (BK + 1) + tx + 8 * j] = s[i][j];
    for (int idx = tid; idx < BK * DO; idx += THREADS) {
      const int r = idx / DO, c = idx % DO;
      const int ki = kv0 + r, d = d0 + c;
      Vs[r * (DO + 1) + c] = (ki < Skv && d < D) ? vb[ki * vs.s + d] : 0.f;
    }
    __syncthreads();
    const int kmax = min(BK, Skv - kv0);
#pragma unroll 4
    for (int j = 0; j < kmax; ++j) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[j * (DO + 1) + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 1.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = d0 + tx + 8 * c;
      if (d < D) ob[row * os.s + d] = acc[i][c] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;
constexpr int LDV = BK + 8;  // row stride of the transposed v tile

union Pack8 {  // eight bf16 (as raw 16-bit words) in one 16-byte word
  uint4 u;
  unsigned short h[8];
};

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a @ b: a 16x16 (row), b 16x8 (col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Eight consecutive head-dim values of one row, zero past the row count or
// past D; 16-byte loads when `vec` (D and the strides multiples of 8, the
// base 16-byte aligned), else element by element.
__device__ __forceinline__ Pack8 load8(const bf16* base, long long stride,
                                       int row, int rows, int col, int D,
                                       bool vec) {
  Pack8 p;
  p.u = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows || col >= D) return p;
  const bf16* src = base + row * stride + col;
  if (vec) {
    p.u = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (col + e < D) p.h[e] = __bfloat16_as_ushort(src[e]);
  }
  return p;
}

template <int NT>
__global__ void __launch_bounds__(THREADS)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int N,
                  int Sq, int Skv, int D, int DP, Strides qs, Strides ks,
                  Strides vs, Strides os, float scale_log2, bool vec) {
  constexpr int DO = 8 * NT;  // output columns of this block
  const int ld = DP + 8;      // row stride of the q and k tiles
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_bf16);  // [BQ][ld]
  bf16* Ks = Qs + BQ * ld;                        // [BK][ld]
  bf16* Vt = Ks + BK * ld;                        // [DO][LDV], v transposed

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;  // fragment row group
  const int t4 = tid & 3;         // thread in group
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / N;
  const int h = blockIdx.y % N;
  const int d0 = blockIdx.z * DO;
  const bf16* qb = q + b * qs.b + h * qs.n;
  const bf16* kb = k + b * ks.b + h * ks.n;
  const bf16* vb = v + b * vs.b + h * vs.n;
  bf16* ob = o + b * os.b + h * os.n;
  const int chunks = DP / 8;

  // q tile, times scale * log2 e, rounded to bf16
  for (int idx = tid; idx < BQ * chunks; idx += THREADS) {
    const int r = idx / chunks, c = (idx % chunks) * 8;
    Pack8 p = load8(qb, qs.s, q0 + r, Sq, c, D, vec);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      p.h[e] = __bfloat16_as_ushort(__float2bfloat16(
          __bfloat162float(__ushort_as_bfloat16(p.h[e])) * scale_log2));
    *reinterpret_cast<uint4*>(Qs + r * ld + c) = p.u;
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = NEG_BIG, m1 = NEG_BIG;  // rows g and g + 8 of this warp
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums
  const bf16* qr0 = Qs + (warp * 16 + g) * ld;
  const bf16* qr1 = qr0 + 8 * ld;

  for (int kv0 = 0; kv0 < Skv; kv0 += BK) {
    __syncthreads();  // earlier readers of Ks / Vt are done
    for (int idx = tid; idx < BK * chunks; idx += THREADS) {
      const int r = idx / chunks, c = (idx % chunks) * 8;
      *reinterpret_cast<uint4*>(Ks + r * ld + c) =
          load8(kb, ks.s, kv0 + r, Skv, c, D, vec).u;
    }
    // neighbouring threads take neighbouring kv rows, so the transposed
    // 16-bit stores of a warp fall in distinct banks
    for (int idx = tid; idx < BK * NT; idx += THREADS) {
      const int r = idx % BK, c = (idx / BK) * 8;
      const Pack8 p = load8(vb, vs.s, kv0 + r, Skv, d0 + c, D, vec);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(c + e) * LDV + r] = __ushort_as_bfloat16(p.h[e]);
    }
    __syncthreads();

    // ---- scores: 16 rows x 64 kv columns per warp, 8 tiles of 16x8 ----
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int kc = 0; kc < DP; kc += 16) {
      const uint32_t a[4] = {lds32(qr0 + kc + 2 * t4), lds32(qr1 + kc + 2 * t4),
                             lds32(qr0 + kc + 8 + 2 * t4),
                             lds32(qr1 + kc + 8 + 2 * t4)};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* kr = Ks + (j * 8 + g) * ld + kc + 2 * t4;
        mma_16816(s[j], a, lds32(kr), lds32(kr + 8));
      }
    }

    // ---- online softmax in log2 units; rows g (e = 0, 1), g + 8 (2, 3) ----
    float mx0 = NEG_BIG, mx1 = NEG_BIG;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = kv0 + j * 8 + 2 * t4;
      if (col >= Skv) s[j][0] = s[j][2] = NEG_BIG;
      if (col + 1 >= Skv) s[j][1] = s[j][3] = NEG_BIG;
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // ---- acc += p @ v[:, d0:d0+DO], p straight from the score tiles ----
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* vr = Vt + (n * 8 + g) * LDV + kk * 16 + 2 * t4;
        mma_16816(acc[n], a, lds32(vr), lds32(vr + 8));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 1.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 1.f;
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = d0 + n * 8 + 2 * t4;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (col + e >= D) continue;
      if (row0 < Sq) ob[row0 * os.s + col + e] = __float2bfloat16(acc[n][e] * inv0);
      if (row1 < Sq) ob[row1 * os.s + col + e] = __float2bfloat16(acc[n][2 + e] * inv1);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, N, Sq, Skv, D;
  Strides qs, ks, vs, os;
  float scale_log2;
  cudaStream_t stream;
};

template <int NC>
cudaError_t launch_f32(const Args& a) {
  constexpr size_t smem = f32_smem_bytes<NC>();
  auto kernel = flash_f32_kernel<NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.N, (a.D + 8 * NC - 1) / (8 * NC));
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.N, a.Sq,
      a.Skv, a.D, a.qs, a.ks, a.vs, a.os, a.scale_log2);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int NT>
cudaError_t launch_bf16(const Args& a) {
  const int dp = (a.D + 15) / 16 * 16;  // head dim padded for k16 steps
  const size_t smem =
      sizeof(bf16) * ((size_t)(BQ + BK) * (dp + 8) + (size_t)8 * NT * LDV);
  const Strides* in[3] = {&a.qs, &a.ks, &a.vs};
  bool vec = a.D % 8 == 0 && aligned16(a.q) && aligned16(a.k) &&
             aligned16(a.v);
  for (const Strides* s : in)
    vec = vec && s->b % 8 == 0 && s->s % 8 == 0 && s->n % 8 == 0;
  auto kernel = flash_bf16_kernel<NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.N, (a.D + 8 * NT - 1) / (8 * NT));
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.N, a.Sq,
      a.Skv, a.D, dp, a.qs, a.ks, a.vs, a.os, a.scale_log2, vec);
  return cudaGetLastError();
}

// Output columns per block are 8*NC for NC in {5, 8, 10, 16}: the choice
// with the fewest column slices (each recomputes the scores), then the
// least padding.
int pick_nc(int D) {
  const int options[4] = {5, 8, 10, 16};
  int best = 16, best_slices = 1 << 30, best_cols = 1 << 30;
  for (int nc : options) {
    const int slices = (D + 8 * nc - 1) / (8 * nc);
    const int cols = slices * 8 * nc;
    if (slices < best_slices || (slices == best_slices && cols < best_cols)) {
      best = nc;
      best_slices = slices;
      best_cols = cols;
    }
  }
  return best;
}

cudaError_t dispatch(const Args& a, bool is_bf16) {
  switch (pick_nc(a.D)) {
    case 5: return is_bf16 ? launch_bf16<5>(a) : launch_f32<5>(a);
    case 8: return is_bf16 ? launch_bf16<8>(a) : launch_f32<8>(a);
    case 10: return is_bf16 ? launch_bf16<10>(a) : launch_f32<10>(a);
    default: return is_bf16 ? launch_bf16<16>(a) : launch_f32<16>(a);
  }
}

}  // namespace

// q, k, v: (B, Sq|Skv, N, D) and o: (B, Sq, N, D), all of one dtype (fp32
// or bf16), D contiguous. strides: 12 element strides, (batch, seq, head)
// for q, k, v, o in that order. Returns the CUDA error code of the launch.
extern "C" int ppt_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, int is_bf16, int B, int N, int Sq,
                                   int Skv, int D, const long long* strides,
                                   float scale_log2, void* stream) {
  if (B <= 0 || N <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || B * N > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, B, N, Sq, Skv, D,
               Strides{strides[0], strides[1], strides[2]},
               Strides{strides[3], strides[4], strides[5]},
               Strides{strides[6], strides[7], strides[8]},
               Strides{strides[9], strides[10], strides[11]},
               scale_log2, static_cast<cudaStream_t>(stream)};
  return (int)dispatch(a, is_bf16 != 0);
}
