// Non-causal flash attention forward for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel powerpaint_tpu/ops/flash_attention.py::_flash_kernel
// (launched by _flash_bnsd's pl.pallas_call). Same function: online-softmax
// attention with fp32 running max, denominator and accumulator, the softmax
// scale times log2(e) folded into q (rounded to the input type, as the TPU
// kernel does) and exp2 in place of exp, ragged q rows and kv columns
// masked. Every block owns its q rows and loops over all kv tiles in one
// order, so a row's result does not depend on the batch or on the run.
// (B, S, N, D) is read through its strides (D contiguous): no host copy.
//
// bf16 (the main path), flash_bf16_kernel. What bounds it on an H100: the
// tensor-core rate (4 B S^2 N D operations at 989 TFLOP/s: 0.043 ms at the
// UNet's (2, 4096, 4096, 8, 40)) and, at D = 40, the exp2 rate as well: one
// MUFU.EX2 per score, 16 per SM per clock, 0.064 ms at that shape, above
// the tensor-core bound. The design:
// - One block per (64 * NWG q rows, batch * head, z slice of DO output
//   columns): NWG consumer warpgroups of 64 q rows each and one producer
//   warpgroup. D <= 256 is one slice; D = 512 (the VAE) two slices of 256,
//   up to 768 three and up to 1024 four (the asymmetric VAE's decoders:
//   one head over 768 or 1024 channels), each slice recomputing q k^T.
// - Products on wgmma. s = q k^T: m64nBKk16 with q and k from shared memory
//   (K-major, 128-byte swizzle), KSTEPS k16 steps over the shape's largest
//   D padded to 16 (40 -> 48; the pad zero-filled by the copies), unrolled.
//   o += p v: m64nDOk16 with p from registers (the score accumulator of
//   two neighbouring 8-column blocks is the k16 A fragment, so p never goes
//   through shared memory) and v read MN-major from the same swizzled tile
//   layout (wgmma transposes it; no transposed stores). PV at D = 40 runs
//   n40 directly.
// - Loads: the producer warpgroup fills a ring of STAGES k/v stages with
//   16-byte cp.async copies (zero-filled past Skv and D); each thread's
//   copies report to the stage's mbarrier when they land, so several stages
//   are in flight while the consumers compute; consumers free a stage
//   through a second mbarrier. q is loaded once by its consumers. D, a
//   stride or a base off 16 bytes takes element loads instead.
// - The exp2 work overlaps the products twice over: each warpgroup issues
//   tile it's q k^T and tile it - 1's p v together and exponentiates tile
//   it while p v runs (o is rescaled once it is done), and the two
//   warpgroups issue independently, so one's softmax runs under the
//   other's products.
// - Registers: setmaxnreg moves them from the producer (40) to the
//   consumers (232): DO / 2 accumulators, BK / 2 scores, two sets of p of
//   BK / 4 each.
// - Shared memory (bytes, 128-byte rows, QB = ceil(16 KSTEPS / 64)): q
//   128 * 64 * QB per warpgroup, each stage BK * 128 * (QB + ceil(DO / 64)):
//   113 KB at D = 40 (3 stages of 128 kv rows), 161 KB at D = 80, 145 KB at
//   160, 161 KB at 512 (two stages of 32 rows), 225 KB at 768 (two stages of
//   32 rows, 2 KB under the limit) and 209 KB at 1024, where q alone takes
//   128 KB and the stages shrink to 16 kv rows (q k^T on m64n16k16) so that
//   two still fit: the ring needs two, one for the tile whose p v runs and
//   one for the tile whose scores are issued beside it.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W): 0.198 ms at
// (2, 4096, 4096, 8, 40), 1.23x SDPA's 0.161 in the same run (the mma.sync
// version took 0.494); 0.461 ms at the VAE's (1, 4096, 4096, 1, 512), 1.38x
// SDPA. What holds it back: ptxas reports the wgmma of every bf16
// instantiation serialised (its C7513 warning), which can keep the exp2
// work from overlapping the products as designed, and each block re-reads
// all of k and v from L2 for 128 q rows.
//
// The log-sum-exp mode (ppt_flash_attention_lse; ring attention's hops,
// ops/ring_attention.py): the same kernels, with the output written in fp32
// (the bf16 kernel's accumulator times 1/l, unrounded, so that the ring's
// merges of partial results round to bf16 once, at the end) and each query
// row's log-sum-exp, (m + log2 l) * ln 2 of the base-2 running state, into
// a (B, N, Sq) fp32 tensor; of a head dim split into column slices, slice 0
// writes it. Without it the kernels write what they wrote before, in the
// same order.
//
// The bf16-softmax mode (ppt_flash_attention_bf16_softmax; the experiment of
// scripts/torch_perf_attn_bf16.py, no pipeline calls it): replaces the TPU
// kernel scripts/perf_attn_bf16.py::_bf16_kernel (launched by _flash_bf16's
// pl.pallas_call), a different function from the one above: the fp32 scores
// of a kv tile rounded to bf16, the running max kept in bf16, s - m_new and
// exp2 in bf16 with p fed to p v as it comes, only alpha = exp2(m_prev -
// m_new) taken in fp32 (the difference rounded to bf16 first), the row sum
// in fp32 over the bf16 p, columns past Skv set to a finite -3e38 and out =
// acc / l (1 where l = 0). So the result depends on the kv tile (BK), as the
// TPU kernel's on its block_kv. The flag changes only the softmax and the
// final division: the tiling, the ring and the wgmma products are those
// above. What bounds it on an H100: the same tensor-core time (0.043 ms at
// (2, 4096, 4096, 8, 40)) and the same exp floor, 0.064 ms there: ptxas
// issues ex2.approx.ftz.bf16x2 as two MUFU.EX2.BF16, one a half, and a
// PRMT to pack them (cuobjdump -sass, counted by chip_smoke.py:
// 128 MUFU.EX2.BF16 and 4 MUFU.EX2 in the D = 40 instantiation against
// the fp32 softmax's 132 MUFU.EX2), so the packed form halves no exp work.
// The design: the score accumulator's same-row neighbours sc[4j],
// sc[4j + 1] (row g) and sc[4j + 2], sc[4j + 3] (row g + 8) are rounded
// pairwise into bf16x2 (cvt.rn.bf16x2.f32), max.bf16x2 takes the row max,
// the two rows' maxima travel as one bf16x2 through the two shuffles, and
// sub.rn.bf16x2 then ex2.approx.ftz.bf16x2 give p as a bf16x2 that is
// already the wgmma A fragment (no pack of p; the max and the subtraction
// are one HMNMX2 / HADD2 a pair). On an H100 that instruction's p is exp2
// in fp32 cut toward zero to bf16, not rounded to nearest
// (scripts/torch_perf_attn_bf16.py reads both), and the plain version,
// flash_attention_bf16_softmax_plain, rounds so. The mode is its own library: this source
// built with PPT_FLASH_BF16_SOFTMAX defined (ops/_build.py's
// flash_attention_bf16_softmax) has its entry and only its instantiations,
// so the main paths' library neither carries nor compiles them. Measured
// (scripts/torch_perf_attn_bf16.py, NVIDIA H100 80GB HBM3 at 700 W): 0.210
// ms at (2, 4096, 4096, 8, 40) against the fp32 softmax's 0.200 in the same
// run. bf16 inputs only.
//
// fp32 (checks and the CPU-comparable reference): flash_f32_kernel does all
// arithmetic as fp32 FMA on the CUDA cores (67 TFLOP/s on an H100 SXM), a
// 4x8 register tile of scores per thread fed from shared memory in
// head-dim chunks of 32, so any D works; the output columns are split over
// gridDim.z in slices of 8 * NC.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // fp32: q rows per block
constexpr int BK = 64;        // fp32: kv rows per tile
constexpr int THREADS = 128;  // fp32: 4 warps
constexpr float NEG_BIG = -1e30f;
constexpr float NEG_BF16 = -3e38f;  // the bf16-softmax mode's mask: finite in bf16
constexpr float LN2 = 0.693147180559945309f;  // the log-sum-exp from base 2 to e

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
                 Strides os, float scale_log2, float* __restrict__ lse) {
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
    if (lse != nullptr && tx == 0 && blockIdx.z == 0)  // one column slice writes it
      lse[(long long)blockIdx.y * Sq + row] = (m[i] + log2f(l[i])) * LN2;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 1.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = d0 + tx + 8 * c;
      if (d < D) ob[row * os.s + d] = acc[i][c] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma, a producer warpgroup and a ring of kv stages
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;
using namespace hopper;

union Pack8 {  // eight bf16 (as raw 16-bit words) in one 16-byte word
  uint4 u;
  unsigned short h[8];
};

// bf16x2 arithmetic of the bf16-softmax mode; the low half is the
// lower-addressed (even) column, as pack_bf16 lays it out.
__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t a) {
  uint32_t d;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}
__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// Eight consecutive head-dim values of one row, zero past the row count or
// past D, element by element (the path for D or strides that are not a
// multiple of 8 elements, or bases not 16-byte aligned).
__device__ __forceinline__ Pack8 load8_scalar(const bf16* base, long long stride, int row,
                                              int rows, int col, int D) {
  Pack8 p;
  p.u = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows) return p;
  const bf16* src = base + row * stride + col;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (col + e < D) p.h[e] = __bfloat16_as_ushort(src[e]);
  return p;
}

struct BfParams {
  const bf16 *q, *k, *v;
  bf16* o;      // the bf16 output, or null when o32 is written instead
  float* o32;   // the fp32 output of the log-sum-exp mode, or null
  float* lse;   // (B, N, Sq) fp32 log-sum-exp in natural-log units, or null
  int N, Sq, Skv, D;
  Strides qs, ks, vs, os;
  float scale_log2;
  bool vec;  // 16-byte copies: D and the strides multiples of 8, bases aligned
};

// The two products of a consumer warpgroup by shape: scores 64 x BK (A = q,
// B = k, both from shared memory), output 64 x DO (A = p from registers,
// B = v).
template <int BK>
struct ScoreMma;
template <>
struct ScoreMma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b, int s) {
    wgmma_ss_n128(d, a, b, s);
  }
};
template <>
struct ScoreMma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b, int s) {
    wgmma_ss_n64(d, a, b, s);
  }
};
template <>
struct ScoreMma<16> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t a, uint64_t b, int s) {
    wgmma_ss_n16(d, a, b, s);
  }
};
template <>
struct ScoreMma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b, int s) {
    wgmma_ss_n32(d, a, b, s);
  }
};
template <int DO>
struct ValueMma;
#define PPT_VALUE_MMA(N)                                                              \
  template <>                                                                         \
  struct ValueMma<N> {                                                                \
    static __device__ __forceinline__ void run(float (&d)[N / 2], const uint32_t (&a)[4], \
                                               uint64_t b) {                         \
      wgmma_rs_n##N(d, a, b, 1);                                                      \
    }                                                                                 \
  };
PPT_VALUE_MMA(40)
PPT_VALUE_MMA(64)
PPT_VALUE_MMA(80)
PPT_VALUE_MMA(160)
PPT_VALUE_MMA(256)
#undef PPT_VALUE_MMA

// DO output columns per block (one z slice), BK kv rows per stage, NWG
// consumer warpgroups of 64 q rows each, STAGES kv stages in the ring,
// KSTEPS k16 steps of q k^T (the head dims the shape takes, zero-padded);
// BSM: the bf16-softmax mode.
template <int DO, int BK, int NWG, int STAGES, int KSTEPS, bool BSM>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
    flash_bf16_kernel(const BfParams p) {
  constexpr int VB = (DO + 63) / 64;          // 64-column blocks of a v tile
  constexpr int VC = DO / 8;                  // 16-byte chunks of a v row
  constexpr int QB = (KSTEPS * 16 + 63) / 64;  // 64-column blocks of a q or k tile
  constexpr int KC = KSTEPS * 2;              // 16-byte chunks of a q or k row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;  // [NWG][QB][64][128 B]
  const uint32_t k_s = q_s + NWG * QB * 64 * 128;               // [STAGES][QB][BK][128 B]
  const uint32_t v_s = k_s + STAGES * QB * BK * 128;            // [STAGES][VB][BK][128 B]
  const uint32_t full = v_s + STAGES * VB * BK * 128;           // [STAGES] mbarriers
  const uint32_t empty = full + STAGES * 8;                     // [STAGES]
  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // warpgroups 0 .. NWG - 1 compute, NWG loads
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 128);      // every producer thread's copies
      mbar_init(empty + 8 * s, NWG * 4); // every consumer warp done reading
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int b = blockIdx.y / p.N;
  const int h = blockIdx.y % p.N;
  const int d0 = blockIdx.z * DO;
  const int n_tiles = (p.Skv + BK - 1) / BK;

  if (wg == NWG) {
    // ---- producer: k and v tiles into the ring, as 16-byte cp.async
    // copies (zero-filled past Skv and past D) whose completion each thread
    // reports to the stage's barrier, so several stages are in flight.
    if constexpr (NWG == 2) setmaxnreg_dec<40>();
    const int t = tid - NWG * 128;
    const bf16* kb = p.k + b * p.ks.b + h * p.ks.n;
    const bf16* vb = p.v + b * p.vs.b + h * p.vs.n;
    const int kr0 = t / KC, kc0 = t - kr0 * KC, kdr = 128 / KC, kdc = 128 - kdr * KC;
    const int vr0 = t / VC, vc0 = t - vr0 * VC, vdr = 128 / VC, vdc = 128 - vdr * VC;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
      const int kv0 = it * BK;
      const uint32_t kt = k_s + s * QB * BK * 128, vt = v_s + s * VB * BK * 128;
      if (p.vec) {
        // thread t takes (row, chunk) pairs t, t + 128, ... of each tile,
        // walked without a division per copy
        for (int r = kr0, c = kc0; r < BK; r += kdr, c += kdc) {
          if (c >= KC) c -= KC, ++r;
          if (r >= BK) break;
          const bool ok = kv0 + r < p.Skv && c * 8 < p.D;
          cp_async16(kt + swz(r, c, BK), ok ? kb + (kv0 + r) * p.ks.s + c * 8 : kb, ok);
        }
        for (int r = vr0, c = vc0; r < BK; r += vdr, c += vdc) {
          if (c >= VC) c -= VC, ++r;
          if (r >= BK) break;
          const bool ok = kv0 + r < p.Skv && d0 + c * 8 < p.D;
          cp_async16(vt + swz(r, c, BK), ok ? vb + (kv0 + r) * p.vs.s + d0 + c * 8 : vb, ok);
        }
        mbar_arrive_cp_async(full + 8 * s);
      } else {
        for (int i = t; i < BK * KC; i += 128) {
          const int r = i / KC, c = i - r * KC;
          st_shared16(kt + swz(r, c, BK), load8_scalar(kb, p.ks.s, kv0 + r, p.Skv, c * 8, p.D).u);
        }
        for (int i = t; i < BK * VC; i += 128) {
          const int r = i / VC, c = i - r * VC;
          st_shared16(vt + swz(r, c, BK),
                      load8_scalar(vb, p.vs.s, kv0 + r, p.Skv, d0 + c * 8, p.D).u);
        }
        fence_proxy_async();
        mbar_arrive(full + 8 * s);
      }
    }
    cp_async_wait_all();  // no copy outlives the block
    return;
  }

  // ---- consumers: warpgroup wg owns q rows q0 .. q0 + 63
  if constexpr (NWG == 2) setmaxnreg_inc<232>();
  const int wt = tid & 127;
  const int wq = wt >> 5;            // warp in the warpgroup: rows 16 wq ..
  const int g = (wt & 31) >> 2;      // fragment row group
  const int t4 = wt & 3;             // thread in group
  const int q0 = blockIdx.x * (64 * NWG) + wg * 64;
  const uint32_t qt = q_s + wg * QB * 64 * 128;

  // q tile, times scale * log2 e, rounded to bf16, once
  {
    const bf16* qb = p.q + b * p.qs.b + h * p.qs.n;
    for (int i = wt; i < 64 * KC; i += 128) {
      const int r = i / KC, c = i - r * KC;
      Pack8 v;
      if (p.vec) {
        v.u = make_uint4(0u, 0u, 0u, 0u);
        if (q0 + r < p.Sq && c * 8 < p.D)
          v.u = *reinterpret_cast<const uint4*>(qb + (q0 + r) * p.qs.s + c * 8);
      } else {
        v = load8_scalar(qb, p.qs.s, q0 + r, p.Sq, c * 8, p.D);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v.h[e] = __bfloat16_as_ushort(__float2bfloat16(
            __bfloat162float(__ushort_as_bfloat16(v.h[e])) * p.scale_log2));
      st_shared16(qt + swz(r, c, 64), v.u);
    }
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);
  }

  float o[DO / 2];
#pragma unroll
  for (int i = 0; i < DO / 2; ++i) o[i] = 0.f;
  float m0 = NEG_BIG, m1 = NEG_BIG;  // rows g and g + 8 of this warp's 16
  uint32_t mb = pack_bf16(NEG_BF16, NEG_BF16);  // BSM: both rows' max, bf16x2
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums
  float alpha0, alpha1;              // the last tile's rescale of o
  float sc[BK / 2];         // scores of the tile in flight
  uint32_t pa[BK / 16][4];  // p of the tile whose p v is next, bf16 A fragments
  uint32_t pn[BK / 16][4];  // p of the tile just exponentiated

  // s = q k^T of stage s: 64 x BK, k16 steps over the padded head dim
  auto scores = [&](int s) {
    const uint32_t kt = k_s + s * QB * BK * 128;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const uint32_t off = (ks & 3) * 32;  // k16 step inside a 128-byte row
      ScoreMma<BK>::run(sc, desc_sw128(qt + (ks >> 2) * 64 * 128 + off, 16, 1024),
                        desc_sw128(kt + (ks >> 2) * BK * 128 + off, 16, 1024), ks > 0);
    }
  };
  // o += p v of stage s: p from registers (the score accumulator of two
  // neighbouring 8-column blocks is the k16 A fragment), v MN-major
  auto values = [&](int s) {
    const uint32_t vt = v_s + s * VB * BK * 128;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      ValueMma<DO>::run(o, pa[kk], desc_sw128(vt + kk * 16 * 128, BK * 128, 1024));
  };
  // online softmax of tile it in log2 units, rows g (e = 0, 1) and g + 8
  // (2, 3): m, l and alpha updated, p into pn; columns past Skv (the last
  // tile only) masked first
  auto softmax = [&](int it) {
    const int kv0 = it * BK;
    constexpr float neg = BSM ? NEG_BF16 : NEG_BIG;
    if (kv0 + BK > p.Skv) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int col = kv0 + j * 8 + 2 * t4;
        if (col >= p.Skv) sc[4 * j] = sc[4 * j + 2] = neg;
        if (col + 1 >= p.Skv) sc[4 * j + 1] = sc[4 * j + 3] = neg;
      }
    }
    if constexpr (BSM) {
      // scores rounded pairwise to bf16x2: s0 row g, s1 row g + 8
      uint32_t s0[BK / 8], s1[BK / 8];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s0[j] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
        s1[j] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
      }
      uint32_t mx0 = s0[0], mx1 = s1[0];
#pragma unroll
      for (int j = 1; j < BK / 8; ++j) {
        mx0 = max_bf16x2(mx0, s0[j]);
        mx1 = max_bf16x2(mx1, s1[j]);
      }
      // (row g, row g + 8) of the even and of the odd columns, then across
      // the four threads of the rows
      uint32_t mx = max_bf16x2(__byte_perm(mx0, mx1, 0x5410), __byte_perm(mx0, mx1, 0x7632));
      mx = max_bf16x2(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = max_bf16x2(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const uint32_t mn = max_bf16x2(mb, mx);
      const uint32_t dm = sub_bf16x2(mb, mn);  // m_prev - m_new in bf16
      alpha0 = ex2(bf16_lo(dm));
      alpha1 = ex2(bf16_hi(dm));
      mb = mn;
      const uint32_t mg = __byte_perm(mn, 0, 0x1010), m8 = __byte_perm(mn, 0, 0x3232);
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const uint32_t p01 = ex2_bf16x2(sub_bf16x2(s0[j], mg));
        const uint32_t p23 = ex2_bf16x2(sub_bf16x2(s1[j], m8));
        rs0 += bf16_lo(p01) + bf16_hi(p01);
        rs1 += bf16_lo(p23) + bf16_hi(p23);
        pn[j >> 1][2 * (j & 1)] = p01;
        pn[j >> 1][2 * (j & 1) + 1] = p23;
      }
      l0 = l0 * alpha0 + rs0;
      l1 = l1 * alpha1 + rs1;
      return;
    }
    float mx0 = NEG_BIG, mx1 = NEG_BIG;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    alpha0 = ex2(m0 - mn0);
    alpha1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = ex2(sc[4 * j] - mn0), p1 = ex2(sc[4 * j + 1] - mn0);
      const float p2 = ex2(sc[4 * j + 2] - mn1), p3 = ex2(sc[4 * j + 3] - mn1);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pn[j >> 1][2 * (j & 1)] = pack_bf16(p0, p1);
      pn[j >> 1][2 * (j & 1) + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
  };
  auto rescale = [&]() {
#pragma unroll
    for (int i = 0; i < DO / 8; ++i) {
      o[4 * i] *= alpha0;
      o[4 * i + 1] *= alpha0;
      o[4 * i + 2] *= alpha1;
      o[4 * i + 3] *= alpha1;
    }
  };
  auto release = [&](int s) {
    __syncwarp();
    if ((wt & 31) == 0) mbar_arrive(empty + 8 * s);
  };
  auto take_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = pn[kk][e];
  };

  // Tile it's scores are issued before tile it - 1's p v, so the exp2 work
  // of tile it overlaps that product on the tensor cores; o is rescaled
  // once the product is done.
  mbar_wait(full, 0);
  fence_proxy_async();
  wgmma_fence();
  scores(0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(0);
  take_p();
  for (int it = 1; it < n_tiles; ++it) {
    const int s = it % STAGES, prev = (it - 1) % STAGES;
    mbar_wait(full + 8 * s, (it / STAGES) & 1);
    fence_proxy_async();
    fence_regs(pa);
    fence_regs(o);
    wgmma_fence();
    scores(s);
    wgmma_commit();
    values(prev);
    wgmma_commit();
    wgmma_wait<1>();  // the scores are in
    fence_regs(sc);
    softmax(it);
    wgmma_wait<0>();  // p v of tile it - 1 is done
    fence_regs(pa);   // p stays live (and unwritten) while the product reads it
    fence_regs(o);
    release(prev);
    rescale();
    take_p();
  }
  wgmma_fence();
  values((n_tiles - 1) % STAGES);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  release((n_tiles - 1) % STAGES);

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  float inv0 = l0 > 0.f ? 1.f / l0 : 1.f;
  float inv1 = l1 > 0.f ? 1.f / l1 : 1.f;
  if constexpr (BSM) {  // the TPU kernel's acc / l, l = 0 taken as 1
    const float den0 = l0 == 0.f ? 1.f : l0, den1 = l1 == 0.f ? 1.f : l1;
#pragma unroll
    for (int i = 0; i < DO / 8; ++i) {
      o[4 * i] /= den0;
      o[4 * i + 1] /= den0;
      o[4 * i + 2] /= den1;
      o[4 * i + 3] /= den1;
    }
    inv0 = inv1 = 1.f;
  }
  const int row0 = q0 + wq * 16 + g;
  const int row1 = row0 + 8;
  if (p.lse != nullptr && blockIdx.z == 0 && t4 == 0) {  // one slice writes it
    float* lb = p.lse + (long long)blockIdx.y * p.Sq;
    if (row0 < p.Sq) lb[row0] = (m0 + log2f(l0)) * LN2;
    if (row1 < p.Sq) lb[row1] = (m1 + log2f(l1)) * LN2;
  }
  if (p.o32 != nullptr) {  // the fp32 output: no rounding to bf16
    float* of = p.o32 + b * p.os.b + h * p.os.n;
#pragma unroll
    for (int i = 0; i < DO / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = d0 + i * 8 + 2 * t4 + e;
        if (col >= p.D) continue;
        if (row0 < p.Sq) of[row0 * p.os.s + col] = o[4 * i + e] * inv0;
        if (row1 < p.Sq) of[row1 * p.os.s + col] = o[4 * i + 2 + e] * inv1;
      }
    }
    return;
  }
  bf16* ob = p.o + b * p.os.b + h * p.os.n;
#pragma unroll
  for (int i = 0; i < DO / 8; ++i) {
    const int col = d0 + i * 8 + 2 * t4;
    if (p.vec && col + 1 < p.D) {  // even strides and D: 4-byte pairs
      if (row0 < p.Sq)
        *reinterpret_cast<uint32_t*>(ob + row0 * p.os.s + col) =
            pack_bf16(o[4 * i] * inv0, o[4 * i + 1] * inv0);
      if (row1 < p.Sq)
        *reinterpret_cast<uint32_t*>(ob + row1 * p.os.s + col) =
            pack_bf16(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
      continue;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (col + e >= p.D) continue;
      if (row0 < p.Sq) ob[row0 * p.os.s + col + e] = __float2bfloat16(o[4 * i + e] * inv0);
      if (row1 < p.Sq) ob[row1 * p.os.s + col + e] = __float2bfloat16(o[4 * i + 2 + e] * inv1);
    }
  }
}
// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* o;     // the output: q's type, or fp32 where lse is written
  float* lse;  // (B, N, Sq) fp32, or null
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
      a.Skv, a.D, a.qs, a.ks, a.vs, a.os, a.scale_log2, a.lse);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The bf16 kernel's shape for head dim D (mirrored by
// ops/flash_attention.py::bf16_config): output columns per z slice, kv rows
// per stage, consumer warpgroups, stages. Every D up to 256 is one slice;
// past 256, slices of 256 with one consumer warpgroup (the q tile of 64 x D
// and two stages of k and v fill the shared memory): 32 kv rows a stage up
// to D = 768, 16 up to 1024.
struct BfConfig {
  int DO, BK, NWG, STAGES, KSTEPS;
};

BfConfig bf16_config(int D) {
  if (D <= 40) return {40, 128, 2, 3, 3};
  if (D <= 64) return {64, 128, 2, 3, 4};
  if (D <= 80) return {80, 128, 2, 2, 5};
  if (D <= 160) return {160, 64, 2, 2, 10};
  if (D <= 256) return {256, 64, 2, 2, 16};
  if (D <= 512) return {256, 32, 1, 2, 32};
  if (D <= 768) return {256, 32, 1, 2, 48};
  return {256, 16, 1, 2, 64};
}

size_t bf16_smem_bytes(const BfConfig& c) {
  const int qb = (c.KSTEPS * 16 + 63) / 64, vb = (c.DO + 63) / 64;
  return 1024 + (size_t)128 * (c.NWG * qb * 64 + c.STAGES * (qb + vb) * c.BK) +
         16 * c.STAGES;
}

template <int DO, int BK, int NWG, int STAGES, int KSTEPS, bool BSM>
cudaError_t launch_bf16(const Args& a) {
  const size_t smem = bf16_smem_bytes(BfConfig{DO, BK, NWG, STAGES, KSTEPS});
  const Strides* st[4] = {&a.qs, &a.ks, &a.vs, &a.os};
  bool vec = a.D % 8 == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
             aligned16(a.o);
  for (const Strides* s : st) vec = vec && s->b % 8 == 0 && s->s % 8 == 0 && s->n % 8 == 0;
  auto kernel = flash_bf16_kernel<DO, BK, NWG, STAGES, KSTEPS, BSM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const bool f32_out = a.lse != nullptr;  // the log-sum-exp mode writes fp32
  const BfParams p{static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
                   static_cast<const bf16*>(a.v),
                   f32_out ? nullptr : static_cast<bf16*>(a.o),
                   f32_out ? static_cast<float*>(a.o) : nullptr, a.lse,
                   a.N, a.Sq, a.Skv, a.D, a.qs, a.ks, a.vs, a.os, a.scale_log2, vec};
  const dim3 grid((a.Sq + 64 * NWG - 1) / (64 * NWG), a.B * a.N, (a.D + DO - 1) / DO);
  kernel<<<grid, 128 * (NWG + 1), smem, a.stream>>>(p);
  return cudaGetLastError();
}

constexpr int BF16_MAX_D = 1024;

template <bool BSM>
cudaError_t dispatch_bf16(const Args& a) {
  if (a.D > BF16_MAX_D) return cudaErrorInvalidValue;
  switch (bf16_config(a.D).KSTEPS) {
    case 3: return launch_bf16<40, 128, 2, 3, 3, BSM>(a);
    case 4: return launch_bf16<64, 128, 2, 3, 4, BSM>(a);
    case 5: return launch_bf16<80, 128, 2, 2, 5, BSM>(a);
    case 10: return launch_bf16<160, 64, 2, 2, 10, BSM>(a);
    case 16: return launch_bf16<256, 64, 2, 2, 16, BSM>(a);
    case 32: return launch_bf16<256, 32, 1, 2, 32, BSM>(a);
    case 48: return launch_bf16<256, 32, 1, 2, 48, BSM>(a);
    default: return launch_bf16<256, 16, 1, 2, 64, BSM>(a);
  }
}

#ifndef PPT_FLASH_BF16_SOFTMAX
// Output columns per block of the fp32 kernel are 8*NC for NC in {5, 8,
// 10, 16}: the choice with the fewest column slices (each recomputes the
// scores), then the least padding.
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

cudaError_t dispatch_f32(const Args& a) {
  switch (pick_nc(a.D)) {
    case 5: return launch_f32<5>(a);
    case 8: return launch_f32<8>(a);
    case 10: return launch_f32<10>(a);
    default: return launch_f32<16>(a);
  }
}

#endif  // PPT_FLASH_BF16_SOFTMAX

}  // namespace

#ifndef PPT_FLASH_BF16_SOFTMAX

// The bf16 kernel's shape for head dim D: out[0..5] = output columns per
// slice, kv rows per stage, consumer warpgroups, stages, slices, shared
// memory bytes. Returns 0, or cudaErrorInvalidValue past D = 1024.
extern "C" int ppt_flash_attention_bf16_config(int D, long long* out) {
  if (D <= 0 || D > BF16_MAX_D) return (int)cudaErrorInvalidValue;
  const BfConfig c = bf16_config(D);
  const long long v[6] = {c.DO, c.BK, c.NWG, c.STAGES, (D + c.DO - 1) / c.DO,
                          (long long)bf16_smem_bytes(c)};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// q, k, v: (B, Sq|Skv, N, D) and o: (B, Sq, N, D), all of one dtype (fp32
// or bf16), D contiguous (bf16: D at most 1024). strides: 12 element
// strides, (batch, seq, head) for q, k, v, o in that order. Returns the CUDA
// error code of the launch.
extern "C" int ppt_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, int is_bf16, int B, int N, int Sq,
                                   int Skv, int D, const long long* strides,
                                   float scale_log2, void* stream) {
  if (B <= 0 || N <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || B * N > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, nullptr, B, N, Sq, Skv, D,
               Strides{strides[0], strides[1], strides[2]},
               Strides{strides[3], strides[4], strides[5]},
               Strides{strides[6], strides[7], strides[8]},
               Strides{strides[9], strides[10], strides[11]},
               scale_log2, static_cast<cudaStream_t>(stream)};
  return (int)(is_bf16 != 0 ? dispatch_bf16<false>(a) : dispatch_f32(a));
}

// The log-sum-exp mode (ring attention's hops): as ppt_flash_attention,
// but o is fp32 whatever the inputs' type (a bf16 kernel keeps its fp32
// accumulator unrounded), and lse, (B, N, Sq) fp32 contiguous, receives
// each query row's log(sum(exp(scale * q k^T))) in natural-log units.
extern "C" int ppt_flash_attention_lse(const void* q, const void* k, const void* v,
                                       float* o, float* lse, int is_bf16, int B, int N,
                                       int Sq, int Skv, int D, const long long* strides,
                                       float scale_log2, void* stream) {
  if (B <= 0 || N <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || B * N > 65535 ||
      lse == nullptr || o == nullptr)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, lse, B, N, Sq, Skv, D,
               Strides{strides[0], strides[1], strides[2]},
               Strides{strides[3], strides[4], strides[5]},
               Strides{strides[6], strides[7], strides[8]},
               Strides{strides[9], strides[10], strides[11]},
               scale_log2, static_cast<cudaStream_t>(stream)};
  return (int)(is_bf16 != 0 ? dispatch_bf16<false>(a) : dispatch_f32(a));
}

#else  // PPT_FLASH_BF16_SOFTMAX

// The bf16-softmax mode (scripts/torch_perf_attn_bf16.py's experiment): as
// ppt_flash_attention on bf16 q, k, v and o, with the softmax of the TPU
// kernel scripts/perf_attn_bf16.py::_bf16_kernel in bf16 (see the top of
// this file). bf16 only; D at most 1024.
extern "C" int ppt_flash_attention_bf16_softmax(const void* q, const void* k, const void* v,
                                                void* o, int B, int N, int Sq, int Skv, int D,
                                                const long long* strides, float scale_log2,
                                                void* stream) {
  if (B <= 0 || N <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || B * N > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, nullptr, B, N, Sq, Skv, D,
               Strides{strides[0], strides[1], strides[2]},
               Strides{strides[3], strides[4], strides[5]},
               Strides{strides[6], strides[7], strides[8]},
               Strides{strides[9], strides[10], strides[11]},
               scale_log2, static_cast<cudaStream_t>(stream)};
  return (int)dispatch_bf16<true>(a);
}

#endif  // PPT_FLASH_BF16_SOFTMAX
