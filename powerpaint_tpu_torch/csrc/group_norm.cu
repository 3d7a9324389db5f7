// GroupNorm (+ SiLU) over (B, S, C) tensors with channels last, its
// statistics alone, and the int8 units' activation quantiser, for Hopper
// (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel powerpaint_tpu/ops/norms_pallas.py::_gn_kernel
// (group_norm_fused: GroupNorm, optional SiLU), the statistics the conv
// kernels of powerpaint_tpu/ops/conv_pallas.py take from gn_stats, and the
// activation quantiser inside _int8_fused_kernel / _int8_kernel:
//   q = clip(round_half_even(y * inv_x_scale), -127, 127),
//   y = silu(GN(x)) in fp32 (conv3x3_gn_silu_int8) or x itself (conv3x3_int8).
// One source, four modes:
//   STATS  fp32 mean and 1/sqrt(var + eps) per (batch, group);
//   APPLY  (x - mean) * rstd * gamma + beta, optional SiLU, in x's dtype;
//   QUANT  the statistics, then GroupNorm + SiLU + the quantiser, int8;
//   and the quantiser of x alone (quantize_kernel).
// Every mode with statistics writes its (B, G) mean and rstd.
// For a canvas whose rows are split over ranks (sequence parallelism):
//   MOMENTS (STATS with `moments` set) writes each (batch, group)'s mean
//   and M2 (the sum of squared deviations) over this rank's rows instead of
//   mean and rstd: the values the streamed form's chunks merge, which the
//   caller gathers over the ranks and merges (Chan) in rank order;
//   APPLY and QUANT with `given` statistics take (2, B, G) mean and rstd
//   from the caller and compute none: one launch of the streamed form's
//   apply kernel (gn_finish_kernel), which reads x once and writes once.
//
// What bounds it: bytes. At (2, 4096, 320) bf16 a read and a write of x is
// 10.5 MB, 0.0031 ms at 3.35 TB/s; the arithmetic is a few operations an
// element. So x is read once and written once where the map allows it.
//
// Design.
// - Resident form, one launch: a thread-block cluster owns one image and a
//   span of whole groups, its blocks a contiguous run of rows each; every
//   block holds its rows x span tile in shared memory (up to 96 KB, so two
//   blocks fit an SM). The span is the narrowest of whole groups whose row
//   is a whole number of 32-byte sectors (16-byte vectors where none fits),
//   the cluster the smallest power of two up to 16 whose tiles fit, grown
//   while a two-image batch leaves SMs without a block and every block
//   keeps 128 rows. Each block
//   takes two-pass (mean, M2) of every group of its tile; the cluster
//   syncs; each block reads all blocks' partials through distributed
//   shared memory and merges them (Chan) in rank order, so every block
//   holds the same bits; then it applies (and quantises) from shared
//   memory and writes. Used wherever the tiles fit: every UNet and BrushNet
//   map at 512^2.
// - Streamed form, two launches, for maps no cluster holds (the VAE's
//   largest): launch 1, per (image, chunk of rows) of 128 chunks an image,
//   two-pass partials of each staged 32 KB sub-tile (double-buffered
//   cp.async) merged in order; launch 2, each block merges the 128 chunk
//   partials of its image in chunk order (the same bits in every block;
//   no counter to zero) and applies its chunk, reading x again.
// - The statistics' partition and merge order depend only on (S, C, G),
//   the element size and the SM count, never on B or on the mode: the four
//   modes give the same mean and rstd bits for one tensor. The plain int8
//   version takes its statistics from the STATS mode, so QUANT quantises
//   exactly what it does.
// - QUANT is the plain version's IEEE fp32 operations in its order,
//   (x - mean) * (rstd * gamma) + beta, then y * (1 / (1 + expf(-y))),
//   then y * inv_x_scale rounded half to even (__float2int_rn) and
//   clamped: explicit _rn intrinsics, so nothing is contracted into an
//   FMA and an int8 level never flips against it. Statistics use explicit
//   intrinsics too, so every mode's code rounds them alike. APPLY uses FMA
//   and the fast exp (its output is rounded to x's dtype).
// - A cluster size the card cannot schedule is refused
//   (cudaOccupancyMaxActiveClusters, checked once per size), never
//   replaced by a smaller one.
// What holds it back at the UNet's maps (chip_smoke.py's times, PERF.md):
// not bytes but the chain of dependent phases in one launch (the tile's
// load, two reduction passes with block barriers, the cluster exchange,
// the apply), each latency-bound with about one block an SM, so even the
// smallest map pays most of a large one's time. Throwaway builds on the card
// (not kept) did not shorten it: 512 or 1024 threads a block, blocks
// forced to one or two an SM, and the first per-group reduction loops were
// each slower; the sums' four interleaved chains, the parallel gather of
// the cluster's partials, per-thread column constants and the 128-row
// floor on cluster growth each took a little off.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int RESIDENT_BYTES = 96 * 1024;  // the x tile of one block of a cluster
constexpr int MAX_CLUSTER = 16;            // above 8: non-portable cluster sizes
constexpr int MIN_ROWS = 128;              // rows a block keeps when a cluster grows for occupancy
constexpr int STREAM_CHUNKS = 128;         // streamed form: row chunks an image
constexpr int SUB_BYTES = 32 * 1024;       // streamed form: one staged sub-tile
constexpr int MAX_SMEM = 200 * 1024;

enum { STATS = 0, APPLY = 1, QUANT = 2 };

// How a shape is cut (mirrored by ops/norms.py::gn_plan).
struct Plan {
  int resident;    // 1: one launch, a cluster per (image, span); 0: streamed
  int span;        // channels a block covers (whole groups); C when streamed
  int spans;       // C / span
  int k;           // groups in a span
  int cluster;     // blocks a cluster; 1 when streamed
  int rows;        // rows a block holds (resident) or a chunk covers (streamed)
  int chunks;      // blocks along the rows of an image
  int sub_rows;    // streamed: rows of one staged sub-tile; 0 when resident
  long long smem;  // dynamic shared memory of the (first) launch
  long long smem2; // streamed: of the second launch; 0 when resident
};

__host__ __device__ inline long long align16(long long n) { return (n + 15) & ~15LL; }

// The column sums of tile_moments (at most THREADS 16-byte units of 8
// channels, or one row), and the resident form's gathered partials.
__host__ __device__ inline int colsum_floats(int span, int k) {
  const int n = span > 2048 ? span : 2048;
  return n > 2 * MAX_CLUSTER * k ? n : 2 * MAX_CLUSTER * k;
}

long long resident_smem(int rows, int span, int k, int esize) {
  return align16((long long)rows * span * esize) +
         4LL * (4 * span + 4 * k + colsum_floats(span, k));
}

Plan plan_gn(int S, int C, int G, int esize, int sms) {
  Plan pl{};
  const int gs = C / G;
  auto tile = [&](int span, int n) { return (long long)((S + n - 1) / n) * span * esize; };
  // The smallest power-of-two cluster whose tiles fit, grown while a
  // two-image batch would give fewer blocks than SMs and each block would
  // keep MIN_ROWS rows (smaller blocks cost more than the SMs they fill:
  // measured on the card); 0 if none fits.
  auto cluster_for = [&](int span) {
    int n = 1;
    while (n < MAX_CLUSTER && n < S &&
           (tile(span, n) > RESIDENT_BYTES ||
            (2LL * (C / span) * n < sms && (S + 2 * n - 1) / (2 * n) >= MIN_ROWS)))
      n *= 2;
    return tile(span, n) <= RESIDENT_BYTES ? n : 0;
  };
  int span = 0, n = 0;
  for (int align = 32; align >= 16 && span == 0; align /= 2) {
    for (int k = 1; k <= G; ++k) {
      if (G % k != 0 || (k * gs * esize) % align != 0) continue;
      n = cluster_for(k * gs);  // a wider span of this alignment holds more
      if (n) span = k * gs;
      break;
    }
  }
  if (span == 0 && (n = cluster_for(C)) != 0) span = C;
  if (span != 0) {
    pl.resident = 1;
    pl.span = span;
    pl.spans = C / span;
    pl.k = span / gs;
    pl.cluster = n;
    pl.rows = (S + n - 1) / n;
    pl.chunks = n;
    pl.smem = resident_smem(pl.rows, span, pl.k, esize);
    return pl;
  }
  pl.span = C;
  pl.spans = 1;
  pl.k = G;
  pl.cluster = 1;
  pl.chunks = std::min(STREAM_CHUNKS, S);
  pl.rows = (S + pl.chunks - 1) / pl.chunks;
  pl.sub_rows = std::max(1, std::min(pl.rows, SUB_BYTES / (C * esize)));
  pl.smem = 2 * align16((long long)pl.sub_rows * C * esize) +
            4LL * (2 * G + C + colsum_floats(C, 0));
  pl.smem2 = 4LL * (3 * C + 2 * G);
  return pl;
}

struct Args {
  const void* x;       // (B, S, C), fp32 or bf16
  const float* gamma;  // (C); null in the statistics mode
  const float* beta;   // (C)
  void* out;           // apply: (B, S, C) in x's dtype
  int8_t* q;           // quantise: (B, S, C) int8
  float* stats;        // (2, B, G): mean, then 1 / sqrt(var + eps)
  float* part;         // streamed: (B, chunks, G, 2) chunk mean and M2
  const float* given;  // apply, quantise: (2, B, G) mean and rstd to use, or null
  float eps, inv_x_scale;
  int B, S, C, G;
  int silu;            // apply: SiLU after the norm
  int vec;             // 16-byte accesses: rows and spans whole vectors, tensors aligned
  int moments;         // statistics: write M2 in place of rstd
  Plan pl;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// Sixteen bytes of x (shared or global) as fp32, and back.
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void load_vec(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                            pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16(v); }

// VEC quantised values -> VEC bytes.
__device__ __forceinline__ void store_q(int8_t* dst, const int (&q)[8]) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e) w[e >> 2] |= (uint32_t)(q[e] & 0xff) << (8 * (e & 3));
  *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
}
__device__ __forceinline__ void store_q(int8_t* dst, const int (&q)[4]) {
  uint32_t w = 0u;
#pragma unroll
  for (int e = 0; e < 4; ++e) w |= (uint32_t)(q[e] & 0xff) << (8 * e);
  *reinterpret_cast<uint32_t*>(dst) = w;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Chan's merge of the moments (nb, mb, m2b) into the running (n, mean, m2).
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb, float mb,
                                           float m2b) {
  if (nb == 0.f) return;
  const float nn = __fadd_rn(n, nb);
  const float fb = __fdiv_rn(nb, nn);
  const float d = __fsub_rn(mb, mean);
  mean = __fadd_rn(mean, __fmul_rn(d, fb));
  m2 = __fadd_rn(__fadd_rn(m2, m2b), __fmul_rn(__fmul_rn(d, d), __fmul_rn(n, fb)));
  n = nn;
}

__device__ __forceinline__ float rstd_of(float n, float m2, float eps) {
  return __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(m2, n), eps)));
}

// SiLU as the plain version computes it, y * (1 / (1 + exp(-y))), and the
// quantiser, in IEEE fp32 operations.
__device__ __forceinline__ float silu_exact(float y) {
  return __fmul_rn(y, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-y))));
}
__device__ __forceinline__ int quantize(float y, float inv) {
  return min(127, max(-127, __float2int_rn(__fmul_rn(y, inv))));
}

// rows x span elements of x (row stride C) -> tile[rows][span] in shared
// memory: 16-byte cp.async where vec, else element by element.
template <typename T>
__device__ __forceinline__ void load_tile(T* tile, const T* x, int rows, int span, int C, bool vec) {
  if (vec) {
    constexpr int VEC = 16 / sizeof(T);
    const int vpr = span / VEC;
    for (int v = threadIdx.x; v < rows * vpr; v += THREADS) {
      const int r = v / vpr, cv = v - r * vpr;
      cp_async16(smem_u32(tile + r * span + cv * VEC), x + (long long)r * C + cv * VEC, true);
    }
  } else {
    for (int e = threadIdx.x; e < rows * span; e += THREADS) {
      const int r = e / span;
      tile[e] = x[(long long)r * C + e - r * span];
    }
  }
}

// p[0] + p[stride] + ... + p[(n - 1) * stride] as four interleaved chains
// (element i into chain i % 4), then (c0 + c1) + (c2 + c3): a fixed order
// with a quarter of the latency of one chain.
__device__ __forceinline__ float sum4(const float* p, int stride, int n) {
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
  int i = 0;
  for (; i + 4 <= n; i += 4) {
    c0 = __fadd_rn(c0, p[i * stride]);
    c1 = __fadd_rn(c1, p[(i + 1) * stride]);
    c2 = __fadd_rn(c2, p[(i + 2) * stride]);
    c3 = __fadd_rn(c3, p[(i + 3) * stride]);
  }
  if (i < n) c0 = __fadd_rn(c0, p[i * stride]);
  if (i + 1 < n) c1 = __fadd_rn(c1, p[(i + 1) * stride]);
  if (i + 2 < n) c2 = __fadd_rn(c2, p[(i + 2) * stride]);
  return __fadd_rn(__fadd_rn(c0, c1), __fadd_rn(c2, c3));
}

// Two-pass (mean, M2) of each of the k groups (gs channels each) of a
// [rows][span] tile in shared memory -> mean_out[k], m2_out[k]. Thread w
// takes column unit u (a 16-byte vector where vec, else one channel) of
// rows rl, rl + RL, ... (row lane rl of RL) and keeps one sum a channel in
// registers; the sums go through shared memory (colsum[RL][span]) and are
// added over the row lanes, then over the group's channels, each in
// sum4's fixed order: the same bits for the same (rows, span, gs, vec)
// whatever the data's source. Every thread calls it; it ends with a
// barrier.
template <typename T>
__device__ void tile_moments(const T* tile, int rows, int span, int gs, int k, bool vec,
                             float* mean_out, float* m2_out, float* colsum, float* chsum) {
  constexpr int VEC = 16 / sizeof(T);
  const int unit = vec ? VEC : 1;
  const int units = span / unit;
  const int lanes = max(1, THREADS / units);
  const int n_el = rows * gs;
  for (int pass = 0; pass < 2; ++pass) {
    for (int w = threadIdx.x; w < lanes * units; w += THREADS) {
      const int rl = w / units, u = w - rl * units, c0 = u * unit;
      float acc[VEC], mu[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        acc[e] = 0.f;
        mu[e] = pass && e < unit ? mean_out[(c0 + e) / gs] : 0.f;
      }
      if (vec) {
        for (int r = rl; r < rows; r += lanes) {
          float f[VEC];
          load_vec(tile + r * span + c0, f);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            if (pass == 0) {
              acc[e] = __fadd_rn(acc[e], f[e]);
            } else {
              const float d = __fsub_rn(f[e], mu[e]);
              acc[e] = __fmaf_rn(d, d, acc[e]);
            }
          }
        }
      } else {
        for (int r = rl; r < rows; r += lanes) {
          const float v = to_f(tile[r * span + c0]);
          if (pass == 0) {
            acc[0] = __fadd_rn(acc[0], v);
          } else {
            const float d = __fsub_rn(v, mu[0]);
            acc[0] = __fmaf_rn(d, d, acc[0]);
          }
        }
      }
      for (int e = 0; e < unit; ++e) colsum[rl * span + c0 + e] = acc[e];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < span; c += THREADS)
      chsum[c] = sum4(colsum + c, span, lanes);
    __syncthreads();
    for (int g = threadIdx.x; g < k; g += THREADS) {
      const float t = sum4(chsum + g * gs, 1, gs);
      if (pass == 0)
        mean_out[g] = n_el > 0 ? __fdiv_rn(t, (float)n_el) : 0.f;
      else
        m2_out[g] = t;
    }
    __syncthreads();
  }
}

// Per-channel constants of the apply pass over channels [c0, c0 + span).
// apply: ca = rstd * gamma, cb = beta - mean * ca (the FMA form);
// quantise: ca = rstd * gamma, cb = mean, bet = beta (the plain version's
// operation order).
template <int MODE>
__device__ void build_tables(const Args& a, int c0, int span, int gs, const float* smean,
                             const float* srstd, float* bet, float* ca, float* cb) {
  for (int c = threadIdx.x; c < span; c += THREADS) {
    const int g = c / gs;
    const float gm = a.gamma[c0 + c], bt = a.beta[c0 + c];
    bet[c] = bt;
    if (MODE == QUANT) {
      ca[c] = __fmul_rn(srstd[g], gm);
      cb[c] = smean[g];
    } else {
      const float s = srstd[g] * gm;
      ca[c] = s;
      cb[c] = bt - smean[g] * s;
    }
  }
}

// The apply pass over `rows` rows of `span` channels read from src (shared
// or global, row stride src_stride), written at element offset dst0 (row
// 0, channel 0) of out or q, row stride C. Thread w takes column unit u of
// rows rl, rl + RL, ... as tile_moments does, its channels' constants in
// registers. apply: y = x * ca + cb (FMA), fast SiLU; quantise: the plain
// version's (x - mean) * (rstd * gamma) + beta, exact SiLU, quantiser.
template <typename T, int MODE>
__device__ void apply_rows(const Args& a, const T* src, long long src_stride, int rows, int span,
                           long long dst0, const float* ca, const float* cb, const float* bet) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = a.vec != 0, silu = a.silu != 0;
  const int unit = vec ? VEC : 1;
  const int units = span / unit;
  const int lanes = max(1, THREADS / units);
  for (int w = threadIdx.x; w < lanes * units; w += THREADS) {
    const int rl = w / units, c0 = (w - rl * units) * unit;
    float k1[VEC], k2[VEC], k3[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int c = min(c0 + e, span - 1);
      k1[e] = ca[c];
      k2[e] = cb[c];
      k3[e] = bet[c];
    }
    auto one = [&](float v, int e) {
      if (MODE == QUANT)
        return silu_exact(__fadd_rn(__fmul_rn(__fsub_rn(v, k2[e]), k1[e]), k3[e]));
      const float y = fmaf(v, k1[e], k2[e]);
      return silu ? __fdividef(y, 1.f + __expf(-y)) : y;
    };
    for (int r = rl; r < rows; r += lanes) {
      const long long o = dst0 + (long long)r * a.C + c0;
      if (vec) {
        float f[VEC];
        load_vec(src + r * src_stride + c0, f);
        if (MODE == QUANT) {
          int qv[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) qv[e] = quantize(one(f[e], e), a.inv_x_scale);
          store_q(a.q + o, qv);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) f[e] = one(f[e], e);
          store_vec(static_cast<T*>(a.out) + o, f);
        }
      } else {
        const float y = one(to_f(src[r * src_stride + c0]), 0);
        if (MODE == QUANT)
          a.q[o] = (int8_t)quantize(y, a.inv_x_scale);
        else
          store_out(static_cast<T*>(a.out) + o, y);
      }
    }
  }
}

// Resident form. Grid (spans * cluster, B), clusters of `cluster` blocks
// along x: block rank r of the cluster of span sp holds rows
// [r * rows, (r + 1) * rows) of image blockIdx.y.
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS) gn_resident_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Plan& pl = a.pl;
  const int n = pl.cluster, R = pl.rows, span = pl.span, k = pl.k, gs = a.C / a.G;
  const int rank = (int)cluster_ctarank();
  const int sp = blockIdx.x / n, b = blockIdx.y;
  const int rows = max(0, min(R, a.S - rank * R)), c0 = sp * span;
  T* tile = reinterpret_cast<T*>(smem);
  float* f = reinterpret_cast<float*>(smem + align16((long long)R * span * sizeof(T)));
  float *bet = f, *ca = f + span, *cb = f + 2 * span;
  float *pmean = f + 3 * span, *pm2 = pmean + k, *smean = pm2 + k, *srstd = smean + k;
  float *chsum = srstd + k, *colsum = chsum + span;
  const long long row0 = (long long)b * a.S + (long long)rank * R;  // first (batch, row)
  load_tile(tile, static_cast<const T*>(a.x) + row0 * a.C + c0, rows, span, a.C, a.vec != 0);
  cp_async_wait_all();
  __syncthreads();
  tile_moments(tile, rows, span, gs, k, a.vec != 0, pmean, pm2, colsum, chsum);
  cluster_sync();  // every block's partials are in its shared memory
  // gather all n blocks' (mean[k], M2[k]) in parallel, one word a thread,
  // into colsum[n][2k] (pm2 follows pmean)
  const uint32_t part0 = smem_u32(pmean);
  for (int t = threadIdx.x; t < n * 2 * k; t += THREADS) {
    const int r = t / (2 * k);
    colsum[t] = ld_dsmem_f32(dsmem_addr(part0 + 4 * (t - r * 2 * k), r));
  }
  cluster_arrive();  // this block is done reading the others' partials
  __syncthreads();
  for (int g = threadIdx.x; g < k; g += THREADS) {
    float cnt = 0.f, mean = 0.f, m2 = 0.f;
    for (int r = 0; r < n; ++r) {
      const int rr = max(0, min(R, a.S - r * R));
      chan_merge(cnt, mean, m2, (float)(rr * gs), colsum[r * 2 * k + g], colsum[r * 2 * k + k + g]);
    }
    const float rstd = rstd_of(cnt, m2, a.eps);
    smean[g] = mean;
    srstd[g] = rstd;
    if (rank == 0) {
      const int gi = b * a.G + sp * k + g;
      a.stats[gi] = mean;
      a.stats[a.B * a.G + gi] = a.moments ? m2 : rstd;
    }
  }
  if (MODE != STATS) {
    __syncthreads();
    build_tables<MODE>(a, c0, span, gs, smean, srstd, bet, ca, cb);
    __syncthreads();
    apply_rows<T, MODE>(a, tile, span, rows, span, row0 * a.C + c0, ca, cb, bet);
  }
  cluster_wait();  // keep this block's partials until every block has read them
}

// Streamed form, launch 1. Grid (chunks, B): the moments of each group
// over one chunk of rows, staged in sub-tiles, merged in order.
template <typename T>
__global__ void __launch_bounds__(THREADS) gn_partial_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Plan& pl = a.pl;
  const int C = a.C, G = a.G, gs = C / G, chunk = blockIdx.x, b = blockIdx.y;
  const int rows = max(0, min(pl.rows, a.S - chunk * pl.rows));
  const long long tile_bytes = align16((long long)pl.sub_rows * C * sizeof(T));
  T* buf[2] = {reinterpret_cast<T*>(smem), reinterpret_cast<T*>(smem + tile_bytes)};
  float* pmean = reinterpret_cast<float*>(smem + 2 * tile_bytes);
  float *pm2 = pmean + G, *chsum = pm2 + G, *colsum = chsum + C;
  const T* x = static_cast<const T*>(a.x) + ((long long)b * a.S + (long long)chunk * pl.rows) * C;
  const int nt = (rows + pl.sub_rows - 1) / pl.sub_rows;
  auto sub = [&](int t) { return min(pl.sub_rows, rows - t * pl.sub_rows); };
  float cnt = 0.f, mean = 0.f, m2 = 0.f;  // thread g < G: group g's running moments
  if (nt > 0) load_tile(buf[0], x, sub(0), C, C, a.vec != 0);
  cp_async_commit();
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt)
      load_tile(buf[(t + 1) & 1], x + (long long)(t + 1) * pl.sub_rows * C, sub(t + 1), C, C,
                a.vec != 0);
    cp_async_commit();
    cp_async_wait_group<1>();
    __syncthreads();
    tile_moments(buf[t & 1], sub(t), C, gs, G, a.vec != 0, pmean, pm2, colsum, chsum);
    if (threadIdx.x < G)
      chan_merge(cnt, mean, m2, (float)(sub(t) * gs), pmean[threadIdx.x], pm2[threadIdx.x]);
    __syncthreads();  // buffer t & 1 may be refilled
  }
  if (threadIdx.x < G) {
    float* p = a.part + (((long long)b * pl.chunks + chunk) * G + threadIdx.x) * 2;
    p[0] = mean;
    p[1] = m2;
  }
}

// Streamed form, launch 2. Grid (chunks, B), or (1, B) for the statistics
// alone: each block merges its image's chunk partials in chunk order (or
// takes the given statistics: then it is the only launch) and applies its
// chunk.
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS) gn_finish_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Plan& pl = a.pl;
  const int C = a.C, G = a.G, gs = C / G, chunk = blockIdx.x, b = blockIdx.y;
  float* f = reinterpret_cast<float*>(smem);
  float *bet = f, *ca = f + C, *cb = f + 2 * C, *smean = f + 3 * C, *srstd = smean + G;
  for (int g = threadIdx.x; g < G; g += THREADS) {
    float cnt = 0.f, mean = 0.f, m2 = 0.f, rstd;
    if (a.given != nullptr) {
      mean = a.given[b * G + g];
      rstd = a.given[a.B * G + b * G + g];
    } else {
      for (int c = 0; c < pl.chunks; ++c) {
        const int rr = max(0, min(pl.rows, a.S - c * pl.rows));
        const float* p = a.part + (((long long)b * pl.chunks + c) * G + g) * 2;
        chan_merge(cnt, mean, m2, (float)(rr * gs), p[0], p[1]);
      }
      rstd = rstd_of(cnt, m2, a.eps);
    }
    smean[g] = mean;
    srstd[g] = rstd;
    if (chunk == 0) {
      a.stats[b * G + g] = mean;
      a.stats[a.B * G + b * G + g] = a.moments ? m2 : rstd;
    }
  }
  if (MODE == STATS) return;
  __syncthreads();
  build_tables<MODE>(a, 0, C, gs, smean, srstd, bet, ca, cb);
  __syncthreads();
  const int rows = max(0, min(pl.rows, a.S - chunk * pl.rows));
  const long long row0 = (long long)b * a.S + (long long)chunk * pl.rows;
  apply_rows<T, MODE>(a, static_cast<const T*>(a.x) + row0 * C, C, rows, C, row0 * C, ca, cb, bet);
}

// q = clip(rint(x * inv_x_scale), -127, 127) over n elements.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q, long long n, float inv,
                    int vec) {
  constexpr int VEC = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * THREADS;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (vec) {
    for (long long v = first; v < n / VEC; v += stride) {
      float f[VEC];
      load_vec(x + v * VEC, f);
      int qv[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) qv[e] = quantize(f[e], inv);
      store_q(q + v * VEC, qv);
    }
    return;
  }
  for (long long e = first; e < n; e += stride) q[e] = (int8_t)quantize(to_f(x[e]), inv);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (uintptr_t)(bytes - 1)) == 0;
}

// Whether the card can hold one cluster of this launch (asked once per
// kernel, cluster size and shared memory).
bool cluster_fits(const void* fn, const cudaLaunchConfig_t& cfg) {
  struct Entry {
    const void* fn;
    unsigned n;
    size_t smem;
    bool ok;
  };
  static Entry cache[64];
  static int used = 0;
  const unsigned n = cfg.attrs[0].val.clusterDim.x;
  for (int i = 0; i < used; ++i)
    if (cache[i].fn == fn && cache[i].n == n && cache[i].smem == cfg.dynamicSmemBytes)
      return cache[i].ok;
  int clusters = 0;
  const bool ok = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg) == cudaSuccess &&
                  clusters > 0;
  cudaGetLastError();  // a refused size leaves its error here
  if (used < 64) cache[used++] = {fn, n, cfg.dynamicSmemBytes, ok};
  return ok;
}

template <typename K>
cudaError_t configure(K kernel, bool cluster) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err == cudaSuccess && cluster)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

template <typename T, int MODE>
cudaError_t launch_resident(const Args& a, cudaStream_t s) {
  auto kernel = gn_resident_kernel<T, MODE>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = configure(kernel, true);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.pl.spans * a.pl.cluster, a.B, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)a.pl.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!cluster_fits(reinterpret_cast<const void*>(kernel), cfg))
    return cudaErrorInvalidConfiguration;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t launch_streamed(const Args& a, cudaStream_t s) {
  auto partial = gn_partial_kernel<T>;
  auto finish = gn_finish_kernel<T, MODE>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = configure(partial, false);
    if (err == cudaSuccess) err = configure(finish, false);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  partial<<<dim3(a.pl.chunks, a.B), THREADS, (size_t)a.pl.smem, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finish<<<dim3(MODE == STATS ? 1 : a.pl.chunks, a.B), THREADS, (size_t)a.pl.smem2, s>>>(a);
  return cudaGetLastError();
}

// Given statistics: the apply kernel alone, a block per (chunk of rows,
// image).
template <typename T, int MODE>
cudaError_t launch_given(const Args& a, cudaStream_t s) {
  auto finish = gn_finish_kernel<T, MODE>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = configure(finish, false);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  finish<<<dim3(a.pl.chunks, a.B), THREADS, (size_t)a.pl.smem2, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, int mode, cudaStream_t s) {
  if (a.given != nullptr)
    return mode == APPLY ? launch_given<T, APPLY>(a, s) : launch_given<T, QUANT>(a, s);
  if (a.pl.resident) {
    if (mode == STATS) return launch_resident<T, STATS>(a, s);
    if (mode == APPLY) return launch_resident<T, APPLY>(a, s);
    return launch_resident<T, QUANT>(a, s);
  }
  if (mode == STATS) return launch_streamed<T, STATS>(a, s);
  if (mode == APPLY) return launch_streamed<T, APPLY>(a, s);
  return launch_streamed<T, QUANT>(a, s);
}

}  // namespace

// The plan for (S, C, G) at this element size on `sms` SMs: out[0..9] =
// resident, span, spans, k, cluster, rows, chunks, sub_rows, smem, smem2.
extern "C" void ppt_group_norm_plan(int S, int C, int G, int esize, int sms, long long* out) {
  const Plan pl = plan_gn(S, C, G, esize, sms);
  const long long v[10] = {pl.resident, pl.span, pl.spans, pl.k, pl.cluster,
                           pl.rows, pl.chunks, pl.sub_rows, pl.smem, pl.smem2};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
}

// fp32 elements of the partials buffer ppt_group_norm needs (0: resident).
extern "C" long long ppt_group_norm_workspace(int B, int S, int C, int G, int is_bf16) {
  if (B <= 0 || S <= 0 || C <= 0 || G <= 0 || C % G != 0) return 0;
  const Plan pl = plan_gn(S, C, G, is_bf16 ? 2 : 4, hopper::sm_count());
  return pl.resident ? 0 : 2LL * B * pl.chunks * G;
}

// x: (B, S, C) fp32 or bf16, contiguous. mode 0: statistics only; 1: out =
// GroupNorm (+ SiLU when silu) in x's dtype; 2: q = quantise(silu(GN(x)))
// int8. gamma, beta: (C) fp32 (null for mode 0). stats: (2, B, G) fp32,
// written in every mode. part: ppt_group_norm_workspace floats, or null
// when it is 0. G at most 256. cluster: 0 for the plan's cluster size, else
// that size (a size the card cannot hold is refused). given (modes 1 and
// 2): (2, B, G) fp32 mean and rstd to apply, computing none; null
// otherwise. moments (mode 0): write M2 in place of rstd. Returns the CUDA
// error code.
extern "C" int ppt_group_norm(const void* x, const float* gamma, const float* beta, void* out,
                              int8_t* q, float* stats, float* part, float eps, float inv_x_scale,
                              int mode, int silu, int is_bf16, int B, int S, int C, int G,
                              int cluster, const float* given, int moments, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || G <= 0 || G > THREADS || C % G != 0 || B > 65535 || mode < 0 ||
      mode > 2 || x == nullptr || stats == nullptr ||
      (mode != STATS && (gamma == nullptr || beta == nullptr)) ||
      (mode == APPLY && out == nullptr) || (mode == QUANT && q == nullptr) ||
      (given != nullptr && (mode == STATS || cluster > 0)) || (moments && mode != STATS))
    return (int)cudaErrorInvalidValue;
  const int esize = is_bf16 ? 2 : 4;
  Plan pl = plan_gn(S, C, G, esize, hopper::sm_count());
  if (given != nullptr) {  // the apply kernel alone over chunks of rows
    pl = Plan{};
    pl.span = C;
    pl.spans = 1;
    pl.k = G;
    pl.cluster = 1;
    pl.chunks = std::min(STREAM_CHUNKS, S);
    pl.rows = (S + pl.chunks - 1) / pl.chunks;
    pl.smem2 = 4LL * (3 * C + 2 * G);
  }
  if (cluster > 0) {
    if (!pl.resident) return (int)cudaErrorInvalidValue;
    pl.cluster = pl.chunks = cluster;
    pl.rows = (S + cluster - 1) / cluster;
    pl.smem = resident_smem(pl.rows, pl.span, pl.k, esize);
  }
  if (pl.smem > MAX_SMEM || pl.smem2 > MAX_SMEM ||
      (!pl.resident && given == nullptr && part == nullptr) ||
      (long long)pl.spans * pl.cluster > 2147483647LL || (long long)S * C > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int vec_bytes = mode == QUANT ? 16 / esize : 16;  // bytes of one output vector
  const bool vec = (pl.span * esize) % 16 == 0 && (C * esize) % 16 == 0 && aligned(x, 16) &&
                   (mode != APPLY || aligned(out, 16)) && (mode != QUANT || aligned(q, vec_bytes));
  Args a{x,    gamma, beta, out,  q,          stats, part, given, eps, inv_x_scale,
         B,    S,     C,    G,    silu, vec ? 1 : 0, moments ? 1 : 0, pl};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<bf16>(a, mode, s) : launch<float>(a, mode, s));
}

// q = clip(rint(x * inv_x_scale), -127, 127) for n elements of fp32 or
// bf16 x into int8 q. Returns the CUDA error code.
extern "C" int ppt_quantize_int8(const void* x, int8_t* q, long long n, float inv_x_scale,
                                 int is_bf16, void* stream) {
  if (n <= 0 || x == nullptr || q == nullptr) return (int)cudaErrorInvalidValue;
  const int esize = is_bf16 ? 2 : 4, VEC = 16 / esize;
  const int vec = n % VEC == 0 && aligned(x, 16) && aligned(q, VEC);
  const long long items = vec ? n / VEC : n;
  const long long blocks = std::min<long long>((items + THREADS - 1) / THREADS, 8LL * hopper::sm_count());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    quantize_kernel<bf16><<<(unsigned)blocks, THREADS, 0, s>>>(static_cast<const bf16*>(x), q, n,
                                                               inv_x_scale, vec);
  else
    quantize_kernel<float><<<(unsigned)blocks, THREADS, 0, s>>>(static_cast<const float*>(x), q,
                                                                n, inv_x_scale, vec);
  return (int)cudaGetLastError();
}
