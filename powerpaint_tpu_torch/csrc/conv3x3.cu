// 3x3 stride-1 SAME convolution on NHWC tensors for Hopper (sm_90a), with an
// optional GroupNorm + SiLU prologue, bound with ctypes.
//
// Replaces the TPU kernels of powerpaint_tpu/ops/conv_pallas.py (both
// launched by _conv_call's pl.pallas_call): _fused_kernel (conv3x3_gn_silu,
// out = conv3x3(silu(GN(x))) + bias, statistics from gn_stats) and
// _plain_kernel (conv3x3, out = conv3x3(x) + bias). One kernel does both; the
// prologue is a template flag.
//
// What bounds it: operations. At the UNet's (2, 64, 64, 320 -> 320) the work
// is 15.1 GFLOP for 5.2 MB of tensors, 0.015 ms at 989 TFLOP/s against
// 0.0016 ms of memory traffic; at the VAE's (1, 512, 512, 128 -> 128) it is
// 77.3 GFLOP, 0.078 ms. So it is an implicit GEMM on the tensor cores (M =
// output pixels, N = Cout, K = 9 * Cin), and what the fusion saves is the
// normalised activation's round trip through device memory. The prologue
// costs CUDA-core work (an exp and a division per element) beside the
// products, so it runs once per input element per block, on warps that do
// not issue the products.
//
// bf16 (the main path), conv3x3_bf16_kernel, warp-specialised, 384 threads:
// - Two consumer warpgroups, each owning an 8 x 8 pixel tile of one image
//   (so no tile spans two images) and a Cout tile of BN in {64, 128, 160,
//   256}. They issue only wgmma m64nBNk16, A and B from shared memory,
//   fp32 accumulators in registers (BN / 2 a thread; setmaxnreg gives
//   them 200 registers, the producer warps 104).
// - K runs over 64-channel chunks (one 128-byte swizzled row a pixel) and
//   the 9 taps: 36 k16 steps a chunk. The chunk's slab (each tile's 10 x 10
//   pixels with the halo) stays resident in one of two stages; tap
//   (dy, dx) is the slab read through a descriptor whose start is shifted
//   by dy slab rows and dx pixels (8-pixel core-matrix rows, 1280 bytes
//   between them; the swizzle is taken on absolute addresses, so the
//   shifted start needs no base offset). Pixels outside the image are zero
//   rows of the slab, so the taps need no mask.
// - Copies by TMA, which writes through the async proxy that wgmma reads
//   (no proxy fence on the products' path) and fills zeros outside the
//   tensor (the SAME padding of the plain form, Cout and Cin tails): the
//   slab as two 64 x 10 x 10 boxes of x viewed as (Cin, W, H, B), the
//   weights as one 64 x 1 x BN box of w viewed as (Cin, 9, Cout) a tap, read
//   as (Cout, 3, 3, Cin) with no repack, through a ring of up to 8 stages
//   (160 KB) that one thread of a weight warp keeps full. The tensor maps
//   are encoded per call on the host (cuTensorMapEncodeTiled, reached
//   through the runtime). A Cin off 64 or a misaligned tensor takes
//   element copies instead (test shapes only).
// - Prologue off the products' path: three transform warps wait for the
//   chunk's slab, apply GroupNorm + SiLU in fp32 in place (gn_stats' mean
//   and rstd, gamma, beta; one 16-byte channel chunk a thread), round to
//   bf16, leave out-of-image pixels zero (SAME padding after the norm,
//   never silu(beta - mean * rstd * gamma)), fence and hand the stage to
//   the consumers through an mbarrier, one chunk ahead of them.
// - Consumers release a weight stage once the products that read it are
//   done (wgmma.wait_group 1) and a slab stage after its last tap.
// - The Cout tile and the K split come from an estimate of the clocks of a
//   two-image batch (plan_bf16): 160 at the UNet's first levels, 64 with K
//   split five ways at 8 x 8 x 1280, where few pixel tiles need more blocks.
// - Shared memory: 2 slab stages of 26 KB + the weight ring (8 x 20 KB at
//   BN = 160, 5 x 32 KB at 256): 213 KB, one block an SM.
// - Where K is split, each block writes its fp32 partial sums to its own
//   slice of a workspace, and the last block of a tile to arrive (a counter
//   per tile) adds the slices in split order, adds the bias and writes the
//   tile, its 256 consumer threads sharing the tile's 8-channel groups. The
//   splits are sized for a two-image batch whatever B, so each output's sum
//   runs over the same chunks in the same order in any batch: bitwise
//   batch-invariant and deterministic.
// - Bias in fp32, one rounding to bf16.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W): the fused form
// 0.089 ms at (2, 64, 64, 320 -> 320) with its two statistics launches,
// 0.74x conv2d(silu(group_norm)) (the mma.sync version took 0.189); the
// plain form 0.092 ms at (2, 64, 64, 640 -> 640), 0.77x cuDNN (0.297
// before), 66% of the bf16 peak. At the deep levels the fused form is
// 1.2-1.5x the library chain while the plain one is 0.9-1.1x cuDNN: the
// GroupNorm + SiLU prologue on three warps sets its pace there.
//
// fp32 (checks and the CPU-comparable reference), conv3x3_kernel: the
// products as CUDA-core FMA over 128-pixel x 64-channel tiles of TH
// flattened (batch, row) rows x TW columns, K chunks of 16 channels
// double-buffered with cp.async, the prologue once per slab element by the
// thread that copied it, a slab row of another image masked per (pixel,
// tap), the same split-K scheme.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <string.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMA (checks and the CPU-comparable reference)
// ---------------------------------------------------------------------------

constexpr int BM = 128;       // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int THREADS = 256;  // 8 warps: 4 along the pixels x 2 along Cout
constexpr int MAX_TW = 16;    // tile width in pixels

template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int BK = 16;
  static constexpr int LD = BK + 4;   // 80-byte rows, 16-byte aligned
};

struct Params {
  const void* x;      // (B, H, W, Cin)
  const void* w;      // (Cout, 3, 3, Cin)
  const void* bias;   // (Cout) or null
  const float* mean;  // (B, G), prologue only
  const float* rstd;  // (B, G)
  const float* gamma; // (Cin)
  const float* beta;  // (Cin)
  void* out;          // (B, H, W, Cout)
  int B, H, W, Cin, Cout, G;
  int TH, TW;         // pixel tile: TH flattened rows x TW columns
  int NB;             // most batches one slab touches
  bool vec;           // 16-byte copies: Cin a multiple, x and w aligned
  int col_tiles;      // tiles along W; blockIdx.z = split * col_tiles + tile
  int splits;         // K splits; > 1: fp32 partial sums through ws
  float* ws;          // (splits, B*H*W, Cout) fp32 partial sums
  unsigned int* counters;  // one per output tile, zeroed
};

__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

// Copy one 16-byte vector of channels global -> shared: cp.async (zero-fill
// when !valid) on the aligned path, element by element otherwise (zero past
// n_valid channels).
template <typename T>
__device__ __forceinline__ void copy_vec(T* dst, const T* src, bool valid,
                                         int n_valid, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    const int bytes = valid ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      dst[e] = (valid && e < n_valid) ? src[e] : from_f<T>(0.f);
  }
}

// Four bytes global -> shared, zero-filled when !valid.
__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most n of this thread's copy groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// One tap of one K chunk, fp32 FMA: rows[mt][h] is the slab row (element
// offset) of this thread's accumulator rows, or -1 for a zero row.
__device__ __forceinline__ void tap_product(const float* As, const float* Bs,
                                            const int (&rows)[2][2], int wn,
                                            int g, int t4,
                                            float (&acc)[2][4][4]) {
  constexpr int LD = Cfg<float>::LD;
#pragma unroll 4
  for (int k = 0; k < Cfg<float>::BK; ++k) {
    float a[2][2], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[mt][h] = rows[mt][h] >= 0 ? As[rows[mt][h] + k] : 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        b[nt][e] = Bs[(wn * 32 + nt * 8 + 2 * t4 + e) * LD + k];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][nt][e] = fmaf(a[mt][e >> 1], b[nt][e & 1], acc[mt][nt][e]);
  }
}

__host__ __device__ inline int slab_pixels(int TH, int TW) {
  return (TH + 2) * (TW + 2);
}

// Prologue parameters of one K chunk (fp32): gamma[BK], beta[BK],
// mean[NB][BK], rstd[NB][BK] for the slab's batches and the chunk's groups.
template <typename T>
__host__ __device__ inline int param_floats(int NB) {
  return 2 * Cfg<T>::BK * (1 + NB);
}

// [3][params] + [2][slab pixels][LD] + [2][9][BN][LD]
template <typename T>
size_t smem_bytes(int TH, int TW, int NB, bool gn) {
  constexpr int LD = Cfg<T>::LD;
  return (gn ? 3 * sizeof(float) * param_floats<T>(NB) : 0) +
         sizeof(T) * ((2 * (size_t)slab_pixels(TH, TW) + 2 * 9 * BN) * LD);
}

// Sixteen bytes of channels in shared memory, and back.
__device__ __forceinline__ void load_vec(const float* q, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(q);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void store_vec(float* q, const float (&v)[4]) {
  *reinterpret_cast<float4*>(q) = make_float4(v[0], v[1], v[2], v[3]);
}

template <typename T, bool GN>
__global__ void __launch_bounds__(THREADS, 2)
    conv3x3_kernel(Params p) {
  constexpr int BK = Cfg<T>::BK, LD = Cfg<T>::LD;
  constexpr int VEC = 16 / sizeof(T);  // channels per 16-byte vector
  constexpr int NV = BK / VEC;         // vectors per slab pixel
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int TH = p.TH, TW = p.TW, SW = TW + 2;
  const int SP = slab_pixels(TH, TW);
  const int PF = GN ? param_floats<T>(p.NB) : 0;
  float* params = reinterpret_cast<float*>(smem_raw);  // [3][PF]
  T* slab = reinterpret_cast<T*>(params + 3 * PF);     // [2][SP][LD]
  T* wts = slab + 2 * SP * LD;               // [2][9][BN][LD]

  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ w = static_cast<const T*>(p.w);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * TH;  // first flattened (batch, row) row
  const int col_tile = blockIdx.z % p.col_tiles;
  const int split = blockIdx.z / p.col_tiles;
  const int w0 = col_tile * TW;    // first column
  const int rows_total = p.B * p.H;
  const int Cin = p.Cin;
  const int gs = GN ? Cin / p.G : 1;        // channels per group
  const int b_lo = max(r0 - 1, 0) / p.H;    // the slab's first batch

  // A rows this thread reads: the rows of its accumulators (g and g + 8 of
  // each 16-row tile). Tile pixel m -> (i, j).
  int base[2][2], hrow[2][2];
  bool mok[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wm * 32 + mt * 16 + g + 8 * h;
      const int i = m / TW, j = m - i * TW;
      mok[mt][h] = i < TH && r0 + i < rows_total && w0 + j < p.W;
      hrow[mt][h] = (r0 + i) % p.H;
      base[mt][h] = i * SW + j;  // slab pixel of tap (0, 0)
    }
  // K chunk k -> shared buffer `buf`: the slab's channels and the 9 taps'
  // weight slices, as 16-byte vectors. Thread tid copies slab vectors tid,
  // tid + THREADS, ...: always the same channel vector v = tid % NV.
  auto issue_data = [&](int k, int buf) {
    const int c0 = k * BK;
    T* sl = slab + buf * SP * LD;
    for (int idx = tid; idx < SP * NV; idx += THREADS) {
      const int sp = idx / NV, v = idx - sp * NV;
      const int si = sp / SW, sj = sp - si * SW;
      const int row = r0 - 1 + si, col = w0 - 1 + sj;
      const int c = c0 + v * VEC;
      const bool ok = row >= 0 && row < rows_total && col >= 0 && col < p.W &&
                      c < Cin;
      const T* src = ok ? x + ((long long)row * p.W + col) * Cin + c : x;
      copy_vec(sl + sp * LD + v * VEC, src, ok, Cin - c, p.vec);
    }
    T* wt = wts + buf * 9 * BN * LD;
    for (int idx = tid; idx < 9 * BN * NV; idx += THREADS) {
      const int tn = idx / NV, v = idx - tn * NV;  // tn = tap * BN + n
      const int tap = tn / BN, n = tn - tap * BN;
      const int c = c0 + v * VEC;
      const bool ok = n0 + n < p.Cout && c < Cin;
      const T* src = ok ? w + ((long long)(n0 + n) * 9 + tap) * Cin + c : w;
      copy_vec(wt + tn * LD + v * VEC, src, ok, Cin - c, p.vec);
    }
  };

  // K chunk k's prologue parameters -> parameter buffer `pbuf`.
  auto issue_params = [&](int k, int pbuf) {
    const int c0 = k * BK;
    float* prm = params + pbuf * PF;
    const int g_lo = c0 / gs;
    for (int idx = tid; idx < PF; idx += THREADS) {
      const float* src;
      bool ok;
      if (idx < 2 * BK) {
        const int c = c0 + idx % BK;
        ok = c < Cin;
        src = (idx < BK ? p.gamma : p.beta) + c;
      } else {
        const int r = (idx - 2 * BK) % (p.NB * BK);
        const int b = b_lo + r / BK, gi = g_lo + r % BK;
        ok = b < p.B && gi < p.G;
        src = (idx - 2 * BK < p.NB * BK ? p.mean : p.rstd) + b * p.G + gi;
      }
      copy4(prm + idx, ok ? src : p.gamma, ok);
    }
  };

  // GroupNorm + SiLU, in place, on the slab vectors of chunk k this thread
  // copied itself (so no barrier is needed between its copy and its
  // prologue, and one warp's prologue overlaps another's products), with
  // the chunk's parameters from shared memory. Out-of-image pixels and
  // channels past Cin were copied as zeros and stay zero.
  auto prologue = [&](int k, int buf, int pbuf) {
    const int c0 = k * BK;
    T* sl = slab + buf * SP * LD;
    const float* prm = params + pbuf * PF;
    const float* mean = prm + 2 * BK;       // [NB][BK]
    const float* rstd = mean + p.NB * BK;   // [NB][BK]
    const int v = tid % NV;  // this thread's channel vector, fixed
    const int g_lo = c0 / gs;
    float sc[VEC], sh[VEC];
    int gi[VEC];
    bool cok[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int c = c0 + v * VEC + e;
      cok[e] = c < Cin;
      gi[e] = (cok[e] ? c : Cin - 1) / gs - g_lo;
    }
    int cached_b = -1;
    for (int sp = tid / NV; sp < SP; sp += THREADS / NV) {
      const int si = sp / SW, sj = sp - si * SW;
      const int row = r0 - 1 + si, col = w0 - 1 + sj;
      if (row < 0 || row >= rows_total || col < 0 || col >= p.W) continue;
      const int b = row / p.H - b_lo;
      if (b != cached_b) {
        cached_b = b;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float s = rstd[b * BK + gi[e]] * prm[v * VEC + e];
          sc[e] = s;
          sh[e] = prm[BK + v * VEC + e] - mean[b * BK + gi[e]] * s;
        }
      }
      T* q = sl + sp * LD + v * VEC;
      float d[VEC];
      load_vec(q, d);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float y = fmaf(d[e], sc[e], sh[e]);
        d[e] = cok[e] ? __fdividef(y, 1.f + __expf(-y)) : 0.f;
      }
      store_vec(q, d);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // this block's K chunks: a contiguous share of ceil(Cin / BK)
  const int per = ((Cin + BK - 1) / BK + p.splits - 1) / p.splits;
  const int k_begin = split * per;
  const int k_end = min((Cin + BK - 1) / BK, k_begin + per);
  // Double-buffered copies, one barrier a chunk. Each thread runs the
  // prologue of chunk k on the slab vectors it copied as soon as its own
  // copies are in, so one warp's prologue overlaps another's products.
  // Parameters run two chunks ahead of the data: those of chunk k were
  // copied two iterations earlier and made visible by the last barrier.
  if (GN) {
    issue_params(k_begin, 0);
    if (k_begin + 1 < k_end) issue_params(k_begin + 1, 1);
  }
  issue_data(k_begin, 0);
  cp_async_commit();
  cp_async_wait_group<0>();
  __syncthreads();
  for (int k = k_begin; k < k_end; ++k) {
    const int it = k - k_begin, buf = it & 1;
    cp_async_wait_group<0>();  // this thread's copies of chunk k are in
    if (GN) prologue(k, buf, it % 3);
    __syncthreads();  // chunk k is complete; every reader of chunk k - 1 done
    if (k + 1 < k_end) issue_data(k + 1, buf ^ 1);
    if (GN && k + 2 < k_end) issue_params(k + 2, (it + 2) % 3);
    cp_async_commit();
    const T* sl = slab + buf * SP * LD;
    const T* wt = wts + buf * 9 * BN * LD;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - dy * 3;
      int rows[2][2];  // slab element offset of each A row, -1: zero row
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int hh = hrow[mt][h] + dy - 1;  // source row in its image
          rows[mt][h] = (mok[mt][h] && hh >= 0 && hh < p.H)
                            ? (base[mt][h] + dy * SW + dx) * LD
                            : -1;
        }
      tap_product(sl, wt + tap * BN * LD, rows, wn, g, t4, acc);
    }
  }

  // Epilogue: + bias in fp32, one rounding to T. f(out index, channel,
  // accumulator) for each of this thread's outputs inside the tensor.
  auto each_out = [&](auto&& f) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm * 32 + mt * 16 + g + 8 * h;
        const int i = m / TW, j = m - i * TW;
        if (i >= TH || r0 + i >= rows_total || w0 + j >= p.W) continue;
        const long long pix = (long long)(r0 + i) * p.W + w0 + j;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + wn * 32 + nt * 8 + 2 * t4 + e;
            if (col < p.Cout) f(pix * p.Cout + col, col, acc[mt][nt][2 * h + e]);
          }
      }
  };
  T* __restrict__ out = static_cast<T*>(p.out);
  const T* bias = static_cast<const T*>(p.bias);
  auto finish = [&](long long o, int col, float v) {
    out[o] = from_f<T>(v + (bias != nullptr ? to_f(bias[col]) : 0.f));
  };
  if (p.splits == 1) {
    each_out(finish);
    return;
  }
  // Split K: each block writes its partial sums to its own slice of ws;
  // the last block of this output tile to arrive adds the slices in split
  // order (so the result does not depend on which block finished first),
  // adds the bias and writes the tile.
  const long long MC = (long long)rows_total * p.W * p.Cout;
  each_out([&](long long o, int, float v) { p.ws[split * MC + o] = v; });
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (tid == 0) {
    const int tile = (blockIdx.y * p.col_tiles + col_tile) * gridDim.x + blockIdx.x;
    last = atomicAdd(p.counters + tile, 1u) == (unsigned)p.splits - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  each_out([&](long long o, int col, float) {
    float sum = 0.f;
    for (int sp = 0; sp < p.splits; ++sp) sum += __ldcg(p.ws + sp * MC + o);
    finish(o, col, sum);
  });
}

// ---------------------------------------------------------------------------
// bf16: wgmma, warp-specialised (the main path)
// ---------------------------------------------------------------------------

using namespace hopper;

constexpr int KC = 64;                     // channels per K chunk: one 128-byte row
constexpr int TILE = 8;                    // a consumer warpgroup's pixels: 8 x 8
constexpr int SW = TILE + 2;               // slab pixels per slab row
constexpr int SEG = SW * SW;               // slab pixels per warpgroup tile
constexpr int SEG_BYTES = 13 * 1024;       // a tile's slab, 1024-byte aligned
constexpr int SLAB_BYTES = 2 * SEG_BYTES;  // one stage: both warpgroups' slabs
constexpr int XF = 96;                     // transform threads (warps 8-10)
constexpr int W_BUDGET = 160 * 1024;       // bytes of the weight ring
// Registers a thread after setmaxnreg: the consumers hold BN / 2 fp32
// accumulators; the transform warps ran the fused form faster with 104
// than with 88 (both splits sum to the block's 384 x 168).
constexpr int CONSUMER_REGS = 200, PRODUCER_REGS = 104;

template <int BN>
__host__ __device__ constexpr int w_stages() {
  return W_BUDGET / (BN * 128) < 8 ? W_BUDGET / (BN * 128) : 8;
}

template <int BN>
constexpr size_t bf16_smem_bytes() {
  return 1024 + 2 * SLAB_BYTES + (size_t)w_stages<BN>() * BN * 128 +
         8 * (6 + 2 * w_stages<BN>());
}

struct BfParams {
  const bf16* x;      // (B, H, W, Cin)
  const bf16* w;      // (Cout, 3, 3, Cin)
  const bf16* bias;   // (Cout) or null
  const float* mean;  // (B, G), prologue only
  const float* rstd;  // (B, G)
  const float* gamma; // (Cin)
  const float* beta;  // (Cin)
  bf16* out;          // (B, H, W, Cout)
  int B, H, W, Cin, Cout, G;
  int tiles_w, tiles_img, tiles;  // 8 x 8 pixel tiles: along W, per image, all
  int splits, per;                // K splits, chunks per split
  bool tma;           // TMA copies: Cin a multiple of 64, x and w aligned
  float* ws;          // (splits, B*H*W, Cout) fp32 partial sums
  unsigned int* counters;  // one per output tile, zeroed
};

// The m64nBNk16 product of one consumer warpgroup.
template <int BN>
__device__ __forceinline__ void conv_mma(float (&d)[BN / 2], uint64_t a, uint64_t b);
template <>
__device__ __forceinline__ void conv_mma<64>(float (&d)[32], uint64_t a, uint64_t b) {
  wgmma_ss_n64(d, a, b, 1);
}
template <>
__device__ __forceinline__ void conv_mma<128>(float (&d)[64], uint64_t a, uint64_t b) {
  wgmma_ss_n128(d, a, b, 1);
}
template <>
__device__ __forceinline__ void conv_mma<160>(float (&d)[80], uint64_t a, uint64_t b) {
  wgmma_ss_n160(d, a, b, 1);
}
template <>
__device__ __forceinline__ void conv_mma<256>(float (&d)[128], uint64_t a, uint64_t b) {
  wgmma_ss_n256(d, a, b, 1);
}

// Warpgroup tile w (0, 1) of this block: image b, first row h0, first
// column w0; false (and an all-padding tile) past the last tile.
__device__ __forceinline__ bool tile_of(const BfParams& p, int w, int& b, int& h0, int& w0) {
  const int t = 2 * blockIdx.x + w;
  if (t >= p.tiles) {
    b = 0;
    h0 = p.H + 1;  // every slab row outside the image
    w0 = 0;
    return false;
  }
  b = t / p.tiles_img;
  const int r = t - b * p.tiles_img;
  h0 = (r / p.tiles_w) * TILE;
  w0 = (r % p.tiles_w) * TILE;
  return true;
}

// Block (blockIdx.x, blockIdx.y, blockIdx.z): two 8 x 8 pixel tiles (one
// per consumer warpgroup) x BN output channels x one K split. xmap: x as
// (Cin, W, H, B), boxes of 64 x 10 x 10 x 1; wmap: w as (Cin, 9, Cout),
// boxes of 64 x 1 x BN; both 128-byte swizzled, unused unless p.tma.
template <int BN, bool GN>
__global__ void __launch_bounds__(384, 1)
    conv3x3_bf16_kernel(const BfParams p, const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap) {
  constexpr int WST = w_stages<BN>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t slab_s = (smem_u32(smem_raw) + 1023u) & ~1023u;  // [2][2][SEG_BYTES]
  const uint32_t w_s = slab_s + 2 * SLAB_BYTES;                    // [WST][BN][128 B]
  const uint32_t slab_full = w_s + WST * BN * 128;                 // [2] mbarriers
  const uint32_t slab_empty = slab_full + 16;                      // [2]
  const uint32_t x_full = slab_empty + 16;                         // [2]
  const uint32_t w_full = x_full + 16;                             // [WST]
  const uint32_t w_empty = w_full + 8 * WST;                       // [WST]
  __shared__ int last_block;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(slab_full + 8 * s, XF);   // every transform thread
      mbar_init(slab_empty + 8 * s, 8);   // every consumer warp
      mbar_init(x_full + 8 * s, 1);       // the slab's TMA
    }
    for (int s = 0; s < WST; ++s) {
      mbar_init(w_full + 8 * s, 1);       // the weight slice's TMA (or copy)
      mbar_init(w_empty + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int n0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int k_begin = split * p.per;
  const int nk = min((p.Cin + KC - 1) / KC, k_begin + p.per) - k_begin;

  if (tid >= 256) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid >= 256 + XF) {
      // ---- weight warp: the BN x 64 weight slice of each (chunk, tap) into
      // a ring of WST stages, read as (Cout, 3, 3, Cin) with no repack,
      // zero past Cout and Cin: one TMA box a stage from lane 0. Without
      // TMA (Cin off 64, or misaligned) the lanes copy element by element.
      const int lane = tid & 31;
      int it = 0;
      for (int kl = 0; kl < nk; ++kl) {
        const int c0 = (k_begin + kl) * KC;
        for (int tap = 0; tap < 9; ++tap, ++it) {
          const int s = it % WST;
          const uint32_t dst = w_s + s * BN * 128;
          if (p.tma) {
            if (lane == 0) {
              mbar_wait(w_empty + 8 * s, ((it / WST) & 1) ^ 1);
              mbar_arrive_expect_tx(w_full + 8 * s, BN * 128);
              tma_load_3d(dst, &wmap, w_full + 8 * s, c0, tap, n0);
            }
            continue;
          }
          mbar_wait(w_empty + 8 * s, ((it / WST) & 1) ^ 1);
          for (int i = lane; i < BN * 8; i += 32) {
            const int n = i >> 3, c = i & 7, ch = c0 + 8 * c;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            unsigned short* hv = reinterpret_cast<unsigned short*>(&v);
            if (n0 + n < p.Cout) {
              const bf16* src = p.w + ((long long)(n0 + n) * 9 + tap) * p.Cin + ch;
              for (int e = 0; e < 8 && ch + e < p.Cin; ++e) hv[e] = __bfloat16_as_ushort(src[e]);
            }
            st_shared16(dst + swz(n, c, BN), v);
          }
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(w_full + 8 * s);
        }
      }
      return;
    }
    // ---- transform warps: each chunk's slab (the two tiles' 10 x 10
    // pixels with their halo, 64 channels) arrives by TMA, zeros outside
    // the image and past Cin; then GroupNorm + SiLU in fp32 in place,
    // rounded to bf16, on the in-image pixels only, so pixels outside the
    // image stay zero: SAME padding of the normalised input. Thread xt
    // always handles 16-byte channel chunk xt % 8. Thread 0 also issues
    // the next chunk's TMA once its stage is free.
    const int xt = tid - 256;
    const int c = xt & 7;
    int b0, h00, w00, b1, h01, w01;
    tile_of(p, 0, b0, h00, w00);
    tile_of(p, 1, b1, h01, w01);
    const int gs = GN ? p.Cin / p.G : 1;  // channels per group
    auto issue_slab = [&](int kl) {
      const int s = kl & 1;
      const int c0 = (k_begin + kl) * KC;
      mbar_arrive_expect_tx(x_full + 8 * s, 2 * SEG * 128);
      tma_load_4d(slab_s + s * SLAB_BYTES, &xmap, x_full + 8 * s, c0, w00 - 1, h00 - 1, b0);
      tma_load_4d(slab_s + s * SLAB_BYTES + SEG_BYTES, &xmap, x_full + 8 * s, c0, w01 - 1,
                  h01 - 1, b1);
    };
    if (p.tma && xt == 0) issue_slab(0);
    for (int kl = 0; kl < nk; ++kl) {
      const int s = kl & 1;
      const uint32_t dst = slab_s + s * SLAB_BYTES;
      const int ch = (k_begin + kl) * KC + 8 * c;  // this thread's first channel
      if (p.tma) {
        mbar_wait(x_full + 8 * s, (kl >> 1) & 1);
      } else {
        mbar_wait(slab_empty + 8 * s, ((kl >> 1) & 1) ^ 1);
        for (int px = xt >> 3; px < 2 * SEG; px += XF / 8) {
          const int w = px >= SEG, q = px - w * SEG;
          const int h = (w ? h01 : h00) - 1 + q / SW, col = (w ? w01 : w00) - 1 + q % SW;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          unsigned short* hv = reinterpret_cast<unsigned short*>(&v);
          if (h >= 0 && h < p.H && col >= 0 && col < p.W) {
            const bf16* src =
                p.x + (((long long)(w ? b1 : b0) * p.H + h) * p.W + col) * p.Cin + ch;
            for (int e = 0; e < 8 && ch + e < p.Cin; ++e) hv[e] = __bfloat16_as_ushort(src[e]);
          }
          st_shared16(dst + w * SEG_BYTES + q * 128 + ((c ^ (q & 7)) << 4), v);
        }
      }
      if constexpr (GN) {
        int cached_b = -1;
        float sc[8], sh[8];
        for (int px = xt >> 3; px < 2 * SEG; px += XF / 8) {
          const int w = px >= SEG, q = px - w * SEG;
          const int h = (w ? h01 : h00) - 1 + q / SW, col = (w ? w01 : w00) - 1 + q % SW;
          if (h < 0 || h >= p.H || col < 0 || col >= p.W || ch >= p.Cin) continue;
          const int bb = w ? b1 : b0;
          if (bb != cached_b) {
            cached_b = bb;
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int ce = min(ch + e, p.Cin - 1);
              const int gi = bb * p.G + ce / gs;
              const float s_ = p.rstd[gi] * p.gamma[ce];
              sc[e] = s_;
              sh[e] = p.beta[ce] - p.mean[gi] * s_;
            }
          }
          const uint32_t a = dst + w * SEG_BYTES + q * 128 + ((c ^ (q & 7)) << 4);
          uint4 v = ld_shared16(a);
          uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u[i]));
            float y0 = fmaf(f.x, sc[2 * i], sh[2 * i]);
            float y1 = fmaf(f.y, sc[2 * i + 1], sh[2 * i + 1]);
            y0 = ch + 2 * i < p.Cin ? __fdividef(y0, 1.f + __expf(-y0)) : 0.f;
            y1 = ch + 2 * i + 1 < p.Cin ? __fdividef(y1, 1.f + __expf(-y1)) : 0.f;
            u[i] = pack_bf16(y0, y1);
          }
          st_shared16(a, v);
        }
      }
      if (GN || !p.tma) fence_proxy_async();  // this thread's writes -> wgmma
      mbar_arrive(slab_full + 8 * s);
      // the next chunk's stage frees once the consumers are past chunk
      // kl - 1, which they leave only after this hand-over of chunk kl
      if (p.tma && xt == 0 && kl + 1 < nk) {
        mbar_wait(slab_empty + 8 * ((kl + 1) & 1), (((kl + 1) >> 1) & 1) ^ 1);
        issue_slab(kl + 1);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns tile wg's 64 pixels x BN channels and
  // issues only wgmma. Tap (dy, dx) reads the slab shifted by dy rows and
  // dx pixels: a descriptor start (rows of 8 pixels, 1280 bytes apart).
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = tid >> 7;
  const int wt = tid & 127;
  const int lane = wt & 31;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int prev_stage = -1;
  for (int kl = 0; kl < nk; ++kl) {
    const int ss = kl & 1;
    mbar_wait(slab_full + 8 * ss, (kl >> 1) & 1);
    const uint32_t a_base = slab_s + ss * SLAB_BYTES + wg * SEG_BYTES;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int it = kl * 9 + tap, s = it % WST;
      mbar_wait(w_full + 8 * s, (it / WST) & 1);
      const uint32_t a0 = a_base + ((tap / 3) * SW + tap % 3) * 128;
      const uint32_t b0 = w_s + s * BN * 128;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        conv_mma<BN>(acc, desc_sw128(a0 + ks * 32, 16, SW * 128),
                     desc_sw128(b0 + ks * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // the previous tap's products are done
      __syncwarp();
      if (lane == 0) {
        if (prev_stage >= 0) mbar_arrive(w_empty + 8 * prev_stage);
        if (tap == 0 && kl > 0) mbar_arrive(slab_empty + 8 * ((kl - 1) & 1));
      }
      prev_stage = s;
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // ---- epilogue: + bias in fp32, one rounding to bf16. Accumulator row
  // m = 16 wq + g + 8 hh is pixel (h0 + 2 wq + hh, w0 + g) of the tile;
  // each thread holds channel pairs n0 + 8 i + 2 t4 (+ 1).
  int b, h0, w0;
  const bool valid = tile_of(p, wg, b, h0, w0);
  const int wq = wt >> 5, g = lane >> 2, t4 = lane & 3;
  const bool pairs = p.Cout % 2 == 0;
  const long long MC = (long long)p.B * p.H * p.W * p.Cout;
  auto bias_of = [&](int co) {
    return p.bias != nullptr && co < p.Cout ? __bfloat162float(p.bias[co]) : 0.f;
  };
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int h = h0 + 2 * wq + hh, col = w0 + g;
    if (!valid || h >= p.H || col >= p.W) continue;
    const long long pix = ((long long)b * p.H + h) * p.W + col;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int co = n0 + 8 * i + 2 * t4;
      if (co >= p.Cout) continue;
      const float v0 = acc[4 * i + 2 * hh], v1 = acc[4 * i + 2 * hh + 1];
      const long long o = pix * p.Cout + co;
      if (p.splits > 1) {  // this split's partial sums
        if (pairs) {
          *reinterpret_cast<float2*>(p.ws + split * MC + o) = make_float2(v0, v1);
        } else {
          p.ws[split * MC + o] = v0;
          if (co + 1 < p.Cout) p.ws[split * MC + o + 1] = v1;
        }
      } else if (pairs) {
        *reinterpret_cast<uint32_t*>(p.out + o) =
            pack_bf16(v0 + bias_of(co), v1 + bias_of(co + 1));
      } else {
        p.out[o] = __float2bfloat16(v0 + bias_of(co));
        if (co + 1 < p.Cout) p.out[o + 1] = __float2bfloat16(v1 + bias_of(co + 1));
      }
    }
  }
  if (p.splits == 1) return;
  // Split K: the last block of this output tile to arrive adds the slices
  // in split order (so the result does not depend on which block finished
  // first), adds the bias and writes the tile; its 256 consumer threads
  // share the tile's (pixel, 8-channel group) items.
  __threadfence();
  named_bar_sync(1, 256);
  if (tid == 0) {
    const int tile = blockIdx.x * gridDim.y + blockIdx.y;
    last_block = atomicAdd(p.counters + tile, 1u) == (unsigned)p.splits - 1;
  }
  named_bar_sync(1, 256);
  if (!last_block) return;
  __threadfence();
  constexpr int GROUPS = BN / 8;
  for (int item = tid; item < 2 * 64 * GROUPS; item += 256) {
    const int px = item / GROUPS, co = n0 + 8 * (item - px * GROUPS);
    int tb_, th_, tw_;
    if (!tile_of(p, px >> 6, tb_, th_, tw_) || co >= p.Cout) continue;
    const int h = th_ + ((px & 63) >> 3), col = tw_ + (px & 7);
    if (h >= p.H || col >= p.W) continue;
    const long long o = (((long long)tb_ * p.H + h) * p.W + col) * p.Cout + co;
    if (p.Cout % 8 == 0) {
      float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0;
      for (int sp = 0; sp < p.splits; ++sp) {
        const float4 a0 = __ldcg(reinterpret_cast<const float4*>(p.ws + sp * MC + o));
        const float4 a1 = __ldcg(reinterpret_cast<const float4*>(p.ws + sp * MC + o + 4));
        s0.x += a0.x; s0.y += a0.y; s0.z += a0.z; s0.w += a0.w;
        s1.x += a1.x; s1.y += a1.y; s1.z += a1.z; s1.w += a1.w;
      }
      const uint4 v = make_uint4(pack_bf16(s0.x + bias_of(co), s0.y + bias_of(co + 1)),
                                 pack_bf16(s0.z + bias_of(co + 2), s0.w + bias_of(co + 3)),
                                 pack_bf16(s1.x + bias_of(co + 4), s1.y + bias_of(co + 5)),
                                 pack_bf16(s1.z + bias_of(co + 6), s1.w + bias_of(co + 7)));
      *reinterpret_cast<uint4*>(p.out + o) = v;
    } else {
      for (int e = 0; e < 8 && co + e < p.Cout; ++e) {
        float sum = 0.f;
        for (int sp = 0; sp < p.splits; ++sp) sum += __ldcg(p.ws + sp * MC + o + e);
        p.out[o + e] = __float2bfloat16(sum + bias_of(co + e));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// fp32: K splits for a grid of `tiles` output tiles: enough blocks for two
// per SM, each split keeping at least 4 chunks, no split empty.
int pick_splits(long long tiles, int n_chunks) {
  long long want = (2LL * sm_count() + tiles - 1) / tiles;
  want = std::min<long long>(want, n_chunks / 4);
  if (want <= 1) return 1;
  const int per = (n_chunks + (int)want - 1) / (int)want;
  return (n_chunks + per - 1) / per;
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(p.TH, p.TW, p.NB, p.mean != nullptr);
  const dim3 grid((p.Cout + BN - 1) / BN, (p.B * p.H + p.TH - 1) / p.TH,
                  p.col_tiles * p.splits);
  const bool gn = p.mean != nullptr;
  auto kernel = gn ? conv3x3_kernel<T, true> : conv3x3_kernel<T, false>;
  // allow up to 200 KB of dynamic shared memory, once per kernel (188 KB
  // is the most any shape takes: fp32, W = 1)
  constexpr int kMaxSmem = 200 * 1024;
  static bool configured[2] = {false, false};
  if (!configured[gn]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    configured[gn] = true;
  }
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 15u) == 0;
}

struct Shape {
  int TH, TW, col_tiles, splits;
  long long ws_floats;  // partial sums, 0 unless K is split
  long long tiles;      // output tiles (split-K counters)
};

Shape plan_f32(int B, int H, int W, int Cin, int Cout) {
  Shape sh;
  sh.TW = W < MAX_TW ? W : MAX_TW;
  sh.TH = BM / sh.TW;
  sh.col_tiles = (W + sh.TW - 1) / sh.TW;
  const long long tiles = (long long)((Cout + BN - 1) / BN) *
                          ((B * (long long)H + sh.TH - 1) / sh.TH) * sh.col_tiles;
  // The K splits are sized for the tiles of a two-image batch (the UNet's
  // CFG batch of one request), never for B: each output's fp32 sum then
  // runs over the same chunks in the same order in any batch, so an image
  // of a batched request gets the bits it gets alone.
  const long long tiles2 = (long long)((Cout + BN - 1) / BN) *
                           ((2LL * H + sh.TH - 1) / sh.TH) * sh.col_tiles;
  sh.splits = pick_splits(tiles2, (Cin + Cfg<float>::BK - 1) / Cfg<float>::BK);
  sh.ws_floats = sh.splits > 1 ? (long long)sh.splits * B * H * W * Cout : 0;
  sh.tiles = tiles;
  return sh;
}

// bf16 (mirrored by ops/conv.py::bf16_plan): 8 x 8 pixel tiles, two a
// block; the Cout tile BN of {64, 128, 160, 256} and the K split into
// `splits` runs of `per` 64-channel chunks that the estimate below finds
// fastest for a two-image batch (never for B, for the reason given in
// plan_f32): wide tiles at the wide levels, narrow tiles and more blocks at
// the deep ones.
struct BfPlan {
  int BN, tiles_w, tiles_img, tiles, blocks, n_tiles, splits, per;
  size_t smem;
  long long ws_floats, counters;
};

BfPlan plan_bf16(int B, int H, int W, int Cin, int Cout, int sms) {
  BfPlan pl;
  pl.tiles_w = (W + TILE - 1) / TILE;
  pl.tiles_img = (H + TILE - 1) / TILE * pl.tiles_w;
  pl.tiles = B * pl.tiles_img;
  pl.blocks = (pl.tiles + 1) / 2;
  const int n_chunks = (Cin + KC - 1) / KC;
  const int options[4] = {256, 160, 128, 64};
  long long least = 1LL << 40;
  for (int bn : options) least = std::min(least, (long long)(Cout + bn - 1) / bn * bn);
  // Estimated clocks of a two-image batch, over the Cout tiles that pad
  // Cout least and every split: waves of blocks x (the chunks' products,
  // two warpgroups sharing the tensor cores at m64nBNk16's rate or the
  // operands' shared-memory rate, + a block's fill and drain + the split
  // sums). Ties keep the wider tile and fewer splits.
  double best = 1e300;
  for (int bn : options) {
    const int n_tiles = (Cout + bn - 1) / bn;
    if ((long long)n_tiles * bn > least) continue;
    const double t_mma = std::max(bn / 2.0, 16.0 + bn / 4.0);
    for (int want = 1; want <= n_chunks; ++want) {
      const int per = (n_chunks + want - 1) / want;
      const int splits = (n_chunks + per - 1) / per;
      if (splits != want) continue;
      const long long blocks2 = (long long)pl.tiles_img * n_tiles * splits;
      const double waves = (double)((blocks2 + sms - 1) / sms);
      const double cost = waves * (per * 72.0 * t_mma + 6000.0 +
                                   (splits > 1 ? 12.0 * splits * bn : 0.0));
      if (cost < best) {
        best = cost;
        pl.BN = bn;
        pl.n_tiles = n_tiles;
        pl.per = per;
        pl.splits = splits;
      }
    }
  }
  switch (pl.BN) {
    case 64: pl.smem = bf16_smem_bytes<64>(); break;
    case 128: pl.smem = bf16_smem_bytes<128>(); break;
    case 160: pl.smem = bf16_smem_bytes<160>(); break;
    default: pl.smem = bf16_smem_bytes<256>(); break;
  }
  pl.ws_floats = pl.splits > 1 ? (long long)pl.splits * B * H * W * Cout : 0;
  pl.counters = pl.splits > 1 ? (long long)pl.blocks * pl.n_tiles : 0;
  return pl;
}

template <int BN>
cudaError_t launch_bf16(const BfParams& p, const BfPlan& pl, bool gn, cudaStream_t stream) {
  auto kernel = gn ? conv3x3_bf16_kernel<BN, true> : conv3x3_bf16_kernel<BN, false>;
  constexpr size_t smem = bf16_smem_bytes<BN>();
  static bool configured[2] = {false, false};
  if (!configured[gn]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured[gn] = true;
  }
  CUtensorMap xmap, wmap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&wmap, 0, sizeof(wmap));
  if (p.tma) {
    const cuuint64_t row = 2ull * p.Cin;
    const cuuint64_t xd[4] = {(cuuint64_t)p.Cin, (cuuint64_t)p.W, (cuuint64_t)p.H,
                              (cuuint64_t)p.B};
    const cuuint64_t xs[3] = {row, row * p.W, row * p.W * p.H};
    const cuuint32_t xb[4] = {KC, SW, SW, 1};
    const cuuint64_t wd[3] = {(cuuint64_t)p.Cin, 9, (cuuint64_t)p.Cout};
    const cuuint64_t wstr[2] = {row, row * 9};
    const cuuint32_t wb[3] = {KC, 1, BN};
    if (!tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.x, 4, xd, xs, xb) ||
        !tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.w, 3, wd, wstr, wb))
      return cudaErrorInvalidValue;
  }
  kernel<<<dim3(pl.blocks, pl.n_tiles, pl.splits), 384, smem, stream>>>(p, xmap, wmap);
  return cudaGetLastError();
}

}  // namespace

// The bf16 kernel's plan for a shape: out[0..6] = the Cout tile, 8 x 8
// pixel tiles, blocks along the pixels, Cout tiles, K splits, chunks per
// split, shared memory bytes. `sms` is the SM count it plans for.
extern "C" void ppt_conv3x3_bf16_plan(int B, int H, int W, int Cin, int Cout, int sms,
                                      long long* out) {
  const BfPlan pl = plan_bf16(B, H, W, Cin, Cout, sms);
  const long long v[7] = {pl.BN, pl.tiles, pl.blocks, pl.n_tiles, pl.splits, pl.per,
                          (long long)pl.smem};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}

// The workspace ppt_conv3x3 needs for this shape: returns the fp32
// elements of partial sums and sets *counters to the number of zeroed
// 32-bit counters (both 0 when it does not split K).
extern "C" long long ppt_conv3x3_workspace(int B, int H, int W, int Cin,
                                           int Cout, int is_bf16,
                                           long long* counters) {
  if (is_bf16) {
    const BfPlan pl = plan_bf16(B, H, W, Cin, Cout, hopper::sm_count());
    *counters = pl.counters;
    return pl.ws_floats;
  }
  const Shape sh = plan_f32(B, H, W, Cin, Cout);
  *counters = sh.splits > 1 ? sh.tiles : 0;
  return sh.ws_floats;
}

// x: (B, H, W, Cin), w: (Cout, 3, 3, Cin), bias: (Cout) or null, out:
// (B, H, W, Cout), all contiguous and of one dtype (fp32 or bf16). mean and
// rstd: (B, G) fp32, gamma and beta: (Cin) fp32, all null for the plain
// convolution. ws and counters: the workspace ppt_conv3x3_workspace
// sizes (counters zeroed), or null when it is 0. Returns the CUDA error code
// of the launch.
extern "C" int ppt_conv3x3(const void* x, const void* w, const void* bias,
                           const float* mean, const float* rstd,
                           const float* gamma, const float* beta, void* out,
                           float* ws, unsigned int* counters, int is_bf16,
                           int B, int H, int W, int Cin, int Cout, int G,
                           void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0)
    return (int)cudaErrorInvalidValue;
  if (mean != nullptr && (G <= 0 || Cin % G != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const BfPlan pl = plan_bf16(B, H, W, Cin, Cout, hopper::sm_count());
    if ((long long)B * H * W > 2147483647LL || pl.n_tiles > 65535 || pl.splits > 65535 ||
        (pl.splits > 1 && (ws == nullptr || counters == nullptr)))
      return (int)cudaErrorInvalidValue;
    const BfParams p{static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                     static_cast<const bf16*>(bias), mean, rstd, gamma, beta,
                     static_cast<bf16*>(out), B, H, W, Cin, Cout, G,
                     pl.tiles_w, pl.tiles_img, pl.tiles, pl.splits, pl.per,
                     Cin % KC == 0 && aligned16(x) && aligned16(w), ws, counters};
    const bool gn = mean != nullptr;
    switch (pl.BN) {
      case 64: return (int)launch_bf16<64>(p, pl, gn, s);
      case 128: return (int)launch_bf16<128>(p, pl, gn, s);
      case 160: return (int)launch_bf16<160>(p, pl, gn, s);
      default: return (int)launch_bf16<256>(p, pl, gn, s);
    }
  }
  const Shape sh = plan_f32(B, H, W, Cin, Cout);
  if ((long long)B * H > 2147483647LL - sh.TH ||
      ((long long)B * H + sh.TH - 1) / sh.TH > 65535 ||
      (long long)sh.col_tiles * sh.splits > 65535 ||
      (sh.splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int NB = std::min(B, (sh.TH + 2 + H - 1) / H + 1);
  Params p{x,      w,     bias, mean, rstd, gamma, beta, out,
           B,      H,     W,    Cin,  Cout, G,     sh.TH, sh.TW,
           NB,     Cin % 4 == 0 && aligned16(x) && aligned16(w),
           sh.col_tiles, sh.splits, ws, counters};
  return (int)launch<float>(p, s);
}
