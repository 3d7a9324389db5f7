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
// 77.3 GFLOP, 0.078 ms. So the design is an implicit GEMM on the tensor
// cores, and what the fusion saves is the normalised activation's round trip
// through device memory. The prologue itself costs CUDA-core instructions
// (an exp and a division per element), so it runs once per input element
// per block, not once per tap.
//
// Design (first version: right, not yet near the bound):
// - GEMM view: M = output pixels, N = Cout, K = 9 * Cin. One block of 256
//   threads computes a 128-pixel x 64-channel tile; its 8 warps each own
//   32 x 32. The pixel tile is a rectangle of TH flattened (batch, row) rows
//   x TW columns (TW = min(W, 16), TH = 128 / TW), so its 3x3 neighbourhood
//   is a small slab of (TH + 2) x (TW + 2) pixels: 180 for 8 x 16, 1.4x the
//   tile. Blocks with neighbouring blockIdx.x share their slab, which they
//   read from L2.
// - K runs over Cin chunks of 16. Per chunk the block copies the slab's
//   channels and the 9 taps' 64 x 16 weight slices into shared memory with
//   cp.async (16-byte copies, zero-filled outside the image),
//   double-buffered so the next chunk's copies fly while this one computes,
//   with one barrier a chunk. The weight is read as (Cout, 3, 3, Cin): the
//   OIHW weight in channels-last memory, so the host never repacks it.
// - Prologue, once per slab element, by the thread that copied it (no
//   barrier between copy and prologue): (x - mean[b, g]) * rstd[b, g] *
//   gamma + beta, then SiLU, in fp32 (the chunk's gamma, beta, mean and rstd
//   arrive in shared memory with its copies), rounded to the compute type in
//   place (as the TPU kernel and the unfused chain round the normalised
//   activation). Pixels outside the image stay zero AFTER the norm chain:
//   SAME padding of the normalised input, never silu(beta - mean * rstd *
//   gamma).
// - The 9 taps then read shifted rows of the slab. A slab row that belongs
//   to another image (a tile spanning two images, or H < TH) is masked to
//   zero per (pixel, tap) in the fragment.
// - bf16 (the main path): mma.sync m16n8k16, bf16 operands, fp32
//   accumulators, bias added in fp32, one rounding to bf16. Fragments come
//   from ldmatrix.x4, each lane pointing at its own slab row, so the taps'
//   shifted, gathered rows cost nothing extra; a pixel whose source row is
//   in another image points at a zero row. About 73 KB of shared memory and
//   at most 80 registers a thread (a few bytes spill) let three blocks share
//   an SM, which the latency-bound products need more than registers.
// - fp32 (checks and the CPU-comparable reference): the same tiles as
//   CUDA-core FMA, each thread computing the accumulators it would hold in
//   the mma layout, so the epilogue is shared.
// - Ragged Cin, Cout and pixel counts are masked; offsets into x and out are
//   64-bit. Cin not a multiple of 16 bytes' worth of elements (or a base not
//   16-byte aligned) takes element copies in place of cp.async.
// - Where the output tiles give fewer than two blocks per SM (the deep
//   UNet levels: 8 x 8 x batch 2 is one pixel tile, 20 blocks at Cout =
//   1280), K is split over blocks: each writes its fp32 partial sums to its
//   own slice of a workspace, and the last block of a tile to arrive (a
//   counter per tile) adds the slices in split order, so the result is the
//   same from run to run, adds the bias and writes the tile. The number of
//   splits depends on the shape of one image, not on the batch, so the
//   result is also the same whatever batch an image is in.
// Where it stands (H100 SXM, 700 W): about 200 TFLOP/s without the prologue
// and about 70 with it at the UNet's first level, 2-4x cuDNN's time; the
// prologue costs as much as the products there. Later work: wgmma and TMA,
// larger warp tiles, the prologue off the products' critical path (producer
// warps).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int BM = 128;       // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int THREADS = 256;  // 8 warps: 4 along the pixels x 2 along Cout
constexpr int MAX_TW = 16;    // tile width in pixels

typedef __nv_bfloat16 bf16;

template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int BK = 16;       // channels per K chunk
  static constexpr int LD = BK + 8;   // 48-byte rows: conflict-free ldmatrix
};
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
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

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

// c += a @ b: a 16x16 (row), b 16x8 (col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// One tap of one K chunk, bf16. a_addr[mt] is the shared address of the
// slab row (and k half) this lane hands ldmatrix for the A fragment of row
// tile mt (a zero row where the pixel's source is outside its image);
// b_addr the lane's address in this tap's weight slice. acc[mt][nt][e] is
// the mma.sync C fragment layout: rows 16 mt + g (e = 0, 1) and + 8 (e = 2,
// 3), columns 8 nt + 2 t4 + (e & 1), inside this warp's 32 x 32 sub-tile.
__device__ __forceinline__ void tap_product(const uint32_t (&a_addr)[2],
                                            uint32_t b_addr,
                                            float (&acc)[2][4][4]) {
  constexpr int LD = Cfg<bf16>::LD;
  uint32_t a[2][4], b[2][4];
  ldsm_x4(a_addr[0], a[0]);
  ldsm_x4(a_addr[1], a[1]);
  ldsm_x4(b_addr, b[0]);                       // n tiles 0, 1
  ldsm_x4(b_addr + 16 * LD * sizeof(bf16), b[1]);  // n tiles 2, 3
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      mma_16816(acc[mt][nt], a[mt], b[nt >> 1][2 * (nt & 1)],
                b[nt >> 1][2 * (nt & 1) + 1]);
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

// [3][params] + [2][slab pixels][LD] + [2][9][BN][LD] + one zero row of LD
template <typename T>
size_t smem_bytes(int TH, int TW, int NB, bool gn) {
  constexpr int LD = Cfg<T>::LD;
  return (gn ? 3 * sizeof(float) * param_floats<T>(NB) : 0) +
         sizeof(T) * ((2 * (size_t)slab_pixels(TH, TW) + 2 * 9 * BN + 1) * LD);
}

// Sixteen bytes of channels in shared memory as fp32, and back.
__device__ __forceinline__ void load_vec(const bf16* q, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(q);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store_vec(bf16* q, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(q) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void load_vec(const float* q, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(q);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void store_vec(float* q, const float (&v)[4]) {
  *reinterpret_cast<float4*>(q) = make_float4(v[0], v[1], v[2], v[3]);
}

template <typename T, bool GN>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 3 : 2)
    conv3x3_kernel(Params p) {
  constexpr int BK = Cfg<T>::BK, LD = Cfg<T>::LD;
  constexpr int VEC = 16 / sizeof(T);  // channels per 16-byte vector
  constexpr int NV = BK / VEC;         // vectors per slab pixel
  constexpr bool MMA = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int TH = p.TH, TW = p.TW, SW = TW + 2;
  const int SP = slab_pixels(TH, TW);
  const int PF = GN ? param_floats<T>(p.NB) : 0;
  float* params = reinterpret_cast<float*>(smem_raw);  // [3][PF]
  T* slab = reinterpret_cast<T*>(params + 3 * PF);     // [2][SP][LD]
  T* wts = slab + 2 * SP * LD;               // [2][9][BN][LD]
  T* zero_row = wts + 2 * 9 * BN * LD;       // [LD]

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
  if (tid < LD) zero_row[tid] = from_f<T>(0.f);

  // A rows this thread reads: for mma, the row it hands ldmatrix (one per
  // 16-row tile, lanes 16-31 at the upper k half); for FMA, the rows of its
  // accumulators (g and g + 8 of each 16-row tile). Tile pixel m -> (i, j).
  int base[2][2], hrow[2][2];
  bool mok[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wm * 32 + mt * 16 +
                    (MMA ? (lane & 7) + ((lane >> 3) & 1) * 8 : g + 8 * h);
      const int i = m / TW, j = m - i * TW;
      mok[mt][h] = i < TH && r0 + i < rows_total && w0 + j < p.W;
      hrow[mt][h] = (r0 + i) % p.H;
      base[mt][h] = i * SW + j;  // slab pixel of tap (0, 0)
    }
  const int a_k = MMA ? (lane >> 4) * 8 : 0;  // ldmatrix k half of this lane
  // ldmatrix rows of the weight slice: n tiles in pairs, k halves
  const int b_off = ((wn * 32 + (lane & 7) + (lane >> 4) * 8) * LD +
                     ((lane >> 3) & 1) * 8) * (int)sizeof(T);

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

  const uint32_t slab_s = static_cast<uint32_t>(__cvta_generic_to_shared(slab));
  const uint32_t wts_s = static_cast<uint32_t>(__cvta_generic_to_shared(wts));
  const uint32_t zero_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(zero_row)) + a_k * sizeof(T);
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
      if constexpr (MMA) {
        const uint32_t sl_s = slab_s + buf * SP * LD * (int)sizeof(T);
        const uint32_t a_addr[2] = {
            rows[0][0] >= 0 ? sl_s + (rows[0][0] + a_k) * (int)sizeof(T) : zero_s,
            rows[1][0] >= 0 ? sl_s + (rows[1][0] + a_k) * (int)sizeof(T) : zero_s};
        tap_product(a_addr,
                    wts_s + ((buf * 9 + tap) * BN * LD) * (int)sizeof(T) + b_off,
                    acc);
      } else {
        tap_product(sl, wt + tap * BN * LD, rows, wn, g, t4, acc);
      }
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

// K splits for a grid of `tiles` output tiles: enough blocks for two per SM,
// each split keeping at least 4 chunks, no split empty.
int pick_splits(long long tiles, int n_chunks) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  long long want = (2LL * sms + tiles - 1) / tiles;
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

Shape plan(int B, int H, int W, int Cin, int Cout, bool is_bf16) {
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
  const int bk = is_bf16 ? Cfg<bf16>::BK : Cfg<float>::BK;
  sh.splits = pick_splits(tiles2, (Cin + bk - 1) / bk);
  sh.ws_floats = sh.splits > 1 ? (long long)sh.splits * B * H * W * Cout : 0;
  sh.tiles = tiles;
  return sh;
}

}  // namespace

// The workspace ppt_conv3x3 needs for this shape: returns the fp32
// elements of partial sums and sets *counters to the number of zeroed
// 32-bit counters (both 0 when it does not split K).
extern "C" long long ppt_conv3x3_workspace(int B, int H, int W, int Cin,
                                           int Cout, int is_bf16,
                                           long long* counters) {
  const Shape sh = plan(B, H, W, Cin, Cout, is_bf16 != 0);
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
  const Shape sh = plan(B, H, W, Cin, Cout, is_bf16 != 0);
  if ((long long)B * H > 2147483647LL - sh.TH ||
      ((long long)B * H + sh.TH - 1) / sh.TH > 65535 ||
      (long long)sh.col_tiles * sh.splits > 65535 ||
      (sh.splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int vec_elems = is_bf16 ? 8 : 4;
  const int NB = std::min(B, (sh.TH + 2 + H - 1) / H + 1);
  Params p{x,      w,     bias, mean, rstd, gamma, beta, out,
           B,      H,     W,    Cin,  Cout, G,     sh.TH, sh.TW,
           NB,     Cin % vec_elems == 0 && aligned16(x) && aligned16(w),
           sh.col_tiles, sh.splits, ws, counters};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<bf16>(p, s) : launch<float>(p, s));
}
