// Static-scale int8 W8A8 3x3 stride-1 SAME convolution on NHWC tensors for
// Hopper (sm_90a), with an optional GroupNorm + SiLU prologue, bound with
// ctypes.
//
// Replaces the TPU kernels of powerpaint_tpu/ops/conv_pallas.py launched by
// _int8_conv_call's pl.pallas_call: _int8_fused_kernel (conv3x3_gn_silu_int8)
// and _int8_kernel (conv3x3_int8). Both compute
//   y   = silu(GN(x)) in fp32 (prologue on), or x itself (prologue off)
//   q   = clip(round_half_even(y * inv_x_scale), -127, 127)       int8
//   acc = sum over taps and Cin of q * w_q                         int32, exact
//   out = (float)acc * (w_scale[oc] * x_scale) + bias[oc]          fp32 -> x's dtype
// with x_scale one static per-tensor scale and w_q, w_scale the per-output-
// channel int8 weights of ops.conv.quantize_weights_int8. One kernel does
// both; the prologue is a template flag.
//
// What bounds it: operations. At the UNet's (2, 64, 64, 320 -> 320) the
// work is 15.1 G integer operations, 0.0076 ms at the H100 SXM's 1979 dense
// int8 TOP/s, against 0.0019 ms to move x (bf16), the int8 weights and the
// output once. So it is an implicit GEMM on the int8 tensor cores; what the
// fusion saves is the normalised, quantised activation's trip through
// device memory.
//
// Design (first version, right before fast; the tiling is that of
// csrc/conv3x3.cu, whose notes explain it):
// - GEMM view: M = output pixels, N = Cout, K = 9 * Cin. A block of 256
//   threads computes 128 pixels x 64 channels; its 8 warps 32 x 32 each.
//   The pixel tile is TH flattened (batch, row) rows x TW columns, read
//   with its 3x3 neighbourhood as a (TH + 2) x (TW + 2) slab.
// - K runs over Cin chunks of 32, one mma.sync m16n8k32 (s8 x s8 -> s32)
//   step. Per chunk the block copies the slab's raw channels (fp32 or bf16)
//   into a staging buffer and the 9 taps' 64 x 32 int8 weight slices into
//   shared memory with cp.async, double-buffered, one barrier a chunk. The
//   weight is read as (Cout, 3, 3, Cin) int8.
// - Prologue, once per slab element, by the thread that copied it: the
//   GroupNorm, (x - mean) * (rstd * gamma) + beta, then y / (1 + exp(-y)) * y
//   in IEEE fp32 operations (no contraction into FMAs, no fast exp), so the
//   activation is the plain PyTorch version's to the last bit wherever exp
//   agrees; then the quantiser (__float2int_rn rounds half to even, as
//   jnp.round), clamped to +-127, written to an int8 slab. Pixels outside
//   the image and channels past Cin are written as 0: SAME padding of the
//   quantised activation (0 quantises to 0).
// - The 9 taps read shifted rows of the int8 slab through ldmatrix, each
//   lane pointing at its own slab row (a zero row where the pixel's source
//   is outside its image). 48-byte rows keep ldmatrix conflict-free; the
//   fragment layouts of m16n8k32.s8 are those of m16n8k16.bf16 byte for
//   byte, so the addressing is csrc/conv3x3.cu's.
// - Epilogue: the int32 sum converted to fp32 (round to nearest), times
//   w_scale * x_scale (formed first), plus the fp32 bias, each one IEEE
//   operation as in the plain version, then one rounding to x's dtype.
// - Where the output tiles give fewer than two blocks per SM, K is split
//   over blocks. int32 sums are exact, so the splits add into one zeroed
//   int32 workspace with atomics in any order and the result does not
//   depend on it; the last block of a tile (a counter per tile) applies the
//   epilogue.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int BM = 128;       // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int THREADS = 256;  // 8 warps: 4 along the pixels x 2 along Cout
constexpr int MAX_TW = 16;    // tile width in pixels
constexpr int BK = 32;        // channels per K chunk: one m16n8k32 step
constexpr int LDQ = BK + 16;  // int8 rows of 48 bytes: conflict-free ldmatrix

typedef __nv_bfloat16 bf16;

struct Params {
  const void* x;        // (B, H, W, Cin), fp32 or bf16
  const int8_t* w;      // (Cout, 3, 3, Cin)
  const float* w_scale; // (Cout)
  const float* bias;    // (Cout) or null
  const float* mean;    // (B, G), prologue only
  const float* rstd;    // (B, G)
  const float* gamma;   // (Cin)
  const float* beta;    // (Cin)
  void* out;            // (B, H, W, Cout), x's dtype
  float x_scale, inv_x_scale;
  int B, H, W, Cin, Cout, G;
  int TH, TW;           // pixel tile: TH flattened rows x TW columns
  int NB;               // most batches one slab touches
  bool xvec, wvec;      // 16-byte copies of x / of w
  int col_tiles;        // tiles along W; blockIdx.z = split * col_tiles + tile
  int splits;           // K splits; > 1: int32 sums through ws
  int* ws;              // (B*H*W, Cout) int32, zeroed
  unsigned int* counters;  // one per output tile, zeroed
};

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }
template <>
__device__ __forceinline__ int8_t zero<int8_t>() { return 0; }

__device__ __forceinline__ void store_out(float* o, float v) { *o = v; }
__device__ __forceinline__ void store_out(bf16* o, float v) {
  *o = __float2bfloat16(v);
}

// One 16-byte vector global -> shared: cp.async (zero-filled when !valid) on
// the aligned path, element by element otherwise (zero past n_valid).
template <typename T>
__device__ __forceinline__ void copy_vec(T* dst, const T* src, bool valid,
                                         int n_valid, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0));
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      dst[e] = (valid && e < n_valid) ? src[e] : zero<T>();
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// c += a @ b: a 16x32 (row), b 32x8 (col), s8 in, s32 accumulate (exact)
__device__ __forceinline__ void mma_16832(int (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// One tap of one K chunk. a_addr[mt]: the shared address of the slab row
// (and 16-byte k half) this lane hands ldmatrix for row tile mt; b_addr: the
// lane's address in this tap's weight slice. acc[mt][nt][e] is the C
// fragment: rows 16 mt + g (e = 0, 1) and + 8 (e = 2, 3), columns
// 8 nt + 2 t4 + (e & 1) of the warp's 32 x 32 sub-tile.
__device__ __forceinline__ void tap_product(const uint32_t (&a_addr)[2],
                                            uint32_t b_addr,
                                            int (&acc)[2][4][4]) {
  uint32_t a[2][4], b[2][4];
  ldsm_x4(a_addr[0], a[0]);
  ldsm_x4(a_addr[1], a[1]);
  ldsm_x4(b_addr, b[0]);              // n tiles 0, 1
  ldsm_x4(b_addr + 16 * LDQ, b[1]);   // n tiles 2, 3
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      mma_16832(acc[mt][nt], a[mt], b[nt >> 1][2 * (nt & 1)],
                b[nt >> 1][2 * (nt & 1) + 1]);
}

__host__ __device__ inline int slab_pixels(int TH, int TW) {
  return (TH + 2) * (TW + 2);
}

// Prologue parameters of one K chunk (fp32): gamma[BK], beta[BK],
// mean[NB][BK], rstd[NB][BK] for the slab's batches and the chunk's groups.
__host__ __device__ inline int param_floats(int NB) { return 2 * BK * (1 + NB); }

// [3][params] + [2][slab pixels][BK] staging (x's type) + [2][slab pixels]
// [LDQ] int8 + [2][9][BN][LDQ] int8 weights + one zero row of LDQ
template <typename T>
size_t smem_bytes(int TH, int TW, int NB, bool gn) {
  const size_t sp = slab_pixels(TH, TW);
  return (gn ? 3 * sizeof(float) * param_floats(NB) : 0) +
         2 * sp * BK * sizeof(T) + (2 * sp + 2 * 9 * BN + 1) * LDQ;
}

// Sixteen bytes of channels in shared memory as fp32.
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
__device__ __forceinline__ void load_vec(const float* q, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(q);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}

// VEC quantised values -> VEC bytes of the int8 slab.
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

template <typename T, bool GN>
__global__ void __launch_bounds__(THREADS, 2) conv3x3_int8_kernel(Params p) {
  constexpr int VEC = 16 / sizeof(T);  // channels per 16-byte staging vector
  constexpr int NV = BK / VEC;         // staging vectors per slab pixel
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int TH = p.TH, TW = p.TW, SW = TW + 2;
  const int SP = slab_pixels(TH, TW);
  const int PF = GN ? param_floats(p.NB) : 0;
  float* params = reinterpret_cast<float*>(smem_raw);    // [3][PF]
  T* stage = reinterpret_cast<T*>(params + 3 * PF);       // [2][SP][BK]
  int8_t* slab = reinterpret_cast<int8_t*>(stage + 2 * SP * BK);  // [2][SP][LDQ]
  int8_t* wts = slab + 2 * SP * LDQ;                      // [2][9][BN][LDQ]
  int8_t* zero_row = wts + 2 * 9 * BN * LDQ;              // [LDQ]

  const T* __restrict__ x = static_cast<const T*>(p.x);
  const int8_t* __restrict__ w = p.w;
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
  if (tid < LDQ) zero_row[tid] = 0;

  // The slab row each lane hands ldmatrix for its 16-row tiles (lanes
  // 16-31 at the upper 16 bytes of k). Tile pixel m -> (i, j).
  int base[2], hrow[2];
  bool mok[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int m = wm * 32 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int i = m / TW, j = m - i * TW;
    mok[mt] = i < TH && r0 + i < rows_total && w0 + j < p.W;
    hrow[mt] = (r0 + i) % p.H;
    base[mt] = i * SW + j;  // slab pixel of tap (0, 0)
  }
  const int a_k = (lane >> 4) * 16;  // byte offset of this lane's k half
  const int b_off = (wn * 32 + (lane & 7) + (lane >> 4) * 8) * LDQ +
                    ((lane >> 3) & 1) * 16;

  // K chunk k -> buffer `buf`: the slab's raw channels into the staging
  // buffer and the 9 taps' int8 weight slices, as 16-byte vectors. Thread
  // tid copies staging vectors tid, tid + THREADS, ... and later quantises
  // exactly those.
  auto load_chunk = [&](int k, int buf) {
    const int c0 = k * BK;
    T* st = stage + buf * SP * BK;
    for (int idx = tid; idx < SP * NV; idx += THREADS) {
      const int sp = idx / NV, v = idx - sp * NV;
      const int si = sp / SW, sj = sp - si * SW;
      const int row = r0 - 1 + si, col = w0 - 1 + sj;
      const int c = c0 + v * VEC;
      const bool ok = row >= 0 && row < rows_total && col >= 0 && col < p.W &&
                      c < Cin;
      const T* src = ok ? x + ((long long)row * p.W + col) * Cin + c : x;
      copy_vec(st + sp * BK + v * VEC, src, ok, Cin - c, p.xvec);
    }
    int8_t* wt = wts + buf * 9 * BN * LDQ;
    for (int idx = tid; idx < 9 * BN * 2; idx += THREADS) {
      const int tn = idx >> 1, v = idx & 1;  // tn = tap * BN + n
      const int tap = tn / BN, n = tn - tap * BN;
      const int c = c0 + v * 16;
      const bool ok = n0 + n < p.Cout && c < Cin;
      const int8_t* src = ok ? w + ((long long)(n0 + n) * 9 + tap) * Cin + c : w;
      copy_vec(wt + tn * LDQ + v * 16, src, ok, Cin - c, p.wvec);
    }
  };

  // K chunk k's prologue parameters -> parameter buffer `pbuf`.
  auto load_params = [&](int k, int pbuf) {
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

  // The staging vectors of chunk k this thread copied -> int8 slab `buf`:
  // GroupNorm + SiLU (prologue on), then the quantiser; zeros outside the
  // image and past Cin.
  auto quantise = [&](int k, int buf, int pbuf) {
    const int c0 = k * BK;
    const T* st = stage + buf * SP * BK;
    int8_t* sl = slab + buf * SP * LDQ;
    const float* prm = params + pbuf * PF;
    const float* mean = prm + 2 * BK;       // [NB][BK]
    const float* rstd = mean + p.NB * BK;   // [NB][BK]
    const int g_lo = c0 / gs;
    for (int idx = tid; idx < SP * NV; idx += THREADS) {
      const int sp = idx / NV, v = idx - sp * NV;
      const int si = sp / SW, sj = sp - si * SW;
      const int row = r0 - 1 + si, col = w0 - 1 + sj;
      const bool inside = row >= 0 && row < rows_total && col >= 0 && col < p.W;
      float d[VEC];
      load_vec(st + sp * BK + v * VEC, d);
      int q[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int cl = v * VEC + e;  // channel within the chunk
        float y = d[e];
        if (GN) {
          if (inside && c0 + cl < Cin) {
            const int b = row / p.H - b_lo;
            const int gi = (c0 + cl) / gs - g_lo;
            const float sc = __fmul_rn(rstd[b * BK + gi], prm[cl]);
            y = __fadd_rn(__fmul_rn(__fsub_rn(y, mean[b * BK + gi]), sc),
                          prm[BK + cl]);
            y = __fmul_rn(y, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-y))));
          } else {
            y = 0.f;
          }
        }
        const int qi = __float2int_rn(__fmul_rn(y, p.inv_x_scale));
        q[e] = min(127, max(-127, qi));
      }
      store_q(sl + sp * LDQ + v * VEC, q);
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  const uint32_t slab_s = static_cast<uint32_t>(__cvta_generic_to_shared(slab));
  const uint32_t wts_s = static_cast<uint32_t>(__cvta_generic_to_shared(wts));
  const uint32_t zero_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(zero_row)) + a_k;
  // this block's K chunks: a contiguous share of ceil(Cin / BK)
  const int per = ((Cin + BK - 1) / BK + p.splits - 1) / p.splits;
  const int k_begin = split * per;
  const int k_end = min((Cin + BK - 1) / BK, k_begin + per);
  // Double-buffered copies, one barrier a chunk. Each thread quantises the
  // staging vectors of chunk k it copied as soon as its own copies are in.
  // Parameters run two chunks ahead of the data: those of chunk k were
  // copied two iterations earlier and made visible by the last barrier.
  if (GN) {
    load_params(k_begin, 0);
    if (k_begin + 1 < k_end) load_params(k_begin + 1, 1);
  }
  load_chunk(k_begin, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  for (int k = k_begin; k < k_end; ++k) {
    const int it = k - k_begin, buf = it & 1;
    cp_async_wait_all();  // this thread's copies of chunk k are in
    quantise(k, buf, it % 3);
    __syncthreads();  // chunk k is quantised; every reader of chunk k - 1 done
    if (k + 1 < k_end) load_chunk(k + 1, buf ^ 1);
    if (GN && k + 2 < k_end) load_params(k + 2, (it + 2) % 3);
    cp_async_commit();
    const uint32_t sl_s = slab_s + buf * SP * LDQ;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - dy * 3;
      uint32_t a_addr[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int hh = hrow[mt] + dy - 1;  // source row in its image
        a_addr[mt] = (mok[mt] && hh >= 0 && hh < p.H)
                         ? sl_s + (base[mt] + dy * SW + dx) * LDQ + a_k
                         : zero_s;
      }
      tap_product(a_addr, wts_s + (buf * 9 + tap) * BN * LDQ + b_off, acc);
    }
  }

  // Epilogue. f(out index, channel, int32 sum) for each of this thread's
  // outputs inside the tensor.
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
  auto finish = [&](long long o, int col, int a) {
    float v = __fmul_rn(__int2float_rn(a), __fmul_rn(p.w_scale[col], p.x_scale));
    if (p.bias != nullptr) v = __fadd_rn(v, p.bias[col]);
    store_out(out + o, v);
  };
  if (p.splits == 1) {
    each_out(finish);
    return;
  }
  // Split K: every block adds its sums into ws (exact, so in any order);
  // the last block of this output tile to arrive applies the epilogue.
  each_out([&](long long o, int, int a) { atomicAdd(p.ws + o, a); });
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
  each_out([&](long long o, int col, int) { finish(o, col, __ldcg(p.ws + o)); });
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

// the opt-in limit is 227 KB a block, static shared memory included
constexpr int kMaxSmem = 224 * 1024;

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const bool gn = p.mean != nullptr;
  const size_t smem = smem_bytes<T>(p.TH, p.TW, p.NB, gn);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const dim3 grid((p.Cout + BN - 1) / BN, (p.B * p.H + p.TH - 1) / p.TH,
                  p.col_tiles * p.splits);
  auto kernel = gn ? conv3x3_int8_kernel<T, true> : conv3x3_int8_kernel<T, false>;
  static bool configured[2] = {false, false};
  if (!configured[gn]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    configured[gn] = true;
  }
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 15u) == 0;
}

struct Shape {
  int TH, TW, col_tiles, splits;
  long long tiles;  // output tiles
};

Shape plan(int B, int H, int W, int Cin, int Cout) {
  Shape sh;
  sh.TW = W < MAX_TW ? W : MAX_TW;
  sh.TH = BM / sh.TW;
  sh.col_tiles = (W + sh.TW - 1) / sh.TW;
  sh.tiles = (long long)((Cout + BN - 1) / BN) *
             ((B * (long long)H + sh.TH - 1) / sh.TH) * sh.col_tiles;
  sh.splits = pick_splits(sh.tiles, (Cin + BK - 1) / BK);
  return sh;
}

}  // namespace

// The workspace ppt_conv3x3_int8 needs for this shape: returns the int32
// elements of sums and sets *counters to the number of 32-bit tile
// counters, all zeroed by the caller (both 0 when it does not split K).
extern "C" long long ppt_conv3x3_int8_workspace(int B, int H, int W, int Cin,
                                                int Cout, long long* counters) {
  const Shape sh = plan(B, H, W, Cin, Cout);
  *counters = sh.splits > 1 ? sh.tiles : 0;
  return sh.splits > 1 ? (long long)B * H * W * Cout : 0;
}

// x: (B, H, W, Cin) fp32 or bf16; w: (Cout, 3, 3, Cin) int8; w_scale (Cout)
// and bias (Cout, or null) fp32; out: (B, H, W, Cout) in x's dtype; all
// contiguous. mean and rstd: (B, G) fp32, gamma and beta: (Cin) fp32, all
// null for the form without the prologue. x_scale and inv_x_scale: the
// static activation scale and its fp32 reciprocal. ws and counters: the
// zeroed workspace ppt_conv3x3_int8_workspace sizes, or null when it is 0.
// Returns the CUDA error code of the launch.
extern "C" int ppt_conv3x3_int8(const void* x, const int8_t* w,
                                const float* w_scale, const float* bias,
                                const float* mean, const float* rstd,
                                const float* gamma, const float* beta,
                                void* out, int* ws, unsigned int* counters,
                                float x_scale, float inv_x_scale, int is_bf16,
                                int B, int H, int W, int Cin, int Cout, int G,
                                void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0)
    return (int)cudaErrorInvalidValue;
  if (mean != nullptr && (G <= 0 || Cin % G != 0))
    return (int)cudaErrorInvalidValue;
  const Shape sh = plan(B, H, W, Cin, Cout);
  if ((long long)B * H > 2147483647LL - sh.TH ||
      ((long long)B * H + sh.TH - 1) / sh.TH > 65535 ||
      (long long)sh.col_tiles * sh.splits > 65535 ||
      (sh.splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int xvec_elems = is_bf16 ? 8 : 4;
  const int NB = std::min(B, (sh.TH + 2 + H - 1) / H + 1);
  Params p{x, w, w_scale, bias, mean, rstd, gamma, beta, out,
           x_scale, inv_x_scale, B, H, W, Cin, Cout, G, sh.TH, sh.TW, NB,
           Cin % xvec_elems == 0 && aligned16(x),
           Cin % 16 == 0 && aligned16(w),
           sh.col_tiles, sh.splits, ws, counters};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<bf16>(p, s) : launch<float>(p, s));
}
