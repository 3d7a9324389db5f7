// Static-scale int8 W8A8 3x3 stride-1 SAME convolution of a quantised NHWC
// activation for Hopper (sm_90a), on wgmma s8 fed by TMA, bound with ctypes.
//
// Replaces the products and the dequantisation of the TPU kernels of
// powerpaint_tpu/ops/conv_pallas.py launched by _int8_conv_call's
// pl.pallas_call, _int8_fused_kernel (conv3x3_gn_silu_int8) and _int8_kernel
// (conv3x3_int8). Their function is
//   q   = clip(round_half_even(y * inv_x_scale), -127, 127)       int8
//   acc = sum over taps and Cin of q * w_q                         int32, exact
//   out = (float)acc * (w_scale[oc] * x_scale) + bias[oc]          fp32 -> out dtype
// with y = silu(GN(x)) or x. The quantiser runs first, in
// csrc/group_norm.cu (one launch that also takes the GroupNorm statistics),
// which writes q to device memory; this kernel reads q. So an int8 unit is
// two launches and this kernel has no prologue: the IEEE-exact prologue
// (expf, true division, no contraction) that bound the first version ran
// at CUDA-core speed beside the products. q is 1 byte an element: writing
// and reading it back costs about 1.2 us at (2, 64, 64, 320).
//
// What bounds it: operations. At the UNet's (2, 64, 64, 320 -> 320) the
// work is 15.1 G integer operations, 0.0076 ms at the H100 SXM's 1979 dense
// int8 TOP/s, against 0.0019 ms to move q, the weights and the output once.
//
// Design: the bf16 kernel of csrc/conv3x3.cu with its prologue off, in int8.
// - 320 threads. Two consumer warpgroups, each owning an 8 x 8 pixel tile
//   of one image and a Cout tile of BN in {64, 128, 160, 256} (S32S8S8
//   wgmma shapes), issue only wgmma m64nBNk32 s32.s8.s8, A and B from
//   shared memory, both K-major (8-bit wgmma takes no transpose), int32
//   accumulators in registers. One thread of warp 8 issues the slab's TMA,
//   one of warp 9 the weights'.
// - K runs over 128-channel chunks: one 128-byte row a pixel, so the slab,
//   its 128-byte swizzle, the tap offsets into the resident slab (dy * 1280
//   + dx * 128 bytes, base offset 0, measured on the card for the bf16
//   kernel) and the weight ring are the bf16 kernel's byte for byte, with
//   k32 steps of 32 bytes. Chosen over 64-channel chunks with the 64-byte
//   swizzle, which divide every site's Cin but need a new descriptor layout
//   whose absolute-address swizzle would have to be measured again: at Cin
//   320 and 960 the last chunk is partly zero-filled (17% and 6% of the
//   products wasted at those sites).
// - TMA: the slab as two 128 x 10 x 10 boxes of q viewed as (Cin, W, H, B),
//   zero-filled outside the tensor, which is the SAME padding of the
//   quantised activation (0 quantises to 0) and the Cin tail; the weights
//   as one 128 x 1 x BN box of w_q viewed as (Cin, 9, Cout) a tap, read as
//   (Cout, 3, 3, Cin) with no repack, through a ring of up to 8 stages. TMA
//   writes through the async proxy that wgmma reads, so no proxy fence on
//   the products' path. Cin must be a multiple of 16 (TMA strides); the
//   wrapper pads the rare other shapes with zero channels.
// - Epilogue: (float)acc * (w_scale * x_scale) + bias, each an IEEE
//   operation in the plain version's order, one rounding to the output
//   type: bitwise the plain version.
// - K split where output tiles are few (8 x 8 x 1280): the splits of one
//   tile are one thread-block cluster along z (1, 2, 4 or 8 blocks). Each
//   non-leading block leaves its int32 sums in its shared memory; the
//   leader adds them over distributed shared memory (exact, so any order
//   gives the same bits) and writes the tile. No workspace and nothing to
//   zero. The plan (plan_int8, mirrored by ops/conv.py::int8_plan) is an
//   estimate of the clocks of a two-image batch, never of B.
// What holds it back (chip_smoke.py's times, PERF.md): not the products.
// Throwaway builds on the card at (2, 64, 64, 320 -> 320) (not kept): without
// the wgmma, or without the epilogue's stores, the kernel kept most of its
// time, and with the weights loaded once in place of every tap almost all
// of it (so L2 weight traffic is not the limit either). One wave of 128
// blocks leaves the fill, the per-tap hand-overs and the epilogue exposed;
// a persistent grid that overlaps one tile's epilogue with the next one's
// loads is the next step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <string.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int KC = 128;                    // int8 channels per K chunk: one 128-byte row
constexpr int TILE = 8;                    // a consumer warpgroup's pixels: 8 x 8
constexpr int SW = TILE + 2;               // slab pixels per slab row
constexpr int SEG = SW * SW;               // slab pixels per warpgroup tile
constexpr int SEG_BYTES = 13 * 1024;       // a tile's slab, 1024-byte aligned
constexpr int SLAB_BYTES = 2 * SEG_BYTES;  // one stage: both warpgroups' slabs
constexpr int THREADS = 320;               // 2 consumer warpgroups + 2 producer warps
constexpr int W_BUDGET = 160 * 1024;       // bytes of the weight ring
constexpr int MAX_SPLITS = 8;              // a portable cluster

template <int BN>
__host__ __device__ constexpr int w_stages() {
  return W_BUDGET / (BN * 128) < 8 ? W_BUDGET / (BN * 128) : 8;
}

template <int BN>
constexpr size_t smem_bytes() {
  return 1024 + 2 * SLAB_BYTES + (size_t)w_stages<BN>() * BN * 128 + 8 * (4 + 2 * w_stages<BN>());
}

struct Params {
  const float* w_scale;  // (Cout)
  const float* bias;     // (Cout) or null
  void* out;             // (B, H, W, Cout), fp32 or bf16
  float x_scale;
  int B, H, W, Cin, Cout;
  int tiles_w, tiles_img, tiles;  // 8 x 8 pixel tiles: along W, per image, all
  int splits, per;                // K splits (the cluster along z), chunks per split
};

// m64nNk32 products, s8 x s8 -> s32: d = A B + (scale_d ? d : 0), A and B
// K-major from shared memory. The accumulator layout is the bf16 wgmma's:
// thread t of warp w holds rows 16 w + t / 4 (d[4 i], d[4 i + 1]) and
// 16 w + t / 4 + 8 (d[4 i + 2], d[4 i + 3]) at columns 8 i + 2 (t % 4), + 1.
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da,
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n160(int (&d)[80], uint64_t da,
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da,
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void mma_s8(int (&d)[BN / 2], uint64_t a, uint64_t b);
template <>
__device__ __forceinline__ void mma_s8<64>(int (&d)[32], uint64_t a, uint64_t b) {
  wgmma_s8_n64(d, a, b, 1);
}
template <>
__device__ __forceinline__ void mma_s8<128>(int (&d)[64], uint64_t a, uint64_t b) {
  wgmma_s8_n128(d, a, b, 1);
}
template <>
__device__ __forceinline__ void mma_s8<160>(int (&d)[80], uint64_t a, uint64_t b) {
  wgmma_s8_n160(d, a, b, 1);
}
template <>
__device__ __forceinline__ void mma_s8<256>(int (&d)[128], uint64_t a, uint64_t b) {
  wgmma_s8_n256(d, a, b, 1);
}

__device__ __forceinline__ void st_shared_s32(uint32_t dst, int v) {
  asm volatile("st.shared.s32 [%0], %1;\n" ::"r"(dst), "r"(v) : "memory");
}

// Warpgroup tile w (0, 1) of this block: image b, first row h0, first
// column w0; false (and an all-padding tile) past the last tile.
__device__ __forceinline__ bool tile_of(const Params& p, int w, int& b, int& h0, int& w0) {
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

__device__ __forceinline__ void store_pair(float* o, float v0, float v1, bool both) {
  if (both) {
    *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
  } else {
    o[0] = v0;
  }
}
__device__ __forceinline__ void store_pair(bf16* o, float v0, float v1, bool both) {
  if (both) {
    *reinterpret_cast<uint32_t*>(o) = pack_bf16(v0, v1);
  } else {
    o[0] = __float2bfloat16(v0);
  }
}

// Block (blockIdx.x, blockIdx.y, blockIdx.z): two 8 x 8 pixel tiles (one
// per consumer warpgroup) x BN output channels x K split blockIdx.z (the
// block's rank in its cluster). qmap: q as (Cin, W, H, B), boxes of
// 128 x 10 x 10 x 1; wmap: w_q as (Cin, 9, Cout), boxes of 128 x 1 x BN; both
// 128-byte swizzled. TO: the output type.
template <int BN, typename TO>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_int8_kernel(const Params p, const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap wmap) {
  constexpr int WST = w_stages<BN>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t slab_s = (smem_u32(smem_raw) + 1023u) & ~1023u;  // [2][2][SEG_BYTES]
  const uint32_t w_s = slab_s + 2 * SLAB_BYTES;                    // [WST][BN][128 B]
  const uint32_t x_full = w_s + WST * BN * 128;                    // [2] mbarriers
  const uint32_t slab_empty = x_full + 16;                         // [2]
  const uint32_t w_full = slab_empty + 16;                         // [WST]
  const uint32_t w_empty = w_full + 8 * WST;                       // [WST]
  const int tid = threadIdx.x;
  if (tid == 256) tma_prefetch(&qmap);
  if (tid == 288) tma_prefetch(&wmap);
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(x_full + 8 * s, 1);      // the slab's TMA
      mbar_init(slab_empty + 8 * s, 8);  // every consumer warp
    }
    for (int s = 0; s < WST; ++s) {
      mbar_init(w_full + 8 * s, 1);      // the weight slice's TMA
      mbar_init(w_empty + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * p.per;
  const int nk = min((p.Cin + KC - 1) / KC, k_begin + p.per) - k_begin;
  const bool split = p.splits > 1;

  if (tid >= 256) {
    if (tid == 256) {
      // ---- slab producer: each chunk's slab (the two tiles' 10 x 10
      // pixels with their halo, 128 channels) into one of two stages, once
      // the consumers are done with the chunk two back.
      int b0, h00, w00, b1, h01, w01;
      tile_of(p, 0, b0, h00, w00);
      tile_of(p, 1, b1, h01, w01);
      for (int kl = 0; kl < nk; ++kl) {
        const int s = kl & 1, c0 = (k_begin + kl) * KC;
        mbar_wait(slab_empty + 8 * s, ((kl >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(x_full + 8 * s, 2 * SEG * 128);
        tma_load_4d(slab_s + s * SLAB_BYTES, &qmap, x_full + 8 * s, c0, w00 - 1, h00 - 1, b0);
        tma_load_4d(slab_s + s * SLAB_BYTES + SEG_BYTES, &qmap, x_full + 8 * s, c0, w01 - 1,
                    h01 - 1, b1);
      }
    } else if (tid == 288) {
      // ---- weight producer: the BN x 128 slice of each (chunk, tap) into
      // a ring of WST stages, zero past Cout and Cin.
      int it = 0;
      for (int kl = 0; kl < nk; ++kl) {
        const int c0 = (k_begin + kl) * KC;
        for (int tap = 0; tap < 9; ++tap, ++it) {
          const int s = it % WST;
          mbar_wait(w_empty + 8 * s, ((it / WST) & 1) ^ 1);
          mbar_arrive_expect_tx(w_full + 8 * s, BN * 128);
          tma_load_3d(w_s + s * BN * 128, &wmap, w_full + 8 * s, c0, tap, n0);
        }
      }
    }
    if (split) {  // the consumers' two cluster barriers below
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // ---- consumers: warpgroup wg owns tile wg's 64 pixels x BN channels and
  // issues only wgmma. Tap (dy, dx) reads the slab shifted by dy rows and
  // dx pixels: a descriptor start (rows of 8 pixels, 1280 bytes apart).
  const int wg = tid >> 7;
  const int wt = tid & 127;
  const int lane = wt & 31;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  int prev_stage = -1;
  for (int kl = 0; kl < nk; ++kl) {
    const int ss = kl & 1;
    mbar_wait(x_full + 8 * ss, (kl >> 1) & 1);
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
        mma_s8<BN>(acc, desc_sw128(a0 + ks * 32, 16, SW * 128), desc_sw128(b0 + ks * 32, 16, 1024));
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

  // ---- split K: the cluster's other blocks leave their sums in their
  // shared memory (the slab and ring are free once both warpgroups are
  // done); the leader (rank 0) adds them and writes the tile.
  if (split) {
    const bool leader = cluster_ctarank() == 0;
    named_bar_sync(1, 256);
    const uint32_t red = slab_s + tid * 4;  // [BN / 2][256] int32
    if (!leader) {
      fence_proxy_async();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) st_shared_s32(red + i * 1024, acc[i]);
    }
    cluster_sync();  // the partial sums are in place
    if (leader) {
      for (int r = 1; r < p.splits; ++r) {
        const uint32_t peer = dsmem_addr(red, r);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += ld_dsmem_s32(peer + i * 1024);
      }
    }
    cluster_sync();  // every block keeps its shared memory until the leader has read it
    if (!leader) return;
  }

  // ---- epilogue: dequantise in fp32, one rounding to TO. Accumulator row
  // m = 16 wq + g + 8 hh is pixel (h0 + 2 wq + hh, w0 + g) of the tile; each
  // thread holds channel pairs n0 + 8 i + 2 t4 (+ 1).
  int b, h0, w0;
  const bool valid = tile_of(p, wg, b, h0, w0);
  const int wq = wt >> 5, g = lane >> 2, t4 = lane & 3;
  TO* out = static_cast<TO*>(p.out);
  const bool pairs = p.Cout % 2 == 0;
  long long pix[2];
  bool in[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int h = h0 + 2 * wq + hh, col = w0 + g;
    in[hh] = valid && h < p.H && col < p.W;
    pix[hh] = ((long long)b * p.H + h) * p.W + col;
  }
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int co = n0 + 8 * i + 2 * t4;
    if (co >= p.Cout) continue;
    const bool two = co + 1 < p.Cout;
    // the channels' constants once for both rows
    const float s0 = __fmul_rn(p.w_scale[co], p.x_scale);
    const float s1 = two ? __fmul_rn(p.w_scale[co + 1], p.x_scale) : 0.f;
    const float b0 = p.bias != nullptr ? p.bias[co] : 0.f;
    const float b1 = p.bias != nullptr && two ? p.bias[co + 1] : 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (!in[hh]) continue;
      float v0 = __fmul_rn(__int2float_rn(acc[4 * i + 2 * hh]), s0);
      float v1 = __fmul_rn(__int2float_rn(acc[4 * i + 2 * hh + 1]), s1);
      if (p.bias != nullptr) {
        v0 = __fadd_rn(v0, b0);
        v1 = __fadd_rn(v1, b1);
      }
      TO* o = out + pix[hh] * p.Cout + co;
      if (pairs) {
        store_pair(o, v0, v1, true);
      } else {
        store_pair(o, v0, v1, false);
        if (two) store_pair(o + 1, v1, 0.f, false);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Mirrored by ops/conv.py::int8_plan: 8 x 8 pixel tiles, two a block; the
// Cout tile BN of {64, 128, 160, 256} and the K split into `splits` (1, 2,
// 4 or 8: a portable cluster) runs of `per` 128-channel chunks that an
// estimate of the clocks of a two-image batch finds fastest, among the
// tiles that pad Cout least (never from B; ties keep the wider tile and
// fewer splits). m64nNk32 s8 takes the clocks of m64nNk16 bf16, so the
// estimate is plan_bf16's.
struct Plan {
  int BN, tiles_w, tiles_img, tiles, blocks, n_tiles, splits, per;
  size_t smem;
};

Plan plan_int8(int B, int H, int W, int Cin, int Cout, int sms) {
  Plan pl;
  pl.tiles_w = (W + TILE - 1) / TILE;
  pl.tiles_img = (H + TILE - 1) / TILE * pl.tiles_w;
  pl.tiles = B * pl.tiles_img;
  pl.blocks = (pl.tiles + 1) / 2;
  const int n_chunks = (Cin + KC - 1) / KC;
  const int options[4] = {256, 160, 128, 64};
  long long least = 1LL << 40;
  for (int bn : options) least = std::min(least, (long long)(Cout + bn - 1) / bn * bn);
  double best = 1e300;
  for (int bn : options) {
    const int n_tiles = (Cout + bn - 1) / bn;
    if ((long long)n_tiles * bn > least) continue;
    const double t_mma = std::max(bn / 2.0, 16.0 + bn / 4.0);
    for (int want = 1; want <= MAX_SPLITS && want <= n_chunks; want *= 2) {
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
    case 64: pl.smem = smem_bytes<64>(); break;
    case 128: pl.smem = smem_bytes<128>(); break;
    case 160: pl.smem = smem_bytes<160>(); break;
    default: pl.smem = smem_bytes<256>(); break;
  }
  return pl;
}

template <int BN, typename TO>
cudaError_t launch(const Params& p, const Plan& pl, const int8_t* q, const int8_t* w,
                   cudaStream_t stream) {
  auto kernel = conv3x3_int8_kernel<BN, TO>;
  constexpr size_t smem = smem_bytes<BN>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap qmap, wmap;
  memset(&qmap, 0, sizeof(qmap));
  memset(&wmap, 0, sizeof(wmap));
  const cuuint64_t row = (cuuint64_t)p.Cin;
  const cuuint64_t qd[4] = {(cuuint64_t)p.Cin, (cuuint64_t)p.W, (cuuint64_t)p.H, (cuuint64_t)p.B};
  const cuuint64_t qs[3] = {row, row * p.W, row * p.W * p.H};
  const cuuint32_t qb[4] = {KC, SW, SW, 1};
  const cuuint64_t wd[3] = {(cuuint64_t)p.Cin, 9, (cuuint64_t)p.Cout};
  const cuuint64_t ws[2] = {row, row * 9};
  const cuuint32_t wb[3] = {KC, 1, BN};
  if (!tensor_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, 4, qd, qs, qb) ||
      !tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, 3, wd, ws, wb))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.blocks, pl.n_tiles, pl.splits);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = pl.splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p, qmap, wmap);
  return err != cudaSuccess ? err : cudaGetLastError();
}

bool aligned16(const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15u) == 0; }

}  // namespace

// The plan for a shape: out[0..6] = the Cout tile, 8 x 8 pixel tiles,
// blocks along the pixels, Cout tiles, K splits, chunks per split, shared
// memory bytes. `sms` is the SM count it plans for.
extern "C" void ppt_conv3x3_int8_plan(int B, int H, int W, int Cin, int Cout, int sms,
                                      long long* out) {
  const Plan pl = plan_int8(B, H, W, Cin, Cout, sms);
  const long long v[7] = {pl.BN, pl.tiles, pl.blocks, pl.n_tiles, pl.splits, pl.per,
                          (long long)pl.smem};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}

// q: (B, H, W, Cin) int8, the quantised activation; w: (Cout, 3, 3, Cin)
// int8; w_scale (Cout) and bias (Cout, or null) fp32; out: (B, H, W, Cout)
// bf16 when out_bf16, else fp32; all contiguous, q and w 16-byte aligned,
// Cin a multiple of 16. Returns the CUDA error code of the launch.
extern "C" int ppt_conv3x3_int8(const int8_t* q, const int8_t* w, const float* w_scale,
                                const float* bias, void* out, float x_scale, int out_bf16,
                                int B, int H, int W, int Cin, int Cout, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cin % 16 != 0 ||
      !aligned16(q) || !aligned16(w) || w_scale == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  const Plan pl = plan_int8(B, H, W, Cin, Cout, hopper::sm_count());
  if ((long long)B * H * W > 2147483647LL || pl.n_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{w_scale, bias, out, x_scale, B, H, W, Cin, Cout,
                 (W + TILE - 1) / TILE, pl.tiles_img, pl.tiles, pl.splits, pl.per};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pl.BN) {
    case 64: return (int)(out_bf16 ? launch<64, bf16>(p, pl, q, w, s) : launch<64, float>(p, pl, q, w, s));
    case 128: return (int)(out_bf16 ? launch<128, bf16>(p, pl, q, w, s) : launch<128, float>(p, pl, q, w, s));
    case 160: return (int)(out_bf16 ? launch<160, bf16>(p, pl, q, w, s) : launch<160, float>(p, pl, q, w, s));
    default: return (int)(out_bf16 ? launch<256, bf16>(p, pl, q, w, s) : launch<256, float>(p, pl, q, w, s));
  }
}
