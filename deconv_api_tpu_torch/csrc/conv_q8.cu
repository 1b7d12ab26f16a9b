// The int8 layer step of the int8 execution tier (quality=int8), NHWC, for
// sm_90a: K5.
//
// Replaces no Pallas kernel.  The JAX package's int8 tier
// (deconv_api_tpu/engine/deconv.py:_up_step_q8) quantizes each conv or
// dense layer's input per batch row, contracts int8 x int8 -> int32 in XLA
// (deconv_api_tpu/ops/conv.py:conv2d_q8, ops/linear.py:dense_q8), folds the
// bias into the accumulator, applies relu on it and dequantizes.  Eager
// PyTorch on CUDA has no int8 convolution, so the port runs the whole step
// here, in four entries:
//   quantize_rows_q8  the input, float32 (rows, L) -> int8 at a scale per row;
//   quantize_t_q8     the weight, float32 [R][C] -> int8 [C][R] (K-major);
//   conv_q8           the implicit-GEMM conv (a dense layer of many rows too);
//   dense_q8          a dense layer of few rows: a split-K GEMV and its fold.
// The arithmetic is the reference's, written with rounding intrinsics so no
// nvcc flag can move a bit: q = clip(rint(x / s), +-127) with an IEEE
// division; bq = clip(rint(b / scale), +-2^30); acc + bq; relu on the int32;
// float(acc) * scale, where scale = sx * sw is the caller's tensor.
//
// Bound on the H100: bytes.  At the 11 VGG16 convs of batch 8 up to
// block5_conv1 the contraction reads 36 MB of int8 operands and writes 427
// MB of float32 outputs, 0.14 ms at 3.35 TB/s; the operations, 14.42 GMAC
// an image, take 0.117 ms at 1,979 int8 TOPS; site by site the larger of
// the two sums to 0.186 ms, and from block1_conv2 to block3_conv3 each
// site's output write outlasts its tensor-core work.  So the output leaves
// once, as the layer's float32, and no int32 tensor goes back to device
// memory.
//
// conv_q8: GEMM rows M = output pixels (n, ho, wo), columns N = Cout, the
// reduction k = (kh, kw, ci).  The weight comes K-major (OHWI, [Cout][K]),
// as quantize_t_q8 writes it from the HWIO float weight in the one pass the
// step makes over the weight anyway.  Every kernel runs wgmma m64nNk32 s8 x
// s8 -> s32 from shared memory, two warpgroups of 64 rows a block, and
// finishes in its epilogue (bias fold, relu, dequantize).
// - conv_q8_patch (stride 1, Cin % 16 == 0: the VGG16 convs but the
//   first): K3's tiling (csrc/fused_unpool_conv.cu) on TMA.  A block owns
//   8 x 16 (or 16 x 8) output pixels and 64 or 128 channels; per chunk of
//   64 or 128 input channels the halo tile under the patch lands once, and
//   every tap's A operand is a descriptor into it, shifted by the tap.  B,
//   one (chunk, tap) slice a step, streams through a ring of 4 stages
//   requested two steps ahead, each stage's bytes counted in by an
//   mbarrier, so a step's wgmma runs while the next two land.  Halo and B
//   are 64B- or 128B-swizzled, so every TMA box moves whole rows (16-byte
//   boxes ran at half the rate).  The epilogue stages the finished patch in
//   swizzled 8 x 8 x 32 boxes and stores them by TMA.  The tensor maps are
//   made at each launch (cuTensorMapEncodeTiled, through the runtime) and
//   passed as __grid_constant__ parameters, so a captured graph keeps them;
//   the zero padding is the TMA's out-of-bounds fill.
// - conv_q8_ring (other strides, Cin % 16 == 0): an implicit GEMM of 128
//   rows whose A rows (each output pixel's input pixel at a tap) and B rows
//   arrive by cp.async, 16 bytes a copy, into the same kind of ring, as
//   16-byte k-planes (eight rows of a plane are one core matrix); the
//   epilogue goes through a swizzled int32 tile, 16 bytes a thread.
// - conv_q8_halo (Cin not a multiple of 16, Cin = 3 at block1_conv1, or a
//   misaligned input): a block of 128 pixels of one output row loads the
//   input rows under them once (the halo tile) and forms each 64-deep slice
//   of their im2col rows from it in shared memory (the 27 -> 32 reduction
//   at Cin 3 is one slice); its output leaves by TMA as the patch's does.
// dense_q8: A = the K-major weight [Dout][Din], 64 outputs a block; B = 8
// input rows; wgmma m64n8k32; the reduction split across blocks so that
// fc1's 103 MB weight streams through every SM; a second small kernel sums
// the int32 partials (exact, so any split gives the same bits) and finishes.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;           // GEMM rows per block: two warpgroups of 64
constexpr int BK = 64;            // reduction bytes per step
constexpr int KP = BK / 16;       // 16-byte k-planes per step
constexpr int STAGES = 4;         // ring depth, in steps
constexpr int AHEAD = STAGES - 2; // steps a stage is requested ahead
constexpr int THREADS = 256;
constexpr int A_PLANE = BM * 16 + 16;  // a plane padded by 16 bytes: 8 planes of a row in 8 bank groups

template <int BN>
struct Ring {
  static constexpr int B_PLANE = BN * 16 + 16;
  static constexpr int A_STAGE = KP * A_PLANE;
  static constexpr int B_STAGE = KP * B_PLANE;
  static constexpr int STAGE = A_STAGE + B_STAGE;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int TILE = BM * BN * 4;  // the epilogue's int32 tile, over the ring
  static constexpr int SMEM = RING > TILE ? RING : TILE;
};

// dense_q8's GEMV: 64 outputs x 8 rows a block, 256 reduction bytes a step
constexpr int DBM = 64, DROWS = 8, DBK = 256, DKP = DBK / 16, DTHREADS = 128;
constexpr int D_APLANE = DBM * 16 + 16, D_BPLANE = DROWS * 16 + 16;
constexpr int D_ASTAGE = DKP * D_APLANE, D_STAGE = D_ASTAGE + DKP * D_BPLANE;
constexpr int D_SMEM = STAGES * D_STAGE;

enum Mode { RAW = 0, LINEAR = 1, RELU = 2 };  // raw: the int32 accumulator

struct Conv {
  const int8_t* x;      // (N, H, W, Cin)
  const int8_t* w;      // (Cout, KH, KW, Cin)
  void* out;            // (N, Ho, Wo, Cout), int32 (RAW) or float32
  const float* bias;    // (Cout,)
  const float* scale;   // (N,): sx * sw per batch row
  int N, H, W, Cin, KH, KW, Cout, Ho, Wo, sh, sw, pt, pl;
  int K;      // KH * KW * Cin
  int64_t M;  // N * Ho * Wo
  int mode;
  int vec_out;  // Cout % 4 == 0 and out 16-byte aligned
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wgmma (sm_90a), s8 x s8 -> s32: D[64 x N] += A[64 x 32] B[32 x N], both
// operands from shared memory through descriptors (the accumulator layout of
// mma.m16n8k32 per warp: warp w of the warpgroup holds rows 16w..16w+15)
__device__ __forceinline__ void wgmma_s8(int (&d)[4], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across the async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
// orders this thread's generic-proxy shared-memory writes (stores and
// cp.async) before the async proxy's (wgmma's) reads
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// Wait for the phase of parity `parity` of the mbarrier at `bar` to
// complete; a copy that never lands traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (i > (1u << 26)) __trap();
  }
}
// TMA: a box of the tensor map at the coordinates into shared memory,
// completing `bytes` of the mbarrier's transaction count
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2, int c3) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
               : "memory");
}
__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile without swizzle: core
// matrices of 8 rows x 16 bytes (rows 16 bytes apart), `lbo` bytes between
// the two core matrices of a 32-deep k slice, `sbo` bytes between groups of
// 8 rows.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)((lbo & 0x3ffff) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3ffff) >> 4) << 32);
}

// A view into a K-major tile of `row` = 64 or 128 bytes a row, swizzled to
// match (64B or 128B) by TMA into a buffer on a 1024-byte boundary, whose
// 8-row groups are `sbo` bytes apart and may start at any row: the swizzle
// follows the address bits, so a view shifted by whole rows reads the rows
// TMA wrote there.
__device__ __forceinline__ uint64_t smem_desc_view(uint32_t addr, uint32_t sbo, int row) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | (1ull << 16) | ((uint64_t)((sbo & 0x3ffff) >> 4) << 32) |
         ((uint64_t)(row == 128 ? 1 : 2) << 62);
}



// Byte offset of 16-byte chunk `ch` of row `r` in a tile of `row_bytes`-byte
// rows: the chunk index XORed with r % 8, so the fragment stores of 8 rows
// hit 8 bank groups.
__device__ __forceinline__ uint32_t tile_off(int r, int ch, int row_bytes) {
  return (uint32_t)(r * row_bytes + ((ch ^ (r & 7)) << 4));
}

__device__ __forceinline__ int8_t quantize(float v, float s) {
  return (int8_t)(int)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
}

// the bias folded into the accumulator's units at scale s
__device__ __forceinline__ int fold(float b, float s) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(b, s)), -1073741824.f), 1073741824.f);
}

// the step's finish of one accumulator: the folded bias, relu, dequantize
__device__ __forceinline__ uint32_t finish(int acc, int mode, int bq, float s) {
  if (mode == RAW) return (uint32_t)acc;
  int a = acc + bq;
  if (mode == RELU) a = max(a, 0);
  return __float_as_uint(__fmul_rn(__int2float_rn(a), s));
}

// A warpgroup's 64 x BN accumulators (warp w of it holding rows 16w ..
// 16w + 15) into rows row0 .. row0 + 63 of a swizzled int32 tile
template <int BN>
__device__ __forceinline__ void frag_to_tile(const int (&acc)[BN / 2], uint8_t* tile, int row0) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + warp * 16 + (lane >> 2) + half * 8;
      const int col = j * 8 + (lane & 3) * 2;
      *reinterpret_cast<int2*>(tile + tile_off(row, col >> 2, BN * 4) + (col & 3) * 4) =
          make_int2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
}

// The bias of channels n0 .. n0 + BN - 1 folded at scale s, for a block
// whose rows are all of one image
template <int BN, int NT>
__device__ __forceinline__ void fold_table(const Conv& p, int* bq_s, float s, int n0) {
  if (p.mode == RAW) return;
  for (int c = threadIdx.x; c < BN; c += NT) bq_s[c] = fold(p.bias[min(n0 + c, p.Cout - 1)], s);
}

// Tile rows 0 .. rows - 1 out, 16 bytes a thread: tile row r to output
// row pix(r) (none where negative), channels n0 ..  With bq_s, every row is
// of one image, at scale s with its folded bias in bq_s; without, each
// row's image is m / (Ho * Wo).
template <int BN, int NT, typename Pix>
__device__ __forceinline__ void tile_out(const Conv& p, const uint8_t* tile, int rows, int n0, const int* bq_s,
                                         float s, Pix pix) {
  constexpr int CH = BN / 4;
  const int64_t hw = (int64_t)p.Ho * p.Wo;
  for (int j = threadIdx.x; j < rows * CH; j += NT) {
    const int row = j / CH, ch = j - row * CH;
    const int c = n0 + ch * 4;
    const int64_t m = pix(row);
    if (m < 0 || c >= p.Cout) continue;
    const int4 v = *reinterpret_cast<const int4*>(tile + tile_off(row, ch, BN * 4));
    const int a[4] = {v.x, v.y, v.z, v.w};
    int bq[4] = {0, 0, 0, 0};
    float sr = s;
    if (p.mode != RAW) {
      if (bq_s) {
#pragma unroll
        for (int e = 0; e < 4; ++e) bq[e] = bq_s[ch * 4 + e];
      } else {
        sr = p.scale[m / hw];
#pragma unroll
        for (int e = 0; e < 4; ++e) bq[e] = fold(p.bias[min(c + e, p.Cout - 1)], sr);
      }
    }
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = finish(a[e], p.mode, bq[e], sr);
    uint32_t* dst = reinterpret_cast<uint32_t*>(p.out) + m * p.Cout + c;
    if (p.vec_out) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < p.Cout) dst[e] = o[e];
    }
  }
}

// A warpgroup's finished accumulators (bias fold, relu, dequantize) into
// boxes of 32 channels by `box_rows` rows of 128 bytes, 128B-swizzled (row
// r's 16-byte chunk c at c ^ (r % 8)) for TMA stores: channel col of the
// warpgroup's row r goes to box box0 + col / 32, row row0 + r.
template <int BN>
__device__ __forceinline__ void stage_boxes(const Conv& p, const int (&acc)[BN / 2], uint8_t* smem, int box_rows,
                                            int box0, int row0, const int* bq_s, float sc) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + warp * 16 + (lane >> 2) + half * 8;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = j * 8 + (lane & 3) * 2, c32 = col & 31;
      uint8_t* const row = smem + ((box0 + (col >> 5)) * box_rows + r) * 128;
      *reinterpret_cast<uint2*>(row + (((c32 >> 2) ^ (r & 7)) << 4) + (c32 & 3) * 4) =
          make_uint2(finish(acc[4 * j + 2 * half], p.mode, bq_s[col], sc),
                     finish(acc[4 * j + 2 * half + 1], p.mode, bq_s[col + 1], sc));
    }
  }
  fence_proxy_async();  // the generic-proxy stores before the TMA reads them
}

__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Cin % 16 == 0, 16-byte aligned operands: the cp.async ring.  Block b is
// row tile b / tiles_n, channel tile b % tiles_n (neighbouring blocks share
// their A rows in the L2).
template <int BN>
__global__ void __launch_bounds__(THREADS, 2) conv_q8_ring(const Conv p, int tiles_n) {
  using R = Ring<BN>;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  const int64_t m0 = (int64_t)(blockIdx.x / tiles_n) * BM;
  const int64_t left = p.M - m0;
  const int rows = left < BM ? (int)left : BM;

  // A loader: chunk j = tid + q * THREADS is plane j % KP of row j / KP,
  // so a warp's copies cover whole 64-byte row slices
  constexpr int AQ = BM * KP / THREADS;
  bool a_ok[AQ];
  int a_h0[AQ], a_w0[AQ];
  const int8_t* a_img[AQ];
#pragma unroll
  for (int q = 0; q < AQ; ++q) {
    const int64_t am = m0 + (tid + q * THREADS) / KP;
    a_ok[q] = am < p.M;
    a_h0[q] = a_w0[q] = 0;
    a_img[q] = p.x;
    if (a_ok[q]) {
      const int64_t hw = (int64_t)p.Ho * p.Wo;
      const int n = (int)(am / hw);
      const int rem = (int)(am - n * hw);
      const int ho = rem / p.Wo, wo = rem - ho * p.Wo;
      a_h0[q] = ho * p.sh - p.pt;
      a_w0[q] = wo * p.sw - p.pl;
      a_img[q] = p.x + (int64_t)n * p.H * p.W * p.Cin;
    }
  }
  const int cchunks = (p.Cin + BK - 1) / BK;
  const int steps = p.KH * p.KW * cchunks;

  auto load = [&](int stage, int step) {
    const int tap = step / cchunks, c0 = (step - tap * cchunks) * BK;
    const int kh = tap / p.KW, kw = tap - kh * p.KW;
    uint8_t* const a_dst = smem + stage * R::STAGE;
    uint8_t* const b_dst = a_dst + R::A_STAGE;
#pragma unroll
    for (int q = 0; q < AQ; ++q) {
      const int j = tid + q * THREADS;
      const int r = j / KP, pl = j % KP;
      const int h = a_h0[q] + kh, w = a_w0[q] + kw, ci = c0 + pl * 16;
      const bool ok = a_ok[q] && h >= 0 && h < p.H && w >= 0 && w < p.W && ci < p.Cin;
      cp_async16(smem_u32(a_dst + pl * A_PLANE + r * 16),
                 ok ? a_img[q] + ((int64_t)h * p.W + w) * p.Cin + ci : p.x, ok ? 16 : 0);
    }
#pragma unroll
    for (int q = 0; q < BN * KP / THREADS; ++q) {
      const int j = tid + q * THREADS;
      const int r = j / KP, pl = j % KP;
      const int co = n0 + r, ci = c0 + pl * 16;
      const bool ok = co < p.Cout && ci < p.Cin;
      cp_async16(smem_u32(b_dst + pl * R::B_PLANE + r * 16),
                 ok ? p.w + (int64_t)co * p.K + tap * p.Cin + ci : p.w, ok ? 16 : 0);
    }
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  for (int s = 0; s < AHEAD; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();  // step s has landed; the wgmma of step s - 2, its stage's last reader, is done
    if (s + AHEAD < steps) load((s + AHEAD) % STAGES, s + AHEAD);
    cp_async_commit();
    const uint32_t a_base = s0 + (s % STAGES) * R::STAGE + wg * 64 * 16;
    const uint32_t b_base = s0 + (s % STAGES) * R::STAGE + R::A_STAGE;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KP / 2; ++ks)
      wgmma_s8(acc, smem_desc(a_base + 2 * ks * A_PLANE, A_PLANE, 128),
               smem_desc(b_base + 2 * ks * R::B_PLANE, R::B_PLANE, 128));
    wgmma_commit();
    wgmma_wait<1>();  // step s - 1's products are done; step s's run on
  }
  wgmma_wait<0>();
  fence_regs(acc);
  cp_async_wait<0>();
  __syncthreads();
  frag_to_tile<BN>(acc, smem, wg * 64);
  __syncthreads();
  tile_out<BN, THREADS>(p, smem, rows, n0, nullptr, 1.f, [&](int r) { return r < rows ? m0 + r : (int64_t)-1; });
}

__host__ __device__ constexpr int patch_stages(int bn, int ck) { return bn * ck <= 4096 ? 6 : 4; }

// Stride 1 with at least 3 taps, Cin % 16 == 0, aligned operands, Cout %
// 4 == 0: K3's tiling on TMA.  Block b owns a patch of tr x tc = 8 x 16 or
// 16 x 8 output pixels of one image (two 8 x 8 sub-patches, one a
// warpgroup: 128 GEMM rows) and BN channels.  For each chunk of CK input
// channels, the halo tile under the patch ((tr + KH - 1) x (tc + KW - 1)
// pixels of CK bytes, one TMA box) lands once in one of two buffers, and
// every tap's A operand is a descriptor into it, shifted by the tap: eight
// consecutive pixels of a halo row are an 8-row group, the sub-patch's rows
// hc pixels apart.  B, one (chunk, tap) slice of BN rows a step, streams
// through a ring of STAGES, requested AHEAD steps ahead.  Both are
// swizzled (64B at CK 64, 128B at CK 128), so each TMA box moves whole
// 64- or 128-byte rows.  Thread 0 issues every copy; an mbarrier per stage
// and per halo buffer counts its bytes in.  The next chunk's halo is
// requested once the wgmma of the chunk before, the buffer's last reader,
// is done, and waited for at that chunk's first step.  The epilogue finishes the accumulators into 8 x 8 x 32
// boxes staged over the ring and stores them by TMA, which clips pixels
// and channels past the output.  Shared memory: the B ring | two halo
// buffers | the mbarriers; the staged boxes and the folded bias over them.
template <int BN, int CK>
__global__ void __launch_bounds__(THREADS, BN == 64 ? 3 : 2)
    conv_q8_patch(const Conv p, int tr, int tc, int tiles_r, int tiles_c, int tiles_n,
                  const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap omap) {
  // the ring: 6 stages of small slices (4 KB), else 4, asked for two steps
  // ahead of the wait depth
  constexpr int B_STAGE = BN * CK, STAGES = patch_stages(BN, CK), AHEAD = STAGES - 2, WAIT = STAGES - AHEAD - 1;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  // the swizzle repeats every 8 rows: buffers start on 1024-byte boundaries
  uint8_t* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_u32(smem);
  const int hc = tc + p.KW - 1, hrows = (tr + p.KH - 1) * hc;
  const int h_buf = (hrows * CK + 1023) / 1024 * 1024, h_off = STAGES * B_STAGE;
  const uint32_t bars = s0 + h_off + 2 * h_buf;  // full[STAGES], then halo_full[2]

  int bid = blockIdx.x;
  const int n0 = (bid % tiles_n) * BN;
  bid /= tiles_n;
  const int c0 = (bid % tiles_c) * tc;
  bid /= tiles_c;
  const int r0 = (bid % tiles_r) * tr, n = bid / tiles_r;
  const int tid = threadIdx.x, wg = tid >> 7;
  // the warpgroup's sub-patch, in output pixels from the patch's origin
  const int sy = tc == 8 ? wg * 8 : 0, sx = tc == 8 ? 0 : wg * 8;
  const int T = p.KH * p.KW;

  auto load_halo = [&](int buf, int ch0) {
    const uint32_t bar = bars + (STAGES + buf) * 8;
    mbar_expect_tx(bar, hrows * CK);
    tma_4d(s0 + h_off + buf * h_buf, &xmap, ch0, c0 - p.pl, r0 - p.pt, n, bar);
  };
  auto load_b = [&](int stage, int chunk, int tap) {
    const uint32_t bar = bars + stage * 8;
    mbar_expect_tx(bar, B_STAGE);
    tma_2d(s0 + stage * B_STAGE, &wmap, tap * p.Cin + chunk * CK, n0, bar);
  };
  if (tid == 0) {
    for (int i = 0; i < STAGES + 2; ++i) mbar_init(bars + i * 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int cchunks = (p.Cin + CK - 1) / CK, steps = cchunks * T;
  int l_chunk = 0, l_tap = 0;  // the step load_b fetches next
  for (int s = 0; s < AHEAD && s < steps; ++s) {
    if (tid == 0) {
      if (s == 0) load_halo(0, 0);
      load_b(s, l_chunk, l_tap);
    }
    if (++l_tap == T) l_tap = 0, ++l_chunk;
  }

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const uint32_t a_sub = (sy * hc + sx) * CK;  // the sub-patch's first halo pixel at tap (0, 0)
  int chunk = 0, tap = 0;
  for (int s = 0; s < steps; ++s) {
    mbar_wait(bars + (s % STAGES) * 8, (s / STAGES) & 1);
    if (tap == 0) mbar_wait(bars + (STAGES + (chunk & 1)) * 8, (chunk >> 1) & 1);
    __syncthreads();  // the wgmma of step s + AHEAD - STAGES, the stage's last reader, is done
    if (s + AHEAD < steps) {
      if (tid == 0) load_b((s + AHEAD) % STAGES, l_chunk, l_tap);
      if (++l_tap == T) l_tap = 0, ++l_chunk;
    }
    if (tid == 0 && tap == WAIT && chunk + 1 < cchunks) load_halo((chunk + 1) & 1, (chunk + 1) * CK);
    const int dy = tap / p.KW, dx = tap - dy * p.KW;
    const uint32_t a_base = s0 + h_off + (chunk & 1) * h_buf + a_sub + (dy * hc + dx) * CK;
    const uint32_t b_base = s0 + (s % STAGES) * B_STAGE;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < CK / 32; ++ks)
      wgmma_s8(acc, smem_desc_view(a_base + 32 * ks, hc * CK, CK), smem_desc_view(b_base + 32 * ks, 8 * CK, CK));
    wgmma_commit();
    wgmma_wait<WAIT>();  // the products of step s + AHEAD - STAGES are done
    if (++tap == T) tap = 0, ++chunk;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  __syncthreads();

  // the finished float32 (or raw int32) accumulators out by TMA: one
  // 8 x 8 x 32 box per sub-patch and 32 channels
  const float sc = p.mode == RAW ? 1.f : p.scale[n];
  int* const bq_s = reinterpret_cast<int*>(smem + BM * BN * 4);
  fold_table<BN, THREADS>(p, bq_s, sc, n0);
  __syncthreads();
  stage_boxes<BN>(p, acc, smem, 64, wg * (BN / 32), 0, bq_s, sc);
  __syncthreads();
  if (tid == 0) {
    for (int w = 0; w < 2; ++w)
      for (int g = 0; g < BN / 32; ++g)
        tma_store_4d(&omap, s0 + (w * (BN / 32) + g) * 64 * 128, n0 + g * 32,
                     c0 + (tc == 8 ? 0 : w * 8), r0 + (tc == 8 ? w * 8 : 0), n);
    tma_store_drain();
  }
}

// Any Cin and alignment: block b is pixels wo0 .. wo0 + 127 of output row
// (n, ho) and a channel tile.  The input rows under them (the halo tile,
// KH rows of `halo_cols` pixels) load once; each 64-deep reduction slice of
// the block's im2col rows is formed from it in shared memory, through a
// table of each k's offset in the tile, beside the slice of B.  Where Cout
// % 4 == 0 and the output is aligned the epilogue stores by TMA (one box
// of 128 pixels by 32 channels per 32 channels), else 16 bytes a thread.
// Shared memory: A | B | koff | halo; the epilogue's boxes and the folded
// bias over them.
template <int BN>
__global__ void __launch_bounds__(THREADS, BN == 64 ? 4 : 2)
    conv_q8_halo(const Conv p, int tiles_w, int tiles_n, int halo_cols, const __grid_constant__ CUtensorMap omap) {
  using R = Ring<BN>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  // on a 1024-byte boundary: the epilogue's boxes are 128B-swizzled
  uint8_t* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const a_s = smem;
  uint8_t* const b_s = smem + R::A_STAGE;
  int* const koff = reinterpret_cast<int*>(b_s + R::B_STAGE);
  int8_t* const halo = reinterpret_cast<int8_t*>(koff + BK);
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x, wg = tid >> 7;

  int bid = blockIdx.x;
  const int n0 = (bid % tiles_n) * BN;
  bid /= tiles_n;
  const int wo0 = (bid % tiles_w) * BM;
  bid /= tiles_w;
  const int ho = bid % p.Ho, n = bid / p.Ho;
  const int rows = min(BM, p.Wo - wo0);
  const int64_t m0 = ((int64_t)n * p.Ho + ho) * p.Wo + wo0;

  // the halo tile: input rows ho * sh - pt + kh, from pixel wo0 * sw - pl,
  // halo_cols pixels each, zero outside the image
  const int row_bytes = halo_cols * p.Cin;
  const int64_t w_lo = (int64_t)(wo0 * p.sw - p.pl) * p.Cin;
  for (int i = tid; i < p.KH * row_bytes; i += THREADS) {
    const int kh = i / row_bytes;
    const int h = ho * p.sh - p.pt + kh;
    const int64_t off = w_lo + (i - kh * row_bytes);
    halo[i] = (h >= 0 && h < p.H && off >= 0 && off < (int64_t)p.W * p.Cin)
                  ? p.x[((int64_t)n * p.H + h) * p.W * p.Cin + off]
                  : (int8_t)0;
  }

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const int pix = p.sw * p.Cin;  // halo bytes between neighbouring output pixels
  for (int k0 = 0; k0 < p.K; k0 += BK) {
    if (tid < BK) {
      const int k = k0 + tid;
      int o = -1;
      if (k < p.K) {
        const int kh = k / (p.KW * p.Cin), rem = k - kh * p.KW * p.Cin;
        o = kh * row_bytes + rem;  // rem = kw * Cin + ci
      }
      koff[tid] = o;
    }
    for (int j = tid; j < BN * KP; j += THREADS) {
      const int r = j / KP, pl = j % KP;
      const int co = n0 + r;
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (co < p.Cout) {
        const int8_t* src = p.w + (int64_t)co * p.K;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int k = k0 + pl * 16 + e;
          if (k < p.K) v[e >> 2] |= (uint32_t)(uint8_t)__ldg(src + k) << (8 * (e & 3));
        }
      }
      *reinterpret_cast<uint4*>(b_s + pl * R::B_PLANE + r * 16) = make_uint4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();  // the halo and the table are in; the last slice's wgmma is done
    for (int j = tid; j < BM * KP; j += THREADS) {
      const int r = j / KP, pl = j % KP;
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (r < rows) {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int o = koff[pl * 16 + e];
          if (o >= 0) v[e >> 2] |= (uint32_t)(uint8_t)halo[o + r * pix] << (8 * (e & 3));
        }
      }
      *reinterpret_cast<uint4*>(a_s + pl * A_PLANE + r * 16) = make_uint4(v[0], v[1], v[2], v[3]);
    }
    fence_proxy_async();
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KP / 2; ++ks)
      wgmma_s8(acc, smem_desc(s0 + wg * 64 * 16 + 2 * ks * A_PLANE, A_PLANE, 128),
               smem_desc(s0 + R::A_STAGE + 2 * ks * R::B_PLANE, R::B_PLANE, 128));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warpgroup's wgmma has read the slice
  }
  const float sc = p.mode == RAW ? 1.f : p.scale[n];
  int* const bq_s = reinterpret_cast<int*>(smem + R::TILE);
  fold_table<BN, THREADS>(p, bq_s, sc, n0);
  if (p.vec_out) {  // out by TMA: one box of 128 pixels by 32 channels per 32 channels
    __syncthreads();
    stage_boxes<BN>(p, acc, smem, BM, 0, wg * 64, bq_s, sc);
    __syncthreads();
    if (tid == 0) {
      for (int g = 0; g < BN / 32; ++g) tma_store_4d(&omap, s0 + g * BM * 128, n0 + g * 32, wo0, ho, n);
      tma_store_drain();
    }
    return;
  }
  frag_to_tile<BN>(acc, smem, wg * 64);
  __syncthreads();
  tile_out<BN, THREADS>(p, smem, rows, n0, bq_s, sc, [&](int r) { return r < rows ? m0 + r : (int64_t)-1; });
}

// dense_q8, the GEMV: block (o-tile, split, row group) sums outputs o0 ..
// o0 + 63 of rows b0 .. b0 + 7 over reduction bytes [split * kper, + kper)
// into ws[split][row][o].  The same ring as conv_q8_ring, 256 bytes a step.
__global__ void __launch_bounds__(DTHREADS) dense_q8_gemv(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                                                          int32_t* __restrict__ ws, int B, int Din, int Dout,
                                                          int kper) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int o0 = blockIdx.x * DBM, split = blockIdx.y, b0 = blockIdx.z * DROWS;
  const int k0 = split * kper, k1 = min(Din, k0 + kper);
  const int steps = (k1 - k0 + DBK - 1) / DBK;

  auto load = [&](int stage, int step) {
    const int kb = k0 + step * DBK;
    uint8_t* const a_dst = smem + stage * D_STAGE;
    uint8_t* const b_dst = a_dst + D_ASTAGE;
#pragma unroll
    for (int q = 0; q < DBM * DKP / DTHREADS; ++q) {
      const int j = tid + q * DTHREADS;
      const int r = j / DKP, pl = j % DKP;
      const int k = kb + pl * 16;
      const bool ok = o0 + r < Dout && k < k1;
      cp_async16(smem_u32(a_dst + pl * D_APLANE + r * 16), ok ? w + (int64_t)(o0 + r) * Din + k : w, ok ? 16 : 0);
    }
    const int r = tid / DKP, pl = tid % DKP;  // DROWS * DKP == DTHREADS
    const int k = kb + pl * 16;
    const bool ok = b0 + r < B && k < k1;
    cp_async16(smem_u32(b_dst + pl * D_BPLANE + r * 16), ok ? x + (int64_t)(b0 + r) * Din + k : x, ok ? 16 : 0);
  };

  int acc[4] = {0, 0, 0, 0};
  for (int s = 0; s < AHEAD; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    if (s + AHEAD < steps) load((s + AHEAD) % STAGES, s + AHEAD);
    cp_async_commit();
    const uint32_t a_base = s0 + (s % STAGES) * D_STAGE;
    const uint32_t b_base = a_base + D_ASTAGE;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DKP / 2; ++ks)
      wgmma_s8(acc, smem_desc(a_base + 2 * ks * D_APLANE, D_APLANE, 128),
               smem_desc(b_base + 2 * ks * D_BPLANE, D_BPLANE, 128));
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  // d[2 * half + e]: output o0 + 16 * warp + lane / 4 + 8 * half, row b0 + 2 * (lane % 4) + e
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = o0 + warp * 16 + (lane >> 2) + half * 8, b = b0 + (lane & 3) * 2 + e;
      if (o < Dout && b < B) ws[((int64_t)split * B + b) * Dout + o] = acc[2 * half + e];
    }
}

// dense_q8's fold: the partials of each (row, output) summed, then finished
__global__ void dense_q8_finish(const int32_t* __restrict__ ws, void* __restrict__ out, const float* __restrict__ bias,
                                const float* __restrict__ scale, int B, int Dout, int splits, int mode) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n = (int64_t)B * Dout;
  if (i >= n) return;
  int acc = 0;
  for (int s = 0; s < splits; ++s) acc += ws[s * n + i];
  const int b = (int)(i / Dout), o = (int)(i - (int64_t)b * Dout);
  const float s = mode == RAW ? 1.f : scale[b];
  reinterpret_cast<uint32_t*>(out)[i] = finish(acc, mode, mode == RAW ? 0 : fold(bias[o], s), s);
}

// quantize_rows_q8: 16 elements a thread (one row: L % 16 == 0) with 16-byte
// accesses where `vec`, else one
__global__ void quantize_rows_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                                     int8_t* __restrict__ out, int64_t n, int64_t L, int vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  if (vec) {
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n / 16; i += stride) {
      const float s = scale[i * 16 / L];
      const float4* src = reinterpret_cast<const float4*>(x) + i * 4;
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 f = __ldg(src + q);
        v[q] = (uint32_t)(uint8_t)quantize(f.x, s) | (uint32_t)(uint8_t)quantize(f.y, s) << 8 |
               (uint32_t)(uint8_t)quantize(f.z, s) << 16 | (uint32_t)(uint8_t)quantize(f.w, s) << 24;
      }
      reinterpret_cast<uint4*>(out)[i] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
      out[i] = quantize(x[i], scale[i / L]);
  }
}

// quantize_t_q8: out[c][r] = q(w[r][c]), a 64 x 64 tile a block through
// shared memory; 16-byte stores along r where the tile is whole and aligned
constexpr int TT = 64, TT_PAD = TT + 16;
__global__ void __launch_bounds__(256) quantize_t_kernel(const float* __restrict__ w, const float* __restrict__ scale,
                                                         int8_t* __restrict__ out, int R, int C) {
  __shared__ __align__(16) int8_t t[TT][TT_PAD];  // [c][r]
  const int c0 = blockIdx.x * TT, r0 = blockIdx.y * TT;
  const int tid = threadIdx.x;
  const float s = scale[0];
#pragma unroll 4
  for (int i = 0; i < TT * TT / 256; ++i) {
    const int r = i * 4 + tid / TT, c = tid % TT;
    t[c][r] = (r0 + r < R && c0 + c < C) ? quantize(__ldg(w + (int64_t)(r0 + r) * C + c0 + c), s) : (int8_t)0;
  }
  __syncthreads();
  const int c = tid / 4, part = (tid % 4) * 16;
  if (c0 + c >= C) return;
  int8_t* dst = out + (int64_t)(c0 + c) * R + r0 + part;
  if (R % 16 == 0 && r0 + part + 16 <= R && ((uintptr_t)out & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(&t[c][part]);
  } else {
    for (int e = 0; e < 16; ++e)
      if (r0 + part + e < R) dst[e] = t[c][part + e];
  }
}

bool aligned(const void* p, int bytes) { return (reinterpret_cast<uintptr_t>(p) % bytes) == 0; }

template <int BN>
int launch_ring(const Conv& p, cudaStream_t st) {
  const int tiles_n = (p.Cout + BN - 1) / BN;
  const int64_t blocks = (p.M + BM - 1) / BM * tiles_n;
  if (blocks >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  auto kernel = conv_q8_ring<BN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<BN>::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, THREADS, Ring<BN>::SMEM, st>>>(p, tiles_n);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, reached through the runtime (no link to the
// driver library): the map of a tensor of `type` (int8 by default) with
// the given swizzle, boxes past its edges zero-filled on loads and clipped
// on stores.  Nonzero where it cannot be made.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

int encode_map(CUtensorMap* map, int rank, const void* base, const cuuint64_t* dims, const cuuint64_t* strides,
               const cuuint32_t* box, const cuuint32_t* elem,
               CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE,
               CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_UINT8) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult q;
    void* fn = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess || !fn)
      return 1;
    encode = (EncodeTiled)fn;
  }
  return encode(map, type, rank, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS;
}

// The patch of 256 pixels (tr x tc: 16 x 16, 8 x 32 or 32 x 8) that pads
// the output least, 16 x 16 on a tie
template <int BN, int CK>
int64_t patch_smem(const Conv& p, int tr, int tc) {
  const int64_t hrows = (int64_t)(tr + p.KH - 1) * (tc + p.KW - 1), h_buf = (hrows * CK + 1023) / 1024 * 1024;
  const int64_t smem = 1024 + patch_stages(BN, CK) * CK * BN + 2 * h_buf + (patch_stages(BN, CK) + 2) * 8;
  const int64_t epi = 1024 + BM * BN * 4 + BN * 4;  // the staged patch and the folded bias
  return smem > epi ? smem : epi;
}

// The map of the (N, Ho, Wo, Cout) output as 4-byte elements, in boxes of
// `box` (channels, pixels, rows, images), 128B-swizzled as stage_boxes
// writes them.  Nonzero where it cannot be made.
struct Box4 {
  cuuint32_t c, x, y, n;
};
int out_map(CUtensorMap* map, const Conv& p, Box4 b) {
  const cuuint64_t dims[4] = {(cuuint64_t)p.Cout, (cuuint64_t)p.Wo, (cuuint64_t)p.Ho, (cuuint64_t)p.N};
  const cuuint64_t strides[3] = {(cuuint64_t)p.Cout * 4, (cuuint64_t)p.Wo * p.Cout * 4,
                                 (cuuint64_t)p.Ho * p.Wo * p.Cout * 4};
  const cuuint32_t box[4] = {b.c, b.x, b.y, b.n};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode_map(map, 4, p.out, dims, strides, box, ones, CU_TENSOR_MAP_SWIZZLE_128B,
                    CU_TENSOR_MAP_DATA_TYPE_UINT32);
}

// The patch of 128 pixels (8 x 16 or 16 x 8) that pads the output least,
// 8 x 16 on a tie
void patch_shape(const Conv& p, int& tr, int& tc) {
  const int64_t wide = (int64_t)((p.Ho + 7) / 8 * 8) * ((p.Wo + 15) / 16 * 16);
  const int64_t tall = (int64_t)((p.Ho + 15) / 16 * 16) * ((p.Wo + 7) / 8 * 8);
  tr = tall < wide ? 16 : 8;
  tc = 128 / tr;
}

template <int BN, int CK>
int launch_patch(const Conv& p, cudaStream_t st) {
  int tr, tc;
  patch_shape(p, tr, tc);
  const int64_t smem = patch_smem<BN, CK>(p, tr, tc);

  const int tiles_r = (p.Ho + tr - 1) / tr, tiles_c = (p.Wo + tc - 1) / tc, tiles_n = (p.Cout + BN - 1) / BN;
  const int64_t blocks = (int64_t)p.N * tiles_r * tiles_c * tiles_n;
  if (smem > 232448 || blocks >= ((int64_t)1 << 31)) return -1;  // the caller takes the ring
  const CUtensorMapSwizzle swizzle = CK == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap xmap, wmap, omap;
  {
    const cuuint64_t dims[4] = {(cuuint64_t)p.Cin, (cuuint64_t)p.W, (cuuint64_t)p.H, (cuuint64_t)p.N};
    const cuuint64_t strides[3] = {(cuuint64_t)p.Cin, (cuuint64_t)p.W * p.Cin, (cuuint64_t)p.H * p.W * p.Cin};
    const cuuint32_t box[4] = {(cuuint32_t)CK, (cuuint32_t)(tc + p.KW - 1), (cuuint32_t)(tr + p.KH - 1), 1};
    const cuuint32_t ones[4] = {1, 1, 1, 1};
    if (encode_map(&xmap, 4, p.x, dims, strides, box, ones, swizzle)) return -1;
  }
  {
    const cuuint64_t dims[2] = {(cuuint64_t)p.K, (cuuint64_t)p.Cout};
    const cuuint64_t strides[1] = {(cuuint64_t)p.K};
    const cuuint32_t box[2] = {(cuuint32_t)CK, (cuuint32_t)BN};
    const cuuint32_t ones[2] = {1, 1};
    if (encode_map(&wmap, 2, p.w, dims, strides, box, ones, swizzle)) return -1;
  }
  if (out_map(&omap, p, {32, 8, 8, 1})) return -1;
  auto kernel = conv_q8_patch<BN, CK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, THREADS, (int)smem, st>>>(p, tr, tc, tiles_r, tiles_c, tiles_n, xmap,
                                                                       wmap, omap);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_halo(const Conv& p, cudaStream_t st) {
  using R = Ring<BN>;
  const int tiles_n = (p.Cout + BN - 1) / BN, tiles_w = (p.Wo + BM - 1) / BM;
  const int halo_cols = (BM - 1) * p.sw + p.KW;
  const int64_t halo = (int64_t)p.KH * halo_cols * p.Cin;
  int64_t smem = R::A_STAGE + R::B_STAGE + BK * 4 + halo;
  if (smem < R::TILE + BN * 4) smem = R::TILE + BN * 4;
  smem += 1024;  // room to start on a 1024-byte boundary
  Conv q = p;
  CUtensorMap omap;
  if (q.vec_out && out_map(&omap, q, {32, BM, 1, 1})) q.vec_out = 0;
  const int64_t blocks = (int64_t)p.N * p.Ho * tiles_w * tiles_n;
  if (smem > 232448 || blocks >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  auto kernel = conv_q8_halo<BN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, THREADS, (int)smem, st>>>(q, tiles_w, tiles_n, halo_cols, omap);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, H, W, Cin) int8, w (Cout, KH, KW, Cin) int8, out (N, Ho, Wo, Cout):
// int32 for mode 0 (the raw accumulator), float32 for mode 1 (linear) and
// 2 (relu), which read bias (Cout,) and scale (N,) float32; all contiguous.
// (pt, pl) the top and left padding.  Returns cudaErrorInvalidValue for a
// geometry no kernel here takes, else cudaGetLastError() after the launch.
extern "C" int conv_q8(const void* x, const void* w, void* out, const void* bias, const void* scale, int N, int H,
                       int W, int Cin, int KH, int KW, int Cout, int Ho, int Wo, int sh, int sw, int pt, int pl,
                       int mode, void* stream) {
  Conv p{(const int8_t*)x, (const int8_t*)w, out, (const float*)bias, (const float*)scale,
         N, H, W, Cin, KH, KW, Cout, Ho, Wo, sh, sw, pt, pl, KH * KW * Cin, (int64_t)N * Ho * Wo, mode, 0};
  if (N < 0 || H < 0 || W < 0 || Cin <= 0 || KH <= 0 || KW <= 0 || Cout <= 0 || Ho < 0 || Wo < 0 || sh <= 0 ||
      sw <= 0 || mode < RAW || mode > RELU || (mode != RAW && (!bias || !scale)) ||
      (int64_t)KH * KW * Cin >= ((int64_t)1 << 31) || (int64_t)Cout * KH * KW * Cin >= ((int64_t)1 << 31) ||
      (int64_t)N * H * W * Cin >= ((int64_t)1 << 40) || p.M * Cout >= ((int64_t)1 << 40))
    return (int)cudaErrorInvalidValue;
  if (p.M == 0) return 0;
  p.vec_out = Cout % 4 == 0 && aligned(out, 16);
  const cudaStream_t st = (cudaStream_t)stream;
  const bool vec = Cin % 16 == 0 && aligned(x, 16) && aligned(w, 16);
  if (vec && p.vec_out && sh == 1 && sw == 1 && KH * KW > AHEAD) {
    // BN 64 where BN 128 would leave SMs idle (14 x 14 at batch 8)
    int tr, tc;
    patch_shape(p, tr, tc);
    const bool narrow = Cout <= 64 || (int64_t)N * ((Ho + tr - 1) / tr) * ((Wo + tc - 1) / tc) * ((Cout + 127) / 128) < 132;
    const bool wide = Cin % 128 == 0;
    const int rc = narrow ? (wide ? launch_patch<64, 128>(p, st) : launch_patch<64, 64>(p, st))
                          : (wide ? launch_patch<128, 128>(p, st) : launch_patch<128, 64>(p, st));
    if (rc >= 0) return rc;
  }
  if (vec) return Cout <= 64 ? launch_ring<64>(p, st) : launch_ring<128>(p, st);
  return Cout <= 64 ? launch_halo<64>(p, st) : launch_halo<128>(p, st);
}

// x (B, Din) int8, w (Dout, Din) int8 (K-major), out (B, Dout) as conv_q8's
// modes; ws (splits, B, Dout) int32 scratch.  Din % 16 == 0, kper a
// multiple of 256 with splits * kper >= Din > (splits - 1) * kper, operands
// 16-byte aligned.  Two launches: the GEMV's partials, then their fold.
extern "C" int dense_q8(const void* x, const void* w, void* out, const void* bias, const void* scale, void* ws, int B,
                        int Din, int Dout, int splits, int kper, int mode, void* stream) {
  if (B < 0 || Din <= 0 || Dout <= 0 || Din % 16 || kper <= 0 || kper % DBK || splits <= 0 || splits > 65535 ||
      (int64_t)splits * kper < Din || (int64_t)(splits - 1) * kper >= Din || mode < RAW || mode > RELU ||
      (mode != RAW && (!bias || !scale)) || !aligned(x, 16) || !aligned(w, 16) ||
      (int64_t)Dout * Din >= ((int64_t)1 << 40) || (int64_t)splits * B * Dout >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((Dout + DBM - 1) / DBM, splits, (B + DROWS - 1) / DROWS);
  if (grid.z > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(dense_q8_gemv, cudaFuncAttributeMaxDynamicSharedMemorySize, D_SMEM);
  if (err != cudaSuccess) return (int)err;
  dense_q8_gemv<<<grid, DTHREADS, D_SMEM, st>>>((const int8_t*)x, (const int8_t*)w, (int32_t*)ws, B, Din, Dout, kper);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)B * Dout;
  dense_q8_finish<<<(unsigned)((n + 255) / 256), 256, 0, st>>>((const int32_t*)ws, out, (const float*)bias,
                                                              (const float*)scale, B, Dout, splits, mode);
  return (int)cudaGetLastError();
}

// x (rows, L) float32 -> out int8 at scale[row], contiguous.
extern "C" int quantize_rows_q8(const void* x, const void* scale, void* out, long long rows, long long L,
                                void* stream) {
  if (rows < 0 || L < 0) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)rows * L;
  if (n == 0) return 0;
  const int vec = L % 16 == 0 && aligned(x, 16) && aligned(out, 16);
  const int64_t work = vec ? n / 16 : n;
  const int64_t blocks = (work + 255) / 256;
  quantize_rows_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)scale, (int8_t*)out, n, L, vec);
  return (int)cudaGetLastError();
}

// w (R, C) float32 -> out (C, R) int8 at scale[0], contiguous.
extern "C" int quantize_t_q8(const void* w, const void* scale, void* out, int R, int C, void* stream) {
  if (R < 0 || C < 0) return (int)cudaErrorInvalidValue;
  if (R == 0 || C == 0) return 0;
  const dim3 grid((C + TT - 1) / TT, (R + TT - 1) / TT);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  quantize_t_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>((const float*)w, (const float*)scale, (int8_t*)out, R, C);
  return (int)cudaGetLastError();
}
