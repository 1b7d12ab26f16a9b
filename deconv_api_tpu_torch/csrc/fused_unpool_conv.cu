// Switch unpool (+ backward ReLU) fused into the flipped-kernel SAME
// stride-1 convolution of the deconvnet backward pass, NHWC, for sm_90a.
//
// Replaces: deconv_api_tpu/ops/pallas_deconv.py:_mxu_kernel (entry
// fused_pallas_call(impl="mxu") via fused_unpool_backward), the TPU kernel
// that scatters a pooled tile through its switches in VMEM and feeds the
// flipped conv's input formation, so the 2x-spatial unpooled tensor never
// reaches device memory.
//
// Bound on the H100: operations.  Each output pixel reduces kh*kw*Cout
// products per input channel: at VGG16 batch 8, top-4 the four fused
// sites are 4 x 32 x 3.70 GFLOP, about 474 GFLOP, 0.48 ms at 989 TFLOP/s
// dense bf16 on the tensor cores; one packed block1 site at batch 8, top-8
// (groups 8) is 236.7 GFLOP, 0.24 ms.
//
// Both kernels are an implicit GEMM, M = output pixels x packed groups
// (n, r, c, g), N = Cin, reduction = kh*kw*Cout.  Row m of the GEMM stores
// to out[m*Cin + ci], which is out[n, r, c, g*Cin + ci].  The value at
// unpooled (R, C) of group g and channel co is
//   relu?(y[n, R/ph, C/pw, g*Cout + co]) where
//   idx[n/rep, R/ph, C/pw, co] equals the slot (R%ph)*pw + C%pw, else 0,
// and 0 outside the image (SAME).  B is the flipped kernel, tap (dy, dx)
// of which is w[kh-1-dy, kw-1-dx] transposed, shared by every group.  The
// unpooled tensor exists only as shared-memory tiles.  Groups (`groups` >
// 1) are the channel-packed ("kpack") tail of
// deconv_api_tpu/engine/deconv.py, where the TPU kernel folds the packed
// groups into the GEMM's M (_mxu_kernel) and broadcasts the switches across
// them (_scatter_block).
//
// bf16, fused_unpool_conv_mma: bf16 operands on the tensor cores (wgmma,
// both operands from shared memory), fp32 accumulation.  A block owns a
// patch of tr x tc output pixels of one group (256 GEMM rows, one 8 x 8
// sub-patch per 64 rows) and BN = 64 or 128 input channels.  For each
// 64-wide Cout chunk it copies the pooled rectangle under the patch and its
// (kh/2, kw/2) halo, signal and switches, into shared memory (cp.async, 16
// and 8 bytes), and forms from it, once, the unpooled halo tile: switch
// select and ReLU on registers, one 16-byte store per 8 channels.  Tiles
// are kept as 16-byte k-planes (8 channels of every row, rows 16 bytes
// apart), so the A operand of every kernel tap is a wgmma descriptor into
// the halo tile, shifted by the tap, with no further gather: the kh*kw
// shifted matmuls the TPU kernel runs from one VMEM tile.  B, w read
// K-major with the taps reversed, streams through a 4-stage cp.async ring
// one (chunk, tap) slice per stage, requested two steps ahead; each step's
// wgmma is left running while the next step is issued, and the next
// chunk's halo tile is formed into a second buffer beside it.  The epilogue
// rounds to bf16 through a swizzled shared tile and stores 16 bytes per
// thread.  Channel counts that are not multiples of 8 (or misaligned
// pointers) take the same tiling with masked scalar loads and stores.  The
// wrapper (ops/cuda_deconv.py:tile_plan) picks the patch and BN; a site
// whose tiles do not fit in shared memory (kernels wider than 7 taps at
// BN 128) runs the CUDA-core kernel below.  The register file holds one
// 256 x 128 fp32 accumulator per SM, so every block streams its own copy
// of B from L2, and each warpgroup's wgmma reads its own copy of the B
// slice from shared memory: shared-memory traffic, the weight stream, the
// halo formation and the per-step barrier, not the tensor cores, bound
// this kernel today (PERF.md).
//
// fp32, fused_unpool_conv_simt: CUDA-core FMAs, never TF32.  A block owns
// 128 consecutive GEMM rows x 64 channels; for each tap and 16-wide Cout
// chunk it gathers A through the switches and B (the flipped kernel (kh,
// kw, Cout, Cin), which the wrapper computes, ops/conv.py:flip_kernel) into
// shared memory, and each of 256 threads accumulates an 8 x 4 sub-tile in
// fp32 registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// --- CUDA-core kernel (fp32; bf16 sites the tensor-core tiling cannot hold)

namespace simt {

constexpr int BM = 128;  // GEMM rows (pixel, group) per block
constexpr int BN = 64;   // input channels (GEMM N) per block
constexpr int BK = 16;   // Cout chunk per shared-memory stage
constexpr int TM = 8;    // rows per thread
constexpr int TN = 4;    // channels per thread
constexpr int NT = 256;  // threads per block: (BM/TM) x (BN/TN)
constexpr int A_ROWS = NT / BK;  // rows one A-loading pass covers
constexpr int B_ROWS = NT / BN;  // Cout rows one B-loading pass covers
constexpr int APAD = 4;  // keeps A stores off one bank, float4 reads aligned

}  // namespace simt

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, bool RELU>
__global__ void __launch_bounds__(simt::NT, 2)
fused_unpool_conv_simt(const T* __restrict__ y, const int8_t* __restrict__ idx,
                       const T* __restrict__ fk, T* __restrict__ out, int N, int Ho, int Wo,
                       int Cout, int Cin, int ph, int pw, int kh, int kw, int rep, int groups) {
  using namespace simt;
  __shared__ __align__(16) float As[BK][BM + APAD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int H = Ho * ph, W = Wo * pw;
  const int HW = H * W;
  const int M = N * HW * groups;
  const int Cy = groups * Cout;  // signal channels
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  // A loader: Cout lane a_k, pixels a_m + A_ROWS*i
  const int a_k = tid % BK;
  const int a_m = tid / BK;
  // B loader: Cin lane b_n, Cout rows b_k + B_ROWS*i
  const int b_n = tid % BN;
  const int b_k = tid / BN;
  // compute: channels tx*TN.., pixels ty*TM..
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int dy = 0; dy < kh; ++dy) {
    for (int dx = 0; dx < kw; ++dx) {
      // per-tap source of the pixels this thread loads: offset of the
      // pooled element in y (the switch offset follows), and its slot;
      // slot -1 marks SAME padding or a pixel past the end
      int ysrc[BM / A_ROWS], isrc[BM / A_ROWS], slot[BM / A_ROWS];
#pragma unroll
      for (int i = 0; i < BM / A_ROWS; ++i) {
        const int m = m0 + a_m + A_ROWS * i;
        slot[i] = -1;
        ysrc[i] = 0;
        isrc[i] = 0;
        if (m < M) {
          const int p = m / groups;  // pixel (n, r, c)
          const int g = m - p * groups;
          const int n = p / HW;
          const int rem = p - n * HW;
          const int R = rem / W + dy - kh / 2;
          const int Cc = rem % W + dx - kw / 2;
          if (R >= 0 && R < H && Cc >= 0 && Cc < W) {
            const int pr = R / ph, pc = Cc / pw;
            slot[i] = (R - pr * ph) * pw + (Cc - pc * pw);
            ysrc[i] = ((n * Ho + pr) * Wo + pc) * Cy + g * Cout;
            isrc[i] = (((n / rep) * Ho + pr) * Wo + pc) * Cout;
          }
        }
      }
      const T* fk_tap = fk + (int64_t)(dy * kw + dx) * Cout * Cin;

      for (int co0 = 0; co0 < Cout; co0 += BK) {
        const int co = co0 + a_k;
#pragma unroll
        for (int i = 0; i < BM / A_ROWS; ++i) {
          float v = 0.f;
          if (slot[i] >= 0 && co < Cout && idx[isrc[i] + co] == slot[i]) {
            v = to_f32(y[ysrc[i] + co]);
            if (RELU) v = fmaxf(v, 0.f);
          }
          As[a_k][a_m + A_ROWS * i] = v;
        }
#pragma unroll
        for (int i = 0; i < BK / B_ROWS; ++i) {
          const int kk = b_k + B_ROWS * i;
          const int c_out = co0 + kk, c_in = n0 + b_n;
          Bs[kk][b_n] =
              (c_out < Cout && c_in < Cin) ? to_f32(fk_tap[(int64_t)c_out * Cin + c_in]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
          const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
          const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
          const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c_in = n0 + tx * TN + j;
      if (c_in < Cin) out[(int64_t)m * Cin + c_in] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch_simt(const void* y, const void* idx, const void* fk, void* out, int N, int Ho, int Wo,
                int Cout, int Cin, int ph, int pw, int kh, int kw, int rep, int groups, int relu,
                cudaStream_t stream) {
  const int64_t M = (int64_t)N * Ho * ph * Wo * pw * groups;
  const dim3 grid((unsigned)((M + simt::BM - 1) / simt::BM),
                  (unsigned)((Cin + simt::BN - 1) / simt::BN));
  auto kernel = relu ? fused_unpool_conv_simt<T, true> : fused_unpool_conv_simt<T, false>;
  kernel<<<grid, simt::NT, 0, stream>>>((const T*)y, (const int8_t*)idx, (const T*)fk, (T*)out, N,
                                        Ho, Wo, Cout, Cin, ph, pw, kh, kw, rep, groups);
  return (int)cudaGetLastError();
}

// --- tensor-core kernel (bf16) ----------------------------------------------

namespace tcore {

constexpr int BK = 64;      // Cout chunk: one halo tile; one B ring stage per tap
constexpr int KC = BK / 8;  // 16-byte k-planes of a tile
constexpr int BM = 256;     // GEMM rows per block: four 8 x 8 pixel sub-patches
constexpr int SUB = 8;      // a sub-patch is 8 x 8 pixels, the 64 rows of one wgmma
constexpr int STAGES = 4;   // B ring depth, in (chunk, tap) steps
constexpr int AHEAD = STAGES - 2;  // steps a B slice is requested ahead

struct Params {
  const __nv_bfloat16* y;
  const int8_t* idx;
  const __nv_bfloat16* w;  // the unflipped forward kernel (kh, kw, Cin, Cout)
  __nv_bfloat16* out;
  int Ho, Wo, H, W, Cout, Cin, ph, pw, kh, kw, rep, groups;
  int tr, tc;      // patch of tr x tc pixels (BM GEMM rows) of one group
  int hc, hrows;   // halo tile: (tr + kh - 1) x (tc + kw - 1) pixels
  int prh, pcw;    // pooled rectangle under the halo tile
  int tiles_r, tiles_c, tiles_n;
  int relu, vec;   // vec: 16-byte global accesses (channels and pointers aligned)
};

// Shared-memory layout in bytes.  Every tile is stored as 16-byte k-planes:
// plane kc holds channels [8kc, 8kc + 8) of each row, rows 16 bytes apart.
// Eight consecutive rows of a plane are one wgmma core matrix, so a
// warpgroup's A operand at any tap is a descriptor into the halo tile:
// its 8-row groups (sub-patch rows) hc rows apart, its two k-planes one
// plane apart.  A plane is padded by 16 bytes so the 8 planes of one row
// fall in 8 bank groups.  ops/cuda_deconv.py:_smem_bytes computes the same
// total.
struct Layout {
  int b_plane, b_stage, a_plane, a_buf, ry_plane, ri_plane;
  int a_off, ry_off, ri_off, meta_off, total;
};

__host__ __device__ inline Layout layout(int bn, int hrows, int pooled_px, int halo_bufs) {
  Layout L;
  L.b_plane = bn * 16 + 16;
  L.b_stage = KC * L.b_plane;
  L.a_plane = hrows * 16 + 16;
  L.a_buf = KC * L.a_plane;
  L.ry_plane = pooled_px * 16 + 16;
  L.ri_plane = (pooled_px * 8 + 15) / 16 * 16 + 16;
  L.a_off = STAGES * L.b_stage;
  L.ry_off = L.a_off + halo_bufs * L.a_buf;
  L.ri_off = L.ry_off + KC * L.ry_plane;
  L.meta_off = L.ri_off + KC * L.ri_plane;
  L.total = L.meta_off + (hrows * 4 + 15) / 16 * 16;
  if (L.total < BM * bn * 2) L.total = BM * bn * 2;  // the epilogue's output tile
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wgmma (sm_90a): D[64 x N] += A[64 x 16] B[16 x N], both operands from
// shared memory through descriptors, fp32 D (the accumulator layout of
// mma.m16n8k16 per warp: warp w of the warpgroup holds rows 16w..16w+15).
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across the async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// orders this thread's generic-proxy shared-memory writes (stores and
// cp.async) before the async proxy's (wgmma's) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory matrix descriptor of a K-major tile without swizzle: core
// matrices of 8 rows x 16 bytes (rows 16 bytes apart), `lbo` bytes between
// the two core matrices of a 16-deep k slice, `sbo` bytes between groups of
// 8 rows.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)((lbo & 0x3ffff) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3ffff) >> 4) << 32);
}

__device__ __forceinline__ int floor_div(int a, int b) { return a >= 0 ? a / b : -((b - 1 - a) / b); }

// Byte offset of 16-byte chunk `ch` of row `k` in the epilogue's tile of
// `row_bytes`-byte rows (a multiple of 128): the chunk index is XORed with
// k % 8, so the accumulator stores of 8 rows hit 8 bank groups.
__device__ __forceinline__ uint32_t tile_off(int k, int ch, int row_bytes) {
  return (uint32_t)(k * row_bytes + ((ch ^ (k & 7)) << 4));
}

// The switch select (and ReLU) of 8 bf16 channels: keep y where the switch
// byte equals `slot`, else 0.
__device__ __forceinline__ uint4 unpool8(uint4 yv, uint2 iv, uint32_t slot, bool relu) {
  uint32_t w[4] = {yv.x, yv.y, yv.z, yv.w};
  const uint32_t ib[2] = {iv.x, iv.y};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t b = ib[q >> 1] >> ((q & 1) * 16);
    const uint32_t lo = (b & 0xffu) == slot ? 0x0000ffffu : 0u;
    const uint32_t hi = ((b >> 8) & 0xffu) == slot ? 0xffff0000u : 0u;
    uint32_t v = w[q] & (lo | hi);
    if (relu) v &= ~(((v >> 15) & 0x00010001u) * 0xffffu);  // negative halves -> 0
    w[q] = v;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

}  // namespace tcore

// BM GEMM rows (four 8 x 8 pixel sub-patches) x BN channels per block; a
// ring of STAGES (chunk, tap) B slices, loaded AHEAD steps ahead, so one
// step's wgmma runs while the next is issued.  Two halo buffers when Cout
// spans more than one chunk, else one.  At BN 128 each of four warpgroups
// owns a sub-patch (a 64 x 128 fp32 accumulator, half the register file);
// at BN 64 each of two owns two, so 256 threads hold the same rows and two
// blocks share an SM, one's prologue running beside the other's products.
template <int BN>
__global__ void __launch_bounds__(BN == 128 ? 512 : 256, BN == 128 ? 1 : 2)
    fused_unpool_conv_mma(const tcore::Params p) {
  using namespace tcore;
  constexpr int SUBS = BN == 128 ? 1 : 2;  // sub-patches per warpgroup
  constexpr int NT = 2 * BM / SUBS;
  constexpr int B_PLANE = BN * 16 + 16;
  static_assert((BN * KC) % NT == 0 && AHEAD >= 1, "B loader");

  extern __shared__ __align__(128) uint8_t smem[];
  const Layout L = layout(BN, p.hrows, p.prh * p.pcw, p.Cout > BK ? 2 : 1);
  const uint32_t s0 = smem_u32(smem);
  int* const meta = reinterpret_cast<int*>(smem + L.meta_off);

  int bid = blockIdx.x;
  const int nt = bid % p.tiles_n;
  bid /= p.tiles_n;
  const int ct = bid % p.tiles_c;
  bid /= p.tiles_c;
  const int rt = bid % p.tiles_r;
  bid /= p.tiles_r;
  const int g = bid % p.groups, n = bid / p.groups;
  const int r0 = rt * p.tr, c0 = ct * p.tc, n0 = nt * BN;
  const int R0 = r0 - p.kh / 2, C0 = c0 - p.kw / 2;  // halo origin, unpooled
  const int PR0 = floor_div(R0, p.ph), PC0 = floor_div(C0, p.pw);  // pooled rectangle origin
  const int Cy = p.groups * p.Cout;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int sub_cols = p.tc / SUB;

  // each halo pixel's place in the pooled rectangle and its slot, or -1
  // for SAME padding and pixels past the image
  for (int h = tid; h < p.hrows; h += NT) {
    const int R = R0 + h / p.hc, C = C0 + h % p.hc;
    int m = -1;
    if (R >= 0 && R < p.H && C >= 0 && C < p.W) {
      const int pr = R / p.ph, pc = C / p.pw;
      const int px = (pr - PR0) * p.pcw + (pc - PC0);
      m = px << 8 | (((R - pr * p.ph) * p.pw + (C - pc * p.pw)) & 0xff);
    }
    meta[h] = m;
  }

  // the pooled rectangle of Cout channels [co0, co0 + BK): group g's signal
  // and the switches, as k-planes (cp.async on the vector path)
  auto load_pooled = [&](int co0) {
    const int npx = p.prh * p.pcw;
    const int nb = n / p.rep;
    for (int i = tid; i < npx * KC; i += NT) {
      const int kc = i % KC, px = i / KC;
      const int pr = PR0 + px / p.pcw, pc = PC0 + px % p.pcw, co = co0 + kc * 8;
      if (pr < 0 || pr >= p.Ho || pc < 0 || pc >= p.Wo || co >= p.Cout) continue;
      const __nv_bfloat16* ys =
          p.y + ((int64_t)(n * p.Ho + pr) * p.Wo + pc) * Cy + g * p.Cout + co;
      const int8_t* is = p.idx + ((int64_t)(nb * p.Ho + pr) * p.Wo + pc) * p.Cout + co;
      uint8_t* yd = smem + L.ry_off + kc * L.ry_plane + px * 16;
      uint8_t* id = smem + L.ri_off + kc * L.ri_plane + px * 8;
      if (p.vec) {
        cp_async16(smem_u32(yd), ys, 16);
        cp_async8(smem_u32(id), is);
      } else {
        uint32_t yw[4] = {0u, 0u, 0u, 0u}, iw[2] = {0xffffffffu, 0xffffffffu};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (co + e < p.Cout) {
            yw[e >> 1] |= (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(ys) + e)
                          << ((e & 1) * 16);
            iw[e >> 2] = (iw[e >> 2] & ~(0xffu << ((e & 3) * 8))) |
                         ((uint32_t)(uint8_t)__ldg(is + e) << ((e & 3) * 8));
          }
        *reinterpret_cast<uint4*>(yd) = make_uint4(yw[0], yw[1], yw[2], yw[3]);
        *reinterpret_cast<uint2*>(id) = make_uint2(iw[0], iw[1]);
      }
    }
  };

  // the unpooled halo tile of chunk co0 from the pooled rectangle: every
  // tap's A operand is a view of it
  auto form_halo = [&](int buf, int co0) {
    uint8_t* const a = smem + L.a_off + buf * L.a_buf;
    for (int i = tid; i < p.hrows * KC; i += NT) {
      const int kc = i / p.hrows, h = i - kc * p.hrows;
      const int m = meta[h];
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m >= 0 && co0 + kc * 8 < p.Cout) {
        const int px = m >> 8;
        v = unpool8(*reinterpret_cast<const uint4*>(smem + L.ry_off + kc * L.ry_plane + px * 16),
                    *reinterpret_cast<const uint2*>(smem + L.ri_off + kc * L.ri_plane + px * 8),
                    (uint32_t)(m & 0xff), p.relu != 0);
      }
      *reinterpret_cast<uint4*>(a + kc * L.a_plane + h * 16) = v;
    }
  };

  // B of step (chunk, tap): the flipped kernel's tap, which is w's tap
  // T-1-tap, rows n0 + [0, BN) (Cin), columns chunk*BK + [0, BK) (Cout), as
  // K-major k-planes, zero past Cin or Cout
  const int T = p.kh * p.kw;
  const int b_kc = tid % KC;
  auto load_b = [&](int stage, int chunk, int tap) {
    const int co = chunk * BK + b_kc * 8;
    const __nv_bfloat16* base = p.w + ((int64_t)(T - 1 - tap) * p.Cin + n0) * p.Cout + co;
    uint8_t* const dst = smem + stage * L.b_stage + b_kc * B_PLANE;
#pragma unroll
    for (int j = 0; j < BN * KC / NT; ++j) {
      const int nn = j * (NT / KC) + tid / KC;
      const bool ok = co < p.Cout && n0 + nn < p.Cin;
      if (p.vec) {
        cp_async16(smem_u32(dst + nn * 16), ok ? base + (int64_t)nn * p.Cout : p.w, ok ? 16 : 0);
      } else {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (ok) {
          const unsigned short* src =
              reinterpret_cast<const unsigned short*>(base + (int64_t)nn * p.Cout);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (co + e < p.Cout) v[e >> 1] |= (uint32_t)__ldg(src + e) << ((e & 1) * 16);
        }
        *reinterpret_cast<uint4*>(dst + nn * 16) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  };

  float acc[SUBS][BN / 2];
#pragma unroll
  for (int j = 0; j < SUBS; ++j)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[j][i] = 0.f;

  const int nchunks = (p.Cout + BK - 1) / BK;
  const int steps = nchunks * T;
  // the tap at which a chunk forms the next chunk's halo tile, beside the
  // wgmma in flight: the pooled rectangle, requested at tap 0, has landed
  // by then, and the wgmma of the chunk before, the other buffer's last
  // reader, is done
  const int form_tap = T - 1 < AHEAD ? T - 1 : AHEAD;

  load_pooled(0);
  cp_async_commit();
  int l_chunk = 0, l_tap = 0;  // step that load_b fetches next
  for (int s = 0; s < AHEAD; ++s) {
    if (s < steps) {
      load_b(s, l_chunk, l_tap);
      if (++l_tap == T) l_tap = 0, ++l_chunk;
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
  form_halo(0, 0);

  uint32_t a_sub[SUBS];  // each sub-patch's first halo row at tap (0, 0), bytes
#pragma unroll
  for (int j = 0; j < SUBS; ++j) {
    const int sub = wg * SUBS + j;
    a_sub[j] = ((sub / sub_cols) * SUB * p.hc + (sub % sub_cols) * SUB) * 16;
  }
  int chunk = 0, tap = 0, dy = 0, dx = 0;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();  // B of step s and the chunk's halo tile are in; wgmma of step s-2 is done
    if (s + AHEAD < steps) {
      load_b((s + AHEAD) % STAGES, l_chunk, l_tap);
      if (++l_tap == T) l_tap = 0, ++l_chunk;
    }
    if (tap == 0 && chunk + 1 < nchunks) load_pooled((chunk + 1) * BK);
    cp_async_commit();

    const uint32_t a_base = s0 + L.a_off + (chunk & 1) * L.a_buf + (dy * p.hc + dx) * 16;
    const uint32_t b_base = s0 + (s % STAGES) * L.b_stage;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KC / 2; ++ks) {
      const uint64_t db = smem_desc(b_base + 2 * ks * B_PLANE, B_PLANE, 128);
#pragma unroll
      for (int j = 0; j < SUBS; ++j) {
        const uint64_t da = smem_desc(a_base + a_sub[j] + 2 * ks * L.a_plane, L.a_plane, p.hc * 16);
        if constexpr (BN == 128)
          wgmma_n128(acc[j], da, db);
        else
          wgmma_n64(acc[j], da, db);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // step s-1's products are done; step s's run on

    if (tap == form_tap && chunk + 1 < nchunks) {
      if (form_tap < AHEAD) {  // short kernels: wait for everything here
        wgmma_wait<0>();
        cp_async_wait<0>();
        __syncthreads();
      }
      form_halo((chunk + 1) & 1, (chunk + 1) * BK);
    }
    if (++dx == p.kw) {
      dx = 0;
      if (++dy == p.kh) dy = 0;
    }
    if (++tap == T) tap = 0, ++chunk;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < SUBS; ++j) fence_regs(acc[j]);

  // epilogue: bf16 through a swizzled BM x BN shared tile, 16-byte stores.
  // Row 64 sub + 8 i + j of the block is pixel (i, j) of sub-patch sub.
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int sj = 0; sj < SUBS; ++sj)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = (wg * SUBS + sj) * 64 + (warp & 3) * 16 + (lane >> 2) + half * 8;
        const int col = j * 8 + (lane & 3) * 2;
        *reinterpret_cast<__nv_bfloat162*>(smem + tile_off(row, col >> 3, BN * 2) + (col & 7) * 2) =
            __floats2bfloat162_rn(acc[sj][4 * j + 2 * half], acc[sj][4 * j + 2 * half + 1]);
      }
  __syncthreads();
  constexpr int OUT_CHUNKS = BN / 8;
#pragma unroll
  for (int j0 = 0; j0 < BM * OUT_CHUNKS; j0 += NT) {
    const int j = j0 + tid;
    const int row = j / OUT_CHUNKS, ch = j % OUT_CHUNKS;
    const int rw = row >> 6, r64 = row & 63;
    const int r = r0 + (rw / sub_cols) * SUB + (r64 >> 3);
    const int c = c0 + (rw % sub_cols) * SUB + (r64 & 7);
    const int ci = n0 + ch * 8;
    if (r >= p.H || c >= p.W || ci >= p.Cin) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(smem + tile_off(row, ch, BN * 2));
    __nv_bfloat16* dst = p.out + ((((int64_t)n * p.H + r) * p.W + c) * p.groups + g) * p.Cin + ci;
    if (p.vec) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (ci + e < p.Cin)
          reinterpret_cast<unsigned short*>(dst)[e] = (unsigned short)(w[e >> 1] >> ((e & 1) * 16));
    }
  }
}

template <int BN>
int launch_mma(const tcore::Params& p, int64_t blocks, cudaStream_t stream) {
  auto kernel = fused_unpool_conv_mma<BN>;
  const int smem = tcore::layout(BN, p.hrows, p.prh * p.pcw, p.Cout > tcore::BK ? 2 : 1).total;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, BN == 128 ? 512 : 256, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_unpool_conv_f32(const void* y, const void* idx, const void* fk, void* out,
                                     int N, int Ho, int Wo, int Cout, int Cin, int ph, int pw,
                                     int kh, int kw, int rep, int groups, int relu, void* stream) {
  if ((int64_t)N * Ho * Wo * groups == 0 || Cin == 0) return 0;
  return launch_simt<float>(y, idx, fk, out, N, Ho, Wo, Cout, Cin, ph, pw, kh, kw, rep, groups,
                            relu, (cudaStream_t)stream);
}

// `w` is the flipped kernel (kh, kw, Cout, Cin) for the CUDA-core kernel
// (tile_r == 0), and the unflipped forward kernel (kh, kw, Cin, Cout) for
// the tensor-core kernel, which reads it K-major with the taps reversed.
// The launch plan (ops/cuda_deconv.py:tile_plan): a patch of tile_r x
// tile_c pixels of one group (multiples of 8, 256 GEMM rows) and bn
// channels per block.
extern "C" int fused_unpool_conv_bf16(const void* y, const void* idx, const void* w, void* out,
                                      int N, int Ho, int Wo, int Cout, int Cin, int ph, int pw,
                                      int kh, int kw, int rep, int groups, int relu, void* stream,
                                      int tile_r, int tile_c, int bn) {
  if ((int64_t)N * Ho * Wo * groups == 0 || Cin == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tile_r == 0)
    return launch_simt<__nv_bfloat16>(y, idx, w, out, N, Ho, Wo, Cout, Cin, ph, pw, kh, kw, rep,
                                      groups, relu, st);
  if (tile_r * tile_c != tcore::BM || tile_r % tcore::SUB || tile_c % tcore::SUB ||
      (bn != 64 && bn != 128))
    return (int)cudaErrorInvalidValue;
  tcore::Params p;
  p.y = (const __nv_bfloat16*)y;
  p.idx = (const int8_t*)idx;
  p.w = (const __nv_bfloat16*)w;
  p.out = (__nv_bfloat16*)out;
  p.Ho = Ho, p.Wo = Wo, p.H = Ho * ph, p.W = Wo * pw;
  p.Cout = Cout, p.Cin = Cin, p.ph = ph, p.pw = pw, p.kh = kh, p.kw = kw;
  p.rep = rep, p.groups = groups;
  p.tr = tile_r, p.tc = tile_c;
  p.hc = tile_c + kw - 1;
  p.hrows = (tile_r + kh - 1) * p.hc;
  p.prh = (tile_r + kh - 2 + ph - 1) / ph + 1;
  p.pcw = (tile_c + kw - 2 + pw - 1) / pw + 1;
  p.tiles_r = (p.H + tile_r - 1) / tile_r;
  p.tiles_c = (p.W + tile_c - 1) / tile_c;
  p.tiles_n = (Cin + bn - 1) / bn;
  p.relu = relu;
  const bool aligned = ((uintptr_t)y % 16 == 0) && ((uintptr_t)w % 16 == 0) &&
                       ((uintptr_t)out % 16 == 0) && ((uintptr_t)idx % 8 == 0);
  p.vec = aligned && Cout % 8 == 0 && Cin % 8 == 0;
  const int64_t blocks = (int64_t)N * groups * p.tiles_r * p.tiles_c * p.tiles_n;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  return bn == 128 ? launch_mma<128>(p, blocks, st) : launch_mma<64>(p, blocks, st);
}
