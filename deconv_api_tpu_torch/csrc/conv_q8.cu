// Int8 convolution with int32 accumulation, NHWC x HWIO, for sm_90a.
//
// Replaces no Pallas kernel.  The JAX package's int8 execution tier
// (quality=int8) contracts int8 activations with int8 kernels in XLA:
// deconv_api_tpu/ops/conv.py:conv2d_q8 and deconv_api_tpu/ops/linear.py:
// dense_q8, both with preferred_element_type=int32.  Eager PyTorch on CUDA
// has no int8 convolution, and torch._int_mm takes no fewer than 17 rows,
// so the port's int8 tier runs its contractions here: every conv of the
// int8 forward, and every dense layer as a 1x1 conv over a 1x1 image.
//
// Bound on the H100: operations.  Up to block5_conv1 the VGG16 forward is
// about 13.5 GMAC an image, 108 GMAC at batch 8: some 0.11 ms at 1,979
// int8 TOPS, against about 0.1 GB of operand and result bytes.
//
// Design (simple and right first): an implicit GEMM.  Row m of the GEMM is
// output pixel (n, ho, wo), column is the output channel, and the
// reduction index k = (kh * KW + kw) * Cin + ci walks the window in HWIO
// order, so the kernel's rows are a [K][Cout] matrix as stored.  A block of
// 256 threads computes a 128 x 64 tile of the output with mma.sync
// m16n8k32 (s8 x s8 -> s32), eight warps of 32 x 32 each.  Each k step of
// 32 stages the A tile (the im2col rows, gathered from NHWC in 16-byte
// loads where Cin is a multiple of 16, else byte by byte) and the B tile
// (16-byte loads along Cout, transposed into k-contiguous rows in shared
// memory, the layout mma's "col" B operand wants) through registers: the
// next step's global loads are issued before this step's products.
// Padding, the ragged reduction (9 * Cin = 27 at Cin = 3), ragged rows and
// ragged channels are zero-filled in the kernel.  The result is the raw
// int32 accumulator: the bias fold, the activation and the dequantisation
// are the caller's, per batch row.  Integer sums are exact, so the result
// is bit-equal to any other exact contraction of the same operands.
// wgmma s8, TMA and a ring of stages are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 64, BK = 32;
constexpr int THREADS = 256;
constexpr int LDS = 48;  // shared-memory row stride in bytes: 16-aligned, conflict-free fragment loads

struct Geometry {
  int N, H, W, Cin, KH, KW, Cout, Ho, Wo, sh, sw, pt, pl;
  int K;      // KH * KW * Cin
  int64_t M;  // N * Ho * Wo
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 consecutive reduction entries k0 .. k0+15 of one output pixel's
// im2col row; zero outside the image and past K.
__device__ __forceinline__ uint4 load_a(const int8_t* __restrict__ x, const Geometry& g, bool row_ok,
                                        int n, int h0, int w0, int k0, bool vec) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (!row_ok) return v;
  if (vec) {  // Cin % 16 == 0: the 16 entries share one (kh, kw)
    if (k0 < g.K) {
      const int pos = k0 / g.Cin, ci = k0 - pos * g.Cin;
      const int kh = pos / g.KW, kw = pos - kh * g.KW;
      const int h = h0 + kh, w = w0 + kw;
      if (h >= 0 && h < g.H && w >= 0 && w < g.W)
        v = *reinterpret_cast<const uint4*>(x + ((int64_t)(n * g.H + h) * g.W + w) * g.Cin + ci);
    }
    return v;
  }
  unsigned char b[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int k = k0 + j;
    b[j] = 0;
    if (k < g.K) {
      const int pos = k / g.Cin, ci = k - pos * g.Cin;
      const int kh = pos / g.KW, kw = pos - kh * g.KW;
      const int h = h0 + kh, w = w0 + kw;
      if (h >= 0 && h < g.H && w >= 0 && w < g.W)
        b[j] = (unsigned char)x[((int64_t)(n * g.H + h) * g.W + w) * g.Cin + ci];
    }
  }
  v.x = b[0] | (b[1] << 8) | (b[2] << 16) | ((unsigned)b[3] << 24);
  v.y = b[4] | (b[5] << 8) | (b[6] << 16) | ((unsigned)b[7] << 24);
  v.z = b[8] | (b[9] << 8) | (b[10] << 16) | ((unsigned)b[11] << 24);
  v.w = b[12] | (b[13] << 8) | (b[14] << 16) | ((unsigned)b[15] << 24);
  return v;
}

// 16 consecutive output channels co0 .. co0+15 of kernel row k; zero past
// K and Cout.
__device__ __forceinline__ uint4 load_b(const int8_t* __restrict__ w, const Geometry& g, int k, int co0,
                                        bool vec) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (k >= g.K) return v;
  const int8_t* row = w + (int64_t)k * g.Cout;
  if (vec) {  // Cout % 16 == 0: the chunk is in range whole or not at all
    if (co0 < g.Cout) v = *reinterpret_cast<const uint4*>(row + co0);
    return v;
  }
  unsigned char b[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) b[j] = co0 + j < g.Cout ? (unsigned char)row[co0 + j] : 0;
  v.x = b[0] | (b[1] << 8) | (b[2] << 16) | ((unsigned)b[3] << 24);
  v.y = b[4] | (b[5] << 8) | (b[6] << 16) | ((unsigned)b[7] << 24);
  v.z = b[8] | (b[9] << 8) | (b[10] << 16) | ((unsigned)b[11] << 24);
  v.w = b[12] | (b[13] << 8) | (b[14] << 16) | ((unsigned)b[15] << 24);
  return v;
}

__global__ void __launch_bounds__(THREADS) conv_q8_kernel(const int8_t* __restrict__ x,
                                                          const int8_t* __restrict__ w,
                                                          int32_t* __restrict__ out, Geometry g,
                                                          bool vec_a, bool vec_b) {
  __shared__ __align__(16) unsigned char As[BM * LDS];  // [m][k], k contiguous
  __shared__ __align__(16) unsigned char Bs[BN * LDS];  // [n][k], k contiguous

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A loader: thread tid fills half (tid & 1) of tile row tid >> 1
  const int a_row = tid >> 1, a_half = tid & 1;
  const int64_t am = m0 + a_row;
  const bool a_ok = am < g.M;
  int an = 0, ah0 = 0, aw0 = 0;
  if (a_ok) {
    const int64_t hw = (int64_t)g.Ho * g.Wo;
    an = (int)(am / hw);
    const int rem = (int)(am - (int64_t)an * hw);
    const int ho = rem / g.Wo, wo = rem - ho * g.Wo;
    ah0 = ho * g.sh - g.pt;
    aw0 = wo * g.sw - g.pl;
  }
  // B loader: threads 0..127 fill k row tid >> 2, channels (tid & 3) * 16
  const int b_k = tid >> 2, b_c = (tid & 3) * 16;
  const bool b_on = tid < BK * BN / 16;

  // the warp's 32 x 32 sub-tile, and its lane's fragment coordinates
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int gid = lane >> 2, tig = lane & 3;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int ktiles = (g.K + BK - 1) / BK;
  uint4 ra = load_a(x, g, a_ok, an, ah0, aw0, a_half * 16, vec_a);
  uint4 rb = b_on ? load_b(w, g, b_k, n0 + b_c, vec_b) : make_uint4(0, 0, 0, 0);

  for (int kt = 0; kt < ktiles; ++kt) {
    __syncthreads();  // the previous step's fragments are read
    *reinterpret_cast<uint4*>(As + a_row * LDS + a_half * 16) = ra;
    if (b_on) {
      const unsigned words[4] = {rb.x, rb.y, rb.z, rb.w};
#pragma unroll
      for (int j = 0; j < 16; ++j) Bs[(b_c + j) * LDS + b_k] = (unsigned char)(words[j >> 2] >> (8 * (j & 3)));
    }
    __syncthreads();
    if (kt + 1 < ktiles) {  // the next step's loads fly under this step's products
      const int k_next = (kt + 1) * BK;
      ra = load_a(x, g, a_ok, an, ah0, aw0, k_next + a_half * 16, vec_a);
      if (b_on) rb = load_b(w, g, k_next + b_k, n0 + b_c, vec_b);
    }

    unsigned af[2][4], bf[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const unsigned char* r0 = As + (wm + i * 16 + gid) * LDS + tig * 4;
      const unsigned char* r8 = r0 + 8 * LDS;
      af[i][0] = *reinterpret_cast<const unsigned*>(r0);
      af[i][1] = *reinterpret_cast<const unsigned*>(r8);
      af[i][2] = *reinterpret_cast<const unsigned*>(r0 + 16);
      af[i][3] = *reinterpret_cast<const unsigned*>(r8 + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned char* c0 = Bs + (wn + j * 8 + gid) * LDS + tig * 4;
      bf[j][0] = *reinterpret_cast<const unsigned*>(c0);
      bf[j][1] = *reinterpret_cast<const unsigned*>(c0 + 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
  }

  // c0, c1: row gid, cols 2 * tig + {0, 1}; c2, c3: row gid + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t m = m0 + wm + i * 16 + gid + half * 8;
      if (m >= g.M) continue;
      int32_t* row = out + m * g.Cout;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = n0 + wn + j * 8 + tig * 2;
        if (co < g.Cout) row[co] = acc[i][j][half * 2];
        if (co + 1 < g.Cout) row[co + 1] = acc[i][j][half * 2 + 1];
      }
    }
  }
}

bool aligned(const void* p, int bytes) { return (reinterpret_cast<uintptr_t>(p) % bytes) == 0; }

}  // namespace

// x (N, H, W, Cin) int8, w (KH, KW, Cin, Cout) int8, out (N, Ho, Wo, Cout)
// int32, all contiguous; (pt, pl) the top and left padding.  Returns
// cudaErrorInvalidValue for a geometry the kernel does not take, else
// cudaGetLastError() after the launch.
extern "C" int conv_q8(const void* x, const void* w, void* out, int N, int H, int W, int Cin, int KH,
                       int KW, int Cout, int Ho, int Wo, int sh, int sw, int pt, int pl, void* stream) {
  Geometry g{N, H, W, Cin, KH, KW, Cout, Ho, Wo, sh, sw, pt, pl, KH * KW * Cin, (int64_t)N * Ho * Wo};
  if (N < 0 || H < 0 || W < 0 || Cin <= 0 || KH <= 0 || KW <= 0 || Cout <= 0 || Ho < 0 || Wo < 0 ||
      sh <= 0 || sw <= 0 || (int64_t)KH * KW * Cin >= ((int64_t)1 << 31) ||
      (int64_t)N * H * W * Cin >= ((int64_t)1 << 31) || g.M * Cout >= ((int64_t)1 << 40))
    return (int)cudaErrorInvalidValue;
  if (g.M == 0) return 0;
  const int64_t gx = (g.M + BM - 1) / BM;
  const int gy = (Cout + BN - 1) / BN;
  if (gx >= ((int64_t)1 << 31) || gy > 65535) return (int)cudaErrorInvalidValue;
  const bool vec_a = Cin % 16 == 0 && aligned(x, 16);
  const bool vec_b = Cout % 16 == 0 && aligned(w, 16);
  conv_q8_kernel<<<dim3((unsigned)gx, gy), THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (int32_t*)out, g, vec_a, vec_b);
  return (int)cudaGetLastError();
}
