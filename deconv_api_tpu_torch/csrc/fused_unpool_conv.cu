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
// Design: an implicit GEMM, M = output pixels x packed groups (n, r, c, g),
// N = Cin, reduction = kh*kw*Cout.  A block owns a 128-row x 64-channel
// output tile; for each kernel tap and 16-wide Cout chunk it stages in
// shared memory
//   A: the unpooled input, formed by gather: the value at unpooled (R, C)
//      of group g is relu?(y[n, R/ph, C/pw, g*Cout + co]) where
//      idx[n/rep, R/ph, C/pw, co] equals the slot (R%ph)*pw + C%pw, else 0,
//      and 0 outside the image (SAME);
//   B: the matching slice of the flipped kernel (kh, kw, Cout, Cin), which
//      the wrapper computes once per call (ops/conv.py:flip_kernel) and
//      every group shares;
// and each of 256 threads accumulates an 8-row x 4-channel sub-tile in
// fp32 registers with FMAs.  Row m stores to out[m*Cin + ci], which is
// out[n, r, c, g*Cin + ci].  The unpooled tensor exists only as shared
// memory tiles.  The store rounds to y's dtype.  fp32 instantiations never
// touch TF32.  This is the simple first form: no tensor cores, no
// double-buffering; mma/wgmma and TMA staging are the route to the bound.
//
// Groups (`groups` > 1) are the channel-packed ("kpack") tail of
// deconv_api_tpu/engine/deconv.py, where the TPU kernel folds the packed
// groups into the GEMM's M (_mxu_kernel) and broadcasts the switches across
// them (_scatter_block): here too, so one grouped launch is one GEMM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // GEMM rows (pixel, group) per block
constexpr int BN = 64;   // input channels (GEMM N) per block
constexpr int BK = 16;   // Cout chunk per shared-memory stage
constexpr int TM = 8;    // rows per thread
constexpr int TN = 4;    // channels per thread
constexpr int NT = 256;  // threads per block: (BM/TM) x (BN/TN)
constexpr int A_ROWS = NT / BK;  // rows one A-loading pass covers
constexpr int B_ROWS = NT / BN;  // Cout rows one B-loading pass covers
constexpr int APAD = 4;  // keeps A stores off one bank, float4 reads aligned

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, bool RELU>
__global__ void __launch_bounds__(NT, 2)
fused_unpool_conv_kernel(const T* __restrict__ y, const int8_t* __restrict__ idx,
                         const T* __restrict__ fk, T* __restrict__ out, int N, int Ho, int Wo,
                         int Cout, int Cin, int ph, int pw, int kh, int kw, int rep,
                         int groups) {
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
int launch(const void* y, const void* idx, const void* fk, void* out, int N, int Ho, int Wo,
           int Cout, int Cin, int ph, int pw, int kh, int kw, int rep, int groups, int relu,
           void* stream) {
  const int64_t M = (int64_t)N * Ho * ph * Wo * pw * groups;
  if (M == 0 || Cin == 0) return 0;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cin + BN - 1) / BN));
  auto kernel = relu ? fused_unpool_conv_kernel<T, true> : fused_unpool_conv_kernel<T, false>;
  kernel<<<grid, NT, 0, (cudaStream_t)stream>>>((const T*)y, (const int8_t*)idx, (const T*)fk,
                                                (T*)out, N, Ho, Wo, Cout, Cin, ph, pw, kh, kw,
                                                rep, groups);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_unpool_conv_f32(const void* y, const void* idx, const void* fk, void* out,
                                     int N, int Ho, int Wo, int Cout, int Cin, int ph, int pw,
                                     int kh, int kw, int rep, int groups, int relu, void* stream) {
  return launch<float>(y, idx, fk, out, N, Ho, Wo, Cout, Cin, ph, pw, kh, kw, rep, groups, relu,
                       stream);
}

extern "C" int fused_unpool_conv_bf16(const void* y, const void* idx, const void* fk, void* out,
                                      int N, int Ho, int Wo, int Cout, int Cin, int ph, int pw,
                                      int kh, int kw, int rep, int groups, int relu, void* stream) {
  return launch<__nv_bfloat16>(y, idx, fk, out, N, Ho, Wo, Cout, Cin, ph, pw, kh, kw, rep, groups,
                               relu, stream);
}
