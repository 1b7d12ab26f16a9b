// Switch unpool through int8 argmax switches, NHWC, for sm_90a.
//
// Replaces: deconv_api_tpu/ops/pallas_pool.py:_unpool_kernel (entry
// unpool_argmax_pallas), the TPU kernel that scatters each pooled value to
// its window's argmax slot, optionally through the deconvnet backward ReLU,
// with one switch block shared by `rep` consecutive signal rows.  The
// grouped form (`groups` > 1) is the channel-packed ("kpack") tail's unpool,
// deconv_api_tpu/ops/pool.py:unpool_with_argmax(groups=), which XLA ran
// outside Pallas: the signal carries `groups` projections group-major in its
// C channels and every group reads the same switch channel ch % (C/groups).
//
// Bound on the H100: device-memory bytes.  The output is ph*pw times the
// pooled signal and is written once; the signal and the switches are read
// once.  The VGG16 block1 site at batch 8, top-4 moves about 263 MB, some
// 79 us at 3.35 TB/s.
//
// Design: a gather, not a scatter: one thread per unpooled output element
// (n, r, c, ch), channels fastest, so stores coalesce and no two threads
// write the same address.  The thread reads y[n, r/ph, c/pw, ch] and
// idx[n/rep, r/ph, c/pw, ch] (ph*pw neighbouring threads read the same
// pooled element, which the cache serves; the groups of one pixel read the
// same switch bytes) and writes y * (idx == slot),
// the plain version's arithmetic, so results are bit-identical.  Rows and
// cols past ho*ph x wo*pw are the out_hw zero padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, bool RELU>
__global__ void unpool_kernel(const T* __restrict__ y, const int8_t* __restrict__ idx,
                              T* __restrict__ out, int64_t total, int Ho, int Wo, int C,
                              int Hout, int Wout, int ph, int pw, int rep, int groups) {
  const int Ci = C / groups;  // switch channels
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; o < total; o += stride) {
    const int ch = (int)(o % C);
    int64_t t = o / C;
    const int col = (int)(t % Wout);
    t /= Wout;
    const int row = (int)(t % Hout);
    const int64_t n = t / Hout;
    float r = 0.f;
    if (row < Ho * ph && col < Wo * pw) {
      const int pr = row / ph, pc = col / pw;
      const int slot = (row - pr * ph) * pw + (col - pc * pw);
      float v = to_f32(y[((n * Ho + pr) * Wo + pc) * C + ch]);
      if (RELU) v = fmaxf(v, 0.f);
      const int8_t s = idx[(((n / rep) * Ho + pr) * Wo + pc) * Ci + (groups > 1 ? ch % Ci : ch)];
      r = v * (s == slot ? 1.f : 0.f);
    }
    out[o] = from_f32<T>(r);
  }
}

template <typename T>
int launch(const void* y, const void* idx, void* out, int64_t N, int Ho, int Wo, int C, int Hout,
           int Wout, int ph, int pw, int rep, int groups, int relu, void* stream) {
  const int64_t total = N * Hout * Wout * (int64_t)C;
  if (total == 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond this
  auto kernel = relu ? unpool_kernel<T, true> : unpool_kernel<T, false>;
  kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)y, (const int8_t*)idx, (T*)out, total, Ho, Wo, C, Hout, Wout, ph, pw, rep, groups);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int unpool_argmax_f32(const void* y, const void* idx, void* out, int64_t N, int Ho,
                                 int Wo, int C, int Hout, int Wout, int ph, int pw, int rep,
                                 int groups, int relu, void* stream) {
  return launch<float>(y, idx, out, N, Ho, Wo, C, Hout, Wout, ph, pw, rep, groups, relu, stream);
}

extern "C" int unpool_argmax_bf16(const void* y, const void* idx, void* out, int64_t N, int Ho,
                                  int Wo, int C, int Hout, int Wout, int ph, int pw, int rep,
                                  int groups, int relu, void* stream) {
  return launch<__nv_bfloat16>(y, idx, out, N, Ho, Wo, C, Hout, Wout, ph, pw, rep, groups, relu,
                               stream);
}
