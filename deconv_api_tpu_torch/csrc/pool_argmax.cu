// Max-pool with int8 argmax switches, NHWC, for sm_90a.
//
// Replaces: deconv_api_tpu/ops/pallas_pool.py:_pool_kernel (entry
// maxpool_argmax_pallas), the TPU kernel that emits the pooled maxima and
// the compact int8 window argmax in one pass.
//
// Bound on the H100: device-memory bytes.  Each input element is read once
// and each window writes one pooled value and one int8 index; there is no
// arithmetic to speak of.  At VGG16 batch 8 the four forward pools move
// about 253 MB, some 75 us at 3.35 TB/s.
//
// Design: one thread per pooled pixel and per L-channel vector, L = 16
// bytes' worth (4 fp32, 8 bf16).  The thread makes one 16-byte load per
// window slot, one 16-byte store of the pooled values and one store of its
// L index bytes.  Channels are fastest within a warp, so every access
// covers whole 32-byte sectors.  Each lane walks the window in row-major
// order with a strict '>' in fp32 (exact for bf16), so the first maximum
// wins, as in the reference; the stored value is the input element itself,
// so the pooled tensor is bit-identical to the plain version, ties and +-0
// included.  The grid gives the indices in 32 bits: batch row on z, pooled
// row on y, pooled column x channel vector on x, with one division per
// thread.  Trailing rows and cols that do not fill a window have no thread
// (floor), as ops/pool.py drops them.  The scalar path (L = 1, any window)
// is the same kernel for ragged channels, misaligned pointers and windows
// other than 2x2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// element bits -> fp32
template <typename T> struct Elem;
template <> struct Elem<float> {
  using bits = unsigned int;
  static __device__ __forceinline__ float f32(bits b) { return __uint_as_float(b); }
};
template <> struct Elem<__nv_bfloat16> {
  using bits = unsigned short;
  static __device__ __forceinline__ float f32(bits b) { return __uint_as_float((unsigned)b << 16); }
};

// one access of BYTES bytes
template <int BYTES> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<2> { using type = unsigned short; };
template <> struct Word<1> { using type = unsigned char; };

// L elements of bits type S, moved as one word
template <typename S, int L> union Pack {
  typename Word<sizeof(S) * L>::type w;
  S v[L];
};

// L = 16 / sizeof(T) with PH = PW = 2 (the vector path), or L = 1 with
// PH = PW = 0 and the window from ph, pw (the scalar path).
template <typename T, int L, int PH, int PW>
__global__ void pool_argmax_kernel(const typename Elem<T>::bits* __restrict__ x,
                                   typename Elem<T>::bits* __restrict__ pooled,
                                   int8_t* __restrict__ idx, int H, int W, int C, int Wo, int ph_,
                                   int pw_) {
  using S = typename Elem<T>::bits;
  using P = Pack<S, L>;
  const int ph = PH ? PH : ph_, pw = PW ? PW : pw_;
  const int cvecs = C / L;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Wo * cvecs) return;
  const int wo = t / cvecs;
  const int ch = (t - wo * cvecs) * L;
  const int ho = blockIdx.y, b = blockIdx.z, Ho = gridDim.y;
  const S* base = x + ((b * H + ho * ph) * W + wo * pw) * C + ch;

  P best;
  best.w = *reinterpret_cast<const decltype(best.w)*>(base);
  float bestf[L];
  Pack<int8_t, L> besti;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    bestf[l] = Elem<T>::f32(best.v[l]);
    besti.v[l] = 0;
  }
#pragma unroll
  for (int di = 0; di < ph; ++di) {
#pragma unroll
    for (int dj = 0; dj < pw; ++dj) {
      if (di == 0 && dj == 0) continue;
      P cand;
      cand.w = *reinterpret_cast<const decltype(cand.w)*>(base + (di * W + dj) * C);
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float f = Elem<T>::f32(cand.v[l]);
        if (f > bestf[l]) {  // strict: the first row-major maximum wins
          bestf[l] = f;
          best.v[l] = cand.v[l];
          besti.v[l] = (int8_t)(di * pw + dj);
        }
      }
    }
  }
  const int o = ((b * Ho + ho) * Wo + wo) * C + ch;
  *reinterpret_cast<decltype(best.w)*>(pooled + o) = best.w;
  *reinterpret_cast<decltype(besti.w)*>(idx + o) = besti.w;
}

bool aligned(const void* p, int bytes) { return (reinterpret_cast<uintptr_t>(p) % bytes) == 0; }

// The launch plan (lanes, threads, grid) comes from the wrapper
// (ops/cuda_pool.py:pool_plan); a plan this kernel cannot run is refused
// with cudaErrorInvalidValue before anything launches.
template <typename T>
int launch(const void* x, void* pooled, void* idx, int64_t B, int H, int W, int C, int ph, int pw,
           void* stream, int lanes, int threads, int gx, int gy, int gz) {
  using S = typename Elem<T>::bits;
  constexpr int VL = 16 / sizeof(T);
  const int Ho = H / ph, Wo = W / pw;
  const bool vector = lanes == VL && ph == 2 && pw == 2 && C % VL == 0 && aligned(x, 16) &&
                      aligned(pooled, 16) && aligned(idx, VL);
  if (!(vector || lanes == 1) || gy != Ho || gz != B || threads < 32 || threads > 1024 ||
      (int64_t)gx * threads < (int64_t)Wo * (C / lanes) ||
      B * H * W * (int64_t)C >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Ho == 0 || Wo == 0 || C == 0) return 0;
  const dim3 grid(gx, gy, gz);
  auto kernel = vector ? pool_argmax_kernel<T, VL, 2, 2> : pool_argmax_kernel<T, 1, 0, 0>;
  kernel<<<grid, threads, 0, (cudaStream_t)stream>>>((const S*)x, (S*)pooled, (int8_t*)idx, H, W,
                                                      C, Wo, ph, pw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pool_argmax_f32(const void* x, void* pooled, void* idx, int64_t B, int H, int W,
                               int C, int ph, int pw, void* stream, int lanes, int threads, int gx,
                               int gy, int gz) {
  return launch<float>(x, pooled, idx, B, H, W, C, ph, pw, stream, lanes, threads, gx, gy, gz);
}

extern "C" int pool_argmax_bf16(const void* x, void* pooled, void* idx, int64_t B, int H, int W,
                                int C, int ph, int pw, void* stream, int lanes, int threads,
                                int gx, int gy, int gz) {
  return launch<__nv_bfloat16>(x, pooled, idx, B, H, W, C, ph, pw, stream, lanes, threads, gx, gy,
                               gz);
}
