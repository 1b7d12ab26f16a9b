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
// Design: one thread per pooled pixel and per L-channel vector, L = 16
// bytes' worth (8 bf16, 4 fp32).  The thread loads its signal vector and
// its L switch bytes once, and writes one 16-byte vector to each of the
// window's ph*pw slots: out = v * (s == slot), in fp32 and then narrowed,
// the plain version's arithmetic, so results are bit-identical (a negative
// value at a slot that is not the argmax stays -0.0).  Channels are fastest
// within a warp, so every load and store covers whole 32-byte sectors.
// The grid gives the indices in 32 bits: batch row on z, pooled row on y,
// pooled column x channel vector on x; the only division is one per thread
// (and one modulo for the grouped form, whose vectors never straddle a
// group).  A pooled row or column past the extent exists only where out_hw
// pads one: its threads write the padding's zeros in the same launch.
// The scalar path (L = 1, any window) is the same kernel for ragged
// channels, misaligned pointers and windows other than 2x2.  Stores are
// streaming (st.global.cs, evict first): the output is written once and
// read by the next launch, never by this one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// element bits <-> fp32
template <typename T> struct Elem;
template <> struct Elem<float> {
  using bits = unsigned int;
  static __device__ __forceinline__ float f32(bits b) { return __uint_as_float(b); }
  static __device__ __forceinline__ bits narrow(float v) { return __float_as_uint(v); }
};
template <> struct Elem<__nv_bfloat16> {
  using bits = unsigned short;
  static __device__ __forceinline__ float f32(bits b) { return __uint_as_float((unsigned)b << 16); }
  static __device__ __forceinline__ bits narrow(float v) {
    return __bfloat16_as_ushort(__float2bfloat16(v));
  }
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

template <typename S, int L>
__device__ __forceinline__ Pack<S, L> load(const S* p) {
  Pack<S, L> r;
  r.w = *reinterpret_cast<const decltype(r.w)*>(p);
  return r;
}

template <typename S, int L>
__device__ __forceinline__ void store(S* p, const Pack<S, L>& v) {
  __stcs(reinterpret_cast<decltype(v.w)*>(p), v.w);
}

// L = 16 / sizeof(T) with PH = PW = 2 (the vector path), or L = 1 with
// PH = PW = 0 and the window from ph, pw (the scalar path).
template <typename T, int L, int PH, int PW>
__global__ void unpool_kernel(const typename Elem<T>::bits* __restrict__ y,
                              const int8_t* __restrict__ idx,
                              typename Elem<T>::bits* __restrict__ out, int Ho, int Wo, int C,
                              int Hout, int Wout, int ph_, int pw_, int rep, int Ci, int relu) {
  using S = typename Elem<T>::bits;
  const int ph = PH ? PH : ph_, pw = PW ? PW : pw_;
  const int cvecs = C / L;
  const int bands = Wout > Wo * pw ? Wo + 1 : Wo;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= bands * cvecs) return;
  const int pc = t / cvecs;
  const int ch = (t - pc * cvecs) * L;
  const int pr = blockIdx.y, n = blockIdx.z;

  float v[L];
  Pack<int8_t, L> s;
  if (pr < Ho && pc < Wo) {
    const Pack<S, L> yv = load<S, L>(y + ((n * Ho + pr) * Wo + pc) * C + ch);
    s = load<int8_t, L>(idx + (((n / rep) * Ho + pr) * Wo + pc) * Ci + (Ci == C ? ch : ch % Ci));
#pragma unroll
    for (int l = 0; l < L; ++l) {
      v[l] = Elem<T>::f32(yv.v[l]);
      if (relu) v[l] = fmaxf(v[l], 0.f);
    }
  } else {  // out_hw padding: zeros
#pragma unroll
    for (int l = 0; l < L; ++l) {
      v[l] = 0.f;
      s.v[l] = -1;
    }
  }
#pragma unroll
  for (int a = 0; a < ph; ++a) {
    const int row = pr * ph + a;
    if (row >= Hout) break;
#pragma unroll
    for (int b = 0; b < pw; ++b) {
      const int col = pc * pw + b;
      if (col >= Wout) break;
      const int slot = a * pw + b;
      Pack<S, L> o;
#pragma unroll
      for (int l = 0; l < L; ++l) o.v[l] = Elem<T>::narrow(v[l] * (s.v[l] == slot ? 1.f : 0.f));
      store(out + ((n * Hout + row) * Wout + col) * C + ch, o);
    }
  }
}

bool aligned(const void* p, int bytes) { return (reinterpret_cast<uintptr_t>(p) % bytes) == 0; }

template <typename T, int L, int PH, int PW>
void start(dim3 grid, int threads, cudaStream_t cs, const void* y, const void* idx, void* out,
           int Ho, int Wo, int C, int Hout, int Wout, int ph, int pw, int rep, int Ci, int relu) {
  using S = typename Elem<T>::bits;
  unpool_kernel<T, L, PH, PW><<<grid, threads, 0, cs>>>((const S*)y, (const int8_t*)idx, (S*)out,
                                                        Ho, Wo, C, Hout, Wout, ph, pw, rep, Ci,
                                                        relu);
}

// The launch plan (lanes, threads, grid) comes from the wrapper
// (ops/cuda_pool.py:unpool_plan); a plan this kernel cannot run is refused
// with cudaErrorInvalidValue before anything launches.
template <typename T>
int launch(const void* y, const void* idx, void* out, int64_t N, int Ho, int Wo, int C, int Hout,
           int Wout, int ph, int pw, int rep, int groups, int relu, void* stream, int lanes,
           int threads, int gx, int gy, int gz) {
  constexpr int VL = 16 / sizeof(T);
  const int Ci = C / groups;
  const int bands_h = Hout > Ho * ph ? Ho + 1 : Ho;
  const int bands_w = Wout > Wo * pw ? Wo + 1 : Wo;
  const bool vector = lanes == VL && ph == 2 && pw == 2 && Ci % VL == 0 && aligned(y, 16) &&
                      aligned(out, 16) && aligned(idx, VL);
  if (!(vector || lanes == 1) || gy != bands_h || gz != N || threads < 32 || threads > 1024 ||
      (int64_t)gx * threads < (int64_t)bands_w * (C / lanes) ||
      N * Hout * Wout * (int64_t)C >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  if (N == 0 || bands_h == 0 || bands_w == 0 || C == 0) return 0;
  const dim3 grid(gx, gy, gz);
  const cudaStream_t cs = (cudaStream_t)stream;
  if (vector)
    start<T, VL, 2, 2>(grid, threads, cs, y, idx, out, Ho, Wo, C, Hout, Wout, ph, pw, rep, Ci,
                       relu);
  else
    start<T, 1, 0, 0>(grid, threads, cs, y, idx, out, Ho, Wo, C, Hout, Wout, ph, pw, rep, Ci, relu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int unpool_argmax_f32(const void* y, const void* idx, void* out, int64_t N, int Ho,
                                 int Wo, int C, int Hout, int Wout, int ph, int pw, int rep,
                                 int groups, int relu, void* stream, int lanes, int threads, int gx,
                                 int gy, int gz) {
  return launch<float>(y, idx, out, N, Ho, Wo, C, Hout, Wout, ph, pw, rep, groups, relu, stream,
                       lanes, threads, gx, gy, gz);
}

extern "C" int unpool_argmax_bf16(const void* y, const void* idx, void* out, int64_t N, int Ho,
                                  int Wo, int C, int Hout, int Wout, int ph, int pw, int rep,
                                  int groups, int relu, void* stream, int lanes, int threads,
                                  int gx, int gy, int gz) {
  return launch<__nv_bfloat16>(y, idx, out, N, Ho, Wo, C, Hout, Wout, ph, pw, rep, groups, relu,
                               stream, lanes, threads, gx, gy, gz);
}
