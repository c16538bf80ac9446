// Fused z/w tails of the classical ADMM iteration, for sm_90a.
//
// Replaces the Pallas TPU kernels of pnp_admm_cnc_mri_tpu/ops/pallas_kernels.py:
//   l1_tail  (:68, body _l1_tail_kernel :54)   z' = soft(x + w, c)
//                                              w' = (w + x) - z'
//   cnc_tail (:119, body _cnc_tail_kernel :105)
//       s  = soft(z, 1/b)
//       t  = (1 - a) z + a (x + w) + arlb (z - s)      arlb = a rho lam b
//       z' = soft(t, arl)                              arl  = a rho lam
//       w' = (w + x) - z'
//
// Bound: device memory. Each element costs a handful of flops against 16 B
// (L1: x, w in; z', w' out; z is not read) or 20 B (CNC: x, z, w in) of
// float32 traffic. At batch 512 of 256x256 float32 that is 4 planes = 512 MiB
// for L1 and 5 planes = 640 MiB for CNC: about 160 us and 200 us at the
// H100's 3.35 TB/s. The design follows from that: one pass, each input read
// once and each output written once, 16-byte vector loads and stores where
// the size and the pointers allow it (a scalar loop otherwise), and a flat
// grid-stride loop over any contiguous shape (the TPU's tiling rule is not
// carried over).
//
// Numerics: the file is built with --fmad=false, so no multiply-add is
// contracted and every operation rounds where the plain PyTorch version
// rounds; the operations run in the JAX order. The scalars (1/b, 1-a, a,
// arlb, arl) are computed by the caller in double and passed in the
// kernel's type, as the Pallas kernel takes them from SMEM. soft() keeps
// NaN (fmaxf(NaN, 0) would give 0, where jnp.maximum gives NaN) and maps
// sign(0) to 0.
//
// Interface: plain C, called through ctypes. Each entry point launches on
// the given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 blocks per SM; the loop strides past that

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

__device__ __forceinline__ float abs_(float v) { return fabsf(v); }
__device__ __forceinline__ double abs_(double v) { return fabs(v); }

// jnp.maximum(|v| - c, 0) * jnp.sign(v)
template <typename T>
__device__ __forceinline__ T soft(T v, T c) {
  T m = abs_(v) - c;
  m = (m < T(0)) ? T(0) : m;  // NaN < 0 is false: NaN passes through
  const T s = (v > T(0)) ? T(1) : ((v < T(0)) ? T(-1) : T(0));
  return m * s;
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
l1_tail_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ z_out,
               T* __restrict__ w_out, T c, int64_t n_packs) {
  using P = Pack<T, N>;
  const P* xp = reinterpret_cast<const P*>(x);
  const P* wp = reinterpret_cast<const P*>(w);
  P* zo = reinterpret_cast<P*>(z_out);
  P* wo = reinterpret_cast<P*>(w_out);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_packs;
       i += stride) {
    const P xv = xp[i];
    const P wv = wp[i];
    P zn, wn;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const T z = soft(xv.v[k] + wv.v[k], c);
      zn.v[k] = z;
      wn.v[k] = (wv.v[k] + xv.v[k]) - z;
    }
    zo[i] = zn;
    wo[i] = wn;
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
cnc_tail_kernel(const T* __restrict__ x, const T* __restrict__ z, const T* __restrict__ w,
                T* __restrict__ z_out, T* __restrict__ w_out, T inv_b, T one_minus_alpha,
                T alpha, T arlb, T arl, int64_t n_packs) {
  using P = Pack<T, N>;
  const P* xp = reinterpret_cast<const P*>(x);
  const P* zp = reinterpret_cast<const P*>(z);
  const P* wp = reinterpret_cast<const P*>(w);
  P* zo = reinterpret_cast<P*>(z_out);
  P* wo = reinterpret_cast<P*>(w_out);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_packs;
       i += stride) {
    const P xv = xp[i];
    const P zv = zp[i];
    const P wv = wp[i];
    P zn, wn;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const T zk = zv.v[k];
      const T s = soft(zk, inv_b);
      const T t = one_minus_alpha * zk + alpha * (xv.v[k] + wv.v[k]) + arlb * (zk - s);
      const T znew = soft(t, arl);
      zn.v[k] = znew;
      wn.v[k] = (wv.v[k] + xv.v[k]) - znew;
    }
    zo[i] = zn;
    wo[i] = wn;
  }
}

inline int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Elements per 16-byte vector: 4 floats or 2 doubles.
template <typename T>
constexpr int kVec = 16 / sizeof(T);

template <typename T>
int launch_l1(const void* x, const void* w, void* z_out, void* w_out, T c, int64_t n,
              void* stream) {
  if (n <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto px = static_cast<const T*>(x);
  auto pw = static_cast<const T*>(w);
  auto pz = static_cast<T*>(z_out);
  auto po = static_cast<T*>(w_out);
  constexpr int V = kVec<T>;
  if (n % V == 0 && aligned16(x) && aligned16(w) && aligned16(z_out) && aligned16(w_out)) {
    l1_tail_kernel<T, V><<<blocks_for(n / V), kThreads, 0, s>>>(px, pw, pz, po, c, n / V);
  } else {
    l1_tail_kernel<T, 1><<<blocks_for(n), kThreads, 0, s>>>(px, pw, pz, po, c, n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_cnc(const void* x, const void* z, const void* w, void* z_out, void* w_out, T inv_b,
               T one_minus_alpha, T alpha, T arlb, T arl, int64_t n, void* stream) {
  if (n <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto px = static_cast<const T*>(x);
  auto pz = static_cast<const T*>(z);
  auto pw = static_cast<const T*>(w);
  auto pzo = static_cast<T*>(z_out);
  auto pwo = static_cast<T*>(w_out);
  constexpr int V = kVec<T>;
  if (n % V == 0 && aligned16(x) && aligned16(z) && aligned16(w) && aligned16(z_out) &&
      aligned16(w_out)) {
    cnc_tail_kernel<T, V><<<blocks_for(n / V), kThreads, 0, s>>>(
        px, pz, pw, pzo, pwo, inv_b, one_minus_alpha, alpha, arlb, arl, n / V);
  } else {
    cnc_tail_kernel<T, 1><<<blocks_for(n), kThreads, 0, s>>>(
        px, pz, pw, pzo, pwo, inv_b, one_minus_alpha, alpha, arlb, arl, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int admm_l1_tail_f32(const void* x, const void* w, void* z_out, void* w_out, float c, int64_t n,
                     void* stream) {
  return launch_l1<float>(x, w, z_out, w_out, c, n, stream);
}

int admm_l1_tail_f64(const void* x, const void* w, void* z_out, void* w_out, double c,
                     int64_t n, void* stream) {
  return launch_l1<double>(x, w, z_out, w_out, c, n, stream);
}

int admm_cnc_tail_f32(const void* x, const void* z, const void* w, void* z_out, void* w_out,
                      float inv_b, float one_minus_alpha, float alpha, float arlb, float arl,
                      int64_t n, void* stream) {
  return launch_cnc<float>(x, z, w, z_out, w_out, inv_b, one_minus_alpha, alpha, arlb, arl, n,
                           stream);
}

int admm_cnc_tail_f64(const void* x, const void* z, const void* w, void* z_out, void* w_out,
                      double inv_b, double one_minus_alpha, double alpha, double arlb,
                      double arl, int64_t n, void* stream) {
  return launch_cnc<double>(x, z, w, z_out, w_out, inv_b, one_minus_alpha, alpha, arlb, arl, n,
                            stream);
}

}  // extern "C"
