// One whole ADMM-L1 iteration in three launches, for sm_90a (float32).
//
// Replaces the Pallas TPU kernel of pnp_admm_cnc_mri_tpu/ops/pallas_dc.py:
// make_fused_iteration (:83, body _iteration_kernel :38) for the shapes that
// csrc/admm_iteration_cluster.cu (one launch a step, FFTs in a cluster's
// shared memory) does not take: H or W not a power of two, or a half
// spectrum too large for a cluster. For a batch of (H, W) images, W even,
// Wh = W/2 + 1, with the half-spectrum DFT done as matrix products:
//
//   v  = z - w
//   X  = v (cw - i sw)[:, :Wh]                   rows, W -> Wh bins
//   Y  = (ch - i sh) X                           columns, complex
//   Hb = A .* Y + C                              blend (A real (H, Wh), C per image)
//   I  = (ch + i sh)^T Hb / H                    inverse columns
//   x  = |Re(I diag(wk) (cw + i sw)[:Wh, :])| / W,  wk = [1, 2, ..., 2, 1]
//   z' = soft(x + w, thr),  w' = (w + x) - z'
//
// Bound: bytes. The function itself needs only two half-spectrum FFTs, the
// blend and the elementwise tail: about 6 MFLOP per 256 x 256
// image-iteration (5 H W log2(H W) for the two transforms), 3.1 GFLOP a
// launch at batch 512, 0.05 ms at the H100's 67 TFLOP/s of float32, while
// reading z, w, Cr, Ci and writing z', w' moves 0.67 GB, 0.20 ms at
// 3.35 TB/s. The dense-DFT formulation used here (as in the TPU kernel)
// does far more work: its twelve products cost 202.9 MFLOP per
// image-iteration, 103.9 GFLOP a launch, so this design cannot go below
// 1.55 ms on the CUDA cores however well its products run.
//
// Design. The TPU kernel kept whole images and every intermediate in VMEM;
// one 256 x 256 float32 image is already more than a block's 227 KB of
// shared memory. The work splits instead by rows and by spectral columns:
//
//   A (row_gemm<kForward>)   a register-tiled product per 128-row tile of
//      the (B*H, W) batch, v = z - w formed as the tile is loaded, against
//      E = [cw | -sw][:, :Wh] (W x 2Wh), written as Xr, Xi into two
//      (B, H, Wh) scratch planes;
//   B (column_strip)         a block owns a strip of S spectral columns
//      (of any images), holds X (H x S complex) in shared memory, runs
//      Y = (ch - i sh) X, blends, and runs I = (ch + i sh) Hb / H as complex
//      products against ch and sh (symmetric, so one tile layout serves
//      both directions, and each tile element feeds four multiply-adds),
//      writing Ir, Ii back over its own columns. S is 32, or 16 or 8
//      where H is too tall for 32 in shared memory (H above 384 and 776
//      on the H100; up to 1552);
//   C (row_gemm<kSynthesis>) the product [Ir | Ii] F / W with
//      F = [wk cw; -wk sw][:Wh, :] (2Wh x W; wk scales by 1 or 2 exactly),
//      then |.|, soft and the dual, with w read again.
//
// Each stage is a float32 product on the CUDA cores: operand tiles in
// shared memory, double-buffered (through registers in A and C, with
// cp.async in B), a small output tile per thread (8 x 6 in A; 8 x 4
// complex in B at 32 columns a strip; 8 x 8 in C), sums in registers, one
// owner per output and no atomics, so a launch is deterministic. The stages
// run at 28 to 38% of the products' own floor (PERF.md).
//
// Numerics: built without --fmad=false (the products contract to FMAs and
// are held to a tolerance, not bit for bit). The divisions by H and W come
// after the sums, and the dual is (w + x) - z', as in the TPU kernel.
// soft() keeps NaN and maps sign(0) to 0; a NaN spreads through its own
// image's transform only, since no product mixes images.
//
// Interface: plain C, called through ctypes, one entry point per stage.
// Each launches on the given stream, does not synchronise, and returns
// cudaGetLastError() (or the error of cudaFuncSetAttribute). The device's
// shared-memory limit is read, and the column kernel's attribute set, once
// per process and device.

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr int kBK = 8;   // depth of a product step
constexpr int kTM = 8;   // output rows per thread

__device__ __forceinline__ float soft(float v, float c) {
  float m = fabsf(v) - c;
  m = (m < 0.f) ? 0.f : m;  // NaN < 0 is false: NaN passes through
  const float s = (v > 0.f) ? 1.f : ((v < 0.f) ? -1.f : 0.f);
  return m * s;
}

// N consecutive floats from shared memory (N = 1, 2 or 4; aligned).
template <int N>
__device__ __forceinline__ void lds(float* dst, const float* src) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x; dst[1] = v.y;
  } else {
    dst[0] = src[0];
  }
}

// Asynchronous 4-byte copy from device to shared memory, zero-filled when
// !valid (src is then not read), and its group fences.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// ---------------------------------------------------------------------------
// Stages A and C: out = A (rows x K) . Bm (K x N), 128-row tiles of BN columns.
// A thread holds rows {64 q + 4 ty + i | q < 2, i < 4} of the tile's 128 and
// columns {g (BN / NG) + NV tx + v | g < NG, v < NV}, tx, ty in [0, 16).

enum Mode { kForward = 0, kSynthesis = 1 };

struct RowArgs {
  const float* a0;   // forward: z;  synthesis: Ir
  const float* a1;   // forward: w;  synthesis: Ii
  const float* bm;   // forward: E (W x 2Wh);  synthesis: F (2Wh x W)
  float* out0;       // forward: Xr;  synthesis: z'
  float* out1;       // forward: Xi;  synthesis: w'
  const float* wd;   // synthesis: w
  int64_t rows;      // B * H
  int width;         // W
  int wh;            // Wh
  float thr;         // synthesis: rho * lam
};

constexpr int kBM = 128;
constexpr int kAPad = 4;  // As rows are 132 floats: the two halves of a warp's stores hit other banks

template <int MODE, int BN, int TN, int NV, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
row_gemm(RowArgs p) {
  constexpr int NG = TN / NV;
  constexpr int GW = BN / NG;  // columns between a thread's groups
  static_assert(GW == 16 * NV, "16 threads across a group");
  static_assert((kBK * BN) % kThreads == 0, "B tile loads evenly");
  constexpr int BLOADS = kBK * BN / kThreads;

  __shared__ __align__(16) float As[2][kBK][kBM + kAPad];
  __shared__ __align__(16) float Bs[2][kBK][BN];

  const int K = MODE == kForward ? p.width : 2 * p.wh;
  const int N = MODE == kForward ? 2 * p.wh : p.width;
  const int lda = MODE == kForward ? p.width : p.wh;
  const int n_tiles = (N + BN - 1) / BN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;

  // A loads: row t / 2 of the tile, four consecutive k from (t % 2) * 4
  const int a_row = t / 2, a_k = (t % 2) * 4;
  const int64_t r_load = m0 + a_row;
  const bool row_ok = r_load < p.rows;
  const int64_t a_off = r_load * lda;

  float ra[4], rb[BLOADS];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + a_k + q;
      float v = 0.f;
      if (row_ok && k < K) {
        if (MODE == kForward) {
          v = p.a0[a_off + k] - p.a1[a_off + k];  // v = z - w
        } else {
          v = k < p.wh ? p.a0[a_off + k] : p.a1[a_off + k - p.wh];
        }
      }
      ra[q] = v;
    }
#pragma unroll
    for (int q = 0; q < BLOADS; ++q) {
      const int e = t + q * kThreads;
      const int kk = e / BN, n = e % BN;
      rb[q] = (k0 + kk < K && n0 + n < N) ? p.bm[static_cast<int64_t>(k0 + kk) * N + n0 + n] : 0.f;
    }
  };
  auto store_tile = [&](int buf) {
#pragma unroll
    for (int q = 0; q < 4; ++q) As[buf][a_k + q][a_row] = ra[q];
#pragma unroll
    for (int q = 0; q < BLOADS; ++q) {
      const int e = t + q * kThreads;
      Bs[buf][e / BN][e % BN] = rb[q];
    }
  };

  float acc[kTM][TN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int k_tiles = (K + kBK - 1) / kBK;
  load_tile(0);
  store_tile(0);
  __syncthreads();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < k_tiles) load_tile((kt + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[TN];
      lds<4>(a, &As[buf][kk][4 * ty]);
      lds<4>(a + 4, &As[buf][kk][64 + 4 * ty]);
#pragma unroll
      for (int g = 0; g < NG; ++g) lds<NV>(b + g * NV, &Bs[buf][kk][g * GW + NV * tx]);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < k_tiles) store_tile(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t r = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (r >= p.rows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + (j / NV) * GW + NV * tx + j % NV;
      if (n >= N) continue;
      if (MODE == kForward) {
        if (n < p.wh) {
          p.out0[r * p.wh + n] = acc[i][j];
        } else {
          p.out1[r * p.wh + n - p.wh] = acc[i][j];
        }
      } else {
        const int64_t o = r * p.width + n;
        const float x = fabsf(acc[i][j] / static_cast<float>(p.width));
        const float wv = p.wd[o];
        const float zn = soft(x + wv, p.thr);
        p.out0[o] = zn;
        p.out1[o] = (wv + x) - zn;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Stage B: a block owns S consecutive columns c of the (B * Wh) spectral
// columns; column c is bin k = c % Wh of image b = c / Wh, and element
// (h, c) of a plane sits at b H Wh + h Wh + k. The strip holds row h as
// [re(S) | im(S)]. The H x H complex products run in row tiles of 32 TM: a
// thread holds rows {128 q + 4 ty + i | q < TM / 4, i < 4} (ty in [0, 32))
// and columns {TN tx .. TN tx + TN - 1} (tx in [0, 8)), real and imaginary
// sums for each. ch and sh are symmetric, so both directions read tiles of
// their rows (contiguous in m): forward (ch - i sh) X, inverse (ch + i sh) Hb.
// When one tile covers all H rows (H <= 32 TM), the forward sums stay in
// registers until the block has read the strip, and the blended strip
// overwrites it in place; taller images take a second strip buffer.

struct ColArgs {
  float* p0;          // Xr in, Ir out
  float* p1;          // Xi in, Ii out
  const float* ch;    // cos DFT matrix (H x H, symmetric)
  const float* sh;    // sin DFT matrix
  const float* a;     // A (H x Wh)
  const float* cr;    // C (B x H x Wh)
  const float* ci;
  int64_t cols;       // B * Wh
  int h;
  int wh;
};

// Rows per thread for H rows: 4 up to H = 128, else 8.
inline int column_tm(int h) { return h <= 32 * 4 ? 4 : 8; }

// Shared memory of a block: the strip in (and, unless in place, out), two
// tiles of ch and sh, the columns' offsets and bins.
inline size_t column_smem(int h, int s) {
  const int mt = 32 * column_tm(h);
  const size_t k2 = static_cast<size_t>((h + kBK - 1) / kBK * kBK);
  const size_t strips = h <= mt ? 1 : 2;
  return strips * k2 * 2 * s * sizeof(float) + 2 * kBK * 2 * mt * sizeof(float) +
         s * (sizeof(int64_t) + sizeof(int));
}

// (acc_r, acc_i) = (ch -+ i sh)[m0 : m0 + 32 TM, :] . strip, with - for the
// forward transform (INV false) and + for the inverse. Starts and ends with
// a barrier.
template <int S, int TM, bool INV>
__device__ __forceinline__ void strip_product(float (&acc_r)[TM][S / 8], float (&acc_i)[TM][S / 8],
                                              const float* __restrict__ ch, const float* __restrict__ sh,
                                              const float* strip, float* gs, int m0, int h) {
  constexpr int TN = S / 8;
  constexpr int MT = 32 * TM;
  constexpr int GLOADS = kBK * 2 * MT / kThreads;
  const int t = threadIdx.x, tx = t % 8, ty = t / 8;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc_r[i][j] = acc_i[i][j] = 0.f;
  // tile row kk holds ch[k0 + kk][m0 : m0 + MT] then sh[k0 + kk][m0 : m0 + MT],
  // copied asynchronously (no registers held), two tiles in flight
  auto issue = [&](int k0, int buf) {
#pragma unroll
    for (int q = 0; q < GLOADS; ++q) {
      const int e = t + q * kThreads;
      const int kk = e / (2 * MT), r = e % (2 * MT);
      const int mm = r % MT;
      const float* src = r < MT ? ch : sh;
      const bool ok = k0 + kk < h && m0 + mm < h;
      cp_async4(&gs[buf * kBK * 2 * MT + e], ok ? src + static_cast<int64_t>(k0 + kk) * h + m0 + mm : src, ok);
    }
    cp_async_commit();
  };
  const int k_tiles = (h + kBK - 1) / kBK;
  __syncthreads();  // the tiles of a previous product are read, the strip is written
  issue(0, 0);
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < k_tiles) {
      issue((kt + 1) * kBK, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt has landed for every thread
    const float* g = gs + buf * kBK * 2 * MT;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float c[TM], sn[TM], xr[TN], xi[TN];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        lds<4>(c + 4 * q, &g[kk * 2 * MT + 128 * q + 4 * ty]);
        lds<4>(sn + 4 * q, &g[kk * 2 * MT + MT + 128 * q + 4 * ty]);
      }
      const float* row = &strip[(kt * kBK + kk) * 2 * S];
      lds<TN>(xr, row + TN * tx);
      lds<TN>(xi, row + S + TN * tx);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float sp = INV ? -sn[i] : sn[i];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          // forward: re += c xr + s xi, im += c xi - s xr; inverse: the signs of s flip
          acc_r[i][j] = fmaf(sp, xi[j], fmaf(c[i], xr[j], acc_r[i][j]));
          acc_i[i][j] = fmaf(-sp, xr[j], fmaf(c[i], xi[j], acc_i[i][j]));
        }
      }
    }
    __syncthreads();  // tile kt is read before tile kt + 2 overwrites it
  }
}

template <int S, int TM>
__global__ void __launch_bounds__(kThreads, 2)
column_strip(ColArgs p) {
  constexpr int TN = S / 8;
  constexpr int MT = 32 * TM;
  extern __shared__ __align__(16) unsigned char smem[];
  const int k2 = (p.h + kBK - 1) / kBK * kBK;
  const bool in_place = p.h <= MT;
  float* xs = reinterpret_cast<float*>(smem);                         // [k2][2S]  Xr | Xi
  float* hs = in_place ? xs : xs + static_cast<size_t>(k2) * 2 * S;   // [k2][2S]  blended
  float* gs = hs + static_cast<size_t>(k2) * 2 * S;                   // [2][kBK][2][MT]
  auto base = reinterpret_cast<int64_t*>(gs + 2 * kBK * 2 * MT);      // [S]
  auto bin = reinterpret_cast<int*>(base + S);                        // [S]

  const int t = threadIdx.x, tx = t % 8, ty = t / 8;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * S;
  const int64_t plane_stride = static_cast<int64_t>(p.h) * p.wh;
  if (t < S) {
    const int64_t c = c0 + t;
    const int64_t b = c / p.wh;
    bin[t] = static_cast<int>(c - b * p.wh);
    base[t] = c < p.cols ? b * plane_stride + bin[t] : -1;
  }
  __syncthreads();

  // the strip, zero in the padding rows and in columns past the end
  for (int e = t; e < k2 * 2 * S; e += kThreads) {
    const int hh = e / (2 * S), r = e % (2 * S), j = r % S;
    float v = 0.f;
    if (hh < p.h && base[j] >= 0) v = (r < S ? p.p0 : p.p1)[base[j] + static_cast<int64_t>(hh) * p.wh];
    xs[e] = v;
    if (!in_place) hs[e] = 0.f;
  }

  float acc_r[TM][TN], acc_i[TM][TN];
  // forward columns and blend: Hb = A .* ((ch - i sh) X) + C
  for (int m0 = 0; m0 < p.h; m0 += MT) {
    strip_product<S, TM, false>(acc_r, acc_i, p.ch, p.sh, xs, gs, m0, p.h);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + 128 * (i / 4) + 4 * ty + i % 4;
      if (m >= p.h) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int jj = TN * tx + j;
        if (base[jj] < 0) continue;
        const int64_t o = base[jj] + static_cast<int64_t>(m) * p.wh;
        const float av = p.a[static_cast<int64_t>(m) * p.wh + bin[jj]];
        hs[m * 2 * S + jj] = av * acc_r[i][j] + p.cr[o];
        hs[m * 2 * S + S + jj] = av * acc_i[i][j] + p.ci[o];
      }
    }
  }

  // inverse columns: I = (ch + i sh) Hb / H, over the strip's own columns
  for (int m0 = 0; m0 < p.h; m0 += MT) {
    strip_product<S, TM, true>(acc_r, acc_i, p.ch, p.sh, hs, gs, m0, p.h);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + 128 * (i / 4) + 4 * ty + i % 4;
      if (m >= p.h) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int jj = TN * tx + j;
        if (base[jj] < 0) continue;
        const int64_t o = base[jj] + static_cast<int64_t>(m) * p.wh;
        p.p0[o] = acc_r[i][j] / static_cast<float>(p.h);
        p.p1[o] = acc_i[i][j] / static_cast<float>(p.h);
      }
    }
  }
}

// The current device's opt-in shared memory a block may use (bytes), read
// once per process and device; a negative cudaError if the query failed.
int device_smem_limit() {
  static std::once_flag once[kMaxDevices];
  static int limit[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return -static_cast<int>(cudaErrorInvalidDevice);
  std::call_once(once[dev], [dev] {
    const cudaError_t err = cudaDeviceGetAttribute(&limit[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) limit[dev] = -static_cast<int>(err);
  });
  return limit[dev];
}

template <int S, int TM>
int launch_columns_tm(const ColArgs& p, cudaStream_t s) {
  // the kernel's shared-memory limit, raised to the device's once per
  // process and device (every strip width that column_strip_width picks fits it)
  static std::once_flag once[kMaxDevices];
  static cudaError_t set_err[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  std::call_once(once[dev], [] {
    int dev_now = 0;
    cudaGetDevice(&dev_now);
    const int limit = device_smem_limit();
    set_err[dev_now] = limit < 0 ? static_cast<cudaError_t>(-limit)
                                 : cudaFuncSetAttribute(column_strip<S, TM>,
                                                        cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  });
  if (set_err[dev] != cudaSuccess) return static_cast<int>(set_err[dev]);
  const size_t bytes = column_smem(p.h, S);
  const int64_t blocks = (p.cols + S - 1) / S;
  column_strip<S, TM><<<static_cast<unsigned>(blocks), kThreads, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int launch_columns(const ColArgs& p, cudaStream_t s) {
  return column_tm(p.h) == 4 ? launch_columns_tm<S, 4>(p, s) : launch_columns_tm<S, 8>(p, s);
}

// The widest strip (32, 16 or 8 columns) whose shared memory fits a block of
// the current device: a wider strip reads the DFT matrices fewer times.
// Returns 0 if none fits, or a negative cudaError if the device query failed.
int column_strip_width(int h) {
  const int limit = device_smem_limit();
  if (limit < 0) return limit;
  constexpr int kStrips[] = {32, 16, 8};
  for (int s : kStrips) {
    if (column_smem(h, s) <= static_cast<size_t>(limit)) return s;
  }
  return 0;
}

template <int MODE, int BN, int TN, int NV, int MIN_BLOCKS>
int launch_rows(const RowArgs& p, cudaStream_t s) {
  const int n = MODE == kForward ? 2 * p.wh : p.width;
  const int64_t blocks = (p.rows + kBM - 1) / kBM * ((n + BN - 1) / BN);
  row_gemm<MODE, BN, TN, NV, MIN_BLOCKS><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The strip width the column stage takes for H rows on the current device,
// 0 if H is too tall for its shared memory, or a negative cudaError.
int admm_iteration_column_strip(int h) { return column_strip_width(h); }

// Stage A: Xr, Xi (rows x Wh each) from z, w (rows x W) and E (W x 2Wh).
int admm_iteration_rows_f32(const void* z, const void* w, const void* e, void* xr, void* xi,
                            int64_t rows, int width, int wh, void* stream) {
  if (rows <= 0) return cudaSuccess;
  RowArgs p{static_cast<const float*>(z), static_cast<const float*>(w), static_cast<const float*>(e),
            static_cast<float*>(xr), static_cast<float*>(xi), nullptr, rows, width, wh, 0.f};
  // 96-column tiles: 2Wh = 258 columns take three tiles (288), not three of 128
  return launch_rows<kForward, 96, 6, 2, 1>(p, static_cast<cudaStream_t>(stream));
}

// Stage B: the column transforms and the blend, in place over the planes.
int admm_iteration_columns_f32(void* p0, void* p1, const void* ch, const void* sh, const void* a,
                               const void* cr, const void* ci, int64_t cols, int h, int wh,
                               void* stream) {
  if (cols <= 0) return cudaSuccess;
  ColArgs p{static_cast<float*>(p0), static_cast<float*>(p1), static_cast<const float*>(ch),
            static_cast<const float*>(sh), static_cast<const float*>(a), static_cast<const float*>(cr),
            static_cast<const float*>(ci), cols, h, wh};
  auto s = static_cast<cudaStream_t>(stream);
  switch (column_strip_width(h)) {
    case 32: return launch_columns<32>(p, s);
    case 16: return launch_columns<16>(p, s);
    case 8: return launch_columns<8>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Stage C: synthesis from Ir, Ii with F (2Wh x W), then |.|, soft and the dual.
int admm_iteration_synthesis_f32(const void* ir, const void* ii, const void* f, const void* w,
                                 void* z_out, void* w_out, float thr, int64_t rows, int width,
                                 int wh, void* stream) {
  if (rows <= 0) return cudaSuccess;
  RowArgs p{static_cast<const float*>(ir), static_cast<const float*>(ii), static_cast<const float*>(f),
            static_cast<float*>(z_out), static_cast<float*>(w_out), static_cast<const float*>(w),
            rows, width, wh, thr};
  return launch_rows<kSynthesis, 128, 8, 4, 2>(p, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
