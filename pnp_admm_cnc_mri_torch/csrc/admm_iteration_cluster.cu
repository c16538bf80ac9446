// One whole ADMM-L1 iteration in one launch, one thread-block cluster per
// image, for sm_90a (float32).
//
// Replaces the Pallas TPU kernel of pnp_admm_cnc_mri_tpu/ops/pallas_dc.py:
// make_fused_iteration (:83, body _iteration_kernel :38), for images whose H
// and W are powers of two and whose half spectrum fits a cluster's shared
// memory (csrc/admm_iteration.cu takes the other shapes). For a batch of
// (H, W) images, Wh = W/2 + 1:
//
//   v  = z - w
//   V  = rfft2(v)                                  (H x Wh)
//   Hb = A .* V + C                                A real (H, Wh), C per image
//   x  = |Re irfft2(Hb)|                           bins 0 and W/2 weighed once, / H, / W
//   z' = soft(x + w, thr),  w' = (w + x) - z'
//
// Bound: bytes. Reading z, w, Cr, Ci and writing z', w' moves 0.67 GB a step
// at 512 x 256 x 256 (0.20 ms at 3.35 TB/s); the two half-spectrum FFTs, the
// blend and the tail are about 3.1 GFLOP (0.05 ms on the CUDA cores), so
// about 4.6 flops a byte against the card's ~20. The design keeps every
// intermediate on chip and reads each input once, but w, which it reads
// twice (0.81 GB a step) to make room for C.
//
// Design. A cluster of Q blocks (launched with cudaLaunchKernelEx; Q is
// chosen by the caller from the device's shared memory, see
// fused_dc.cluster_size) holds one image. Block r owns rows
// [r R, (r + 1) R), R = H / Q, and W/2/Q column slots:
//
//   1 rows       one thread brings the block's rows of z and w into shared
//                memory with cp.async.bulk, completing on an mbarrier. z
//                lands at the tail of the spectrum buffer: the spectrum row
//                i ends (4W + 8)(i + 1) bytes in, the z row i + 1 starts
//                8R + 4W (i + 1) bytes in, so rows taken in order never
//                overwrite z that is still to be read. Pairs of rows of
//                v = z - w go through one complex FFT of length W each
//                (v_a + i v_b), and are separated by conjugate symmetry into
//                bins 0..Wh-1 of each row. Then w's buffer takes the Cr and
//                Ci of the block's slots, by cp.async, while the cluster
//                syncs and gathers.
//   cluster.sync()
//   2 columns    the Wh bins make W/2 slots: bins 0 and W/2 are real after
//                the row transforms and share slot 0 as bin0 + i bin(W/2).
//                For a batch of its slots block r gathers the H values of
//                each from the Q blocks' spectra through distributed shared
//                memory, runs the forward FFT of length H, blends with A (an
//                L2 hit, shared by all images) and C (slot 0: separated by
//                conjugate symmetry, blended, and only the Hermitian part of
//                each blend kept, the part whose inverse is real), runs the
//                inverse FFT, divides by H, and writes the columns back
//                where they came from. A column is read and written by its
//                owner only. After the last blend w is loaded again, by
//                cp.async.bulk, for phase 3.
//   cluster.sync()
//   3 synthesis  pairs of rows again: bins 0 and W/2 are real (the
//                reference weighs only their real parts, once), the half
//                spectrum is extended by conjugate symmetry, X_a + i X_b
//                goes through one inverse complex FFT, and its real and
//                imaginary parts are the two rows times W. Then / W, |.|,
//                soft and the dual; z' and w' are written once.
//
// FFTs: Stockham autosort in place, radix-4 stages and one radix-2 stage
// where log2(n) is odd. A sequence belongs to n/8 threads, each with 8
// elements in registers a stage, so up to n = 256 a stage syncs one warp,
// not the block. Twiddles come from a table exp(-2 pi i t / n), t in [0, n),
// built once by the caller in double precision from integer t; the inverse
// takes its conjugate. No __sinf.
//
// Numerics: built without --fmad=false (held to a tolerance against the
// dense-DFT plain version, not bit for bit). The divisions by H and W come
// after the sums, the dual is (w + x) - z', as in the TPU kernel. soft()
// keeps NaN; a NaN spreads through its own image only, since a cluster
// holds one image and nothing crosses clusters. One owner per output and no
// atomics, so two launches are bitwise equal.
//
// Interface: plain C, called through ctypes. The launch runs on the given
// stream, does not synchronise, and returns cudaGetLastError() (or the
// launch's own error). The device's limits are read, and the kernel's
// shared-memory attribute set, once per process and device.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

// Threads a block, and the complex values of the block's work buffer (kWork,
// and kPad more for the columns' padded pitch): a batch of FFTs fills the
// buffer at 8 elements a thread. H and W are at most kWork / 2.
constexpr int kThreads = 512;
constexpr int kLogWork = 12;
constexpr int kWork = 1 << kLogWork;
constexpr int kPad = 64;
constexpr int kPer = kWork / kThreads;  // work-buffer elements a thread
static_assert(kPer == 8, "fft() gives each thread 8 elements of a full buffer");
// Probe builds only (probes/k3_probe.py), to time the phases by difference:
// ADMM_CLUSTER_PHASES = 0, 1 or 2 stops after that phase and writes w as z'
// and w'; ADMM_CLUSTER_SHORTCUT = 1 gathers and scatters the columns in the
// block's own spectrum. Both give wrong results; the library runs as below.
#ifndef ADMM_CLUSTER_PHASES
#define ADMM_CLUSTER_PHASES 3
#endif
#ifndef ADMM_CLUSTER_SHORTCUT
#define ADMM_CLUSTER_SHORTCUT 0
#endif
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float soft(float v, float c) {
  float m = fabsf(v) - c;
  m = (m < 0.f) ? 0.f : m;  // NaN < 0 is false: NaN passes through
  const float s = (v > 0.f) ? 1.f : ((v < 0.f) ? -1.f : 0.f);
  return m * s;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// 1-D bulk copy (TMA) of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory to this block's shared memory.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// 4-byte copy from device to shared memory, asynchronous; and the wait for
// all of a thread's copies.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// `count` complex FFTs of length n = 2^log_n (8 <= n <= kWork), in place
// in shared memory: sequence s at a + s * pitch, its elements contiguous.
// Stockham stages, radix 4 and, where log2(n) is odd, one radix 2 last.
// Each sequence is owned by n / 8 threads, 8 elements a thread a stage: a
// stage loads them into registers, syncs the sequence's threads, computes,
// stores in place, and syncs again: __syncwarp where a sequence fits in a
// warp, the block's barrier otherwise. Every thread of the block calls it
// (threads past count * n / 8 only take part in the syncs).
template <bool INV>
__device__ void fft(float2* a, int log_n, int count, int pitch, const float2* __restrict__ tw) {
  const int log_g = log_n - 3;  // threads a sequence
  const int g = 1 << log_g;
  const int s = threadIdx.x >> log_g, lt = threadIdx.x & (g - 1);
  const bool active = s < count;
  float2* x = a + s * pitch;
  auto sync = [&] {
    if (log_g <= 5) {
      __syncwarp();
    } else {
      __syncthreads();
    }
  };
  for (int log_ns = 0; log_ns < log_n;) {
    const int log_r = (log_ns + 2 <= log_n) ? 2 : 1;
    const int log_m = log_n - log_r;  // butterflies a sequence: m = n / r = (8 / r) g
    const int m = 1 << log_m, ns = 1 << log_ns;
    const int tw_shift = log_m - log_ns;  // twiddle step n / (ns r)
    float2 v[8];
    // butterfly c of this thread is j = lt + c g; its input q is x[j + q m]
    if (active) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = i & ((1 << log_r) - 1), c = i >> log_r;
        v[i] = x[lt + c * g + q * m];
      }
    }
    sync();
    if (active) {
      if (log_r == 2) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = lt + c * g, k = j & (ns - 1);
          const int d = ((j >> log_ns) << (log_ns + 2)) + k;
          float2* u = v + 4 * c;
          if (k > 0) {  // k = 0: the twiddles are 1
#pragma unroll
            for (int q = 1; q < 4; ++q) {
              float2 wq = __ldg(&tw[(q * k) << tw_shift]);
              if (INV) wq.y = -wq.y;
              u[q] = cmul(u[q], wq);
            }
          }
          // forward: y1 = u0 - i u1 - u2 + i u3; the inverse flips the signs of i
          const float2 s02 = make_float2(u[0].x + u[2].x, u[0].y + u[2].y);
          const float2 d02 = make_float2(u[0].x - u[2].x, u[0].y - u[2].y);
          const float2 s13 = make_float2(u[1].x + u[3].x, u[1].y + u[3].y);
          const float2 d13 = make_float2(u[1].x - u[3].x, u[1].y - u[3].y);
          const float2 rot = INV ? make_float2(-d13.y, d13.x) : make_float2(d13.y, -d13.x);  // -+ i d13
          x[d] = make_float2(s02.x + s13.x, s02.y + s13.y);
          x[d + ns] = make_float2(d02.x + rot.x, d02.y + rot.y);
          x[d + 2 * ns] = make_float2(s02.x - s13.x, s02.y - s13.y);
          x[d + 3 * ns] = make_float2(d02.x - rot.x, d02.y - rot.y);
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = lt + c * g, k = j & (ns - 1);
          const int d = ((j >> log_ns) << (log_ns + 1)) + k;
          float2 u0 = v[2 * c], u1 = v[2 * c + 1];
          if (k > 0) {
            float2 w1 = __ldg(&tw[k << tw_shift]);
            if (INV) w1.y = -w1.y;
            u1 = cmul(u1, w1);
          }
          x[d] = make_float2(u0.x + u1.x, u0.y + u1.y);
          x[d + ns] = make_float2(u0.x - u1.x, u0.y - u1.y);
        }
      }
    }
    sync();
    log_ns += log_r;
  }
}

struct Args {
  const float* z;
  const float* w;
  const float2* tw_w;  // exp(-2 pi i t / W), t < W
  const float2* tw_h;  // exp(-2 pi i t / H), t < H
  const float* a;      // A (H x Wh)
  const float* cr;     // C (B x H x Wh)
  const float* ci;
  float* z_out;
  float* w_out;
  float thr;
  int log_h;
  int log_w;
  int q;  // blocks per cluster
};

// Shared memory of a block: the mbarrier, the spectrum (R x Wh complex), the
// rows of w (R x W), the work buffer.
inline size_t cluster_smem(int h, int w, int q) {
  const size_t r = h / q, wh = w / 2 + 1;
  return 16 + r * wh * 8 + r * w * 4 + size_t{kWork + kPad} * 8;
}

// At most 64 registers a thread, so that two blocks fit an SM. Loops that
// read shared memory of other blocks before they store are unrolled (kPer
// fixed steps of kThreads elements), so that a thread's loads are in flight
// together.
__global__ void __launch_bounds__(kThreads, 2) cluster_iteration(Args p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t b = blockIdx.x / p.q;
  const int H = 1 << p.log_h, W = 1 << p.log_w, wh = W / 2 + 1;
  const int R = H / p.q;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  auto bar = reinterpret_cast<uint64_t*>(smem);
  auto spec = reinterpret_cast<float2*>(smem + 16);       // [R][Wh]
  auto wk = reinterpret_cast<float*>(spec + R * wh);      // [R][W]
  auto buf = reinterpret_cast<float2*>(wk + R * W);       // [kWork + kPad]
  float* zs = reinterpret_cast<float*>(spec) + 2 * R;     // [R][W], the tail of spec

  const int64_t row0 = b * H + static_cast<int64_t>(rank) * R;
  const unsigned row_bytes = static_cast<unsigned>(R) * W * sizeof(float);
  if (tid == 0) mbar_init(bar, 1);
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 2 * row_bytes);
    bulk_load(zs, p.z + row0 * W, row_bytes, bar);
    bulk_load(wk, p.w + row0 * W, row_bytes, bar);
  }
  mbar_wait(bar, 0);

  // -- 1: forward row transforms, two real rows per complex FFT ------------
  const int pairs = R / 2;
  const int log_batch = min(__ffs(R) - 2, kLogWork - p.log_w);  // pairs a batch: min(R/2, kWork/W)
  const int batch = 1 << log_batch;
  for (int p0 = 0; p0 < pairs && ADMM_CLUSTER_PHASES >= 1; p0 += batch) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      if (e < (batch << p.log_w)) {
        const int o = (2 * p0 + 2 * (e >> p.log_w)) * W + (e & (W - 1));
        buf[e] = make_float2(zs[o] - wk[o], zs[o + W] - wk[o + W]);
      }
    }
    __syncthreads();
    fft<false>(buf, p.log_w, batch, W, p.tw_w);
    __syncthreads();
    for (int e = tid; e < batch * wh; e += kThreads) {
      const int pp = e / wh, k = e - pp * wh;
      const float2 u = buf[pp * W + k], m = buf[pp * W + ((W - k) & (W - 1))];
      // V_a = (u + conj(m)) / 2, V_b = (u - conj(m)) / 2i
      const int ra = 2 * (p0 + pp);
      spec[ra * wh + k] = make_float2(0.5f * (u.x + m.x), 0.5f * (u.y - m.y));
      spec[(ra + 1) * wh + k] = make_float2(0.5f * (u.y + m.y), -0.5f * (u.x - m.x));
    }
    __syncthreads();
  }

  // The Wh bins make W/2 column slots: slot 0 holds bins 0 and W/2, whose
  // row transforms are real, as one complex column bin0 + i bin(W/2); slot
  // k > 0 is bin k. A block owns W/2/Q consecutive slots. Their Cr and Ci
  // (2 H W/2/Q = R W floats) are copied now into the w buffer, free until
  // phase 3 loads w again: cs[plane][row][slot - s_first]. Slot 0 reads its
  // bins of C where it blends them.
  const int nk = (W / 2) / p.q, log_nk = __ffs(nk) - 1;
  const int s_first = rank * nk;
  float* cs = wk;
  for (int e = tid; e < R * W && ADMM_CLUSTER_PHASES >= 2; e += kThreads) {
    const int k = s_first + (e & (nk - 1)), hh = (e >> log_nk) & (H - 1);
    if (k) cp_async4(&cs[e], ((e >> (log_nk + p.log_h)) ? p.ci : p.cr) + (b * H + hh) * wh + k);
  }
  cluster.sync();

  // -- 2: column transforms and the blend, over this block's column slots ---
  // in batches of a power of two (at most kWork / H and kPad); column cc of
  // a batch at buf + cc (H + 1), the odd pitch keeping a warp's accesses
  // along a row of the batch, and down a column, on distinct banks
  const int log_cb = min(min(log_nk, kLogWork - p.log_h), 6);
  const int cb = 1 << log_cb, pitch = H + 1;
  const float inv_h = 1.f / static_cast<float>(H);
  for (int c0 = 0; c0 < nk && ADMM_CLUSTER_PHASES >= 2; c0 += cb) {
    const int k0 = s_first + c0;  // element (row hh, slot k0 + cc): e = hh cb + cc
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // in halves, to keep the loads in registers
      float2 g[kPer / 2];
#pragma unroll
      for (int i = 0; i < kPer / 2; ++i) {
        const int e = tid + (half * kPer / 2 + i) * kThreads;
        if (e < (H << log_cb)) {
          const int hh = e >> log_cb, k = k0 + (e & (cb - 1));
          const float2* src =
              ((ADMM_CLUSTER_SHORTCUT & 1) ? spec : cluster.map_shared_rank(spec, hh / R)) + (hh % R) * wh;
          g[i] = k ? src[k] : make_float2(src[0].x, src[W / 2].x);
        }
      }
#pragma unroll
      for (int i = 0; i < kPer / 2; ++i) {
        const int e = tid + (half * kPer / 2 + i) * kThreads;
        if (e < (H << log_cb)) buf[(e & (cb - 1)) * pitch + (e >> log_cb)] = g[i];
      }
    }
    if (c0 == 0) cp_async_wait_all();
    __syncthreads();
    fft<false>(buf, p.log_h, cb, pitch, p.tw_h);
    __syncthreads();
#pragma unroll 1
    for (int e = tid; e < (H << log_cb); e += kThreads) {
      const int cc = c0 + (e & (cb - 1));
      if (s_first + cc) {
        const int hh = e >> log_cb, o = (hh << log_nk) + cc;
        const float av = __ldg(&p.a[static_cast<int64_t>(hh) * wh + s_first + cc]);  // an L2 hit
        float2& y = buf[(e & (cb - 1)) * pitch + hh];
        y = make_float2(av * y.x + cs[o], av * y.y + cs[(H << log_nk) + o]);
      }
    }
    if (k0 == 0) {
      // slot 0: rows m and -m of the packed transform give bins 0 and W/2
      // (each the transform of a real column, so Hermitian), each is blended,
      // and only the Hermitian part of each blend is kept, since only the
      // real part of its inverse is used; packed again as bin0 + i bin(W/2)
      for (int m = tid; m <= H / 2; m += kThreads) {
        const int mn = (H - m) & (H - 1);
        const float2 fp = buf[m], fn = buf[mn];
        const float2 y0 = make_float2(0.5f * (fp.x + fn.x), 0.5f * (fp.y - fn.y));
        const float2 yn = make_float2(0.5f * (fp.y + fn.y), -0.5f * (fp.x - fn.x));
        const int64_t om = (b * H + m) * wh, on = (b * H + mn) * wh;
        const float* am = p.a + static_cast<int64_t>(m) * wh;
        const float* an = p.a + static_cast<int64_t>(mn) * wh;
        // blends at (m, 0), (-m, 0), (m, W/2), (-m, W/2); Y(-m) = conj(Y(m))
        const float2 h0m = make_float2(am[0] * y0.x + p.cr[om], am[0] * y0.y + p.ci[om]);
        const float2 h0n = make_float2(an[0] * y0.x + p.cr[on], -an[0] * y0.y + p.ci[on]);
        const float2 hnm = make_float2(am[W / 2] * yn.x + p.cr[om + W / 2], am[W / 2] * yn.y + p.ci[om + W / 2]);
        const float2 hnn = make_float2(an[W / 2] * yn.x + p.cr[on + W / 2], -an[W / 2] * yn.y + p.ci[on + W / 2]);
        const float2 e0 = make_float2(0.5f * (h0m.x + h0n.x), 0.5f * (h0m.y - h0n.y));
        const float2 en = make_float2(0.5f * (hnm.x + hnn.x), 0.5f * (hnm.y - hnn.y));
        buf[m] = make_float2(e0.x - en.y, e0.y + en.x);
        buf[mn] = make_float2(e0.x + en.y, en.x - e0.y);
      }
    }
    __syncthreads();
    if (c0 + cb >= nk && tid == 0) {  // C is read: load w again for phase 3
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(bar, row_bytes);
      bulk_load(wk, p.w + row0 * W, row_bytes, bar);
    }
    fft<true>(buf, p.log_h, cb, pitch, p.tw_h);
    __syncthreads();
#pragma unroll 1
    for (int e = tid; e < (H << log_cb); e += kThreads) {
      const int hh = e >> log_cb, k = k0 + (e & (cb - 1));
      const float2 x = buf[(e & (cb - 1)) * pitch + hh];
      float2* dst = ((ADMM_CLUSTER_SHORTCUT & 1) ? spec : cluster.map_shared_rank(spec, hh / R)) + (hh % R) * wh;
      if (k) {
        dst[k] = make_float2(x.x * inv_h, x.y * inv_h);
      } else {  // the real parts of the inverses of bins 0 and W/2
        dst[0] = make_float2(x.x * inv_h, 0.f);
        dst[W / 2] = make_float2(x.y * inv_h, 0.f);
      }
    }
    __syncthreads();
  }
  cluster.sync();

  // -- 3: synthesis of row pairs, |.|, soft and the dual ---------------------
  const float inv_w = 1.f / static_cast<float>(W);
  if (ADMM_CLUSTER_PHASES < 3) {
    for (int e = tid; e < R * W; e += kThreads) {
      p.z_out[row0 * W + e] = wk[e];
      p.w_out[row0 * W + e] = wk[e];
    }
  }
  if (ADMM_CLUSTER_PHASES >= 3) mbar_wait(bar, 1);
  for (int p0 = 0; p0 < pairs && ADMM_CLUSTER_PHASES >= 3; p0 += batch) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      if (e < (batch << p.log_w)) {
        const int ra = 2 * p0 + 2 * (e >> p.log_w), k = e & (W - 1);
        const int kk = k < wh ? k : W - k;
        float2 xa = spec[ra * wh + kk], xb = spec[(ra + 1) * wh + kk];  // bins 0, W/2: real
        if (k >= wh) {
          xa.y = -xa.y;
          xb.y = -xb.y;
        }
        buf[e] = make_float2(xa.x - xb.y, xa.y + xb.x);  // X_a + i X_b
      }
    }
    __syncthreads();
    fft<true>(buf, p.log_w, batch, W, p.tw_w);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      if (e < (batch << p.log_w)) {
        const int rr = 2 * p0 + 2 * (e >> p.log_w), j = e & (W - 1);
        const float2 v = buf[e];
        const float xa = fabsf(v.x * inv_w), xb = fabsf(v.y * inv_w);
        const float wa = wk[rr * W + j], wb = wk[(rr + 1) * W + j];
        const float za = soft(xa + wa, p.thr), zb = soft(xb + wb, p.thr);
        const int64_t o = (row0 + rr) * W + j;
        p.z_out[o] = za;
        p.w_out[o] = (wa + xa) - za;
        p.z_out[o + W] = zb;
        p.w_out[o + W] = (wb + xb) - zb;
      }
    }
    __syncthreads();
  }
}

struct DeviceState {
  cudaError_t err = cudaSuccess;
  int smem_block = 0;  // opt-in shared memory a block may use
  int smem_sm = 0;     // shared memory of an SM
  int smem_reserved = 0;  // shared memory the system keeps per block
};

// The current device's limits, read, and the kernel's shared-memory limit
// raised to the block maximum, once per process and device.
const DeviceState& device_state(int* dev_out) {
  static std::once_flag once[kMaxDevices];
  static DeviceState state[kMaxDevices];
  static DeviceState bad_device{cudaErrorInvalidDevice};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev < 0 || dev >= kMaxDevices) return bad_device;
  std::call_once(once[dev], [dev] {
    DeviceState& s = state[dev];
    s.err = cudaDeviceGetAttribute(&s.smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (s.err == cudaSuccess)
      s.err = cudaDeviceGetAttribute(&s.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (s.err == cudaSuccess)
      s.err = cudaDeviceGetAttribute(&s.smem_reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
    if (s.err == cudaSuccess)
      s.err = cudaFuncSetAttribute(cluster_iteration, cudaFuncAttributeMaxDynamicSharedMemorySize, s.smem_block);
  });
  if (dev_out) *dev_out = dev;
  return state[dev];
}

bool shape_ok(int h, int w, int q) {
  auto pow2 = [](int n) { return n > 0 && (n & (n - 1)) == 0; };
  return pow2(h) && pow2(w) && h >= 8 && w >= 8 && h <= kWork / 2 && w <= kWork / 2 &&
         (q == 1 || q == 2 || q == 4 || q == 8) &&
         h >= 2 * q && w / 2 >= q;
}

int log2i(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

cudaLaunchConfig_t launch_config(int64_t batch, int h, int w, int q, cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch * q));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = cluster_smem(h, w, q);
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// The current device's shared memory: a block's opt-in limit, an SM's, and
// what the system reserves per block (bytes). Returns a cudaError.
int admm_iteration_cluster_limits(int* smem_block, int* smem_sm, int* smem_reserved) {
  const DeviceState& s = device_state(nullptr);
  *smem_block = s.smem_block;
  *smem_sm = s.smem_sm;
  *smem_reserved = s.smem_reserved;
  return static_cast<int>(s.err);
}

// Dynamic shared memory of one block for (H, W) and Q blocks per cluster.
int64_t admm_iteration_cluster_smem(int h, int w, int q) {
  return shape_ok(h, w, q) ? static_cast<int64_t>(cluster_smem(h, w, q)) : -1;
}

// Clusters of Q blocks that can be resident at once on the current device
// (cudaOccupancyMaxActiveClusters), or a negative cudaError.
int admm_iteration_cluster_active(int h, int w, int q) {
  if (!shape_ok(h, w, q)) return -static_cast<int>(cudaErrorInvalidValue);
  const DeviceState& s = device_state(nullptr);
  if (s.err != cudaSuccess) return -static_cast<int>(s.err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(1, h, w, q, nullptr, attr);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, cluster_iteration, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// One iteration of `batch` images: z, w (batch x H x W) to z', w'. tw_w, tw_h:
// the twiddle tables (W and H complex values); A (H x Wh); Cr, Ci (batch x H
// x Wh). H, W powers of two; q blocks per cluster.
int admm_iteration_cluster_f32(const void* z, const void* w, const void* tw_w, const void* tw_h, const void* a,
                               const void* cr, const void* ci, void* z_out, void* w_out, float thr, int64_t batch,
                               int h, int width, int q, void* stream) {
  if (batch <= 0) return cudaSuccess;
  if (!shape_ok(h, width, q)) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceState& s = device_state(nullptr);
  if (s.err != cudaSuccess) return static_cast<int>(s.err);
  if (cluster_smem(h, width, q) > static_cast<size_t>(s.smem_block)) return static_cast<int>(cudaErrorInvalidValue);
  Args p{static_cast<const float*>(z), static_cast<const float*>(w), static_cast<const float2*>(tw_w),
         static_cast<const float2*>(tw_h), static_cast<const float*>(a), static_cast<const float*>(cr),
         static_cast<const float*>(ci), static_cast<float*>(z_out), static_cast<float*>(w_out), thr,
         log2i(h), log2i(width), q};
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(batch, h, width, q, static_cast<cudaStream_t>(stream), attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, cluster_iteration, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
