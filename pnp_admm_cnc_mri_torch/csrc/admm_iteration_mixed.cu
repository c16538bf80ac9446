// One whole ADMM-L1 iteration in one launch, one thread-block cluster per
// image, with mixed-radix FFTs, for sm_90a (float32).
//
// Replaces the Pallas TPU kernel of pnp_admm_cnc_mri_tpu/ops/pallas_dc.py:
// make_fused_iteration (:83, body _iteration_kernel :38), for the images
// that csrc/admm_iteration_cluster.cu does not take: H and W whose prime
// factors are 2, 3, 5 and 7 (320, 384, 448, 640, 300, ...) and powers of two
// whose half spectrum needs more than 8 blocks (512 x 512, 1024 x 256). For
// a batch of (H, W) images, Wh = W/2 + 1:
//
//   v  = z - w
//   V  = rfft2(v)                                  (H x Wh)
//   Hb = A .* V + C                                A real (H, Wh), C per image
//   x  = |Re irfft2(Hb)|                           bins 0 and W/2 weighed once, / H, / W
//   z' = soft(x + w, thr),  w' = (w + x) - z'
//
// Bound: bytes, as for the cluster design. Reading z, w, Cr, Ci and writing
// z', w' moves 4 (4 H W + 2 H Wh) bytes an image (1.05 GB a step at 512 x
// 320 x 320, 0.31 ms at 3.35 TB/s); the FFTs, blend and tail are about 5 H W
// log2(H W) flops, under a fifth of that time on the CUDA cores. Every
// intermediate stays on chip; each input is read once but w, read twice.
//
// Design: that of admm_iteration_cluster.cu (its notes hold here), with the
// power-of-two arithmetic replaced:
//
// - Q (1 to 16, chosen by the caller, fused_dc.mixed_size) divides H; block
//   r owns rows [r R, (r + 1) R), R = H / Q, which may be odd: the last row
//   of an odd R is transformed alone, as v_a + i 0. The W/2 column slots
//   split as evenly as they go: block r owns [floor(r S / Q), floor((r + 1)
//   S / Q)), S = W/2. Q above 8 is a non-portable cluster size, allowed by
//   the kernel's attribute.
// - Layout: the rows of z land 16-byte aligned at the tail of the spectrum
//   buffer, 8 R' bytes in (R' = R rounded up to even), so a spectrum row i,
//   which ends (4W + 8)(i + 1) bytes in, never reaches z row i + 1. w's
//   buffer holds R W floats or the 2 H ceil(S/Q) of the block's Cr and Ci,
//   whichever is more. Rows come by cp.async.bulk when both ends and the
//   size are 16-byte aligned, else by plain loads.
// - FFTs: Stockham autosort in place, stages of radix 4 (while 4 divides),
//   one 2, then 3, 5 and 7 (the caller's plan, one radix a nibble). Stage of
//   radix r at span ns: butterfly j of a sequence (m = n / r of them) takes
//   x[j + q m], twiddles them by tw[q k (n / (ns r))] (k = j mod ns), runs
//   the r-point DFT and writes x[(j - k) r + k + q ns]. A sequence belongs to
//   a group of g threads, g the least power of two that holds every stage
//   with at most 8 values a thread (4 butterflies of radix 2, 2 of radix 3
//   or 4, 1 of radix 5 or 7); a stage loads, syncs the group (the warp's
//   sync up to g = 32, a named barrier above), computes, stores and syncs
//   again, so a block runs 512 / g sequences at once. Stage constants come
//   without runtime division (n / ns kept as the stages go, j mod ns by a
//   float reciprocal, corrected). The twiddle table is the cluster design's,
//   exp(-2 pi i t / n) from integer t in double precision, conjugated for
//   the inverse; the 3-, 5- and 7-point DFTs use cos and sin of 2 pi t / r as
//   float literals. No __sinf.
// - Rows: group s packs, transforms and separates unit s of a batch; only
//   the read of z before the spectrum is written syncs the block. Columns:
//   gathered and scattered across the cluster as in the cluster design, in
//   batches of a power of two of slots at pitch H | 1 (odd, so a warp's
//   accesses along a row of the batch and down a column fall on distinct
//   banks, for odd H too); column cc is the FFT's group cc.
// - Registers: the kernel is instantiated per set of odd radices (8), so a
//   shape compiles only the DFTs it runs, and per blocks an SM: 64
//   registers a thread where two blocks' shared memory fits an SM, 128 where
//   only one does. The slot-0 blend runs out of line (blend_slot0): inline,
//   its pointers pushed the column loop's values to local memory, which the
//   shared-memory carve-out leaves little L1 for.
//
// Numerics: built without --fmad=false (held to a tolerance against the
// plain step in float64). soft() keeps NaN; a NaN spreads through its own
// image only, since a cluster holds one image. One owner per output and no
// atomics, so two launches are bitwise equal.
//
// Interface: plain C, called through ctypes, the cluster library's. The
// launch runs on the given stream, does not synchronise, and returns
// cudaGetLastError() (or the launch's own error). The device's limits are
// read, and the kernel's attributes set, once per process and device.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <initializer_list>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

// Threads a block, and the complex values of the block's work buffer (kWork,
// and kPad more for the columns' padded pitch). H and W are at most kMaxSide.
constexpr int kThreads = 512;
constexpr int kWork = 4096;
constexpr int kPad = 64;
constexpr int kMaxSide = 2048;
constexpr int kMaxQ = 16;
constexpr int kMaxColumnBatch = 64;
// Probe builds only (probes/k3_probe.py), to time the phases by difference:
// ADMM_MIXED_PHASES = 0, 1 or 2 stops after that phase and writes w as z'
// and w'. It gives wrong results; the library runs as below.
#ifndef ADMM_MIXED_PHASES
#define ADMM_MIXED_PHASES 3
#endif
constexpr int kValues = 8;  // complex values a thread holds in an FFT stage
// Butterflies of radix r a thread holds in a stage: at most kValues values.
__host__ __device__ constexpr int per_thread(int r) { return kValues / r > 1 ? kValues / r : 1; }
// The odd radices a kernel instantiation runs, a bit each: an instantiation
// compiles only the stages its shapes need, so the 5- and 7-point DFTs' live
// values do not push the power-of-two path's registers to local memory.
constexpr int kRadix3 = 1, kRadix5 = 2, kRadix7 = 4;
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

// cos and sin of 2 pi t / r for the odd radices, t in [1, r/2]
__device__ __forceinline__ constexpr float rot_cos(int r, int t) {
  return r == 3 ? -0.5f
         : r == 5 ? (t == 1 ? 0.30901699437494745f : -0.80901699437494734f)
                  : (t == 1 ? 0.62348980185873359f : t == 2 ? -0.22252093395631434f : -0.90096886790241903f);
}
__device__ __forceinline__ constexpr float rot_sin(int r, int t) {
  return r == 3 ? 0.86602540378443871f
         : r == 5 ? (t == 1 ? 0.95105651629515353f : 0.58778525229247325f)
                  : (t == 1 ? 0.78183148246802980f : t == 2 ? 0.97492791218182362f : 0.43388373911755823f);
}

// The R-point DFT of u in place: y_k = sum_q u_q exp(-+ 2 pi i q k / R)
// (the inverse takes +).
template <int R, bool INV>
__device__ __forceinline__ void dft(float2* u) {
  if constexpr (R == 2) {
    const float2 a = u[0], b = u[1];
    u[0] = make_float2(a.x + b.x, a.y + b.y);
    u[1] = make_float2(a.x - b.x, a.y - b.y);
  } else if constexpr (R == 4) {
    // forward: y1 = u0 - i u1 - u2 + i u3; the inverse flips the signs of i
    const float2 s02 = make_float2(u[0].x + u[2].x, u[0].y + u[2].y);
    const float2 d02 = make_float2(u[0].x - u[2].x, u[0].y - u[2].y);
    const float2 s13 = make_float2(u[1].x + u[3].x, u[1].y + u[3].y);
    const float2 d13 = make_float2(u[1].x - u[3].x, u[1].y - u[3].y);
    const float2 rot = INV ? make_float2(-d13.y, d13.x) : make_float2(d13.y, -d13.x);  // -+ i d13
    u[0] = make_float2(s02.x + s13.x, s02.y + s13.y);
    u[1] = make_float2(d02.x + rot.x, d02.y + rot.y);
    u[2] = make_float2(s02.x - s13.x, s02.y - s13.y);
    u[3] = make_float2(d02.x - rot.x, d02.y - rot.y);
  } else {
    // odd R: with s_q = u_q + u_{R-q}, d_q = u_q - u_{R-q} (q = 1..R/2),
    // y_k = u_0 + sum_q cos(2 pi q k / R) s_q -+ i sum_q sin(2 pi q k / R) d_q,
    // and y_{R-k} the same with the sign of the sine part flipped
    constexpr int H = R / 2;
    float2 s[H], d[H];
    float2 y0 = u[0];
#pragma unroll
    for (int q = 1; q <= H; ++q) {
      s[q - 1] = make_float2(u[q].x + u[R - q].x, u[q].y + u[R - q].y);
      d[q - 1] = make_float2(u[q].x - u[R - q].x, u[q].y - u[R - q].y);
      y0.x += s[q - 1].x;
      y0.y += s[q - 1].y;
    }
    const float2 u0 = u[0];
    u[0] = y0;
#pragma unroll
    for (int k = 1; k <= H; ++k) {
      float2 a = u0, b = make_float2(0.f, 0.f);
#pragma unroll
      for (int q = 1; q <= H; ++q) {
        const int t = (q * k) % R;  // the angle 2 pi t / R, folded to t <= R/2
        const float c = rot_cos(R, t <= H ? t : R - t);
        const float sn = t <= H ? rot_sin(R, t) : -rot_sin(R, R - t);
        a.x += c * s[q - 1].x;
        a.y += c * s[q - 1].y;
        b.x += sn * d[q - 1].x;
        b.y += sn * d[q - 1].y;
      }
      // forward: y_k = a - i b, y_{R-k} = a + i b; the inverse swaps them
      const float2 minus = make_float2(a.x + b.y, a.y - b.x), plus = make_float2(a.x - b.y, a.y + b.x);
      u[k] = INV ? plus : minus;
      u[R - k] = INV ? minus : plus;
    }
  }
}

// Division by a runtime d of x with x d < 2^32: floor(x / d) = umulhi(x,
// magic(d)), magic(d) = ceil(2^32 / d); d = 1 is x itself.
__host__ __device__ __forceinline__ unsigned magic(unsigned d) { return d > 1 ? 0xFFFFFFFFu / d + 1 : 0; }
__device__ __forceinline__ int fast_div(int x, int d, unsigned m) {
  return d > 1 ? static_cast<int>(__umulhi(static_cast<unsigned>(x), m)) : x;
}

// The sync of a group of 2^log_g threads that owns one sequence: the warp's
// where a group fits in a warp, else named barrier 1 + group among the
// group's threads (at most 8 groups of 64 or more in a block).
__device__ __forceinline__ void group_sync(int log_g) {
  if (log_g <= 5) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + (static_cast<int>(threadIdx.x) >> log_g)), "r"(1 << log_g)
                 : "memory");
  }
}

// j mod ns for j, ns < 2^16 from inv = 1 / ns in float: the quotient's
// float estimate is off by at most one, and is corrected.
__device__ __forceinline__ int mod_by(int j, int ns, float inv) {
  int r = j - __float2int_rz(static_cast<float>(j) * inv) * ns;
  r += r < 0 ? ns : 0;
  return r >= ns ? r - ns : r;
}

// One Stockham stage of radix R at span ns of a sequence of length n at x,
// owned by the g = 2^log_g threads of a group (lane lt); butterfly j = lt + c
// g. rest = n / ns; inv_ns = 1 / ns. Every thread of the group calls it;
// `active` is false for a group with no sequence in this batch.
template <int R, bool INV>
__device__ __forceinline__ void stage(float2* x, int n, int ns, int rest, float inv_ns, int log_g, int lt,
                                      bool active, const float2* __restrict__ tw) {
  constexpr int P = per_thread(R);  // butterflies a thread
  const int m = n / R, stride = rest / R, g = 1 << log_g;  // R is a constant: no division
  float2 v[P][R];
  if (active) {
#pragma unroll
    for (int c = 0; c < P; ++c) {
      const int j = lt + c * g;
      if (j < m) {
#pragma unroll
        for (int q = 0; q < R; ++q) v[c][q] = x[j + q * m];
      }
    }
  }
  group_sync(log_g);
  if (active) {
#pragma unroll
    for (int c = 0; c < P; ++c) {
      const int j = lt + c * g;
      if (j < m) {
        const int k = mod_by(j, ns, inv_ns);
        if (k > 0) {  // k = 0: the twiddles are 1
#pragma unroll
          for (int q = 1; q < R; ++q) {
            float2 wq = __ldg(&tw[q * k * stride]);
            if (INV) wq.y = -wq.y;
            v[c][q] = cmul(v[c][q], wq);
          }
        }
        dft<R, INV>(v[c]);
        const int d = (j - k) * R + k;
#pragma unroll
        for (int q = 0; q < R; ++q) x[d + q * ns] = v[c][q];
      }
    }
  }
  group_sync(log_g);
}

// Complex FFTs of length n in place in shared memory: group s (2^log_g
// threads, the caller's choice for n, fft_plan_of below) transforms the
// sequence at a + s * pitch if s < count. `plan` holds the radices, one a
// nibble from the lowest; ODD names the odd ones compiled. Every thread of
// the block calls it; each group ends synced.
template <bool INV, int ODD>
__device__ __forceinline__ void fft(float2* a, uint64_t plan, int n, int log_g, int count, int pitch,
                                    const float2* __restrict__ tw) {
  const int s = static_cast<int>(threadIdx.x) >> log_g, lt = static_cast<int>(threadIdx.x) & ((1 << log_g) - 1);
  const bool active = s < count;
  float2* x = a + s * pitch;
  for (int ns = 1, rest = n, st = 0; ns < n && st < 16; plan >>= 4, ++st) {  // at most 16 stages: never spins
    const int r = static_cast<int>(plan & 15);
    if (r < 2) break;
    const float inv_ns = 1.f / static_cast<float>(ns);
    switch (r) {
      case 4:
        stage<4, INV>(x, n, ns, rest, inv_ns, log_g, lt, active, tw);
        rest /= 4;  // divisions by constants only
        break;
      case 2:
        stage<2, INV>(x, n, ns, rest, inv_ns, log_g, lt, active, tw);
        rest /= 2;
        break;
      case 3:
        if constexpr ((ODD & kRadix3) != 0) stage<3, INV>(x, n, ns, rest, inv_ns, log_g, lt, active, tw);
        rest /= 3;
        break;
      case 5:
        if constexpr ((ODD & kRadix5) != 0) stage<5, INV>(x, n, ns, rest, inv_ns, log_g, lt, active, tw);
        rest /= 5;
        break;
      default:
        if constexpr ((ODD & kRadix7) != 0) stage<7, INV>(x, n, ns, rest, inv_ns, log_g, lt, active, tw);
        rest /= 7;
        break;
    }
    ns *= r;
  }
}

// The FFT plan of n (radix 4 while 4 divides, one 2, then 3, 5, 7), one
// radix a nibble, and log2 of the threads a sequence: the least power of
// two g with ceil((n / r) / per_thread(r)) <= g at every stage. So a block
// of 512 runs 512 / g sequences at once, and 512 / g * n <= 4096 values, the
// work buffer. False where n has a prime factor above 7.
bool fft_plan_of(int n, uint64_t* plan, int* log_group) {
  uint64_t code = 0;
  int shift = 0, need = 1;
  const int n0 = n;
  for (int r : {4, 2, 3, 5, 7}) {
    while (n % r == 0 && n > 1) {
      code |= static_cast<uint64_t>(r) << shift;
      shift += 4;
      n /= r;
      need = std::max(need, (n0 / r + per_thread(r) - 1) / per_thread(r));
    }
  }
  int lg = 0;
  while ((1 << lg) < need) ++lg;
  *plan = code;
  *log_group = lg;
  return n == 1 && shift > 0 && shift <= 60 && lg <= 9;
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
  int height;
  int width;
  int q;  // blocks per cluster
  uint64_t plan_w, plan_h;
  int log_gw, log_gh;  // log2 of the threads an FFT of length W, H
  int spec_bytes;      // the spectrum buffer (z at its tail)
  int wbuf_bytes;      // w's buffer, or the block's Cr and Ci
  // Per-shape constants, computed once by the caller (args_for) so that the
  // kernel reads them as parameters instead of holding them in registers:
  int rows;           // R = H / Q
  unsigned magic_rows;  // magic(R)
  int wh;             // W / 2 + 1
  int slots;          // S = W / 2
  int units;          // row pairs a block, (R + 1) / 2
  int row_batch;      // units a batch: 512 / the row FFT's group
  int col_batch;      // slots a batch, a power of two
  int log_col_batch;
  int col_elems;      // H col_batch
  int pitch;          // H | 1
  float inv_h, inv_w;
};

inline int round16(int n) { return (n + 15) / 16 * 16; }

// The block's buffers (bytes): the spectrum with z's rows at its tail, and
// w's rows or the block's slots of Cr and Ci.
inline int spec_bytes_of(int h, int w, int q) {
  const int r = h / q;
  return round16(8 * (r + (r & 1)) + 4 * w * r);
}
inline int wbuf_bytes_of(int h, int w, int q) {
  const int r = h / q, nk = (w / 2 + q - 1) / q;
  return round16(4 * std::max(r * w, 2 * h * nk));
}

// Shared memory of a block: the mbarrier, the spectrum, w's buffer, the work buffer.
inline size_t mixed_smem(int h, int w, int q) {
  return 16 + static_cast<size_t>(spec_bytes_of(h, w, q)) + wbuf_bytes_of(h, w, q) + size_t{kWork + kPad} * 8;
}

// Whether a bulk copy may take these rows: both ends and the size 16-byte
// aligned (uniform over the block).
__device__ __forceinline__ bool aligned_rows(const float* src, const void* dst, unsigned bytes) {
  return ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) | bytes) & 15) == 0;
}

// Slot 0 of a column batch: rows m and -m of the packed transform give bins
// 0 and W/2 (each the transform of a real column, so Hermitian), each is
// blended, and only the Hermitian part of each blend is kept, since only the
// real part of its inverse is used; packed again as bin0 + i bin(W/2). Out
// of line: one block an image runs it once, and inline its pointers would
// crowd the column loop's registers. cr, ci: the image's C.
__device__ __noinline__ void blend_slot0(float2* buf, const float* __restrict__ a, const float* __restrict__ cr,
                                         const float* __restrict__ ci, int H, int wh) {
  const int S = wh - 1;
  for (int m = threadIdx.x; m <= H / 2; m += kThreads) {
    const int mn = m ? H - m : 0;
    const float2 fp = buf[m], fn = buf[mn];
    const float2 y0 = make_float2(0.5f * (fp.x + fn.x), 0.5f * (fp.y - fn.y));
    const float2 yn = make_float2(0.5f * (fp.y + fn.y), -0.5f * (fp.x - fn.x));
    const int om = m * wh, on = mn * wh;
    // blends at (m, 0), (-m, 0), (m, W/2), (-m, W/2); Y(-m) = conj(Y(m))
    const float2 h0m = make_float2(a[om] * y0.x + cr[om], a[om] * y0.y + ci[om]);
    const float2 h0n = make_float2(a[on] * y0.x + cr[on], -a[on] * y0.y + ci[on]);
    const float2 hnm = make_float2(a[om + S] * yn.x + cr[om + S], a[om + S] * yn.y + ci[om + S]);
    const float2 hnn = make_float2(a[on + S] * yn.x + cr[on + S], -a[on + S] * yn.y + ci[on + S]);
    const float2 e0 = make_float2(0.5f * (h0m.x + h0n.x), 0.5f * (h0m.y - h0n.y));
    const float2 en = make_float2(0.5f * (hnm.x + hnn.x), 0.5f * (hnm.y - hnn.y));
    buf[m] = make_float2(e0.x - en.y, e0.y + en.x);
    buf[mn] = make_float2(e0.x + en.y, en.x - e0.y);
  }
}

// MIN_BLOCKS blocks an SM: 2 caps a thread at 64 registers, where two
// blocks' shared memory fits an SM; 1 gives it 128, where one block's does.
template <int ODD, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS) mixed_iteration(Args p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t b = blockIdx.x / p.q;
  const int H = p.height, W = p.width, wh = p.wh, S = p.slots;
  const int R = p.rows;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  auto bar = reinterpret_cast<uint64_t*>(smem);
  auto spec = reinterpret_cast<float2*>(smem + 16);                               // [R][Wh]
  auto wk = reinterpret_cast<float*>(smem + 16 + p.spec_bytes);                  // [R][W]
  auto buf = reinterpret_cast<float2*>(smem + 16 + p.spec_bytes + p.wbuf_bytes);  // [kWork + kPad]
  float* zs = reinterpret_cast<float*>(spec) + 2 * (R + (R & 1));                // [R][W], the tail of spec

  const int64_t row0 = b * H + static_cast<int64_t>(rank) * R;
  const unsigned row_bytes = static_cast<unsigned>(R) * W * sizeof(float);
  const float* z_src = p.z + row0 * W;
  const float* w_src = p.w + row0 * W;
  const bool bulk = aligned_rows(z_src, zs, row_bytes) && aligned_rows(w_src, wk, row_bytes);
  if (tid == 0) mbar_init(bar, 1);
  __syncthreads();
  if (bulk) {
    if (tid == 0) {
      mbar_expect_tx(bar, 2 * row_bytes);
      bulk_load(zs, z_src, row_bytes, bar);
      bulk_load(wk, w_src, row_bytes, bar);
    }
    mbar_wait(bar, 0);
  } else {
    for (int e = tid; e < R * W; e += kThreads) {
      zs[e] = z_src[e];
      wk[e] = w_src[e];
    }
    __syncthreads();
  }

  // -- 1: forward row transforms, two real rows per complex FFT ------------
  // units of rows 2u and 2u + 1 (the second absent for the last of an odd R);
  // group s of the row FFT's groups takes unit u0 + s of a batch
  const int units = p.units;
  const int log_gw = p.log_gw, gw = 1 << log_gw, per_batch_w = p.row_batch;
  const int sw = tid >> log_gw, lw = tid & (gw - 1);
  for (int u0 = 0; u0 < units && ADMM_MIXED_PHASES >= 1; u0 += per_batch_w) {
    const int nb = min(per_batch_w, units - u0), ra = 2 * (u0 + sw);
    float2* x = buf + sw * W;
    if (sw < nb) {
      for (int col = lw; col < W; col += gw) {
        const int o = ra * W + col;
        x[col] = make_float2(zs[o] - wk[o], ra + 1 < R ? zs[o + W] - wk[o + W] : 0.f);
      }
    }
    __syncthreads();  // every row of z of the batch is read before a spectrum row is written
    fft<false, ODD>(buf, p.plan_w, W, log_gw, nb, W, p.tw_w);
    if (sw < nb) {
      for (int k = lw; k < wh; k += gw) {
        const float2 u = x[k], m = x[k ? W - k : 0];
        // V_a = (u + conj(m)) / 2, V_b = (u - conj(m)) / 2i
        spec[ra * wh + k] = make_float2(0.5f * (u.x + m.x), 0.5f * (u.y - m.y));
        if (ra + 1 < R) spec[(ra + 1) * wh + k] = make_float2(0.5f * (u.y + m.y), -0.5f * (u.x - m.x));
      }
    }
    group_sync(log_gw);
  }
  __syncthreads();

  // The Wh bins make S = W/2 column slots: slot 0 holds bins 0 and W/2,
  // whose row transforms are real, as one complex column bin0 + i bin(W/2);
  // slot k > 0 is bin k. The block owns slots [s_first, s_first + nk).
  // Their Cr and Ci are copied now into w's buffer, free until phase 3 loads
  // w again: cs[plane][row][slot - s_first]. Slot 0 reads its bins of C where
  // it blends them.
  const int s_first = rank * S / p.q, nk = (rank + 1) * S / p.q - s_first;
  const unsigned magic_nk = magic(nk);
  float* cs = wk;
  for (int e = tid; e < 2 * H * nk && ADMM_MIXED_PHASES >= 2; e += kThreads) {
    const int plane = e >= H * nk, rem = e - plane * H * nk;
    const int hh = fast_div(rem, nk, magic_nk), k = s_first + rem - hh * nk;
    if (k) cp_async4(&cs[e], (plane ? p.ci : p.cr) + (b * H + hh) * wh + k);
  }
  cluster.sync();

  // -- 2: column transforms and the blend, over this block's column slots ---
  // in batches of a power of two cb (at most the column FFT's groups); column
  // cc of a batch at buf + cc pitch, the FFT's group cc
  const int log_gh = p.log_gh, cb = p.col_batch, log_cb = p.log_col_batch, pitch = p.pitch;
  const float inv_h = p.inv_h;
  const int n_el = p.col_elems;
  for (int c0 = 0; c0 < nk && ADMM_MIXED_PHASES >= 2; c0 += cb) {
    const int k0 = s_first + c0, ncol = min(cb, nk - c0);  // element (row hh, slot k0 + cc): e = hh cb + cc
    for (int e0 = 0; e0 < n_el; e0 += 2 * kThreads) {  // two loads in flight a thread
      float2 g[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = e0 + tid + i * kThreads, cc = e & (cb - 1);
        if (e < n_el && cc < ncol) {
          const int hh = e >> log_cb, k = k0 + cc, owner = fast_div(hh, R, p.magic_rows);
          const float2* src = cluster.map_shared_rank(spec, owner) + (hh - owner * R) * wh;
          g[i] = k ? src[k] : make_float2(src[0].x, src[S].x);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = e0 + tid + i * kThreads, cc = e & (cb - 1);
        if (e < n_el && cc < ncol) buf[cc * pitch + (e >> log_cb)] = g[i];
      }
    }
    if (c0 == 0) cp_async_wait_all();
    __syncthreads();
    fft<false, ODD>(buf, p.plan_h, H, log_gh, ncol, pitch, p.tw_h);
    __syncthreads();
    for (int e = tid; e < n_el; e += kThreads) {
      const int cc = e & (cb - 1);
      if (cc < ncol && k0 + cc) {
        const int hh = e >> log_cb, o = hh * nk + c0 + cc;
        const float av = __ldg(&p.a[static_cast<int64_t>(hh) * wh + k0 + cc]);  // an L2 hit
        float2& y = buf[cc * pitch + hh];
        y = make_float2(av * y.x + cs[o], av * y.y + cs[H * nk + o]);
      }
    }
    if (k0 == 0) blend_slot0(buf, p.a, p.cr + b * H * wh, p.ci + b * H * wh, H, wh);
    __syncthreads();
    fft<true, ODD>(buf, p.plan_h, H, log_gh, ncol, pitch, p.tw_h);
    __syncthreads();
    for (int e = tid; e < n_el; e += kThreads) {
      const int cc = e & (cb - 1);
      if (cc < ncol) {
        const int hh = e >> log_cb, k = k0 + cc, owner = fast_div(hh, R, p.magic_rows);
        const float2 x = buf[cc * pitch + hh];
        float2* dst = cluster.map_shared_rank(spec, owner) + (hh - owner * R) * wh;
        if (k) {
          dst[k] = make_float2(x.x * inv_h, x.y * inv_h);
        } else {  // the real parts of the inverses of bins 0 and W/2
          dst[0] = make_float2(x.x * inv_h, 0.f);
          dst[S] = make_float2(x.y * inv_h, 0.f);
        }
      }
    }
    __syncthreads();
  }
  if (ADMM_MIXED_PHASES >= 2 && tid == 0 && bulk) {  // C is read: load w again for phase 3
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar, row_bytes);
    bulk_load(wk, w_src, row_bytes, bar);
  }
  cluster.sync();

  // -- 3: synthesis of row pairs, |.|, soft and the dual ---------------------
  const float inv_w = p.inv_w;
  if (ADMM_MIXED_PHASES < 3) {
    for (int e = tid; e < R * W; e += kThreads) {
      p.z_out[row0 * W + e] = w_src[e];
      p.w_out[row0 * W + e] = w_src[e];
    }
    if (bulk && ADMM_MIXED_PHASES == 2) mbar_wait(bar, 1);  // no copy in flight at exit
    return;
  }
  if (bulk) {
    mbar_wait(bar, 1);
  } else {
    for (int e = tid; e < R * W; e += kThreads) wk[e] = w_src[e];
    __syncthreads();
  }
  for (int u0 = 0; u0 < units; u0 += per_batch_w) {
    const int nb = min(per_batch_w, units - u0), rr = 2 * (u0 + sw);
    float2* x = buf + sw * W;
    if (sw < nb) {
      for (int k = lw; k < W; k += gw) {
        const int kk = k < wh ? k : W - k;
        float2 xa = spec[rr * wh + kk];  // bins 0, W/2: real
        float2 xb = rr + 1 < R ? spec[(rr + 1) * wh + kk] : make_float2(0.f, 0.f);
        if (k >= wh) {
          xa.y = -xa.y;
          xb.y = -xb.y;
        }
        x[k] = make_float2(xa.x - xb.y, xa.y + xb.x);  // X_a + i X_b
      }
    }
    group_sync(log_gw);
    fft<true, ODD>(buf, p.plan_w, W, log_gw, nb, W, p.tw_w);
    if (sw < nb) {
      for (int j = lw; j < W; j += gw) {
        const float2 v = x[j];
        const int64_t o = (row0 + rr) * W + j;
        const float xa = fabsf(v.x * inv_w), wa = wk[rr * W + j];
        const float za = soft(xa + wa, p.thr);
        p.z_out[o] = za;
        p.w_out[o] = (wa + xa) - za;
        if (rr + 1 < R) {
          const float xb = fabsf(v.y * inv_w), wb = wk[(rr + 1) * W + j];
          const float zb = soft(xb + wb, p.thr);
          p.z_out[o + W] = zb;
          p.w_out[o + W] = (wb + xb) - zb;
        }
      }
    }
    group_sync(log_gw);
  }
}

// The instantiations: by the odd radices of H's and W's plans, and by the
// blocks an SM (index 0: two, 1: one).
using Kernel = void (*)(Args);
#define ADMM_MIXED_KERNELS(M)                                                                              \
  mixed_iteration<0, M>, mixed_iteration<1, M>, mixed_iteration<2, M>, mixed_iteration<3, M>,              \
      mixed_iteration<4, M>, mixed_iteration<5, M>, mixed_iteration<6, M>, mixed_iteration<7, M>
const Kernel kKernels[2][8] = {{ADMM_MIXED_KERNELS(2)}, {ADMM_MIXED_KERNELS(1)}};
#undef ADMM_MIXED_KERNELS

Kernel kernel_for(uint64_t plan_w, uint64_t plan_h, bool two) {
  int odd = 0;
  for (uint64_t plan : {plan_w, plan_h}) {
    for (; plan; plan >>= 4) {
      const int r = static_cast<int>(plan & 15);
      odd |= r == 3 ? kRadix3 : r == 5 ? kRadix5 : r == 7 ? kRadix7 : 0;
    }
  }
  return kKernels[two ? 0 : 1][odd];
}

struct DeviceState {
  cudaError_t err = cudaSuccess;
  int smem_block = 0;     // opt-in shared memory a block may use
  int smem_sm = 0;        // shared memory of an SM
  int smem_reserved = 0;  // shared memory the system keeps per block
};

// The current device's limits, read, and the kernel's shared-memory limit
// raised to the block maximum and non-portable cluster sizes allowed, once
// per process and device.
const DeviceState& device_state() {
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
    for (const auto& row : kKernels) {
      for (Kernel k : row) {
        if (s.err == cudaSuccess)
          s.err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, s.smem_block);
        if (s.err == cudaSuccess) s.err = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      }
    }
  });
  return state[dev];
}

// The shape and Q the kernel takes, with the FFT plans of W and H.
bool shape_ok(int h, int w, int q, uint64_t* plan_w = nullptr, uint64_t* plan_h = nullptr, int* log_gw = nullptr,
              int* log_gh = nullptr) {
  uint64_t pw = 0, ph = 0;
  int gw = 0, gh = 0;
  return h >= 8 && w >= 8 && h <= kMaxSide && w <= kMaxSide && w % 2 == 0 && q >= 1 && q <= kMaxQ &&
         h % q == 0 && q <= w / 2 && fft_plan_of(w, plan_w ? plan_w : &pw, log_gw ? log_gw : &gw) &&
         fft_plan_of(h, plan_h ? plan_h : &ph, log_gh ? log_gh : &gh);
}

bool two_an_sm(int h, int w, int q, const DeviceState& s) {
  return 2 * (mixed_smem(h, w, q) + static_cast<size_t>(s.smem_reserved)) <= static_cast<size_t>(s.smem_sm);
}

cudaLaunchConfig_t launch_config(int64_t batch, int h, int w, int q, cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch * q));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = mixed_smem(h, w, q);
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
int admm_iteration_mixed_limits(int* smem_block, int* smem_sm, int* smem_reserved) {
  const DeviceState& s = device_state();
  *smem_block = s.smem_block;
  *smem_sm = s.smem_sm;
  *smem_reserved = s.smem_reserved;
  return static_cast<int>(s.err);
}

// Dynamic shared memory of one block for (H, W) and Q blocks per cluster,
// or -1 where the kernel does not take them.
int64_t admm_iteration_mixed_smem(int h, int w, int q) {
  return shape_ok(h, w, q) ? static_cast<int64_t>(mixed_smem(h, w, q)) : -1;
}

// Clusters of Q blocks that can be resident at once on the current device
// (cudaOccupancyMaxActiveClusters), 0 where a block does not fit, or a
// negative cudaError.
int admm_iteration_mixed_active(int h, int w, int q) {
  uint64_t plan_w = 0, plan_h = 0;
  int log_gw = 0, log_gh = 0;
  if (!shape_ok(h, w, q, &plan_w, &plan_h, &log_gw, &log_gh)) return -static_cast<int>(cudaErrorInvalidValue);
  const DeviceState& s = device_state();
  if (s.err != cudaSuccess) return -static_cast<int>(s.err);
  if (mixed_smem(h, w, q) > static_cast<size_t>(s.smem_block)) return 0;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(1, h, w, q, nullptr, attr);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kernel_for(plan_w, plan_h, two_an_sm(h, w, q, s)), &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// One iteration of `batch` images: z, w (batch x H x W) to z', w'. tw_w, tw_h:
// the twiddle tables (W and H complex values); A (H x Wh); Cr, Ci (batch x H
// x Wh). H and W with no prime factor above 7, W even; q blocks per cluster,
// q dividing H.
int admm_iteration_mixed_f32(const void* z, const void* w, const void* tw_w, const void* tw_h, const void* a,
                             const void* cr, const void* ci, void* z_out, void* w_out, float thr, int64_t batch,
                             int h, int width, int q, void* stream) {
  if (batch <= 0) return cudaSuccess;
  Args p{static_cast<const float*>(z), static_cast<const float*>(w), static_cast<const float2*>(tw_w),
         static_cast<const float2*>(tw_h), static_cast<const float*>(a), static_cast<const float*>(cr),
         static_cast<const float*>(ci), static_cast<float*>(z_out), static_cast<float*>(w_out), thr,
         h, width, q};
  if (!shape_ok(h, width, q, &p.plan_w, &p.plan_h, &p.log_gw, &p.log_gh)) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceState& s = device_state();
  if (s.err != cudaSuccess) return static_cast<int>(s.err);
  if (mixed_smem(h, width, q) > static_cast<size_t>(s.smem_block)) return static_cast<int>(cudaErrorInvalidValue);
  p.spec_bytes = spec_bytes_of(h, width, q);
  p.wbuf_bytes = wbuf_bytes_of(h, width, q);
  p.rows = h / q;
  p.magic_rows = magic(p.rows);
  p.wh = width / 2 + 1;
  p.slots = width / 2;
  p.units = (p.rows + 1) / 2;
  p.row_batch = kThreads >> p.log_gw;
  // slots a batch: the most the column FFT's groups, the buffer's pad and the
  // block with the most slots take, rounded down to a power of two
  const int most = std::min(std::min((p.slots + q - 1) / q, kThreads >> p.log_gh), kMaxColumnBatch);
  p.col_batch = 1;
  p.log_col_batch = 0;
  while (2 * p.col_batch <= most) {
    p.col_batch *= 2;
    ++p.log_col_batch;
  }
  p.col_elems = h * p.col_batch;
  p.pitch = h | 1;
  p.inv_h = 1.f / static_cast<float>(h);
  p.inv_w = 1.f / static_cast<float>(width);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(batch, h, width, q, static_cast<cudaStream_t>(stream), attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel_for(p.plan_w, p.plan_h, two_an_sm(h, width, q, s)), p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
