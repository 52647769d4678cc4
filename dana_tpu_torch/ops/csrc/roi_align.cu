// RoIAlign over NHWC features for Hopper (sm_90a): one row-pooling body
// behind two float32 entries, and its bfloat16 instance behind a third.
//
//   out[b, r, ph, pw, c] = sum_w Wx[b,r,pw,w] * sum_h Wy[b,r,ph,h] * feat[b,h,w,c]
//
// Replaces the two Pallas TPU kernels of dana_tpu/ops/roi_align_pallas.py,
// which share the body `_matmul_body` (stage 1 over H, stage 2 over W):
//   * `roi_align_fwd_f32` (K2, serving) for `_kernel` (pallas_call in
//     `roi_align_pallas`), which builds Wy and Wx from the rois inside the
//     kernel.  The weights are those of dana_tpu/ops/roi_align.py: rois
//     scaled by `spatial_scale` after a float32 cast, an adaptive sample
//     count per bin axis (floor plus exact-product correction, the ceiling
//     of extent / P without a reciprocal rewrite) capped at `max_samples`,
//     and the bilinear clamp rules of the reference CUDA RoIAlign: a sample
//     outside [-1, size] adds zero, a coordinate below 0 clamps to 0, a low
//     index at size-1 or above collapses onto size-1 with no fractional
//     part.
//   * `roi_align_pw_f32` (K3, training) for `_kernel_pw3` (pallas_call in
//     `roi_align_pallas_pw`): the same contractions of given Wy [B,R,P,H]
//     and Wx [B,R,P,W], which the training step keeps for its backward.
//   * `roi_align_fwd_bf16` (K2 in bfloat16, the precision recipe's
//     serving path), whose arithmetic is that of the JAX package's bf16
//     RoIAlign, the "combine" path of dana_tpu/ops/roi_align.py: every tap
//     (h, w) of bin (ph, pw) weighs bf16(Wy[ph, h] * Wx[pw, w]), the
//     product of the two float32 axis weights rounded to bf16, the sums
//     run in float32 and each output is rounded to bf16 once.  K2's axis
//     weights, taps and ring serve it unchanged; each thread owns 8
//     neighbouring channels (16 bytes of bf16), 128 threads a block, and
//     the combined weights are formed in registers, P a tap.  Bound:
//     bytes, half of float32's (40 MB of map and 241 MB of outputs at the
//     serving shapes, 0.084 ms at 3.35 TB/s).
//
// Bound on this card: bytes.  The function reads the feature map once and
// writes each output once: 80 MB and 482 MB at the serving shapes (8
// images, 38x64x1024 map, 300 rois, 7x7 bins), 0.17 ms at 3.35 TB/s.  The
// weights are zero outside the bilinear taps of one bin row, so the
// operations the data needs are few; what costs is reading the taps'
// feature rows (4 KB each at C = 1024) through L2: about 2.1 GB, 26 times
// the map, at proposal-like rois.  A bin row of a roi that spans the whole
// map keeps up to 23 rows x 64 columns of taps, which its one block
// streams alone: those rows set the kernel's tail.
//
// Design: one block per row of bins (b, r, ph), image-major with ph
// fastest, so the blocks in flight share one image's feature map in L2
// and each block reads every kept (h, w) feature row once for its P bins.
//  1. Taps, in shared memory.  The block holds the dense rows Wy[ph, :]
//     and Wx[:, :] of its roi: K3 copies them, K2 builds them from the roi,
//     each entry summing its samples' low and high weights in sample order
//     as the plain version does, with explicitly rounded float operations
//     (no fused multiply-add, no fast division) so the bin arithmetic is
//     exact.  All warps then compact them with ballots into the kept rows
//     h (Wy nonzero) and kept columns w (some Wx[pw, w] nonzero), and lay
//     the kept rows x kept columns out as one stream of taps, column by
//     column.
//  2. Pooling.  256 threads along the channels, each owning groups of 4
//     neighbouring channels (float4: NHWC makes C contiguous, so every
//     load and store is coalesced).  Each thread copies its taps' 16 bytes
//     into its own column of a ring of D slots in shared memory with
//     cp.async, V taps a step and D - V taps ahead, so the loads in flight
//     cost no registers and three blocks fit an SM; it needs no barrier,
//     since it reads only what it copied.  Stage 1 sums a column's taps
//     times their Wy, stage 2 adds that times Wx[:, w] into P
//     accumulators in registers.  One streaming store of the P outputs
//     ends the row: nothing reads them back before layer4, and they
//     outgrow L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;              // float32: 4 channels a thread
constexpr int THREADS_BF16 = 128;         // bf16: 8 channels a thread
constexpr int D = 8;                        // cp.async ring slots, taps
constexpr int V = 4;                        // taps a step
constexpr int MAX_SAMPLES = 64;             // K2: samples per axis supported
constexpr size_t SMEM_DEFAULT = 48 * 1024;  // above: opt in per kernel
constexpr size_t SMEM_MAX = 227 * 1024;

// 4-byte words of shared memory a block of `threads` uses (`samples`: K2's
// sample capacity per axis, 0 for K3).  `carve` lays them out in this
// order.
__host__ __device__ inline size_t smem_words(int H, int W, int P,
                                             int samples, int threads) {
  return (size_t)4 * D * threads + (size_t)2 * H * W + (size_t)3 * H
      + (size_t)2 * P * W + W + (H + 31) / 32 + (W + 31) / 32
      + (size_t)4 * samples * (1 + P);
}

struct Taps {
  float4* ring;    // [D][threads] each thread's 16-byte slots
  int2* list;      // [n_h * n_w] the taps in pooling order: feature row
                   // offset in 16-byte units (bit 31: the last of its
                   // column), Wy tap (float bits)
  float* wy;       // [H]     dense Wy row of the block's ph
  float* wx;       // [P][W]  dense Wx rows of the roi
  float* hw;       // [H]     kept Wy taps
  int* hoff;       // [H]     their feature rows' offsets, 16-byte units
  float* wxs;      // [W][P]  kept columns' Wx
  int* woff;       // [W]     their offsets, 16-byte units
  unsigned* mask;  // [ceil(H/32) + ceil(W/32)] ballots, rows then columns
  float* samples;  // K2: the roi's bilinear samples
};

__device__ __forceinline__ Taps carve(float* s, int H, int W, int P,
                                      int threads) {
  Taps t;
  t.ring = reinterpret_cast<float4*>(s);
  t.list = reinterpret_cast<int2*>(s + 4 * D * threads);
  t.wy = reinterpret_cast<float*>(t.list + H * W);
  t.wx = t.wy + H;
  t.hw = t.wx + P * W;
  t.hoff = reinterpret_cast<int*>(t.hw + H);
  t.wxs = reinterpret_cast<float*>(t.hoff + H);
  t.woff = reinterpret_cast<int*>(t.wxs + W * P);
  t.mask = reinterpret_cast<unsigned*>(t.woff + W);
  t.samples = reinterpret_cast<float*>(t.mask + (H + 31) / 32 + (W + 31) / 32);
  return t;
}

// Whether entry `lane` of ballot chunk k is kept: chunks below `my` cover
// rows h, the rest columns w.
template <int P>
__device__ __forceinline__ bool kept(const Taps& t, int k, int my, int lane,
                                     int H, int W) {
  if (k < my) {
    const int h = 32 * k + lane;
    return h < H && t.wy[h] != 0.f;
  }
  const int w = 32 * (k - my) + lane;
  bool any = false;
  if (w < W) {
#pragma unroll
    for (int q = 0; q < P; ++q) any |= t.wx[q * W + w] != 0.f;
  }
  return any;
}

// All warps of the NTH threads compact the dense rows into the kept taps,
// in ascending h and w, and lay them out as one stream; -> its length,
// kept rows x kept columns.  cn: 16-byte units of a feature row.  Starts
// with the dense rows visible to the whole block, and ends with the taps.
template <int P, int NTH>
__device__ __forceinline__ int compact(const Taps& t, int H, int W,
                                       int cn) {
  constexpr int WARPS = NTH / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int my = (H + 31) / 32, chunks = my + (W + 31) / 32;
  for (int k = warp; k < chunks; k += WARPS) {
    const unsigned m = __ballot_sync(0xffffffffu, kept<P>(t, k, my, lane, H, W));
    if (lane == 0) t.mask[k] = m;
  }
  __syncthreads();
  for (int k = warp; k < chunks; k += WARPS) {
    if (!kept<P>(t, k, my, lane, H, W)) continue;
    int pos = __popc(t.mask[k] & below);
    for (int k2 = k < my ? 0 : my; k2 < k; ++k2) pos += __popc(t.mask[k2]);
    if (k < my) {
      const int h = 32 * k + lane;
      t.hw[pos] = t.wy[h];
      t.hoff[pos] = h * W * cn;
    } else {
      const int w = 32 * (k - my) + lane;
      t.woff[pos] = w * cn;
#pragma unroll
      for (int q = 0; q < P; ++q) t.wxs[pos * P + q] = t.wx[q * W + w];
    }
  }
  __syncthreads();
  int nh = 0, nw = 0;
  for (int k = 0; k < chunks; ++k) (k < my ? nh : nw) += __popc(t.mask[k]);
  for (int e = threadIdx.x; e < nh * nw; e += NTH) {
    const int j = e / nh, i = e - j * nh;
    t.list[e] = make_int2((t.hoff[i] + t.woff[j]) | (i == nh - 1 ? INT_MIN : 0),
                          __float_as_int(t.hw[i]));
  }
  __syncthreads();
  return nh * nw;
}

__device__ __forceinline__ void fma4(float a, const float4& x, float4& acc) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

// The ring is written by cp.async and read by ld.shared, all volatile asm
// that the compiler keeps in program order, so a slot is read only after
// its wait and overwritten only after its read; the asm declares no
// memory effects, leaving the tap list's loads free to be scheduled early.

// 16 bytes from global to shared memory, asynchronously (L2 only).
__device__ __forceinline__ void cp_async16(unsigned dst, const float4* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ float4 ld_shared4(unsigned src) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(src));
  return v;
}

__device__ __forceinline__ uint4 ld_shared_u4(unsigned src) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(src));
  return v;
}

// The shared body: the P outputs of one row of bins from its taps.
// f4: the image's feature map, o4: the row's [P, C] outputs, in float4s.
template <int P>
__device__ __forceinline__ void pool_row(const float4* __restrict__ f4,
                                         float4* __restrict__ o4,
                                         const Taps& t, int taps, int c4n) {
  constexpr int NG = D / V;                 // copy groups the ring holds
  static_assert(D % V == 0 && NG >= 2, "ring layout");
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int2* list = t.list;
  // this thread's slots: slot k at ring + 16 (k THREADS) bytes
  const unsigned ring = (unsigned)__cvta_generic_to_shared(
      t.ring + threadIdx.x);
  for (int c4 = threadIdx.x; c4 < c4n; c4 += THREADS) {
    float4 acc[P];
#pragma unroll
    for (int q = 0; q < P; ++q) acc[q] = zero;
    float4 s1 = zero;                       // stage 1 of the current column
    int j = 0;                              // the current column
    // one copy group per V taps, empty past the last, so that a step's
    // group is done when at most NG - 1 later groups are in flight
#pragma unroll
    for (int k = 0; k < (NG - 1) * V; ++k) {
      if (k < taps)
        cp_async16(ring + k * THREADS * 16, f4 + (list[k].x & INT_MAX) + c4);
      if (k % V == V - 1) cp_async_commit();
    }
    for (int k = 0; k < taps; k += V) {
#pragma unroll
      for (int u = 0; u < V; ++u) {         // into the slots step k-V freed
        const int ahead = k + (NG - 1) * V + u;
        if (ahead < taps)
          cp_async16(ring + (ahead % D) * THREADS * 16,
                     f4 + (list[ahead].x & INT_MAX) + c4);
      }
      cp_async_commit();
      cp_async_wait<NG - 1>();
#pragma unroll
      for (int u = 0; u < V; ++u) {
        if (k + u >= taps) break;
        const int2 e = list[k + u];
        fma4(__int_as_float(e.y),
             ld_shared4(ring + ((k + u) % D) * THREADS * 16), s1);
        if (e.x < 0) {                      // the column is done: stage 2
#pragma unroll
          for (int q = 0; q < P; ++q) fma4(t.wxs[j * P + q], s1, acc[q]);
          s1 = zero;
          ++j;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < P; ++q) __stcs(o4 + (size_t)q * c4n + c4, acc[q]);
  }
}

// Two floats rounded to bf16, the first in the low half (lower address).
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// The bf16 body: pool_row's ring and tap stream over 8 bf16 channels a
// thread (16 bytes), each tap weighed, for each output bin q of the row, by
// bf16(Wy tap * Wx[q, w]) (see the head of the file).
// f8: the image's feature map, o8: the row's [P, C] outputs, in 16-byte
// units of 8 channels.
template <int P>
__device__ __forceinline__ void pool_row_bf16(const uint4* __restrict__ f8,
                                              uint4* __restrict__ o8,
                                              const Taps& t, int taps,
                                              int c8n) {
  constexpr int NG = D / V;
  const int2* list = t.list;
  const unsigned ring = (unsigned)__cvta_generic_to_shared(
      t.ring + threadIdx.x);
  for (int c8 = threadIdx.x; c8 < c8n; c8 += THREADS_BF16) {
    float acc[P][8];
#pragma unroll
    for (int q = 0; q < P; ++q)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[q][i] = 0.f;
    int j = 0;                              // the current column
#pragma unroll
    for (int k = 0; k < (NG - 1) * V; ++k) {
      if (k < taps)
        cp_async16(ring + k * THREADS_BF16 * 16,
                   reinterpret_cast<const float4*>(
                       f8 + (list[k].x & INT_MAX) + c8));
      if (k % V == V - 1) cp_async_commit();
    }
    for (int k = 0; k < taps; k += V) {
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int ahead = k + (NG - 1) * V + u;
        if (ahead < taps)
          cp_async16(ring + (ahead % D) * THREADS_BF16 * 16,
                     reinterpret_cast<const float4*>(
                         f8 + (list[ahead].x & INT_MAX) + c8));
      }
      cp_async_commit();
      cp_async_wait<NG - 1>();
#pragma unroll
      for (int u = 0; u < V; ++u) {
        if (k + u >= taps) break;
        const int2 e = list[k + u];
        const uint4 raw =
            ld_shared_u4(ring + ((k + u) % D) * THREADS_BF16 * 16);
        const unsigned words[4] = {raw.x, raw.y, raw.z, raw.w};  // 8 bf16
        float x[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {       // bf16 -> float32, exactly
          x[2 * i] = __uint_as_float(words[i] << 16);
          x[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
        }
        const float wy = __int_as_float(e.y);
#pragma unroll
        for (int q = 0; q < P; ++q) {
          const float w = __bfloat162float(
              __float2bfloat16_rn(__fmul_rn(wy, t.wxs[j * P + q])));
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[q][i] = fmaf(w, x[i], acc[q][i]);
        }
        if (e.x < 0) ++j;                   // the column is done
      }
    }
#pragma unroll
    for (int q = 0; q < P; ++q) {
      __stcs(o8 + (size_t)q * c8n + c8,
             make_uint4(pack_bf16x2(acc[q][0], acc[q][1]),
                        pack_bf16x2(acc[q][2], acc[q][3]),
                        pack_bf16x2(acc[q][4], acc[q][5]),
                        pack_bf16x2(acc[q][6], acc[q][7])));
    }
  }
}

// K2: adaptive samples per bin axis, ceil(extent / pooled) by floor plus
// exact-product correction, capped at max_samples.
__device__ __forceinline__ float axis_count(float extent, int pooled,
                                            int max_samples) {
  const float qf = floorf(__fdiv_rn(extent, (float)pooled));
  const float cnt = qf + (__fmul_rn(qf, (float)pooled) < extent ? 1.f : 0.f);
  return fminf(fmaxf(cnt, 1.f), (float)max_samples);
}

// K2: sample s of bin p along one axis -> its low and high indices and
// their weights (the 1/count average folded in), at slot k of `smp`
// ([4][cap]: low index, high index, low weight, high weight).
__device__ __forceinline__ void axis_sample(float lo, float bin, float cnt,
                                            int p, int s, int size,
                                            float* smp, int cap, int k) {
  const float x = __fadd_rn(__fadd_rn(lo, __fmul_rn((float)p, bin)),
                            __fmul_rn((float)s + 0.5f, __fdiv_rn(bin, cnt)));
  const bool in_range = x >= -1.f && x <= (float)size;
  const float xc = fmaxf(x, 0.f);
  const float xl = fminf(floorf(xc), (float)(size - 1));
  const float frac = xl >= (float)(size - 1) ? 0.f : __fsub_rn(xc, xl);
  const float w = in_range ? __fdiv_rn(1.f, cnt) : 0.f;
  int* idx = reinterpret_cast<int*>(smp);
  idx[k] = (int)xl;
  idx[cap + k] = min((int)xl + 1, size - 1);
  smp[2 * cap + k] = __fmul_rn(w, __fsub_rn(1.f, frac));
  smp[3 * cap + k] = __fmul_rn(w, frac);
}

// K2: entry u of a dense axis row, the sum over its n samples (in sample
// order) of the low and high weights that land on u.
__device__ __forceinline__ float axis_entry(const float* smp, int cap,
                                            int first, int n, int u) {
  const int* idx = reinterpret_cast<const int*>(smp);
  float v = 0.f;
  for (int k = first; k < first + n; ++k) {
    const float lo = idx[k] == u ? smp[2 * cap + k] : 0.f;
    const float hi = idx[cap + k] == u ? smp[3 * cap + k] : 0.f;
    v = __fadd_rn(v, __fadd_rn(lo, hi));
  }
  return v;
}

// K2: the dense rows Wy[ph, :] and Wx[:, :] of one row of bins from its
// roi, built by a block of NTH threads into t.
template <int P, int NTH>
__device__ __forceinline__ void roi_weights(const Taps& t,
                                            const float* __restrict__ roi,
                                            int ph, int H, int W,
                                            float spatial_scale,
                                            int max_samples) {
  const float x1 = __fmul_rn(roi[0], spatial_scale);
  const float y1 = __fmul_rn(roi[1], spatial_scale);
  const float x2 = __fmul_rn(roi[2], spatial_scale);
  const float y2 = __fmul_rn(roi[3], spatial_scale);
  const float ext_y = fmaxf(__fsub_rn(y2, y1), 1.f);
  const float ext_x = fmaxf(__fsub_rn(x2, x1), 1.f);
  const float bin_y = __fdiv_rn(ext_y, (float)P);
  const float bin_x = __fdiv_rn(ext_x, (float)P);
  const float cy = axis_count(ext_y, P, max_samples);
  const float cx = axis_count(ext_x, P, max_samples);
  const int ny = (int)cy, nx = (int)cx;

  // the row's ny samples along y at slots [0, ny), then nx for each of
  // the P bins along x at slots ny + q * nx + s
  const int cap = max_samples * (1 + P);
  for (int e = threadIdx.x; e < ny + P * nx; e += NTH) {
    if (e < ny) {
      axis_sample(y1, bin_y, cy, ph, e, H, t.samples, cap, e);
    } else {
      const int q = (e - ny) / nx;
      axis_sample(x1, bin_x, cx, q, e - ny - q * nx, W, t.samples, cap, e);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < H + P * W; e += NTH) {
    if (e < H) {
      t.wy[e] = axis_entry(t.samples, cap, 0, ny, e);
    } else {
      const int q = (e - H) / W;
      t.wx[e - H] = axis_entry(t.samples, cap, ny + q * nx, nx,
                               e - H - q * W);
    }
  }
  __syncthreads();
}

template <int P>
__global__ void __launch_bounds__(THREADS, 3)
roi_align_fwd_kernel(const float* __restrict__ feat,
                     const float* __restrict__ rois, float* __restrict__ out,
                     int R, int H, int W, int C, int roi_cols,
                     float spatial_scale, int max_samples) {
  extern __shared__ float4 smem4[];
  const Taps t = carve(reinterpret_cast<float*>(smem4), H, W, P, THREADS);
  const int ph = (int)(blockIdx.x % P);
  const size_t br = blockIdx.x / P;                // b * R + r
  const int b = (int)(br / R);
  roi_weights<P, THREADS>(t, rois + br * roi_cols + (roi_cols - 4), ph, H, W,
                          spatial_scale, max_samples);
  const int c4n = C / 4;
  const int taps = compact<P, THREADS>(t, H, W, c4n);
  pool_row<P>(reinterpret_cast<const float4*>(feat) + (size_t)b * H * W * c4n,
              reinterpret_cast<float4*>(out) + (br * P + ph) * P * c4n, t,
              taps, c4n);
}

// K2 in bf16: K2's weights and taps, the bf16 body
template <int P>
__global__ void __launch_bounds__(THREADS_BF16, 4)
roi_align_fwd_bf16_kernel(const uint4* __restrict__ feat,
                          const float* __restrict__ rois,
                          uint4* __restrict__ out, int R, int H, int W, int C,
                          int roi_cols, float spatial_scale, int max_samples) {
  extern __shared__ float4 smem4[];
  const Taps t = carve(reinterpret_cast<float*>(smem4), H, W, P,
                       THREADS_BF16);
  const int ph = (int)(blockIdx.x % P);
  const size_t br = blockIdx.x / P;                // b * R + r
  const int b = (int)(br / R);
  roi_weights<P, THREADS_BF16>(t, rois + br * roi_cols + (roi_cols - 4), ph,
                               H, W, spatial_scale, max_samples);
  const int c8n = C / 8;
  const int taps = compact<P, THREADS_BF16>(t, H, W, c8n);
  pool_row_bf16<P>(feat + (size_t)b * H * W * c8n,
                   out + (br * P + ph) * P * c8n, t, taps, c8n);
}

template <int P>
__global__ void __launch_bounds__(THREADS, 3)
roi_align_pw_kernel(const float* __restrict__ feat,
                    const float* __restrict__ wy,
                    const float* __restrict__ wx, float* __restrict__ out,
                    int R, int H, int W, int C) {
  extern __shared__ float4 smem4[];
  const Taps t = carve(reinterpret_cast<float*>(smem4), H, W, P, THREADS);
  const int ph = (int)(blockIdx.x % P);
  const size_t br = blockIdx.x / P;                // b * R + r
  const int b = (int)(br / R);
  const float* yrow = wy + (br * P + ph) * H;
  const float* xrows = wx + br * P * W;            // [P][W], as t.wx
  for (int e = threadIdx.x; e < H + P * W; e += THREADS) {
    if (e < H) t.wy[e] = yrow[e];
    else t.wx[e - H] = xrows[e - H];
  }
  __syncthreads();
  const int c4n = C / 4;
  const int taps = compact<P, THREADS>(t, H, W, c4n);
  pool_row<P>(reinterpret_cast<const float4*>(feat) + (size_t)b * H * W * c4n,
              reinterpret_cast<float4*>(out) + (br * P + ph) * P * c4n, t,
              taps, c4n);
}

// Shapes the body takes: C a multiple of `step` (the channels of 16
// bytes), one image's map indexable in int 16-byte offsets below bit 31,
// and its shared memory within the block's 227 KB.
bool shape_ok(int H, int W, int C, int P, int samples, int threads,
              int step) {
  return H > 0 && W > 0 && C > 0 && C % step == 0
      && (size_t)H * W * (C / step) <= (size_t)INT_MAX
      && 4 * smem_words(H, W, P, samples, threads) <= SMEM_MAX;
}

// Launch `kernel` over `blocks` blocks of `threads` with `smem` bytes of
// dynamic shared memory, opting in above the default 48 KB; -> the
// cudaError_t.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t blocks, int threads, size_t smem,
           cudaStream_t stream, Args... args) {
  if (blocks == 0) return (int)cudaSuccess;
  if (smem > SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int roi_align_pw_pooled_ok(int P) { return P == 5 || P == 7; }

extern "C" int roi_align_fwd_max_samples() { return MAX_SAMPLES; }

// K2: feat [B,H,W,C], rois [B,R,roi_cols] (roi_cols 4 or 5, box in the
// last 4) -> out [B,R,P,P,C]; contiguous float32, feat 16-byte aligned.
// Launches on `stream`; returns the cudaError_t.
extern "C" int roi_align_fwd_f32(const void* feat, const void* rois, void* out,
                                 int B, int R, int H, int W, int C,
                                 int roi_cols, int P, float spatial_scale,
                                 int max_samples, void* stream) {
  if (max_samples < 1 || max_samples > MAX_SAMPLES
      || !shape_ok(H, W, C, P, max_samples, THREADS, 4))
    return (int)cudaErrorInvalidValue;
  const size_t blocks = (size_t)B * R * P;
  const size_t smem = 4 * smem_words(H, W, P, max_samples, THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  const float* f = (const float*)feat;
  const float* r = (const float*)rois;
  float* o = (float*)out;
  switch (P) {            // the detector's 7x7 bins; 5x5 in the tests
    case 5:
      return launch(roi_align_fwd_kernel<5>, blocks, THREADS, smem, s, f, r,
                    o, R, H, W, C, roi_cols, spatial_scale, max_samples);
    case 7:
      return launch(roi_align_fwd_kernel<7>, blocks, THREADS, smem, s, f, r,
                    o, R, H, W, C, roi_cols, spatial_scale, max_samples);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K2 in bf16: feat [B,H,W,C] bf16, rois [B,R,roi_cols] float32 (roi_cols 4
// or 5, box in the last 4) -> out [B,R,P,P,C] bf16; contiguous, feat
// 16-byte aligned, C a multiple of 8.  Launches on `stream`; returns the
// cudaError_t.
extern "C" int roi_align_fwd_bf16(const void* feat, const void* rois,
                                  void* out, int B, int R, int H, int W, int C,
                                  int roi_cols, int P, float spatial_scale,
                                  int max_samples, void* stream) {
  if (max_samples < 1 || max_samples > MAX_SAMPLES
      || !shape_ok(H, W, C, P, max_samples, THREADS_BF16, 8))
    return (int)cudaErrorInvalidValue;
  const size_t blocks = (size_t)B * R * P;
  const size_t smem = 4 * smem_words(H, W, P, max_samples, THREADS_BF16);
  cudaStream_t s = (cudaStream_t)stream;
  const uint4* f = (const uint4*)feat;
  const float* r = (const float*)rois;
  uint4* o = (uint4*)out;
  switch (P) {
    case 5:
      return launch(roi_align_fwd_bf16_kernel<5>, blocks, THREADS_BF16, smem,
                    s, f, r, o, R, H, W, C, roi_cols, spatial_scale,
                    max_samples);
    case 7:
      return launch(roi_align_fwd_bf16_kernel<7>, blocks, THREADS_BF16, smem,
                    s, f, r, o, R, H, W, C, roi_cols, spatial_scale,
                    max_samples);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K3: feat [B,H,W,C], wy [B,R,P,H], wx [B,R,P,W] -> out [B,R,P,P,C]; all
// contiguous float32, feat 16-byte aligned.  Launches on `stream`;
// returns the cudaError_t.
extern "C" int roi_align_pw_f32(const void* feat, const void* wy, const void* wx,
                                void* out, int B, int R, int H, int W, int C,
                                int P, void* stream) {
  if (!shape_ok(H, W, C, P, 0, THREADS, 4)) return (int)cudaErrorInvalidValue;
  const size_t blocks = (size_t)B * R * P;
  const size_t smem = 4 * smem_words(H, W, P, 0, THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  const float* f = (const float*)feat;
  const float* y = (const float*)wy;
  const float* x = (const float*)wx;
  float* o = (float*)out;
  switch (P) {
    case 5:
      return launch(roi_align_pw_kernel<5>, blocks, THREADS, smem, s, f, y, x,
                    o, R, H, W, C);
    case 7:
      return launch(roi_align_pw_kernel<7>, blocks, THREADS, smem, s, f, y, x,
                    o, R, H, W, C);
    default: return (int)cudaErrorInvalidValue;
  }
}
