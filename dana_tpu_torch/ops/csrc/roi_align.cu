// RoIAlign over NHWC features for Hopper (sm_90a): one row-pooling body
// behind two float32 entries, and a tensor-core product for bfloat16 behind
// a third.
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
//     serving path) for the same `_kernel` (pallas_call :221), which on a
//     bf16 map the JAX main path runs as the XLA "combine" path of
//     dana_tpu/ops/roi_align.py:119-147: every tap (h, w) of bin (ph, pw)
//     weighs bf16(Wy[ph, h] * Wx[pw, w]), the product of the two float32
//     axis weights rounded to bf16, the sums run in float32 and each output
//     is rounded to bf16 once.  That rounding per product rules out the
//     two-stage form; the combined form is a matrix product, which JAX
//     gives the TPU's matrix unit and this kernel gives the tensor cores
//     (see "The bf16 entry" below).
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
//
// The bf16 entry.  Bound: bytes, half of float32's (40 MB of map and 241
// MB of outputs at the serving shapes, 0.084 ms at 3.35 TB/s); its
// operations, the nonzero combined products, are ~1.8 GFLOP (~2 us at 989
// TFLOP/s).  What costs is again the taps' feature rows through L2, and
// the latency of each block's short chain of dependent steps.  For each
// roi (b, r) the function is one product
//
//     out[b, r] [P*P, C] = Wc [P*P, T] . F [T, C]
//
// over the roi's T taps: the rows x the columns of its two axes' sample
// spans (the low index of bin 0's first sample to the high index of bin
// P-1's last), a rectangle of the map that holds every nonzero weight;
// inside it a row or column weighs 0 where no sample lands (a roi larger
// than the map, whose capped samples skip cells).  bf16 x bf16 products
// are exact in float32, so only the order of the float32 sums differs
// from JAX's.
//  1. Grid: a block per (roi, slice of 256 channels), slice fastest, image
//     major: 9,600 blocks at the serving shapes (2,400 rois, C = 1024), two
//     an SM, 256 threads (two warpgroups).  Each block reads each tap once
//     for all P*P bins (330 K taps for the serving rois, where a block per
//     bin row read 536 K).
//  2. Taps: every thread builds the roi's bins with K2's arithmetic
//     (`roi_bins`, `sample_at`: IEEE division and products) and the two
//     spans from two samples; the weights Wy [P][nh] and Wx [P][nw] over
//     the spans, an entry a thread, each the sum of its samples' weights in
//     sample order (`axis_weight`, `axis_entry`'s sum).  One barrier.  The
//     taps go in chunks of 8: a span row and 8 of its columns (the columns
//     rounded up to 8, the padding weighing 0); a stage holds 8 chunks (64
//     taps).
//  3. A ring of 2 slots.  While the tensor cores work on stage s, stage s +
//     1 is filled: lane 0 of warp g loads chunk g's feature rows of the
//     slice by TMA into the B tile [64 taps x 256 channels] bf16 (MN-major,
//     128-byte swizzle, an atom a (chunk, group of 64 channels)), with one
//     box {64 channels, 8 columns, 4 groups} of a 5-d view of the map
//     where C is a multiple of 64 (one TMA load for four groups: 8% faster
//     on an H100 at the serving shapes), else a box {64, 8} a group;
//     columns past the map read as zeros.  Then every thread forms the
//     combined weights bf16(Wy * Wx) of a chunk for one or two bin rows
//     (one Wy, two 16-byte loads of Wx: formed once a block, not once a
//     thread) into the A tile [64 bins x 64 taps] bf16, K-major with the
//     128-byte swizzle.  TMA
//     and not 16-byte cp.async gathers: the taps are a rectangle, and a
//     gather cost every thread 8 copies and their addresses a stage.
//  4. Product: each warpgroup `wgmma` m64n128k16 (bf16 in, float32
//     accumulators) over its 128 channels, four k-steps a stage, issued
//     unconditionally: a stage's chunks past the roi's last are zero taps
//     (rows read outside the map, zero weights).  Rows P*P..63 of A are
//     never written (their outputs are never stored).
//  5. Epilogue: each output rounded to bf16 once into a swizzled tile in
//     the free slot, then TMA stores of the P*P rows, which nothing reads
//     back before layer4.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;              // float32: 4 channels a thread
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

// K2: adaptive samples per bin axis, ceil(extent / pooled) by floor plus
// exact-product correction, capped at max_samples.
__device__ __forceinline__ float axis_count(float extent, int pooled,
                                            int max_samples) {
  const float qf = floorf(__fdiv_rn(extent, (float)pooled));
  const float cnt = qf + (__fmul_rn(qf, (float)pooled) < extent ? 1.f : 0.f);
  return fminf(fmaxf(cnt, 1.f), (float)max_samples);
}

// K2: one axis of a roi's bins: start, bin size, sample spacing, the
// weight of an in-range sample (the 1/count average), samples a bin and
// the map's size along the axis.
struct Axis {
  float lo, bin, step, w;
  int n, size;
};

__device__ __forceinline__ Axis make_axis(float lo, float bin, float cnt,
                                          int size) {
  return Axis{lo, bin, __fdiv_rn(bin, cnt), __fdiv_rn(1.f, cnt), (int)cnt,
              size};
}

// K2: sample s of bin p -> its low and high indices and their weights.
__device__ __forceinline__ void sample_at(const Axis& a, int p, int s,
                                          int& il, int& ih, float& wl,
                                          float& wh) {
  const float x = __fadd_rn(__fadd_rn(a.lo, __fmul_rn((float)p, a.bin)),
                            __fmul_rn((float)s + 0.5f, a.step));
  const bool in_range = x >= -1.f && x <= (float)a.size;
  const float xc = fmaxf(x, 0.f);
  const float xl = fminf(floorf(xc), (float)(a.size - 1));
  const float frac = xl >= (float)(a.size - 1) ? 0.f : __fsub_rn(xc, xl);
  const float w = in_range ? a.w : 0.f;
  il = (int)xl;
  ih = min((int)xl + 1, a.size - 1);
  wl = __fmul_rn(w, __fsub_rn(1.f, frac));
  wh = __fmul_rn(w, frac);
}

// K2: sample s of bin p along one axis -> its low and high indices and
// their weights at slot k of `smp` ([4][cap]: low index, high index, low
// weight, high weight).
__device__ __forceinline__ void axis_sample(float lo, float bin, float cnt,
                                            int p, int s, int size,
                                            float* smp, int cap, int k) {
  int* idx = reinterpret_cast<int*>(smp);
  sample_at(make_axis(lo, bin, cnt, size), p, s, idx[k], idx[cap + k],
            smp[2 * cap + k], smp[3 * cap + k]);
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

// K2: a roi's bins along both axes, from its box in image coordinates:
// start, bin size and samples a bin (as a float and as a count).
struct RoiBins {
  float y1, x1, bin_y, bin_x, cy, cx;
  int ny, nx;
};

template <int P>
__device__ __forceinline__ RoiBins roi_bins(const float* __restrict__ roi,
                                            float spatial_scale,
                                            int max_samples) {
  RoiBins g;
  g.x1 = __fmul_rn(roi[0], spatial_scale);
  g.y1 = __fmul_rn(roi[1], spatial_scale);
  const float x2 = __fmul_rn(roi[2], spatial_scale);
  const float y2 = __fmul_rn(roi[3], spatial_scale);
  const float ext_y = fmaxf(__fsub_rn(y2, g.y1), 1.f);
  const float ext_x = fmaxf(__fsub_rn(x2, g.x1), 1.f);
  g.bin_y = __fdiv_rn(ext_y, (float)P);
  g.bin_x = __fdiv_rn(ext_x, (float)P);
  g.cy = axis_count(ext_y, P, max_samples);
  g.cx = axis_count(ext_x, P, max_samples);
  g.ny = (int)g.cy;
  g.nx = (int)g.cx;
  return g;
}

// K2: the dense rows Wy[ph, :] and Wx[:, :] of one row of bins from its
// roi, built by a block of NTH threads into t.
template <int P, int NTH>
__device__ __forceinline__ void roi_weights(const Taps& t,
                                            const float* __restrict__ roi,
                                            int ph, int H, int W,
                                            float spatial_scale,
                                            int max_samples) {
  const RoiBins g = roi_bins<P>(roi, spatial_scale, max_samples);
  const int ny = g.ny, nx = g.nx;

  // the row's ny samples along y at slots [0, ny), then nx for each of
  // the P bins along x at slots ny + q * nx + s
  const int cap = max_samples * (1 + P);
  for (int e = threadIdx.x; e < ny + P * nx; e += NTH) {
    if (e < ny) {
      axis_sample(g.y1, g.bin_y, g.cy, ph, e, H, t.samples, cap, e);
    } else {
      const int q = (e - ny) / nx;
      axis_sample(g.x1, g.bin_x, g.cx, q, e - ny - q * nx, W, t.samples, cap,
                  e);
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

// ------------------------------------------------------- the bf16 entry

constexpr int BF_THREADS = 256;            // two warpgroups
constexpr int BF_SLICE = 256;              // channels a block, 128 a warpgroup
constexpr int BF_TAPS = 64;                // taps a slot: four k-steps of 16
constexpr int BF_SLOTS = 2;                // ring slots
constexpr int BF_A = 64 * BF_TAPS * 2;     // A tile: 64 bin rows of 128 bytes
constexpr int BF_GROUP = 8 * 128;          // 8 taps x 64 channels: an atom
constexpr int BF_CHUNK = BF_GROUP * BF_SLICE / 64;  // 8 taps x 256 channels
constexpr int BF_SLOT = BF_A + BF_CHUNK * BF_TAPS / 8;
constexpr int BF_STAGE_BOX = 64 * 128;     // epilogue: 64 rows x 64 channels

// Row stride of the kept columns' weights Wx [P][SW]: the columns padded
// with zeros to whole chunks of 8, plus 4 floats so that the rows' 16-byte
// groups fall on different banks.
__host__ __device__ inline int kept_stride(int W) {
  return (W + 7) / 8 * 8 + 4;
}

// Bytes of shared memory a bf16 block uses: the ring (aligned to the
// 128-byte swizzle's 1024-byte atoms), its two mbarriers, then the kept
// columns' weights Wx [P][SW] and the kept rows' weights Wy [P][H].
__host__ __device__ inline size_t smem_bf16(int H, int W, int P) {
  return 1024 + (size_t)BF_SLOTS * BF_SLOT + 16
      + 4 * ((size_t)P * kept_stride(W) + (size_t)P * H);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// arrive, and expect `bytes` more of transactions in the current phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that
// outlasts 2^26 polls is a fault of the pipeline: trap (the launch then
// fails with an error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// a box of the 4-d map at (c0, c1, c2, c3) into shared memory, completing
// on `bar`
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"((uint64_t)map), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load5(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"((uint64_t)map), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// a box of shared memory to the 2-d map at (c0, c1)
__device__ __forceinline__ void tma_store2(const CUtensorMap* map,
                                           const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n"
      :: "l"((uint64_t)map), "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until the committed stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// shared memory written through the generic proxy (st.shared) -> visible
// to the async proxy, through which wgmma and TMA read it
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a warpgroup's own barrier (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle (as in
// cisa_shots_bf16.cu): SBO, the bytes from one atom of 8 rows to the next
// along K; LBO, for the MN-major B, from one group of 64 channels to the
// next (unused for the K-major A).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, float32) (+)= A (64 x 16, K-major) @ B (16 x 128, MN-major)
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Two floats rounded to bf16, the first in the low half (lower address).
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Entry u of bin p's row on axis a: the low and high weights of its
// samples that land on u, summed in sample order (`axis_entry`'s sum,
// without the samples in shared memory).
__device__ __forceinline__ float axis_weight(const Axis& a, int p, int u) {
  float v = 0.f;
  for (int s = 0; s < a.n; ++s) {
    int il, ih;
    float wl, wh;
    sample_at(a, p, s, il, ih, wl, wh);
    v = __fadd_rn(v, __fadd_rn(il == u ? wl : 0.f, ih == u ? wh : 0.f));
  }
  return v;
}

// The span of the map an axis's samples touch: the low index of bin 0's
// first sample to the high index of bin P-1's last (the indices grow with
// the sample).  Every nonzero weight lies inside it.
template <int P>
__device__ __forceinline__ int2 axis_span(const Axis& a) {
  int il, ih, unused;
  float w0, w1;
  sample_at(a, 0, 0, il, unused, w0, w1);
  sample_at(a, P - 1, a.n - 1, unused, ih, w0, w1);
  return make_int2(il, ih);
}

// The roi's taps, kept rows x kept columns of its spans, in chunks of 8:
// chunk c is kept row c / cpr and its columns 8 (c % cpr) .. + 7 (cpr:
// chunks a row, the nw kept columns rounded up to 8; columns past nw weigh
// 0).  Stage s holds chunks 8s .. 8s + 7; a chunk past the last is zeros.

// Stage s's combined weights into the A tile `a` [64 bin rows x 64 taps]
// (K-major, 128-byte swizzle: row m's 16-byte chunk q at m * 128 + (q ^ m %
// 8) * 16).  Thread t forms chunk q = t % 8 of the stage, kept row i and
// columns 8 jc .. + 7 (zeros if not `live`), for the bin rows t / 8 and t /
// 8 + 32 below P*P: bf16(Wy[ph, h] * Wx[pw, w]), one Wy and eight Wx (two
// 16-byte loads) a row.
template <int P>
__device__ __forceinline__ void combine_weights(uint8_t* a, const float* wyk,
                                                const float* wxk, int H,
                                                int SW, int i, int jc,
                                                bool live) {
  const int q = threadIdx.x & 7;
  for (int m = threadIdx.x >> 3; m < P * P; m += BF_THREADS / 8) {
    const int ph = m / P;
    const float y = live ? wyk[ph * H + (live ? i : 0)] : 0.f;
    const float4* x = reinterpret_cast<const float4*>(
        wxk + (m - ph * P) * SW + (live ? 8 * jc : 0));
    const float4 xa = x[0], xb = x[1];
    *reinterpret_cast<uint4*>(a + m * 128 + ((q ^ (m & 7)) << 4)) =
        make_uint4(pack_bf16x2(__fmul_rn(y, xa.x), __fmul_rn(y, xa.y)),
                   pack_bf16x2(__fmul_rn(y, xa.z), __fmul_rn(y, xa.w)),
                   pack_bf16x2(__fmul_rn(y, xb.x), __fmul_rn(y, xb.y)),
                   pack_bf16x2(__fmul_rn(y, xb.z), __fmul_rn(y, xb.w)));
  }
}

// A chunk's feature rows, 8 taps from map row h and column w, channels
// ch0 .. ch0 + 255, into position g of its stage's B tile `bt` by TMA, with
// an arrival on `full` expecting them.  The B tile is [8 chunks][4 groups
// of 64 channels][8 taps][128 bytes]: MN-major with the 128-byte swizzle,
// an atom a (chunk, group).  With C a multiple of 64 (`wide`) one box of
// the 5-d map loads the chunk's 4 groups (4096 bytes); else a box of the
// 4-d map a group that holds a channel below C (`groups` of them, 1024
// bytes each).  Columns past the map read as zeros; a chunk that is not
// `live` is read at row H, wholly outside the map: zeros.
__device__ __forceinline__ void load_chunk(uint8_t* bt, uint64_t* full,
                                           const CUtensorMap* map, int wide,
                                           int b, int h, int w, int ch0,
                                           int groups, bool live, int H,
                                           int g) {
  if (!live) h = H, w = 0;
  uint8_t* dst = bt + g * BF_CHUNK;
  if (wide) {
    mbar_expect_tx(full, BF_CHUNK);
    tma_load5(dst, map, full, 0, w, ch0 / 64, h, b);
  } else {
    mbar_expect_tx(full, groups * BF_GROUP);
    for (int bx = 0; bx < groups; ++bx)
      tma_load4(dst + bx * BF_GROUP, map, full, ch0 + 64 * bx, w, h, b);
  }
}

// K2 in bf16 (see the head of the file): one block per (roi, slice of 256
// channels), slice fastest.
template <int P>
__global__ void __launch_bounds__(BF_THREADS, 2)
roi_align_fwd_bf16_kernel(const __grid_constant__ CUtensorMap fmap, int wide,
                          const __grid_constant__ CUtensorMap omap,
                          const float* __restrict__ rois, int R, int H,
                          int W, int C, int roi_cols, float spatial_scale,
                          int max_samples) {
  extern __shared__ uint8_t smem_raw[];
  if (threadIdx.x == 0) {    // the maps' descriptors, while the taps form
    asm volatile("prefetch.tensormap [%0];\n" :: "l"((uint64_t)&fmap)
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" :: "l"((uint64_t)&omap)
                 : "memory");
  }
  uint8_t* const ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const int SW = kept_stride(W);
  uint64_t* const full =
      reinterpret_cast<uint64_t*>(ring + BF_SLOTS * BF_SLOT);
  float* const wxk = reinterpret_cast<float*>(full + BF_SLOTS);
  float* const wyk = wxk + P * SW;
  auto slot = [&](int s) { return ring + s % BF_SLOTS * BF_SLOT; };

  const int slices = (C + BF_SLICE - 1) / BF_SLICE;
  const int ch0 = (int)(blockIdx.x % slices) * BF_SLICE;
  const int br = (int)(blockIdx.x / slices);       // b * R + r
  const int b = br / R;
  const RoiBins g = roi_bins<P>(rois + (size_t)br * roi_cols + (roi_cols - 4),
                                spatial_scale, max_samples);
  const Axis ay = make_axis(g.y1, g.bin_y, g.cy, H);
  const Axis ax = make_axis(g.x1, g.bin_x, g.cx, W);
  const int2 ys = axis_span<P>(ay), xs = axis_span<P>(ax);
  const int nh = ys.y - ys.x + 1, nw = xs.y - xs.x + 1, cpr = (nw + 7) / 8;
  const int nchunks = nh * cpr, stages = (nchunks + 7) / 8;
  // the weights over the spans, an entry a thread: Wy [P][nh], then Wx
  // [P][8 cpr] zero-padded to whole chunks
  const int ey = P * nh, ex = 8 * cpr;
  for (int e = threadIdx.x; e < ey + P * ex; e += BF_THREADS) {
    if (e < ey) {
      const int q = e / nh, i = e - q * nh;
      wyk[q * H + i] = axis_weight(ay, q, ys.x + i);
    } else {
      const int q = (e - ey) / ex, j = e - ey - q * ex;
      wxk[q * SW + j] = j < nw ? axis_weight(ax, q, xs.x + j) : 0.f;
    }
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < BF_SLOTS; ++i) mbar_init(&full[i], BF_THREADS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // stage s into its slot: lane 0 of warp g copies the stage's chunk g,
  // then everyone forms the weights while the copies fly.  Chunk 8s + g is
  // kept row i of the span and its columns 8 jc ..; (i, jc) steps by 8
  // chunks a stage.
  const int groups = min(BF_SLICE / 64, (C - ch0 + 63) / 64);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = threadIdx.x & 7, di = 8 / cpr, dj = 8 - di * cpr;
  int ti = warp / cpr, tj = warp - ti * cpr;   // chunk `warp` of the stage
  int ci = q / cpr, cj = q - ci * cpr;         // chunk q of the stage
  auto fill = [&](int s) {
    if (s < stages) {
      if (lane == 0)
        load_chunk(slot(s) + BF_A, &full[s % BF_SLOTS], &fmap, wide, b,
                   ys.x + ti, xs.x + 8 * tj, ch0, groups,
                   8 * s + warp < nchunks, H, warp);
      combine_weights<P>(slot(s), wyk, wxk, H, SW, ci, cj,
                         8 * s + q < nchunks);
    }
    ti += di, tj += dj, ci += di, cj += dj;
    if (tj >= cpr) tj -= cpr, ++ti;
    if (cj >= cpr) cj -= cpr, ++ci;
  };
  fill(0);
  static_assert(BF_SLOTS == 2, "a fill a stage, one ahead");

  // warpgroup wg: channels ch0 + 128 wg .. + 127, B's groups 2 wg, 2 wg + 1
  const int wg = threadIdx.x >> 7;
  float acc[64];
  for (int s = 0; s < stages; ++s) {
    mbar_wait(&full[s % BF_SLOTS], s / BF_SLOTS & 1);    // s's feature rows
    fence_async_smem();                        // this thread's weights of s
    __syncthreads();     // everyone's weights of s; and s - 1 is read
    const uint8_t* a = slot(s);
    const uint8_t* bw = a + BF_A + wg * 2 * BF_GROUP;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BF_TAPS / 16; ++kk)   // taps 16kk ..: 2 chunks
      wgmma_m64n128(acc, desc(a + kk * 32, 16, 1024),
                    desc(bw + 2 * kk * BF_CHUNK, BF_GROUP, BF_CHUNK),
                    s > 0 || kk > 0);
    wgmma_commit();
    fill(s + BF_SLOTS - 1);                      // into the slot s - 1 read
    wgmma_wait_all();
    fence_regs(acc);
  }

  // Epilogue: the outputs rounded to bf16 into this warpgroup's half of the
  // slot of stage `stages` (free: the last stage's is the other) as two
  // boxes [64 rows x 64 channels] with the 128-byte swizzle, then one TMA
  // store a box of its P*P rows that hold a channel below C: nothing reads
  // them back before layer4.  Accumulator d[i] of thread t is row 16 (t /
  // 32) + t % 32 / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (t % 4) + i %
  // 2.
  uint8_t* const tile = slot(stages) + wg * 2 * BF_STAGE_BOX;
  const int t = threadIdx.x & 127, r0 = 16 * (t >> 5) + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int row = r0 + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    *reinterpret_cast<__nv_bfloat162*>(
        tile + (col >> 6) * BF_STAGE_BOX + row * 128
        + ((((col >> 3) & 7) ^ (row & 7)) << 4) + (col & 7) * 2) =
        __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
  fence_async_smem();
  wg_sync(wg);
  if (t == 0) {
    for (int bx = 0; bx < 2 && ch0 + wg * 128 + 64 * bx < C; ++bx)
      tma_store2(&omap, tile + bx * BF_STAGE_BOX, ch0 + wg * 128 + 64 * bx,
                 br * (P * P));
    bulk_commit();
    bulk_wait_read();
  }
}

// Shapes the float32 body takes: C a multiple of 4, one image's map
// indexable in int float4 offsets, and its shared memory within the
// block's 227 KB.
bool shape_ok(int H, int W, int C, int P, int samples) {
  return H > 0 && W > 0 && C > 0 && C % 4 == 0
      && (size_t)H * W * (C / 4) <= (size_t)INT_MAX
      && 4 * smem_words(H, W, P, samples, THREADS) <= SMEM_MAX;
}

// Shapes the bf16 entry takes: C a multiple of 8 (rows of the map on
// 16-byte boundaries, as TMA needs), its shared memory within 227 KB.
bool shape_ok_bf16(int H, int W, int C, int P) {
  return H > 0 && W > 0 && C > 0 && C % 8 == 0
      && smem_bf16(H, W, P) <= SMEM_MAX;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// The bf16 map feat [B][H][W][C] for TMA, 128-byte swizzle, what lies
// outside reading as zeros; *wide: whether a box holds a chunk's 4 groups
// of 64 channels.  With C a multiple of 64, a 5-d tensor [B][H][C/64][W][64]
// (the channel groups as a dimension of stride 128 bytes, inside the
// columns) in boxes of 64 channels x 8 columns x 4 groups; else a 4-d
// tensor [B][H][W][C] in boxes of 64 channels x 8 columns.  -> 0 or a
// cudaError_t.
int feat_map(CUtensorMap* map, int* wide, const void* feat, int B, int H,
             int W, int C) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorInitializationError;
  *wide = C % 64 == 0;
  const cuuint64_t pix = (cuuint64_t)C * 2, row = pix * W, img = row * H;
  const cuuint64_t dims5[5] = {64, (cuuint64_t)W, (cuuint64_t)C / 64,
                               (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides5[4] = {pix, 128, row, img};
  const cuuint32_t box5[5] = {64, 8, BF_SLICE / 64, 1, 1};
  const cuuint64_t dims4[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)B};
  const cuuint64_t strides4[3] = {pix, row, img};
  const cuuint32_t box4[4] = {64, 8, 1, 1};
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, *wide ? 5 : 4,
                        const_cast<void*>(feat), *wide ? dims5 : dims4,
                        *wide ? strides5 : strides4, *wide ? box5 : box4,
                        estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The bf16 output out [B*R*P*P][C] for TMA stores in boxes of 64 channels x
// P*P rows (a roi's bins), 128-byte swizzle; what lies past C is not
// written.  -> 0 or a cudaError_t.
int out_map(CUtensorMap* map, void* out, size_t rows, int C, int P) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorInitializationError;
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)C * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)(P * P)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
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
      || !shape_ok(H, W, C, P, max_samples))
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
      || !shape_ok_bf16(H, W, C, P))
    return (int)cudaErrorInvalidValue;
  const size_t blocks = (size_t)B * R * ((C + BF_SLICE - 1) / BF_SLICE);
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > (size_t)INT_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap fmap, omap;
  int wide = 0;
  int e = feat_map(&fmap, &wide, feat, B, H, W, C);
  if (e == 0) e = out_map(&omap, out, (size_t)B * R * P * P, C, P);
  if (e != 0) return e;
  const size_t smem = smem_bf16(H, W, P);
  cudaStream_t s = (cudaStream_t)stream;
  const float* r = (const float*)rois;
  switch (P) {
    case 5:
      return launch(roi_align_fwd_bf16_kernel<5>, blocks, BF_THREADS, smem, s,
                    fmap, wide, omap, r, R, H, W, C, roi_cols, spatial_scale,
                    max_samples);
    case 7:
      return launch(roi_align_fwd_bf16_kernel<7>, blocks, BF_THREADS, smem, s,
                    fmap, wide, omap, r, R, H, W, C, roi_cols, spatial_scale,
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
  if (!shape_ok(H, W, C, P, 0)) return (int)cudaErrorInvalidValue;
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
