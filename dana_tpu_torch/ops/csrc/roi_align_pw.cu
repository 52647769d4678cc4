// RoIAlign from precomputed axis weights, float32, for Hopper (sm_90a).
//
//   out[b, r, ph, pw, c] = sum_w Wx[b,r,pw,w] * sum_h Wy[b,r,ph,h] * feat[b,h,w,c]
//
// Replaces the Pallas TPU kernel `_kernel_pw3` (body `_matmul_body`) of
// dana_tpu/ops/roi_align_pallas.py (pallas_call in `roi_align_pallas_pw`):
// the same two contractions, stage 1 over H, stage 2 over W.  The
// training step pools its sampled rois with it; the weights Wy [B,R,P,H]
// and Wx [B,R,P,W] are built once by the caller and kept for the
// backward.
//
// Bound on this card: bytes.  The function reads feat and the weights
// once and writes the output once: at the training shapes (4 images,
// 38x64x1024 map, 128 rois, 7x7 bins) that is 39.8 MB + 1.5 MB read and
// 102.8 MB written, 0.043 ms at 3.35 TB/s.  The dense contractions would
// be 21.1 GFLOP (0.316 ms at 67 TFLOP/s outside the tensor cores), but
// each weight row is zero outside a short span (the bilinear taps of one
// bin's samples), so the work the data needs is far smaller.
//
// Design: one block per output row (b, r, ph), 256 threads along the
// channels, each owning float4 groups of 4 neighbouring channels (NHWC:
// C is contiguous, so every load and store is coalesced).  Warp 0
// compacts the row's nonzero Wy taps and warp 1 the columns w where some
// Wx[pw, w] is nonzero, with ballots, into shared memory; the loops then
// run over those lists only, so the skipped zeros are the same for every
// thread.  For each kept column the thread sums its stage-1 value over
// the kept rows in a register and adds it, times Wx[pw, w], into the P
// outputs of the row, which stay in registers until the one store.
// Neighbouring rows (ph) of one roi re-read overlapping feature rows
// through L2.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr size_t SMEM_DEFAULT = 48 * 1024;   // no opt-in attribute needed

__device__ __forceinline__ void fma4(float a, const float4& x, float4& acc) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

template <int P>
__global__ void __launch_bounds__(THREADS)
roi_align_pw_kernel(const float* __restrict__ feat, const float* __restrict__ wy,
                    const float* __restrict__ wx, float* __restrict__ out,
                    int R, int H, int W, int C) {
  extern __shared__ float smem[];
  float* hw = smem;                                  // [H] kept Wy taps
  float* wxs = hw + H;                               // [W][P] kept Wx columns
  int* hidx = reinterpret_cast<int*>(wxs + W * P);   // [H]
  int* widx = hidx + H;                              // [W]
  __shared__ int nh, nw;

  const int ph = (int)(blockIdx.x % P);
  const size_t br = blockIdx.x / P;                  // b * R + r
  const int b = (int)(br / R);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;

  if (warp == 0) {
    const float* row = wy + (br * P + ph) * H;
    int n = 0;
    for (int h0 = 0; h0 < H; h0 += 32) {
      const int h = h0 + lane;
      const float a = h < H ? row[h] : 0.f;
      const unsigned m = __ballot_sync(0xffffffffu, a != 0.f);
      if (a != 0.f) {
        const int pos = n + __popc(m & below);
        hidx[pos] = h;
        hw[pos] = a;
      }
      n += __popc(m);
    }
    if (lane == 0) nh = n;
  } else if (warp == 1) {
    const float* cols = wx + br * P * W;
    int n = 0;
    for (int w0 = 0; w0 < W; w0 += 32) {
      const int w = w0 + lane;
      float v[P];
      bool any = false;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        v[q] = w < W ? cols[q * W + w] : 0.f;
        any |= v[q] != 0.f;
      }
      const unsigned m = __ballot_sync(0xffffffffu, any);
      if (any) {
        const int pos = n + __popc(m & below);
        widx[pos] = w;
#pragma unroll
        for (int q = 0; q < P; ++q) wxs[pos * P + q] = v[q];
      }
      n += __popc(m);
    }
    if (lane == 0) nw = n;
  }
  __syncthreads();

  const int c4n = C / 4;
  const float4* f4 = reinterpret_cast<const float4*>(feat + (size_t)b * H * W * C);
  float4* o4 = reinterpret_cast<float4*>(out + (br * P + ph) * P * C);
  const int n_h = nh, n_w = nw;
  for (int c4 = tid; c4 < c4n; c4 += THREADS) {
    float4 acc[P];
#pragma unroll
    for (int q = 0; q < P; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < n_w; ++j) {
      const int w = widx[j];
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = 0; i < n_h; ++i) {
        fma4(hw[i], f4[((size_t)hidx[i] * W + w) * c4n + c4], t);
      }
#pragma unroll
      for (int q = 0; q < P; ++q) fma4(wxs[j * P + q], t, acc[q]);
    }
#pragma unroll
    for (int q = 0; q < P; ++q) o4[(size_t)q * c4n + c4] = acc[q];
  }
}

template <int P>
int launch(const float* feat, const float* wy, const float* wx, float* out,
           int B, int R, int H, int W, int C, size_t smem, cudaStream_t stream) {
  const size_t blocks = (size_t)B * R * P;
  if (blocks == 0) return (int)cudaSuccess;
  roi_align_pw_kernel<P><<<(unsigned)blocks, THREADS, smem, stream>>>(
      feat, wy, wx, out, R, H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int roi_align_pw_pooled_ok(int P) { return P == 5 || P == 7; }

// feat [B,H,W,C], wy [B,R,P,H], wx [B,R,P,W] -> out [B,R,P,P,C], all
// contiguous float32, C % 4 == 0 and feat 16-byte aligned.  Launches on
// `stream`; returns the cudaError_t.
extern "C" int roi_align_pw_f32(const void* feat, const void* wy, const void* wx,
                                void* out, int B, int R, int H, int W, int C,
                                int P, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * H + W + (size_t)W * P);
  if (C % 4 != 0 || smem > SMEM_DEFAULT) return (int)cudaErrorInvalidValue;
  const float* f = (const float*)feat;
  const float* y = (const float*)wy;
  const float* x = (const float*)wx;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (P) {            // the detector's 7x7 bins; 5x5 in the tests
    case 5: return launch<5>(f, y, x, o, B, R, H, W, C, smem, s);
    case 7: return launch<7>(f, y, x, o, B, R, H, W, C, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
