// The trunk's BN-act epilogue (dana_tpu_torch/ops/bn_act.py) and its
// backward, one pass each over a conv's output.
//
//   forward   y = relu((x * s + o) + r'),  r' = r, or r * s_r + o_r, or none
//   backward  m = (y <= 0) ? 0 : g;  g_x = m * s;  g_r = m, or m * s_r
//
// Replaces no Pallas kernel: the JAX package leaves the chain to XLA, which
// fuses it into the conv, while PyTorch runs it as three to nine
// elementwise passes.  The pass is bound by its bytes (x, r and y once each)
// at 3.35 TB/s; the design's only aim is to stream them at that rate: 16-byte
// loads and stores, a grid-stride loop over enough blocks to fill every SM.
//
// Rounding is PyTorch's, operation by operation, so the result equals the
// separate ops' bit for bit: __fmul_rn / __fadd_rn keep nvcc from
// contracting a product and a sum into one FMA, and in bfloat16 every
// result is rounded to bfloat16 (round to nearest even, as PyTorch's
// TensorIterator stores each op's float result) before the next op reads
// it.  The ReLU is F.relu's clamp_min: NaN passes with its bits, anything
// else goes through fmaxf(v, 0).  The backward's mask is
// threshold_backward's `y <= 0 ? 0 : g`.
//
// Two paths, chosen by the caller from the strides: the vector path for
// operands that share one dense layout with the channels innermost (the
// trunk's NCHW view of NHWC memory) and C a multiple of the 16-byte vector,
// the channel of each vector followed incrementally; the strided path for
// any other layout, which decomposes each NCHW index.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// outside the anonymous namespace: the extern "C" entries take it, and a
// type of internal linkage would give them internal linkage too
struct Shapes {                 // ops/bn_act.py `_Shapes`
  int64_t size[4];              // N, C, H, W
  int64_t stride[4][4];         // each operand's strides, in elements
};

namespace {

constexpr int kThreads = 256;

struct F32 {
  using S = float;
  static __device__ __forceinline__ float get(S v) { return v; }
  static __device__ __forceinline__ S put(float v) { return v; }
};

struct BF16 {
  using S = unsigned short;
  static __device__ __forceinline__ float get(S v) {
    return __bfloat162float(__ushort_as_bfloat16(v));
  }
  static __device__ __forceinline__ S put(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

template <class D>
union Pack {
  uint4 u;
  typename D::S v[16 / sizeof(typename D::S)];
};

template <class D>
__device__ __forceinline__ typename D::S mul(typename D::S a,
                                             typename D::S b) {
  return D::put(__fmul_rn(D::get(a), D::get(b)));
}

template <class D>
__device__ __forceinline__ typename D::S add(typename D::S a,
                                             typename D::S b) {
  return D::put(__fadd_rn(D::get(a), D::get(b)));
}

template <class D, bool R, bool RBN>
__device__ __forceinline__ typename D::S forward1(
    typename D::S x, typename D::S s, typename D::S o, typename D::S r,
    typename D::S sr, typename D::S orr) {
  typename D::S t = add<D>(mul<D>(x, s), o);
  if (R) t = add<D>(t, RBN ? add<D>(mul<D>(r, sr), orr) : r);
  const float f = D::get(t);
  return isnan(f) ? t : D::put(fmaxf(f, 0.f));
}

// MODE 0: no g_r; 1: g_r = m (identity residual); 2: g_r = m * s_r
template <class D, int MODE>
__device__ __forceinline__ void backward1(
    typename D::S g, typename D::S y, typename D::S s, typename D::S sr,
    typename D::S& gx, typename D::S& gr) {
  const typename D::S m = D::get(y) <= 0.f ? D::put(0.f) : g;
  gx = mul<D>(m, s);
  if (MODE == 1) gr = m;
  if (MODE == 2) gr = mul<D>(m, sr);
}

__device__ __forceinline__ int64_t offset(const Shapes& sh, int k,
                                          int64_t n, int64_t c, int64_t h,
                                          int64_t w) {
  return n * sh.stride[k][0] + c * sh.stride[k][1] + h * sh.stride[k][2] +
         w * sh.stride[k][3];
}

// ------------------------------------------------------------ forward

template <class D, bool R, bool RBN>
__global__ void __launch_bounds__(kThreads)
forward_vec(const uint4* __restrict__ x, const uint4* __restrict__ s,
            const uint4* __restrict__ o, const uint4* __restrict__ r,
            const uint4* __restrict__ sr, const uint4* __restrict__ orr,
            uint4* __restrict__ y, int64_t nvec, int cvec) {
  constexpr int V = 16 / sizeof(typename D::S);
  const int64_t step = (int64_t)gridDim.x * kThreads;
  const int cstep = (int)(step % cvec);
  int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int cv = (int)(i % cvec);
  for (; i < nvec; i += step) {
    Pack<D> xv, sv, ov, rv, srv, orv, out;
    xv.u = x[i];
    sv.u = __ldg(s + cv);
    ov.u = __ldg(o + cv);
    if (R) rv.u = r[i];
    if (RBN) {
      srv.u = __ldg(sr + cv);
      orv.u = __ldg(orr + cv);
    }
#pragma unroll
    for (int k = 0; k < V; ++k)
      out.v[k] = forward1<D, R, RBN>(xv.v[k], sv.v[k], ov.v[k],
                                    R ? rv.v[k] : 0, RBN ? srv.v[k] : 0,
                                    RBN ? orv.v[k] : 0);
    y[i] = out.u;
    cv += cstep;
    if (cv >= cvec) cv -= cvec;
  }
}

template <class D, bool R, bool RBN>
__global__ void __launch_bounds__(kThreads)
forward_strided(const typename D::S* __restrict__ x,
                const typename D::S* __restrict__ s,
                const typename D::S* __restrict__ o,
                const typename D::S* __restrict__ r,
                const typename D::S* __restrict__ sr,
                const typename D::S* __restrict__ orr,
                typename D::S* __restrict__ y, Shapes sh, int64_t n) {
  const int64_t step = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += step) {
    const int64_t w = i % sh.size[3];
    int64_t t = i / sh.size[3];
    const int64_t h = t % sh.size[2];
    t /= sh.size[2];
    const int64_t c = t % sh.size[1];
    const int64_t b = t / sh.size[1];
    y[offset(sh, 2, b, c, h, w)] = forward1<D, R, RBN>(
        x[offset(sh, 0, b, c, h, w)], s[c], o[c],
        R ? r[offset(sh, 1, b, c, h, w)] : 0, RBN ? sr[c] : 0,
        RBN ? orr[c] : 0);
  }
}

int blocks_for(int64_t work, int max_blocks) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  return (int)(b < max_blocks ? b : max_blocks);
}

template <class D, bool R, bool RBN>
int forward_launch(const void* x, const void* s, const void* o,
                   const void* r, const void* sr, const void* orr, void* y,
                   const Shapes* sh, int64_t n, int c, int max_blocks,
                   cudaStream_t stream) {
  using S = typename D::S;
  constexpr int V = 16 / sizeof(S);
  if (sh == nullptr) {
    const int64_t nvec = n / V;
    forward_vec<D, R, RBN>
        <<<blocks_for(nvec, max_blocks), kThreads, 0, stream>>>(
            (const uint4*)x, (const uint4*)s, (const uint4*)o,
            (const uint4*)r, (const uint4*)sr, (const uint4*)orr,
            (uint4*)y, nvec, c / V);
  } else {
    forward_strided<D, R, RBN>
        <<<blocks_for(n, max_blocks), kThreads, 0, stream>>>(
            (const S*)x, (const S*)s, (const S*)o, (const S*)r,
            (const S*)sr, (const S*)orr, (S*)y, *sh, n);
  }
  return (int)cudaGetLastError();
}

template <class D>
int forward(const void* x, const void* s, const void* o, const void* r,
            const void* sr, const void* orr, void* y, const Shapes* sh,
            int64_t n, int c, int has_r, int has_rbn, int max_blocks,
            cudaStream_t stream) {
  if (!has_r)
    return forward_launch<D, false, false>(x, s, o, r, sr, orr, y, sh, n, c,
                                           max_blocks, stream);
  if (!has_rbn)
    return forward_launch<D, true, false>(x, s, o, r, sr, orr, y, sh, n, c,
                                          max_blocks, stream);
  return forward_launch<D, true, true>(x, s, o, r, sr, orr, y, sh, n, c,
                                       max_blocks, stream);
}

// ----------------------------------------------------------- backward

template <class D, int MODE>
__global__ void __launch_bounds__(kThreads)
backward_vec(const uint4* __restrict__ g, const uint4* __restrict__ y,
             const uint4* __restrict__ s, const uint4* __restrict__ sr,
             uint4* __restrict__ gx, uint4* __restrict__ gr, int64_t nvec,
             int cvec) {
  constexpr int V = 16 / sizeof(typename D::S);
  const int64_t step = (int64_t)gridDim.x * kThreads;
  const int cstep = (int)(step % cvec);
  int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int cv = (int)(i % cvec);
  for (; i < nvec; i += step) {
    Pack<D> gv, yv, sv, srv, gxv, grv;
    gv.u = g[i];
    yv.u = y[i];
    sv.u = __ldg(s + cv);
    if (MODE == 2) srv.u = __ldg(sr + cv);
#pragma unroll
    for (int k = 0; k < V; ++k)
      backward1<D, MODE>(gv.v[k], yv.v[k], sv.v[k], MODE == 2 ? srv.v[k] : 0,
                         gxv.v[k], grv.v[k]);
    gx[i] = gxv.u;
    if (MODE) gr[i] = grv.u;
    cv += cstep;
    if (cv >= cvec) cv -= cvec;
  }
}

template <class D, int MODE>
__global__ void __launch_bounds__(kThreads)
backward_strided(const typename D::S* __restrict__ g,
                 const typename D::S* __restrict__ y,
                 const typename D::S* __restrict__ s,
                 const typename D::S* __restrict__ sr,
                 typename D::S* __restrict__ gx,
                 typename D::S* __restrict__ gr, Shapes sh, int64_t n) {
  const int64_t step = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += step) {
    const int64_t w = i % sh.size[3];
    int64_t t = i / sh.size[3];
    const int64_t h = t % sh.size[2];
    t /= sh.size[2];
    const int64_t c = t % sh.size[1];
    const int64_t b = t / sh.size[1];
    typename D::S dx, dr = 0;
    backward1<D, MODE>(g[offset(sh, 0, b, c, h, w)],
                       y[offset(sh, 1, b, c, h, w)], s[c],
                       MODE == 2 ? sr[c] : 0, dx, dr);
    gx[offset(sh, 2, b, c, h, w)] = dx;
    if (MODE) gr[offset(sh, 3, b, c, h, w)] = dr;
  }
}

template <class D, int MODE>
int backward_launch(const void* g, const void* y, const void* s,
                    const void* sr, void* gx, void* gr, const Shapes* sh,
                    int64_t n, int c, int max_blocks, cudaStream_t stream) {
  using S = typename D::S;
  constexpr int V = 16 / sizeof(S);
  if (sh == nullptr) {
    const int64_t nvec = n / V;
    backward_vec<D, MODE>
        <<<blocks_for(nvec, max_blocks), kThreads, 0, stream>>>(
            (const uint4*)g, (const uint4*)y, (const uint4*)s,
            (const uint4*)sr, (uint4*)gx, (uint4*)gr, nvec, c / V);
  } else {
    backward_strided<D, MODE>
        <<<blocks_for(n, max_blocks), kThreads, 0, stream>>>(
            (const S*)g, (const S*)y, (const S*)s, (const S*)sr, (S*)gx,
            (S*)gr, *sh, n);
  }
  return (int)cudaGetLastError();
}

template <class D>
int backward(const void* g, const void* y, const void* s, const void* sr,
             void* gx, void* gr, const Shapes* sh, int64_t n, int c,
             int mode, int max_blocks, cudaStream_t stream) {
  if (mode == 0)
    return backward_launch<D, 0>(g, y, s, sr, gx, gr, sh, n, c, max_blocks,
                                 stream);
  if (mode == 1)
    return backward_launch<D, 1>(g, y, s, sr, gx, gr, sh, n, c, max_blocks,
                                 stream);
  return backward_launch<D, 2>(g, y, s, sr, gx, gr, sh, n, c, max_blocks,
                               stream);
}

}  // namespace

// x, r, y [N, C, H, W] (strides in `sh`, operands 0, 1, 2), s, o, s_r, o_r
// [C] contiguous; r, s_r, o_r may be null when has_r / has_rbn are 0.  A
// null `sh` takes the vector path: x, r and y share one dense
// channels-innermost layout, C % (16 B / element) == 0 and every pointer is
// 16-byte aligned.  -> cudaError_t of the launch.
extern "C" int bn_act_f32(const void* x, const void* s, const void* o,
                          const void* r, const void* sr, const void* orr,
                          void* y, const Shapes* sh, int64_t n, int c,
                          int has_r, int has_rbn, int max_blocks,
                          cudaStream_t stream) {
  return forward<F32>(x, s, o, r, sr, orr, y, sh, n, c, has_r, has_rbn,
                      max_blocks, stream);
}

extern "C" int bn_act_bf16(const void* x, const void* s, const void* o,
                           const void* r, const void* sr, const void* orr,
                           void* y, const Shapes* sh, int64_t n, int c,
                           int has_r, int has_rbn, int max_blocks,
                           cudaStream_t stream) {
  return forward<BF16>(x, s, o, r, sr, orr, y, sh, n, c, has_r, has_rbn,
                       max_blocks, stream);
}

// g, y, g_x, g_r (operands 0-3 of `sh`, null as above); mode 0: no g_r,
// 1: g_r = m, 2: g_r = m * s_r.
extern "C" int bn_act_backward_f32(const void* g, const void* y,
                                   const void* s, const void* sr, void* gx,
                                   void* gr, const Shapes* sh, int64_t n,
                                   int c, int mode, int max_blocks,
                                   cudaStream_t stream) {
  return backward<F32>(g, y, s, sr, gx, gr, sh, n, c, mode, max_blocks,
                       stream);
}

extern "C" int bn_act_backward_bf16(const void* g, const void* y,
                                    const void* s, const void* sr, void* gx,
                                    void* gr, const Shapes* sh, int64_t n,
                                    int c, int mode, int max_blocks,
                                    cudaStream_t stream) {
  return backward<BF16>(g, y, s, sr, gx, gr, sh, n, c, mode, max_blocks,
                        stream);
}
