// Shot-fused CISA attention core, float32, for Hopper (sm_90a).
//
//   out[g, i, :] = mean_s ( softmax_n(scale * q[g,i,:] . k[g,s,n,:])
//                           + gamma * u[g,s,n] ) @ v[g,s,:,:]
//
// Replaces the Pallas TPU kernel `_kernel_shots` of
// dana_tpu/ops/cisa_attention.py (pallas_call in `_fused_shots`), which
// the detector runs at two sites: the RPN (query map tokens attend
// 3 x 400 support tokens) and the RoI head (R*49 RoI tokens attend
// 3 x 49 pooled support tokens).
//
// Bound on this card: operations.  2*Nq*Ns*(D + C) per shot on plain
// float32 units (67 TFLOP/s on an H100 SXM at 700 W); at the RPN site of
// a 608x1024 query (Nq 2432, Ns 400, D 256, C 1024, 3 shots) that is
// 7.47 GFLOP per image against 10 MB of q and output traffic.
//
// Design: one block per (g, tile of BQ=16 query rows), 256 threads.  The
// query tile sits in shared memory; keys stream through shared memory in
// chunks of 64 rows padded to D+4 floats, so rows stay float4-aligned and
// eight lanes of a float4 read hit 32 distinct banks.  Each thread scores
// 4 query rows against one key from float4 reads (the query reads are
// warp broadcasts), 8 read wavefronts per 16 multiply-adds.  The [Ns, BQ]
// score tile stays in shared memory, so the attention matrix never
// reaches device memory.  Softmax runs one warp
// per row in float32 (max, exp, sum, divide, + gamma*u).  probs @ v_s
// accumulates into registers: each thread owns 4 channels x 16 rows
// (64 accumulators), reads v once per (n, channel) with neighbouring
// threads on neighbouring addresses, and reads probs as float4
// broadcasts.  The shot mean is taken in registers at the end, so the
// [S, Nq, C] per-shot outputs are never stored.  Score tile size grows
// with Ns; the launcher refuses shapes whose tile exceeds the 227 KB of
// shared memory a block may use.  Ns = 1 and ragged Nq are handled
// (padded query rows are zero and are not written).  D must be a
// multiple of 4 and q, k 16-byte aligned (float4 loads).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 16;          // query rows per block
constexpr int KN = 64;          // key rows staged per chunk
constexpr int THREADS = 256;
constexpr int RPT = BQ * KN / THREADS;  // query rows per thread, score phase
constexpr int CPT = 4;          // channels per thread per channel chunk
constexpr int CCHUNK = THREADS * CPT;
constexpr size_t SMEM_LIMIT = 232448;   // bytes a block may use on sm_90

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(THREADS)
cisa_shots_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ u,
                  float* __restrict__ out, int S, int Nq, int Ns, int D,
                  int C, float scale, float gamma) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ks_stride = D + 4;            // float4-aligned key rows
  float* qs = smem;                       // [BQ][D]
  float* ks = qs + BQ * D;                // [KN][D + 4]
  float* ps = ks + KN * ks_stride;         // [Ns][BQ]
  const int g = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int rows = min(BQ, Nq - q0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d4n = D / 4;

  const float4* qg = reinterpret_cast<const float4*>(q + ((size_t)g * Nq + q0) * D);
  for (int i = tid; i < BQ * d4n; i += THREADS) {
    reinterpret_cast<float4*>(qs)[i] =
        (i / d4n) < rows ? qg[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // score phase: thread (key kn, row group rg) owns rows rg + j*(BQ/RPT)
  const int kn = tid % KN, rg = tid / KN;

  for (int c0 = 0; c0 < C; c0 += CCHUNK) {
    float acc[BQ][CPT];
#pragma unroll
    for (int i = 0; i < BQ; ++i) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
    }
    for (int s = 0; s < S; ++s) {
      const size_t gs = (size_t)g * S + s;
      const float* kg = k + gs * Ns * D;
      const float* vg = v + gs * Ns * C;
      const float* ug = u + gs * Ns;

      // scores: ps[n][r] = scale * q[r] . k[n]
      for (int n0 = 0; n0 < Ns; n0 += KN) {
        const int nk = min(KN, Ns - n0);
        __syncthreads();                  // ks and ps are free to write
        const float4* kg4 = reinterpret_cast<const float4*>(kg + (size_t)n0 * D);
        for (int i = tid; i < KN * d4n; i += THREADS) {
          const int r = i / d4n, d4 = i - r * d4n;
          reinterpret_cast<float4*>(ks + r * ks_stride)[d4] =
              r < nk ? kg4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        __syncthreads();
        if (kn < nk) {
          const float4* kr = reinterpret_cast<const float4*>(ks + kn * ks_stride);
          float dot[RPT];
#pragma unroll
          for (int j = 0; j < RPT; ++j) dot[j] = 0.f;
          for (int d4 = 0; d4 < d4n; ++d4) {
            const float4 kk = kr[d4];
#pragma unroll
            for (int j = 0; j < RPT; ++j) {
              const float4 qq = reinterpret_cast<const float4*>(
                  qs + (rg + j * (BQ / RPT)) * D)[d4];
              dot[j] = fmaf(qq.x, kk.x, dot[j]);
              dot[j] = fmaf(qq.y, kk.y, dot[j]);
              dot[j] = fmaf(qq.z, kk.z, dot[j]);
              dot[j] = fmaf(qq.w, kk.w, dot[j]);
            }
          }
#pragma unroll
          for (int j = 0; j < RPT; ++j) {
            ps[(n0 + kn) * BQ + rg + j * (BQ / RPT)] = dot[j] * scale;
          }
        }
      }
      __syncthreads();

      // row softmax in float32, plus the unary term
      for (int r = warp; r < BQ; r += THREADS / 32) {
        float m = -INFINITY;
        for (int n = lane; n < Ns; n += 32) m = fmaxf(m, ps[n * BQ + r]);
        m = warp_max(m);
        float sum = 0.f;
        for (int n = lane; n < Ns; n += 32) {
          const float e = expf(ps[n * BQ + r] - m);
          ps[n * BQ + r] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        for (int n = lane; n < Ns; n += 32) {
          ps[n * BQ + r] = ps[n * BQ + r] / sum + gamma * ug[n];
        }
      }
      __syncthreads();

      // acc += probs @ v_s over this thread's channels
      for (int n = 0; n < Ns; ++n) {
        float vv[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = c0 + tid + j * THREADS;
          vv[j] = c < C ? vg[(size_t)n * C + c] : 0.f;
        }
        const float4* pr = reinterpret_cast<const float4*>(ps + n * BQ);
#pragma unroll
        for (int i4 = 0; i4 < BQ / 4; ++i4) {
          const float4 p = pr[i4];
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            acc[4 * i4 + 0][j] = fmaf(p.x, vv[j], acc[4 * i4 + 0][j]);
            acc[4 * i4 + 1][j] = fmaf(p.y, vv[j], acc[4 * i4 + 1][j]);
            acc[4 * i4 + 2][j] = fmaf(p.z, vv[j], acc[4 * i4 + 2][j]);
            acc[4 * i4 + 3][j] = fmaf(p.w, vv[j], acc[4 * i4 + 3][j]);
          }
        }
      }
    }

    float* og = out + ((size_t)g * Nq + q0) * C;
#pragma unroll
    for (int i = 0; i < BQ; ++i) {
      if (i < rows) {
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = c0 + tid + j * THREADS;
          if (c < C) og[(size_t)i * C + c] = acc[i][j] / (float)S;
        }
      }
    }
  }
}

}  // namespace

extern "C" size_t cisa_shots_smem_bytes(int Ns, int D) {
  return sizeof(float) * ((size_t)BQ * D + (size_t)KN * (D + 4) + (size_t)Ns * BQ);
}

extern "C" size_t cisa_shots_smem_limit() { return SMEM_LIMIT; }

// Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int cisa_shots_f32(const void* q, const void* k, const void* v,
                              const void* u, void* out, int G, int S, int Nq,
                              int Ns, int D, int C, float scale, float gamma,
                              void* stream) {
  const size_t smem = cisa_shots_smem_bytes(Ns, D);
  if (smem > SMEM_LIMIT || D % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      cisa_shots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Nq + BQ - 1) / BQ, G);
  cisa_shots_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)u,
      (float*)out, S, Nq, Ns, D, C, scale, gamma);
  return (int)cudaGetLastError();
}
