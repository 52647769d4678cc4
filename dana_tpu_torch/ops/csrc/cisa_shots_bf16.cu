// Shot-fused CISA attention core, bfloat16, on Hopper's tensor cores
// (sm_90a).
//
//   out[g, i, :] = bf16( mean_s ( P[g,s,i,:] @ v[g,s,:,:] ) ),
//   P[g,s,i,n] = bf16( softmax_n(scale * q[g,i,:] . k[g,s,n,:])
//                      + gamma * u[g,s,n] )
//
// Replaces the Pallas TPU kernel `_kernel_shots` of
// dana_tpu/ops/cisa_attention.py (pallas_call in `_fused_shots`) on
// bfloat16 inputs, the precision recipe's attention (TPU.COMPUTE_DTYPE
// bfloat16 with ATTENTION_DTYPE following it), at the detector's two sites:
// the RPN (query map tokens attend 3 x 400 support tokens) and the RoI
// head (R*49 RoI tokens attend 3 x 49 pooled support tokens).  The
// single-group `_kernel` (`_fused`) is this kernel at S = 1.  The
// arithmetic is the JAX kernel's: both products take bf16 operands with
// float32 sums (`mma.sync.m16n8k16` .bf16, float32 accumulators: each
// product of two bf16 values is exact in float32); the scores are scaled,
// the softmax and the unary term are float32; the probabilities are
// rounded to bf16 as the A operand of the PV product (JAX's
// `probs.astype(v.dtype)`); the shot mean is taken in float32 and rounded
// to bf16 once.  The float32 kernel is csrc/cisa_shots.cu.
//
// Bound on this card: operations, 2*Nq*Ns*(D + C) per shot, at the 989
// TFLOP/s of dense bf16 on an H100 SXM.
//
// Design, right and simple first (`wgmma` and TMA are later work): one
// block per (g, tile of BQ = 32 query rows), 8 warps, one warp per 16 rows
// x a quarter of the keys (scores) or of the channel slice (PV).  For each
// slice of CS = 4 * 8 * NT channels (one slice at C <= 1024) and each shot:
//   1. scores: the q tile [32 x D] is resident; k streams in chunks of 64
//      keys x all of D through a double buffer of 16-byte `cp.async`
//      copies; a warp's 16 x 16 score tile (ldmatrix fragments of q and k)
//      is scaled and stored as float32 into S [32][SST]; keys past Ns get
//      -inf.  The attention matrix never reaches device memory.
//   2. softmax over each row of S in float32, + gamma * u, rounded to bf16
//      into P [32][PST]; keys past Ns hold 0.  The first v tile is in
//      flight meanwhile.
//   3. acc += P @ v over the shot's keys: v streams in tiles of 16 keys x
//      CS channels through a double buffer (keys past Ns and channels past
//      C load as zeros); B fragments by `ldmatrix.trans`.  A warp's 16 x
//      8*NT outputs stay in registers across the shots, so per-shot outputs
//      are never stored.
// The epilogue divides by S and stores bf16 pairs.  Ragged Nq (padded rows
// are zero and are not written), D a multiple of 16, C a multiple of 8 and
// 16-byte aligned q, k, v are taken; the wrapper refuses anything else, and
// shapes whose shared memory exceeds the 227 KB a block may use.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BQ = 32;                  // query rows a block
constexpr int KC = 64;                  // keys a k chunk (4 warps x 16)
constexpr int VK = 16;                  // keys a v tile (one mma k-step)
constexpr size_t SMEM_LIMIT = 232448;   // bytes a block may use on sm_90

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared-memory strides (elements) and the layout's bytes.  Row strides of
// the bf16 tiles are 8 halves past a multiple of 16, so the 8 rows an
// ldmatrix reads hit 8 distinct 16-byte bank groups; the float32 score rows
// are 8 floats past a multiple of 32, so a half-warp's float2 stores of 4
// rows hit 32 distinct banks.
struct Layout {
  int ns16, qst, sst, pst, kst, vst;
  size_t q, s, p, ring;                 // bytes of each region
  __host__ __device__ Layout(int Ns, int D, int cs) {
    ns16 = round_up(Ns, 16);
    qst = D + 8;
    kst = D + 8;
    sst = round_up(ns16, 32) + 8;
    pst = ns16 + 8;
    vst = cs + 8;
    q = (size_t)2 * BQ * qst;
    s = (size_t)4 * BQ * sst;
    p = (size_t)2 * BQ * pst;
    const size_t kring = (size_t)2 * 2 * KC * kst;
    const size_t vring = (size_t)2 * 2 * VK * vst;
    ring = kring > vring ? kring : vring;
  }
  __host__ __device__ size_t bytes() const { return q + s + p + ring; }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// ldmatrix reads what plain stores and cp.async wrote before a barrier:
// the "memory" clobber keeps it after them.

// c += a (16 x 16, row) @ b (16 x 8, col): bf16 operands, float32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// NT: n-tiles of 8 channels a warp owns in the PV phase; a channel slice is
// CS = 4 * 8 * NT channels (the 4 warps along the channels).
template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
cisa_shots_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ u,
                       __nv_bfloat16* __restrict__ out, int S, int Nq, int Ns,
                       int D, int C, float scale, float gamma) {
  constexpr int CS = 4 * 8 * NT;
  const Layout L(Ns, D, CS);
  extern __shared__ float4 smem4[];
  char* const base = reinterpret_cast<char*>(smem4);
  __nv_bfloat16* const qs = reinterpret_cast<__nv_bfloat16*>(base);
  float* const sc = reinterpret_cast<float*>(base + L.q);
  __nv_bfloat16* const ps = reinterpret_cast<__nv_bfloat16*>(base + L.q + L.s);
  __nv_bfloat16* const ring =
      reinterpret_cast<__nv_bfloat16*>(base + L.q + L.s + L.p);

  const int gi = blockIdx.y, q0 = blockIdx.x * BQ;
  const int rows = min(BQ, Nq - q0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int wr = warp & 1, wc = warp >> 1;
  const int ns16 = L.ns16, nkc = (Ns + KC - 1) / KC, nvt = ns16 / VK;
  const int d8 = D / 8;                               // 16-byte chunks a row
  const __nv_bfloat16* const qg = q + ((size_t)gi * Nq + q0) * D;
  __nv_bfloat16* const og = out + ((size_t)gi * Nq + q0) * C;

  // the q tile, once (its copies complete with the first k chunk's)
  for (int i = tid; i < BQ * d8; i += THREADS) {
    const int r = i / d8, d = i % d8 * 8;
    const bool ok = r < rows;
    cp_async16(qs + r * L.qst + d, ok ? qg + (size_t)r * D + d : q, ok);
  }

  // ldmatrix lane offsets: A tiles (rows l & 15, columns (l >> 4) * 8); k as
  // B (keys (l & 7) + (l >> 4) * 8, depth ((l >> 3) & 1) * 8); v as B by
  // .trans (keys (l & 7) + ((l >> 3) & 1) * 8, channels (l >> 4) * 8)
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int kb_key = (lane & 7) + (lane >> 4) * 8, kb_d = ((lane >> 3) & 1) * 8;
  const int vb_key = (lane & 7) + ((lane >> 3) & 1) * 8, vb_c = (lane >> 4) * 8;

  for (int c0 = 0; c0 < C; c0 += CS) {
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    for (int s = 0; s < S; ++s) {
      const __nv_bfloat16* const kg = k + ((size_t)gi * S + s) * Ns * D;
      const __nv_bfloat16* const vg = v + ((size_t)gi * S + s) * Ns * C;
      auto load_k = [&](int kc) {          // chunk kc into stage kc & 1
        __nv_bfloat16* dst = ring + (kc & 1) * KC * L.kst;
        const int n0 = kc * KC;
        for (int i = tid; i < KC * d8; i += THREADS) {
          const int r = i / d8, d = i % d8 * 8;
          const bool ok = n0 + r < Ns;
          cp_async16(dst + r * L.kst + d,
                     ok ? kg + (size_t)(n0 + r) * D + d : k, ok);
        }
        cp_commit();
      };
      auto load_v = [&](int vt) {          // tile vt into stage vt & 1
        __nv_bfloat16* dst = ring + (vt & 1) * VK * L.vst;
        const int n0 = vt * VK;
        for (int i = tid; i < VK * (CS / 8); i += THREADS) {
          const int r = i / (CS / 8), c = i % (CS / 8) * 8;
          const bool ok = n0 + r < Ns && c0 + c < C;
          cp_async16(dst + r * L.vst + c,
                     ok ? vg + (size_t)(n0 + r) * C + c0 + c : v, ok);
        }
        cp_commit();
      };

      // ---- 1. scores of shot s into S
      load_k(0);
      for (int kc = 0; kc < nkc; ++kc) {
        cp_wait_all();                   // chunk kc (and q) have landed
        __syncthreads();                 // ... for all; chunk kc-1 is read
        if (kc + 1 < nkc) load_k(kc + 1);
        const int key0 = kc * KC + wc * 16;
        if (key0 < ns16) {               // the warp's 16 keys hold some < Ns
          const __nv_bfloat16* kb = ring + (kc & 1) * KC * L.kst;
          float sacc[2][4] = {};
          for (int kk = 0; kk < D; kk += 16) {
            uint32_t a[4], b[4];
            ldmatrix_x4(a, qs + (wr * 16 + a_row) * L.qst + kk + a_col);
            ldmatrix_x4(b, kb + (wc * 16 + kb_key) * L.kst + kk + kb_d);
            mma(sacc[0], a, b[0], b[1]);
            mma(sacc[1], a, b[2], b[3]);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int key = key0 + j * 8 + 2 * tq;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = wr * 16 + gr + 8 * h;
              float2 val;
              val.x = key < Ns ? sacc[j][2 * h] * scale : -INFINITY;
              val.y = key + 1 < Ns ? sacc[j][2 * h + 1] * scale : -INFINITY;
              *reinterpret_cast<float2*>(sc + row * L.sst + key) = val;
            }
          }
        }
      }
      __syncthreads();                   // S is complete; the k ring is read

      // ---- 3's first v tile, in flight during 2.
      load_v(0);

      // ---- 2. softmax over each row of S, + gamma * u, into P as bf16
      const __nv_bfloat16* const ug = u + ((size_t)gi * S + s) * Ns;
      for (int r = warp; r < BQ; r += WARPS) {
        float* sr = sc + r * L.sst;
        __nv_bfloat16* pr = ps + r * L.pst;
        float m = -INFINITY;
        for (int n = lane; n < Ns; n += 32) m = fmaxf(m, sr[n]);
        m = warp_max(m);
        float sum = 0.f;
        for (int n = lane; n < Ns; n += 32) {
          const float e = expf(sr[n] - m);
          sr[n] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        for (int n = lane; n < ns16; n += 32) {
          const float p = n < Ns
              ? __fadd_rn(__fdiv_rn(sr[n], sum),
                          __fmul_rn(gamma, __bfloat162float(ug[n])))
              : 0.f;
          pr[n] = __float2bfloat16_rn(p);
        }
      }

      // ---- 3. acc += P @ v over the shot's keys
      for (int vt = 0; vt < nvt; ++vt) {
        cp_wait_all();                   // tile vt has landed
        __syncthreads();                 // ... for all; P is written; vt-1 read
        if (vt + 1 < nvt) load_v(vt + 1);
        const __nv_bfloat16* vb = ring + (vt & 1) * VK * L.vst;
        uint32_t a[4];
        ldmatrix_x4(a, ps + (wr * 16 + a_row) * L.pst + vt * VK + a_col);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, vb + vb_key * L.vst + wc * 8 * NT + j * 8 + vb_c);
          mma(acc[j], a, b[0], b[1]);
          mma(acc[j + 1], a, b[2], b[3]);
        }
      }
      __syncthreads();                   // v ring and P are read
    }

    // ---- the shot mean, rounded to bf16 once
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = c0 + wc * 8 * NT + j * 8 + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wr * 16 + gr + 8 * h;
        if (row < rows && c < C) {
          *reinterpret_cast<__nv_bfloat162*>(og + (size_t)row * C + c) =
              __floats2bfloat162_rn(__fdiv_rn(acc[j][2 * h], (float)S),
                                    __fdiv_rn(acc[j][2 * h + 1], (float)S));
        }
      }
    }
  }
}

int pick_nt(int C) { return C > 512 ? 32 : 16; }

size_t smem_bytes(int Ns, int D, int C) {
  return Layout(Ns, D, 4 * 8 * pick_nt(C)).bytes();
}

template <int NT>
int launch(const void* q, const void* k, const void* v, const void* u,
           void* out, int G, int S, int Nq, int Ns, int D, int C, float scale,
           float gamma, cudaStream_t stream) {
  const size_t smem = Layout(Ns, D, 4 * 8 * NT).bytes();
  cudaError_t e = cudaFuncSetAttribute(
      cisa_shots_bf16_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Nq + BQ - 1) / BQ, G);
  cisa_shots_bf16_kernel<NT><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)u, (__nv_bfloat16*)out,
      S, Nq, Ns, D, C, scale, gamma);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory the kernel takes at (Ns, D, C); a shape above the limit
// is refused.
extern "C" size_t cisa_shots_bf16_smem_bytes(int Ns, int D, int C) {
  return smem_bytes(Ns, D, C);
}

extern "C" size_t cisa_shots_bf16_smem_limit() { return SMEM_LIMIT; }

// q [G,Nq,D], k [G,S,Ns,D], v [G,S,Ns,C], u [G,S,Ns] bf16 -> out [G,Nq,C]
// bf16, all contiguous.  Launches on `stream`; returns the cudaError_t of
// the launch.
extern "C" int cisa_shots_bf16(const void* q, const void* k, const void* v,
                               const void* u, void* out, int G, int S, int Nq,
                               int Ns, int D, int C, float scale, float gamma,
                               void* stream) {
  if (D % 16 != 0 || C % 8 != 0 || smem_bytes(Ns, D, C) > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  if (G == 0 || Nq == 0) return (int)cudaSuccess;
  auto* fn = pick_nt(C) == 32 ? launch<32> : launch<16>;
  return fn(q, k, v, u, out, G, S, Nq, Ns, D, C, scale, gamma,
            (cudaStream_t)stream);
}
