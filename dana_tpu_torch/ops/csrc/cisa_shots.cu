// Shot-fused CISA attention core, float32, on Hopper's tensor cores (sm_90a).
//
//   out[g, i, :] = mean_s ( softmax_n(scale * q[g,i,:] . k[g,s,n,:])
//                           + gamma * u[g,s,n] ) @ v[g,s,:,:]
//
// Replaces the Pallas TPU kernel `_kernel_shots` of
// dana_tpu/ops/cisa_attention.py (pallas_call in `_fused_shots`), which
// the detector runs at two sites: the RPN (query map tokens attend
// 3 x 400 support tokens) and the RoI head (R*49 RoI tokens attend
// 3 x 49 pooled support tokens).  The single-group `_kernel` (`_fused`)
// is this kernel at S = 1.
//
// Bound on this card: operations, 2*Nq*Ns*(D + C) per shot.  Both products
// run as 3xTF32 on the tensor cores (`mma.sync.m16n8k8` .tf32, float32
// accumulators): each float32 operand x is split into big = tf32(x),
// rounded to nearest with ties away as `cvt.rna.tf32.f32` rounds, and
// small = x - big, and a*b is taken as a_small*b_big + a_big*b_small +
// a_big*b_big.  One TF32 pass keeps only ~1e-4 of the output
// (tests/test_torch_port_tf32.py); the split keeps float32 accuracy at
// three passes, so the bound is 495/3 = 165 TFLOP/s on an H100 SXM at
// 700 W.  The split is made per fragment, in registers, as operands leave
// shared memory, on the integer units: `cvt` runs at a fraction of their
// rate.  small is handed over with its rounding increment added and its low
// 13 bits left in place: the tensor core reads the top 19 bits of a .tf32
// operand, so that is small rounded to nearest as well.
//
// Design: one block per (g, tile of BQ query rows), 8 warps.  Tiles, in
// order of preference: BQ = 64 with the score tiles of all S shots
// resident (the RoI sites, Ns 49); BQ = 32 with all shots' tiles or one
// shot's at a time (R = S or 1; the RPN sites, Ns 400, take R = 1: 64-row
// tiles there leave too few blocks to fill the card); BQ = 16 likewise.
// For each group of R shots:
//   1. scores, transposed (scores^T = k q^T, keys as the M dimension):
//      q [BQ x D] is resident (rows padded to 4 mod 8 floats, so fragment
//      reads hit 32 distinct banks); k streams through a ring of [KC keys x
//      DS depth] slices (256 x 64 at BQ 32, 64 x 64 at BQ 64) by 16-byte
//      `cp.async`, one barrier per stage.  A warp owns 32 keys x 32 rows
//      (16 x 32 at BQ 64).  Scores are scaled, keys past Ns set to -inf
//      (zero-filled keys would score 0), and stored into the resident tile
//      P [R][BQ][Ns8 + 4] (Ns8 = Ns rounded up to 8): the attention matrix
//      never reaches device memory.
//   2. softmax in float32 over each row of P, then + gamma * u; padded key
//      columns hold 0.
//   3. probs @ v: v streams through a double buffer of [VK keys x CS
//      channels] tiles (32 x 512 at BQ 32, 64 x 256 at BQ 64; keys past Ns
//      and channels past C load as 0), the first in flight during the
//      softmax.  A warp owns a 32 x 64 output tile in registers; the channel
//      slices loop outside the shots of the group, so their sum stays in
//      registers and per-shot outputs are never stored.  With R < S each
//      group's sum is added into the block's own output rows (no atomics).
// Full key chunks and v tiles take a copy of the inner loops without the
// per-tile guards of the ragged ones, so their loads, splits and mmas
// interleave freely.  What bounds it at the RPN site is the L2: every
// 32-row block reads all of its group's v (4.9 MB), 3 GB a call.  Ragged
// Nq (padded rows are zero and are not written), C a multiple of 4 with a
// masked tail, D a multiple of 8 and 16-byte aligned q, k and v are taken;
// the wrapper refuses anything else, and shapes whose BQ = 16, one-shot
// tile exceeds the 227 KB of shared memory a block may use.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr size_t SMEM_LIMIT = 232448;   // bytes a block may use on sm_90

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

template <int BQ>
struct Tile {
  // score phase, transposed (scores^T = k q^T): warp tiles of 16*SMT keys
  // x 8*SNT query rows, SWR warps along the rows and SWK along the keys;
  // KC keys a chunk (64 at BQ 64: the RoI site has 49 keys)
  static constexpr int SNT = BQ == 16 ? 2 : 4, SWR = BQ / (8 * SNT);
  static constexpr int SWK = WARPS / SWR, SMT = BQ == 64 ? 1 : 2;
  static constexpr int KC = SWK * 16 * SMT;
  // depth of a staged k slice, and its row stride (floats, 4 mod 8)
  static constexpr int DS = BQ == 16 ? 32 : 64, KST = DS + 4;
  // PV phase: warp tiles of (16*MT) rows x (8*NT) channels
  static constexpr int MT = BQ >= 32 ? 2 : 1, WR = BQ / (16 * MT);
  static constexpr int WC = WARPS / WR, NT = BQ == 16 ? 4 : 8;
  static constexpr int CS = 8 * NT * WC, VST = CS + 8;  // stride 8 mod 32
  // keys per v tile; stages in the cp.async rings of k and of v tiles
  static constexpr int NSK = BQ == 64 ? 4 : 2;
  static constexpr int VK = BQ == 64 ? 64 : 32, NSV = 2;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = big + small as .tf32 operands (see the head of the file)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of m16n8k8 .tf32 at p = &A[g][t] of a row-major tile with
// row stride ld: (g, t), (g+8, t), (g, t+4), (g+8, t+4)
__device__ __forceinline__ void load_a(const float* p, int ld,
                                       uint32_t (&ab)[4], uint32_t (&as)[4]) {
  split(p[0], ab[0], as[0]);
  split(p[8 * ld], ab[1], as[1]);
  split(p[4], ab[2], as[2]);
  split(p[8 * ld + 4], ab[3], as[3]);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// sacc[mi][j] += k slice [16 keys x DS] (m tile mi) @ q slice^T [DS x 8
// rows] (n tile j), for the first mtv of the SMT key tiles.  Called with
// mtv = SMT for a full chunk, so that the common case compiles without
// branches between the tiles.
template <int SMT, int SNT, int DS, int KST>
__device__ __forceinline__ void score_slice(float (&sacc)[SMT][SNT][4],
                                            const float* ka, const float* qb,
                                            int qst, int mtv) {
#pragma unroll
  for (int kk = 0; kk < DS; kk += 8) {
    uint32_t ab[SMT][4], as[SMT][4], bb[SNT][2], bs[SNT][2];
#pragma unroll
    for (int mi = 0; mi < SMT; ++mi) {
      if (mi < mtv) load_a(ka + mi * 16 * KST + kk, KST, ab[mi], as[mi]);
    }
#pragma unroll
    for (int j = 0; j < SNT; ++j) {
      const float* qr = qb + j * 8 * qst + kk;
      split(qr[0], bb[j][0], bs[j][0]);
      split(qr[4], bb[j][1], bs[j][1]);
    }
    // 3xTF32: the small cross terms, then big x big, each over all tiles
#pragma unroll
    for (int mi = 0; mi < SMT; ++mi)
#pragma unroll
      for (int j = 0; j < SNT; ++j) if (mi < mtv) mma(sacc[mi][j], as[mi], bb[j]);
#pragma unroll
    for (int mi = 0; mi < SMT; ++mi)
#pragma unroll
      for (int j = 0; j < SNT; ++j) if (mi < mtv) mma(sacc[mi][j], ab[mi], bs[j]);
#pragma unroll
    for (int mi = 0; mi < SMT; ++mi)
#pragma unroll
      for (int j = 0; j < SNT; ++j) if (mi < mtv) mma(sacc[mi][j], ab[mi], bb[j]);
  }
}

// acc += probs [16*MT x nk] @ v tile [nk x 8*NT] (nk a multiple of 8, at
// most VK); called with nk = VK for a full tile, as above.
template <int MT, int NT, int VK, int VST>
__device__ __forceinline__ void pv_tile(float (&acc)[MT][NT][4],
                                        const float* pa, int ps,
                                        const float* vb, int nk) {
#pragma unroll
  for (int kk = 0; kk < VK; kk += 8) {
    if (kk < nk) {
      uint32_t ab[MT][4], as[MT][4], bb[NT][2], bs[NT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        load_a(pa + mi * 16 * ps + kk, ps, ab[mi], as[mi]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* vr = vb + kk * VST + j * 8;
        split(vr[0], bb[j][0], bs[j][0]);
        split(vr[4 * VST], bb[j][1], bs[j][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma(acc[mi][j], as[mi], bb[j]);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma(acc[mi][j], ab[mi], bs[j]);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma(acc[mi][j], ab[mi], bb[j]);
    }
  }
}

template <int BQ>
__global__ void __launch_bounds__(THREADS, 1)
cisa_shots_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ u,
                  float* __restrict__ out, int S, int R, int Nq, int Ns,
                  int D, int C, float scale, float gamma) {
  using T = Tile<BQ>;
  constexpr int KC = T::KC, DS = T::DS, KST = T::KST, VK = T::VK;
  constexpr int NSK = T::NSK, NSV = T::NSV;
  extern __shared__ float4 smem4[];
  const int ns8 = round_up(Ns, 8), ns16 = round_up(Ns, 16), ps = ns8 + 4;
  const int dp = round_up(D, DS), qst = dp + 4;
  float* const P = reinterpret_cast<float*>(smem4);   // [R][BQ][ps]
  float* const qs = P + R * BQ * ps;                   // [BQ][qst]
  float* const ks = qs + BQ * qst;                     // [NSK][KC][KST]
  float* const vs = qs;                                // [NSV][VK][VST]

  const int gi = blockIdx.y, q0 = blockIdx.x * BQ;
  const int rows = min(BQ, Nq - q0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int nd = dp / DS, nkc = (Ns + KC - 1) / KC;
  const int nvc = (ns8 + VK - 1) / VK, ncs = (C + T::CS - 1) / T::CS;
  const float* const qg = q + ((size_t)gi * Nq + q0) * D;
  float* const og = out + ((size_t)gi * Nq + q0) * C;

  for (int s0 = 0; s0 < S; s0 += R) {
    const int rn = min(R, S - s0);

    // ---- 1. scores of shots s0 .. s0+rn-1 into P
    const int n_sc = rn * nkc * nd;
    auto load_k = [&](int it) {          // one cp.async group per item
      if (it < n_sc) {
        const int s = s0 + it / (nkc * nd), rem = it % (nkc * nd);
        const int n0 = rem / nd * KC, d0 = rem % nd * DS;
        const int nr = min(KC, ns16 - n0);  // whole m16 key tiles
        const float* kg = k + ((size_t)gi * S + s) * Ns * D;
        float* dst = ks + (it % NSK) * KC * KST;
        for (int i = tid; i < nr * (DS / 4); i += THREADS) {
          const int r = i / (DS / 4), d = i % (DS / 4) * 4;
          const bool ok = n0 + r < Ns && d0 + d < D;
          cp_async16(dst + r * KST + d,
                     ok ? kg + (size_t)(n0 + r) * D + d0 + d : k, ok);
        }
      }
      cp_commit();
    };
    for (int i = tid; i < BQ * (dp / 4); i += THREADS) {   // with k slice 0
      const int r = i / (dp / 4), d = i % (dp / 4) * 4;
      const bool ok = r < rows && d < D;
      cp_async16(qs + r * qst + d, ok ? qg + (size_t)r * D + d : q, ok);
    }
    for (int i = 0; i < NSK - 1; ++i) load_k(i);

    const int swr = warp / T::SWK, swk = warp % T::SWK;
    float sacc[T::SMT][T::SNT][4] = {};
    for (int it = 0; it < n_sc; ++it) {
      cp_wait<NSK - 2>();                // item it has landed
      __syncthreads();                   // ... for all; item it-1 is consumed
      load_k(it + NSK - 1);              // into item it-1's stage
      const int sl = it / (nkc * nd), rem = it % (nkc * nd);
      const int n0 = rem / nd * KC, d0 = rem % nd * DS;
      const int key0 = swk * 16 * T::SMT, row0 = swr * 8 * T::SNT;
      // this warp's m16 key tiles that hold keys below Ns
      const int mtv = (ns16 - n0 - key0) / 16;
      const float* ka = ks + (it % NSK) * KC * KST + (key0 + gr) * KST + tq;
      const float* qb = qs + (row0 + gr) * qst + d0 + tq;
      if (mtv >= T::SMT) {
        score_slice<T::SMT, T::SNT, DS, KST>(sacc, ka, qb, qst, T::SMT);
      } else {
        score_slice<T::SMT, T::SNT, DS, KST>(sacc, ka, qb, qst, mtv);
      }
      if (rem % nd == nd - 1) {          // this key chunk's scores are done
        // C fragment (key g [+8], row 2t [+1]) into P [row][key]
        float* pr = P + (sl * BQ + row0 + 2 * tq) * ps;
#pragma unroll
        for (int mi = 0; mi < T::SMT; ++mi) {
#pragma unroll
          for (int j = 0; j < T::SNT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = n0 + key0 + mi * 16 + gr + (e >> 1) * 8;
              if (key < ns8) {
                pr[(j * 8 + (e & 1)) * ps + key] =
                    key < Ns ? sacc[mi][j][e] * scale : -INFINITY;
              }
              sacc[mi][j][e] = 0.f;
            }
          }
        }
      }
    }
    __syncthreads();                     // q and k are consumed

    // ---- 3's first v tiles, in flight during 2.
    const int n_pv = ncs * rn * nvc;
    auto load_v = [&](int it) {          // one cp.async group per item
      if (it < n_pv) {
        const int ci = it / (rn * nvc), rem = it % (rn * nvc);
        const int s = s0 + rem / nvc, n0 = rem % nvc * VK;
        const int c0 = ci * T::CS, nr = min(VK, ns8 - n0);
        const float* vg = v + ((size_t)gi * S + s) * Ns * C;
        float* dst = vs + (it % NSV) * VK * T::VST;
        for (int i = tid; i < nr * (T::CS / 4); i += THREADS) {
          const int r = i / (T::CS / 4), c = i % (T::CS / 4) * 4;
          const bool ok = n0 + r < Ns && c0 + c < C;
          cp_async16(dst + r * T::VST + c,
                     ok ? vg + (size_t)(n0 + r) * C + c0 + c : v, ok);
        }
      }
      cp_commit();
    };
    for (int i = 0; i < NSV - 1; ++i) load_v(i);

    // ---- 2. softmax over each row of P, + gamma * u
    for (int r = warp; r < rn * BQ; r += WARPS) {
      float* pr = P + r * ps;
      const float* ur = u + ((size_t)gi * S + s0 + r / BQ) * Ns;
      float m = -INFINITY;
      for (int n = lane; n < Ns; n += 32) m = fmaxf(m, pr[n]);
      m = warp_max(m);
      float sum = 0.f;
      for (int n = lane; n < ns8; n += 32) {   // exp(-inf) = 0 past Ns
        const float e = expf(pr[n] - m);
        pr[n] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int n = lane; n < Ns; n += 32) pr[n] = pr[n] / sum + gamma * ur[n];
    }

    // ---- 3. out rows += probs @ v over the group's shots, per channel slice
    const int wr = warp / T::WC, wc = warp % T::WC;
    float acc[T::MT][T::NT][4] = {};
    for (int it = 0; it < n_pv; ++it) {
      cp_wait<NSV - 2>();
      __syncthreads();                   // also orders 2.'s writes to P
      load_v(it + NSV - 1);
      const int ci = it / (rn * nvc), rem = it % (rn * nvc);
      const int sl = rem / nvc, n0 = rem % nvc * VK;
      const int nk = min(VK, ns8 - n0);
      const float* vb = vs + (it % NSV) * VK * T::VST + tq * T::VST + wc * 8 * T::NT + gr;
      const float* pa = P + (sl * BQ + wr * 16 * T::MT + gr) * ps + n0 + tq;
      if (nk == VK) {
        pv_tile<T::MT, T::NT, VK, T::VST>(acc, pa, ps, vb, VK);
      } else {
        pv_tile<T::MT, T::NT, VK, T::VST>(acc, pa, ps, vb, nk);
      }
      if (rem == rn * nvc - 1) {         // this channel slice is summed
        const bool first = s0 == 0, last = s0 + rn == S;
        const int c = ci * T::CS + wc * 8 * T::NT + 2 * tq;
#pragma unroll
        for (int mi = 0; mi < T::MT; ++mi) {
#pragma unroll
          for (int j = 0; j < T::NT; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = wr * 16 * T::MT + mi * 16 + gr + 8 * h;
              const int col = c + j * 8;
              if (row < rows && col < C) {
                float2* o = reinterpret_cast<float2*>(og + (size_t)row * C + col);
                float2 val = make_float2(acc[mi][j][2 * h], acc[mi][j][2 * h + 1]);
                if (!first) {
                  const float2 prev = *o;
                  val.x += prev.x;
                  val.y += prev.y;
                }
                if (last) {
                  val.x /= (float)S;
                  val.y /= (float)S;
                }
                *o = val;
              }
              acc[mi][j][2 * h] = 0.f;
              acc[mi][j][2 * h + 1] = 0.f;
            }
          }
        }
      }
    }
    __syncthreads();                     // v and P are consumed
  }
}

template <int BQ>
size_t smem_bytes(int r, int Ns, int D) {
  using T = Tile<BQ>;
  const size_t p = (size_t)r * BQ * (round_up(Ns, 8) + 4);
  const size_t scores = (size_t)BQ * (round_up(D, T::DS) + 4)
                        + (size_t)T::NSK * T::KC * T::KST;
  const size_t pv = (size_t)T::NSV * T::VK * T::VST;
  return sizeof(float) * (p + (scores > pv ? scores : pv));
}

size_t smem_bytes(int bq, int r, int Ns, int D) {
  return bq == 64 ? smem_bytes<64>(r, Ns, D)
       : bq == 32 ? smem_bytes<32>(r, Ns, D) : smem_bytes<16>(r, Ns, D);
}

template <int BQ>
int launch(int R, const float* q, const float* k, const float* v,
           const float* u, float* out, int G, int S, int Nq, int Ns, int D,
           int C, float scale, float gamma, cudaStream_t stream) {
  const size_t smem = smem_bytes<BQ>(R, Ns, D);
  cudaError_t e = cudaFuncSetAttribute(
      cisa_shots_kernel<BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Nq + BQ - 1) / BQ, G);
  cisa_shots_kernel<BQ><<<grid, THREADS, smem, stream>>>(
      q, k, v, u, out, S, R, Nq, Ns, D, C, scale, gamma);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory of the smallest tile plan (16 rows, one shot's scores):
// a shape above the limit here is refused.
extern "C" size_t cisa_shots_smem_bytes(int Ns, int D) {
  return smem_bytes(16, 1, Ns, D);
}

extern "C" size_t cisa_shots_smem_limit() { return SMEM_LIMIT; }

// Launches on `stream`; returns the cudaError_t of the launch.  Takes the
// first tile plan (BQ, R) of the head of the file that fits.
extern "C" int cisa_shots_f32(const void* q, const void* k, const void* v,
                              const void* u, void* out, int G, int S, int Nq,
                              int Ns, int D, int C, float scale, float gamma,
                              void* stream) {
  if (D % 8 != 0 || C % 4 != 0) return (int)cudaErrorInvalidValue;
  const int plans[5][2] = {{64, S}, {32, S}, {32, 1}, {16, S}, {16, 1}};
  for (const auto& pl : plans) {
    const int bq = pl[0], r = pl[1];
    if (smem_bytes(bq, r, Ns, D) > SMEM_LIMIT) continue;
    auto* fn = bq == 64 ? launch<64> : bq == 32 ? launch<32> : launch<16>;
    return fn(r, (const float*)q, (const float*)k, (const float*)v,
              (const float*)u, (float*)out, G, S, Nq, Ns, D, C, scale, gamma,
              (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}
