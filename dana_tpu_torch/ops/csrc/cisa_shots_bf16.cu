// Shot-fused CISA attention core, bfloat16, on Hopper (sm_90a): `wgmma`
// on 64-row warpgroup tiles, TMA loads into `mbarrier` rings.
//
//   out[g, i, :] = bf16( (1/S) * sum_s P[g,i,s,:] @ v[g,s,:,:] ),
//   P[g,i,s,n]   = bf16( softmax_n(scale * q[g,i,:] . k[g,s,n,:])
//                        + gamma * u[g,s,n] )
//
// Replaces the Pallas TPU kernel `_kernel_shots` (dana_tpu/ops/
// cisa_attention.py:137, pallas_call in `_fused_shots` :173) on bfloat16
// inputs, the precision recipe's attention, at the detector's two sites:
// the RPN (G=8, S=3, Nq=2432 query tokens, Ns=400 support tokens, D=256,
// C=1024) and the RoI head (Nq=14700 RoI tokens, Ns=49).  The single-group
// `_kernel` (:30, `_fused` :65) is this kernel at S = 1.  The float32
// kernel is csrc/cisa_shots.cu.
//
// Arithmetic (the JAX kernel's, `cisa_attention_shots_plain`): the scores
// are float32 sums of bf16 products (wgmma, float32 accumulators), times
// `scale`; the softmax and the unary term are float32; P is rounded to
// bf16 after the normalisation and the unary term, before the PV product;
// the PV sums are float32, and the shot mean is rounded to bf16 once.  No
// unnormalised running sum is rescaled, so P is rounded where JAX rounds
// it.  e / sum is a product with the sum's reciprocal and one FMA on its
// exact residual (correctly rounded but in rare cases one float32 ulp off);
// the mean is the product with the float32 reciprocal of S, as PyTorch's
// `mean` on CUDA takes it.
//
// Bound on an H100 SXM: at the RPN site operations, 2*S*Nq*Ns*(D + C) =
// 59.8 GFLOP at 989 TFLOP/s of dense bf16, 0.060 ms; at the RoI site bytes,
// its 241 MB output (305 MB in all) at 3.35 TB/s, 0.091 ms.
//
// The shot mean is one product over the shots' keys laid end to end:
// (1/S) [P_1 .. P_S] @ [v_1; ..; v_S].  Two kernels meet through a bf16
// scratch P [G, Nq, S, Nsp] that the wrapper allocates (Nsp = Ns rounded up
// to 8, the padding zeros: each shot's keys start on a 16-byte boundary).
//
// Phase A, `probs_kernel`, P.  Work items of 128 query rows and one shot,
// or all S shots where the query tiles alone fill two waves of the card
// (q is then read once for its shots).  One block per SM walks the items.
// Two consumer warpgroups own 64 rows each; a producer thread keeps q tiles
// [128 x D] (two where they fit: the next item's loads while this one
// runs) and a ring of 64-key k tiles, each with its 72 values of u, in
// flight by TMA (full / empty mbarriers).  Pass 1 runs wgmma m64n64k16
// over D per key tile and keeps each row's max and sum (the sum rescaled
// when the max grows: a sum, not P, so P's rounding is untouched); pass 2
// recomputes the scores and writes P.  With one key tile (Ns <= 64, the
// RoI site) the values stay in registers and there is no second pass.  The
// block's key tiles form one stream whose wgmma groups run a tile ahead of
// the softmax, so the tensor cores work on tile n+1 while the threads fold
// tile n in.  P leaves as 16-byte stores: a quad of lanes transposes its
// pairs by shuffles so that each lane holds 8 consecutive keys of a row.
//
// Phase B, `pv_kernel`, out = (1/S) P @ v.  A persistent GEMM on 128 x 256
// output tiles (one block per SM walks the tiles, channel tile fastest, so
// the blocks in flight share P's rows and v[g] in L2; the ring runs on
// across tiles, so one tile's epilogue overlaps the next one's loads).  A
// producer thread keeps 3 slots of a P tile [128 x 64] and a v tile
// [64 x 256] in flight by TMA: over K = S*Ns where Nsp = Ns, else shot by
// shot (a tile's keys past the shot's Ns meet v rows that TMA fills with
// zeros).  Two consumer warpgroups run wgmma m64n256k16 with float32
// accumulators, P K-major, v MN-major (its channels contiguous, `tnspB`);
// `setmaxnreg` moves registers from the producer's warpgroup to theirs.  The
// epilogue rounds the mean to bf16 into a 128-byte-swizzled tile that
// leaves by TMA stores.
//
// What this does about the faults of the earlier, simple kernel: (1)
// `mma.sync` on 32-row blocks and v fragments by ldmatrix -> warpgroup
// wgmma from swizzled shared memory, 128 x 256 outputs a block in phase B;
// (2) serial phases
// behind __syncthreads -> producers that keep the rings full, phase A's
// softmax overlapped with the next key tile's wgmma, and no softmax in
// phase B's way; (3) v re-read by every 32-row block -> each v tile is read
// once for a 128 x 256 output tile (19 row tiles a group at the RPN site,
// not 76, and 4 channel tiles, not 1); (4) 4-byte stores of the output ->
// TMA stores from a swizzled tile; the RoI site's 49 keys take one 64-key
// tile and a single pass.
//
// Shapes: any G, S >= 1, Nq >= 1, Ns >= 1 (ragged Nq, Ns and K are zero
// filled by TMA and masked), D a multiple of 16 up to what two k slots and
// a q tile leave of shared memory (448), C a multiple of 8, 16-byte
// aligned q, k, v and u.  The wrapper refuses anything else.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int CONSUMERS = 256;          // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // + a producer warpgroup
constexpr int PRODUCER = CONSUMERS;     // the thread that starts TMA
constexpr int BQ = 128;                 // query rows a block (both phases)
constexpr int BK = 64;                  // keys a tile (both phases)
constexpr int BN = 256;                 // channels an output tile
constexpr int SUB = 64;                 // bf16 columns of a 128-byte row
constexpr int MAX_STAGES = 8;
constexpr int BARRIERS = 1024;          // bytes kept for the mbarriers
// phase A, after the mbarriers: a k slot's u values, 72 from the 16-byte
// boundary at or below its first key (TMA takes 16-byte aligned starts)
constexpr int U_BOX = BK + 8, U_SLOT = 256, MAX_STAGES_A = 4;
constexpr size_t SMEM_LIMIT = 232448;   // bytes a block may use on sm_90
constexpr int Q_SUB = BQ * 128;         // bytes of a q sub-tile
constexpr int K_SUB = BK * 128;         // bytes of a k sub-tile
constexpr int A_STAGE = BQ * 128;       // P tile [128 x 64]
constexpr int V_BOX = BK * 128;         // v box [64 keys x 64 channels]
constexpr int B_STAGE = V_BOX * BN / SUB;   // v tile [64 keys x 256]
constexpr int STAGING = 64 * BN * 2;    // a warpgroup's output tile

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared memory of phase A at D (D rounded up to 64) with the u slots,
// `qslots` q tiles and `stages` k slots, and of phase B with `stages` slots
// and the output tiles; +1024 to align the base to the 128-byte swizzle's
// 1024-byte atom.
__host__ __device__ size_t smem_a(int D, int qslots, int stages) {
  const int nsub = round_up(D, SUB) / SUB;
  return 1024 + BARRIERS + MAX_STAGES_A * U_SLOT +
         (size_t)nsub * (qslots * Q_SUB + stages * K_SUB);
}

__host__ __device__ size_t smem_b(int stages) {
  return 1024 + BARRIERS + (size_t)stages * (A_STAGE + B_STAGE)
         + 2 * STAGING;
}

// ------------------------------------------------------------ primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
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
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load1(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"((uint64_t)map),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// a warpgroup's own barrier (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}



// generic-proxy shared-memory writes -> visible to TMA (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.  K-major tiles
// (q, k, P): rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO); LBO is
// unused.  MN-major tiles (v): rows of 128 bytes are keys, 8-key atoms
// 1024 bytes apart (SBO), the next 64 channels `lbo` bytes on (LBO).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, float32) (+)= A (64 x 16, K-major) @ B (16 x 64, K-major)
__device__ __forceinline__ void wgmma_m64n64_kk(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 256, float32) (+)= A (64 x 16, K-major) @ B (16 x 256, MN-major)
__device__ __forceinline__ void wgmma_m64n256_kmn(float (&d)[128], uint64_t da,
                                                  uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~(uintptr_t)1023);
}

// --------------------------------------------------------------- phase A
// Accumulator layout of wgmma m64nN (float32) for thread t of a warpgroup:
// d[i] is row 16*(t/32) + (t%32)/4 + 8*((i>>1)&1), column 8*(i>>2) +
// 2*(t%4) + (i&1).

struct Ring {                           // a slot index and its phase parity
  int slot = 0, n;
  uint32_t ph = 0;
  __device__ explicit Ring(int n_) : n(n_) {}
  __device__ void next() {
    if (++slot == n) slot = 0, ph ^= 1;
  }
};

// x / y for a float32 y with r = 1/y correctly rounded: the product and one
// FMA correction of its residual (exact) give the correctly rounded quotient
// but in rare cases one float32 ulp off, which the bf16 rounding that
// follows absorbs; a tenth of the instructions of IEEE division.
__device__ __forceinline__ float div_r(float x, float y, float r) {
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q, y, x), r, q);
}

// Start the scores of one key tile: acc = q_slot[64 rows of wg] @ k_tile^T
// over D (nsub sub-tiles of 64), asynchronously (one wgmma group).
__device__ __forceinline__ void start_scores(float (&acc)[32],
                                             const uint8_t* qs,
                                             const uint8_t* kb, int nsub,
                                             int wg) {
  fence_regs(acc);
  wgmma_fence();
  for (int j = 0; j < nsub; ++j) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64_kk(acc, desc(qs + j * Q_SUB + wg * 64 * 128 + kk * 32, 16),
                      desc(kb + j * K_SUB + kk * 32, 16), j > 0 || kk > 0);
  }
  wgmma_commit();
}

// A position in a block's stream of key tiles: tile n, the n-th of the
// block; its item k, the shot sidx within the item (spi shots an item) and
// the tile its within the shot (TS tiles a shot); its k slot and q slot
// with their phase parities.
struct Cursor {
  int n = 0, k = 0, sidx = 0, its = 0, kslot = 0, qslot = 0;
  uint32_t kph = 0, qph = 0;
  __device__ void next(int TS, int spi, int stages, int qslots) {
    ++n;
    if (++kslot == stages) kslot = 0, kph ^= 1;
    if (++its == TS) {
      its = 0;
      if (++sidx == spi) {
        sidx = 0;
        ++k;
        if (++qslot == qslots) qslot = 0, qph ^= 1;
      }
    }
  }
};

// A shot's state in a consumer thread: its two rows' max m, sum l and 1/l.
struct RowStats {
  float m[2], l[2], r[2];
};

// Fold key tile kt's scores into the stats (pass 1), then, in the pass
// that writes, store its P.  acc holds the raw sums; keys past Ns -> -inf.
__device__ __forceinline__ void take_tile(
    const float (&acc)[32], RowStats& st, int kt, int pass, int nkt,
    int passes, int lane,
    int row0, int Nq, int Ns, int Nsp, int rowstride, float scale,
    const float (&gu)[16], __nv_bfloat16* __restrict__ pg) {
  const bool writes = pass == passes - 1;
  float sc[32];               // the accumulator is only read: a write to it
  if (kt == nkt - 1) {        // would serialise the next tile's wgmma
#pragma unroll                // keys past Ns: -inf, on the last tile only
    for (int i = 0; i < 32; ++i) {
      const int col = kt * BK + 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
      sc[i] = col < Ns ? __fmul_rn(acc[i], scale) : -INFINITY;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = __fmul_rn(acc[i], scale);
  }
  if (pass == 0) {
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
      const float mn = fmaxf(st.m[h], tmax[h]);   // finite: key 0 is < Ns
      st.l[h] *= expf(st.m[h] - mn);
      st.m[h] = mn;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float e = expf(sc[i] - st.m[(i >> 1) & 1]);
      st.l[(i >> 1) & 1] += e;
      if (passes == 1) sc[i] = e;      // the one pass: m is final
    }
    if (kt == nkt - 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        st.l[h] += __shfl_xor_sync(0xffffffffu, st.l[h], 1);
        st.l[h] += __shfl_xor_sync(0xffffffffu, st.l[h], 2);
        st.r[h] = __frcp_rn(st.l[h]);
      }
    }
  }
  if (!writes) return;
  // P = bf16(e / l + gamma * u) for the keys < Ns, and 0 for the row's
  // padding up to Nsp: there e = exp(-inf) = 0 and gu = 0.  No select or
  // branch between the values, so their exp chains interleave.
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    const float e = passes == 1 ? sc[i] : expf(sc[i] - st.m[h]);
    sc[i] = __fadd_rn(div_r(e, st.l[h], st.r[h]), gu[(i >> 2) * 2 + (i & 1)]);
  }
  // bf16 pairs: w[h][j] holds keys 8j + 2(lane%4) + {0, 1} of row half h.
  // A 4 x 4 transpose within each quad of lanes (two xor-shuffle stages a
  // group of four j) leaves lane q the keys 8q .. 8q+7 and 32+8q .. 32+8q+7
  // of its rows: two 16-byte stores a row, 64 bytes of a row a quad.
  uint32_t w[2][8];
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const __nv_bfloat162 b2 = __floats2bfloat162_rn(sc[i], sc[i + 1]);
    w[(i >> 1) & 1][i >> 2] = *reinterpret_cast<const uint32_t*>(&b2);
  }
  const int q = lane % 4;
#pragma unroll
  for (int k = 1; k <= 2; k <<= 1)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t got[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        got[e] = __shfl_xor_sync(0xffffffffu, w[h][e ^ k], k);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if ((e & k) != (q & k)) w[h][e] = got[e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = kt * BK + 32 * half + 8 * q;
      if (row < Nq && col < Nsp)
        *reinterpret_cast<uint4*>(pg + (size_t)row * rowstride + col) =
            make_uint4(w[h][4 * half], w[h][4 * half + 1],
                       w[h][4 * half + 2], w[h][4 * half + 3]);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
probs_kernel(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap umap,
             __nv_bfloat16* __restrict__ p,
             int G, int S, int Nq, int Ns, int D, int Nsp, int spi,
             int qslots, int stages, float scale, float gamma) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const base = aligned_smem(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(base);
  uint64_t* const empty = full + MAX_STAGES;
  uint64_t* const qfull = empty + MAX_STAGES;
  uint64_t* const qempty = qfull + 2;
  const int nsub = round_up(D, SUB) / SUB;
  uint8_t* const ubuf = base + BARRIERS;
  uint8_t* const qbuf = ubuf + MAX_STAGES_A * U_SLOT;
  uint8_t* const kbuf = qbuf + qslots * nsub * Q_SUB;
  const int qslot_bytes = nsub * Q_SUB, kstage = nsub * K_SUB;
  // with each k tile, u's values of its keys (past the shot's Ns they
  // belong to the next shot, or read as zeros: masked), from the 16-byte
  // boundary at or below its first key
  auto uchunk = [&](int slot) {
    return reinterpret_cast<const __nv_bfloat16*>(ubuf + slot * U_SLOT);
  };

  // an item: spi shots (1 or S) of a 128-row query tile of a group
  const int nqt = (Nq + BQ - 1) / BQ, sgroups = S / spi;
  const int items = sgroups * nqt * G;
  const int nkt = (Ns + BK - 1) / BK;
  const int passes = nkt == 1 ? 1 : 2, TS = passes * nkt, T = spi * TS;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);            // one arrival a consumer warpgroup
    }
    for (int i = 0; i < qslots; ++i) {
      mbar_init(&qfull[i], 1);
      mbar_init(&qempty[i], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: each item's q tile, then its key tiles of each pass;
    // its warpgroup gives registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (threadIdx.x == PRODUCER) {
      Ring ks(stages), qr(qslots);
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int sh0 = item % sgroups * spi,
                  q0 = item / sgroups % nqt * BQ, g = item / (sgroups * nqt);
        mbar_wait(&qempty[qr.slot], qr.ph ^ 1);
        mbar_expect_tx(&qfull[qr.slot], qslot_bytes);
        for (int j = 0; j < nsub; ++j)
          tma_load(qbuf + qr.slot * qslot_bytes + j * Q_SUB, &qmap,
                   &qfull[qr.slot], j * SUB, q0, g);
        qr.next();
        for (int it = 0; it < T; ++it) {
          mbar_wait(&empty[ks.slot], ks.ph ^ 1);
          const int kt = it % TS % nkt, gs = g * S + sh0 + it / TS;
          mbar_expect_tx(&full[ks.slot], kstage + U_BOX * 2);
          for (int j = 0; j < nsub; ++j)
            tma_load(kbuf + ks.slot * kstage + j * K_SUB, &kmap,
                     &full[ks.slot], j * SUB, kt * BK, gs);
          tma_load1(ubuf + ks.slot * U_SLOT, &umap, &full[ks.slot],
                    (gs * Ns + kt * BK) & ~7);
          ks.next();
        }
      }
    }
  } else {
  // ---- consumers: warpgroup wg owns rows 64*wg .. 64*wg + 63 of a tile.
  // The block's key tiles form one stream, n = 0 .. N-1 over its items (T
  // a item); their wgmma groups run one ahead of the softmax work, so tile
  // n+1's scores are on the tensor cores while tile n's are folded in.  The
  // start is unconditional (a wgmma under a branch is serialised): past the
  // end it repeats tile N-1 and the result is dropped.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int lane = t % 32;
  const int N = (blockIdx.x < items
                     ? (items - blockIdx.x + gridDim.x - 1) / gridDim.x
                     : 0) * T;
  Cursor ci, cf;                        // the tiles to start, to finish
  const uint8_t *qsrc = qbuf, *ksrc = kbuf;
  auto start = [&](float (&acc)[32]) {
    if (ci.n < N) {
      if (ci.its == 0 && ci.sidx == 0)
        mbar_wait(&qfull[ci.qslot], ci.qph);
      mbar_wait(&full[ci.kslot], ci.kph);
      qsrc = qbuf + ci.qslot * qslot_bytes;
      ksrc = kbuf + ci.kslot * kstage;
      ci.next(TS, spi, stages, qslots);
    }
    start_scores(acc, qsrc, ksrc, nsub, wg);
  };
  RowStats st;
  int row0 = 0, sh0 = 0, g = 0, ush = 0;   // ush: the shot's first u index
  const int rowstride = S * Nsp;
  __nv_bfloat16* pg = p;
  auto finish = [&](const float (&acc)[32]) {
    if (cf.its == 0) {                   // a new shot
      if (cf.sidx == 0) {                // of a new item
        const int item = blockIdx.x + cf.k * gridDim.x;
        sh0 = item % sgroups * spi;
        g = item / (sgroups * nqt);
        row0 = item / sgroups % nqt * BQ + wg * 64 + 16 * (t / 32) + lane / 4;
      }
      const int sh = sh0 + cf.sidx;
      ush = (g * S + sh) * Ns;
      pg = p + (size_t)g * Nq * rowstride + (size_t)sh * Nsp;
      st = RowStats{{-INFINITY, -INFINITY}, {0.f, 0.f}, {0.f, 0.f}};
    }
    const int pass = cf.its < nkt ? 0 : 1;
    float gu[16];                        // gamma * u of the thread's keys
    if (pass == passes - 1) {            // (0 past Ns), read before the
      const int kt = cf.its - pass * nkt;   // slot is freed
      const __nv_bfloat16* us = uchunk(cf.kslot) + ((ush + kt * BK) & 7);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * (j >> 1) + 2 * (lane % 4) + (j & 1);
        gu[j] = kt * BK + c < Ns
                    ? __fmul_rn(gamma, __bfloat162float(us[c])) : 0.f;
      }
    }
    if (t == 0) mbar_arrive(&empty[cf.kslot]);
    take_tile(acc, st, cf.its - pass * nkt, pass, nkt, passes, lane, row0,
              Nq, Ns, Nsp, rowstride, scale, gu, pg);
    if (cf.its == TS - 1 && cf.sidx == spi - 1 && t == 0)
      mbar_arrive(&qempty[cf.qslot]);
    cf.next(TS, spi, stages, qslots);
  };
  float acc0[32], acc1[32];
  start(acc0);
  for (int n = 0; n < N; n += 2) {
    start(acc1);
    wgmma_wait<1>();
    fence_regs(acc0);
    finish(acc0);
    start(acc0);
    wgmma_wait<1>();
    fence_regs(acc1);
    if (n + 1 < N) finish(acc1);
  }
  wgmma_wait<0>();
  }
}

// --------------------------------------------------------------- phase B

__global__ void __launch_bounds__(THREADS, 1)
pv_kernel(const __grid_constant__ CUtensorMap pmap,
          const __grid_constant__ CUtensorMap vmap,
          const __grid_constant__ CUtensorMap vmap4,
          const __grid_constant__ CUtensorMap omap, int G, int S, int Nq,
          int Ns, int Nsp, int C, int stages) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const base = aligned_smem(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(base);
  uint64_t* const empty = full + MAX_STAGES;
  uint8_t* const ring = base + BARRIERS;
  uint8_t* const staging = ring + stages * (A_STAGE + B_STAGE);

  const int mt = (Nq + BQ - 1) / BQ, nt = (C + BN - 1) / BN;
  // P's rows hold each shot's keys padded to Nsp.  With no padding (Ns a
  // multiple of 8) they are v[g] as [S*Ns, C]'s keys end to end: one run of
  // key tiles over K = S*Ns.  Else each shot's key tiles apart, past the
  // shot's Ns meeting v rows that read as zeros.
  const bool flat = Ns == Nsp;
  const int nkt = (Ns + BK - 1) / BK;
  const int nk = flat ? (S * Ns + BK - 1) / BK : S * nkt;
  const int tiles = G * mt * nt;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: P [128 x 64] and v [64 x 256] a key tile, every tile;
    // its warpgroup gives registers to the consumers' accumulators
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (threadIdx.x == PRODUCER) {
      Ring ring_(stages);
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = tile % nt * BN, m0 = tile / nt % mt * BQ;
        const int g = tile / (nt * mt);
        // v boxes of 64 channels that hold some channel < C
        const int vboxes = min(BN / SUB, (C - n0 + SUB - 1) / SUB);
        for (int t = 0; t < nk; ++t) {
          const int s = flat ? 0 : t / nkt, kt = flat ? t : t % nkt;
          mbar_wait(&empty[ring_.slot], ring_.ph ^ 1);
          uint8_t* a = ring + ring_.slot * (A_STAGE + B_STAGE);
          mbar_expect_tx(&full[ring_.slot], A_STAGE + vboxes * V_BOX);
          tma_load(a, &pmap, &full[ring_.slot], s * Nsp + kt * BK, m0, g);
          for (int b = 0; b < vboxes; ++b) {
            if (flat)
              tma_load(a + A_STAGE + b * V_BOX, &vmap, &full[ring_.slot],
                       n0 + b * SUB, kt * BK, g);
            else
              tma_load4(a + A_STAGE + b * V_BOX, &vmap4, &full[ring_.slot],
                        n0 + b * SUB, kt * BK, s, g);
          }
          ring_.next();
        }
      }
    }
  } else {
  // ---- consumers: warpgroup wg owns rows 64*wg .. 64*wg + 63 of a tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int lane = t % 32, r = 16 * (t / 32) + lane / 4;   // and r + 8
  uint8_t* const stage_out = staging + wg * STAGING;
  const float inv = __frcp_rn((float)S);   // the mean as torch's on CUDA
  Ring ring_(stages);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = tile % nt * BN, m0 = tile / nt % mt * BQ;
    const int g = tile / (nt * mt);
    float acc[128];
    int prev = 0;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&full[ring_.slot], ring_.ph);
      const uint8_t* a = ring + ring_.slot * (A_STAGE + B_STAGE);
      const uint8_t* b = a + A_STAGE;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n256_kmn(acc, desc(a + wg * 64 * 128 + kk * 32, 16),
                          desc(b + kk * 16 * 128, V_BOX), kt > 0 || kk > 0);
      wgmma_commit();
      if (kt > 0) {
        wgmma_wait<1>();                   // key tile kt-1 is read
        if (t == 0) mbar_arrive(&empty[prev]);
      }
      prev = ring_.slot;
      ring_.next();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (t == 0) mbar_arrive(&empty[prev]);

    // epilogue: the shot mean in bf16 through a swizzled tile, TMA stores
    if (t == 0) bulk_wait_read();          // the last tile's stores read it
    wg_sync(wg);
#pragma unroll
    for (int i = 0; i < 128; i += 2) {
      const int row = r + 8 * ((i >> 1) & 1);
      const int chunk = (i >> 2) & 7, box = i >> 5;   // 8 cols, 64 cols
      uint8_t* dst = stage_out + box * V_BOX + row * 128 +
                     ((chunk ^ (row & 7)) * 16) + (lane % 4) * 4;
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(
          __fmul_rn(acc[i], inv), __fmul_rn(acc[i + 1], inv));
    }
    fence_async_smem();
    wg_sync(wg);
    if (t == 0 && m0 + wg * 64 < Nq) {
      for (int b = 0; b < BN / SUB && n0 + b * SUB < C; ++b)
        tma_store(&omap, stage_out + b * V_BOX, n0 + b * SUB, m0 + wg * 64,
                  g);
      bulk_commit();
    }
  }
  if (t == 0) bulk_wait();
  }
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

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

// A bf16 tensor [d2][d1][d0] (d0 contiguous, rows of `row` elements, planes
// of `plane` elements) cut into boxes of 64 x b1 x 1, 128-byte swizzle;
// what lies outside reads as zeros.  -> 0 or a cudaError_t.
int make_map(CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1,
             uint64_t d2, uint64_t row, uint64_t plane, uint32_t b1) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorInitializationError;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {row * 2, plane * 2};
  const cuuint32_t box[3] = {SUB, b1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A bf16 vector of n values in boxes of b0, no swizzle (u); what lies
// outside reads as zeros.
int make_map1(CUtensorMap* map, const void* ptr, uint64_t n, uint32_t b0) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorInitializationError;
  const cuuint64_t dims[1] = {n}, strides[1] = {n * 2};
  const cuuint32_t box[1] = {b0}, estr[1] = {1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 1,
                        const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// v [G][S][Ns][C] as a 4-d tensor in boxes of 64 channels x b1 keys x 1 x 1;
// keys past Ns read as zeros.
int make_map4(CUtensorMap* map, const void* ptr, uint64_t C, uint64_t Ns,
              uint64_t S, uint64_t G, uint32_t b1) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorInitializationError;
  const cuuint64_t dims[4] = {C, Ns, S, G};
  const cuuint64_t strides[3] = {C * 2, Ns * C * 2, S * Ns * C * 2};
  const cuuint32_t box[4] = {SUB, b1, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

int launch_probs(const void* q, const void* k, const void* u, void* p, int G,
                 int S, int Nq, int Ns, int D, float scale, float gamma,
                 int qslots, int stages, cudaStream_t stream) {
  const size_t smem = smem_a(D, qslots, stages);
  if (D % 16 != 0 || Ns < 1 || S < 1 || qslots < 1 || qslots > 2 ||
      stages < 2 || stages > MAX_STAGES_A || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, umap;
  int e = make_map(&qmap, q, D, Nq, G, D, (uint64_t)Nq * D, BQ);
  if (e == 0)
    e = make_map(&kmap, k, D, Ns, (uint64_t)G * S, D, (uint64_t)Ns * D, BK);
  if (e == 0) e = make_map1(&umap, u, (uint64_t)G * S * Ns, U_BOX);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(
      probs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // all S shots an item where the query tiles alone fill two waves of the
  // card (q is then loaded once for its shots), else one shot an item
  const int sms = sm_count();
  const long tiles = (long)((Nq + BQ - 1) / BQ) * G;
  const int spi = tiles >= 2L * sms ? S : 1;
  const long items = tiles * (S / spi);
  const unsigned grid = (unsigned)(items < sms ? items : sms);
  probs_kernel<<<grid, THREADS, smem, stream>>>(
      qmap, kmap, umap, (__nv_bfloat16*)p, G, S, Nq, Ns,
      D, round_up(Ns, 8), spi, qslots, stages, scale, gamma);
  return (int)cudaGetLastError();
}

int launch_pv(const void* p, const void* v, void* out, int G, int S, int Nq,
              int Ns, int C, int stages, cudaStream_t stream) {
  const size_t smem = smem_b(stages);
  if (C % 8 != 0 || Ns < 1 || S < 1 || stages < 2 || stages > MAX_STAGES ||
      smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const int nsp = round_up(Ns, 8), K = S * nsp;
  CUtensorMap pmap, vmap, vmap4, omap;
  int e = make_map(&pmap, p, K, Nq, G, K, (uint64_t)Nq * K, BQ);
  if (e == 0)
    e = make_map(&vmap, v, C, (uint64_t)S * Ns, G, C, (uint64_t)S * Ns * C,
                 BK);
  if (e == 0) e = make_map4(&vmap4, v, C, Ns, S, G, BK);
  if (e == 0) e = make_map(&omap, out, C, Nq, G, C, (uint64_t)Nq * C, 64);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(
      pv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long tiles =
      (long)G * ((Nq + BQ - 1) / BQ) * ((C + BN - 1) / BN);
  const int sms = sm_count();
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  pv_kernel<<<grid, THREADS, smem, stream>>>(pmap, vmap, vmap4, omap, G, S,
                                             Nq, Ns, nsp, C, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory of phase A at (D, q slots, k slots) and of phase B at
// (slots), and the bytes a block may use: the wrapper's plan
// (ops/cisa_attention.py `bf16_plan`) is held against these.
extern "C" size_t cisa_shots_bf16_smem_a(int D, int qslots, int stages) {
  return smem_a(D, qslots, stages);
}

extern "C" size_t cisa_shots_bf16_smem_b(int stages) { return smem_b(stages); }

extern "C" size_t cisa_shots_bf16_smem_limit() { return SMEM_LIMIT; }

// Phase A: q [G,Nq,D], k [G,S,Ns,D], u [G,S,Ns] bf16 -> p [G,Nq,S,Nsp]
// bf16, Nsp = Ns rounded up to 8 (the keys Ns..Nsp-1 hold zeros).
extern "C" int cisa_probs_bf16(const void* q, const void* k, const void* u,
                               void* p, int G, int S, int Nq, int Ns, int D,
                               float scale, float gamma, int qslots,
                               int stages, void* stream) {
  if (G == 0 || Nq == 0) return (int)cudaSuccess;
  return launch_probs(q, k, u, p, G, S, Nq, Ns, D, scale, gamma, qslots,
                      stages, (cudaStream_t)stream);
}

// Phase B: p [G,Nq,S,Nsp], v [G,S,Ns,C] bf16 -> out [G,Nq,C] bf16.
extern "C" int cisa_pv_bf16(const void* p, const void* v, void* out, int G,
                            int S, int Nq, int Ns, int C, int stages,
                            void* stream) {
  if (G == 0 || Nq == 0) return (int)cudaSuccess;
  return launch_pv(p, v, out, G, S, Nq, Ns, C, stages, (cudaStream_t)stream);
}

// Both phases on `stream`: q [G,Nq,D], k [G,S,Ns,D], v [G,S,Ns,C],
// u [G,S,Ns] bf16, contiguous, p the scratch [G,Nq,S,Nsp] -> out [G,Nq,C].
// Returns the first non-zero cudaError_t of the two launches.
extern "C" int cisa_shots_bf16(const void* q, const void* k, const void* v,
                               const void* u, void* p, void* out, int G,
                               int S, int Nq, int Ns, int D, int C,
                               float scale, float gamma, int qslots,
                               int stages_a, int stages_b, void* stream) {
  if (G == 0 || Nq == 0) return (int)cudaSuccess;
  const int e = launch_probs(q, k, u, p, G, S, Nq, Ns, D, scale, gamma,
                             qslots, stages_a, (cudaStream_t)stream);
  if (e != 0) return e;
  return launch_pv(p, v, out, G, S, Nq, Ns, C, stages_b,
                   (cudaStream_t)stream);
}
