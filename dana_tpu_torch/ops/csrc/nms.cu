// Greedy NMS over score-sorted boxes for Hopper (sm_90a), batched over
// images, with no host synchronisation.
//
// Replaces no Pallas kernel.  The JAX package computes NMS in XLA
// (dana_tpu/ops/nms.py:61 `nms_fixed`, :116 `nms_fixed_tiled`: a
// suppression fixed point inside `lax.while_loop`s, which never leave the
// device).  The port's plain version (dana_tpu_torch/ops/nms.py) ends its
// data-dependent loops on the host, one synchronisation per tile and per
// nine fixed-point steps, and a traced program cannot hold such a loop at
// all.  This kernel gives the port JAX's property: the kept set is found on
// the device, in the shape of the reference detector's own nms.cu (a
// suppression bitmask, then a walk).
//
//   keep[i] = valid[i] and no kept j < i has IoU(i, j) > thr
//
// over boxes already sorted by score (a stable descending sort outside the
// kernel), written as the first M kept positions into the sorted axis and
// a mask; padded slots hold 0 and false.
//
// Exactness.  The kept set must equal the plain version's, so the IoU is
// the plain version's float32 arithmetic rounded after every operation
// (dana_tpu_torch/core/boxes.py `iou_matrix`): areas (x2 - x1 + 1) *
// (y2 - y1 + 1), wh = max(min - max + 1, 0), union = (area_a + area_b) -
// inter, then an IEEE division, each with an explicitly rounded intrinsic
// so nvcc contracts nothing into a fused multiply-add; maxima and minima
// propagate NaN as torch.maximum / minimum and clamp do.  The threshold is
// compared in float32 (the wrapper passes it as a C float, the value
// PyTorch compares a float32 tensor with), strictly greater.  The IoU is
// symmetric bit for bit (every operation commutes), so row i against
// column j gives what the plain version computes for j against i.
//
// Bound on this card: latency, not bytes or operations.  The inputs and
// outputs are small (16 B a box, 9 B a slot: 0.8 MB at serving) and the
// IoUs the data needs are a few million float32 operations: microseconds
// at 67 TFLOP/s.  The walk is serial per image: box i's fate depends on
// every kept box before it.
//
// Design, two kernels on the caller's stream:
//  1. `mask_kernel`: the suppression bitmask [B, N, W] uint64, W =
//     ceil(N / 64), upper triangular by 64-box tiles.  One block of 64
//     threads per (column tile, row tile, image) with column tile >= row
//     tile (the others return at once): the column tile's 64 boxes and
//     areas are staged in shared memory, each thread takes one row box i
//     and sets bit k of word (i, col) when box col*64+k lies after i and
//     overlaps it past the threshold.  Words below the diagonal are never
//     written, and never read.
//  2. `walk_kernel`: one block per image.  The "removed" words live in
//     shared memory (W words: 188 at N = 12000).  The block walks the
//     boxes 64 at a time: after one barrier, a warp ballot of the validity
//     bytes, minus the chunk's removed word, gives its live boxes; the
//     lowest live box is kept (thread 0 writes its slot), every thread ORs
//     its share of the kept box's row past this chunk (words col+1..W-1,
//     all written by pass 1) into the removed words, and the chunk's live
//     set drops the boxes that the row's own word col suppresses, so no
//     barrier is needed per kept box and no thread reads a shared word
//     while another writes it.  It stops at M kept, then fills the unused
//     slots.  Every thread takes the same decisions (the same ballots, the
//     same shared word after the barrier, the same row words), so the
//     barriers are uniform.
// The wrapper allocates the bitmask with torch.empty (36 MB at B 8, N
// 6000; 72 MB at B 4, N 12000).  What a faster kernel would change: the
// walk pays one global row read per kept box (M of them in series);
// prefetching the next live box's row would shorten it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kMaxWalkThreads = 256;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

// clamp(min=0), NaN kept
__device__ __forceinline__ float clamp0(float x) {
  return (x != x) ? x : fmaxf(x, 0.0f);
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

__device__ __forceinline__ float box_iou(float4 a, float area_a, float4 b,
                                         float area_b) {
  float w = clamp0(__fadd_rn(__fsub_rn(nan_min(a.z, b.z), nan_max(a.x, b.x)),
                             1.0f));
  float h = clamp0(__fadd_rn(__fsub_rn(nan_min(a.w, b.w), nan_max(a.y, b.y)),
                             1.0f));
  float inter = __fmul_rn(w, h);
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, uni);
}

__global__ void __launch_bounds__(kTile)
mask_kernel(const float4* __restrict__ boxes, int n, int words, float thr,
            unsigned long long* __restrict__ mask) {
  const int col = blockIdx.x, row = blockIdx.y, b = blockIdx.z;
  if (col < row) return;
  __shared__ float4 cbox[kTile];
  __shared__ float carea[kTile];
  const int t = threadIdx.x;
  const float4* bb = boxes + (size_t)b * n;
  const int j = col * kTile + t;
  if (j < n) {
    float4 v = bb[j];
    cbox[t] = v;
    carea[t] = box_area(v);
  }
  __syncthreads();
  const int i = row * kTile + t;
  if (i >= n) return;
  const float4 a = bb[i];
  const float area_a = box_area(a);
  const int cols = min(kTile, n - col * kTile);
  unsigned long long bits = 0;
  for (int k = (col == row) ? t + 1 : 0; k < cols; ++k)
    if (box_iou(a, area_a, cbox[k], carea[k]) > thr) bits |= 1ull << k;
  mask[((size_t)b * n + i) * words + col] = bits;
}

__global__ void walk_kernel(const unsigned long long* __restrict__ mask,
                            const unsigned char* __restrict__ valid, int n,
                            int words, int m, long long* __restrict__ pos,
                            unsigned char* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  for (int w = tid; w < words; w += blockDim.x) removed[w] = 0ull;
  __syncthreads();
  const unsigned long long* mb = mask + (size_t)b * n * words;
  const unsigned char* vb = valid + (size_t)b * n;
  long long* pb = pos + (size_t)b * m;
  unsigned char* kb = keep + (size_t)b * m;
  int count = 0;
  for (int c = 0; c < words && count < m; ++c) {
    const int i0 = c * kTile + lane, i1 = i0 + 32;
    const unsigned lo = __ballot_sync(0xffffffffu, i0 < n && vb[i0]);
    const unsigned hi = __ballot_sync(0xffffffffu, i1 < n && vb[i1]);
    // the earlier chunks' ORs into removed[c] are done
    __syncthreads();
    unsigned long long live = ((unsigned long long)hi << 32 | lo)
                              & ~removed[c];
    while (live) {
      const int k = __ffsll((long long)live) - 1;
      const int i = c * kTile + k;
      if (tid == 0) {
        pb[count] = i;
        kb[count] = 1;
      }
      ++count;
      const unsigned long long* r = mb + (size_t)i * words;
      // later chunks' words only: this chunk's live set takes the kept
      // box's own word below, so no thread reads a word another writes
      for (int w = c + 1 + tid; w < words; w += blockDim.x)
        removed[w] |= r[w];
      if (count >= m) break;
      // boxes after k that the kept box does not suppress
      live &= ~r[c] & ~((2ull << k) - 1ull);
    }
  }
  for (int s = count + tid; s < m; s += blockDim.x) {
    pb[s] = 0;
    kb[s] = 0;
  }
}

}  // namespace

extern "C" {

// The largest N the walk's shared "removed" words allow (48 KB).
int nms_sorted_max_boxes() { return 48 * 1024 / 8 * kTile; }

// boxes [B, N, 4] float32 (16-byte aligned), valid [B, N] bool, mask
// scratch [B, N, ceil(N/64)] uint64, pos [B, M] int64, keep [B, M] bool;
// -> a cudaError_t.  B, N >= 1, M >= 0.
int nms_sorted_f32(const void* boxes, const void* valid, void* mask,
                   void* pos, void* keep, int b, int n, int m, float thr,
                   void* stream) {
  if (b < 1 || n < 1 || m < 0 || n > nms_sorted_max_boxes())
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int words = (n + kTile - 1) / kTile;
  mask_kernel<<<dim3(words, words, b), kTile, 0, s>>>(
      (const float4*)boxes, n, words, thr, (unsigned long long*)mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int threads = (words + 31) / 32 * 32;
  threads = threads < kMaxWalkThreads ? threads : kMaxWalkThreads;
  walk_kernel<<<b, threads, words * sizeof(unsigned long long), s>>>(
      (const unsigned long long*)mask, (const unsigned char*)valid, n, words,
      m, (long long*)pos, (unsigned char*)keep);
  return (int)cudaGetLastError();
}

}  // extern "C"
