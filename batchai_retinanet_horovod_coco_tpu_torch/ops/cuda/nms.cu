// Class-masked greedy NMS keep mask for Hopper (sm_90a).
//
// Replaces the TPU kernel batchai_retinanet_horovod_coco_tpu/ops/pallas/nms.py
// (nms_keep_mask → _kernel).  Same function: over B images of K candidates
// already sorted by descending score, candidate i is kept iff it is valid
// (not padding) and no KEPT candidate j < i of the same class has
// IoU(j, i) > t.  The Pallas kernel's blocked fixed point and identity-matmul
// transposes exist for the TPU's (8, 128) tiles; here the work is split into
// a parallel bitmask pass and a blocked scan, two launches:
//
//   nms_mask_kernel  grid (ceil(K/64) row blocks, ceil(K/64) column blocks, B),
//                    256 threads.  Row j = 64*row_block + r gets ONE uint64
//                    word: bit c is set iff j < i (i = the c-th column of
//                    the block), same class, IoU(j, i) > t.  Four
//                    neighbouring lanes share a row, every fourth column each,
//                    unrolled and branch-free (areas precomputed, bits
//                    masked afterwards) so that a thread's IoUs overlap, and
//                    OR their bits with two shuffles.  Blocks below the
//                    diagonal write nothing: the scan never reads them.
//   nms_scan_kernel  one block of kScanThreads an image, walking the K
//                    candidates a 64-candidate word at a time.  `removed`
//                    (the candidates suppressed by kept rows of earlier
//                    words) and the validity bits live in shared memory as
//                    one uint64 a word, and so do the mask rows of the
//                    current word and of the next one (two row blocks,
//                    1 KB a word each).  For word w:
//                      1. thread 0 resolves the word from its staged
//                         diagonal words mask[64w + r][w]: live = valid &
//                         ~removed[w]; for r in order, if bit r of live is
//                         set, live &= ~diag[r].  What is left of live is the
//                         kept set (a diagonal word only has bits above r).
//                         Meanwhile warps 1.. start asynchronous copies
//                         (cp.async) of row block w + 1 from device memory;
//                      2. after a barrier the kept set is read by all; the
//                         threads write the 64 keep flags, spread the (kept
//                         row, later word) pairs among themselves and OR the
//                         rows' staged words into `removed` with a shared
//                         64-bit atomicOr;
//                    then each thread waits for its copies and a barrier
//                    follows.  The loop over words is uniform across the
//                    block, and the serial part reads no device memory.
//
// Exactness: when word w is resolved, removed[w] holds exactly the bits of
// the kept candidates of words < w (each kept row was OR-ed into every later
// word, and OR does not depend on order), and the in-word loop applies the
// kept rows r' < r of word w before deciding r.  So candidate i is kept iff
// it is valid and no kept j < i of its class suppresses it: the greedy
// solution, which the JAX fixed point converges to.  Padding is never valid,
// hence never kept, hence never suppresses.
//
// Bound on this card: the inputs and the output are ~25 bytes a candidate
// (200 KB at B 8, K 1000), so the least time is set by the IoU operations
// (~15 f32 operations a same-class pair), a few microseconds of the card at
// most.  What the bound does not count is the greedy order's dependency
// chain.  Walked a candidate at a time, with a device-memory round trip
// for each kept candidate's mask row, that chain would cost some 0.3 us a
// kept candidate; here it is 64 dependent steps a word (a shared-memory
// read and a bit test each), with the next word's device memory traffic
// behind it.
//
// IoU arithmetic is op for op ops/iou.py (max/min corners → clamped w, h →
// product → (area_a + area_b) - inter → union > 0 ? inter / max(union, 1e-12)
// : 0) with round-to-nearest intrinsics, so no FMA contraction can move a
// decision at the threshold; the build also passes --fmad=false.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;       // candidates per mask block / word
constexpr int kMaxWords = 128;   // words of the scan's shared bitsets
constexpr int kMaxK = kMaxWords * kBlock;  // 8192 candidates
constexpr int kMaskThreads = 4 * kBlock;  // four threads a row
constexpr int kScanThreads = 256;

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f), fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

// IoU of a against b, with their areas precomputed by area().
__device__ __forceinline__ float iou(float4 a, float area_a, float4 b, float area_b) {
  float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  float inter = __fmul_rn(iw, ih);
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  // No overlap gives 0 without the divide (0 / union is 0 up to its sign,
  // which no comparison sees): a zero dividend takes __fdiv_rn's slow path.
  return inter > 0.0f && uni > 0.0f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.0f;
}

__device__ __forceinline__ float4 load_box(const float* p) {
  return make_float4(p[0], p[1], p[2], p[3]);
}

__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float* __restrict__ boxes,  // (B, K, 4)
                const int* __restrict__ cls,      // (B, K)
                int k, int words, float threshold,
                unsigned long long* __restrict__ mask) {  // (B, K, words)
  const int row_block = blockIdx.x;
  const int col_block = blockIdx.y;
  const int b = blockIdx.z;
  if (col_block < row_block) return;  // every column precedes every row
  __shared__ float4 col_box[kBlock];
  __shared__ float col_area[kBlock];
  __shared__ int col_cls[kBlock];
  const int i0 = col_block * kBlock;
  const int n_cols = min(kBlock, k - i0);
  if (threadIdx.x < kBlock) {
    // Columns past K get an empty box; their bits are cleared below.
    const int c = threadIdx.x;
    const float4 box = c < n_cols ? load_box(boxes + ((size_t)b * k + i0 + c) * 4)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    col_box[c] = box;
    col_area[c] = area(box);
    col_cls[c] = c < n_cols ? cls[(size_t)b * k + i0 + c] : 0;
  }
  __syncthreads();
  // Four neighbouring lanes share row r, a quarter of the columns each.
  const int r = threadIdx.x >> 2;
  const int quarter = threadIdx.x & 3;
  const int j = row_block * kBlock + r;
  const float4 row = j < k ? load_box(boxes + ((size_t)b * k + j) * 4)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
  const float row_area = area(row);
  const int c_row = j < k ? cls[(size_t)b * k + j] : 0;
  // The lane's 16 columns (every fourth, so that the four lanes read
  // neighbouring shared words) unrolled and branch-free: their IoUs overlap.
  unsigned long long bits = 0ull;
#pragma unroll
  for (int n = 0; n < kBlock / 4; ++n) {
    const int c = 4 * n + quarter;
    // Cross-class IoU is zeroed BEFORE the threshold, as in ops/nms.py.
    const float v_iou = iou(row, row_area, col_box[c], col_area[c]);
    const float v = col_cls[c] == c_row ? v_iou : 0.0f;
    bits |= static_cast<unsigned long long>(v > threshold) << c;
  }
  bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
  bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
  if (n_cols < kBlock) bits &= (1ull << n_cols) - 1ull;  // columns past K
  if (col_block == row_block) bits &= r == kBlock - 1 ? 0ull : ~0ull << (r + 1);  // i > j only
  if (quarter == 0 && j < k) mask[((size_t)b * k + j) * words + col_block] = bits;
}

// Row block w of the mask (its words w onward) into shared memory, zeros
// past K, by `threads` threads numbered from `t`, as asynchronous copies:
// each thread waits for its own with __pipeline_wait_prior(0).
__device__ __forceinline__ void stage_rows(const unsigned long long* __restrict__ rows,
                                           unsigned long long* __restrict__ dst, int w, int k,
                                           int words, int t, int threads) {
  const int span = words - w;
  for (int p = t; p < kBlock * span; p += threads) {
    const int r = p / span;
    const int ww = w + p % span;
    const int row = w * kBlock + r;
    if (row < k)
      __pipeline_memcpy_async(dst + r * words + ww, rows + (size_t)row * words + ww,
                              sizeof(unsigned long long));
    else
      dst[r * words + ww] = 0ull;
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const float* __restrict__ scores,  // (B, K)
                const unsigned long long* __restrict__ mask,  // (B, K, words)
                int k, int words, float pad_score,
                bool* __restrict__ keep) {  // (B, K)
  // Two row blocks of the mask, [2][kBlock][words]: the current word's
  // rows and the next word's, staged while the current one resolves.
  extern __shared__ unsigned long long staged[];
  __shared__ unsigned long long removed[kMaxWords];
  __shared__ unsigned long long valid[kMaxWords];
  __shared__ unsigned long long kept_word;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const unsigned long long* rows = mask + (size_t)b * k * words;

  // Validity (score above the padding level), a warp a word.
  for (int w = tid >> 5; w < words; w += kScanThreads / 32) {
    const int i = w * kBlock + lane;
    const unsigned lo = __ballot_sync(0xffffffffu, i < k && scores[(size_t)b * k + i] > pad_score);
    const unsigned hi =
        __ballot_sync(0xffffffffu, i + 32 < k && scores[(size_t)b * k + i + 32] > pad_score);
    if (lane == 0) {
      valid[w] = (static_cast<unsigned long long>(hi) << 32) | lo;
      removed[w] = 0ull;
    }
  }
  stage_rows(rows, staged, 0, k, words, tid, kScanThreads);
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int w = 0; w < words; ++w) {
    const unsigned long long* cur = staged + (w & 1) * kBlock * words;
    if (tid == 0) {
      // The serial part: resolve word w from its staged diagonal, read
      // into a local array first (reading it inside the chain measured
      // twice as slow on the card).
      unsigned long long diag[kBlock];
#pragma unroll
      for (int r = 0; r < kBlock; ++r) diag[r] = cur[r * words + w];
      unsigned long long live = valid[w] & ~removed[w];
#pragma unroll
      for (int r = 0; r < kBlock; ++r)
        if ((live >> r) & 1ull) live &= ~diag[r];
      kept_word = live;
    } else if (tid >= 32 && w + 1 < words) {
      // Meanwhile warps 1.. start copying the next row block into the other
      // buffer, last read before the previous barrier.
      stage_rows(rows, staged + ((w + 1) & 1) * kBlock * words, w + 1, k, words, tid - 32,
                 kScanThreads - 32);
    }
    __syncthreads();
    const unsigned long long kept = kept_word;
    const int i0 = w * kBlock;
    if (tid < kBlock && i0 + tid < k) keep[(size_t)b * k + i0 + tid] = (kept >> tid) & 1ull;
    // (kept row r, later word ww) pairs: thread tid takes word
    // w + 1 + tid % later (neighbouring threads read neighbouring words of
    // a row) and the rows r = tid / later + n * groups.
    const int later = words - 1 - w;
    if (later > 0 && kept != 0ull) {
      const int groups = kScanThreads / later;  // >= 2: words <= 128
      const int first = tid / later;
      if (first < groups) {
        const int ww = w + 1 + tid % later;
        unsigned long long acc = 0ull;
        for (int r = first; r < kBlock; r += groups)
          if ((kept >> r) & 1ull) acc |= cur[r * words + ww];
        if (acc != 0ull) atomicOr(&removed[ww], acc);
      }
    }
    __pipeline_wait_prior(0);  // the next row block has landed
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int nms_max_k() { return kMaxK; }

// The mask pass on `stream`: (B, K, words) uint64 suppression bits, upper
// blocks only.  Returns the launch error code (0 = ok).
int nms_mask_launch(const float* boxes, const int* cls, int batch, int k, float threshold,
                    unsigned long long* mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (k + kBlock - 1) / kBlock;
  dim3 grid(words, words, batch);
  nms_mask_kernel<<<grid, kMaskThreads, 0, s>>>(boxes, cls, k, words, threshold, mask);
  return static_cast<int>(cudaGetLastError());
}

// The scan on `stream`, after nms_mask_launch on the same stream: the (B, K)
// keep flags.  Returns the launch error code (0 = ok).
int nms_scan_launch(const float* scores, const unsigned long long* mask, int batch, int k,
                    float pad_score, bool* keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (k + kBlock - 1) / kBlock;
  const size_t smem = 2 * sizeof(unsigned long long) * kBlock * words;  // 128 KB at K 8192
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_scan_kernel<<<batch, kScanThreads, smem, s>>>(scores, mask, k, words, pad_score, keep);
  return static_cast<int>(cudaGetLastError());
}

const char* nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
