// Fused anchor→gt assignment for Hopper (sm_90a).
//
// Replaces the TPU kernel batchai_retinanet_horovod_coco_tpu/ops/pallas/
// matching.py (assign_fused → _kernel).  Same function: for B images of G
// padded gt boxes against A shared anchors, the IoU of every (anchor, gt)
// pair (masked gts give 0) reduced two ways:
//
//   per anchor:  max IoU, the FIRST gt reaching it, and that gt's box and
//                label;
//   per gt:      best IoU, and the LOWEST anchor index reaching it.
//
//   match_kernel     grid (ceil(A / kTile), B), kThreads threads.  The G gt
//                    rows go to shared memory (box, area, label, key, mask
//                    and a list slot: 37 B a gt).  Each thread owns
//                    kPerThread anchors (strided by kThreads, so loads and
//                    stores coalesce) in registers.  Each warp reduces each
//                    of its kPerThread chunks of 32 consecutive anchors to
//                    the chunk's bounding box (min x1, min y1, max x2,
//                    max y2), and the block reduces those to the tile's box.
//                    Warp 0 then lists, in ascending g, the gts that are real
//                    (gt_mask) and overlap the tile's box strictly on both
//                    axes, with a ballot and popc prefix over chunks of 32
//                    rows.  Every warp walks only that list, and for each
//                    listed gt only the chunks whose box it overlaps by the
//                    same test (a warp-uniform branch).  Per anchor a strict
//                    > from (0, g 0) keeps the first argmax, as jnp.argmax
//                    does; the matched box and label are read from shared
//                    memory, row 0 included when it is padding (as the
//                    plain gather does).  Per gt a warp folds its best
//                    (IoU, anchor) with two redux ops when that IoU is > 0,
//                    lane 0 folds it into a block key in shared memory, and
//                    the block folds the listed gts' keys into the global
//                    ones with one atomicMax a gt.
//   finalize_kernel  unpacks the (B, G) keys into IoU and anchor index; a
//                    key of 0 (no anchor above IoU 0) is (0.0, anchor 0).
//
// Why the culling is exact.  Let (tx1, ty1, tx2, ty2) be the box of a set of
// anchors (the tile, or a chunk).  For every anchor a of the set,
// min(a.x2, g.x2) <= min(tx2, g.x2) and max(a.x1, g.x1) >= max(tx1, g.x1).
// So if fminf(tx2, g.x2) > fmaxf(tx1, g.x1) fails, min(a.x2, g.x2) -
// max(a.x1, g.x1) is <= 0 exactly, its correctly rounded difference is <= 0
// too, the clamp gives iw = 0 and the IoU is 0 for every anchor of the set;
// the same holds for y.  Masked gts give 0 by definition.  A skipped
// (anchor, gt) pair therefore only ever offers an IoU of 0, which can tie a
// per-anchor maximum of 0 only, and for that the first index, g = 0, wins:
// the start value (0, g 0).  Per gt, the plain max and first argmax of a
// column of zeros is (0, anchor 0): the unfolded key 0.  Any IoU above 0
// comes from a walked pair, and the list is walked in ascending g, so
// strict > still keeps the first maximum.
//
// The per-gt key is 64 bits: the IoU's f32 bits above the complement of
// the anchor index.  Only IoUs > 0 are folded, and the bits of positive
// floats order like their values, so the largest key holds the highest IoU
// and, among equal IoUs, the lowest anchor: the same answer on every run,
// with no float atomics.
//
// Bound on this card: the bytes, about 81 MB of anchors and outputs at B 16,
// A 201 600 (some 0.024 ms at 3.35 TB/s).  Most (anchor, gt row) pairs have
// an IoU of 0 by construction, and computing them would make the kernel
// issue-bound: on the first training batch, of 1 260 800 (256-anchor tile,
// gt row) pairs only some 46 000 are real gts that overlap the tile's box
// (anchors are ordered (level, y, x, anchor), so a tile is a run of about 28
// positions along a row), and of their 11.8 M (anchor, gt) pairs some 5.5 M
// lie in a chunk whose box the gt overlaps (a chunk of 32 anchors is three
// or four neighbouring positions).  Smaller tiles cull more and cost more
// blocks; of 256, 512 and 1024 anchors a tile, 256 measured fastest.
//
// IoU arithmetic is op for op ops/iou.py (max/min corners → clamped w, h →
// product → (area_a + area_b) - inter → union > 0 ? inter / max(union,
// 1e-12) : 0) with round-to-nearest intrinsics; the build passes
// --fmad=false.  A state flips if an IoU crosses 0.5 or 0.4 by one ulp.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 1;
constexpr int kTile = kThreads * kPerThread;  // anchors a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGt = 1024;  // 37 KB of shared memory

__device__ __forceinline__ float area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.0f), fmaxf(__fsub_rn(y2, y1), 0.0f));
}

// IoU of anchor a against gt b, with b's area precomputed by area().
__device__ __forceinline__ float iou(float4 a, float area_a, float4 b, float area_b) {
  float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  float inter = __fmul_rn(iw, ih);
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  // No overlap gives 0 without the divide (0 / union is 0 up to its sign,
  // which no comparison sees): a zero dividend takes __fdiv_rn's slow path.
  return inter > 0.0f && uni > 0.0f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.0f;
}

// (min x1, min y1, max x2, max y2) over the warp's lanes.
__device__ __forceinline__ float4 warp_box(float4 t) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    t.x = fminf(t.x, __shfl_xor_sync(0xffffffffu, t.x, o));
    t.y = fminf(t.y, __shfl_xor_sync(0xffffffffu, t.y, o));
    t.z = fmaxf(t.z, __shfl_xor_sync(0xffffffffu, t.z, o));
    t.w = fmaxf(t.w, __shfl_xor_sync(0xffffffffu, t.w, o));
  }
  return t;
}

// Strict overlap of box c with gt g on both axes (the list's test).
__device__ __forceinline__ bool overlaps(float4 c, float4 g) {
  return fminf(c.z, g.z) > fmaxf(c.x, g.x) && fminf(c.w, g.w) > fmaxf(c.y, g.y);
}

__global__ void __launch_bounds__(kThreads)
match_kernel(const float4* __restrict__ anchors,   // (A,)
             const float4* __restrict__ gt_boxes,  // (B, G)
             const int* __restrict__ gt_labels,    // (B, G)
             const uint8_t* __restrict__ gt_mask,  // (B, G)
             int num_anchors, int num_gt,
             float4* __restrict__ matched_boxes,   // (B, A)
             int* __restrict__ matched_labels,     // (B, A)
             float* __restrict__ max_iou,          // (B, A)
             unsigned long long* __restrict__ gt_keys) {  // (B, G)
  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_box = reinterpret_cast<float4*>(smem);
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(s_box + num_gt);
  float* s_area = reinterpret_cast<float*>(s_key + num_gt);
  int* s_label = reinterpret_cast<int*>(s_area + num_gt);
  int* s_list = s_label + num_gt;  // listed gts, ascending
  uint8_t* s_real = reinterpret_cast<uint8_t*>(s_list + num_gt);
  __shared__ float4 s_warp_box[kWarps];
  __shared__ int s_count;

  const int b = blockIdx.y;
  const int a0 = blockIdx.x * kTile;
  const unsigned lane = threadIdx.x & 31u;
  const int warp = threadIdx.x >> 5;
  for (int g = threadIdx.x; g < num_gt; g += kThreads) {
    const float4 box = gt_boxes[(size_t)b * num_gt + g];
    s_box[g] = box;
    s_area[g] = area(box.x, box.y, box.z, box.w);
    s_label[g] = gt_labels[(size_t)b * num_gt + g];
    s_real[g] = gt_mask[(size_t)b * num_gt + g];
    s_key[g] = 0ull;
  }

  float4 box[kPerThread];
  float4 chunk[kPerThread];  // box of the warp's 32 consecutive anchors at k
  float box_area[kPerThread];
  float best[kPerThread];
  int best_g[kPerThread];
  bool live[kPerThread];
  const float4 empty = make_float4(INFINITY, INFINITY, -INFINITY, -INFINITY);
  float4 tile = empty;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int a = a0 + k * kThreads + threadIdx.x;
    live[k] = a < num_anchors;
    box[k] = live[k] ? anchors[a] : make_float4(0.f, 0.f, 0.f, 0.f);
    box_area[k] = area(box[k].x, box[k].y, box[k].z, box[k].w);
    best[k] = 0.0f;  // a gt off the list offers 0, and g = 0 wins that tie
    best_g[k] = 0;
    chunk[k] = warp_box(live[k] ? box[k] : empty);
    tile.x = fminf(tile.x, chunk[k].x);
    tile.y = fminf(tile.y, chunk[k].y);
    tile.z = fmaxf(tile.z, chunk[k].z);
    tile.w = fmaxf(tile.w, chunk[k].w);
  }
  if (lane == 0) s_warp_box[warp] = tile;
  __syncthreads();  // also publishes the gt rows

  if (warp == 0) {
    tile = warp_box(lane < kWarps ? s_warp_box[lane] : empty);
    int count = 0;
    for (int base = 0; base < num_gt; base += 32) {
      const int g = base + lane;
      const bool hit = g < num_gt && s_real[g] && overlaps(tile, s_box[g]);
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (hit) s_list[count + __popc(ballot & ((1u << lane) - 1u))] = g;
      count += __popc(ballot);
    }
    if (lane == 0) s_count = count;
  }
  __syncthreads();

  const int count = s_count;
  for (int i = 0; i < count; ++i) {
    const int g = s_list[i];
    const float4 gb = s_box[g];
    const float ga = s_area[g];
    // This thread's best anchor for gt g with an IoU above 0: anchors
    // ascend with k, so a strict > keeps the lowest index.  hi = IoU bits,
    // lo = ~anchor.  A chunk whose box g does not overlap gets IoU 0 from
    // every anchor (the list's argument again) and is skipped; the test is
    // warp-uniform.
    unsigned hi = 0u, lo = 0u;
    float thread_best = 0.0f;
    bool walked = false;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (!overlaps(chunk[k], gb)) continue;
      walked = true;
      if (!live[k]) continue;
      const float v = iou(box[k], box_area[k], gb, ga);
      if (v > best[k]) {
        best[k] = v;
        best_g[k] = g;
      }
      if (v > thread_best) {
        thread_best = v;
        hi = __float_as_uint(__fadd_rn(v, 0.0f));  // v > 0: the sign bit stays clear
        lo = ~static_cast<unsigned>(a0 + k * kThreads + threadIdx.x);
      }
    }
    if (!walked) continue;  // warp-uniform
    const unsigned warp_hi = __reduce_max_sync(0xffffffffu, hi);
    if (warp_hi != 0u) {  // warp-uniform
      const unsigned warp_lo = __reduce_max_sync(0xffffffffu, hi == warp_hi ? lo : 0u);
      if (lane == 0)
        atomicMax(&s_key[g], (static_cast<unsigned long long>(warp_hi) << 32) | warp_lo);
    }
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (!live[k]) continue;
    const size_t o = (size_t)b * num_anchors + a0 + k * kThreads + threadIdx.x;
    matched_boxes[o] = s_box[best_g[k]];
    matched_labels[o] = s_label[best_g[k]];
    max_iou[o] = best[k];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int g = s_list[i];
    if (s_key[g] != 0ull) atomicMax(&gt_keys[(size_t)b * num_gt + g], s_key[g]);
  }
}

__global__ void finalize_kernel(const unsigned long long* __restrict__ gt_keys, int n,
                                float* __restrict__ gt_best_iou,
                                int* __restrict__ gt_best_anchor) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = gt_keys[i];
  gt_best_iou[i] = __uint_as_float(static_cast<unsigned>(key >> 32));
  // Key 0: no anchor above IoU 0, so the column is all zeros and its first
  // argmax is anchor 0.
  gt_best_anchor[i] =
      key == 0ull ? 0 : static_cast<int>(~static_cast<unsigned>(key & 0xffffffffull));
}

}  // namespace

extern "C" {

int match_max_gt() { return kMaxGt; }

int match_tile() { return kTile; }

// Launches both kernels on `stream`; `gt_keys` is (B, G) scratch.  Returns
// the launch error code (0 = ok).
int match_launch(const float* anchors, const float* gt_boxes, const int* gt_labels,
                 const uint8_t* gt_mask, int batch, int num_anchors, int num_gt,
                 float* matched_boxes, int* matched_labels, float* max_iou,
                 unsigned long long* gt_keys, float* gt_best_iou, int* gt_best_anchor,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(gt_keys, 0, sizeof(unsigned long long) * batch * num_gt, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (size_t)num_gt * (sizeof(float4) + sizeof(unsigned long long) +
                                        sizeof(float) + 2 * sizeof(int) + sizeof(uint8_t));
  dim3 grid((num_anchors + kTile - 1) / kTile, batch);
  match_kernel<<<grid, kThreads, smem, s>>>(
      reinterpret_cast<const float4*>(anchors), reinterpret_cast<const float4*>(gt_boxes),
      gt_labels, gt_mask, num_anchors, num_gt, reinterpret_cast<float4*>(matched_boxes),
      matched_labels, max_iou, gt_keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = batch * num_gt;
  finalize_kernel<<<(n + 255) / 256, 256, 0, s>>>(gt_keys, n, gt_best_iou, gt_best_anchor);
  return static_cast<int>(cudaGetLastError());
}

const char* match_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
