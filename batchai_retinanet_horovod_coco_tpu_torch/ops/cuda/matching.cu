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
//                    rows go to shared memory (box, area, label, mask: 28 B
//                    a gt).  Each thread owns kPerThread anchors (strided by
//                    kThreads, so loads and stores coalesce) and loops over
//                    g in ascending order; a strict > keeps the first
//                    argmax, as jnp.argmax does.  The matched box and label
//                    are read straight from shared memory (the TPU kernel's
//                    one-hot MXU product is not carried over).  Per gt, a
//                    warp reduces its best (IoU, anchor) with two redux ops,
//                    lane 0 folds it into a block key in shared memory, and
//                    after the loop the block folds its keys into the global
//                    ones with one atomicMax a gt.
//   finalize_kernel  unpacks the (B, G) keys into IoU and anchor index.
//
// The per-gt key is 64 bits: the IoU's f32 bits above the complement of
// the anchor index.  IoU >= 0 here, and the bits of non-negative floats
// order like their values, so the largest key holds the highest IoU and,
// among equal IoUs, the lowest anchor: the same answer on every run, with
// no float atomics.
//
// Bound on this card: about 16 f32 operations a (anchor, real gt) pair
// (322.6 M pairs at B 16, A 201 600 and 100 real gts an image: some
// 0.077 ms at 67 TFLOP/s) and about 81 MB of anchors and outputs (some
// 0.024 ms at 3.35 TB/s): the operations bound it when every row is a real
// gt, the bytes when most rows are padding.  The design keeps the pair loop
// free of memory traffic: gt rows are shared-memory broadcasts, anchors
// live in registers.  Every row, padding too, still costs its two warp
// reductions and a shared atomic.
//
// IoU arithmetic is op for op ops/iou.py (max/min corners → clamped w, h →
// product → (area_a + area_b) - inter → union > 0 ? inter / max(union,
// 1e-12) : 0) with round-to-nearest intrinsics; the build passes
// --fmad=false.  A state flips if an IoU crosses 0.5 or 0.4 by one ulp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;  // anchors a block
constexpr int kMaxGt = 1024;                  // 36 KB of shared memory

__device__ __forceinline__ float area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.0f), fmaxf(__fsub_rn(y2, y1), 0.0f));
}

// IoU of anchor a against gt b, with b's area precomputed by area().
__device__ __forceinline__ float iou(float4 a, float area_a, float4 b, float area_b) {
  float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  float inter = __fmul_rn(iw, ih);
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.0f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.0f;
}

__global__ void match_kernel(const float4* __restrict__ anchors,   // (A,)
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
  int* s_mask = s_label + num_gt;

  const int b = blockIdx.y;
  const int a0 = blockIdx.x * kTile;
  for (int g = threadIdx.x; g < num_gt; g += kThreads) {
    const float4 box = gt_boxes[(size_t)b * num_gt + g];
    s_box[g] = box;
    s_area[g] = area(box.x, box.y, box.z, box.w);
    s_label[g] = gt_labels[(size_t)b * num_gt + g];
    s_mask[g] = gt_mask[(size_t)b * num_gt + g] != 0;
    s_key[g] = 0ull;
  }
  __syncthreads();

  float4 box[kPerThread];
  float box_area[kPerThread];
  float best[kPerThread];
  int best_g[kPerThread];
  bool live[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int a = a0 + k * kThreads + threadIdx.x;
    live[k] = a < num_anchors;
    box[k] = live[k] ? anchors[a] : make_float4(0.f, 0.f, 0.f, 0.f);
    box_area[k] = area(box[k].x, box[k].y, box[k].z, box[k].w);
    best[k] = -1.0f;  // below any IoU, so g = 0 always takes it
    best_g[k] = 0;
  }
  const unsigned lane = threadIdx.x & 31u;
  for (int g = 0; g < num_gt; ++g) {
    const float4 gb = s_box[g];
    const float ga = s_area[g];
    const bool valid = s_mask[g];
    // This thread's best anchor for gt g: anchors ascend with k, so a
    // strict > keeps the lowest index.  hi = IoU bits, lo = ~anchor; an
    // empty thread contributes 0, below every live anchor's key.
    unsigned hi = 0u, lo = 0u;
    float thread_best = -1.0f;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (!live[k]) continue;
      const float v = valid ? iou(box[k], box_area[k], gb, ga) : 0.0f;
      if (v > best[k]) {
        best[k] = v;
        best_g[k] = g;
      }
      if (v > thread_best) {
        thread_best = v;
        hi = __float_as_uint(__fadd_rn(v, 0.0f));  // -0 → +0: keep the sign bit clear
        lo = ~static_cast<unsigned>(a0 + k * kThreads + threadIdx.x);
      }
    }
    const unsigned warp_hi = __reduce_max_sync(0xffffffffu, hi);
    const unsigned warp_lo = __reduce_max_sync(0xffffffffu, hi == warp_hi ? lo : 0u);
    if (lane == 0 && warp_lo != 0u)
      atomicMax(&s_key[g], (static_cast<unsigned long long>(warp_hi) << 32) | warp_lo);
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
  for (int g = threadIdx.x; g < num_gt; g += kThreads)
    if (s_key[g] != 0ull) atomicMax(&gt_keys[(size_t)b * num_gt + g], s_key[g]);
}

__global__ void finalize_kernel(const unsigned long long* __restrict__ gt_keys, int n,
                                float* __restrict__ gt_best_iou,
                                int* __restrict__ gt_best_anchor) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = gt_keys[i];
  gt_best_iou[i] = __uint_as_float(static_cast<unsigned>(key >> 32));
  gt_best_anchor[i] = static_cast<int>(~static_cast<unsigned>(key & 0xffffffffull));
}

}  // namespace

extern "C" {

int match_max_gt() { return kMaxGt; }

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
                                        sizeof(float) + 2 * sizeof(int));
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
