// Fused sigmoid focal loss, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels batchai_retinanet_horovod_coco_tpu/ops/pallas/
// focal.py: _call_fwd (body _fwd_kernel) and _call_bwd (body _bwd_kernel).
// Same functions, over logits (B, A, K) f32 and per-anchor int32 labels and
// states (B, A), with the one-hot target t = (state == 1) & (label == k)
// rebuilt in the kernel and ignored anchors (state == -1) masked:
//
//   forward   per-image sums (B,) of the exp-form focal loss
//               sp_neg = softplus(-x),  xt = t ? x : 0
//               loss   = alpha_t * exp(-gamma (sp_neg + xt)) * (sp_neg + x - xt)
//   backward  dL/dx from the closed form, scaled by the image's cotangent g_b
//               p = exp(-sp_neg),  q = 1 - p = exp(-sp_pos),  sp_pos = softplus(x)
//               t=1: alpha   * exp(-gamma sp_pos) * (-q - gamma p sp_neg)
//               t=0: (1 - a) * exp(-gamma sp_neg) * (p + gamma q sp_pos)
//
// softplus(y) is max(y, 0) + log1p(exp(-|y|)), as jax.nn.softplus
// (logaddexp(y, 0)) computes it; torch's softplus returns y above 20 and
// would differ there.  The forward follows the JAX kernel op for op.  The
// backward is the JAX kernel's closed form, except that it takes sp_pos
// and q = 1 - p from their own softplus and exp (sharing log1p(exp(-|x|))
// with sp_neg) where JAX forms x + sp_neg and 1 - p: those cancel, and
// at |x| near 10 put errors of about 1e-6 of the largest gradient into the
// result, where these stay at f32 rounding of autograd's.  Round-to-nearest
// intrinsics throughout, and no FMA contraction (--fmad=false).
//
//   focal_fwd_kernel     grid (ceil(G / (kThreads Items)), B), where G is the
//                        image's number of V-element groups (V = 4 when K is a
//                        multiple of 4: one 16-byte load; else V = 1).  Each
//                        thread sums Items groups in order, the block reduces
//                        with a fixed shuffle tree and writes ONE partial.
//                        The forward tile (groups a block, kThreads x Items)
//                        is 1024 or 2048; each tile sums in its own order,
//                        so two tiles' sums may differ in their last bits,
//                        and one tile's repeat bit for bit.
//   focal_reduce_kernel  one block an image sums its partials in a fixed
//                        order, so the loss is the same bit for bit from run
//                        to run (no float atomics).
//   focal_bwd_kernel     one thread a group: reads V logits, writes V grads;
//                        Threads a block, 128 or 256 (elementwise, so
//                        every tile gives the same gradient bit for bit).
//
// Bound on this card: bytes.  The forward reads B·A·K·4 bytes of logits and
// 8 bytes an anchor (1.03 GB at B 16, A 201 600, K 80: some 0.32 ms at
// 3.35 TB/s); the backward reads as much and writes the gradient (about
// 0.62 ms).  The design streams the logits once a direction with coalesced
// 16-byte loads and keeps every intermediate in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads of a forward and a reduce block

struct Focal {
  float alpha, one_minus_alpha, neg_gamma, gamma;
};

__device__ __forceinline__ float softplus_neg(float x) {  // softplus(-x)
  return __fadd_rn(fmaxf(-x, 0.0f), log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ float focal_term(float x, bool t, const Focal& f) {
  const float sp_neg = softplus_neg(x);
  const float xt = t ? x : 0.0f;
  const float bce = __fsub_rn(__fadd_rn(sp_neg, x), xt);
  const float modulator = expf(__fmul_rn(f.neg_gamma, __fadd_rn(sp_neg, xt)));
  const float alpha_t = t ? f.alpha : f.one_minus_alpha;
  return __fmul_rn(__fmul_rn(alpha_t, modulator), bce);
}

__device__ __forceinline__ float focal_grad(float x, bool t, const Focal& f) {
  const float tail = log1pf(expf(-fabsf(x)));
  const float sp_neg = __fadd_rn(fmaxf(-x, 0.0f), tail);  // -log p
  const float sp_pos = __fadd_rn(fmaxf(x, 0.0f), tail);   // -log(1 - p)
  const float p = expf(-sp_neg);
  const float q = expf(-sp_pos);  // 1 - p
  const float modulator = expf(__fmul_rn(f.neg_gamma, t ? sp_pos : sp_neg));
  const float inner =
      t ? __fsub_rn(-q, __fmul_rn(__fmul_rn(f.gamma, p), sp_neg))
        : __fadd_rn(p, __fmul_rn(__fmul_rn(f.gamma, q), sp_pos));
  const float alpha_t = t ? f.alpha : f.one_minus_alpha;
  return __fmul_rn(__fmul_rn(alpha_t, modulator), inner);
}

template <int V>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ static void get(const T& v, float* out) {
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static T make(const float* in) { return make_float4(in[0], in[1], in[2], in[3]); }
};
template <>
struct Vec<1> {
  using T = float;
  __device__ static void get(const T& v, float* out) { out[0] = v; }
  __device__ static T make(const float* in) { return in[0]; }
};

// Sum of the focal terms of group q of image b (0 when its anchor is ignored).
template <int V>
__device__ __forceinline__ float group_sum(const typename Vec<V>::T* logits,
                                           const int* labels, const int* state,
                                           size_t img, int per_anchor, int q,
                                           const Focal& f) {
  const int anchor = q / per_anchor;
  const int s = state[img + anchor];
  if (s == -1) return 0.0f;
  const int label = labels[img + anchor];
  const int k0 = (q - anchor * per_anchor) * V;
  float x[V];
  Vec<V>::get(logits[img * per_anchor + q], x);
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < V; ++j)
    sum = __fadd_rn(sum, focal_term(x[j], s == 1 && label == k0 + j, f));
  return sum;
}

__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = 0.0f;
  if (warp == 0) {
    v = lane < kThreads / 32 ? scratch[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;  // valid in thread 0
}

// No __launch_bounds__ here: with it ptxas gave the forward fewer registers
// and the card ran it some 4% slower.
template <int V, int Items>
__global__ void focal_fwd_kernel(const typename Vec<V>::T* __restrict__ logits,
                                 const int* __restrict__ labels,
                                 const int* __restrict__ state, int num_anchors,
                                 int per_anchor, Focal f, float* __restrict__ partials) {
  __shared__ float scratch[kThreads / 32];
  const int b = blockIdx.y;
  const int groups = num_anchors * per_anchor;
  const size_t img = (size_t)b * num_anchors;
  const int q0 = blockIdx.x * (kThreads * Items) + threadIdx.x;
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < Items; ++i) {
    const int q = q0 + i * kThreads;
    if (q < groups) sum = __fadd_rn(sum, group_sum<V>(logits, labels, state, img, per_anchor, q, f));
  }
  sum = block_sum(sum, scratch);
  if (threadIdx.x == 0) partials[(size_t)b * gridDim.x + blockIdx.x] = sum;
}

__global__ void focal_reduce_kernel(const float* __restrict__ partials, int n,
                                    float* __restrict__ out) {
  __shared__ float scratch[kThreads / 32];
  const int b = blockIdx.x;
  float sum = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads)
    sum = __fadd_rn(sum, partials[(size_t)b * n + i]);
  sum = block_sum(sum, scratch);
  if (threadIdx.x == 0) out[b] = sum;
}

template <int V, int Threads>
__global__ void focal_bwd_kernel(const typename Vec<V>::T* __restrict__ logits,
                                 const int* __restrict__ labels,
                                 const int* __restrict__ state,
                                 const float* __restrict__ cotangent, int num_anchors,
                                 int per_anchor, Focal f,
                                 typename Vec<V>::T* __restrict__ grad) {
  const int b = blockIdx.y;
  const int q = blockIdx.x * Threads + threadIdx.x;
  if (q >= num_anchors * per_anchor) return;
  const size_t img = (size_t)b * num_anchors;
  const int anchor = q / per_anchor;
  const int s = state[img + anchor];
  float dx[V];
  if (s == -1) {
#pragma unroll
    for (int j = 0; j < V; ++j) dx[j] = 0.0f;
  } else {
    const int label = labels[img + anchor];
    const int k0 = (q - anchor * per_anchor) * V;
    const float g = cotangent[b];
    float x[V];
    Vec<V>::get(logits[img * per_anchor + q], x);
#pragma unroll
    for (int j = 0; j < V; ++j)
      dx[j] = __fmul_rn(focal_grad(x[j], s == 1 && label == k0 + j, f), g);
  }
  grad[img * per_anchor + q] = Vec<V>::make(dx);
}

Focal make_focal(float alpha, float one_minus_alpha, float gamma) {
  return Focal{alpha, one_minus_alpha, -gamma, gamma};
}

template <int Items>
void launch_fwd(dim3 grid, const float* logits, const int* labels, const int* state,
                int num_anchors, int per_anchor, int vec, const Focal& f, float* partials,
                cudaStream_t s) {
  if (vec == 4)
    focal_fwd_kernel<4, Items><<<grid, kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(logits), labels, state, num_anchors, per_anchor, f,
        partials);
  else
    focal_fwd_kernel<1, Items><<<grid, kThreads, 0, s>>>(logits, labels, state, num_anchors,
                                                          per_anchor, f, partials);
}

template <int Threads>
void launch_bwd(int groups, int batch, const float* logits, const int* labels,
                const int* state, const float* cotangent, int num_anchors, int per_anchor,
                int vec, const Focal& f, float* grad, cudaStream_t s) {
  dim3 grid((groups + Threads - 1) / Threads, batch);
  if (vec == 4)
    focal_bwd_kernel<4, Threads><<<grid, Threads, 0, s>>>(
        reinterpret_cast<const float4*>(logits), labels, state, cotangent, num_anchors,
        per_anchor, f, reinterpret_cast<float4*>(grad));
  else
    focal_bwd_kernel<1, Threads><<<grid, Threads, 0, s>>>(logits, labels, state, cotangent,
                                                          num_anchors, per_anchor, f, grad);
}

}  // namespace

extern "C" {

// Forward at `tile` groups a block (1024 or 2048; the menu of
// ops/cuda/shapes.py): `partials` is
// (B, ceil(G / tile)) scratch, `sums` (B,).  `vec` is 4 (K a multiple of 4,
// 16-byte aligned logits) or 1.  Returns the launch error code (0 = ok;
// cudaErrorInvalidValue for a tile off the menu).
int focal_fwd_launch(const float* logits, const int* labels, const int* state, int batch,
                     int num_anchors, int num_classes, int vec, float alpha,
                     float one_minus_alpha, float gamma, float* partials, float* sums,
                     int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Focal f = make_focal(alpha, one_minus_alpha, gamma);
  const int per_anchor = num_classes / vec;
  const int groups = num_anchors * per_anchor;
  const int blocks = (groups + tile - 1) / tile;
  dim3 grid(blocks, batch);
  switch (tile) {
    case 1024: launch_fwd<4>(grid, logits, labels, state, num_anchors, per_anchor, vec, f,
                             partials, s); break;
    case 2048: launch_fwd<8>(grid, logits, labels, state, num_anchors, per_anchor, vec, f,
                             partials, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  focal_reduce_kernel<<<batch, kThreads, 0, s>>>(partials, blocks, sums);
  return static_cast<int>(cudaGetLastError());
}

// Backward at `tile` threads a block (128 or 256): `grad`
// (B, A, K) = dL/dlogits scaled by `cotangent` (B,).
int focal_bwd_launch(const float* logits, const int* labels, const int* state,
                     const float* cotangent, int batch, int num_anchors, int num_classes,
                     int vec, float alpha, float one_minus_alpha, float gamma, float* grad,
                     int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Focal f = make_focal(alpha, one_minus_alpha, gamma);
  const int per_anchor = num_classes / vec;
  const int groups = num_anchors * per_anchor;
  switch (tile) {
    case 128: launch_bwd<128>(groups, batch, logits, labels, state, cotangent, num_anchors,
                              per_anchor, vec, f, grad, s); break;
    case 256: launch_bwd<256>(groups, batch, logits, labels, state, cotangent, num_anchors,
                              per_anchor, vec, f, grad, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* focal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
