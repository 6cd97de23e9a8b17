// Grouped greedy-NMS alive mask (kernel K1 of the port).
//
// Replaces the TPU kernel luminoth_tpu/ops/pallas/nms_kernel.py
// (`_nms_kernel`, reached through `nms_alive_pallas`). Same contract: per
// group, over candidates already sorted by descending score, the exact
// greedy alive mask ("a candidate survives iff no higher-scored survivor
// overlaps it with IoU strictly above the threshold"). IoU has no +1 on
// widths and guards the union at 1e-8, in exactly `_pair_iou`'s order;
// the library is built with -fmad=false so no product is fused into an add.
//
// What bounds it on Hopper: not bytes (a group is at most 12000 boxes,
// 192 KB) and not IoU arithmetic (a few MFLOP per group), but the serial
// dependency of greedy NMS: whether candidate i survives depends on every
// survivor before it. The TPU kernel hides that behind a sequential grid of
// 512-candidate tiles with an in-tile fixpoint; Hopper's blocks run in no
// order, so nothing can carry state from one block to the next.
//
// Design (form (a): one block per group). The group's boxes are copied once
// into shared memory (12000 x 16 B = 192 KB fits the 227 KB opt-in; larger
// groups read their boxes from global memory instead) next to one alive
// byte per candidate. A loop inside the block walks the candidates in score
// order. A dead candidate costs one shared-memory read and no barrier; each
// survivor is broadcast to all threads, which strike the later candidates
// it overlaps in parallel, then one __syncthreads. The cost is therefore
// (survivors visited) x (one sweep + one barrier). The bitmask form (b)
// would spend 18 MB of IoU bits per RPN group to save those barriers; it is
// the next candidate if the sweep shows up in the profile.
//
// Early exit (exact, optional): with max_survivors > 0 the walk stops at the
// max_survivors-th survivor. Every entry up to it is then final; later
// entries are left partly swept, which the caller's top-max_survivors
// selection never reads (the same contract as the TPU kernel's prefix exit).
// Invalid candidates start dead and never suppress.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmemBytes = 227 * 1024;

__device__ __forceinline__ float pair_iou(float4 a, float4 b) {
  // `_pair_iou` (nms_kernel.py:37-45), operation for operation.
  float xi1 = fmaxf(a.x, b.x);
  float yi1 = fmaxf(a.y, b.y);
  float xi2 = fminf(a.z, b.z);
  float yi2 = fminf(a.w, b.w);
  float inter = fmaxf(xi2 - xi1, 0.0f) * fmaxf(yi2 - yi1, 0.0f);
  float area_a = (a.z - a.x) * (a.w - a.y);
  float area_b = (b.z - b.x) * (b.w - b.y);
  return inter / fmaxf(area_a + area_b - inter, 1e-8f);
}

__global__ void nms_alive_kernel(const float4* __restrict__ boxes,
                                 const uint8_t* __restrict__ valid,
                                 uint8_t* __restrict__ alive_out, int n,
                                 float iou_threshold, int max_survivors,
                                 bool boxes_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x;
  const float4* gboxes = boxes + static_cast<int64_t>(g) * n;
  uint8_t* alive;
  const float4* cand;
  if (boxes_in_smem) {
    float4* sboxes = reinterpret_cast<float4*>(smem);
    for (int j = threadIdx.x; j < n; j += blockDim.x) sboxes[j] = gboxes[j];
    cand = sboxes;
    alive = smem + static_cast<size_t>(n) * sizeof(float4);
  } else {
    cand = gboxes;
    alive = smem;
  }
  const uint8_t* gvalid = valid + static_cast<int64_t>(g) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) alive[j] = gvalid[j] != 0;
  __syncthreads();

  int survivors = 0;  // identical in every thread: all read the same flags
  for (int i = 0; i < n; ++i) {
    if (!alive[i]) continue;
    ++survivors;
    if (max_survivors > 0 && survivors >= max_survivors) break;
    const float4 a = cand[i];
    for (int j = i + 1 + threadIdx.x; j < n; j += blockDim.x) {
      if (alive[j] && pair_iou(a, cand[j]) > iou_threshold) alive[j] = 0;
    }
    __syncthreads();
  }

  uint8_t* gout = alive_out + static_cast<int64_t>(g) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) gout[j] = alive[j];
}

}  // namespace

extern "C" {

// boxes: (groups, n, 4) float32, score-sorted per group; valid: (groups, n)
// bool; alive_out: (groups, n) bool. Returns cudaGetLastError() after the
// launch.
int lumi_nms_alive(const void* boxes, const void* valid, void* alive_out,
                   int groups, int n, float iou_threshold, int max_survivors,
                   void* stream) {
  if (groups == 0 || n == 0) return 0;
  size_t smem = static_cast<size_t>(n) * (sizeof(float4) + 1);
  bool boxes_in_smem = smem <= kMaxSmemBytes;
  if (!boxes_in_smem) smem = static_cast<size_t>(n);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      nms_alive_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = n >= 4096 ? 1024 : 256;
  nms_alive_kernel<<<groups, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(alive_out), n, iou_threshold, max_survivors,
      boxes_in_smem);
  return static_cast<int>(cudaGetLastError());
}

const char* lumi_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
