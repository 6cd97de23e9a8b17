// Fused ROI bilinear crop + 2x2/2 max-pool: the forward (kernel K2 of the
// port), and below it the backward (kernel K3), which shares its taps.
//
// Replaces the TPU kernel luminoth_tpu/ops/pallas/roi_align_kernel.py
// (`_roi_kernel`, reached through `_roi_align_impl`). Same result: for each
// ROI, TF `crop_and_resize`'s S x S bilinear crop of an NHWC feature map
// (zero outside the map), max-pooled 2x2 with stride 2, written as
// (S/2, S/2, C) in the feature map's dtype. The TPU kernel builds dense
// one-hot interpolation matrices so the crop runs on its matrix unit; here
// the crop is what it is, a 4-tap gather, and those matrices are never
// built: each block computes its ROI's sample taps from the normalized box.
//
// What bounds it on Hopper: memory traffic, not arithmetic. Every pooled
// output reads 4 samples x 4 taps, so the main path (8 images x 2000 ROIs x
// 7 x 7 x 1024 channels, bf16) issues ~13 G tap loads (~26 GB) against ~1 GB
// of output. The reads hit a 3.9 MB bf16 map per image, which stays in the
// 50 MB L2, so the bound is L2-to-SM load bandwidth and load issue rate.
//
// Design: one block per ROI; its 2*S taps (row/column index pair, weights
// with the out-of-map zeroing folded in) are computed once into shared
// memory. Threads run along C, so each tap load and each output store of a
// warp touches consecutive channels (coalesced, NHWC). The sum is taken in
// float32 in the plain version's order (rows first, then columns), and the
// pooled maximum is rounded to the output dtype once. The TPU kernel rounds
// its stage-1 intermediate to bf16 as well; this kernel does not, so in bf16
// it is within one bf16 rounding (2^-8 relative) of the float32 result.
// Sample coordinates follow `_sample_coords`/`_interp_matrix`
// (luminoth_tpu/ops/roi_align.py:31-52) operation for operation; the
// library is built with -fmad=false so a coordinate that lands exactly on
// dim - 1 stays in the map.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxCrop = 64;

struct Taps {
  int lo[kMaxCrop];
  int hi[kMaxCrop];
  float w_lo[kMaxCrop];
  float w_hi[kMaxCrop];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One axis of TF crop_and_resize: sample i of `size` between the normalized
// edges lo and hi of a map axis of length dim.
__device__ void make_tap(float lo, float hi, int i, int size, int dim,
                         Taps& taps) {
  const float d = static_cast<float>(dim - 1);
  const float step = static_cast<float>(i) / static_cast<float>(size - 1);
  const float coord = lo * d + step * (hi - lo) * d;
  const bool in_bounds = coord >= 0.0f && coord <= d;
  const float f = fminf(fmaxf(floorf(coord), 0.0f), d);
  const float frac = coord - f;
  const float inside = in_bounds ? 1.0f : 0.0f;
  taps.lo[i] = static_cast<int>(f);
  taps.hi[i] = min(static_cast<int>(f) + 1, dim - 1);
  taps.w_lo[i] = (1.0f - frac) * inside;
  taps.w_hi[i] = frac * inside;
}

template <typename T>
__global__ void roi_crop_pool_kernel(const T* __restrict__ fm,
                                     const float* __restrict__ boxes,
                                     T* __restrict__ out, int rois, int h,
                                     int w, int c, int s) {
  __shared__ Taps ty, tx;
  const int64_t roi = blockIdx.x;  // flat (image, roi) index
  const int64_t image = roi / rois;
  if (threadIdx.x < s) {
    const float* box = boxes + roi * 4;  // (y1, x1, y2, x2), normalized
    make_tap(box[0], box[2], threadIdx.x, s, h, ty);
  } else if (threadIdx.x < 2 * s) {
    const float* box = boxes + roi * 4;
    make_tap(box[1], box[3], threadIdx.x - s, s, w, tx);
  }
  __syncthreads();

  const T* fmi = fm + image * h * w * c;
  const int p = s / 2;
  const int total = p * p * c;
  T* out_r = out + roi * total;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int ch = idx % c;
    const int pix = idx / c;
    const int py = pix / p;
    const int px = pix % p;
    float best = -INFINITY;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int sy = 2 * py + dy;
      const int64_t row_lo = static_cast<int64_t>(ty.lo[sy]) * w;
      const int64_t row_hi = static_cast<int64_t>(ty.hi[sy]) * w;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int sx = 2 * px + dx;
        const int x_lo = tx.lo[sx];
        const int x_hi = tx.hi[sx];
        // rows first (Wy), then columns (Wx), as the plain version sums.
        const float top = ty.w_lo[sy] * to_float(fmi[(row_lo + x_lo) * c + ch]) +
                          ty.w_hi[sy] * to_float(fmi[(row_hi + x_lo) * c + ch]);
        const float bot = ty.w_lo[sy] * to_float(fmi[(row_lo + x_hi) * c + ch]) +
                          ty.w_hi[sy] * to_float(fmi[(row_hi + x_hi) * c + ch]);
        const float v = tx.w_lo[sx] * top + tx.w_hi[sx] * bot;
        best = fmaxf(best, v);
      }
    }
    store(out_r + idx, best);
  }
}

// Backward of the fused crop + pool (kernel K3 of the port).
//
// Replaces the TPU kernel luminoth_tpu/ops/pallas/roi_align_kernel.py
// (`_roi_bwd_kernel`, reached through `_roi_align_bwd_pallas`). Same result:
// d_fm (float32 NHWC) = for every pooled cell, its cotangent routed to the
// window's maximal samples (split evenly over ties), then through the
// transposed bilinear taps. The TPU kernel keeps one (W, H*C) float32
// accumulator per image resident in VMEM and applies dense one-hot Wy^T and
// Wx^T on its matrix unit; on Hopper that accumulator (7.8 MB at 38x50x1024)
// does not fit in shared memory, and the transposed crop is a 4-tap scatter.
//
// What bounds it: the scatter. Each pooled cell adds to at most 4 taps of
// each maximal sample: at the train shape (8 x 256 ROIs x 7 x 7 x 1024)
// ~0.4 G float32 atomic adds into a 62 MB map, against ~0.2 GB of tap
// loads for the recompute. Design: one block per ROI, blocks numbered
// image-major so the accumulators of the images in flight stay in the 50 MB
// L2; the taps are built once per ROI in shared memory by `make_tap` (the
// forward's), threads run along C so each warp's atomics hit 32 consecutive
// floats. The four samples of a window are recomputed with the forward
// kernel's exact float32 operations, so the routing agrees with K2's output
// and not with the TPU kernel's (which rounds its stage-1 intermediate to
// the map dtype). Zero-weight taps are skipped. Atomic order varies from
// run to run, so d_fm is not bitwise repeatable.
template <typename T>
__global__ void roi_crop_pool_bwd_kernel(const T* __restrict__ fm,
                                         const float* __restrict__ boxes,
                                         const T* __restrict__ grad,
                                         float* __restrict__ d_fm, int rois,
                                         int h, int w, int c, int s) {
  __shared__ Taps ty, tx;
  const int64_t roi = blockIdx.x;  // flat (image, roi) index, image-major
  const int64_t image = roi / rois;
  if (threadIdx.x < s) {
    const float* box = boxes + roi * 4;
    make_tap(box[0], box[2], threadIdx.x, s, h, ty);
  } else if (threadIdx.x < 2 * s) {
    const float* box = boxes + roi * 4;
    make_tap(box[1], box[3], threadIdx.x - s, s, w, tx);
  }
  __syncthreads();

  const T* fmi = fm + image * h * w * c;
  float* d_fmi = d_fm + image * h * w * c;
  const int p = s / 2;
  const int total = p * p * c;
  const T* grad_r = grad + roi * total;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int ch = idx % c;
    const int pix = idx / c;
    const int py = pix / p;
    const int px = pix % p;
    float v[2][2];
    float best = -INFINITY;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int sy = 2 * py + dy;
      const int64_t row_lo = static_cast<int64_t>(ty.lo[sy]) * w;
      const int64_t row_hi = static_cast<int64_t>(ty.hi[sy]) * w;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int sx = 2 * px + dx;
        const int x_lo = tx.lo[sx];
        const int x_hi = tx.hi[sx];
        // The forward kernel's operations, in its order.
        const float top = ty.w_lo[sy] * to_float(fmi[(row_lo + x_lo) * c + ch]) +
                          ty.w_hi[sy] * to_float(fmi[(row_hi + x_lo) * c + ch]);
        const float bot = ty.w_lo[sy] * to_float(fmi[(row_lo + x_hi) * c + ch]) +
                          ty.w_hi[sy] * to_float(fmi[(row_hi + x_hi) * c + ch]);
        v[dy][dx] = tx.w_lo[sx] * top + tx.w_hi[sx] * bot;
        best = fmaxf(best, v[dy][dx]);
      }
    }
    float ties = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) ties += v[dy][dx] == best ? 1.0f : 0.0f;
    }
    const float g = 1.0f / ties * to_float(grad_r[idx]);
    if (g == 0.0f) continue;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int sy = 2 * py + dy;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        if (v[dy][dx] != best) continue;
        const int sx = 2 * px + dx;
        const int ys[2] = {ty.lo[sy], ty.hi[sy]};
        const float wys[2] = {ty.w_lo[sy], ty.w_hi[sy]};
        const int xs[2] = {tx.lo[sx], tx.hi[sx]};
        const float wxs[2] = {tx.w_lo[sx], tx.w_hi[sx]};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (wys[i] == 0.0f) continue;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (wxs[j] == 0.0f) continue;
            // Wy^T (Wx^T g), as the plain version contracts.
            atomicAdd(d_fmi + (static_cast<int64_t>(ys[i]) * w + xs[j]) * c +
                          ch,
                      wys[i] * (wxs[j] * g));
          }
        }
      }
    }
  }
}

template <typename T>
int launch_bwd(const void* fm, const void* boxes, const void* grad,
               void* d_fm, int images, int rois, int h, int w, int c, int s,
               void* stream) {
  if (s < 2 || s > kMaxCrop || s % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = static_cast<int64_t>(images) * rois;
  if (blocks == 0) return 0;
  roi_crop_pool_bwd_kernel<T><<<static_cast<unsigned>(blocks), 256, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(fm), static_cast<const float*>(boxes),
      static_cast<const T*>(grad), static_cast<float*>(d_fm), rois, h, w, c,
      s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* fm, const void* boxes, void* out, int images, int rois,
           int h, int w, int c, int s, void* stream) {
  if (s < 2 || s > kMaxCrop || s % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = static_cast<int64_t>(images) * rois;
  if (blocks == 0) return 0;
  roi_crop_pool_kernel<T><<<static_cast<unsigned>(blocks), 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(fm), static_cast<const float*>(boxes),
      static_cast<T*>(out), rois, h, w, c, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// fm: (images, h, w, c) NHWC; boxes: (images, rois, 4) float32 normalized
// (y1, x1, y2, x2); out: (images, rois, s/2, s/2, c) in fm's dtype.
// Returns cudaGetLastError() after the launch.
int lumi_roi_crop_pool_f32(const void* fm, const void* boxes, void* out,
                           int images, int rois, int h, int w, int c, int s,
                           void* stream) {
  return launch<float>(fm, boxes, out, images, rois, h, w, c, s, stream);
}

int lumi_roi_crop_pool_bf16(const void* fm, const void* boxes, void* out,
                            int images, int rois, int h, int w, int c, int s,
                            void* stream) {
  return launch<__nv_bfloat16>(fm, boxes, out, images, rois, h, w, c, s,
                               stream);
}

// Backward: grad (images, rois, s/2, s/2, c) in fm's dtype; d_fm (images, h,
// w, c) float32, zeroed by the caller and accumulated into.
int lumi_roi_crop_pool_bwd_f32(const void* fm, const void* boxes,
                               const void* grad, void* d_fm, int images,
                               int rois, int h, int w, int c, int s,
                               void* stream) {
  return launch_bwd<float>(fm, boxes, grad, d_fm, images, rois, h, w, c, s,
                           stream);
}

int lumi_roi_crop_pool_bwd_bf16(const void* fm, const void* boxes,
                                const void* grad, void* d_fm, int images,
                                int rois, int h, int w, int c, int s,
                                void* stream) {
  return launch_bwd<__nv_bfloat16>(fm, boxes, grad, d_fm, images, rois, h, w,
                                   c, s, stream);
}

const char* lumi_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
