// Fused ROI bilinear crop + 2x2/2 max-pool: the forward (kernel K2 of the
// port), and below it the backward (kernel K3), which shares its taps and
// its sample arithmetic.
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
// What bounds it on Hopper: bytes, and nearly as much the float32 ALU. At
// the serving shape (8 images x 2000 ROIs x 7 x 7 x 1024 channels, bf16)
// the output is 16000 * 49 * 1024 * 2 B = 1.61 GB against a 31 MB map:
// 0.49 ms at 3.35 TB/s. The arithmetic is ~39 float32 operations per
// output, 31 GFLOP, 0.47 ms at 67 TFLOP/s. A direct gather with one thread
// per output element issues 16 scalar 2-byte loads per output and re-reads
// every map element up to 16 times per ROI from L2 (~26 GB of L2 reads).
//
// Design: one block of 256 threads per ROI.
//  * Taps. The ROI's S row samples and S column samples are built once by
//    `make_tap`. Their tap rows (lo and hi of every sample, at most 2S) are
//    deduplicated into "slots", and so are the tap columns: the footprint
//    is the distinct rows x distinct columns, at most 2S x 2S (28 x 28 at
//    S = 14), often far fewer.
//  * Staging. The footprint is copied into shared memory with `cp.async`
//    16 bytes at a time, in channel slices (a power of two of 16-byte
//    vectors, as many as a 52 KB stage holds), double buffered: slice k+1
//    is in flight while slice k is computed. Each map element crosses from
//    L2 once per ROI; the copies bypass L1 and the output is stored with a
//    streaming hint, so the maps stay in L2.
//  * Vectors. A thread owns one vector of 8 consecutive bf16 channels (4
//    float32) in every slice and strides over the pooled cells: one 16-byte
//    shared load per tap, one 16-byte store per output, no integer division
//    in the loops, and bit operations to widen bf16 to float32.
// With the bytes cut, the bf16 kernel's next bound is instruction issue:
// ~55 instructions per output (16 widenings, 36 float32 operations, 3 max),
// ~1.8 ms of issue at the serving shape on 132 SMs.
//  * Arithmetic. Each sample is `bilinear` (rows first, then columns, in
//    float32, the plain version's order) and the pooled maximum is rounded
//    to the output dtype once. K3 recomputes the samples with the same
//    `bilinear`, so it routes each cotangent where K2 found the maximum. The
//    TPU kernel rounds its stage-1 intermediate to bf16 as well; this
//    kernel does not, so in bf16 it is within one bf16 rounding (2^-8
//    relative) of the float32 result.
// Sample coordinates follow `_sample_coords`/`_interp_matrix`
// (luminoth_tpu/ops/roi_align.py:31-52) operation for operation; the
// library is built with -fmad=false so a coordinate that lands exactly on
// dim - 1 stays in the map, and no product is fused into a sum.
// The channel count must be a multiple of the vector width (8 bf16, 4
// float32) and S at most 28; the wrapper raises otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxStagedCrop = 28;  // 2S x 2S taps fit one stage
constexpr int kStageBytes = 52 * 1024;
constexpr int kForwardThreads = 256;
constexpr int kBackwardThreads = 256;
// K3's dynamic shared memory: two blocks to an SM (with their static taps
// and the reserved kilobyte, within its 228 KB) unless one vector of the
// crop's widest footprint needs more.
constexpr int kBackwardSmem = 108 * 1024;

struct Tap {
  int lo, hi;
  float w_lo, w_hi;
};

// One axis of TF crop_and_resize: sample i of `size` between the normalized
// edges lo and hi of a map axis of length dim.
__device__ Tap make_tap(float lo, float hi, int i, int size, int dim) {
  const float d = static_cast<float>(dim - 1);
  const float step = static_cast<float>(i) / static_cast<float>(size - 1);
  const float coord = lo * d + step * (hi - lo) * d;
  const bool in_bounds = coord >= 0.0f && coord <= d;
  const float f = fminf(fmaxf(floorf(coord), 0.0f), d);
  const float frac = coord - f;
  const float inside = in_bounds ? 1.0f : 0.0f;
  Tap t;
  t.lo = static_cast<int>(f);
  t.hi = min(static_cast<int>(f) + 1, dim - 1);
  t.w_lo = (1.0f - frac) * inside;
  t.w_hi = frac * inside;
  return t;
}

// One bilinear sample from its four taps, rows first (Wy) and then columns
// (Wx), as the plain version sums. K2 and K3 both call it, so the sample K3
// recomputes is bitwise the sample K2 pooled. `a_yx`: the map value at
// (y_lo or y_hi, x_lo or x_hi).
__device__ __forceinline__ float bilinear(const Tap& ty, const Tap& tx,
                                          float a_ll, float a_hl, float a_lh,
                                          float a_hh) {
  const float top = ty.w_lo * a_ll + ty.w_hi * a_hl;
  const float bot = ty.w_lo * a_lh + ty.w_hi * a_hh;
  return tx.w_lo * top + tx.w_hi * bot;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// 16 bytes of channels: 8 bf16 or 4 float32, unpacked to float32 and
// packed back with bit operations on the four 32-bit words (a bf16 is the
// high half of its float32; element 0 is the low half of word 0).
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kWidth = 4;
  __device__ static void unpack(const uint4& u, float* out) {
    out[0] = __uint_as_float(u.x);
    out[1] = __uint_as_float(u.y);
    out[2] = __uint_as_float(u.z);
    out[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kWidth = 8;
  __device__ static void unpack_word(uint32_t word, float* out) {
    out[0] = __uint_as_float(word << 16);
    out[1] = __uint_as_float(word & 0xffff0000u);
  }
  __device__ static void unpack(const uint4& u, float* out) {
    unpack_word(u.x, out);
    unpack_word(u.y, out + 2);
    unpack_word(u.z, out + 4);
    unpack_word(u.w, out + 6);
  }
  // Rounds each float to nearest even, as __float2bfloat16_rn does.
  __device__ static uint32_t pack_word(float lo, float hi) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
           static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
               << 16;
  }
  __device__ static uint4 pack(const float* v) {
    return make_uint4(pack_word(v[0], v[1]), pack_word(v[2], v[3]),
                      pack_word(v[4], v[5]), pack_word(v[6], v[7]));
  }
};

// The ROI's taps, and its distinct tap rows and columns ("slots").
struct RoiTaps {
  Tap t[2][kMaxStagedCrop];           // [axis: 0 rows, 1 columns][sample]
  int slot[2][2 * kMaxStagedCrop];    // [axis][k]: slot of tap k (lo: k < S)
  int coord[2][2 * kMaxStagedCrop];   // [axis][slot]: map row / column
  int first[2][2 * kMaxStagedCrop];   // [axis][k]: first k' with tap k's
  int count[2];                       // distinct rows, distinct columns
};

// Builds `taps` with the first 4S threads of the block; ends synchronized.
__device__ void build_roi_taps(const float* box, int h, int w, int s,
                               RoiTaps& taps) {
  const int tid = threadIdx.x;
  if (tid < 2 * s) {
    const int axis = tid / s;
    const int i = tid - axis * s;
    // box: (y1, x1, y2, x2), normalized
    taps.t[axis][i] = make_tap(box[axis], box[axis + 2], i, s,
                               axis == 0 ? h : w);
  }
  __syncthreads();
  const int axis = tid / (2 * s);
  const int k = tid - axis * 2 * s;
  int value = 0;
  if (tid < 4 * s) {
    const Tap* t = taps.t[axis];
    auto tap_of = [&](int j) { return j < s ? t[j].lo : t[j - s].hi; };
    value = tap_of(k);
    int first = k;
    for (int j = 0; j < k; ++j) {
      if (tap_of(j) == value) {
        first = j;
        break;
      }
    }
    taps.first[axis][k] = first;
  }
  __syncthreads();
  if (tid < 4 * s && taps.first[axis][k] == k) {
    int rank = 0;
    for (int j = 0; j < k; ++j) rank += taps.first[axis][j] == j;
    taps.slot[axis][k] = rank;
    taps.coord[axis][rank] = value;
    if (k == 0) {
      int distinct = 0;
      for (int j = 0; j < 2 * s; ++j) distinct += taps.first[axis][j] == j;
      taps.count[axis] = distinct;
    }
  }
  __syncthreads();
  if (tid < 4 * s && taps.first[axis][k] != k) {
    taps.slot[axis][k] = taps.slot[axis][taps.first[axis][k]];
  }
  __syncthreads();
}

// Starts copying channel vector `vec` of the ROI's footprint (its distinct
// tap rows x columns) into `buf`, slot-major with `per_slice` vectors a
// slot, this thread's at `v`: slots first, first + stride, ... Commits one
// cp.async group, empty when `vec` is past the last of `vectors`.
template <typename T>
__device__ __forceinline__ void stage_footprint(
    const T* fmi, const RoiTaps& taps, int w, int c, int vec, int vectors,
    int per_slice, int v, int first, int stride, uint4* buf) {
  if (vec < vectors) {
    const int cols = taps.count[1];
    const int footprint = taps.count[0] * cols;
    int r = first / cols;
    int col = first - r * cols;
    for (int rc = first; rc < footprint; rc += stride) {
      const T* src = fmi + (static_cast<int64_t>(taps.coord[0][r]) * w +
                            taps.coord[1][col]) * c + vec * Vec<T>::kWidth;
      cp_async16(buf + rc * per_slice + v, src);
      col += stride;
      while (col >= cols) {
        col -= cols;
        ++r;
      }
    }
  }
  cp_async_commit();
}

// Sample (sy, sx) of the crop for the channels of this thread's vector `v`,
// from the staged footprint `buf`.
template <typename T>
__device__ __forceinline__ void staged_sample(const uint4* buf,
                                              const RoiTaps& taps, int s,
                                              int per_slice, int v, int sy,
                                              int sx, float* out) {
  constexpr int kWidth = Vec<T>::kWidth;
  const int cols = taps.count[1];
  const Tap ty = taps.t[0][sy];
  const Tap tx = taps.t[1][sx];
  const int r_lo = taps.slot[0][sy] * cols;
  const int r_hi = taps.slot[0][s + sy] * cols;
  const int c_lo = taps.slot[1][sx];
  const int c_hi = taps.slot[1][s + sx];
  float a_ll[kWidth], a_hl[kWidth], a_lh[kWidth], a_hh[kWidth];
  Vec<T>::unpack(buf[(r_lo + c_lo) * per_slice + v], a_ll);
  Vec<T>::unpack(buf[(r_hi + c_lo) * per_slice + v], a_hl);
  Vec<T>::unpack(buf[(r_lo + c_hi) * per_slice + v], a_lh);
  Vec<T>::unpack(buf[(r_hi + c_hi) * per_slice + v], a_hh);
#pragma unroll
  for (int e = 0; e < kWidth; ++e) {
    out[e] = bilinear(ty, tx, a_ll[e], a_hl[e], a_lh[e], a_hh[e]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kForwardThreads)
    roi_crop_pool_kernel(const T* __restrict__ fm,
                         const float* __restrict__ boxes, T* __restrict__ out,
                         int rois, int h, int w, int c, int s) {
  constexpr int kWidth = Vec<T>::kWidth;
  extern __shared__ __align__(16) unsigned char stage[];
  __shared__ RoiTaps taps;
  const int64_t roi = blockIdx.x;  // flat (image, roi) index
  const int64_t image = roi / rois;
  build_roi_taps(boxes + roi * 4, h, w, s, taps);

  const int rows = taps.count[0];
  const int cols = taps.count[1];
  const int footprint = rows * cols;
  const int vectors = c / kWidth;
  // Vectors of channels per slice: the largest power of two one stage
  // holds, at most the block's threads. A thread keeps one vector of every
  // slice and strides over the cells (and the footprint, when copying).
  int lg = 0;
  while ((2 << lg) * footprint * 16 <= kStageBytes &&
         (2 << lg) <= kForwardThreads && (1 << lg) < vectors) {
    ++lg;
  }
  const int per_slice = 1 << lg;
  const int slices = (vectors + per_slice - 1) / per_slice;
  const int v = threadIdx.x & (per_slice - 1);
  const int first = threadIdx.x >> lg;
  const int stride = kForwardThreads >> lg;
  const T* fmi = fm + image * h * w * c;
  const int p = s / 2;
  const int cells = p * p;
  T* out_r = out + roi * cells * c;

  auto load_slice = [&](int slice) {
    stage_footprint<T>(
        fmi, taps, w, c, slice * per_slice + v, vectors, per_slice, v, first,
        stride, reinterpret_cast<uint4*>(stage + (slice & 1) * kStageBytes));
  };

  load_slice(0);
  for (int slice = 0; slice < slices; ++slice) {
    if (slice + 1 < slices) {
      load_slice(slice + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint4* buf =
        reinterpret_cast<const uint4*>(stage + (slice & 1) * kStageBytes);
    const int vec = slice * per_slice + v;
    if (vec < vectors) {
      int py = first / p;
      int px = first - py * p;
      for (int cell = first; cell < cells; cell += stride) {
        float best[kWidth];
#pragma unroll
        for (int e = 0; e < kWidth; ++e) best[e] = -INFINITY;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            float sample[kWidth];
            staged_sample<T>(buf, taps, s, per_slice, v, 2 * py + dy,
                             2 * px + dx, sample);
#pragma unroll
            for (int e = 0; e < kWidth; ++e) {
              best[e] = fmaxf(best[e], sample[e]);
            }
          }
        }
        __stcs(reinterpret_cast<uint4*>(out_r + cell * c + vec * kWidth),
               Vec<T>::pack(best));
        px += stride;
        while (px >= p) {
          px -= p;
          ++py;
        }
      }
    }
    // The next iteration's copy overwrites this buffer.
    __syncthreads();
  }
}

// Backward of the fused crop + pool (kernel K3 of the port).
//
// Replaces the TPU kernel luminoth_tpu/ops/pallas/roi_align_kernel.py
// (`_roi_bwd_kernel`, reached through `_roi_align_bwd_pallas`). Same result:
// d_fm (float32 NHWC) = for every pooled cell, its cotangent routed to the
// window's maximal samples (split evenly over ties), then through the
// transposed bilinear taps (Wx^T, then Wy^T); zero-weight taps get nothing.
// The TPU kernel keeps one (W, H*C) float32 accumulator per image resident
// in VMEM and applies dense one-hot Wy^T and Wx^T on its matrix unit. That
// accumulator (7.8 MB at 38x50x1024) does not fit in shared memory; one
// ROI's footprint does, so this kernel sums each ROI's gradient on chip and
// hands it to global memory once per footprint slot.
//
// What bounds it on Hopper: instructions and shared-memory reads, not
// the atomics. On an H100 SXM (700 W), at the train shape (8 x 256 ROIs,
// 38x50x1024, S = 14, bf16), the first form of this kernel (one thread per
// pooled output and channel, 16 scalar map loads and ~4 scalar global
// atomics per output) ran 2.32 ms; without its map loads 2.28, without its
// atomics 2.32, without both 1.39 (`scripts/k3_variants.py`): loads and
// atomics hid behind each other and the per-element index arithmetic
// (division by runtime C and S/2, 64-bit addresses) was the rest. A first
// redesign kept a float32 footprint accumulator in shared memory and added
// into it with `atomicAdd`: on sm_90 a shared-memory float atomic is a
// compare-and-swap loop, and the kernel ran 6.6 ms. A scatter of every
// tap straight into d_fm (16-byte atomics, no accumulation) ran 2.6 ms on
// random boxes and 4.2 ms on a train step's, whose ROIs crowd the same
// map rows. Hence the design below, whose time splits into staging ~0.1
// ms, recomputing and routing ~0.65 ms (K2's float32 arithmetic, no FMA,
// plus the routing), and the gather ~0.6 ms (each routed sample is read
// from shared memory once for each of its 4 taps).
//
// Design: one block of 256 threads per ROI, K2's structure; per channel
// slice, two phases.
//  * Taps and staging as in K2 (`build_roi_taps`, `stage_footprint`): the
//    footprint of each channel slice is copied into shared memory with
//    `cp.async`, double buffered, and each sample is recomputed from it by
//    `staged_sample`, the function K2 pools, so the routing follows K2's
//    output bit for bit. A thread owns one 16-byte vector of channels (8
//    bf16, 4 float32) of a cell and reads the cell's cotangents with one
//    16-byte streaming load, issued a cell ahead.
//  * Route: each cell writes its four samples' routed cotangents (g / ties
//    where the sample is the window's maximum, else 0) into a float32
//    sample grid in shared memory. Every sample belongs to one cell, so no
//    two threads write one place.
//  * Gather: one thread per footprint slot and vector sums, in registers,
//    the slot's terms: the samples that tap it, with weight wy * wx, laid
//    out once per ROI (`build_terms`). Taps move monotonically along each
//    axis, so the samples that tap a slot are one run, and a slot's terms
//    are its row run times its column run. The sum goes into d_fm with
//    one 16-byte `atomicAdd` (sm_90, global memory) per float4, skipped
//    when all zero: one atomic per touched slot and float4 of channels,
//    and no two threads write one slot.
//  * Slices: as many vectors as fit two stage buffers and the sample grid
//    beside the terms in 108 KB (two blocks to an SM); the launch asks for
//    more when one vector of the crop's widest footprint (2S x 2S) needs
//    it.
// Blocks run image-major (interleaving the images was no faster). Global
// atomics from different ROIs add in an order that varies from run to
// run, so d_fm is not bitwise repeatable; sums of exactly representable
// terms are exact.

// The samples of one axis that tap a slot (their lo or hi tap is the
// slot's coordinate k, so their lo tap is k - 1 or k): taps move
// monotonically along an axis, so they are one run [begin, end).
struct Run {
  short begin, end;
};

// The runs of every slot of both axes, built from `taps` with the first
// 4S threads; ends synchronized.
__device__ void build_runs(const RoiTaps& taps, int s,
                           Run (&runs)[2][2 * kMaxStagedCrop]) {
  const int axis = threadIdx.x / (2 * s);
  const int slot = threadIdx.x - axis * 2 * s;
  if (threadIdx.x < 4 * s && slot < taps.count[axis]) {
    const int coord = taps.coord[axis][slot];
    int begin = s, end = 0;
    for (int i = 0; i < s; ++i) {
      if (taps.t[axis][i].lo == coord || taps.t[axis][i].hi == coord) {
        begin = min(begin, i);
        end = i + 1;
      }
    }
    runs[axis][slot] = {static_cast<short>(begin), static_cast<short>(end)};
  }
  __syncthreads();
}

// The weight of `tap` at map coordinate `coord` (both taps may be on it,
// at the map's last row or column).
__device__ __forceinline__ float tap_weight(const Tap& tap, int coord) {
  return (tap.lo == coord ? tap.w_lo : 0.0f) +
         (tap.hi == coord ? tap.w_hi : 0.0f);
}

// One term of a slot's gradient: a sample that taps the slot (its index
// sy * S + sx) and its weight there, wy * wx.
struct Term {
  int sample;
  float weight;
};

// Where each footprint slot's terms start. Slots are in row-major order,
// and the terms of slot (r, col) are the samples of its row run times
// those of its column run.
struct TermIndex {
  short before[2][2 * kMaxStagedCrop];  // [axis][slot]: run lengths before
  int total[2];                         // [axis]: all run lengths
  __device__ int first_term(const Run (&runs)[2][2 * kMaxStagedCrop], int r,
                            int col) const {
    return before[0][r] * total[1] +
           (runs[0][r].end - runs[0][r].begin) * before[1][col];
  }
};

// Builds `index` with the first two threads, then lays out every slot's
// terms with all; ends synchronized.
__device__ void build_terms(const RoiTaps& taps,
                            const Run (&runs)[2][2 * kMaxStagedCrop], int s,
                            TermIndex& index, Term* terms) {
  if (threadIdx.x < 2) {
    const int axis = threadIdx.x;
    int sum = 0;
    for (int slot = 0; slot < taps.count[axis]; ++slot) {
      index.before[axis][slot] = sum;
      sum += runs[axis][slot].end - runs[axis][slot].begin;
    }
    index.total[axis] = sum;
  }
  __syncthreads();
  const int cols = taps.count[1];
  for (int rc = threadIdx.x; rc < taps.count[0] * cols; rc += blockDim.x) {
    const int r = rc / cols;
    const int col = rc - r * cols;
    int t = index.first_term(runs, r, col);
    for (int sy = runs[0][r].begin; sy < runs[0][r].end; ++sy) {
      const float wy = tap_weight(taps.t[0][sy], taps.coord[0][r]);
      for (int sx = runs[1][col].begin; sx < runs[1][col].end; ++sx) {
        terms[t++] = {sy * s + sx,
                      wy * tap_weight(taps.t[1][sx], taps.coord[1][col])};
      }
    }
  }
  __syncthreads();
}

// 1 / ties for ties in {1, 2, 3, 4}, correctly rounded as 1.0f / ties is.
__device__ __forceinline__ float inverse_ties(int ties) {
  return ties == 1 ? 1.0f : ties == 2 ? 0.5f : ties == 3 ? 1.0f / 3.0f
                                                         : 0.25f;
}

// Shared memory a vector of a slice takes: two stage buffers of its
// footprint and its sample grid.
template <typename T>
__host__ __device__ constexpr int backward_vector_bytes(int footprint,
                                                        int s) {
  return 2 * 16 * footprint + 4 * Vec<T>::kWidth * s * s;
}

// Shared memory of the terms: at most 2S taps of each axis' slots, so at
// most 2S x 2S terms.
__host__ __device__ constexpr int backward_term_bytes(int s) {
  return 4 * s * s * static_cast<int>(sizeof(Term));
}

// Adds one float4 of a slot's gradient into d_fm: one 16-byte atomic, none
// when all four are zero.
__device__ __forceinline__ void flush(float* dst, const float4& sum) {
  if (sum.x != 0.0f || sum.y != 0.0f || sum.z != 0.0f || sum.w != 0.0f) {
    atomicAdd(reinterpret_cast<float4*>(dst), sum);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBackwardThreads, 2)
    roi_crop_pool_bwd_kernel(const T* __restrict__ fm,
                             const float* __restrict__ boxes,
                             const T* __restrict__ grad,
                             float* __restrict__ d_fm, int rois, int h, int w,
                             int c, int s, int smem_bytes) {
  constexpr int kWidth = Vec<T>::kWidth;
  constexpr int kQuarters = kWidth / 4;  // float4s in a vector
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ RoiTaps taps;
  __shared__ Run runs[2][2 * kMaxStagedCrop];
  __shared__ TermIndex index;
  const int64_t roi = blockIdx.x;  // flat (image, roi) index, image-major
  const int64_t image = roi / rois;
  Term* terms = reinterpret_cast<Term*>(smem);
  build_roi_taps(boxes + roi * 4, h, w, s, taps);
  build_runs(taps, s, runs);
  build_terms(taps, runs, s, index, terms);

  const int cols = taps.count[1];
  const int footprint = taps.count[0] * cols;
  const int vectors = c / kWidth;
  // Vectors per slice: as many as fit, at most one a thread. A thread
  // keeps one vector (v) of every slice; the cells (route) and slots
  // (stage, gather) it takes are `first`, `first + stride`, ...
  const int per_slice =
      min(min((smem_bytes - backward_term_bytes(s)) /
                  backward_vector_bytes<T>(footprint, s),
              vectors),
          kBackwardThreads);
  const int slices = (vectors + per_slice - 1) / per_slice;
  const int v = threadIdx.x % per_slice;
  const int first = threadIdx.x / per_slice;
  const int stride = kBackwardThreads / per_slice;
  const int busy = stride * per_slice;  // threads with a vector
  uint4* stage = reinterpret_cast<uint4*>(smem + backward_term_bytes(s));
  float4* routed =
      reinterpret_cast<float4*>(stage + 2 * footprint * per_slice);

  const T* fmi = fm + image * h * w * c;
  float* d_fmi = d_fm + image * h * w * c;
  const int p = s / 2;
  const int cells = p * p;
  const T* grad_r = grad + roi * cells * c;

  auto load_slice = [&](int slice) {
    stage_footprint<T>(fmi, taps, w, c, slice * per_slice + v,
                       threadIdx.x < busy ? vectors : 0, per_slice, v, first,
                       stride, stage + (slice & 1) * footprint * per_slice);
  };

  load_slice(0);
  for (int slice = 0; slice < slices; ++slice) {
    const int vec = slice * per_slice + v;
    const bool active = threadIdx.x < busy && vec < vectors;
    // The cotangents come from device memory: each cell's load is issued
    // one cell ahead of its use, the first before the barrier.
    const T* grad_v = grad_r + vec * kWidth;
    uint4 g_next = make_uint4(0, 0, 0, 0);
    if (active && first < cells) {
      g_next = __ldcs(reinterpret_cast<const uint4*>(grad_v + first * c));
    }
    if (slice + 1 < slices) {
      load_slice(slice + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // The stage is in, and the last slice's gather has read the grid.
    __syncthreads();
    const uint4* buf = stage + (slice & 1) * footprint * per_slice;
    if (active) {
      int py = first / p;
      int px = first - py * p;
      for (int cell = first; cell < cells; cell += stride) {
        const uint4 g_cell = g_next;
        if (cell + stride < cells) {
          g_next = __ldcs(
              reinterpret_cast<const uint4*>(grad_v + (cell + stride) * c));
        }
        float sample[2][2][kWidth];
        float best[kWidth];
#pragma unroll
        for (int e = 0; e < kWidth; ++e) best[e] = -INFINITY;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            // The forward kernel's sample, bit for bit.
            staged_sample<T>(buf, taps, s, per_slice, v, 2 * py + dy,
                             2 * px + dx, sample[dy][dx]);
#pragma unroll
            for (int e = 0; e < kWidth; ++e) {
              best[e] = fmaxf(best[e], sample[dy][dx][e]);
            }
          }
        }
        float g[kWidth];
        Vec<T>::unpack(g_cell, g);
#pragma unroll
        for (int e = 0; e < kWidth; ++e) {
          int ties = 0;
#pragma unroll
          for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
            for (int dx = 0; dx < 2; ++dx) {
              ties += sample[dy][dx][e] == best[e];
            }
          }
          g[e] = inverse_ties(ties) * g[e];
        }
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            float r[kWidth];
#pragma unroll
            for (int e = 0; e < kWidth; ++e) {
              r[e] = sample[dy][dx][e] == best[e] ? g[e] : 0.0f;
            }
            // Grid layout [sample][float4 q][vector]: a warp's lanes
            // (consecutive vectors) write and read consecutive 16 bytes.
            float4* out = routed + ((2 * py + dy) * s + 2 * px + dx) *
                                       kQuarters * per_slice + v;
#pragma unroll
            for (int q = 0; q < kQuarters; ++q) {
              out[q * per_slice] = make_float4(r[4 * q], r[4 * q + 1],
                                               r[4 * q + 2], r[4 * q + 3]);
            }
          }
        }
        px += stride;
        while (px >= p) {
          px -= p;
          ++py;
        }
      }
    }
    // The grid is complete; the next slice's copy may take this stage.
    __syncthreads();
    if (active) {
      int r = first / cols;
      int col = first - r * cols;
      for (int rc = first; rc < footprint; rc += stride) {
        const int y = taps.coord[0][r];
        const int x = taps.coord[1][col];
        int t = index.first_term(runs, r, col);
        const int end = t + (runs[0][r].end - runs[0][r].begin) *
                                (runs[1][col].end - runs[1][col].begin);
        float sum[kWidth];
#pragma unroll
        for (int e = 0; e < kWidth; ++e) sum[e] = 0.0f;
        for (; t < end; ++t) {
          const Term term = terms[t];
          const float4* in =
              routed + term.sample * kQuarters * per_slice + v;
#pragma unroll
          for (int q = 0; q < kQuarters; ++q) {
            const float4 a = in[q * per_slice];
            sum[4 * q] = __fmaf_rn(term.weight, a.x, sum[4 * q]);
            sum[4 * q + 1] = __fmaf_rn(term.weight, a.y, sum[4 * q + 1]);
            sum[4 * q + 2] = __fmaf_rn(term.weight, a.z, sum[4 * q + 2]);
            sum[4 * q + 3] = __fmaf_rn(term.weight, a.w, sum[4 * q + 3]);
          }
        }
        float* dst = d_fmi + (static_cast<int64_t>(y) * w + x) * c +
                     vec * kWidth;
#pragma unroll
        for (int q = 0; q < kQuarters; ++q) {
          flush(dst + 4 * q, make_float4(sum[4 * q], sum[4 * q + 1],
                                         sum[4 * q + 2], sum[4 * q + 3]));
        }
        col += stride;
        while (col >= cols) {
          col -= cols;
          ++r;
        }
      }
    }
  }
}

template <typename T>
int launch_bwd(const void* fm, const void* boxes, const void* grad,
               void* d_fm, int images, int rois, int h, int w, int c, int s,
               void* stream) {
  if (s < 2 || s > kMaxStagedCrop || s % 2 != 0 ||
      c % Vec<T>::kWidth != 0 ||
      reinterpret_cast<uintptr_t>(fm) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(grad) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(d_fm) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = static_cast<int64_t>(images) * rois;
  if (blocks == 0 || c == 0) return 0;
  const int widest =
      backward_vector_bytes<T>(4 * s * s, s) + backward_term_bytes(s);
  const int smem = widest > kBackwardSmem ? widest : kBackwardSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      roi_crop_pool_bwd_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  roi_crop_pool_bwd_kernel<T><<<static_cast<unsigned>(blocks),
                                kBackwardThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(fm), static_cast<const float*>(boxes),
      static_cast<const T*>(grad), static_cast<float*>(d_fm), rois, h, w, c,
      s, smem);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* fm, const void* boxes, void* out, int images, int rois,
           int h, int w, int c, int s, void* stream) {
  if (s < 2 || s > kMaxStagedCrop || s % 2 != 0 ||
      c % Vec<T>::kWidth != 0 ||
      reinterpret_cast<uintptr_t>(fm) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = static_cast<int64_t>(images) * rois;
  if (blocks == 0 || c == 0) return 0;
  constexpr int kSmem = 2 * kStageBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      roi_crop_pool_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  roi_crop_pool_kernel<T><<<static_cast<unsigned>(blocks), kForwardThreads,
                            kSmem, static_cast<cudaStream_t>(stream)>>>(
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
