// Multi-level aligned RoIAlign, forward (K1) and backward (K2), for Hopper
// (sm_90a).
//
// K1 replaces iif_tpu/ops/pallas/roi_align_kernel.py::roi_align_pallas_ml
// (the Pallas TPU kernel _make_ml_kernel / _pallas_ml_call). It computes
// what SingleRoIExtractor._flat_gather computes
// (iif_tpu/detection/roi_extractor.py:97-166), none of the TPU machinery:
// no DMA windows, no edge padding, no one-hot matmuls, no misfit cap. Sums
// run in f32 and the result is rounded once into the feature type.
//
// K2 replaces the custom VJP's backward (_ml_bwd, _pallas_ml_bwd_call,
// _make_ml_bwd_kernel): the gradient of K1 with respect to the four
// levels, none for the RoIs. Each bin's incoming gradient, divided by
// s*s, is spread over its samples' four bilinear corners with exactly
// K1's sample positions, clamps and high-corner snap. On the card no RoI
// misfits a window, so every RoI takes the kernel.
//
// K1's bound is HBM bytes: the feature rows its samples touch, read once,
// and its (R, out, out, C) output, written once (0.038 ms at 7x7, R=2000,
// bf16, C=256). A first version ran at a fifth of it: one block a (RoI,
// bin row) of 128 threads paid the RoI's geometry and a __syncthreads to
// write one 7-wide bin row (14,000 blocks at R=2000), and its threads
// spent about 100 instructions on each output element (two channels a
// thread, 16 four-byte corner loads, 12 float operations a sample). The
// design, shared with K3 (roi_align_common.cuh):
//   1. Eight channels a thread (vec8): a corner is one 16-byte load of a
//      bf16 level, a bin's bf16 output one 16-byte store. Any other even
//      C, or a level or output not 16-byte aligned, takes the same kernel
//      at two channels a thread (pair); the wrapper chooses.
//   2. One block a RoI: its x and y taps are computed once into shared
//      memory. At C=256 one warp spans C and takes a bin row: 7 warps, a
//      7x7 RoI in one pass, a 14x14 one in two.
//   3. s = 2 unrolled.
//   4. Not the separable FMA blend that K3 takes: K1's bf16 output is held
//      within one bf16 ulp of the plain version's, and summed in another
//      order a near-zero output moves by more (seen on the card). K1 keeps
//      the plain version's op order (12 float operations a sample and
//      channel) and equals it.
//   5. Plain stores: K3's streaming stores were measured on its f32
//      output only (0.8 GB at R=1000); K1 writes 50 MB at 7x7, R=2000.
//
// K2's bound is HBM bytes: g read once, the touched f32 accumulator rows
// read and written once and the levels' gradient written once (0.18 ms at
// 7x7, R=2048, B=4, bf16, C=256). A first version gave each (RoI, bin
// row) a block and issued eight scalar f32 atomics per sample and channel
// pair, 411 M a call at either training shape, and ran at 8-11% of the
// bound. The TPU kernel computes a RoI's window at once as dF = row_w^T g
// col_w with the 1/s^2 pool folded into the weights. Here, as K4
// (roi_align_common.cuh, roi_align.cu): one block a (RoI, split) builds
// the RoI's distinct rows and columns at its level with their bins'
// summed weights (1/s^2 folded into the rows) once in shared memory;
// each work item (a row slot, 8 channels as two runs of 4) walks the
// bins, sums g over them in registers and adds one float4 atomic per
// touched (row, column) and 4 channels: for an FPN-mapped RoI 14-28
// cells wide at its level, at most 29 x 29 at 14x14 and 28 x 28 at 7x7
// (fewer where taps share cells), against 3,136 and 784 scalar atomics a
// channel. At C=256 a chunk of 64 channels spans 8 lanes; 7x7 takes two
// blocks a RoI, 14x14 four (kPasses), and a RoI of at most 8 rows 8
// consecutive channels an item (kSmallRows, as K4). vec8 needs C % 8 == 0 and g and every level's
// accumulator on 16 bytes; the pair path (2 channels, float2 atomics)
// takes any other layout; the wrapper chooses. Its pace is set as K4's,
// by the L2's reductions (0.76 GB at 7x7, 0.22 GB at 14x14), and by the
// wrapper's memset of all four levels' accumulators and, for bf16, their
// cast (0.27 ms at B=4, 800x1344), which stay. Tensor cores and TMA are
// not used, for K4's reasons.
//
// This file is built with -fmad=false and K1 and K2 take their taps from
// the one make_tap (roi_align_common.cuh). The FPN level of each RoI comes
// from the caller (the same map_roi_levels as the plain path), never from
// a device log2f near a level boundary.
#include "roi_align_common.cuh"

namespace {

constexpr int kMaxLevels = 4;

struct Levels {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float stride[kMaxLevels];
};

// Select by a runtime level without indexing the parameter arrays, which
// would copy them to local memory.
template <typename V>
__device__ __forceinline__ V pick(const V (&arr)[kMaxLevels], int l) {
  return l == 0 ? arr[0] : l == 1 ? arr[1] : l == 2 ? arr[2] : arr[3];
}

// K1. One block a RoI; blockDim.x = lanes x rows (block_shape).
template <typename T, int V, int S>
__global__ void __launch_bounds__(kMaxThreads)
    roi_align_ml_fwd_kernel(Levels lv, const float* __restrict__ rois,
                            const int* __restrict__ lvl,
                            const int* __restrict__ bidx,
                            T* __restrict__ out, int channels, int out_size,
                            int samples, int lanes) {
  __shared__ Weights xw[kMaxTaps];
  __shared__ Weights yw[kMaxTaps];

  const int r = blockIdx.x;
  const int l = lvl[r];
  const int height = pick(lv.h, l);
  const int width = pick(lv.w, l);
  const float scale = 1.0f / pick(lv.stride, l);
  const float* roi = rois + (size_t)r * 5;
  const float x1 = roi[1] * scale - 0.5f;
  const float y1 = roi[2] * scale - 0.5f;
  const float x2 = roi[3] * scale - 0.5f;
  const float y2 = roi[4] * scale - 0.5f;
  const float bin_w = (x2 - x1) / (float)out_size;
  const float bin_h = (y2 - y1) / (float)out_size;
  const int taps = out_size * samples;

  for (int t = threadIdx.x; t < taps; t += blockDim.x) {
    xw[t] = weights_of(make_tap(x1, bin_w, t, samples, (float)(width - 1)));
    yw[t] = weights_of(make_tap(y1, bin_h, t, samples, (float)(height - 1)));
  }
  __syncthreads();

  const T* feat = static_cast<const T*>(pick(lv.ptr, l)) +
                  (size_t)bidx[r] * height * width * channels;
  forward_roi<T, T, V, S, false>(
      feat, (size_t)width * channels, channels, xw, yw, out_size, out_size,
      samples, lanes, out + (size_t)r * out_size * out_size * channels);
}

template <typename T, int V>
cudaError_t launch_fwd(const Levels& lv, const float* rois, const int* lvl,
                       const int* bidx, T* out, int num_rois, int channels,
                       int out_size, int samples, cudaStream_t st) {
  const BlockShape shape = block_shape(channels, V, out_size);
  if (samples == 2) {
    roi_align_ml_fwd_kernel<T, V, 2><<<num_rois, shape.threads, 0, st>>>(
        lv, rois, lvl, bidx, out, channels, out_size, samples, shape.lanes);
  } else {
    roi_align_ml_fwd_kernel<T, V, 0><<<num_rois, shape.threads, 0, st>>>(
        lv, rois, lvl, bidx, out, channels, out_size, samples, shape.lanes);
  }
  return cudaGetLastError();
}

// K2's items a thread for a RoI of out * s + 1 rows (bwd_shape).
// map_roi_levels puts a RoI on the level where it spans 14-28 cells (the
// finest level takes all smaller ones), so its RoIs mostly fill their
// blocks: on a MaskRCNN training step's RoIs 2 took 2% longer at 7x7 and
// 1% less at 14x14 (PERF.md).
constexpr int kPasses = 1;

// K2. One block a (RoI, split), on K1's taps: both footprints built once
// a block at the RoI's level, the block's share of the RoI's (row slot,
// channels) items scattered into the level's f32 accumulator with one
// vector atomic per touched (row, column). Overlapping RoIs add up in an
// order that changes from run to run.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
    roi_align_ml_bwd_kernel(Levels acc, const float* __restrict__ rois,
                            const int* __restrict__ lvl,
                            const int* __restrict__ bidx,
                            const T* __restrict__ grad, int channels,
                            int out_size, int samples) {
  const int r = blockIdx.x;
  const int l = lvl[r];
  const int height = pick(acc.h, l);
  const int width = pick(acc.w, l);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* p = smem;
  const Footprint ys = carve_footprint(p, out_size, samples, height);
  const Footprint xs = carve_footprint(p, out_size, samples, width);
  const float scale = 1.0f / pick(acc.stride, l);
  const float* roi = rois + (size_t)r * 5;
  const float x1 = roi[1] * scale - 0.5f;
  const float y1 = roi[2] * scale - 0.5f;
  const float x2 = roi[3] * scale - 0.5f;
  const float y2 = roi[4] * scale - 0.5f;
  const float bin_w = (x2 - x1) / (float)out_size;
  const float bin_h = (y2 - y1) / (float)out_size;
  const int taps = out_size * samples;
  const int rows_max =
      slot_bound(end_span(y1, bin_h, taps, samples, height), taps);
  if (!has_items(rows_max, channels, V)) return;

  for (int t = threadIdx.x; t < taps; t += blockDim.x) {
    ys.tap[t] = make_tap(y1, bin_h, t, samples, (float)(height - 1));
  }
  __syncthreads();
  const Span rows = tap_span(ys.tap, taps);
  // the mean over the s x s samples folded into the row weights, as the
  // TPU kernel folds it (_tap_weights(..., fold_pool=True))
  const int n_rows = build_footprint(
      ys, out_size, samples, 1.0f / (float)(samples * samples), rows);
  if (!has_items(n_rows, channels, V)) return;
  for (int t = threadIdx.x; t < taps; t += blockDim.x) {
    xs.tap[t] = make_tap(x1, bin_w, t, samples, (float)(width - 1));
  }
  __syncthreads();
  const int n_cols =
      build_footprint(xs, out_size, samples, 1.0f, tap_span(xs.tap, taps));

  float* dst = static_cast<float*>(const_cast<void*>(pick(acc.ptr, l))) +
               (size_t)bidx[r] * height * width * channels;
  scatter_roi_any<T, V>(
      grad + (size_t)r * out_size * out_size * channels, dst, width,
      channels, out_size, out_size, ys, n_rows, xs, n_cols);
}

template <typename T, int V>
cudaError_t launch_bwd(const Levels& lv, const float* rois, const int* lvl,
                       const int* bidx, const T* grad, int num_rois,
                       int channels, int out_size, int samples,
                       cudaStream_t st) {
  int height = 1;
  int width = 1;
  for (int i = 0; i < kMaxLevels; ++i) {
    height = lv.h[i] > height ? lv.h[i] : height;
    width = lv.w[i] > width ? lv.w[i] : width;
  }
  const BwdShape shape =
      bwd_shape(channels, V, out_size, out_size, samples, height, width,
                kPasses);
  const cudaError_t err =
      allow_smem(roi_align_ml_bwd_kernel<T, V>, shape.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(num_rois, shape.splits);
  roi_align_ml_bwd_kernel<T, V><<<grid, kMaxThreads, shape.smem, st>>>(
      lv, rois, lvl, bidx, grad, channels, out_size, samples);
  return cudaGetLastError();
}

// The f32 accumulators rounded once into the bf16 gradient, two values a
// thread.
__global__ void cast_f32_bf16_kernel(const float* __restrict__ src,
                                     __nv_bfloat16* __restrict__ dst,
                                     size_t pairs) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < pairs;
       i += (size_t)gridDim.x * blockDim.x) {
    const float2 v = reinterpret_cast<const float2*>(src)[i];
    reinterpret_cast<__nv_bfloat162*>(dst)[i] = __floats2bfloat162_rn(v.x, v.y);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; out in the features' dtype. vec8 (8
// channels a thread) needs C % 8 == 0 and every level and out 16-byte
// aligned; otherwise 2 channels a thread. Returns the cudaError_t of the
// launch.
extern "C" int iif_roi_align_ml_fwd(
    const void* f0, const void* f1, const void* f2, const void* f3, int h0,
    int w0, int h1, int w1, int h2, int w2, int h3, int w3, float s0, float s1,
    float s2, float s3, const float* rois, const int* lvl, const int* bidx,
    void* out, int num_rois, int channels, int out_size, int samples,
    int dtype, int vec8, void* stream) {
  if (num_rois == 0) return (int)cudaSuccess;
  if (out_size * samples > kMaxTaps || samples < 1 || out_size < 1 ||
      channels < 2 || (channels & 1) || dtype < 0 || dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv;
  const void* ptrs[kMaxLevels] = {f0, f1, f2, f3};
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  const float ss[kMaxLevels] = {s0, s1, s2, s3};
  bool vec_ok = (channels & 7) == 0 && aligned16(out);
  for (int i = 0; i < kMaxLevels; ++i) {
    lv.ptr[i] = ptrs[i];
    lv.h[i] = hs[i];
    lv.w[i] = ws[i];
    lv.stride[i] = ss[i];
    vec_ok = vec_ok && aligned16(ptrs[i]);
  }
  if (vec8 && !vec_ok) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    float* o = static_cast<float*>(out);
    return (int)(vec8 ? launch_fwd<float, 8>(lv, rois, lvl, bidx, o,
                                             num_rois, channels, out_size,
                                             samples, st)
                      : launch_fwd<float, 2>(lv, rois, lvl, bidx, o,
                                             num_rois, channels, out_size,
                                             samples, st));
  }
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  return (int)(vec8 ? launch_fwd<__nv_bfloat16, 8>(lv, rois, lvl, bidx, o,
                                                   num_rois, channels,
                                                   out_size, samples, st)
                    : launch_fwd<__nv_bfloat16, 2>(lv, rois, lvl, bidx, o,
                                                   num_rois, channels,
                                                   out_size, samples, st));
}

// K2. acc: one f32 buffer holding the four levels' accumulators back to
// back, each (B, H_l, W_l, C), levels starting at element offsets o0..o3;
// it is zeroed here. grad: (R, out, out, C) in the feature type. For
// bfloat16 the result is cast into out (same layout as acc); for float32
// acc is the result and out is unused. vec8 (8 channels a thread, float4
// atomics) needs C % 8 == 0 and acc, every level's accumulator and grad
// 16-byte aligned; otherwise 2 channels a thread (float2 atomics). Returns
// the first cudaError_t.
extern "C" int iif_roi_align_ml_bwd(
    void* acc, void* out, long long total, long long o0, long long o1,
    long long o2, long long o3, int h0, int w0, int h1, int w1, int h2,
    int w2, int h3, int w3, float s0, float s1, float s2, float s3,
    const float* rois, const int* lvl, const int* bidx, const void* grad,
    int num_rois, int channels, int out_size, int samples, int dtype,
    int vec8, void* stream) {
  if (out_size * samples > kMaxTaps || samples < 1 || out_size < 1 ||
      channels < 2 || (channels & 1) || (total & 1) || dtype < 0 ||
      dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* base = static_cast<float*>(acc);
  Levels lv;
  const long long offs[kMaxLevels] = {o0, o1, o2, o3};
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  const float ss[kMaxLevels] = {s0, s1, s2, s3};
  bool vec_ok = (channels & 7) == 0 && aligned16(grad);
  for (int i = 0; i < kMaxLevels; ++i) {
    lv.ptr[i] = base + offs[i];
    lv.h[i] = hs[i];
    lv.w[i] = ws[i];
    lv.stride[i] = ss[i];
    vec_ok = vec_ok && aligned16(lv.ptr[i]);
  }
  if (vec8 && !vec_ok) return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaMemsetAsync(base, 0, (size_t)total * sizeof(float),
                                    st);
  if (err != cudaSuccess) return (int)err;
  if (num_rois > 0) {
    if (dtype == 0) {
      const float* g = static_cast<const float*>(grad);
      err = vec8 ? launch_bwd<float, 8>(lv, rois, lvl, bidx, g, num_rois,
                                        channels, out_size, samples, st)
                 : launch_bwd<float, 2>(lv, rois, lvl, bidx, g, num_rois,
                                        channels, out_size, samples, st);
    } else {
      const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(grad);
      err = vec8 ? launch_bwd<__nv_bfloat16, 8>(lv, rois, lvl, bidx, g,
                                                num_rois, channels, out_size,
                                                samples, st)
                 : launch_bwd<__nv_bfloat16, 2>(lv, rois, lvl, bidx, g,
                                                num_rois, channels, out_size,
                                                samples, st);
    }
    if (err != cudaSuccess) return (int)err;
  }
  if (dtype == 1) {
    const size_t pairs = (size_t)total / 2;
    const int threads = 256;
    size_t blocks = (pairs + threads - 1) / threads;
    if (blocks > 132 * 16) blocks = 132 * 16;
    if (blocks == 0) blocks = 1;
    cast_f32_bf16_kernel<<<(unsigned)blocks, threads, 0, st>>>(
        base, static_cast<__nv_bfloat16*>(out), pairs);
    err = cudaGetLastError();
  }
  return (int)err;
}
