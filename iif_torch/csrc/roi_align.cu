// Single-level RoIAlign, forward (K3) and backward (K4), for Hopper
// (sm_90a).
//
// K3 replaces iif_tpu/ops/pallas/roi_align_kernel.py::roi_align_pallas (the
// Pallas TPU kernel _make_kernel / _pallas_call). It computes what
// iif_tpu/ops/roi_align.py::roi_align computes, none of the TPU machinery:
// no 32x40 DMA window (which clamps the taps of RoIs wider than it), no
// 8-aligned x origin, no one-hot matmuls. Box = roi * spatial_scale -
// offset (0.5 when aligned; unaligned boxes are at least one cell a side),
// out_h x out_w bins of s x s samples, each sample clamped into the map and
// read bilinearly with the high corner clamped, the mean over samples.
// The output is float32 for float32 and bfloat16 features alike, as in JAX.
//
// K3's bound is HBM bytes: at the C4 shapes its f32 output (0.8 GB for
// 1000 RoIs of 14x14x1024) dwarfs the map (8.6 MB bf16, held in L2), so
// the least time is the output's write, 0.24 ms an image. Writing that
// output at the HBM rate leaves a budget of about 40 thread instructions
// for every f32 element it writes; a first version of this kernel (two
// channels a thread, 16 four-byte corner loads, taps reloaded and 1 - frac
// recomputed at every sample, 12 float operations a sample) spent about
// 100, and ran faster on f32 maps than on bf16 ones. The design
// (roi_align_common.cuh):
//   1. Eight channels a thread (vec8): a corner is one 16-byte load of a
//      bf16 map or two of an f32 one, a bin's output two float4 stores.
//      Any other even C, or a map or output not 16-byte aligned, takes
//      the same kernel at two channels a thread (pair); the wrapper
//      chooses.
//   2. One block a RoI: its x and y taps (cells, 1 - frac, frac) are
//      computed once into shared memory. At C=1024 a block is 2 x 128
//      threads; each set of 128 spans C and takes every other bin row.
//   3. s = 2 unrolled, the last x tap's blended columns held in registers.
//      Any other s takes K1's loop (bin_row_plain) at run time.
//   4. For s = 2, the separable blend as explicit FMAs: 6 float operations
//      a sample and channel. It sums in another order than the plain
//      version: the two differ in the last bits (9.5e-7 at the C4 shapes).
//      K1's loop, in the plain version's order, took 1.13-1.44x as long
//      there (PERF.md).
//   5. The f32 output written with streaming stores (__stcs, evict-first):
//      it passes through L2 without pushing the map out; plain stores
//      took 7-13% longer (PERF.md).
//
// K4 replaces the backward of roi_align_pallas_grad (_rapg_bwd,
// _pallas_bwd_call / _make_bwd_kernel): the gradient with respect to the
// map, none for the RoIs. Off the TPU that VJP differentiates the XLA
// gather of iif_tpu/ops/roi_align.py, i.e. a scatter-add, and K4 computes
// exactly that: every sample adds g / s^2 times its four bilinear weights
// into the four clamped corners K3 read, at the RoI's batch index, into a
// zeroed f32 (B, H, W, C) accumulator. None of the TPU machinery: no
// 32x40 window (nor its clamp of wider RoIs' taps), no 8-aligned origin,
// no one-hot matmuls, no read-add-write DMA of a window.
//
// K4's bound is HBM bytes: the f32 g it reads (1.64 GB at the C4 training
// shapes, R=2048, 14x14, C=1024), the touched accumulator rows and the
// map's gradient, 0.54 ms. A first version gave each (RoI, bin row) a
// block, merged the y weights of its samples per map row and the x
// samples of one cell in registers, and added one float2 a touched (row,
// cell): about 600 M float2 reductions, 4.8 GB, at those shapes. The
// TPU kernel computes each RoI's window at once as dF = row_w^T g col_w
// and read-adds-writes it, which a grid that runs in order allows. Here
// (roi_align_common.cuh):
//   1. One block a (RoI, split): the RoI's distinct map rows and columns,
//      each with its bins' summed weights (1/s^2 folded into the rows),
//      built once a block in shared memory from K3's taps.
//   2. One vector atomic per touched (row, column) of a RoI and 4
//      channels: a work item (a row slot, 8 channels) walks the bins,
//      sums g over the row's bins once a bin (h) and spreads h over the
//      bin's columns into a window of 4 columns of pending sums in
//      registers, adding a column when the window moves past it. At
//      those shapes about 190 M float4 reductions, 3.0 GB (chip_smoke.py
//      estimates both designs' from the RoIs); a pile RoI (2-8 px on one
//      16 px cell) adds at most 3 x 3 x 256 float4s, where each of its 14
//      bin rows added its own.
//   3. Eight channels a thread (vec8) when C % 8 == 0 and g and the
//      accumulator start on 16 bytes: for a RoI of more than 8 rows two
//      runs of 4 channels, a chunk's lanes apart, so that the float4s that
//      lanes issue together cover whole sectors; for a smaller one 8
//      consecutive channels (kSmallRows). Otherwise the same kernel at two
//      channels and float2 atomics (pair). The wrapper chooses
//      (kernel_path).
//   4. A RoI's items spread over splits = ceil(items of a RoI out_h * s + 1
//      rows high / (2 x 256)) blocks (8 at the C4 shapes, kPasses), so
//      that a whole-map RoI (about 50 x 84 cells) is not one SM's tail; a
//      block with no item returns first, from the RoI's first and last
//      taps (end_span).
// What sets its pace is L2, not HBM: the card's reductions run at 1.45
// (f32) to 1.87 (float4) TB/s of payload (iif_torch/tools/
// reduction_rate.cu on an H100 80GB HBM3 at 700 W), so K4's 3.0 GB of
// reductions and the g it reads through L2 take most of its time
// (PERF.md). Fewer bytes would need sums across RoIs before the atomics.
// What it does not use: tensor cores (a contraction depth of out = 14, and
// f32 held within 1e-5 of the largest gradient, which TF32 would not
// meet); TMA (g's rows are contiguous and read as 16-byte loads already).
// RoIs that overlap still add with atomics, in an order that changes from
// run to run: a deterministic two-pass (per-RoI windows, then a segmented
// sum) would write the windows' 3.0 GB of f32 sums and read them again.
//
// This file is built with -fmad=false: K3 and K4 take their taps from the
// one make_tap (roi_align_common.cuh), so K4 scatters into exactly the
// corners K3 read.
#include "roi_align_common.cuh"

namespace {

// K3. One block a RoI; blockDim.x = lanes x rows (block_shape).
template <typename T, int V, int S>
__global__ void __launch_bounds__(kMaxThreads)
    roi_align_fwd_kernel(const T* __restrict__ feat, int batch, int height,
                         int width, int channels,
                         const float* __restrict__ rois,
                         float* __restrict__ out, int out_h, int out_w,
                         int samples, float spatial_scale, int aligned,
                         int lanes) {
  __shared__ Weights xw[kMaxTaps];
  __shared__ Weights yw[kMaxTaps];

  const int r = blockIdx.x;
  const float* roi = rois + (size_t)r * 5;
  // truncated as astype(int32), clamped into the batch as JAX's gather
  int b = (int)roi[0];
  b = b < 0 ? 0 : (b >= batch ? batch - 1 : b);
  const float offset = aligned ? 0.5f : 0.0f;
  const float x1 = roi[1] * spatial_scale - offset;
  const float y1 = roi[2] * spatial_scale - offset;
  const float x2 = roi[3] * spatial_scale - offset;
  const float y2 = roi[4] * spatial_scale - offset;
  float roi_w = x2 - x1;
  float roi_h = y2 - y1;
  if (!aligned) {
    roi_w = fmaxf(roi_w, 1.0f);
    roi_h = fmaxf(roi_h, 1.0f);
  }
  const float bin_w = roi_w / (float)out_w;
  const float bin_h = roi_h / (float)out_h;

  for (int t = threadIdx.x; t < out_w * samples; t += blockDim.x) {
    xw[t] = weights_of(make_tap(x1, bin_w, t, samples, (float)(width - 1)));
  }
  for (int t = threadIdx.x; t < out_h * samples; t += blockDim.x) {
    yw[t] = weights_of(make_tap(y1, bin_h, t, samples, (float)(height - 1)));
  }
  __syncthreads();

  forward_roi<T, float, V, S, true>(
      feat + (size_t)b * height * width * channels, (size_t)width * channels,
      channels, xw, yw, out_h, out_w, samples, lanes,
      out + (size_t)r * out_h * out_w * channels);
}

template <typename T, int V>
cudaError_t launch_fwd(const T* feat, int batch, int height, int width,
                       int channels, const float* rois, float* out,
                       int num_rois, int out_h, int out_w, int samples,
                       float spatial_scale, int aligned, cudaStream_t st) {
  const BlockShape shape = block_shape(channels, V, out_h);
  if (samples == 2) {
    roi_align_fwd_kernel<T, V, 2><<<num_rois, shape.threads, 0, st>>>(
        feat, batch, height, width, channels, rois, out, out_h, out_w,
        samples, spatial_scale, aligned, shape.lanes);
  } else {
    roi_align_fwd_kernel<T, V, 0><<<num_rois, shape.threads, 0, st>>>(
        feat, batch, height, width, channels, rois, out, out_h, out_w,
        samples, spatial_scale, aligned, shape.lanes);
  }
  return cudaGetLastError();
}

// K4's items a thread for a RoI of out_h * s + 1 rows (bwd_shape): 2 gives
// a RoI half the blocks of 1. On a C4 training step's RoIs (1.3-2.8 cells
// a side, most of their blocks idle) one item took 3% longer; on the
// kernel phase's, with whole-map RoIs, 2 took 8% longer (PERF.md).
constexpr int kPasses = 2;

// K4. One block a (RoI, split): both footprints built once a block, the
// block's share of the RoI's (row slot, channels) items scattered with one
// vector atomic per touched (row, column). Sums in an order that changes
// from run to run (atomics from overlapping RoIs).
template <int V>
__global__ void __launch_bounds__(kMaxThreads)
    roi_align_bwd_kernel(float* __restrict__ acc, int batch, int height,
                         int width, int channels,
                         const float* __restrict__ rois,
                         const float* __restrict__ grad, int out_h,
                         int out_w, int samples, float spatial_scale,
                         int aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* p = smem;
  const Footprint ys = carve_footprint(p, out_h, samples, height);
  const Footprint xs = carve_footprint(p, out_w, samples, width);

  const int r = blockIdx.x;
  const float* roi = rois + (size_t)r * 5;
  int b = (int)roi[0];
  b = b < 0 ? 0 : (b >= batch ? batch - 1 : b);
  const float offset = aligned ? 0.5f : 0.0f;
  const float x1 = roi[1] * spatial_scale - offset;
  const float y1 = roi[2] * spatial_scale - offset;
  const float x2 = roi[3] * spatial_scale - offset;
  const float y2 = roi[4] * spatial_scale - offset;
  float roi_w = x2 - x1;
  float roi_h = y2 - y1;
  if (!aligned) {
    roi_w = fmaxf(roi_w, 1.0f);
    roi_h = fmaxf(roi_h, 1.0f);
  }
  const float bin_w = roi_w / (float)out_w;
  const float bin_h = roi_h / (float)out_h;
  const int taps = out_h * samples;
  const int rows_max =
      slot_bound(end_span(y1, bin_h, taps, samples, height), taps);
  if (!has_items(rows_max, channels, V)) return;

  for (int t = threadIdx.x; t < taps; t += blockDim.x) {
    ys.tap[t] = make_tap(y1, bin_h, t, samples, (float)(height - 1));
  }
  __syncthreads();
  const Span rows = tap_span(ys.tap, taps);
  // the mean over the s x s samples folded into the row weights
  const int n_rows = build_footprint(
      ys, out_h, samples, 1.0f / (float)(samples * samples), rows);
  if (!has_items(n_rows, channels, V)) return;
  for (int t = threadIdx.x; t < out_w * samples; t += blockDim.x) {
    xs.tap[t] = make_tap(x1, bin_w, t, samples, (float)(width - 1));
  }
  __syncthreads();
  const int n_cols = build_footprint(xs, out_w, samples, 1.0f,
                                     tap_span(xs.tap, out_w * samples));

  scatter_roi_any<float, V>(
      grad + (size_t)r * out_h * out_w * channels,
      acc + (size_t)b * height * width * channels, width, channels, out_h,
      out_w, ys, n_rows, xs, n_cols);
}

template <int V>
cudaError_t launch_bwd(float* acc, int batch, int height, int width,
                       int channels, const float* rois, const float* grad,
                       int num_rois, int out_h, int out_w, int samples,
                       float spatial_scale, int aligned, cudaStream_t st) {
  const BwdShape shape =
      bwd_shape(channels, V, out_h, out_w, samples, height, width, kPasses);
  const cudaError_t err = allow_smem(roi_align_bwd_kernel<V>, shape.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(num_rois, shape.splits);
  roi_align_bwd_kernel<V><<<grid, kMaxThreads, shape.smem, st>>>(
      acc, batch, height, width, channels, rois, grad, out_h, out_w, samples,
      spatial_scale, aligned);
  return cudaGetLastError();
}

}  // namespace

// feat: (B, H, W, C) in dtype (0 = float32, 1 = bfloat16); rois: (R, 5)
// float32; out: (R, out_h, out_w, C) float32. vec8 (8 channels a thread)
// needs C % 8 == 0 and feat and out 16-byte aligned; otherwise 2 channels
// a thread. Returns the cudaError_t of the launch.
extern "C" int iif_roi_align_fwd(const void* feat, int batch, int height,
                                 int width, int channels, const float* rois,
                                 float* out, int num_rois, int out_h,
                                 int out_w, int samples, float spatial_scale,
                                 int aligned, int dtype, int vec8,
                                 void* stream) {
  if (num_rois == 0) return (int)cudaSuccess;
  if (out_h * samples > kMaxTaps || out_w * samples > kMaxTaps ||
      samples < 1 || out_h < 1 || out_w < 1 || channels < 2 ||
      (channels & 1) || batch < 1 || dtype < 0 || dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (vec8 && ((channels & 7) || !aligned16(feat) || !aligned16(out))) {
    return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const float* f = static_cast<const float*>(feat);
    return (int)(vec8 ? launch_fwd<float, 8>(
                            f, batch, height, width, channels, rois, out,
                            num_rois, out_h, out_w, samples, spatial_scale,
                            aligned, st)
                      : launch_fwd<float, 2>(
                            f, batch, height, width, channels, rois, out,
                            num_rois, out_h, out_w, samples, spatial_scale,
                            aligned, st));
  }
  const __nv_bfloat16* f = static_cast<const __nv_bfloat16*>(feat);
  return (int)(vec8 ? launch_fwd<__nv_bfloat16, 8>(
                          f, batch, height, width, channels, rois, out,
                          num_rois, out_h, out_w, samples, spatial_scale,
                          aligned, st)
                    : launch_fwd<__nv_bfloat16, 2>(
                          f, batch, height, width, channels, rois, out,
                          num_rois, out_h, out_w, samples, spatial_scale,
                          aligned, st));
}

// K4. acc: (B, H, W, C) float32, zeroed here, receives the map's gradient
// (the caller casts it to the map's dtype); rois: (R, 5) float32; grad:
// (R, out_h, out_w, C) float32, the gradient of K3's output. vec8 (8
// channels a thread, float4 atomics) needs C % 8 == 0 and acc and grad
// 16-byte aligned; otherwise 2 channels a thread (float2 atomics).
// Returns the first cudaError_t.
extern "C" int iif_roi_align_bwd(float* acc, int batch, int height,
                                 int width, int channels, const float* rois,
                                 const float* grad, int num_rois, int out_h,
                                 int out_w, int samples, float spatial_scale,
                                 int aligned, int vec8, void* stream) {
  if (out_h * samples > kMaxTaps || out_w * samples > kMaxTaps ||
      samples < 1 || out_h < 1 || out_w < 1 || channels < 2 ||
      (channels & 1) || batch < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (vec8 && ((channels & 7) || !aligned16(acc) || !aligned16(grad))) {
    return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      acc, 0, (size_t)batch * height * width * channels * sizeof(float), st);
  if (err != cudaSuccess || num_rois == 0) return (int)err;
  return (int)(vec8 ? launch_bwd<8>(acc, batch, height, width, channels,
                                    rois, grad, num_rois, out_h, out_w,
                                    samples, spatial_scale, aligned, st)
                    : launch_bwd<2>(acc, batch, height, width, channels,
                                    rois, grad, num_rois, out_h, out_w,
                                    samples, spatial_scale, aligned, st));
}
