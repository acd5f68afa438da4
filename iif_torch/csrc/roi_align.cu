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
// K4's layout: the map is a contiguous (B, H, W, C) tensor, so one bilinear
// corner is a contiguous row of C values. A block owns one (RoI, bin row);
// its threads split C two channels at a time, so each corner add is one
// coalesced row. The row's sample geometry is computed once per block into
// shared memory. Its bound is HBM bytes, the f32 g it reads; its pace is
// set by its atomics: a 14x14 RoI of 2x2 samples has 784 samples of 4
// corners, while a 32 px RoI at stride 16 covers about 3x3 cells. So K4
// merges before it adds: the weight of a map row is summed over the
// block's y samples once (into shared memory), and each thread sums its
// consecutive x samples that land on one cell in registers, then adds
// (row weight x cell sum) with one float2 atomic per touched (row, cell).
// The weights factor as wy * wx, so the merged sums are the same function
// in another f32 order.
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

// Two channels added into the accumulator at p (8-byte aligned): one
// float2 atomic, which sm_90 has for global memory.
__device__ __forceinline__ void add_pair(float* p, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
}

// The pending sums of one x cell flushed into every map row the block's
// y samples touch, each scaled by that row's summed weight.
__device__ __forceinline__ void flush_cell(float* map, const int* rows,
                                           const float* row_w, int num_rows,
                                           int width, int channels, int c,
                                           int cell, float2 v) {
  if (cell < 0 || (v.x == 0.0f && v.y == 0.0f)) return;
  for (int k = 0; k < num_rows; ++k) {
    const float w = row_w[k];
    if (w == 0.0f) continue;
    add_pair(map + ((size_t)rows[k] * width + cell) * channels + c, v.x * w,
             v.y * w);
  }
}

// K4. One block a (RoI, bin row), on K3's taps. Sums in an order that
// changes from run to run (atomics from overlapping RoIs and bins).
__global__ void roi_align_bwd_kernel(float* __restrict__ acc, int batch,
                                     int height, int width, int channels,
                                     const float* __restrict__ rois,
                                     const float* __restrict__ grad,
                                     int out_h, int out_w, int samples,
                                     float spatial_scale, int aligned) {
  __shared__ Tap xtap[kMaxTaps];
  __shared__ int rows[2 * kMaxTaps];
  __shared__ float row_w[2 * kMaxTaps];
  __shared__ int num_rows;

  const int r = blockIdx.x;
  const int ph = blockIdx.y;
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
  const int taps_x = out_w * samples;

  for (int t = threadIdx.x; t < taps_x; t += blockDim.x) {
    xtap[t] = make_tap(x1, bin_w, t, samples, (float)(width - 1));
  }
  if (threadIdx.x == 0) {
    // each distinct map row of this bin row's y samples, with the sum of
    // the y weights that land on it
    int n = 0;
    for (int iy = 0; iy < samples; ++iy) {
      const Tap ty = make_tap(y1, bin_h, ph * samples + iy, samples,
                              (float)(height - 1));
      const int row[2] = {ty.lo, ty.hi};
      const float w[2] = {1.0f - ty.frac, ty.frac};
      for (int k = 0; k < 2; ++k) {
        int j = 0;
        while (j < n && rows[j] != row[k]) ++j;
        if (j == n) {
          rows[n] = row[k];
          row_w[n] = 0.0f;
          ++n;
        }
        row_w[j] += w[k];
      }
    }
    num_rows = n;
  }
  __syncthreads();

  float* map = acc + (size_t)b * height * width * channels;
  const float* src = grad + ((size_t)r * out_h + ph) * out_w * channels;
  const float count = (float)(samples * samples);
  const int n_rows = num_rows;
  const float2 zero = make_float2(0.0f, 0.0f);

  for (int c = 2 * threadIdx.x; c < channels; c += 2 * blockDim.x) {
    // pending sums of the x cells `cell` (pa) and `cell + 1` (pb): the
    // taps advance along x, so consecutive samples mostly share them
    int cell = -2;
    float2 pa = zero;
    float2 pb = zero;
    for (int pw = 0; pw < out_w; ++pw) {
      const float2 gv =
          *reinterpret_cast<const float2*>(src + (size_t)pw * channels + c);
      const float g0 = gv.x / count;
      const float g1 = gv.y / count;
      for (int ix = 0; ix < samples; ++ix) {
        const Tap tx = xtap[pw * samples + ix];
        if (tx.lo != cell) {
          flush_cell(map, rows, row_w, n_rows, width, channels, c, cell, pa);
          if (tx.lo == cell + 1) {
            pa = pb;
          } else {
            flush_cell(map, rows, row_w, n_rows, width, channels, c,
                       cell + 1, pb);
            pa = zero;
          }
          pb = zero;
          cell = tx.lo;
        }
        const float wx1 = tx.frac;
        const float wx0 = 1.0f - wx1;
        pa.x += g0 * wx0;
        pa.y += g1 * wx0;
        if (tx.hi == tx.lo) {       // clamped at the map's last column
          pa.x += g0 * wx1;
          pa.y += g1 * wx1;
        } else {
          pb.x += g0 * wx1;
          pb.y += g1 * wx1;
        }
      }
    }
    flush_cell(map, rows, row_w, n_rows, width, channels, c, cell, pa);
    flush_cell(map, rows, row_w, n_rows, width, channels, c, cell + 1, pb);
  }
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
// (R, out_h, out_w, C) float32, the gradient of K3's output. Returns the
// first cudaError_t.
extern "C" int iif_roi_align_bwd(float* acc, int batch, int height,
                                 int width, int channels, const float* rois,
                                 const float* grad, int num_rois, int out_h,
                                 int out_w, int samples, float spatial_scale,
                                 int aligned, void* stream) {
  if (out_h * samples > kMaxTaps || out_w * samples > kMaxTaps ||
      samples < 1 || (channels & 1) || batch < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      acc, 0, (size_t)batch * height * width * channels * sizeof(float), st);
  if (err != cudaSuccess || num_rois == 0) return (int)err;
  const int threads = block_threads(channels);
  const dim3 grid(num_rois, out_h);
  roi_align_bwd_kernel<<<grid, threads, 0, st>>>(
      acc, batch, height, width, channels, rois, grad, out_h, out_w, samples,
      spatial_scale, aligned);
  return (int)cudaGetLastError();
}
