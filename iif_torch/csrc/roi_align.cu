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
// Layout: the map is a contiguous (B, H, W, C) tensor, so one bilinear
// corner is a contiguous row of C values. A block owns one (RoI, bin row);
// its threads split C two channels at a time, so each corner read (K3) or
// add (K4) is one coalesced row. The row's sample geometry is computed
// once per block into shared memory. Sums run in f32.
//
// Bound: HBM bytes. At the C4 shapes the f32 output of K3 (and the f32 g
// that K4 reads) is far larger than the map, so the least time is that of
// the output write (K3) or the g read (K4). K3 does not reach it: f32
// maps, twice the bytes, run faster than bf16 ones, so the work per
// channel pair (16 corner loads, the bf16 unpacking, the weights) sets its
// pace; more channels a thread is the next step (see PERF.md). K4's pace
// is set by its atomics: a 14x14 RoI of 2x2 samples has 784 samples of 4
// corners, while a 32 px RoI at stride 16 covers about 3x3 cells. So K4
// merges before it adds: the weight of a map row is summed over the
// block's y samples once (into shared memory), and each thread sums its
// consecutive x samples that land on one cell in registers, then adds
// (row weight x cell sum) with one float2 atomic per touched (row, cell).
// The weights factor as wy * wx, so the merged sums are the same function
// in another f32 order.
//
// The multi-level kernels' tested source (roi_align_ml.cu) stays as it
// is; the tap geometry below is the same. This file is built with
// -fmad=false and keeps the float op order of the plain version: a
// contracted multiply-add in a sample position can move floor() onto the
// neighbouring cell, and K4 reads exactly the taps that K3 read.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 64;  // output side * sampling ratio

template <typename T>
struct Pair;

template <>
struct Pair<float> {
  static __device__ __forceinline__ float2 load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};

template <>
struct Pair<__nv_bfloat16> {
  static __device__ __forceinline__ float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

// One sample axis: clamp into [0, n-1], floor, high corner clamped.
struct Tap {
  int lo;
  int hi;
  float frac;
};

__device__ __forceinline__ Tap make_tap(float start, float bin, int t, int s,
                                        float last) {
  const float pos = ((float)t + 0.5f) / (float)s;
  float v = start + bin * pos;
  v = fminf(fmaxf(v, 0.0f), last);
  const float lo = floorf(v);
  const float hi = fminf(lo + 1.0f, last);
  Tap tap;
  tap.lo = (int)lo;
  tap.hi = (int)hi;
  tap.frac = v - lo;
  return tap;
}

template <typename T>
__global__ void roi_align_fwd_kernel(const T* __restrict__ feat, int batch,
                                     int height, int width, int channels,
                                     const float* __restrict__ rois,
                                     float* __restrict__ out, int out_h,
                                     int out_w, int samples,
                                     float spatial_scale, int aligned) {
  __shared__ Tap ytap[kMaxTaps];
  __shared__ Tap xtap[kMaxTaps];

  const int r = blockIdx.x;
  const int ph = blockIdx.y;
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
  const int taps_x = out_w * samples;

  for (int t = threadIdx.x; t < taps_x; t += blockDim.x) {
    xtap[t] = make_tap(x1, bin_w, t, samples, (float)(width - 1));
  }
  for (int t = threadIdx.x; t < samples; t += blockDim.x) {
    ytap[t] = make_tap(y1, bin_h, ph * samples + t, samples,
                       (float)(height - 1));
  }
  __syncthreads();

  const T* map = feat + (size_t)b * height * width * channels;
  float* dst = out + ((size_t)r * out_h + ph) * out_w * channels;
  const float count = (float)(samples * samples);

  for (int c = 2 * threadIdx.x; c < channels; c += 2 * blockDim.x) {
    for (int pw = 0; pw < out_w; ++pw) {
      float acc0 = 0.0f;
      float acc1 = 0.0f;
      for (int iy = 0; iy < samples; ++iy) {
        const Tap ty = ytap[iy];
        const float wy1 = ty.frac;
        const float wy0 = 1.0f - wy1;
        const T* row0 = map + (size_t)ty.lo * width * channels + c;
        const T* row1 = map + (size_t)ty.hi * width * channels + c;
        for (int ix = 0; ix < samples; ++ix) {
          const Tap tx = xtap[pw * samples + ix];
          const float wx1 = tx.frac;
          const float wx0 = 1.0f - wx1;
          const float2 v00 = Pair<T>::load(row0 + (size_t)tx.lo * channels);
          const float2 v01 = Pair<T>::load(row0 + (size_t)tx.hi * channels);
          const float2 v10 = Pair<T>::load(row1 + (size_t)tx.lo * channels);
          const float2 v11 = Pair<T>::load(row1 + (size_t)tx.hi * channels);
          acc0 += v00.x * wy0 * wx0 + v01.x * wy0 * wx1 + v10.x * wy1 * wx0 +
                  v11.x * wy1 * wx1;
          acc1 += v00.y * wy0 * wx0 + v01.y * wy0 * wx1 + v10.y * wy1 * wx0 +
                  v11.y * wy1 * wx1;
        }
      }
      *reinterpret_cast<float2*>(dst + (size_t)pw * channels + c) =
          make_float2(acc0 / count, acc1 / count);
    }
  }
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

// K4. Same grid and sample geometry as K3. Sums in an order that changes
// from run to run (atomics from overlapping RoIs and bins).
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

int block_threads(int channels) {
  int threads = ((channels / 2 + 31) / 32) * 32;
  return threads > 256 ? 256 : threads;
}

}  // namespace

// feat: (B, H, W, C) in dtype (0 = float32, 1 = bfloat16); rois: (R, 5)
// float32; out: (R, out_h, out_w, C) float32. Returns the cudaError_t of
// the launch.
extern "C" int iif_roi_align_fwd(const void* feat, int batch, int height,
                                 int width, int channels, const float* rois,
                                 float* out, int num_rois, int out_h,
                                 int out_w, int samples, float spatial_scale,
                                 int aligned, int dtype, void* stream) {
  if (num_rois == 0) return (int)cudaSuccess;
  if (out_h * samples > kMaxTaps || out_w * samples > kMaxTaps ||
      samples < 1 || (channels & 1) || batch < 1 || dtype < 0 || dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = block_threads(channels);
  const dim3 grid(num_rois, out_h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    roi_align_fwd_kernel<float><<<grid, threads, 0, st>>>(
        static_cast<const float*>(feat), batch, height, width, channels, rois,
        out, out_h, out_w, samples, spatial_scale, aligned);
  } else {
    roi_align_fwd_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(feat), batch, height, width,
        channels, rois, out, out_h, out_w, samples, spatial_scale, aligned);
  }
  return (int)cudaGetLastError();
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
