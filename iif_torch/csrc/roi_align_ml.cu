// Multi-level aligned RoIAlign, forward (K1) and backward (K2), for Hopper
// (sm_90a).
//
// K1 replaces iif_tpu/ops/pallas/roi_align_kernel.py::roi_align_pallas_ml
// (the Pallas TPU kernel _make_ml_kernel / _pallas_ml_call). It computes
// what SingleRoIExtractor._flat_gather computes
// (iif_tpu/detection/roi_extractor.py:97-166), none of the TPU machinery:
// no DMA windows, no edge padding, no one-hot matmuls, no misfit cap.
//
// K2 replaces the custom VJP's backward (_ml_bwd, _pallas_ml_bwd_call,
// _make_ml_bwd_kernel): the gradient of K1 with respect to the four
// levels, none for the RoIs. Each bin's incoming gradient, divided by
// s*s, is spread over its samples' four bilinear corners with exactly
// K1's sample positions, clamps and high-corner snap. On the card no RoI
// misfits a window, so every RoI takes the kernel.
//
// Layout: every FPN level is a contiguous (B, H_l, W_l, C) tensor, so one
// bilinear corner is a contiguous row of C values. A block owns one
// (RoI, bin row); its threads split C two channels at a time, so each
// corner read is one coalesced row. Sums run in f32 and the result is
// rounded once into the feature type.
//
// Bound: HBM bytes (the unique feature bytes read plus the output
// written); the arithmetic is a few FLOPs per byte. Neighbouring samples
// share cells, so most corner reads after the first hit L1/L2.
//
// The per-sample geometry keeps the float op order of _flat_gather and
// this file is built with -fmad=false: a contracted multiply-add there can
// move floor() onto the neighbouring cell. The FPN level of each RoI comes
// from the caller (the same map_roi_levels as the plain path), never from
// a device log2f near a level boundary.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxTaps = 64;  // output_size * sampling_ratio per axis

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

template <typename T>
struct Pair;

template <>
struct Pair<float> {
  static __device__ __forceinline__ float2 load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <>
struct Pair<__nv_bfloat16> {
  static __device__ __forceinline__ float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float a,
                                               float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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
__global__ void roi_align_ml_fwd_kernel(Levels lv,
                                        const float* __restrict__ rois,
                                        const int* __restrict__ lvl,
                                        const int* __restrict__ bidx,
                                        T* __restrict__ out, int channels,
                                        int out_size, int samples) {
  __shared__ Tap ytap[kMaxTaps];
  __shared__ Tap xtap[kMaxTaps];

  const int r = blockIdx.x;
  const int ph = blockIdx.y;
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
  const int taps_x = out_size * samples;

  for (int t = threadIdx.x; t < taps_x; t += blockDim.x) {
    xtap[t] = make_tap(x1, bin_w, t, samples, (float)(width - 1));
  }
  for (int t = threadIdx.x; t < samples; t += blockDim.x) {
    ytap[t] = make_tap(y1, bin_h, ph * samples + t, samples,
                       (float)(height - 1));
  }
  __syncthreads();

  const T* feat = static_cast<const T*>(pick(lv.ptr, l)) +
                  (size_t)bidx[r] * height * width * channels;
  T* dst = out + ((size_t)r * out_size + ph) * out_size * channels;
  const float count = (float)(samples * samples);

  for (int c = 2 * threadIdx.x; c < channels; c += 2 * blockDim.x) {
    for (int pw = 0; pw < out_size; ++pw) {
      float acc0 = 0.0f;
      float acc1 = 0.0f;
      for (int iy = 0; iy < samples; ++iy) {
        const Tap ty = ytap[iy];
        const float wy1 = ty.frac;
        const float wy0 = 1.0f - wy1;
        const T* row0 = feat + (size_t)ty.lo * width * channels + c;
        const T* row1 = feat + (size_t)ty.hi * width * channels + c;
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
      Pair<T>::store(dst + (size_t)pw * channels + c, acc0 / count,
                     acc1 / count);
    }
  }
}

// K2. Same grid and sample geometry as K1; each corner's share goes into
// an f32 accumulator shaped like its level with atomicAdd, so overlapping
// RoIs (and neighbouring samples of one RoI) add up in an order that
// changes from run to run. Bound: the f32 read-modify-write of the
// touched accumulator rows and the read of g; the atomics resolve in L2.
template <typename T>
__global__ void roi_align_ml_bwd_kernel(Levels acc,
                                        const float* __restrict__ rois,
                                        const int* __restrict__ lvl,
                                        const int* __restrict__ bidx,
                                        const T* __restrict__ grad,
                                        int channels, int out_size,
                                        int samples) {
  __shared__ Tap ytap[kMaxTaps];
  __shared__ Tap xtap[kMaxTaps];

  const int r = blockIdx.x;
  const int ph = blockIdx.y;
  const int l = lvl[r];
  const int height = pick(acc.h, l);
  const int width = pick(acc.w, l);
  const float scale = 1.0f / pick(acc.stride, l);
  const float* roi = rois + (size_t)r * 5;
  const float x1 = roi[1] * scale - 0.5f;
  const float y1 = roi[2] * scale - 0.5f;
  const float x2 = roi[3] * scale - 0.5f;
  const float y2 = roi[4] * scale - 0.5f;
  const float bin_w = (x2 - x1) / (float)out_size;
  const float bin_h = (y2 - y1) / (float)out_size;
  const int taps_x = out_size * samples;

  for (int t = threadIdx.x; t < taps_x; t += blockDim.x) {
    xtap[t] = make_tap(x1, bin_w, t, samples, (float)(width - 1));
  }
  for (int t = threadIdx.x; t < samples; t += blockDim.x) {
    ytap[t] = make_tap(y1, bin_h, ph * samples + t, samples,
                       (float)(height - 1));
  }
  __syncthreads();

  float* dst = static_cast<float*>(const_cast<void*>(pick(acc.ptr, l))) +
               (size_t)bidx[r] * height * width * channels;
  const T* src = grad + ((size_t)r * out_size + ph) * out_size * channels;
  const float count = (float)(samples * samples);

  for (int c = 2 * threadIdx.x; c < channels; c += 2 * blockDim.x) {
    for (int pw = 0; pw < out_size; ++pw) {
      const float2 gv = Pair<T>::load(src + (size_t)pw * channels + c);
      const float g0 = gv.x / count;
      const float g1 = gv.y / count;
      for (int iy = 0; iy < samples; ++iy) {
        const Tap ty = ytap[iy];
        const float wy1 = ty.frac;
        const float wy0 = 1.0f - wy1;
        float* row0 = dst + (size_t)ty.lo * width * channels + c;
        float* row1 = dst + (size_t)ty.hi * width * channels + c;
        for (int ix = 0; ix < samples; ++ix) {
          const Tap tx = xtap[pw * samples + ix];
          const float wx1 = tx.frac;
          const float wx0 = 1.0f - wx1;
          float* p00 = row0 + (size_t)tx.lo * channels;
          float* p01 = row0 + (size_t)tx.hi * channels;
          float* p10 = row1 + (size_t)tx.lo * channels;
          float* p11 = row1 + (size_t)tx.hi * channels;
          // (g * wx) * wy: the plain version's autograd order
          atomicAdd(p00, g0 * wx0 * wy0);
          atomicAdd(p00 + 1, g1 * wx0 * wy0);
          atomicAdd(p01, g0 * wx1 * wy0);
          atomicAdd(p01 + 1, g1 * wx1 * wy0);
          atomicAdd(p10, g0 * wx0 * wy1);
          atomicAdd(p10 + 1, g1 * wx0 * wy1);
          atomicAdd(p11, g0 * wx1 * wy1);
          atomicAdd(p11 + 1, g1 * wx1 * wy1);
        }
      }
    }
  }
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

int block_threads(int channels) {
  int threads = ((channels / 2 + 31) / 32) * 32;
  return threads > 256 ? 256 : threads;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int iif_roi_align_ml_fwd(
    const void* f0, const void* f1, const void* f2, const void* f3, int h0,
    int w0, int h1, int w1, int h2, int w2, int h3, int w3, float s0, float s1,
    float s2, float s3, const float* rois, const int* lvl, const int* bidx,
    void* out, int num_rois, int channels, int out_size, int samples,
    int dtype, void* stream) {
  if (num_rois == 0) return (int)cudaSuccess;
  if (out_size * samples > kMaxTaps || (channels & 1) || dtype < 0 ||
      dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv;
  const void* ptrs[kMaxLevels] = {f0, f1, f2, f3};
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  const float ss[kMaxLevels] = {s0, s1, s2, s3};
  for (int i = 0; i < kMaxLevels; ++i) {
    lv.ptr[i] = ptrs[i];
    lv.h[i] = hs[i];
    lv.w[i] = ws[i];
    lv.stride[i] = ss[i];
  }
  const int threads = block_threads(channels);
  const dim3 grid(num_rois, out_size);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    roi_align_ml_fwd_kernel<float><<<grid, threads, 0, st>>>(
        lv, rois, lvl, bidx, static_cast<float*>(out), channels, out_size,
        samples);
  } else {
    roi_align_ml_fwd_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        lv, rois, lvl, bidx, static_cast<__nv_bfloat16*>(out), channels,
        out_size, samples);
  }
  return (int)cudaGetLastError();
}

// K2. acc: one f32 buffer holding the four levels' accumulators back to
// back, each (B, H_l, W_l, C), levels starting at element offsets o0..o3;
// it is zeroed here. grad: (R, out, out, C) in the feature type. For
// bfloat16 the result is cast into out (same layout as acc); for float32
// acc is the result and out is unused. Returns the first cudaError_t.
extern "C" int iif_roi_align_ml_bwd(
    void* acc, void* out, long long total, long long o0, long long o1,
    long long o2, long long o3, int h0, int w0, int h1, int w1, int h2,
    int w2, int h3, int w3, float s0, float s1, float s2, float s3,
    const float* rois, const int* lvl, const int* bidx, const void* grad,
    int num_rois, int channels, int out_size, int samples, int dtype,
    void* stream) {
  if (out_size * samples > kMaxTaps || (channels & 1) || (total & 1) ||
      dtype < 0 || dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* base = static_cast<float*>(acc);
  cudaError_t err = cudaMemsetAsync(base, 0, (size_t)total * sizeof(float),
                                    st);
  if (err != cudaSuccess) return (int)err;
  Levels lv;
  const long long offs[kMaxLevels] = {o0, o1, o2, o3};
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  const float ss[kMaxLevels] = {s0, s1, s2, s3};
  for (int i = 0; i < kMaxLevels; ++i) {
    lv.ptr[i] = base + offs[i];
    lv.h[i] = hs[i];
    lv.w[i] = ws[i];
    lv.stride[i] = ss[i];
  }
  if (num_rois > 0) {
    const dim3 grid(num_rois, out_size);
    const int threads = block_threads(channels);
    if (dtype == 0) {
      roi_align_ml_bwd_kernel<float><<<grid, threads, 0, st>>>(
          lv, rois, lvl, bidx, static_cast<const float*>(grad), channels,
          out_size, samples);
    } else {
      roi_align_ml_bwd_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
          lv, rois, lvl, bidx, static_cast<const __nv_bfloat16*>(grad),
          channels, out_size, samples);
    }
    err = cudaGetLastError();
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
