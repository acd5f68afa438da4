// RoIAlign pieces shared by roi_align.cu (K3, K4) and roi_align_ml.cu
// (K1, K2): the sample geometry and the forward kernels' sample loops.
//
// Both files are built with -fmad=false. make_tap keeps the float op order
// of the plain versions: a contracted multiply-add in a sample position
// can move floor() onto the neighbouring cell. Every backward reads the
// taps of its forward through this one make_tap.
//
// The forward loops are written for the H100's instruction issue, which
// sets the pace of a bilinear gather whose bytes mostly hit L1/L2:
//   - V consecutive channels a thread: V = 8 reads a corner with one
//     16-byte load (bf16) or two (f32) and writes 32 bytes (f32) or 16
//     (bf16) at once; V = 2 is the path for any other even C or a storage
//     offset that breaks 16-byte alignment (the wrapper chooses). Each
//     channel's sums run in the same order on both paths.
//   - One block a RoI: each tap's lo, hi, 1 - frac and frac are computed
//     once a block (Weights in shared memory), not once a channel group
//     and sample, and the block's threads take its bin rows in turn.
//   - s = 2 (both configs' sampling_ratio 0) at compile time, the sample
//     loops unrolled; any other s at run time.
//   - bin_row_plain sums in the plain version's order (12 float
//     operations a sample and channel; equal to it at s = 1 and 2, where
//     torch's mean adds the samples in the same order). K1 takes it:
//     its bf16 output is held within one bf16 ulp of the plain version's,
//     and a sum in another order moves near-zero outputs by more.
//   - bin_row_fused, for s known at compile time, blends separably with
//     explicit FMAs (-fmad=false does not stop an intrinsic), 6 float
//     operations a sample and channel, and keeps the last tap's blended
//     columns in registers. K3 takes it for s = 2: its f32 output is held
//     within 1e-5 of the plain version's, and on bin_row_plain it took
//     1.13-1.44x as long at the C4 shapes (PERF.md). Any other s takes
//     bin_row_plain in both kernels (a run-time-s fused loop spilled).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 64;  // output side * sampling ratio
constexpr int kMaxThreads = 256;

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

// A tap as the forward reads it: both cells and both weights.
struct Weights {
  int lo;
  int hi;
  float w0;  // 1 - frac
  float w1;  // frac
};

__device__ __forceinline__ Weights weights_of(Tap t) {
  Weights w;
  w.lo = t.lo;
  w.hi = t.hi;
  w.w0 = 1.0f - t.frac;
  w.w1 = t.frac;
  return w;
}

// V consecutive channels to and from registers in f32.
template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 8> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[8]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  // Streaming stores: K3 writes 0.8-1.6 GB of f32, far past the 50 MB L2,
  // and evict-first keeps the map it reads there.
  static __device__ __forceinline__ void store(float* p,
                                               const float (&v)[8]) {
    float4* q = reinterpret_cast<float4*>(p);
    __stcs(q, make_float4(v[0], v[1], v[2], v[3]));
    __stcs(q + 1, make_float4(v[4], v[5], v[6], v[7]));
  }
};

template <>
struct Vec<float, 2> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[2]) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = a.x; v[1] = a.y;
  }
  static __device__ __forceinline__ void store(float* p,
                                               const float (&v)[2]) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};

// A bf16 is the high half of an f32: the low element of a 32-bit word
// shifted up, the high one masked.
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t bf16_pack(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = bf16_lo(u.x); v[1] = bf16_hi(u.x);
    v[2] = bf16_lo(u.y); v[3] = bf16_hi(u.y);
    v[4] = bf16_lo(u.z); v[5] = bf16_hi(u.z);
    v[6] = bf16_lo(u.w); v[7] = bf16_hi(u.w);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(bf16_pack(v[0], v[1]), bf16_pack(v[2], v[3]),
                   bf16_pack(v[4], v[5]), bf16_pack(v[6], v[7]));
  }
};

template <>
struct Vec<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[2]) {
    const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(p));
    v[0] = bf16_lo(w);
    v[1] = bf16_hi(w);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[2]) {
    *reinterpret_cast<uint32_t*>(p) = bf16_pack(v[0], v[1]);
  }
};

// One map column blended across a y sample's two rows.
template <typename T, int V>
__device__ __forceinline__ void blend_column(const T* row0, const T* row1,
                                             size_t col, float wy0,
                                             float wy1, float (&h)[V]) {
  float a[V];
  float b[V];
  Vec<T, V>::load(row0 + col, a);
  Vec<T, V>::load(row1 + col, b);
#pragma unroll
  for (int v = 0; v < V; ++v) h[v] = __fmaf_rn(b[v], wy1, a[v] * wy0);
}

template <int V>
__device__ __forceinline__ void accumulate(float (&acc)[V],
                                           const float (&h0)[V],
                                           const float (&h1)[V], float w0,
                                           float w1) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    acc[v] = __fmaf_rn(h0[v], w0, acc[v]);
    acc[v] = __fmaf_rn(h1[v], w1, acc[v]);
  }
}

// One bin row of one channel group, summed in the plain version's order:
// out_w bins of s x s samples, y sample outer, x tap inner, each sample
// (((v00 wy0) wx0 + (v01 wy0) wx1) + (v10 wy1) wx0) + (v11 wy1) wx1 added
// to its bin's sum, the mean one division; written to dst[pw * channels].
// map points at the image and the group's first channel; xw holds out_w *
// s x taps, yw this row's s y taps. S > 0 is s at compile time (the loops
// unrolled), S == 0 takes s at run time.
template <typename T, typename O, int V, int S>
__device__ __forceinline__ void bin_row_plain(const T* __restrict__ map,
                                              size_t row_elems, int channels,
                                              const Weights* xw,
                                              const Weights* yw, int out_w,
                                              int s, O* __restrict__ dst) {
  const int n = S > 0 ? S : s;
  const float count = (float)(n * n);
  for (int pw = 0; pw < out_w; ++pw) {
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
#pragma unroll
    for (int iy = 0; iy < n; ++iy) {
      const Weights wy = yw[iy];
      const T* row0 = map + (size_t)wy.lo * row_elems;
      const T* row1 = map + (size_t)wy.hi * row_elems;
#pragma unroll
      for (int ix = 0; ix < n; ++ix) {
        const Weights wx = xw[pw * n + ix];
        const size_t lo = (size_t)wx.lo * channels;
        const size_t hi = (size_t)wx.hi * channels;
        float v00[V];
        float v01[V];
        float v10[V];
        float v11[V];
        Vec<T, V>::load(row0 + lo, v00);
        Vec<T, V>::load(row0 + hi, v01);
        Vec<T, V>::load(row1 + lo, v10);
        Vec<T, V>::load(row1 + hi, v11);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          acc[v] += v00[v] * wy.w0 * wx.w0 + v01[v] * wy.w0 * wx.w1 +
                    v10[v] * wy.w1 * wx.w0 + v11[v] * wy.w1 * wx.w1;
        }
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = acc[v] / count;
    Vec<O, V>::store(dst + (size_t)pw * channels, acc);
  }
}

// One bin row of one channel group, as bin_row_plain with S > 0 but with
// the separable blend in FMAs, x tap outer and y sample inner:
// h = fma(v_row1, wy1, v_row0 * wy0) for a tap's two columns, then
// acc = fma(h_lo, wx0, acc) and acc = fma(h_hi, wx1, acc): 6 float
// operations a sample and channel, not 12, in another order. The last
// tap's blended columns stay in registers: consecutive taps mostly share
// a column, so a RoI narrower than its s x out_w taps loads and unpacks
// each column once.
template <typename T, typename O, int V, int S>
__device__ __forceinline__ void bin_row_fused(const T* __restrict__ map,
                                              size_t row_elems, int channels,
                                              const Weights* xw,
                                              const Weights* yw, int out_w,
                                              O* __restrict__ dst) {
  static_assert(S > 0, "bin_row_fused unrolls a compile-time s");
  const T* row0[S];
  const T* row1[S];
  float wy0[S];
  float wy1[S];
#pragma unroll
  for (int iy = 0; iy < S; ++iy) {
    const Weights w = yw[iy];
    row0[iy] = map + (size_t)w.lo * row_elems;
    row1[iy] = map + (size_t)w.hi * row_elems;
    wy0[iy] = w.w0;
    wy1[iy] = w.w1;
  }
  float h[S][2][V];  // blended columns col_a (lo) and col_b (hi)
  int col_a = -1;
  int col_b = -1;
  for (int pw = 0; pw < out_w; ++pw) {
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
#pragma unroll
    for (int ix = 0; ix < S; ++ix) {
      const Weights wx = xw[pw * S + ix];
      // hi follows from lo, so lo == col_a means both columns are held
      if (wx.lo != col_a) {
        if (wx.lo == col_b) {
#pragma unroll
          for (int iy = 0; iy < S; ++iy) {
#pragma unroll
            for (int v = 0; v < V; ++v) h[iy][0][v] = h[iy][1][v];
          }
        } else {
#pragma unroll
          for (int iy = 0; iy < S; ++iy) {
            blend_column<T, V>(row0[iy], row1[iy],
                               (size_t)wx.lo * channels, wy0[iy], wy1[iy],
                               h[iy][0]);
          }
        }
#pragma unroll
        for (int iy = 0; iy < S; ++iy) {
          blend_column<T, V>(row0[iy], row1[iy], (size_t)wx.hi * channels,
                             wy0[iy], wy1[iy], h[iy][1]);
        }
        col_a = wx.lo;
        col_b = wx.hi;
      }
#pragma unroll
      for (int iy = 0; iy < S; ++iy) {
        accumulate<V>(acc, h[iy][0], h[iy][1], wx.w0, wx.w1);
      }
    }
    const float count = (float)(S * S);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = acc[v] / count;
    Vec<O, V>::store(dst + (size_t)pw * channels, acc);
  }
}

// How a forward block splits its work: `lanes` threads span the channel
// groups (a thread takes groups lanes apart), `rows` such sets of lanes
// take bin rows `rows` apart, and lanes * rows <= kMaxThreads.
struct BlockShape {
  int lanes;
  int threads;
};

inline BlockShape block_shape(int channels, int v, int out_h) {
  const int groups = channels / v;
  const int lanes = groups < kMaxThreads ? groups : kMaxThreads;
  const int max_rows = kMaxThreads / lanes;
  const int passes = (out_h + max_rows - 1) / max_rows;
  const int rows = (out_h + passes - 1) / passes;
  BlockShape shape;
  shape.lanes = lanes;
  shape.threads = lanes * rows;
  return shape;
}

// A forward block's threads over its RoI: bin rows ph, channel groups g,
// each bin row summed by bin_row_fused (kFused and a compile-time s) or
// bin_row_plain.
template <typename T, typename O, int V, int S, bool kFused>
__device__ __forceinline__ void forward_roi(const T* __restrict__ map,
                                            size_t row_elems, int channels,
                                            const Weights* xw,
                                            const Weights* yw, int out_h,
                                            int out_w, int s, int lanes,
                                            O* __restrict__ dst) {
  const int rows = blockDim.x / lanes;
  const int lane = threadIdx.x % lanes;
  const int groups = channels / V;
  for (int ph = threadIdx.x / lanes; ph < out_h; ph += rows) {
    O* dst_row = dst + (size_t)ph * out_w * channels;
    for (int g = lane; g < groups; g += lanes) {
      const int c = g * V;
      if constexpr (kFused && S > 0) {
        bin_row_fused<T, O, V, S>(map + c, row_elems, channels, xw,
                                  yw + ph * s, out_w, dst_row + c);
      } else {
        bin_row_plain<T, O, V, S>(map + c, row_elems, channels, xw,
                                  yw + ph * s, out_w, s, dst_row + c);
      }
    }
  }
}

// The backward kernels' block: two channels a thread over C, at most
// kMaxThreads.
inline int block_threads(int channels) {
  const int threads = ((channels / 2 + 31) / 32) * 32;
  return threads > kMaxThreads ? kMaxThreads : threads;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace
