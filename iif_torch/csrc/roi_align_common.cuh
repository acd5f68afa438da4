// RoIAlign pieces shared by roi_align.cu (K3, K4) and roi_align_ml.cu
// (K1, K2): the sample geometry, the forward kernels' sample loops and the
// backward kernels' per-RoI separable scatter.
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

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------------
// The backward kernels (K2, K4): each RoI's gradient window as the
// separable product dF = Wy^T g Wx of the TPU kernels, one reduction per
// touched (map row, map column) of a RoI.
//
// A RoI's footprint on one axis is built once a block from its taps: the
// distinct map cells (rows or columns) that the taps touch with a nonzero
// weight, in increasing order, each with its bins' summed weights (dense,
// slot x out, zero where a bin does not touch the cell) and the range of
// bins that do. A tap clamped at the last cell (hi == lo) gives both
// weights to that cell. Nothing assumes an order of the taps: a zero-size
// RoI puts every tap on one point, x2 < x1 gives decreasing taps.
//
// Then each work item, one row slot x V channels, walks the bins pw in
// order, with h = sum_ph Wy[row][ph] g[ph][pw], and adds Wx[col][pw] h
// into the pending sum of each column col that the bin touches; it adds
// a column's sum into the map at (row, column) with one vector
// atomic a 4 channels (float4, V = 8) or 2 (float2, V = 2), which sm_90
// has for global memory. Inside a RoI no two threads add to one address;
// RoIs that overlap still add with atomics. The L2 takes reductions at
// 1.45 (f32) to 1.87 (float4) TB/s of payload on an H100 80GB HBM3 at 700 W
// (iif_torch/tools/reduction_rate.cu): what vector atomics save is mostly
// instructions; the bytes they add set the pace.

// One axis of a RoI's footprint in dynamic shared memory.
struct Footprint {
  Tap* tap;    // out * s taps
  int* slot;   // per map cell of the axis: its slot, or -1
  int* cell;   // per slot (at most 2 a tap): the map row or column
  int* bin0;   // per slot: the first bin that touches it
  int* bin1;   // and the last
  int* first;  // per bin: the first slot it touches
  int* last;   // and the last
  float* w;    // slot x out: the bins' summed weights, times scale
  int* count;  // the number of slots
};

// Bytes of one axis's footprint for `extent` map cells on the axis;
// carve_footprint lays it out.
inline size_t footprint_bytes(int out, int s, int extent) {
  const size_t taps = (size_t)out * s;
  const size_t entries = 2 * taps;
  return taps * sizeof(Tap) + (extent + entries * 3 + 2 * out) * sizeof(int) +
         entries * out * sizeof(float) + sizeof(int);
}

__device__ __forceinline__ Footprint carve_footprint(unsigned char*& p,
                                                     int out, int s,
                                                     int extent) {
  const int taps = out * s;
  const int entries = 2 * taps;
  Footprint f;
  f.tap = reinterpret_cast<Tap*>(p);
  p += taps * sizeof(Tap);
  int* ints = reinterpret_cast<int*>(p);
  f.slot = ints;
  f.cell = ints + extent;
  f.bin0 = f.cell + entries;
  f.bin1 = f.bin0 + entries;
  f.first = f.bin1 + entries;
  f.last = f.first + out;
  p += (extent + entries * 3 + 2 * out) * sizeof(int);
  f.w = reinterpret_cast<float*>(p);
  p += (size_t)entries * out * sizeof(float);
  f.count = reinterpret_cast<int*>(p);
  p += sizeof(int);
  return f;
}

// Entry e of the taps: the low corner of tap e / 2 for even e, the high
// one for odd e, with its bilinear weight.
__device__ __forceinline__ int entry_cell(const Tap* tap, int e) {
  const Tap t = tap[e >> 1];
  return (e & 1) ? t.hi : t.lo;
}
__device__ __forceinline__ float entry_weight(const Tap* tap, int e) {
  const Tap t = tap[e >> 1];
  return (e & 1) ? t.frac : 1.0f - t.frac;
}

// The cells that n_taps taps touch lie in [lo, lo + n): scanned by every
// thread, in no assumed order.
struct Span {
  int lo;
  int n;
};

__device__ __forceinline__ Span tap_span(const Tap* tap, int n_taps) {
  int lo = tap[0].lo;
  int hi = tap[0].hi;
  for (int t = 1; t < n_taps; ++t) {
    lo = min(lo, tap[t].lo);
    hi = max(hi, tap[t].hi);
  }
  Span span;
  span.lo = lo;
  span.n = hi - lo + 1;
  return span;
}

// At most as many slots as the span has cells, and two a tap.
__device__ __forceinline__ int slot_bound(Span span, int n_taps) {
  return min(span.n, 2 * n_taps);
}

// Fills f from its taps (f.tap, written before a __syncthreads) within
// their span; every thread of the block calls it (blockDim.x >= 32).
// The cells with a nonzero weight are marked, numbered in increasing order
// by one warp's scan, then each thread takes a bin and adds its taps'
// weights, times scale, into its own column of the table in tap order,
// and notes the slots that the bin touches. Returns the number of slots.
__device__ int build_footprint(const Footprint& f, int out, int s,
                               float scale, Span span) {
  const int entries = 2 * out * s;
  const int slots = slot_bound(span, out * s);
  for (int i = threadIdx.x; i < span.n; i += blockDim.x) f.slot[i] = 0;
  for (int i = threadIdx.x; i < slots * out; i += blockDim.x) f.w[i] = 0.0f;
  for (int k = threadIdx.x; k < slots; k += blockDim.x) {
    f.bin0[k] = out;
    f.bin1[k] = -1;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < entries; e += blockDim.x) {
    if (entry_weight(f.tap, e) != 0.0f) {
      f.slot[entry_cell(f.tap, e) - span.lo] = 1;
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (span.n + 31) / 32;
    const int i0 = min(lane * per, span.n);
    const int i1 = min(i0 + per, span.n);
    int marked = 0;
    for (int i = i0; i < i1; ++i) marked += f.slot[i];
    int upto = marked;  // inclusive scan over the lanes
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, upto, d);
      if (lane >= d) upto += v;
    }
    int k = upto - marked;
    for (int i = i0; i < i1; ++i) {
      if (f.slot[i]) {
        f.cell[k] = span.lo + i;
        f.slot[i] = k++;
      } else {
        f.slot[i] = -1;
      }
    }
    if (lane == 31) *f.count = upto;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < out; b += blockDim.x) {
    int first = slots;
    int last = -1;
    for (int e = 2 * b * s; e < 2 * (b + 1) * s; ++e) {
      const float we = entry_weight(f.tap, e);
      if (we == 0.0f) continue;
      const int k = f.slot[entry_cell(f.tap, e) - span.lo];
      f.w[k * out + b] += we * scale;
      atomicMin(f.bin0 + k, b);
      atomicMax(f.bin1 + k, b);
      first = min(first, k);
      last = max(last, k);
    }
    f.first[b] = first;
    f.last[b] = last;
  }
  __syncthreads();
  return *f.count;
}

// A backward work item's V channels: V = 2 consecutive ones; for V = 8
// either two runs of 4, at c and c + split, where split = 4 x the lanes of
// its channel chunk, so that the float4 atomics that a chunk's lanes issue
// together cover whole 32-byte sectors; or 8 consecutive ones (split = 4),
// whose two float4s each write half a sector (scatter_roi_any chooses).
template <typename T, int V>
__device__ __forceinline__ void load_item(const T* p, int split,
                                          float (&v)[V]);

template <>
__device__ __forceinline__ void load_item<float, 8>(const float* p,
                                                    int split,
                                                    float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + split));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <>
__device__ __forceinline__ void load_item<__nv_bfloat16, 8>(
    const __nv_bfloat16* p, int split, float (&v)[8]) {
  const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
  const uint2 b = __ldg(reinterpret_cast<const uint2*>(p + split));
  v[0] = bf16_lo(a.x); v[1] = bf16_hi(a.x);
  v[2] = bf16_lo(a.y); v[3] = bf16_hi(a.y);
  v[4] = bf16_lo(b.x); v[5] = bf16_hi(b.x);
  v[6] = bf16_lo(b.y); v[7] = bf16_hi(b.y);
}

template <>
__device__ __forceinline__ void load_item<float, 2>(const float* p, int,
                                                    float (&v)[2]) {
  Vec<float, 2>::load(p, v);
}

template <>
__device__ __forceinline__ void load_item<__nv_bfloat16, 2>(
    const __nv_bfloat16* p, int, float (&v)[2]) {
  Vec<__nv_bfloat16, 2>::load(p, v);
}

// An item's V channels added into the f32 accumulator at p (as
// load_item): vector atomics, none for a part that is all zero.
template <int V>
__device__ __forceinline__ void add_item(float* p, int split,
                                         const float (&a)[V]) {
  if constexpr (V == 8) {
    if (a[0] != 0.0f || a[1] != 0.0f || a[2] != 0.0f || a[3] != 0.0f) {
      atomicAdd(reinterpret_cast<float4*>(p),
                make_float4(a[0], a[1], a[2], a[3]));
    }
    if (a[4] != 0.0f || a[5] != 0.0f || a[6] != 0.0f || a[7] != 0.0f) {
      atomicAdd(reinterpret_cast<float4*>(p + split),
                make_float4(a[4], a[5], a[6], a[7]));
    }
  } else {
    static_assert(V == 2, "vec8 or pair");
    if (a[0] != 0.0f || a[1] != 0.0f) {
      atomicAdd(reinterpret_cast<float2*>(p), make_float2(a[0], a[1]));
    }
  }
}

// Columns of pending sums a work item holds in registers: a bin touches
// at most 2 s columns (two corners a tap), 4 at s <= 2.
constexpr int kWindow = 4;

// One work item: row slot k of one RoI, V channels (load_item). A slot
// holds the bins' weights of one map row; two slots an item read g once
// for both but took 163-170 registers (one block of kMaxThreads a SM, not
// two), and K4 took 14-21% longer, K2 3-11% (PERF.md). grad points at the
// RoI's (out_h, out_w, C) gradient and map at its image's f32 (H, W, C)
// accumulator, both at the item's first channel. Offsets inside them are
// 64-bit: with 32-bit ones K4 took 1-3% longer (PERF.md).
//
// It walks the bins pw in order: h = sum_ph Wy[k][ph] g[ph][pw], each g
// element read once an item, then h times each touched column's weight
// into a window of kWindow columns of pending sums, slots base .. base +
// kWindow - 1, flushed (one vector atomic a column) as the window moves
// past them. Taps are monotone, so the window moves one way and each
// (row, column) is flushed once; any other order flushes a column more
// than once and adds the same sums. A bin whose columns do not fit in the
// window (s > 2 with bins wider than a cell) adds its own. Walking the
// columns instead, with h recomputed for each column's bins, re-read g for
// small RoIs, whose bins share columns: in a C4 training step (RoIs of 1-3
// cells) K4 took 1.8x as long (PERF.md).
template <typename T, int V>
__device__ __forceinline__ void scatter_rows(
    const T* __restrict__ grad, float* __restrict__ map, int width,
    int channels, int split, int out_h, int out_w, const Footprint& ys,
    int k, const Footprint& xs, int n_cols) {
  constexpr int W = kWindow;
  const int ph0 = ys.bin0[k];
  const int ph1 = ys.bin1[k];
  float* const row = map + (size_t)ys.cell[k] * width * channels;
  const float* wy = ys.w + k * out_h;
  float acc[W][V];
#pragma unroll
  for (int c = 0; c < W; ++c) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[c][v] = 0.0f;
  }
  // adds window column c (slot base + c) and clears it
  auto flush = [&](int base, int c) {
    const int j = base + c;
    if (j < 0 || j >= n_cols) return;
    add_item<V>(row + (size_t)xs.cell[j] * channels, split, acc[c]);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[c][v] = 0.0f;
  };
  int base = 0;
  for (int pw = 0; pw < out_w; ++pw) {
    const int j0 = xs.first[pw];
    const int j1 = xs.last[pw];
    float h[V];
#pragma unroll
    for (int v = 0; v < V; ++v) h[v] = 0.0f;
    for (int ph = ph0; ph <= ph1; ++ph) {
      float gv[V];
      load_item<T, V>(grad + ((size_t)ph * out_w + pw) * channels, split,
                      gv);
      const float w = wy[ph];
#pragma unroll
      for (int v = 0; v < V; ++v) h[v] = __fmaf_rn(w, gv[v], h[v]);
    }
    if (j1 - j0 >= W) {  // wider than the window: the bin adds its own
      for (int j = j0; j <= j1; ++j) {
        const float wx = xs.w[j * out_w + pw];
        float a[V];
#pragma unroll
        for (int v = 0; v < V; ++v) a[v] = wx * h[v];
        add_item<V>(row + (size_t)xs.cell[j] * channels, split, a);
      }
      continue;
    }
    if (j0 < base) {  // backwards (or the first bin): a new window
#pragma unroll
      for (int c = 0; c < W; ++c) flush(base, c);
      base = j1 - (W - 1);
    }
    while (j1 >= base + W) {  // forwards: the first column is done
      flush(base, 0);
#pragma unroll
      for (int c = 0; c + 1 < W; ++c) {
#pragma unroll
        for (int v = 0; v < V; ++v) acc[c][v] = acc[c + 1][v];
      }
#pragma unroll
      for (int v = 0; v < V; ++v) acc[W - 1][v] = 0.0f;
      ++base;
    }
#pragma unroll
    for (int c = 0; c < W; ++c) {
      const int j = base + c;
      if (j < j0 || j > j1) continue;
      const float wx = xs.w[j * out_w + pw];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[c][v] = __fmaf_rn(wx, h[v], acc[c][v]);
    }
  }
#pragma unroll
  for (int c = 0; c < W; ++c) flush(base, c);
}

// A backward block's work over its RoI: items (channel chunk, row slot,
// V channels), the chunk outermost, spread over the block's threads and the
// RoI's gridDim.y blocks. Every row slot re-reads g over its bins, so the
// threads that run together take one chunk of kChunkVecs x V channels
// (64 at vec8): its g (50 KB at 14x14 in f32) stays in L1 while they
// re-read it. With the channels innermost across all of C, g's re-reads
// went past L1 and K4 took 11-22% longer (PERF.md).
constexpr int kChunkVecs = 8;

// The lanes of a channel chunk (the last chunk may have fewer vectors)
// and the items of a RoI with n_rows row slots and vecs channel vectors.
__host__ __device__ inline int chunk_lanes(int vecs) {
  return vecs < kChunkVecs ? vecs : kChunkVecs;
}

__host__ __device__ inline int item_count(int n_rows, int vecs) {
  const int chunk = chunk_lanes(vecs);
  return (vecs + chunk - 1) / chunk * n_rows * chunk;
}

// An item's 8 channels (V = 8) are two runs of 4 a chunk's lanes apart
// (load_item), or, for a RoI of at most kSmallRows row slots, 8
// consecutive ones (Runs = false): scatter_roi_any chooses once a RoI from
// the rows it built. Two runs for every RoI took K4 24% longer on a C4
// training step's RoIs (1.3-2.8 cells a side); 8 consecutive channels for
// every RoI took K4 34% and K2 25% longer on the kernel phases' RoIs,
// which overlap much more, and K2 22% on a MaskRCNN step's; a bound of 4
// or 16 rows took K4 1-2% longer, 16 took K2 6% longer (PERF.md).
constexpr int kSmallRows = 8;

template <typename T, int V, bool Runs>
__device__ __forceinline__ void scatter_roi(
    const T* __restrict__ grad, float* __restrict__ map, int width,
    int channels, int out_h, int out_w, const Footprint& ys, int n_rows,
    const Footprint& xs, int n_cols) {
  const int vecs = channels / V;
  const int chunk = chunk_lanes(vecs);
  const int per_chunk = n_rows * chunk;
  const int items = item_count(n_rows, vecs);
  for (int i = blockIdx.y * blockDim.x + threadIdx.x; i < items;
       i += gridDim.y * blockDim.x) {
    const int k = i / per_chunk;
    const int rem = i - k * per_chunk;
    const int slot = rem / chunk;
    const int lane = rem - slot * chunk;
    const int lanes = min(chunk, vecs - k * chunk);  // the last may be short
    if (lane >= lanes) continue;
    constexpr bool runs = Runs && V == 8;
    const int c = k * chunk * V + lane * (runs ? 4 : V);
    scatter_rows<T, V>(grad + c, map + c, width, channels,
                       runs ? 4 * lanes : 4, out_h, out_w, ys, slot, xs,
                       n_cols);
  }
}

// scatter_roi with the channel layout chosen from the RoI's row slots.
template <typename T, int V>
__device__ __forceinline__ void scatter_roi_any(
    const T* __restrict__ grad, float* __restrict__ map, int width,
    int channels, int out_h, int out_w, const Footprint& ys, int n_rows,
    const Footprint& xs, int n_cols) {
  if constexpr (V == 8) {
    if (n_rows <= kSmallRows) {
      scatter_roi<T, V, false>(grad, map, width, channels, out_h, out_w, ys,
                               n_rows, xs, n_cols);
      return;
    }
  }
  scatter_roi<T, V, true>(grad, map, width, channels, out_h, out_w, ys,
                          n_rows, xs, n_cols);
}

// Does block blockIdx.y of a RoI with n_rows row slots have any item?
__device__ __forceinline__ bool has_items(int n_rows, int channels, int v) {
  return (int)(blockIdx.y * blockDim.x) < item_count(n_rows, channels / v);
}

// The span of a RoI's n_taps taps on an axis of n cells from its first
// and last tap alone: make_tap's position is monotone in t (a rounded
// product and sum of an increasing sequence, no contraction), and the
// clamp keeps it so. The kernels ask has_items with it before they
// compute anything: most of a small RoI's blocks have no item, and when
// they returned only after building the rows K4 took 18% longer on a C4
// training step's RoIs (PERF.md).
__device__ __forceinline__ Span end_span(float start, float bin, int n_taps,
                                         int s, int n) {
  const Tap a = make_tap(start, bin, 0, s, (float)(n - 1));
  const Tap b = make_tap(start, bin, n_taps - 1, s, (float)(n - 1));
  Span span;
  span.lo = min(a.lo, b.lo);
  span.n = max(a.hi, b.hi) - span.lo + 1;
  return span;
}

// A backward launch: kMaxThreads threads a block and, for each RoI,
// enough blocks (gridDim.y) that a RoI of out * s + 1 rows, the most that
// taps a cell or less apart touch, takes `passes` items a thread; larger
// RoIs loop more. The footprints of both axes in dynamic shared memory,
// for maps of at most height x width cells.
struct BwdShape {
  int splits;
  size_t smem;
};

inline BwdShape bwd_shape(int channels, int v, int out_h, int out_w, int s,
                          int height, int width, int passes) {
  const int items = item_count(out_h * s + 1, channels / v);
  const int per_block = passes * kMaxThreads;
  BwdShape shape;
  shape.splits = (items + per_block - 1) / per_block;
  shape.smem = footprint_bytes(out_h, s, height) +
               footprint_bytes(out_w, s, width);
  return shape;
}

// Above 48 KB (out * s near kMaxTaps at s = 1) a kernel must opt in.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
