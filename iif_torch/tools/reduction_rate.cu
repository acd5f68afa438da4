// The card's rate of f32 reductions into global memory (atomicAdd with an
// unused result, REDG in SASS), one f32, a float2 or a float4 an atomic,
// into an accumulator of K4's size at the C4 training shapes (4 x 50 x 84
// x 1024 f32, 69 MB: it stays in L2, as K4's does). Each warp instruction
// covers 32 consecutive vectors, whole 32-byte sectors, as the backward
// kernels' do; 3 GB of payload a width. Prints one line a width: ms, GB
// of payload, TB/s of payload and G atomics a second.
//
//   nvcc -O3 -gencode arch=compute_90a,code=sm_90a -o reduction_rate \
//       iif_torch/tools/reduction_rate.cu && ./reduction_rate
//
// (iif_torch/tools/roi_align_ab.py --reduction-rate builds and runs it.)
#include <cstdio>

#include <cuda_runtime.h>

template <int V>
__global__ void reduce(float* buf, size_t segments, int iters) {
  const size_t warp = (blockIdx.x * (size_t)blockDim.x + threadIdx.x) / 32;
  const size_t warps = (size_t)gridDim.x * blockDim.x / 32;
  const int lane = threadIdx.x & 31;
  for (int it = 0; it < iters; ++it) {
    const size_t seg = (warp + (size_t)it * warps) % segments;
    float* p = buf + (seg * 32 + lane) * V;
    if constexpr (V == 4) {
      atomicAdd(reinterpret_cast<float4*>(p), make_float4(1, 1, 1, 1));
    } else if constexpr (V == 2) {
      atomicAdd(reinterpret_cast<float2*>(p), make_float2(1, 1));
    } else {
      atomicAdd(p, 1.0f);
    }
  }
}

template <int V>
int run(float* buf, size_t n) {
  const int blocks = 132 * 8;
  const int threads = 256;
  const size_t segments = n / V / 32;
  const int iters = (int)(3e9 / (4.0 * V * blocks * threads));
  reduce<V><<<blocks, threads>>>(buf, segments, 2);  // warm-up
  cudaEvent_t start, end;
  cudaEventCreate(&start);
  cudaEventCreate(&end);
  cudaEventRecord(start);
  reduce<V><<<blocks, threads>>>(buf, segments, iters);
  cudaEventRecord(end);
  cudaEventSynchronize(end);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, start, end);
  const double bytes = 4.0 * V * blocks * threads * iters;
  printf("{\"width\": %d, \"ms\": %.4f, \"payload_gb\": %.3f, "
         "\"tb_per_s\": %.4f, \"g_atomics_per_s\": %.2f}\n",
         V, ms, bytes / 1e9, bytes / ms / 1e9, bytes / (4.0 * V) / ms / 1e6);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}

int main() {
  const size_t n = 4ull * 50 * 84 * 1024;
  float* buf = nullptr;
  if (cudaMalloc(&buf, n * sizeof(float)) != cudaSuccess) return 1;
  cudaMemset(buf, 0, n * sizeof(float));
  int err = 0;
  for (int round = 0; round < 2; ++round) {
    err |= run<1>(buf, n);
    err |= run<2>(buf, n);
    err |= run<4>(buf, n);
  }
  cudaFree(buf);
  return err;
}
