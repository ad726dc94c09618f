// Device helpers shared by the residual tail's kernels for Hopper (sm_90a):
// residual_tail.cu (the forward) and residual_tail_backward.cu. Each source
// includes this file and is built into its own library; ops/_build.py hashes
// the headers of csrc/ with every source, so an edit here rebuilds both.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int CK = 16;  // input channels a slice: the square tiles' K step
constexpr int TN = 16;  // output channels a thread of a conv
constexpr int SMEM_MAX = 232448;  // bytes a block may use on an H100

__device__ __forceinline__ unsigned smem_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }
// A cluster barrier in two halves: what a thread wrote (to its own or another
// block's shared memory) before its arrive is seen by every thread of the
// cluster after its wait.
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }

template <class T>
__device__ __forceinline__ T pick(int k, T a, T b, T c, T d) {  // no local copy of the argument struct
  return k == 0 ? a : k == 1 ? b : k == 2 ? c : d;
}

// Elements c = threadIdx.x % G of the pixels threadIdx.x / G, + THREADS / G,
// ..., walked without a division: pixel p is column x of row y (of a slab
// of rows, or of the band).
template <int G, int THREADS>
struct Walk {
  int c, p, y, x;
  __device__ explicit Walk(int W) : c(threadIdx.x % G), p(threadIdx.x / G), y(p / W), x(p - y * W) {}
  __device__ __forceinline__ void next(int W) {
    constexpr int STEP = THREADS / G;
    p += STEP;
    x += STEP;
    while (x >= W) { x -= W; ++y; }
  }
};

// One 16-channel input slice of a conv into acc (taps 0..8, channels of the
// slice): with the slices ascending, the square tiles' order of FMAs.
template <int C, int P>
__device__ __forceinline__ void conv_slice(float (&acc)[P][TN], const float* xs, const float* ws,
                                           const int (&off)[P], int rp, int n0) {
  constexpr int XCS = C + 1;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int delta = (tap / 3 - 1) * rp + tap % 3 - 1;
    const float* xp[P];
#pragma unroll
    for (int i = 0; i < P; ++i) xp[i] = xs + (off[i] + delta) * XCS;
    const float* wrow = ws + tap * CK * C + n0;
#pragma unroll
    for (int cc = 0; cc < CK; ++cc) {
      float v[P];
#pragma unroll
      for (int i = 0; i < P; ++i) v[i] = xp[i][cc];
      float wv[TN];
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 w4 = *reinterpret_cast<const float4*>(wrow + cc * C + 4 * q);
        wv[4 * q] = w4.x;
        wv[4 * q + 1] = w4.y;
        wv[4 * q + 2] = w4.z;
        wv[4 * q + 3] = w4.w;
      }
#pragma unroll
      for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(v[i], wv[j], acc[i][j]);
    }
  }
}

}  // namespace
