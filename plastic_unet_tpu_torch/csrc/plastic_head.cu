// Plastic head for Hopper (sm_90a), fp32.
//
// Replaces: plastic_unet_tpu/ops/pallas_plastic.py::_head_kernel_hebb and
// ::_head_kernel_oja (launched per sample by _pallas_head_padded and vmapped
// by plastic_head_pallas_batched). Per sample b, on (n, n) matrices:
//   eff      = w + alpha * hebb[b]          (alpha a matrix, or a scalar: "yoked")
//   activ    = activin[b] @ eff             (fp32 accumulation)
//   activout = sigmoid(activ)
//   hebb'    = rank-1 update from row 0 of activin[b] and activout[b]
//     hebb: (1 - eta) * h + eta * x0[i] * y0[j]
//     oja:  h + eta * (x0[i] - h * y0[j]) * y0[j]
//   with x0 = activin[b, 0, :] and y0 = activout[b, 0, :].
//
// What bounds it: at B=128, n=101 it moves ~26 MB (activin, hebb in; three
// outputs) for 264 MFLOP, so it is memory-bound (~8 us on H100 SXM).
// Design: one launch for all B samples. Grid (column tile, row tile, sample),
// 32x32 output tiles, 32x8 threads; n=101 is handled with edge masks, not
// padding. Each block builds eff for its column tile on load, so eff is
// never written to memory. The trouble spot is the trace update: hebb'[i, j]
// needs y0[j], the row-0 output of column j, which only the block of row
// tile 0 computes, and blocks run in no order. So every block recomputes the
// row-0 dot products of its own column tile in the same k loop (n MACs per
// column, in the same order as the owning block, hence bitwise equal), and
// no block waits for another. eta is read from device memory.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int ROWS = 8;               // threadIdx.y extent
constexpr int PER_T = TILE / ROWS;    // output rows per thread

__device__ __forceinline__ float sigmoidf(float v) { return 1.0f / (1.0f + expf(-v)); }

template <bool OJA, bool SCALAR_ALPHA>
__global__ void __launch_bounds__(TILE * ROWS)
plastic_head_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ alpha, const float* __restrict__ eta,
                    const float* __restrict__ hebb, float* __restrict__ activ,
                    float* __restrict__ activout, float* __restrict__ hebb_out, int n) {
  __shared__ float xs[TILE][TILE + 1];  // activin[b, row tile, k tile]
  __shared__ float es[TILE][TILE + 1];  // eff[k tile, column tile]
  __shared__ float x0s[TILE];           // activin[b, 0, k tile]
  __shared__ float y0s[TILE];           // activout[b, 0, column tile]

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * TILE + tx;
  const int row0 = blockIdx.y * TILE;
  const size_t base = (size_t)blockIdx.z * n * n;
  const float* xb = x + base;
  const float* hb = hebb + base;
  const float a_scalar = SCALAR_ALPHA ? alpha[0] : 0.0f;

  float acc[PER_T];
#pragma unroll
  for (int i = 0; i < PER_T; ++i) acc[i] = 0.0f;
  float acc0 = 0.0f;  // row 0 of this column (warp ty == 0 only)

  for (int k0 = 0; k0 < n; k0 += TILE) {
#pragma unroll
    for (int i = 0; i < PER_T; ++i) {
      const int r = ty + i * ROWS;
      const int gr = row0 + r, gk = k0 + tx;
      xs[r][tx] = (gr < n && gk < n) ? xb[(size_t)gr * n + gk] : 0.0f;
      const int ek = k0 + r;
      float e = 0.0f;
      if (ek < n && col < n) {
        const size_t j = (size_t)ek * n + col;
        const float a = SCALAR_ALPHA ? a_scalar : alpha[j];
        e = w[j] + a * hb[j];
      }
      es[r][tx] = e;
    }
    if (ty == 0) x0s[tx] = (k0 + tx < n) ? xb[k0 + tx] : 0.0f;
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < TILE; ++k) {
      const float e = es[k][tx];
#pragma unroll
      for (int i = 0; i < PER_T; ++i) acc[i] = fmaf(xs[ty + i * ROWS][k], e, acc[i]);
      if (ty == 0) acc0 = fmaf(x0s[k], e, acc0);  // warp-uniform branch
    }
    __syncthreads();
  }

  if (ty == 0) y0s[tx] = sigmoidf(acc0);
  __syncthreads();
  if (col >= n) return;
  const float et = eta[0];
  const float y0 = y0s[tx];
#pragma unroll
  for (int i = 0; i < PER_T; ++i) {
    const int r = row0 + ty + i * ROWS;
    if (r < n) {
      const size_t o = base + (size_t)r * n + col;
      activ[o] = acc[i];
      activout[o] = sigmoidf(acc[i]);
      const float h = hebb[o];
      const float x0 = xb[r];
      hebb_out[o] = OJA ? h + et * (x0 - h * y0) * y0 : (1.0f - et) * h + et * (x0 * y0);
    }
  }
}

template <bool OJA, bool SCALAR_ALPHA>
void launch(const float* x, const float* w, const float* alpha, const float* eta, const float* hebb,
            float* activ, float* activout, float* hebb_out, int batch, int n, cudaStream_t s) {
  const int tiles = (n + TILE - 1) / TILE;
  dim3 grid(tiles, tiles, batch), block(TILE, ROWS);
  plastic_head_kernel<OJA, SCALAR_ALPHA><<<grid, block, 0, s>>>(x, w, alpha, eta, hebb, activ, activout,
                                                              hebb_out, n);
}

}  // namespace

extern "C" int plastic_head_forward(const void* x, const void* w, const void* alpha, const void* eta,
                                    const void* hebb, void* activ, void* activout, void* hebb_out,
                                    int batch, int n, int oja, int scalar_alpha, void* stream) {
  auto f = [&](auto fn) {
    fn((const float*)x, (const float*)w, (const float*)alpha, (const float*)eta, (const float*)hebb,
       (float*)activ, (float*)activout, (float*)hebb_out, batch, n, (cudaStream_t)stream);
  };
  if (oja) {
    if (scalar_alpha) f(launch<true, true>); else f(launch<true, false>);
  } else {
    if (scalar_alpha) f(launch<false, true>); else f(launch<false, false>);
  }
  return (int)cudaGetLastError();
}
