// Weight and bias gradient of the 3x3 SAME stride-1 convolution for Hopper
// (sm_90a), NHWC, fp32.
//
// Replaces: the g.dw(...) and jnp.sum(d, axis=0) lines of
// plastic_unet_tpu/ops/pallas_trunk.py::_tail_bwd_kernel (_Geo.dw: per tap,
// shift_t(input)^T @ d):
//   dW[ky,kx,ci,co] = sum over b,y,x of act(in)[b, y+ky-1, x+kx-1, ci] * d[b,y,x,co]
//   db[co]          = sum over b,y,x of d[b,y,x,co]
// with zero outside the image and act = ReLU or identity applied on load, so
// the forward stores only pre-activations.
//
// What bounds it: the same 2*9*Cin*Cout*B*H*W operations as the forward conv
// against two activation reads, so operations (fp32 FMAs), except at B=1 where
// it is a few microseconds of work and launch latency dominates.
// Design: a reduction over B*H*W pixels into 9*Cin*Cout sums. The five level
// shapes pull in opposite directions (101^2 x 16: 10,201 pixels per sample and
// 2,304 sums; 6^2 x 256: 36 pixels and 589,824 sums), so the work is split
// both ways: grid.y walks (16-channel ci slice) x (CO_T-channel co slice),
// grid.x walks `chunks` of consecutive 8x8 pixel tiles of the (sample, tile)
// sequence. A block stages the input tile with its 1-pixel halo and the d tile
// in shared memory; a thread owns one ci, four co and all nine taps (36 sums in
// registers) and walks each tile row keeping a 3x3 input window in registers,
// so a pixel costs three scalar shared loads and one 16-byte load for 36 FMAs.
// With one chunk the block writes the final array; otherwise it writes its
// partial sums to a workspace and wgrad_reduce adds the chunks in index order.
// No atomics: the result is the same bits on every run.

#include <cuda_runtime.h>

namespace {

constexpr int TPH = 8, TPW = 8;            // output pixels per tile
constexpr int HH = TPH + 2, HW = TPW + 2;  // with the halo
constexpr int CI_T = 16;                   // input channels per block

__device__ __forceinline__ size_t w_index(int tap, int c, int n, int Cin, int Cout, int oihw) {
  return oihw ? ((size_t)n * Cin + c) * 9 + tap : ((size_t)tap * Cin + c) * Cout + n;
}

template <int CO_T>
__global__ void __launch_bounds__(CI_T * CO_T / 4)
wgrad_kernel(const float* __restrict__ x, const float* __restrict__ d,
             float* __restrict__ w_out, float* __restrict__ b_out,
             int H, int W, int Cin, int Cout, int tiles_w, int tiles_per_sample,
             int total_tiles, int tiles_per_chunk, int co_tiles, int relu_in, int direct, int oihw) {
  constexpr int THREADS = CI_T * CO_T / 4;
  __shared__ float xs[HH * HW * CI_T];
  __shared__ __align__(16) float ds[TPH * TPW * CO_T];

  const int tid = threadIdx.x;
  const int ci = tid % CI_T, cg = tid / CI_T;
  const int ci0 = (blockIdx.y / co_tiles) * CI_T, co0 = (blockIdx.y % co_tiles) * CO_T;
  const int t_begin = blockIdx.x * tiles_per_chunk;
  const int t_end = min(total_tiles, t_begin + tiles_per_chunk);
  const bool do_bias = blockIdx.y < co_tiles && ci == 0;  // the ci slice 0 owns db

  float acc[3][3][4];
#pragma unroll
  for (int ky = 0; ky < 3; ++ky)
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[ky][kx][j] = 0.0f;
  float bacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int t = t_begin; t < t_end; ++t) {
    const int b = t / tiles_per_sample, r = t % tiles_per_sample;
    const int oy0 = (r / tiles_w) * TPH, ox0 = (r % tiles_w) * TPW;
    const float* xb = x + (size_t)b * H * W * Cin;
    const float* db = d + (size_t)b * H * W * Cout;
    for (int i = tid; i < HH * HW * CI_T; i += THREADS) {
      const int cc = i % CI_T, p = i / CI_T;
      const int gy = oy0 + p / HW - 1, gx = ox0 + p % HW - 1, c = ci0 + cc;
      float v = 0.0f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin) {
        v = xb[((size_t)gy * W + gx) * Cin + c];
        if (relu_in) v = fmaxf(v, 0.0f);
      }
      xs[i] = v;
    }
    for (int i = tid; i < TPH * TPW * CO_T; i += THREADS) {
      const int n = i % CO_T, p = i / CO_T;
      const int gy = oy0 + p / TPW, gx = ox0 + p % TPW, gn = co0 + n;
      ds[i] = (gy < H && gx < W && gn < Cout) ? db[((size_t)gy * W + gx) * Cout + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll 1
    for (int y = 0; y < TPH; ++y) {
      float a[3][3];  // a[ky][kx]: the input window of the current pixel
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        a[ky][1] = xs[((y + ky) * HW + 0) * CI_T + ci];
        a[ky][2] = xs[((y + ky) * HW + 1) * CI_T + ci];
      }
#pragma unroll
      for (int xx = 0; xx < TPW; ++xx) {
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          a[ky][0] = a[ky][1];
          a[ky][1] = a[ky][2];
          a[ky][2] = xs[((y + ky) * HW + xx + 2) * CI_T + ci];
        }
        const float4 dv = *reinterpret_cast<const float4*>(&ds[(y * TPW + xx) * CO_T + cg * 4]);
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            acc[ky][kx][0] = fmaf(a[ky][kx], dv.x, acc[ky][kx][0]);
            acc[ky][kx][1] = fmaf(a[ky][kx], dv.y, acc[ky][kx][1]);
            acc[ky][kx][2] = fmaf(a[ky][kx], dv.z, acc[ky][kx][2]);
            acc[ky][kx][3] = fmaf(a[ky][kx], dv.w, acc[ky][kx][3]);
          }
        if (do_bias) {
          bacc[0] += dv.x;
          bacc[1] += dv.y;
          bacc[2] += dv.z;
          bacc[3] += dv.w;
        }
      }
    }
    __syncthreads();
  }

  // One chunk: the final array in the caller's layout. More: this chunk's
  // partial sums, (3,3,Cin,Cout)-ordered, for wgrad_reduce.
  float* wt = direct ? w_out : w_out + (size_t)blockIdx.x * 9 * Cin * Cout;
  float* bt = direct ? b_out : b_out + (size_t)blockIdx.x * Cout;
  const int c = ci0 + ci;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = co0 + cg * 4 + j;
    if (n >= Cout) continue;
    if (c < Cin) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
          wt[w_index(ky * 3 + kx, c, n, Cin, Cout, direct && oihw)] = acc[ky][kx][j];
    }
    if (do_bias) bt[n] = bacc[j];
  }
}

// Second stage: out[i] = sum over chunks, in chunk order, of the partials.
__global__ void wgrad_reduce(const float* __restrict__ w_part, const float* __restrict__ b_part,
                             float* __restrict__ w_out, float* __restrict__ b_out,
                             int chunks, int Cin, int Cout, int oihw) {
  const int nw = 9 * Cin * Cout;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nw) {
    float s = 0.0f;
    for (int k = 0; k < chunks; ++k) s += w_part[(size_t)k * nw + i];
    w_out[w_index(i / (Cin * Cout), (i / Cout) % Cin, i % Cout, Cin, Cout, oihw)] = s;
  } else if (i < nw + Cout) {
    const int n = i - nw;
    float s = 0.0f;
    for (int k = 0; k < chunks; ++k) s += b_part[(size_t)k * Cout + n];
    b_out[n] = s;
  }
}

template <int CO_T>
void launch(const float* x, const float* d, float* w_out, float* b_out, float* w_part, float* b_part,
            int batch, int H, int W, int Cin, int Cout, int chunks, int tiles_per_chunk,
            int relu_in, int oihw, cudaStream_t s) {
  const int tiles_w = (W + TPW - 1) / TPW, tiles_h = (H + TPH - 1) / TPH;
  const int co_tiles = (Cout + CO_T - 1) / CO_T, ci_tiles = (Cin + CI_T - 1) / CI_T;
  const int direct = chunks == 1;
  dim3 grid(chunks, ci_tiles * co_tiles);
  wgrad_kernel<CO_T><<<grid, CI_T * CO_T / 4, 0, s>>>(
      x, d, direct ? w_out : w_part, direct ? b_out : b_part, H, W, Cin, Cout, tiles_w,
      tiles_w * tiles_h, batch * tiles_w * tiles_h, tiles_per_chunk, co_tiles, relu_in, direct, oihw);
  if (!direct) {
    const int n = 9 * Cin * Cout + Cout;
    wgrad_reduce<<<(n + 255) / 256, 256, 0, s>>>(w_part, b_part, w_out, b_out, chunks, Cin, Cout, oihw);
  }
}

}  // namespace

// x: (B,H,W,Cin), d: (B,H,W,Cout); w_out: (3,3,Cin,Cout), or (Cout,Cin,3,3) with
// oihw; b_out: (Cout,). The caller splits the batch*ceil(H/8)*ceil(W/8) tiles
// into `chunks` runs of tiles_per_chunk and, for more than one chunk, gives the
// workspaces w_part (chunks,3,3,Cin,Cout) and b_part (chunks,Cout). Cout <= 16
// takes 16-channel co slices (64 threads), wider ones 32 (128 threads).
extern "C" int conv3x3_wgrad(const void* x, const void* d, void* w_out, void* b_out,
                             void* w_part, void* b_part, int batch, int h, int w_, int cin, int cout,
                             int chunks, int tiles_per_chunk, int relu_in, int oihw, void* stream) {
  if (cout <= 16) {
    launch<16>((const float*)x, (const float*)d, (float*)w_out, (float*)b_out, (float*)w_part,
               (float*)b_part, batch, h, w_, cin, cout, chunks, tiles_per_chunk, relu_in, oihw,
               (cudaStream_t)stream);
  } else {
    launch<32>((const float*)x, (const float*)d, (float*)w_out, (float*)b_out, (float*)w_part,
               (float*)b_part, batch, h, w_, cin, cout, chunks, tiles_per_chunk, relu_in, oihw,
               (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
