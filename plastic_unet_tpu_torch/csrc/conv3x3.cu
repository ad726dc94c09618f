// 3x3 SAME stride-1 convolution for Hopper (sm_90a), NHWC, fp32.
//
// Replaces: plastic_unet_tpu/ops/pallas_conv.py::_conv_kernel (pl.pallas_call
// in conv3x3_flat): im2col from 9 border-masked shifts, (R, 9Cin) @ (9Cin, Cout),
// + bias, optional ReLU. Here with a batch dimension, general Cin and Cout,
// and the flags the residual tail needs fused into load and epilogue:
//   out = act_out( conv(act_in(x), w) + bias + act_res(res) )
// where act_in / act_res / act_out are ReLU or identity and res is optional.
//
// What bounds it: at the UNetPRes level shapes (101^2 x 16 ... 6^2 x 256,
// B=128) one conv is ~6 GFLOP against ~85-170 MB of traffic, so it is
// bound by fp32 operations (~90 us on H100 SXM at 67 TFLOP/s), not bytes.
// Design: an implicit GEMM, M = output pixels, N = Cout, K = 9 * Cin, on
// plain fp32 FMAs (no TF32, so parity with the fp32 reference holds). A
// block owns a TPH x TPW tile of output pixels of one sample and an NT-wide
// slice of Cout. Per 16-channel slice of Cin it stages the input tile with a
// 1-pixel halo (zero outside the image; ReLU applied on load when asked) and
// the weights (3,3,Cin,Cout) of its slice in shared memory, so each input
// element is read from device memory ~once per block instead of 9 times.
// Each thread accumulates 4 consecutive pixels x 4 output channels in
// registers: per channel step, 4 scalar shared loads and one 16-byte weight
// load feed 16 FMAs. The halo tile's channel stride is padded to 17 floats
// so the 4-pixel groups of a warp fall on distinct banks.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // every tile configuration runs 128 threads
constexpr int CK = 16;       // input channels staged per step
constexpr int CKP = CK + 1;  // padded channel stride of the halo tile

template <int TPH, int TPW, int NT>
struct Shape {
  static constexpr int HH = TPH + 2, HW = TPW + 2;
  static constexpr int PG_W = TPW / 4;  // 4-pixel groups per tile row
  static constexpr int NG = NT / 4;     // 4-channel groups
  static_assert(TPH * PG_W * NG == THREADS, "tile configuration must use THREADS threads");
};

template <int TPH, int TPW, int NT>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ wt,
               const float* __restrict__ bias, const float* __restrict__ res,
               float* __restrict__ out, int H, int W, int Cin, int Cout, int tiles_w,
               int relu_in, int relu_res, int relu_out) {
  using S = Shape<TPH, TPW, NT>;
  __shared__ float xs[S::HH * S::HW * CKP];
  __shared__ __align__(16) float ws[9 * CK * NT];

  const int tid = threadIdx.x;
  const int ng = tid % S::NG, pg = tid / S::NG;
  const int py = pg / S::PG_W, px = (pg % S::PG_W) * 4;
  const int oy0 = (blockIdx.x / tiles_w) * TPH, ox0 = (blockIdx.x % tiles_w) * TPW;
  const int n0 = blockIdx.y * NT;
  const int b = blockIdx.z;
  const float* xb = x + (size_t)b * H * W * Cin;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int c0 = 0; c0 < Cin; c0 += CK) {
    for (int i = tid; i < S::HH * S::HW * CK; i += THREADS) {
      const int cc = i % CK, p = i / CK;
      const int gy = oy0 + p / S::HW - 1, gx = ox0 + p % S::HW - 1, c = c0 + cc;
      float v = 0.0f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin) {
        v = xb[((size_t)gy * W + gx) * Cin + c];
        if (relu_in) v = fmaxf(v, 0.0f);
      }
      xs[p * CKP + cc] = v;
    }
    for (int i = tid; i < 9 * CK * NT; i += THREADS) {
      const int n = i % NT, r = i / NT;
      const int cc = r % CK, tap = r / CK;
      const int c = c0 + cc, gn = n0 + n;
      ws[i] = (c < Cin && gn < Cout) ? wt[((size_t)tap * Cin + c) * Cout + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      const float* xrow = &xs[((py + ky) * S::HW + px + kx) * CKP];
      const float* wrow = &ws[tap * CK * NT + ng * 4];
#pragma unroll
      for (int cc = 0; cc < CK; ++cc) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xrow[i * CKP + cc];
        const float4 bw = *reinterpret_cast<const float4*>(wrow + cc * NT);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(a[i], bw.x, acc[i][0]);
          acc[i][1] = fmaf(a[i], bw.y, acc[i][1]);
          acc[i][2] = fmaf(a[i], bw.z, acc[i][2]);
          acc[i][3] = fmaf(a[i], bw.w, acc[i][3]);
        }
      }
    }
    __syncthreads();
  }

  const int oy = oy0 + py;
  if (oy >= H) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ox = ox0 + px + i;
    if (ox >= W) continue;
    const size_t o = (((size_t)b * H + oy) * W + ox) * Cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + ng * 4 + j;
      if (n >= Cout) continue;
      float v = acc[i][j] + bias[n];
      if (res != nullptr) {
        float r = res[o + n];
        if (relu_res) r = fmaxf(r, 0.0f);
        v += r;
      }
      if (relu_out) v = fmaxf(v, 0.0f);
      out[o + n] = v;
    }
  }
}

template <int TPH, int TPW, int NT>
void launch(const float* x, const float* wt, const float* bias, const float* res, float* out,
            int batch, int H, int W, int Cin, int Cout, int relu_in, int relu_res, int relu_out,
            cudaStream_t s) {
  const int tiles_w = (W + TPW - 1) / TPW, tiles_h = (H + TPH - 1) / TPH;
  dim3 grid(tiles_w * tiles_h, (Cout + NT - 1) / NT, batch);
  conv3x3_kernel<TPH, TPW, NT><<<grid, THREADS, 0, s>>>(
      x, wt, bias, res, out, H, W, Cin, Cout, tiles_w, relu_in, relu_res, relu_out);
}

}  // namespace

// w: (3, 3, Cin, Cout) contiguous; res may be NULL. Narrow outputs (Cout <= 16)
// take a 16x8-pixel tile with a 16-channel slice, wider ones an 8x8 tile with a
// 32-channel slice; both run 128 threads.
extern "C" int conv3x3_forward(const void* x, const void* w, const void* bias, const void* res,
                               void* out, int batch, int h, int w_, int cin, int cout,
                               int relu_in, int relu_res, int relu_out, void* stream) {
  if (cout <= 16) {
    launch<16, 8, 16>((const float*)x, (const float*)w, (const float*)bias, (const float*)res,
                      (float*)out, batch, h, w_, cin, cout, relu_in, relu_res, relu_out,
                      (cudaStream_t)stream);
  } else {
    launch<8, 8, 32>((const float*)x, (const float*)w, (const float*)bias, (const float*)res,
                     (float*)out, batch, h, w_, cin, cout, relu_in, relu_res, relu_out,
                     (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
