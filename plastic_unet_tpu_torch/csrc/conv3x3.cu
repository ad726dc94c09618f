// 3x3 SAME stride-1 convolution for Hopper (sm_90a), NHWC, fp32.
//
// Replaces: plastic_unet_tpu/ops/pallas_conv.py::_conv_kernel (pl.pallas_call
// in conv3x3_flat): im2col from 9 border-masked shifts, (R, 9Cin) @ (9Cin, Cout),
// + bias, optional ReLU. Here with a batch dimension, general Cin and Cout,
// and the flags the residual tail needs fused into load and epilogue:
//   out = act_out( conv(act_in(x), w) + bias + act_res(res) )
// where act_in / act_res / act_out are ReLU or identity and res is optional.
//
// The same kernel is the input-gradient pass of the residual tail's backward
// (plastic_unet_tpu/ops/pallas_trunk.py::_tail_bwd_kernel, the g.conv(d, wf)
// lines): conv^T == conv(flip(W)) for SAME/stride 1, so with `flip` it reads
// the forward's (3,3,Cf_in,Cf_out) weights tap-reversed and transposed in
// place (no flipped copy is made), takes no bias (bias == NULL), and fuses
// the chain's ReLU masks:
//   out = (conv(x * (in_gate > 0), flip(w)) + res) * (gate > 0)
// in_gate masks the input on load (d_x2 = g * (out > 0)); the masked input
// is also written once to xg_out, by the blocks of the first Cout slice for
// the interior of their tile, because the chain reads it again. gate masks
// the result in the epilogue (d * (pre > 0)).
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

template <int TPH, int TPW, int NT, bool FLIP>
struct Shape {
  static constexpr int HH = TPH + 2, HW = TPW + 2;
  static constexpr int PG_W = TPW / 4;  // 4-pixel groups per tile row
  static constexpr int NG = NT / 4;     // 4-channel groups
  static constexpr int XS = (HH * HW * CKP + 3) / 4 * 4;  // floats of the halo tile, 16-byte rounded
  static constexpr int WSTRIDE = FLIP ? NT + 4 : NT;  // row stride of the weight slice (see the flipped staging)
  static constexpr int WS = 9 * CK * WSTRIDE;         // floats of the weight slice
  static_assert(TPH * PG_W * NG == THREADS, "tile configuration must use THREADS threads");
};

// KG groups of THREADS threads share one output tile: group k walks the
// 16-channel slices k, k+KG, ... of Cin in its own shared-memory buffers, and
// at the end group 0 adds the groups' sums in group order and runs the
// epilogue. KG > 1 is for grids too small to fill the card (B=1 at the deep
// levels: 8 blocks at 6^2 x 256), where one block's K loop is a serial chain
// of load -> sync -> compute steps with one warp per scheduler: more warps on
// the SM hide that latency and the chain is KG times shorter.
// Registers decide how many blocks an SM holds at B=128, and with them the
// speed: the one-group variants are held to 6 blocks per SM (narrow, at most
// 85 registers) and 5 (wide, at most 102). Left to itself the compiler has
// given the narrow one 96 (5 blocks; slower at 101^2 x 16) or the wide one 113.
template <int TPH, int TPW, int NT, int KG, bool FLIP>
__global__ void __launch_bounds__(THREADS * KG, KG > 1 ? 1 : NT == 16 ? 6 : 5)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ in_gate,
               const float* __restrict__ wt, const float* __restrict__ bias,
               const float* __restrict__ res, const float* __restrict__ gate,
               float* __restrict__ out, float* __restrict__ xg_out,
               int H, int W, int Cin, int Cout, int tiles_w,
               int relu_in, int relu_res, int relu_out) {
  using S = Shape<TPH, TPW, NT, FLIP>;
  constexpr int WSTRIDE = S::WSTRIDE;
  extern __shared__ __align__(16) float smem[];
  const int kg = threadIdx.x / THREADS, tid = threadIdx.x % THREADS;
  float* xs = smem + kg * (S::XS + S::WS);
  float* ws = xs + S::XS;

  const int ng = tid % S::NG, pg = tid / S::NG;
  const int py = pg / S::PG_W, px = (pg % S::PG_W) * 4;
  const int oy0 = (blockIdx.x / tiles_w) * TPH, ox0 = (blockIdx.x % tiles_w) * TPW;
  const int n0 = blockIdx.y * NT;
  const int b = blockIdx.z;
  const size_t xoff = (size_t)b * H * W * Cin;
  const float* xb = x + xoff;
  const bool write_xg = xg_out != nullptr && blockIdx.y == 0;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  // Every group runs the same number of steps (the barriers are block-wide);
  // a group whose slice lies beyond Cin stages zeros.
  const int steps = (Cin + CK * KG - 1) / (CK * KG);
  for (int step = 0; step < steps; ++step) {
    const int c0 = (step * KG + kg) * CK;
    for (int i = tid; i < S::HH * S::HW * CK; i += THREADS) {
      const int cc = i % CK, p = i / CK;
      const int gy = oy0 + p / S::HW - 1, gx = ox0 + p % S::HW - 1, c = c0 + cc;
      float v = 0.0f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin) {
        const size_t o = ((size_t)gy * W + gx) * Cin + c;
        v = xb[o];
        if (relu_in) v = fmaxf(v, 0.0f);
        if (in_gate != nullptr && !(in_gate[xoff + o] > 0.0f)) v = 0.0f;
        const int ty = p / S::HW, tx = p % S::HW;  // the tile's interior is written once
        if (write_xg && ty >= 1 && ty <= TPH && tx >= 1 && tx <= TPW) xg_out[xoff + o] = v;
      }
      xs[p * CKP + cc] = v;
    }
    if constexpr (FLIP) {
      // The forward's (3,3,Cout,Cin) array read tap-reversed and transposed:
      // Cin runs fastest in memory, so the loop does too (16 consecutive floats
      // per output channel); the rows' stride NT + 4 spreads the transposed
      // stores over the banks and keeps the 16-byte loads below aligned.
      for (int i = tid; i < 9 * CK * NT; i += THREADS) {
        const int cc = i % CK, r = i / CK;
        const int n = r % NT, tap = r / NT;
        const int c = c0 + cc, gn = n0 + n;
        ws[(tap * CK + cc) * WSTRIDE + n] =
            (c < Cin && gn < Cout) ? wt[((size_t)(8 - tap) * Cout + gn) * Cin + c] : 0.0f;
      }
    } else {
      for (int i = tid; i < 9 * CK * NT; i += THREADS) {
        const int n = i % NT, r = i / NT;
        const int cc = r % CK, tap = r / CK;
        const int c = c0 + cc, gn = n0 + n;
        float v = 0.0f;
        if (c < Cin && gn < Cout) v = wt[((size_t)tap * Cin + c) * Cout + gn];
        ws[i] = v;  // WSTRIDE == NT here
      }
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      const float* xrow = &xs[((py + ky) * S::HW + px + kx) * CKP];
      const float* wrow = &ws[tap * CK * WSTRIDE + ng * 4];
#pragma unroll
      for (int cc = 0; cc < CK; ++cc) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xrow[i * CKP + cc];
        const float4 bw = *reinterpret_cast<const float4*>(wrow + cc * WSTRIDE);
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

  if (KG > 1) {
    // red[k-1][i*4+j][tid] over the staging buffers, which nobody reads any more
    float* red = smem;
    if (kg > 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) red[((kg - 1) * 16 + i * 4 + j) * THREADS + tid] = acc[i][j];
    }
    __syncthreads();
    if (kg > 0) return;
    for (int k = 1; k < KG; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += red[((k - 1) * 16 + i * 4 + j) * THREADS + tid];
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
      float v = acc[i][j];
      if (bias != nullptr) v += bias[n];
      if (res != nullptr) {
        float r = res[o + n];
        if (relu_res) r = fmaxf(r, 0.0f);
        v += r;
      }
      if (relu_out) v = fmaxf(v, 0.0f);
      if (gate != nullptr && !(gate[o + n] > 0.0f)) v = 0.0f;
      out[o + n] = v;
    }
  }
}

struct Args {
  const float *x, *in_gate, *wt, *bias, *res, *gate;
  float *out, *xg_out;
  int batch, H, W, Cin, Cout, relu_in, relu_res, relu_out;
  cudaStream_t stream;
};

template <int TPH, int TPW, int NT, int KG, bool FLIP>
void launch_kg(const Args& a, dim3 grid, int tiles_w) {
  using S = Shape<TPH, TPW, NT, FLIP>;
  constexpr int smem_bytes = KG * (S::XS + S::WS) * (int)sizeof(float);
  static_assert((KG - 1) * 16 * THREADS <= KG * (S::XS + S::WS), "the group sums must fit the staging buffers");
  auto kernel = conv3x3_kernel<TPH, TPW, NT, KG, FLIP>;
  if (smem_bytes > 48 * 1024) {  // above 48 KB a kernel has to opt in, once
    static const cudaError_t opted =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    (void)opted;
  }
  kernel<<<grid, THREADS * KG, smem_bytes, a.stream>>>(
      a.x, a.in_gate, a.wt, a.bias, a.res, a.gate, a.out, a.xg_out, a.H, a.W, a.Cin, a.Cout, tiles_w,
      a.relu_in, a.relu_res, a.relu_out);
}

constexpr int NUM_SMS = 132;  // H100: a grid of no more blocks than this takes K groups

template <int TPH, int TPW, int NT, bool FLIP>
void launch(const Args& a) {
  const int tiles_w = (a.W + TPW - 1) / TPW, tiles_h = (a.H + TPH - 1) / TPH;
  dim3 grid(tiles_w * tiles_h, (a.Cout + NT - 1) / NT, a.batch);
  const long blocks = (long)grid.x * grid.y * grid.z;
  if (blocks <= NUM_SMS && a.Cin >= 4 * CK) {
    launch_kg<TPH, TPW, NT, 4, FLIP>(a, grid, tiles_w);
  } else if (blocks <= NUM_SMS && a.Cin >= 2 * CK) {
    launch_kg<TPH, TPW, NT, 2, FLIP>(a, grid, tiles_w);
  } else {
    launch_kg<TPH, TPW, NT, 1, FLIP>(a, grid, tiles_w);
  }
}

}  // namespace

// w: (3, 3, Cin, Cout) contiguous, or with flip the forward's (3, 3, Cout, Cin);
// in_gate, bias, res, gate and xg_out may be NULL. Narrow outputs (Cout <= 16)
// take a 16x8-pixel tile with a 16-channel slice, wider ones an 8x8 tile with a
// 32-channel slice; both run 128 threads, times 2 or 4 K groups when the grid
// has no more blocks than the card has SMs and Cin is 32 or 64 and wider.
extern "C" int conv3x3_forward(const void* x, const void* in_gate, const void* w, const void* bias,
                               const void* res, const void* gate, void* out, void* xg_out,
                               int batch, int h, int w_, int cin, int cout,
                               int relu_in, int relu_res, int relu_out, int flip, void* stream) {
  const Args a{(const float*)x, (const float*)in_gate, (const float*)w, (const float*)bias,
               (const float*)res, (const float*)gate, (float*)out, (float*)xg_out,
               batch, h, w_, cin, cout, relu_in, relu_res, relu_out, (cudaStream_t)stream};
  if (cout <= 16) {
    if (flip) launch<16, 8, 16, true>(a); else launch<16, 8, 16, false>(a);
  } else {
    if (flip) launch<8, 8, 32, true>(a); else launch<8, 8, 32, false>(a);
  }
  return (int)cudaGetLastError();
}
