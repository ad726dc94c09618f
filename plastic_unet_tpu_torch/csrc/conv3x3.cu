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
// bound by fp32 operations (~90 us on H100 SXM at 67 TFLOP/s), not bytes;
// at B=1 by latency (grids of 8-91 blocks). An implicit GEMM, M = output
// pixels, N = Cout, K = 9 * Cin, on plain fp32 FMAs (no TF32, so parity with
// the fp32 reference holds). Every output is one fmaf chain in one order:
// 16-channel slices of Cin ascending, taps 0..8, channels within the slice;
// then bias, residual, ReLU / gate. Both families below keep that order, so
// they give the same bits. The caller's plan (ops/conv3x3.py::conv3x3_plan)
// picks the family from the shapes.
//
// Square tiles (B=1, and every level of side 50 and more): a block owns a
// 16x8 (Cout <= 16, 16-channel slice) or 8x8 (32-channel slice) pixel tile
// of one sample. Per 16-channel slice of Cin it stages the input tile with a
// 1-pixel halo (zero outside the image; ReLU applied on load when asked) and
// the weights of its slice in shared memory. Each of 128 threads
// accumulates 4 consecutive pixels x 4 output channels: per channel step, 4
// scalar shared loads and one 16-byte weight load feed 16 FMAs, so it is
// bound by shared-memory issue. The halo tile's channel stride is padded to
// 17 floats so the 4-pixel groups of a warp fall on distinct banks. At sides
// 25, 12 and 6 the square tiles pad to 32, 16 and 8 and 39-44% of the FMAs
// are wasted; small grids (B=1) take K groups instead (below).
//
// Whole samples (H*W <= 625 on grids larger than the card: 25^2, 12^2 and
// 6^2 at B=128): a tile is S whole samples, each with its own one-pixel zero
// halo, and a 32-channel slice of Cout; the output pixels are a flat list,
// so no pixel outside the image is computed but the rounding of the tile to
// the thread grid (10% at 12^2 and 6^2, 2% at 25^2). 256 threads each hold
// TP = 5 pixels (samples of up to 320 pixels) or 10 (up to 640; 25^2, one
// block an SM) x 8 channels; a thread keeps its pixels' halo slots in
// registers and a tap adds a constant. Per channel step TP scalar loads and
// two 16-byte weight loads feed TP * 8 FMAs (40 per 7 loads at TP = 5, from
// 16 per 5), and one staged weight slice feeds S * H * W pixels, not 64.
// 4-byte cp.async copies (zero-filled past B, Cin and Cout) fill a
// two-stage ring, so the next slice is in flight while this one is
// computed; each thread then applies ReLU and the input gate to the copies
// it issued itself (the gate's slice comes by cp.async too, into a buffer
// of its own). The halo is zeroed once and never copied: rows of W + 1
// slots share one zero column between a row's right and the next row's
// left edge. What bounds it now: the latency of 8-16 warps an SM on the
// shared-memory loads, and the ReLU/gate pass between two barriers (the
// dgrad with in_gate takes ~20% longer than with gate alone).

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

// ---------------------------------------------------------------------------
// The whole-sample family (small levels at large batch; see the note above).

constexpr int WS_THREADS = 256;
constexpr int TN = 8;        // output channels per thread
constexpr int XCS = CK + 1;  // channel stride of a staged pixel (17 floats: the pixels of a warp on distinct banks)

__device__ __forceinline__ unsigned smem_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// Copy one float (4 bytes); with valid false it writes a zero and reads nothing.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// n / d by a multiply and a shift, exact for n * d < 2^32 (d >= 1).
struct FastDiv {
  unsigned long long m;
  __device__ explicit FastDiv(int d) : m((1ull << 32) / (unsigned)d + 1) {}
  __device__ __forceinline__ int div(int n) const { return (int)(((unsigned long long)(unsigned)n * m) >> 32); }
};

struct WsArgs {
  const float *x, *in_gate, *wt, *bias, *res, *gate;
  float *out, *xg_out;
  int B, H, W, Cin, Cout, S, relu_in, relu_res, relu_out, vec;
};

// Stage layout of S samples: sample s, halo row r (0..H+1), column c (0..W)
// at pixel slot s*(H+2)*(W+1) + r*(W+1) + c, one slot more at the end, each
// slot XCS floats. Column 0 is the zero column on the left of a row and on the
// right of the row before it, so image pixel (y, x) sits at row y+1, column
// x+1, and tap (ky, kx) reads the slot (ky-1)*(W+1) + (kx-1) away from it.
// With in_gate, one more buffer (outside the ring) holds the gate's slice,
// pixel-major without halo.
struct WsGeo {
  int RP, XS, WS, HW, GS;  // row pitch (slots); floats of a stage's input and weights; pixels of a sample; gate floats
  __device__ WsGeo(const WsArgs& a, int wstride)
      : RP(a.W + 1), XS(((a.S * (a.H + 2) * (a.W + 1) + 1) * XCS + 3) / 4 * 4), WS(9 * CK * wstride),
        HW(a.H * a.W), GS(a.in_gate != nullptr ? a.S * a.H * a.W * CK : 0) {}
};

// The input elements a thread copies: channel tid % 16 of the tile pixels
// tid / 16, tid / 16 + 16, ... (WS_THREADS is a multiple of 16), walked
// without a division: pixel pix is column x of image row q (over the tile's
// samples), row r of sample s.
struct PixWalk {
  int pix, x, q, r, s, dx, dq;
  __device__ PixWalk(const WsArgs& a, const FastDiv& by_w, const FastDiv& by_h) {
    constexpr int STEP = WS_THREADS / CK;
    pix = threadIdx.x / CK;
    q = by_w.div(pix);
    x = pix - q * a.W;
    s = by_h.div(q);
    r = q - s * a.H;
    dq = STEP / a.W;
    dx = STEP - dq * a.W;
  }
  __device__ __forceinline__ int slot(int rp) const { return (q + 2 * s + 1) * rp + x + 1; }
  __device__ __forceinline__ void next(const WsArgs& a) {
    pix += WS_THREADS / CK;
    x += dx;
    int d = dq;
    if (x >= a.W) { x -= a.W; ++d; }
    q += d;
    r += d;
    while (r >= a.H) { r -= a.H; ++s; }
  }
};

template <int NT, bool FLIP>
struct WsStage {
  static constexpr int WSTRIDE = FLIP ? NT + 4 : NT;

  // Issue the copies of the 16-channel slice c0 into (xs, ws): the input of
  // the tile's samples (zero past B and past Cin) and the weights of the
  // block's Cout slice (zero past Cin and past Cout). The halo is never copied.
  static __device__ __forceinline__ void issue(const WsArgs& a, const WsGeo& g, const FastDiv& by_w,
                                               const FastDiv& by_h, int b0, int c0, int n0, float* xs, float* ws) {
    const int cc = threadIdx.x % CK, npix = a.S * g.HW;
    for (PixWalk p(a, by_w, by_h); p.pix < npix; p.next(a)) {
      const bool v = b0 + p.s < a.B && c0 + cc < a.Cin;
      cp_async4(xs + p.slot(g.RP) * XCS + cc, v ? a.x + ((size_t)b0 * g.HW + p.pix) * a.Cin + c0 + cc : a.x, v);
    }
    if constexpr (FLIP) {
      // The forward's (3,3,Cout,Cin) array read tap-reversed and transposed,
      // Cin fastest in memory and in the loop (see the tile family).
      for (int i = threadIdx.x; i < 9 * CK * NT; i += WS_THREADS) {
        const int c = c0 + i % CK, r = i / CK;
        const int n = r % NT, tap = r / NT, gn = n0 + n;
        const bool v = c < a.Cin && gn < a.Cout;
        cp_async4(ws + (tap * CK + i % CK) * WSTRIDE + n, v ? a.wt + ((size_t)(8 - tap) * a.Cout + gn) * a.Cin + c : a.wt,
                  v);
      }
    } else {
      for (int i = threadIdx.x; i < 9 * CK * NT; i += WS_THREADS) {
        const int n = i % NT, r = i / NT;
        const int c = c0 + r % CK, tap = r / CK, gn = n0 + n;
        const bool v = c < a.Cin && gn < a.Cout;
        cp_async4(ws + i, v ? a.wt + ((size_t)tap * a.Cin + c) * a.Cout + gn : a.wt, v);
      }
    }
  }

  // The gate's slice c0 for the same elements, into gs (index pix * 16 + cc).
  static __device__ __forceinline__ void issue_gate(const WsArgs& a, const WsGeo& g, int b0, int c0, float* gs) {
    const int cc = threadIdx.x % CK, npix = a.S * g.HW, nimg = (a.B - b0) * g.HW;
    for (int pix = threadIdx.x / CK; pix < npix; pix += WS_THREADS / CK) {
      const bool v = pix < nimg && c0 + cc < a.Cin;
      cp_async4(gs + pix * CK + cc, v ? a.in_gate + ((size_t)b0 * g.HW + pix) * a.Cin + c0 + cc : a.in_gate, v);
    }
  }

  // After the wait: ReLU and the input gate on the copies this thread issued
  // (the values the tile family stages), and the masked input written once to
  // xg_out by the blocks of the first Cout slice. Four copies at a time, their
  // loads issued together.
  static __device__ __forceinline__ void own(const WsArgs& a, const WsGeo& g, const FastDiv& by_w,
                                             const FastDiv& by_h, int b0, int c0, bool write_xg, float* xs,
                                             const float* gs) {
    const int cc = threadIdx.x % CK, npix = min(a.S, a.B - b0) * g.HW;
    if (c0 + cc >= a.Cin) return;
    PixWalk p(a, by_w, by_h);
    while (p.pix < npix) {
      int slot[4], pix[4];
      float v[4], gv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        pix[u] = p.pix < npix ? p.pix : -1;
        slot[u] = p.slot(g.RP) * XCS + cc;
        p.next(a);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[u] = pix[u] >= 0 ? xs[slot[u]] : 0.0f;
        gv[u] = pix[u] >= 0 && gs != nullptr ? gs[pix[u] * CK + cc] : 1.0f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (pix[u] < 0) continue;
        if (a.relu_in) v[u] = fmaxf(v[u], 0.0f);
        if (!(gv[u] > 0.0f)) v[u] = 0.0f;
        if (write_xg) a.xg_out[((size_t)b0 * g.HW + pix[u]) * a.Cin + c0 + cc] = v[u];
        xs[slot[u]] = v[u];
      }
    }
  }
};

// Block: S whole samples x an NT-wide slice of Cout. Thread: TP output pixels
// (tile pixels pg, pg + PG, ...) x TN consecutive channels; per channel step
// TP scalar loads and two float4 loads feed TP * 8 FMAs.
template <int NT, int TP, bool FLIP>
__global__ void __launch_bounds__(WS_THREADS, TP >= 8 ? 1 : 2) conv3x3_ws_kernel(const WsArgs a) {
  using St = WsStage<NT, FLIP>;
  constexpr int WSTRIDE = St::WSTRIDE;
  constexpr int NG = NT / TN, PG = WS_THREADS / NG;
  static_assert(NT % TN == 0 && WS_THREADS % NG == 0 && WS_THREADS % CK == 0, "thread grid");
  extern __shared__ __align__(16) float smem[];
  const WsGeo g(a, WSTRIDE);
  const int tid = threadIdx.x, ng = tid % NG, pg = tid / NG;
  const int b0 = blockIdx.x * a.S, n0 = blockIdx.y * NT;
  const int npix = min(a.S, a.B - b0) * g.HW;  // the tile's real output pixels
  const bool write_xg = a.xg_out != nullptr && blockIdx.y == 0;
  const bool own = a.relu_in || a.in_gate != nullptr || write_xg;
  const FastDiv by_w(a.W), by_h(a.H);
  const int stage_f = g.XS + g.WS;
  float* gs = a.in_gate != nullptr ? smem + 2 * stage_f : nullptr;

  // The slots of this thread's pixels; a slot past the tile's pixels computes
  // pixel 0 again and stores nothing.
  int off[TP], gp[TP];
#pragma unroll
  for (int i = 0; i < TP; ++i) {
    const int p = pg + i * PG;
    const bool live = p < npix;
    const int pp = live ? p : 0;
    const int q = by_w.div(pp), s = by_h.div(q);
    off[i] = (q + 2 * s + 1) * g.RP + (pp - q * a.W) + 1;
    gp[i] = live ? b0 * g.HW + p : -1;
  }

  // The halo slots (and the padding) of every stage are zero for good: the
  // copies write only image pixels.
  for (int i = tid; i < 2 * stage_f / 4; i += WS_THREADS)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();

  float acc[TP][TN];
#pragma unroll
  for (int i = 0; i < TP; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  // Copy groups, in the order committed: [slice 0 (+ its gate)], then per
  // step [slice step+1], and after the step's ReLU pass [gate of step+1],
  // so a wait for all but the newest group finds the step's slice and gate.
  const int steps = (a.Cin + CK - 1) / CK;
  St::issue(a, g, by_w, by_h, b0, 0, n0, smem, smem + g.XS);
  if (gs != nullptr) St::issue_gate(a, g, b0, 0, gs);
  cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    float* xs = smem + (step & 1) * stage_f;
    if (step + 1 < steps) {
      float* nx = smem + ((step + 1) & 1) * stage_f;
      St::issue(a, g, by_w, by_h, b0, (step + 1) * CK, n0, nx, nx + g.XS);
    }
    cp_async_commit();
    cp_async_wait1();
    if (own) St::own(a, g, by_w, by_h, b0, step * CK, write_xg, xs, gs);
    __syncthreads();
    if (gs != nullptr && step + 1 < steps) {  // the gate's buffer is free until the next step's pass
      St::issue_gate(a, g, b0, (step + 1) * CK, gs);
      cp_async_commit();
    }
    const float* ws = xs + g.XS;
    // The order of every output's FMA chain is the tile family's: slices
    // ascending, taps 0..8, channels within the slice.
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int delta = (tap / 3 - 1) * g.RP + tap % 3 - 1;
      const float* xp[TP];
#pragma unroll
      for (int i = 0; i < TP; ++i) xp[i] = xs + (off[i] + delta) * XCS;
      const float* wrow = ws + tap * CK * WSTRIDE + ng * TN;
#pragma unroll
      for (int cc = 0; cc < CK; ++cc) {
        float v[TP];
#pragma unroll
        for (int i = 0; i < TP; ++i) v[i] = xp[i][cc];
        const float4 w0 = *reinterpret_cast<const float4*>(wrow + cc * WSTRIDE);
        const float4 w1 = *reinterpret_cast<const float4*>(wrow + cc * WSTRIDE + 4);
        const float wv[TN] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < TP; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(v[i], wv[j], acc[i][j]);
      }
    }
    __syncthreads();  // the next step's copies overwrite this stage
  }

  // The epilogue of the tile family, element by element in its order; 16-byte
  // accesses where every operand allows them.
  const int nb = n0 + ng * TN;
#pragma unroll
  for (int i = 0; i < TP; ++i) {
    if (gp[i] < 0) continue;
    const size_t o = (size_t)gp[i] * a.Cout;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int n = nb + 4 * h;
      if (a.vec && n + 4 <= a.Cout) {
        float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
        if (a.bias != nullptr) {
          const float4 bv = *reinterpret_cast<const float4*>(a.bias + n);
          v.x += bv.x; v.y += bv.y; v.z += bv.z; v.w += bv.w;
        }
        if (a.res != nullptr) {
          float4 r = *reinterpret_cast<const float4*>(a.res + o + n);
          if (a.relu_res) { r.x = fmaxf(r.x, 0.0f); r.y = fmaxf(r.y, 0.0f); r.z = fmaxf(r.z, 0.0f); r.w = fmaxf(r.w, 0.0f); }
          v.x += r.x; v.y += r.y; v.z += r.z; v.w += r.w;
        }
        if (a.relu_out) { v.x = fmaxf(v.x, 0.0f); v.y = fmaxf(v.y, 0.0f); v.z = fmaxf(v.z, 0.0f); v.w = fmaxf(v.w, 0.0f); }
        if (a.gate != nullptr) {
          const float4 gv = *reinterpret_cast<const float4*>(a.gate + o + n);
          if (!(gv.x > 0.0f)) v.x = 0.0f;
          if (!(gv.y > 0.0f)) v.y = 0.0f;
          if (!(gv.z > 0.0f)) v.z = 0.0f;
          if (!(gv.w > 0.0f)) v.w = 0.0f;
        }
        *reinterpret_cast<float4*>(a.out + o + n) = v;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (n + j >= a.Cout) continue;
          float v = acc[i][4 * h + j];
          if (a.bias != nullptr) v += a.bias[n + j];
          if (a.res != nullptr) {
            float r = a.res[o + n + j];
            if (a.relu_res) r = fmaxf(r, 0.0f);
            v += r;
          }
          if (a.relu_out) v = fmaxf(v, 0.0f);
          if (a.gate != nullptr && !(a.gate[o + n + j] > 0.0f)) v = 0.0f;
          a.out[o + n + j] = v;
        }
      }
    }
  }
}

constexpr int SMEM_MAX = 232448;  // bytes a block may use on an H100

template <int NT, int TP, bool FLIP>
int launch_ws(const WsArgs& a, int smem_bytes, cudaStream_t stream) {
  auto kernel = conv3x3_ws_kernel<NT, TP, FLIP>;
  static const cudaError_t opted = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  (void)opted;
  dim3 grid((a.B + a.S - 1) / a.S, (a.Cout + NT - 1) / NT);
  kernel<<<grid, WS_THREADS, smem_bytes, stream>>>(a);
  return 0;
}

// The (NT, TP) variants the plan may name.
template <bool FLIP>
int launch_ws_variant(const WsArgs& a, int nt, int tp, int smem_bytes, cudaStream_t s) {
  if (nt == 32 && tp == 5) return launch_ws<32, 5, FLIP>(a, smem_bytes, s);
  if (nt == 32 && tp == 10) return launch_ws<32, 10, FLIP>(a, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

struct Args {
  const float *x, *in_gate, *wt, *bias, *res, *gate;
  float *out, *xg_out;
  int batch, H, W, Cin, Cout, relu_in, relu_res, relu_out;
  cudaStream_t stream;
};

template <int TPH, int TPW, int NT, int KG, bool FLIP>
void launch_kg(const Args& a) {
  using S = Shape<TPH, TPW, NT, FLIP>;
  constexpr int smem_bytes = KG * (S::XS + S::WS) * (int)sizeof(float);
  static_assert((KG - 1) * 16 * THREADS <= KG * (S::XS + S::WS), "the group sums must fit the staging buffers");
  auto kernel = conv3x3_kernel<TPH, TPW, NT, KG, FLIP>;
  if (smem_bytes > 48 * 1024) {  // above 48 KB a kernel has to opt in, once
    static const cudaError_t opted =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    (void)opted;
  }
  const int tiles_w = (a.W + TPW - 1) / TPW, tiles_h = (a.H + TPH - 1) / TPH;
  dim3 grid(tiles_w * tiles_h, (a.Cout + NT - 1) / NT, a.batch);
  kernel<<<grid, THREADS * KG, smem_bytes, a.stream>>>(
      a.x, a.in_gate, a.wt, a.bias, a.res, a.gate, a.out, a.xg_out, a.H, a.W, a.Cin, a.Cout, tiles_w,
      a.relu_in, a.relu_res, a.relu_out);
}

template <int TPH, int TPW, int NT, bool FLIP>
int launch(const Args& a, int kg) {
  if (kg == 4) launch_kg<TPH, TPW, NT, 4, FLIP>(a);
  else if (kg == 2) launch_kg<TPH, TPW, NT, 2, FLIP>(a);
  else if (kg == 1) launch_kg<TPH, TPW, NT, 1, FLIP>(a);
  else return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// w: (3, 3, Cin, Cout) contiguous, or with flip the forward's (3, 3, Cout, Cin);
// in_gate, bias, res, gate and xg_out may be NULL. The caller's plan
// (ops/conv3x3.py::conv3x3_plan) names the family and its tiling:
//   family 0, square tiles: nt 16 (16x8 pixels) or 32 (8x8 pixels), kg K groups;
//   family 1, whole samples: nt output channels and tp pixels a thread, `samples`
//   samples a tile, `smem` bytes of shared memory (two ring stages and, for
//   the dgrad, the gate's buffer); vec: Cout a multiple of 4 and the epilogue's
//   operands 16-byte aligned.
extern "C" int conv3x3_forward(const void* x, const void* in_gate, const void* w, const void* bias,
                               const void* res, const void* gate, void* out, void* xg_out,
                               int batch, int h, int w_, int cin, int cout,
                               int relu_in, int relu_res, int relu_out, int flip,
                               int family, int nt, int kg_or_tp, int samples, int smem, int vec,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int code;
  if (family == 1) {
    const WsArgs a{(const float*)x, (const float*)in_gate, (const float*)w, (const float*)bias,
                   (const float*)res, (const float*)gate, (float*)out, (float*)xg_out,
                   batch, h, w_, cin, cout, samples, relu_in, relu_res, relu_out, vec};
    code = flip ? launch_ws_variant<true>(a, nt, kg_or_tp, smem, s) : launch_ws_variant<false>(a, nt, kg_or_tp, smem, s);
  } else {
    const Args a{(const float*)x, (const float*)in_gate, (const float*)w, (const float*)bias,
                 (const float*)res, (const float*)gate, (float*)out, (float*)xg_out,
                 batch, h, w_, cin, cout, relu_in, relu_res, relu_out, s};
    if (nt == 16) code = flip ? launch<16, 8, 16, true>(a, kg_or_tp) : launch<16, 8, 16, false>(a, kg_or_tp);
    else if (nt == 32) code = flip ? launch<8, 8, 32, true>(a, kg_or_tp) : launch<8, 8, 32, false>(a, kg_or_tp);
    else code = (int)cudaErrorInvalidValue;
  }
  if (code != 0) return code;
  return (int)cudaGetLastError();
}
