// The UNetPRes residual tail backward in one launch (and a small second one)
// for Hopper (sm_90a), NHWC, fp32.
//
// Replaces: plastic_unet_tpu/ops/pallas_trunk.py::_tail_bwd_kernel (pl.pallas_call
// in make_residual_tail): the reverse chain of two residual blocks, every
// intermediate gradient kept in VMEM. Here, per sample, stage k = 0..3 takes
// the gradient d_k at the output of conv k of the reverse order (w22, w21,
// w12, w11) and the tensor a_k that conv read (pre21, x1, pre11, x0):
//   d_0 = d_x2    = g * (out > 0)
//   d_1 = d_pre21 = conv_T(d_x2, w22) * (pre21 > 0)
//   d_2 = d_x1    = (conv_T(d_pre21, w21) + d_x2) * (x1 > 0)
//   d_3 = d_pre11 = conv_T(d_x1, w12) * (pre11 > 0)
//   dx0           = (conv_T(d_pre11, w11) + d_x1) * (x0 > 0)
//   dW_k = sum over pixels of relu(a_k) (x) d_k (9 taps),  db_k = sum of d_k
// It reads g, out, pre21, x1, pre11, x0 and the four (3,3,C,C) weights and
// writes dx0, the four weight gradients in torch layout (C,C,3,3) and the four
// bias gradients. d_pre21 and d_pre11 never reach device memory; d_x2 and
// d_x1, which a later stage adds back, are parked in dx0's own rows.
//
// What bounds it: at 101^2 x 16 and 50^2 x 32, B=128, the eight convolution
// passes are ~48 GFLOP against ~585 MB of traffic, so fp32 operations (~0.72
// ms at 67 TFLOP/s). The chain it replaces took twelve launches (four
// conv3x3_dgrad square-tile launches, four conv3x3_wgrad launches each with a
// chunk reduction), moved d_x2, d_pre21, d_x1 and d_pre11 through device
// memory two or three times each, read every saved activation twice, and its
// dgrad's inner loop was bound by shared-memory issue.
//
// Design: the forward tail's (csrc/residual_tail.cu): one thread-block
// cluster a sample, nb blocks each owning a band of rows [y0, y1) (y0 = rank *
// H / nb), two band buffers in shared memory in the conv3x3 whole-sample
// layout (rows of W + 1 pixel slots of C + 1 floats, slot 0 a zero column
// shared by neighbouring rows; one halo row above and below). Stage k reads
// d_k from buffer IN (its band and halo rows) and writes d_{k+1} into the
// band rows of buffer OUT, which first holds relu(a_k) over the band: the
// weight gradient reads it there, and the epilogue gates each value by the
// slot it overwrites (relu(a) > 0 == a > 0), so a_k takes no buffer of its
// own. a_{k+1} is copied (cp.async) into IN's band rows as soon as stage k
// has read them, and lands while the halos move. The skips: d_x2 (stage 0)
// and d_x1 (stage 1) are written to dx0's rows, 16 bytes a thread, and read
// back by stages 1 and 3 (same block, same rows). After each stage the
// band's first and last rows go to the neighbours' halo rows over
// distributed shared memory, and the cluster adds the bands' weight-gradient
// sums. Shared memory holds two band buffers, one 16-channel weight slice
// and the stage's 9C^2 + C sums: a second ring stage would cost the band
// count that lets 15 clusters run at once (one weight slice a conv at C=16;
// at C=32 the second slice's copy is exposed once a stage).
//   The input gradient: as the forward's convs, a thread holds P pixels x 16
// output channels and the 16-channel weight slices (tap-reversed and
// transposed as they are staged) come by cp.async, the next one issued as
// soon as the last has been read.
//   The weight gradient: a thread holds 4 input x 2 output channels x 9 taps
// (72 sums) for one run of the band's pixels (row-major), the 3x3 window of
// d sliding along each row in registers: per pixel 6 + 4 scalar shared loads
// feed 72 FMAs. The lanes of a warp share one pixel, so its loads touch
// distinct banks (a layout of 4 pixels a warp, rows apart, had 3-way bank
// conflicts and ran the backward at half the eight launches' speed).
//
// Order of arithmetic (the same bits on every run, inside a CUDA graph too):
//  - dx0 and every d_k: each value is the conv3x3 square tiles' fmaf chain
//    (16-channel slices of Cin ascending, taps 0..8, channels within the
//    slice, from 0.0f), then + the skip, then the gate, operation for
//    operation as conv3x3_kernel with flip, so dx0 has the eight launches'
//    bits.
//  - dW_k[co][ci][tap] and db_k[co]: the band's pixels are cut into G runs
//    (run j: pixels [j*n/G, (j+1)*n/G) of the band's n, row-major; G = 12 at
//    C=16 on 384 threads, 2 at C=32 on 256), at C=32 each cut in two
//    halves; each run (half) is one fmaf chain in pixel order (db: an add
//    chain of d_k a row, the rows then added in order). The runs (the first
//    halves, then the second) are added through shared memory in G rounds, in
//    round q run w adding its column (w + q) % G of the 72 sums (the bias
//    sums in the last column), so column c takes the runs in the order c,
//    c - 1, ..., c + 1 (mod G); then the cluster's bands in rank order 0..nb-1
//    (block r adds the r-th share of the outputs over distributed shared
//    memory), written to a workspace (B, 4, 9C^2 + C); the second launch adds
//    the samples pairwise (a binary tree over 0..B-1, the last incomplete
//    subtrees from the smallest up). No atomics. The wgrad launches' chain (264
//    chunks across samples) is not this order, so dW and db do not have its
//    bits.
//
// The tilings (ops/residual_tail.py::tail_bwd_plan): 101^2 x 16 in 8 bands of
// <= 13 rows, 384 threads; 50^2 x 32 in 5 bands of 10 rows, 256 threads. One
// block an SM; the card runs 15 clusters of 8 at once and 22 of 5, but only 9
// of 9 (the first tiling, 9 bands, ran at half the eight launches' speed).
// Where the time goes at 101^2 x 16, B=128 (clock64 stamps a block, H100):
// the two loops ~68%, the runs' reduction and the warps' spread before it
// ~8%, stage 0's loads (one burst a wave) ~8%, parking, copies and pushes
// ~6%, cluster barriers ~3%.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "residual_tail_common.cuh"

namespace {

constexpr int REDUCE_THREADS = 256;

struct Args {
  const float *g, *out;
  const float *a0, *a1, *a2, *a3;  // what conv k of the reverse order read: pre21, x1, pre11, x0
  const float *w0, *w1, *w2, *w3;  // its (3, 3, C, C) weights, tap-major, Cout fastest: w22, w21, w12, w11
  float* dx0;
  float* ws;  // (B, 4, 9 C^2 + C): a sample's partial sums, stage by stage
  int B, H, W, nb, rows;
};

// Issue the cp.async copies of one 16-channel slice of the input gradient's
// weights into a ring stage, [tap][channel of the slice][output channel]: the
// forward's w[8 - tap][n][s * 16 + cc] (tap-reversed, transposed), read 16
// consecutive floats at a time.
template <int C, int THREADS>
__device__ __forceinline__ void issue_slice(const float* __restrict__ w, int s, float* ws) {
  for (int e = threadIdx.x; e < 9 * CK * C; e += THREADS) {
    const int cc = e % CK, r = e / CK, n = r % C, tap = r / C;
    cp_async4(ws + (tap * CK + cc) * C + n, w + ((size_t)(8 - tap) * C + n) * C + s * CK + cc);
  }
}

// The weight gradient's window: column x of d (2 output channels) at the rows
// above, at and below the pixel's.
struct Col {
  float v[3][2];
};

__device__ __forceinline__ void load_col(Col& c, const float* d, int rstride) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    c.v[r][0] = d[r * rstride];
    c.v[r][1] = d[r * rstride + 1];
  }
}

__device__ __forceinline__ void load_a(float (&av)[4], const float* a) {
#pragma unroll
  for (int i = 0; i < 4; ++i) av[i] = a[i];
}

// One pixel q of the weight gradient: dW[tap] += relu(a)[q] (x) d[q - tap's
// offset]; l, m, r are the window's columns x - 1, x, x + 1 (tap kx reads
// column x + 1 - kx, ky row y + 1 - ky), av relu(a)[q]; bs the bias sums
// of the row, += d[q]. Each sum takes one FMA a pixel, so the order of the taps within a
// pixel is free: the column loaded last (r) comes last.
__device__ __forceinline__ void wgrad_pixel(float (&acc)[4][2][9], float (&bs)[2], const Col& l, const Col& m,
                                            const Col& r, const float (&av)[4]) {
#pragma unroll
  for (int ky = 0; ky < 3; ++ky)
#pragma unroll
    for (int kx = 2; kx >= 0; --kx) {
      const Col& c = kx == 0 ? r : kx == 1 ? m : l;
      const int t = ky * 3 + kx;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0][t] = fmaf(av[i], c.v[2 - ky][0], acc[i][0][t]);
        acc[i][1][t] = fmaf(av[i], c.v[2 - ky][1], acc[i][1][t]);
      }
    }
  bs[0] += m.v[1][0];
  bs[1] += m.v[1][1];
}

// The band's rows of a band buffer (d_x2, d_x1: what a later stage adds
// back; or dx0) to device memory as they lie, 16 bytes a thread.
template <int C, int THREADS>
__device__ __forceinline__ void park(float* __restrict__ dst, const float* buf, int npix, int W) {
  constexpr int XCS = C + 1;
  for (Walk<C / 4, THREADS> w(W); w.p < npix; w.next(W)) {
    const float* d = buf + ((w.y + 1) * (W + 1) + w.x + 1) * XCS + 4 * w.c;
    *reinterpret_cast<float4*>(dst + (size_t)w.p * C + 4 * w.c) = make_float4(d[0], d[1], d[2], d[3]);
  }
}

// Block: band `rank` of sample b (blockIdx.x = b * nb + rank; the nb blocks of
// a sample are one cluster). Input gradient: thread (ng = tid / PG, pg = tid %
// PG) holds pixels pg + i * PG of the band (one past the band computes pixel
// 0 again and stores nothing) x channels [16 ng, 16 ng + 16). Weight
// gradient: run w / WPR of the band's pixels belongs to warps w; lane l holds
// input channels [4 ci4, 4 ci4 + 4), ci4 = (w % WPR) * 64 / C + l / (C / 2),
// and output channels 2 co2, 2 co2 + 1, co2 = l % (C / 2): a warp reads one
// pixel at a time, 2 x C / 2 distinct floats of d and 64 / C x 4 of a.
template <int C, int P, int THREADS>
__global__ void __launch_bounds__(THREADS, 1) tail_backward_kernel(const Args a) {
  constexpr int XCS = C + 1, NG = C / TN, PG = THREADS / NG, NS = C / CK, SSZ = 9 * CK * C;
  constexpr int N = 9 * C * C + C;  // a stage's sums: dW in the lanes' order (sum_index), then db
  constexpr int WPR = C * C / 256, G = THREADS / 32 / WPR;  // warps of a weight-gradient run; runs
  constexpr int NT = C * C / 8;                             // the run's threads (tiles of 4 x 2 channels)
  constexpr int SPLITS = C == 32 ? 2 : 1;  // a run's segments, each one chain (2 runs of 250 pixels at 50^2 x 32)
  static_assert(C % TN == 0 && C % CK == 0 && PG % 32 == 0 && THREADS % C == 0, "thread grid");
  static_assert((C == 16 || C == 32) && G >= 1 && THREADS % (32 * WPR) == 0, "weight-gradient thread grid");
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, rp = a.W + 1;
  const int xsz = (((a.rows + 2) * rp + 1) * XCS + 3) / 4 * 4;
  float* const bufP = smem;
  float* const bufQ = smem + xsz;
  float* const wst = smem + 2 * xsz;  // one weight slice (SSZ floats)
  float* const sums = wst + SSZ;      // the block's N sums of the stage
  const int rank = blockIdx.x % a.nb, b = blockIdx.x / a.nb;
  const int y0 = rank * a.H / a.nb, y1 = (rank + 1) * a.H / a.nb, rh = y1 - y0, npix = rh * a.W;
  const int rh_up = y0 - (rank - 1) * a.H / a.nb;  // rows of the band above (rank > 0)
  const size_t band0 = ((size_t)b * a.H + y0) * a.W * C;  // the band's first element in a tensor
  const int ng = tid / PG, pg = tid % PG, n0 = ng * TN;

  int off[P];
  bool live[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int p = pg + i * PG;
    live[i] = p < npix;
    const int pp = live[i] ? p : 0, q = pp / a.W;
    off[i] = (q + 1) * rp + pp - q * a.W + 1;
  }

  // The first weight slice in flight (the slices of the four convs in order
  // come one after the other through one buffer).
  issue_slice<C, THREADS>(a.w0, 0, wst);
  cp_async_commit();
  // Zero what is read and never written: every row's zero column (and the
  // one after the last row) in both buffers, and the halo rows outside the
  // image. Neighbours write only halo rows inside the image, and only after
  // the cluster's first barrier, which also tells them this block has started.
  for (int i = tid; i < 2 * (rh + 3) * XCS; i += THREADS) {
    const int buf = i / ((rh + 3) * XCS), r = i % ((rh + 3) * XCS);
    smem[buf * xsz + (r / XCS) * rp * XCS + r % XCS] = 0.0f;
  }
  for (int side = 0; side < 2; ++side) {
    if (side == 0 ? rank > 0 : rank + 1 < a.nb) continue;
    const int r0 = side == 0 ? 0 : rh + 1;
    for (int i = tid; i < 2 * a.W * XCS; i += THREADS) {
      const int buf = i / (a.W * XCS), e = i % (a.W * XCS);
      smem[buf * xsz + (r0 * rp + 1) * XCS + e] = 0.0f;
    }
  }
  cluster_arrive();
  // pre21 over the band into Q (its ReLU at stage 0's start), by cp.async;
  // meanwhile d_x2 = g * (out > 0) over the band and its halo rows inside the
  // image into P, as conv3x3's input gate makes it (the value, or 0), 16
  // bytes a load when g and out are 16-byte aligned
  for (Walk<C, THREADS> s(a.W); s.p < npix; s.next(a.W))
    cp_async4(bufQ + ((s.y + 1) * rp + s.x + 1) * XCS + s.c, a.a0 + band0 + (size_t)s.p * C + s.c);
  cp_async_commit();
  {
    const int lo = max(y0 - 1, 0), hi = min(y1 + 1, a.H), nslab = (hi - lo) * a.W;
    const size_t slab = ((size_t)b * a.H + lo) * a.W * C;
    if (((size_t)a.g | (size_t)a.out) % 16 == 0) {
      const float4* g4 = reinterpret_cast<const float4*>(a.g + slab);
      const float4* o4 = reinterpret_cast<const float4*>(a.out + slab);
      for (Walk<C / 4, THREADS> s(a.W); s.p < nslab;) {
        constexpr int U = 4;  // the loads of U steps in flight before their stores
        float4 gv[U], ov[U];
        int e[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          e[u] = s.p < nslab ? ((s.y + lo - y0 + 1) * rp + s.x + 1) * XCS + 4 * s.c : -1;
          if (e[u] >= 0) {
            gv[u] = __ldg(g4 + (size_t)s.p * (C / 4) + s.c);
            ov[u] = __ldg(o4 + (size_t)s.p * (C / 4) + s.c);
          }
          s.next(a.W);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (e[u] < 0) continue;
          float* d = bufP + e[u];
          d[0] = ov[u].x > 0.0f ? gv[u].x : 0.0f;
          d[1] = ov[u].y > 0.0f ? gv[u].y : 0.0f;
          d[2] = ov[u].z > 0.0f ? gv[u].z : 0.0f;
          d[3] = ov[u].w > 0.0f ? gv[u].w : 0.0f;
        }
      }
    } else {
      for (Walk<C, THREADS> s(a.W); s.p < nslab; s.next(a.W)) {
        const size_t o = slab + (size_t)s.p * C + s.c;
        const float gv = __ldg(a.g + o), ov = __ldg(a.out + o);
        bufP[((s.y + lo - y0 + 1) * rp + s.x + 1) * XCS + s.c] = ov > 0.0f ? gv : 0.0f;
      }
    }
    __syncthreads();
    park<C, THREADS>(a.dx0 + band0, bufP, npix, a.W);  // d_x2 for stage 1
  }

  float acc[P][TN];
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    float* const in = (k & 1) ? bufQ : bufP;    // d_k, band and halo rows
    float* const outb = (k & 1) ? bufP : bufQ;  // relu(a_k) over the band, then d_{k+1}
    // a_k's copies (issued before stage 0, or at the end of the last stage)
    // and every weight slice issued so far are in; then the ReLU over the
    // band's rows, 16 bytes a thread (the zero columns stay zero, and the
    // slots' pad floats are never read)
    cp_async_wait_group<0>();
    __syncthreads();
    {
      float* const lo = outb + rp * XCS;
      const int head = (4 - (int)(((size_t)lo / sizeof(float)) & 3)) & 3, n = rh * rp * XCS;
      if (tid < head) lo[tid] = fmaxf(lo[tid], 0.0f);
      float4* const v4 = reinterpret_cast<float4*>(lo + head);
      for (int e = tid; e < (n - head) / 4; e += THREADS) {
        float4 v = v4[e];
        v.x = fmaxf(v.x, 0.0f);
        v.y = fmaxf(v.y, 0.0f);
        v.z = fmaxf(v.z, 0.0f);
        v.w = fmaxf(v.w, 0.0f);
        v4[e] = v;
      }
      for (int e = head + (n - head) / 4 * 4 + tid; e < n; e += THREADS) lo[e] = fmaxf(lo[e], 0.0f);
    }
    __syncthreads();

    // The weight gradient of this warp's run of pixels, row by row.
    {
      const int lane = tid % 32, warp = tid / 32, run = warp / WPR, tile = (warp % WPR) * 32 + lane;
      const int ci4 = tile / (C / 2), co2 = tile % (C / 2);
      const int rs = rp * XCS, pb = run * npix / G, pe = (run + 1) * npix / G;
#pragma unroll 1
      for (int seg = 0; seg < SPLITS; ++seg) {
        float wa[4][2][9], bs[2] = {0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int t = 0; t < 9; ++t) wa[i][j][t] = 0.0f;
        const int re = pb + (seg + 1) * (pe - pb) / SPLITS;
#pragma unroll 1
        for (int p = pb + seg * (pe - pb) / SPLITS; p < re;) {
          const int y = p / a.W, xa = p - y * a.W, xb = min(a.W, xa + re - p);
          const float* dr = in + (y * rp + 1) * XCS + 2 * co2;          // window row 0, image column 0
          const float* ar = outb + ((y + 1) * rp + 1) * XCS + 4 * ci4;  // band row y, image column 0
          Col c0, c1, c2;
          float av[4], an[4];  // relu(a) at this pixel, and at the next (loaded a pixel ahead)
          float rb[2] = {0.0f, 0.0f};  // the row's bias sums, added to the run's at the row's end
          load_col(c0, dr + (xa - 1) * XCS, rs);
          load_col(c1, dr + xa * XCS, rs);
          load_a(av, ar + xa * XCS);
          int x = xa;
#pragma unroll 1
          for (; x + 3 <= xb; x += 3) {  // the slot after the row's last pixel is the next row's zero column
            load_col(c2, dr + (x + 1) * XCS, rs);
            load_a(an, ar + (x + 1) * XCS);
            wgrad_pixel(wa, rb, c0, c1, c2, av);
            load_col(c0, dr + (x + 2) * XCS, rs);
            load_a(av, ar + (x + 2) * XCS);
            wgrad_pixel(wa, rb, c1, c2, c0, an);
            load_col(c1, dr + (x + 3) * XCS, rs);
            load_a(an, ar + (x + 3) * XCS);
            wgrad_pixel(wa, rb, c2, c0, c1, av);
#pragma unroll
            for (int i = 0; i < 4; ++i) av[i] = an[i];
          }
          if (x < xb) {
            load_col(c2, dr + (x + 1) * XCS, rs);
            wgrad_pixel(wa, rb, c0, c1, c2, av);
            if (x + 1 < xb) {
              load_col(c0, dr + (x + 2) * XCS, rs);
              load_a(av, ar + (x + 1) * XCS);
              wgrad_pixel(wa, rb, c1, c2, c0, av);
            }
          }
          bs[0] += rb[0];
          bs[1] += rb[1];
          p += xb - xa;
        }
        if (seg == 0) cluster_wait();  // every block has read the last stage's sums (stage 0: every block has started)
        // The runs' sums into the block's: G rounds; in round q run w adds its
        // column (w + q) % G of the 72 (i, j, t) sums (and the bias sums, in
        // the last column), so every warp works in every round and column c
        // takes the runs in the order c, c - 1, ..., c + 1 (mod G).
        for (int q = 0; q < G; ++q) {
          const int col = (run + q) % G;
#pragma unroll
          for (int c = 0; c < G; ++c) {
            if (c != col) continue;
            constexpr int PER = (72 + G - 1) / G;
            float old[PER];
#pragma unroll
            for (int u = 0; u < PER; ++u)
              if (c * PER + u < 72) old[u] = seg == 0 && q == 0 ? 0.0f : sums[(c * PER + u) * NT + tile];
#pragma unroll
            for (int u = 0; u < PER; ++u) {
              const int f = c * PER + u;  // (i * 2 + j) * 9 + t
              if (f < 72) {
                const float v = wa[f / 18][f / 9 % 2][f % 9];
                sums[f * NT + tile] = seg == 0 && q == 0 ? v : old[u] + v;
              }
            }
            if (c == G - 1 && ci4 == 0) {
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                float* e = sums + 9 * C * C + 2 * co2 + j;
                *e = seg == 0 && q == 0 ? bs[j] : *e + bs[j];
              }
            }
          }
          __syncthreads();
        }
      }
    }

    // The input gradient, slice by slice through the weight ring.
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int t = 0; t < TN; ++t) acc[i][t] = 0.0f;
    for (int s = 0; s < NS; ++s) {
      const int j = k * NS + s;  // the weight slice
      cp_async_wait_group<0>();  // this thread's copies of slice j are in
      __syncthreads();           // and every thread's
      conv_slice<C, P>(acc, in + s * CK, wst, off, rp, n0);
      __syncthreads();  // every thread is past slice j: slice j + 1 goes there, landing while the stage ends
      if (j + 1 < 4 * NS) issue_slice<C, THREADS>(pick((j + 1) / NS, a.w0, a.w1, a.w2, a.w3), (j + 1) % NS, wst);
      cp_async_commit();
    }
    // The epilogue: + the skip (stages 1 and 3: d_x2 and d_x1, parked in
    // dx0's rows), then the gate relu(a_k) > 0, into the slot that held it.
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (!live[i]) continue;
      const size_t o = band0 + (size_t)(pg + i * PG) * C + n0;
      float* const sl = outb + off[i] * XCS + n0;
#pragma unroll
      for (int h = 0; h < TN; h += 8) {
        float r[8], gate[8];  // the loads of 8 channels in flight before their stores
#pragma unroll
        for (int t = 0; t < 8; ++t) gate[t] = sl[h + t];
        if (k & 1) {  // 16-byte aligned: dx0 is the wrapper's own, o a multiple of 16
          const float4 r0 = *reinterpret_cast<const float4*>(a.dx0 + o + h);
          const float4 r1 = *reinterpret_cast<const float4*>(a.dx0 + o + h + 4);
          r[0] = r0.x; r[1] = r0.y; r[2] = r0.z; r[3] = r0.w;
          r[4] = r1.x; r[5] = r1.y; r[6] = r1.z; r[7] = r1.w;
        }
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          float v = acc[i][h + t];
          if (k & 1) v += r[t];
          sl[h + t] = gate[t] > 0.0f ? v : 0.0f;
        }
      }
    }
    __syncthreads();
    if (k & 1) park<C, THREADS>(a.dx0 + band0, outb, npix, a.W);  // d_x1 for stage 3, or dx0 itself
    if (k < 3) {
      // a_{k+1} into IN's band rows, which this stage has read
      const float* const an = pick(k, a.a1, a.a2, a.a3, a.a3) + band0;
      for (Walk<C, THREADS> s(a.W); s.p < npix; s.next(a.W))
        cp_async4(in + ((s.y + 1) * rp + s.x + 1) * XCS + s.c, an + (size_t)s.p * C + s.c);
      cp_async_commit();
      // The band's first and last rows of d_{k+1} into the neighbours' halo
      // rows over distributed shared memory.
      for (int side = 0; side < 2; ++side) {
        if (side == 0 ? rank == 0 : rank + 1 == a.nb) continue;
        float* const nbr = cluster.map_shared_rank(outb, side == 0 ? rank - 1 : rank + 1);
        const int from = (side == 0 ? 1 : rh) * rp + 1, to = (side == 0 ? rh_up + 1 : 0) * rp + 1;
        for (int e = tid; e < a.W * C; e += THREADS) {
          const int x = e / C, c = e % C;
          nbr[(to + x) * XCS + c] = outb[(from + x) * XCS + c];
        }
      }
    }
    // the halo rows and every block's sums are complete everywhere in the cluster
    cluster_arrive();
    cluster_wait();
    // This block's share of the sample's sums: the bands' in rank order.
    {
      float* const dst = a.ws + ((size_t)b * 4 + k) * N;
      for (int e = rank * N / a.nb + tid; e < (rank + 1) * N / a.nb; e += THREADS) {
        float t[16];  // every band's value in flight, then added in rank order
#pragma unroll
        for (int q = 0; q < 16; ++q)
          if (q < a.nb) t[q] = *cluster.map_shared_rank(sums + e, q);
        float v = t[0];
#pragma unroll
        for (int q = 1; q < 16; ++q)
          if (q < a.nb) v += t[q];
        dst[e] = v;
      }
    }
    cluster_arrive();  // this block has read every block's sums; waited on before they are written again
  }
  cluster_wait();  // no block leaves while another reads its shared memory
}

// The samples' partial sums, pairwise over the samples: dW_k (C, C, 3, 3) and db_k.
__global__ void __launch_bounds__(REDUCE_THREADS) tail_backward_reduce(const float* __restrict__ ws, int B, int C,
                                                                       float* dw0, float* db0, float* dw1, float* db1,
                                                                       float* dw2, float* db2, float* dw3, float* db3) {
  const int n = 9 * C * C + C;
  const int i = blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (i >= 4 * n) return;
  const int k = i / n, e = i % n;
  const float* p = ws + (size_t)k * n + e;
  // pairwise: part[l] holds the sum of the last complete run of 2^l samples
  float part[17];
  for (int s = 0; s < B; ++s) {
    float v = p[(size_t)s * 4 * n];
    int l = 0;
    for (int c = s; c & 1; c >>= 1) v = part[l++] + v;
    part[l] = v;
  }
  float v = 0.0f;
  bool first = true;
  for (int l = 0; l < 17; ++l)
    if (B >> l & 1) {
      v = first ? part[l] : part[l] + v;
      first = false;
    }
  if (e < 9 * C * C) {  // sum (i, j, t) of tile (ci4, co2): dW[2 co2 + j][4 ci4 + i][t]
    const int nt = C * C / 8, tile = e % nt, t = e / nt % 9, ij = e / nt / 9;
    const int ci4 = tile / (C / 2), co2 = tile % (C / 2);
    pick(k, dw0, dw1, dw2, dw3)[((2 * co2 + ij % 2) * C + 4 * ci4 + ij / 2) * 9 + t] = v;
  } else {
    pick(k, db0, db1, db2, db3)[e - 9 * C * C] = v;
  }
}

template <int C, int P, int THREADS>
cudaError_t opt_in() {
  static const cudaError_t opted = [] {  // clusters of up to 16 blocks are beyond the portable 8
    auto kernel = tail_backward_kernel<C, P, THREADS>;
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    return e != cudaSuccess ? e : cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  return opted;
}

template <int C, int P, int THREADS>
int launch(const Args& a, int smem_bytes, cudaStream_t stream) {
  const cudaError_t opted = opt_in<C, P, THREADS>();
  if (opted != cudaSuccess) return (int)opted;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = a.nb;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.nb);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, tail_backward_kernel<C, P, THREADS>, a);
}

}  // namespace

// g, out, pre21, x1, pre11, x0 (B, H, W, C) contiguous; w22, w21, w12, w11
// (3, 3, C, C) contiguous (the forward's); dx0 (B, H, W, C) contiguous and
// 16-byte aligned; ws (B * 4 * (9 C^2 + C) floats); dw* (C, C, 3, 3) and db*
// (C,) contiguous. The caller's plan (ops/residual_tail.py::tail_bwd_plan)
// gives nb (bands a sample: the cluster), rows (the most rows a band has:
// ceil(H / nb)), px (pixels a thread), threads (a block's) and smem (bytes:
// two band buffers, two weight stages, the stage's sums).
extern "C" int residual_tail_backward(const void* g, const void* out, const void* pre21, const void* x1,
                                      const void* pre11, const void* x0, const void* w22, const void* w21,
                                      const void* w12, const void* w11, void* dx0, void* ws, void* dw22, void* db22,
                                      void* dw21, void* db21, void* dw12, void* db12, void* dw11, void* db11,
                                      int batch, int h, int w, int c, int nb, int rows, int px, int threads, int smem,
                                      void* stream) {
  const Args a{(const float*)g, (const float*)out, (const float*)pre21, (const float*)x1, (const float*)pre11,
               (const float*)x0, (const float*)w22, (const float*)w21, (const float*)w12, (const float*)w11,
               (float*)dx0, (float*)ws, batch, h, w, nb, rows};
  // the (C, P, threads) tilings the plan may name (ops/residual_tail.py::FUSED_TILING)
  int code = (int)cudaErrorInvalidValue;
  if (c == 16 && px == 4 && threads == 384) code = launch<16, 4, 384>(a, smem, (cudaStream_t)stream);
  if (c == 32 && px == 4 && threads == 256) code = launch<32, 4, 256>(a, smem, (cudaStream_t)stream);
  if (code != 0) return code;
  code = (int)cudaGetLastError();
  if (code != 0) return code;
  const int n = 4 * (9 * c * c + c);
  tail_backward_reduce<<<(n + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)ws, batch, c, (float*)dw22, (float*)db22, (float*)dw21, (float*)db21, (float*)dw12,
      (float*)db12, (float*)dw11, (float*)db11);
  return (int)cudaGetLastError();
}
