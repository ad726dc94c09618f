// The UNetPRes residual tail forward in one launch for Hopper (sm_90a), NHWC, fp32.
//
// Replaces: plastic_unet_tpu/ops/pallas_trunk.py::_tail_fwd_kernel (pl.pallas_call
// in make_residual_tail): two residual blocks and a ReLU with every
// intermediate kept in VMEM. Here, per sample:
//   pre11 = conv(relu(x0)) + b11
//   x1    = conv(relu(pre11)) + b12 + relu(x0)
//   pre21 = conv(relu(x1)) + b21
//   out   = relu(conv(relu(pre21)) + b22 + relu(x1))
// It reads x0, the four (3,3,C,C) weights and biases, and writes out; pre11,
// x1 and pre21 reach device memory only where the caller asks for them (the
// autograd save, the int8 calibration's ranges).
//
// What bounds it: at 101^2 x 16 and 50^2 x 32, B=128, the four convs are
// ~24 GFLOP against 167 MB of traffic (418 MB with the three kept tensors),
// so fp32 operations (~0.36 ms at 67 TFLOP/s). Four launches of the conv3x3
// kernel's square tiles (the "tile" family of ops/conv3x3.py::conv3x3_plan)
// moved pre11, x1 and pre21 through device memory twice each, and their inner
// loop is bound by shared-memory issue (4 scalar loads and one 16-byte load
// feed 16 FMAs).
//
// Design: one thread-block cluster a sample. Its nb blocks each own a band
// of rows [y0, y1) (balanced: y0 = rank * H / nb) and hold two band buffers
// in shared memory, each the band plus one halo row above and below, in rows
// of W + 1 pixel slots whose slot 0 is a zero column shared by a row's right
// and the next row's left edge (the conv3x3 whole-sample layout); a slot is
// C + 1 floats, so the 32 pixels a warp reads sit on distinct banks. The
// buffers hold the ReLU of what the next conv reads, which is also the skip
// each residual adds: A holds relu(x0), then relu(x1) written over it in place
// (the skip reads only the thread's own pixel); B holds relu(pre11), then
// relu(pre21), then out on its way to device memory. After each conv the
// band's first and last rows go into the neighbours' halo rows over
// distributed shared memory, and a cluster barrier makes them visible; halo
// rows outside the image are never written and stay zero, so every conv reads
// zero padding there. Nothing is recomputed. The weights stream through a
// two-stage ring of 16-input-channel slices by cp.async, the next slice in
// flight while this one is computed. A thread holds P pixels (pg, pg + PG,
// ...) x 16 consecutive output channels, a warp one channel group: per input
// channel P scalar loads and four 16-byte broadcast loads feed 16 * P FMAs
// (64 per 8 at P = 4, from the square tiles' 16 per 5). The epilogue leaves
// its values in the band buffer, and the band's rows then leave as they lie in
// memory, 16 bytes a thread (out, and the kept tensors), so the stores
// coalesce and the pushes to the neighbours are one loop over two rows
// (written pixel by pixel from registers, with the pushes inline, the epilogue
// took ~0.19 ms of 1.24 at 101^2 on an H100; PERF.md). The tilings
// (ops/residual_tail.py::tail_plan): 101^2 x 16 in 8 bands of <= 13 rows, 384
// threads; 50^2 x 32 in 5 bands of 10 rows, 256 threads. At one block an SM,
// clusters of 8 fill 120 SMs (15 bands of 7 rows: 105).
//
// Bits: every output is the square tiles' fmaf chain, 16-channel slices of
// Cin ascending, taps 0..8, channels within the slice; then + bias, then +
// relu(residual), then ReLU, operation for operation as conv3x3_kernel's
// epilogue. The intermediates stay fp32, so this launch gives the four
// launches' bits in out and in the kept tensors.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "residual_tail_common.cuh"

namespace {

struct Args {
  const float* x0;
  const float *w0, *w1, *w2, *w3;  // (3, 3, C, C) each, tap-major, Cout fastest
  const float *b0, *b1, *b2, *b3;
  float* out;
  float *pre11, *x1, *pre21;  // kept for the caller, or NULL
  int B, H, W, nb, rows;
};

// Issue the cp.async copies of one 16-channel input slice of one conv's
// weights into a ring stage, in the order the compute reads them: [tap][channel
// of the slice][Cout].
template <int C, int THREADS>
__device__ __forceinline__ void issue_slice(const float* __restrict__ w, int s, float* ws) {
  for (int e = threadIdx.x; e < 9 * CK * C; e += THREADS) {
    const int n = e % C, r = e / C, cc = r % CK, tap = r / CK;
    cp_async4(ws + e, w + ((size_t)tap * C + s * CK + cc) * C + n);
  }
}

// Block: band `rank` of sample b (blockIdx.x = b * nb + rank; the nb blocks of
// a sample are one cluster). Thread: channel group ng = tid / PG (a warp has
// one), pixels pg + i * PG of the band (pg = tid % PG); a pixel past the band
// computes pixel 0 again and stores nothing.
template <int C, int P, int THREADS>
__global__ void __launch_bounds__(THREADS, 1) residual_tail_kernel(const Args a) {
  constexpr int XCS = C + 1, NG = C / TN, PG = THREADS / NG, NS = C / CK, SSZ = 9 * CK * C;
  static_assert(C % TN == 0 && C % CK == 0 && PG % 32 == 0 && THREADS % C == 0, "thread grid");
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, rp = a.W + 1;
  const int xsz = (((a.rows + 2) * rp + 1) * XCS + 3) / 4 * 4;
  float* const bufA = smem;
  float* const bufB = smem + xsz;
  float* const wst = smem + 2 * xsz;  // two stages of one weight slice (SSZ floats) each
  const int rank = blockIdx.x % a.nb, b = blockIdx.x / a.nb;
  const int y0 = rank * a.H / a.nb, y1 = (rank + 1) * a.H / a.nb, rh = y1 - y0, npix = rh * a.W;
  const int rh_up = y0 - (rank - 1) * a.H / a.nb;  // rows of the band above (rank > 0)
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

  // Copies in flight first, one group each: the slab of x0 (the band and its
  // halo rows inside the image) with weight slice 0, then weight slice 1 (the
  // slices of the four convs in order, slice j in stage j % 2).
  const int lo = max(y0 - 1, 0), hi = min(y1 + 1, a.H), nslab = (hi - lo) * a.W;
  const float* const slab = a.x0 + ((size_t)b * a.H + lo) * a.W * C;
  for (Walk<C, THREADS> s(a.W); s.p < nslab; s.next(a.W))
    cp_async4(bufA + ((s.y + lo - y0 + 1) * rp + s.x + 1) * XCS + s.c, slab + (size_t)s.p * C + s.c);
  issue_slice<C, THREADS>(a.w0, 0, wst);
  cp_async_commit();
  issue_slice<C, THREADS>(NS > 1 ? a.w0 : a.w1, NS > 1 ? 1 : 0, wst + SSZ);
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
  cp_async_wait_group<1>();
  for (Walk<C, THREADS> s(a.W); s.p < nslab; s.next(a.W)) {  // ReLU on the copies this thread issued
    float* d = bufA + ((s.y + lo - y0 + 1) * rp + s.x + 1) * XCS + s.c;
    *d = fmaxf(*d, 0.0f);
  }

  float acc[P][TN];
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    const float* xs = (k & 1) ? bufB : bufA;  // conv k reads A, B, A, B
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int t = 0; t < TN; ++t) acc[i][t] = 0.0f;
    for (int s = 0; s < NS; ++s) {
      const int j = k * NS + s;  // the weight slice, in stage j % 2
      if (j > 0) cp_async_wait_group<1>();  // this thread's copies of slice j are in (slice j + 1's may not be)
      __syncthreads();                    // and every thread's
      conv_slice<C, P>(acc, xs + s * CK, wst + (j & 1) * SSZ, off, rp, n0);
      __syncthreads();  // every thread is past stage j % 2: slice j + 2 goes there
      const int jn = j + 2;
      if (jn < 4 * NS) issue_slice<C, THREADS>(pick(jn / NS, a.w0, a.w1, a.w2, a.w3), jn % NS, wst + (j & 1) * SSZ);
      cp_async_commit();  // a group for every slice, empty or not: the wait above counts on it
    }
    // The epilogue, first from registers: + bias, + the skip (convs 1 and 3:
    // relu(x0), relu(x1) at the thread's own pixel, in A), into the band's own
    // rows of the buffer conv k + 1 reads (B, A, B; conv 3's out into B, which
    // it has read): its ReLU, or the value itself where the caller keeps it.
    float* const loc = (k & 1) ? bufA : bufB;
    float* const kept = pick(k, a.pre11, a.x1, a.pre21, (float*)nullptr);
    const float* const bias = pick(k, a.b0, a.b1, a.b2, a.b3);
    const bool raw = kept != nullptr;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (!live[i]) continue;
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const int sl = off[i] * XCS + n0 + t;
        float v = acc[i][t];
        v += __ldg(bias + n0 + t);
        if (k & 1) v += bufA[sl];
        v = raw ? v : fmaxf(v, 0.0f);
        if (k & 1) bufA[sl] = v;
        else bufB[sl] = v;
      }
    }
    __syncthreads();
    // Then the band's rows as the memory holds them, 4 channels a thread and a
    // step: out (conv 3), or the kept values with their ReLU left in place.
    if (k == 3 || raw) {
      float* const g = (k == 3 ? a.out : kept) + ((size_t)b * a.H + y0) * a.W * C;
      for (Walk<C / 4, THREADS> w(a.W); w.p < npix; w.next(a.W)) {
        float* const d = loc + ((w.y + 1) * rp + w.x + 1) * XCS + 4 * w.c;
        const float4 v = make_float4(d[0], d[1], d[2], d[3]);
        *reinterpret_cast<float4*>(g + (size_t)w.p * C + 4 * w.c) = v;
        if (k < 3) {
          d[0] = fmaxf(v.x, 0.0f);
          d[1] = fmaxf(v.y, 0.0f);
          d[2] = fmaxf(v.z, 0.0f);
          d[3] = fmaxf(v.w, 0.0f);
        }
      }
    }
    if (k == 3) break;
    // The band's first and last rows into the halo rows of the neighbours
    // above and below, over distributed shared memory (the ReLU again: a
    // value may not have had it yet, and it changes none that has).
    if (k == 0) cluster_wait();  // every block of the cluster has started
    for (int side = 0; side < 2; ++side) {
      if (side == 0 ? rank == 0 : rank + 1 == a.nb) continue;
      float* const nbr = cluster.map_shared_rank(loc, side == 0 ? rank - 1 : rank + 1);
      const int from = (side == 0 ? 1 : rh) * rp + 1, to = (side == 0 ? rh_up + 1 : 0) * rp + 1;
      for (int e = tid; e < a.W * C; e += THREADS) {
        const int x = e / C, c = e % C;
        nbr[(to + x) * XCS + c] = fmaxf(loc[(from + x) * XCS + c], 0.0f);
      }
    }
    // the band and the halo rows it sent are complete everywhere in the cluster
    cluster_arrive();
    cluster_wait();
  }
}

template <int C, int P, int THREADS>
cudaError_t opt_in() {
  static const cudaError_t opted = [] {  // clusters of up to 16 blocks are beyond the portable 8
    auto kernel = residual_tail_kernel<C, P, THREADS>;
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
  return (int)cudaLaunchKernelEx(&cfg, residual_tail_kernel<C, P, THREADS>, a);
}

}  // namespace

// x0 (B, H, W, C) and the outputs contiguous, the outputs 16-byte aligned;
// w11..w22 (3, 3, C, C) contiguous; pre11, x1 and pre21 may be NULL (not
// kept). The caller's plan (ops/residual_tail.py::tail_plan) gives nb (bands
// a sample: the cluster), rows (the most rows a band has: ceil(H / nb)), px
// (pixels a thread), threads (a block's) and smem (bytes: two band buffers and
// two weight stages).
extern "C" int residual_tail_forward(const void* x0, const void* w11, const void* b11, const void* w12,
                                     const void* b12, const void* w21, const void* b21, const void* w22,
                                     const void* b22, void* out, void* pre11, void* x1, void* pre21, int batch,
                                     int h, int w, int c, int nb, int rows, int px, int threads, int smem,
                                     void* stream) {
  const Args a{(const float*)x0, (const float*)w11, (const float*)w12, (const float*)w21, (const float*)w22,
               (const float*)b11, (const float*)b12, (const float*)b21, (const float*)b22,
               (float*)out, (float*)pre11, (float*)x1, (float*)pre21, batch, h, w, nb, rows};
  // the (C, P, threads) tilings the plan may name (ops/residual_tail.py::FUSED_TILING)
  int code = (int)cudaErrorInvalidValue;
  if (c == 16 && px == 4 && threads == 384) code = launch<16, 4, 384>(a, smem, (cudaStream_t)stream);
  if (c == 32 && px == 4 && threads == 256) code = launch<32, 4, 256>(a, smem, (cudaStream_t)stream);
  if (code != 0) return code;
  return (int)cudaGetLastError();
}
