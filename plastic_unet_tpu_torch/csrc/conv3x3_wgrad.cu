// Weight and bias gradient of the 3x3 SAME stride-1 convolution for Hopper
// (sm_90a), NHWC, fp32.
//
// Replaces: the g.dw(...) and jnp.sum(d, axis=0) lines of
// plastic_unet_tpu/ops/pallas_trunk.py::_tail_bwd_kernel (_Geo.dw: per tap,
// shift_t(input)^T @ d over the whole flattened image):
//   dW[ky,kx,ci,co] = sum over b,y,x of act(in)[b, y+ky-1, x+kx-1, ci] * d[b,y,x,co]
//   db[co]          = sum over b,y,x of d[b,y,x,co]
// with zero outside the image and act = ReLU or identity, so the forward
// stores only pre-activations.
//
// What bounds it: at B=128 the 2*9*Cin*Cout*B*H*W fp32 operations (every
// level shape moves far fewer bytes than the FMAs take at 67 TFLOP/s); at
// B=1 it is a few microseconds of work, so latency: the serial chain of one
// block (stage, wait, compute) and a second launch for the chunk sums.
// Design, for both:
//  - Tiles of whole image rows. A tile is R consecutive rows of one sample at
//    full width, or S whole samples when a sample is small (12^2, 6^2); no
//    pixel outside the image is multiplied (rows past H are skipped). The
//    tile's input rows are staged with a one-pixel zero halo (rows outside
//    the image zero-filled by the copy, the two halo columns zeroed once),
//    so the inner loop slides a 3x3 window along x with no bounds test.
//  - 256-thread blocks, at most 128 registers (two blocks, 16 warps, per
//    SM). A thread owns 2 ci x 4 co x 9 taps = 72 sums; per pixel it loads
//    three float2 of input (one new window column) and one float4 of d for
//    72 FMAs, 18 per shared-memory load. Output tiles (ci slice x co slice)
//    of 16x16, 32x32 or 32x64 take 32, 128 or 256 threads, so the block
//    holds K = 8, 2 or 1 groups; group k takes the k-th column segment of
//    every row of the tile, and at the end group 0 adds the groups' sums
//    through shared memory in group order.
//  - cp.async (16 bytes, or 4 when Cin or Cout is not a multiple of 4) into
//    a two-stage ring: the next tile is in flight while this one is
//    computed. After the wait each thread applies the ReLU to, and adds into
//    the bias sums, the chunks it copied itself, so the inner loop does
//    neither.
//  - grid.x walks `chunks` runs of consecutive tiles, only as many as fill
//    the card; grid.y the (ci slice, co slice) pairs. With one chunk the
//    block writes the final array; otherwise each block writes its partial
//    sums to a workspace and wgrad_reduce adds the chunks in chunk order.
//    No atomics: the same bits on every run for one plan, and the plan
//    depends on the shapes only.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int NSUM = 72;  // 2 ci x 4 co x 9 taps per thread

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Copy VEC floats (16 or 4 bytes); with valid false it writes zeros and reads nothing.
template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  const int n = valid ? VEC * 4 : 0;
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(n));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

struct Params {
  const float *x, *d;
  float *w_out, *b_out;
  int B, H, W, Cin, Cout, R, S, tiles, chunks, co_tiles, relu, direct, oihw;
};

// n / d by a multiply and a shift, exact for n * d < 2^32 (d >= 1).
struct FastDiv {
  unsigned long long m;
  __device__ explicit FastDiv(int d) : m((1ull << 32) / (unsigned)d + 1) {}
  __device__ __forceinline__ int div(int n) const { return (int)(((unsigned long long)(unsigned)n * m) >> 32); }
};

// One tile: S samples x (R + 2) input rows (halo included) and S x R rows of
// d, each cut into copies of VEC floats. A thread takes copies tid, tid +
// THREADS, ... of the flattened tile, so it always holds the same channel
// chunk of a pixel (THREADS is a multiple of the copies per pixel).
template <int CI_T, int CO_T, int VEC>
struct Tile {
  static constexpr int NQX = CI_T / VEC, NQD = CO_T / VEC;  // copies per pixel
  static_assert(THREADS % NQX == 0 && THREADS % NQD == 0, "a thread keeps its channel chunk");

  // Issue the copies of tile (b0, y0) into stage (xs, ds).
  static __device__ __forceinline__ void stage(const Params& p, const FastDiv& by_w, const FastDiv& by_r2,
                                               const FastDiv& by_r, int b0, int y0, int ci0, int co0, float* xs,
                                               float* ds) {
    const int nx = p.S * (p.R + 2) * p.W * NQX;
    for (int i = threadIdx.x; i < nx; i += THREADS) {
      const int pix = i / NQX, c = (i % NQX) * VEC;
      const int row = by_w.div(pix), gx = pix - row * p.W;
      const int s = by_r2.div(row), b = b0 + s, gy = y0 - 1 + row - s * (p.R + 2);
      const bool v = b < p.B && gy >= 0 && gy < p.H && ci0 + c < p.Cin;
      const float* src = v ? p.x + (((size_t)b * p.H + gy) * p.W + gx) * p.Cin + ci0 + c : p.x;
      cp_async<VEC>(xs + (row * (p.W + 2) + gx + 1) * CI_T + c, src, v);  // column 0 is the left halo
    }
    const int nd = p.S * p.R * p.W * NQD;
    for (int i = threadIdx.x; i < nd; i += THREADS) {
      const int pix = i / NQD, n = (i % NQD) * VEC;
      const int row = by_w.div(pix), gx = pix - row * p.W;
      const int s = by_r.div(row), b = b0 + s, gy = y0 + row - s * p.R;
      const bool v = b < p.B && gy < p.H && co0 + n < p.Cout;
      const float* src = v ? p.d + (((size_t)b * p.H + gy) * p.W + gx) * p.Cout + co0 + n : p.d;
      cp_async<VEC>(ds + pix * CO_T + n, src, v);
    }
  }

  // After the wait: ReLU on this thread's own input copies, and its own d
  // copies added into its bias sums bsum[tid] (kept in shared memory to
  // spare registers).
  static __device__ __forceinline__ void own(const Params& p, const FastDiv& by_w, float* xs, const float* ds,
                                             float4* bsum) {
    if (p.relu) {
      const int nx = p.S * (p.R + 2) * p.W * NQX;
      for (int i = threadIdx.x; i < nx; i += THREADS) {
        const int pix = i / NQX, row = by_w.div(pix);
        float* e = xs + (pix + 2 * row + 1) * CI_T + (i % NQX) * VEC;  // row * (W + 2) + gx + 1
        if constexpr (VEC == 4) {
          float4 v = *reinterpret_cast<float4*>(e);
          v.x = fmaxf(v.x, 0.0f); v.y = fmaxf(v.y, 0.0f); v.z = fmaxf(v.z, 0.0f); v.w = fmaxf(v.w, 0.0f);
          *reinterpret_cast<float4*>(e) = v;
        } else {
          *e = fmaxf(*e, 0.0f);
        }
      }
    }
    if (bsum != nullptr) {
      const int nd = p.S * p.R * p.W * NQD;
      float4 b = bsum[threadIdx.x];
      for (int i = threadIdx.x; i < nd; i += THREADS) {
        const float* e = ds + (i / NQD) * CO_T + (i % NQD) * VEC;
        if constexpr (VEC == 4) {
          const float4 v = *reinterpret_cast<const float4*>(e);
          b.x += v.x; b.y += v.y; b.z += v.z; b.w += v.w;
        } else {
          b.x += *e;
        }
      }
      bsum[threadIdx.x] = b;
    }
  }
};

// One output pixel: c0, c1, c2 are the window's columns x-1, x, x+1 (rows ky).
__device__ __forceinline__ void fma_pixel(float (&acc)[2][4][9], const float2 (&c0)[3], const float2 (&c1)[3],
                                          const float2 (&c2)[3], const float4 dv) {
#pragma unroll
  for (int ky = 0; ky < 3; ++ky)
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const float2 a = kx == 0 ? c0[ky] : kx == 1 ? c1[ky] : c2[ky];
      const int t = ky * 3 + kx;
      acc[0][0][t] = fmaf(a.x, dv.x, acc[0][0][t]);
      acc[0][1][t] = fmaf(a.x, dv.y, acc[0][1][t]);
      acc[0][2][t] = fmaf(a.x, dv.z, acc[0][2][t]);
      acc[0][3][t] = fmaf(a.x, dv.w, acc[0][3][t]);
      acc[1][0][t] = fmaf(a.y, dv.x, acc[1][0][t]);
      acc[1][1][t] = fmaf(a.y, dv.y, acc[1][1][t]);
      acc[1][2][t] = fmaf(a.y, dv.z, acc[1][2][t]);
      acc[1][3][t] = fmaf(a.y, dv.w, acc[1][3][t]);
    }
}

__device__ __forceinline__ void load_col(float2 (&c)[3], const float* x, int XR) {
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) c[ky] = *reinterpret_cast<const float2*>(x + ky * XR);
}

template <int CI_T, int CO_T>
__global__ void __launch_bounds__(THREADS, 2) wgrad_kernel(const Params p, int vec) {
  constexpr int G = (CI_T / 2) * (CO_T / 4);  // threads of one group
  constexpr int K = THREADS / G;              // groups per block
  constexpr int RED = (K - 1) * NSUM * G;     // floats of the groups' sums
  constexpr int OUT = 9 * CI_T * (CO_T + 1);  // floats of the output tile
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, kg = tid / G, lt = tid % G;
  const int cp = lt % (CI_T / 2), cq = lt / (CI_T / 2);
  const int ci0 = (blockIdx.y / p.co_tiles) * CI_T, co0 = (blockIdx.y % p.co_tiles) * CO_T;
  const bool do_bias = blockIdx.y < p.co_tiles;  // the ci slice 0 owns db
  const int t_begin = (int)((long long)blockIdx.x * p.tiles / p.chunks);
  const int t_end = (int)((long long)(blockIdx.x + 1) * p.tiles / p.chunks);
  const int ntiles = t_end - t_begin;

  const int XR = (p.W + 2) * CI_T;
  const int XS = p.S * (p.R + 2) * XR, DS = p.S * p.R * p.W * CO_T;
  const int nstages = p.tiles > p.chunks ? 2 : 1;  // a chunk of two tiles or more needs the second
  // Shared memory: the ring of stages, later the groups' sums and the output
  // tile in their place; after all of them the bias sums, one float4 a thread.
  const int ring = nstages * (XS + DS);
  float4* bsum = do_bias ? reinterpret_cast<float4*>(smem + max(ring, max(RED, OUT))) : nullptr;
  if (do_bias) bsum[tid] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // The two halo columns of every staged input row are zero for good.
  for (int i = tid; i < nstages * p.S * (p.R + 2) * 2 * CI_T; i += THREADS) {
    const int c = i % CI_T, side = (i / CI_T) % 2, row = i / (2 * CI_T);  // row over all stages
    const int st = row / (p.S * (p.R + 2)), r = row % (p.S * (p.R + 2));
    smem[st * (XS + DS) + r * XR + side * (p.W + 1) * CI_T + c] = 0.0f;
  }

  float acc[2][4][9];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 9; ++t) acc[i][j][t] = 0.0f;

  // This group's column segment of every row.
  const int cw = (p.W + K - 1) / K;
  const int xa = min(p.W, kg * cw), xb = min(p.W, xa + cw);
  const int tps = (p.H + p.R - 1) / p.R;

  const FastDiv by_w(p.W), by_r2(p.R + 2), by_r(p.R);
  auto stage = [&](int t, float* st) {
    const int b0 = (t / tps) * p.S, y0 = (t % tps) * p.R;
    if (vec) Tile<CI_T, CO_T, 4>::stage(p, by_w, by_r2, by_r, b0, y0, ci0, co0, st, st + XS);
    else Tile<CI_T, CO_T, 1>::stage(p, by_w, by_r2, by_r, b0, y0, ci0, co0, st, st + XS);
  };
  stage(t_begin, smem);
  cp_async_commit();
  for (int i = 0; i < ntiles; ++i) {
    const int t = t_begin + i;
    if (i + 1 < ntiles) stage(t + 1, smem + ((i + 1) & 1) * (XS + DS));
    cp_async_commit();
    cp_async_wait1();
    float* xs = smem + (i & 1) * (XS + DS);
    const float* ds = xs + XS;
    if (vec) Tile<CI_T, CO_T, 4>::own(p, by_w, xs, ds, bsum);
    else Tile<CI_T, CO_T, 1>::own(p, by_w, xs, ds, bsum);
    __syncthreads();

    const int b0 = (t / tps) * p.S, y0 = (t % tps) * p.R;
    const int s_n = min(p.S, p.B - b0), r_n = min(p.R, p.H - y0);
    for (int s = 0; s < s_n; ++s) {
#pragma unroll 1
      for (int r = 0; r < r_n; ++r) {
        const float* xr = xs + (s * (p.R + 2) + r) * XR + 2 * cp;  // window row ky = 0
        const float* dr = ds + (s * p.R + r) * p.W * CO_T + 4 * cq;
        float2 w0[3], w1[3], w2[3];
        if (xa >= xb) continue;
        load_col(w0, xr + xa * CI_T, XR);  // staged column xa is image column xa - 1
        load_col(w1, xr + (xa + 1) * CI_T, XR);
        int x = xa;
#pragma unroll 1
        for (; x + 3 <= xb; x += 3) {
          load_col(w2, xr + (x + 2) * CI_T, XR);
          fma_pixel(acc, w0, w1, w2, *reinterpret_cast<const float4*>(dr + x * CO_T));
          load_col(w0, xr + (x + 3) * CI_T, XR);
          fma_pixel(acc, w1, w2, w0, *reinterpret_cast<const float4*>(dr + (x + 1) * CO_T));
          load_col(w1, xr + (x + 4) * CI_T, XR);
          fma_pixel(acc, w2, w0, w1, *reinterpret_cast<const float4*>(dr + (x + 2) * CO_T));
        }
        if (x < xb) {
          load_col(w2, xr + (x + 2) * CI_T, XR);
          fma_pixel(acc, w0, w1, w2, *reinterpret_cast<const float4*>(dr + x * CO_T));
          if (x + 1 < xb) {
            load_col(w0, xr + (x + 3) * CI_T, XR);
            fma_pixel(acc, w1, w2, w0, *reinterpret_cast<const float4*>(dr + (x + 1) * CO_T));
          }
        }
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

  // Groups 1..K-1 hand their sums to group 0 through the staging memory.
  if (K > 1) {
    float* red = smem;
    if (kg > 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int t = 0; t < 9; ++t) red[((kg - 1) * NSUM + (i * 4 + j) * 9 + t) * G + lt] = acc[i][j][t];
    }
    __syncthreads();
    if (kg == 0) {
      for (int k = 1; k < K; ++k)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int t = 0; t < 9; ++t) acc[i][j][t] += red[((k - 1) * NSUM + (i * 4 + j) * 9 + t) * G + lt];
    }
    __syncthreads();
  }

  float* wt = p.direct ? p.w_out : p.w_out + (size_t)blockIdx.x * 9 * p.Cin * p.Cout;
  float* bt = p.direct ? p.b_out : p.b_out + (size_t)blockIdx.x * p.Cout;
  const bool oihw = p.oihw;  // the partial sums too are in the caller's layout
  // The output tile goes through shared memory, so that the block's stores to
  // device memory are consecutive: (co, ci, tap) order for the torch layout,
  // else (tap, ci, co) with rows padded to CO_T + 1 against bank conflicts.
  float* out = smem;
  if (kg == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const int c = 2 * cp + i, n = 4 * cq + j;
          out[oihw ? (n * CI_T + c) * 9 + t : (t * CI_T + c) * (CO_T + 1) + n] = acc[i][j][t];
        }
  }
  if (do_bias && tid < (vec ? CO_T / 4 : CO_T)) {
    // thread q's chunk of d channels was kept by threads q, q + nqd, ...: added in that order
    const int nqd = vec ? CO_T / 4 : CO_T;
    float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int u = tid; u < THREADS; u += nqd) {
      const float4 v = bsum[u];
      b.x += v.x; b.y += v.y; b.z += v.z; b.w += v.w;
    }
    const float bv[4] = {b.x, b.y, b.z, b.w};
    for (int j = 0; j < (vec ? 4 : 1); ++j) {
      const int n = co0 + tid * (vec ? 4 : 1) + j;
      if (n < p.Cout) bt[n] = bv[j];
    }
  }
  __syncthreads();
  for (int e = tid; e < 9 * CI_T * CO_T; e += THREADS) {
    if (oihw) {
      const int t = e % 9, c = (e / 9) % CI_T, n = e / (9 * CI_T);
      if (ci0 + c < p.Cin && co0 + n < p.Cout) wt[((size_t)(co0 + n) * p.Cin + ci0 + c) * 9 + t] = out[e];
    } else {
      const int n = e % CO_T, c = (e / CO_T) % CI_T, t = e / (CO_T * CI_T);
      if (ci0 + c < p.Cin && co0 + n < p.Cout)
        wt[((size_t)t * p.Cin + ci0 + c) * p.Cout + co0 + n] = out[(t * CI_T + c) * (CO_T + 1) + n];
    }
  }
}

// Second stage: out[i] = sum over chunks, in chunk order, of the partials
// (which are in the output's layout).
// P threads share one output: part q adds chunks [q*chunks/P, (q+1)*chunks/P)
// and part 0 adds the P parts in order, so long chunk lists are read by
// several loads in flight at once.
template <int P>
__global__ void __launch_bounds__(THREADS) wgrad_reduce(const float* __restrict__ w_part,
                                                        const float* __restrict__ b_part, float* __restrict__ w_out,
                                                        float* __restrict__ b_out, int chunks, int Cin, int Cout) {
  constexpr int OUTS = THREADS / P;
  __shared__ float part[P][OUTS];
  const int nw = 9 * Cin * Cout;
  const int o = threadIdx.x % OUTS, q = threadIdx.x / OUTS;
  const int i = blockIdx.x * OUTS + o;
  const int k0 = q * chunks / P, k1 = (q + 1) * chunks / P;
  float s = 0.0f;
  if (i < nw) {
#pragma unroll 4
    for (int k = k0; k < k1; ++k) s += w_part[(size_t)k * nw + i];
  } else if (i < nw + Cout) {
#pragma unroll 4
    for (int k = k0; k < k1; ++k) s += b_part[(size_t)k * Cout + (i - nw)];
  }
  if (P > 1) {
    part[q][o] = s;
    __syncthreads();
    if (q > 0) return;
    s = part[0][o];
    for (int u = 1; u < P; ++u) s += part[u][o];
  }
  if (i < nw) {
    w_out[i] = s;
  } else if (i < nw + Cout) {
    b_out[i - nw] = s;
  }
}

constexpr int SMEM_MAX = 232448;  // bytes a block may use on an H100

template <int CI_T, int CO_T>
void launch(const Params& p, int smem_bytes, int vec, cudaStream_t s) {
  auto kernel = wgrad_kernel<CI_T, CO_T>;
  static const cudaError_t opted = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  (void)opted;
  const int ci_tiles = (p.Cin + CI_T - 1) / CI_T;
  kernel<<<dim3(p.chunks, ci_tiles * p.co_tiles), THREADS, smem_bytes, s>>>(p, vec);
}

}  // namespace

// x: (B,H,W,Cin), d: (B,H,W,Cout); w_out: (3,3,Cin,Cout), or (Cout,Cin,3,3) with
// oihw; b_out: (Cout,). The caller's plan (ops/conv3x3_wgrad.py::wgrad_plan)
// gives the output tile (ci_t x co_t: 16x16, 32x32 or 32x64), the tile of R
// rows x S samples, the tile count, the chunks and the shared memory of a
// block; for more than one chunk it gives the workspaces w_part
// (chunks,3,3,Cin,Cout) and b_part (chunks,Cout). vec: Cin and Cout are
// multiples of 4 and x, d are 16-byte aligned (16-byte copies).
extern "C" int conv3x3_wgrad(const void* x, const void* d, void* w_out, void* b_out, void* w_part, void* b_part,
                             int batch, int h, int w_, int cin, int cout, int ci_t, int co_t, int rows,
                             int samples, int tiles, int chunks, int smem_bytes, int vec, int relu_in, int oihw,
                             void* stream) {
  const int direct = chunks == 1;
  const int co_tiles = (cout + co_t - 1) / co_t;
  const Params p{(const float*)x, (const float*)d, (float*)(direct ? w_out : w_part),
                 (float*)(direct ? b_out : b_part), batch, h, w_, cin, cout, rows, samples, tiles, chunks,
                 co_tiles, relu_in, direct, oihw};
  cudaStream_t s = (cudaStream_t)stream;
  if (ci_t == 16 && co_t == 16) {
    launch<16, 16>(p, smem_bytes, vec, s);
  } else if (ci_t == 32 && co_t == 32) {
    launch<32, 32>(p, smem_bytes, vec, s);
  } else if (ci_t == 32 && co_t == 64) {
    launch<32, 64>(p, smem_bytes, vec, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || direct) return (int)err;
  const int n = 9 * cin * cout + cout;
  if (chunks >= 32) {
    wgrad_reduce<8><<<(n + THREADS / 8 - 1) / (THREADS / 8), THREADS, 0, s>>>(
        (const float*)w_part, (const float*)b_part, (float*)w_out, (float*)b_out, chunks, cin, cout);
  } else {
    wgrad_reduce<1><<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(
        (const float*)w_part, (const float*)b_part, (float*)w_out, (float*)b_out, chunks, cin, cout);
  }
  return (int)cudaGetLastError();
}
