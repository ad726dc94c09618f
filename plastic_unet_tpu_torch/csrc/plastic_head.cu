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
// outputs) for 264 MFLOP, so it is memory-bound (~8 us on H100 SXM); at B=1
// it is one launch and a few memory round trips.
//
// One launch for all B samples, in one of three tile families that
// ops/plastic_head.py::head_plan picks from the shapes alone:
//   "tile":   square 32x32 output tiles, 32x8 threads, k staged in 32-wide
//             steps (the first design; it takes any n).
//   "sample": one block of ~352 threads per sample (large B; n <= 128). The
//             sample's activin and hebb arrive by two flat cp.async copies,
//             16 bytes each but at the ends (rows of 4n bytes are not
//             16-byte aligned; the whole sample is), while w and alpha, the
//             same for every sample and so in L2, are loaded into registers.
//             activin is then transposed (k-major) in shared memory, four
//             rows a 16-byte store, and eff built over its flat copy. Each
//             thread holds 8 rows x 4 columns of outputs and reads per k two
//             float4 of activin and one of eff, the next k's before this k's
//             FMAs: 32 FMAs for 3 shared loads.
//   "spread": bands of rows x tiles of columns, ~128 blocks at B=1, one
//             output a thread. A block issues every copy (its rows of activin
//             and row 0, the column stripes of w, alpha and hebb; 4 bytes
//             each) before a single wait: one memory round trip.
// Row 0's outputs (y0) feed every trace update. In "sample" the block owns
// row 0; a "spread" block of a later band computes row 0 of its columns as an
// extra row, in the same chain order, so no block waits for another. The
// outputs leave through shared memory, consecutive threads on consecutive
// addresses, EPI at a time a thread. eta is read from device memory.
// Bits: every activ[b, r, c] is one fmaf chain over k = 0 .. n-1 in order
// from 0.0f in every family (the tiles' padded k add fmaf(0, 0, acc), which
// changes nothing), eff is w + a * h and sigmoid the same expression, and the
// staged families write the trace updates with the contractions the tile
// kernel's expressions compile to, so all three give the same bits.
// What holds the staged families back (head_phases.py times each phase of a
// block on the card): at one sample an SM the products take ~17k cycles,
// twice the ~9k that the SM's FP32 issue rate allows for their FMAs, and the
// phases around them (copies, transpose, eff, stores) run one after another.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int ROWS = 8;               // threadIdx.y extent
constexpr int PER_T = TILE / ROWS;    // output rows per thread
constexpr int SMEM_MAX = 232448;      // bytes a block may use on an H100
constexpr int WQ = 8;                 // "sample": quads of w and of alpha a thread holds
constexpr int EPI = 8;                // outputs a thread finishes at once

__device__ __forceinline__ float sigmoidf(float v) { return 1.0f / (1.0f + expf(-v)); }

// ---------------------------------------------------------------------------
// The "tile" family.

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
int launch_tile(const float* x, const float* w, const float* alpha, const float* eta, const float* hebb,
                float* activ, float* activout, float* hebb_out, int batch, int n, cudaStream_t s) {
  const int tiles = (n + TILE - 1) / TILE;
  dim3 grid(tiles, tiles, batch), block(TILE, ROWS);
  plastic_head_kernel<OJA, SCALAR_ALPHA><<<grid, block, 0, s>>>(x, w, alpha, eta, hebb, activ, activout,
                                                              hebb_out, n);
  return 0;
}

// ---------------------------------------------------------------------------
// The "sample" and "spread" families: one kernel, staged operands.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Copy `count` contiguous floats from src to buf + m, m = the misalignment of
// src in floats (0..3), so that both sides of the middle part are 16-byte
// aligned: 16-byte copies there, 4-byte ones at the ends. Returns m.
__device__ __forceinline__ int copy_flat(float* buf, const float* src, int count) {
  const int m = static_cast<int>((reinterpret_cast<size_t>(src) >> 2) & 3);
  const int head = min((4 - m) & 3, count), quads = (count - head) >> 2;
  float* dst = buf + m;
  for (int i = threadIdx.x; i < quads; i += blockDim.x) cp_async16(dst + head + 4 * i, src + head + 4 * i);
  for (int i = threadIdx.x; i < head; i += blockDim.x) cp_async4(dst + i, src + i);
  for (int i = head + 4 * quads + threadIdx.x; i < count; i += blockDim.x) cp_async4(dst + i, src + i);
  return m;
}

template <int N>
__device__ __forceinline__ void load_vec(float (&v)[N], const float* p) {  // p aligned to N floats
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = t.x, v[4 * i + 1] = t.y, v[4 * i + 2] = t.z, v[4 * i + 3] = t.w;
    }
  } else {
    static_assert(N == 1, "load_vec: 1 or a multiple of 4 floats");
    v[0] = p[0];
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[N]) {  // p aligned to N floats
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<float4*>(p)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = v[i];
  }
}

template <int TR, int TC>
__device__ __forceinline__ void fma_tile(float (&acc)[TR][TC], const float (&xv)[TR], const float (&ev)[TC]) {
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(xv[i], ev[j], acc[i][j]);
}

// What the plan (ops/plastic_head.py::head_plan) fixes for one launch.
struct StArgs {
  const float *x, *w, *alpha, *eta, *hebb;
  float *activ, *activout, *hebb_out;
  int n;
  int br, bc;  // rows of a band, columns of a tile (n and n in "sample")
  int xs, es;  // strides (floats) of the staged activin (k-major) and of the staged eff
};

// Grid (column tiles, row bands, samples). Local rows: lr < nb is row r0 + lr
// of the band; in a band after the first, lr == nb is row 0. TR x TC outputs
// a thread, rows lr0.., columns lc0... Shared memory, in floats (offsets
// multiples of 4; HB = n * n + 3 rounded up to 4, room for a flat matrix
// copied at its misalignment):
//  WHOLE ("sample")                       | "spread"
//  eb  max(n*ES, HB)  x flat, then eff    | xs  max(n*XS, br*ES) activin k-major, then the band's activ
//  hf  HB             hebb[b] flat        | es  n*ES  w[k, c0 + lc], then eff in place
//  wf  HB             w flat              | as  n*ES  alpha[k, c0 + lc] (alpha a matrix)
//  af  HB             alpha flat (matrix) | hs  n*ES  hebb[b, k, c0 + lc]
//  xs  max(n*XS, n*ES) activin k-major, then activ
//  x0s, y0s: activin[b, 0, r0 + lr] (br, rounded up to 4 in WHOLE) and activout[b, 0, c0 + lc] (ES).
template <bool OJA, bool SCALAR_ALPHA, bool WHOLE, int TR, int TC, int KU, int MAXT>
__global__ void __launch_bounds__(MAXT) plastic_head_staged(const StArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int n = a.n, XS = a.xs, ES = a.es;
  const int c0 = blockIdx.x * a.bc, r0 = blockIdx.y * a.br;
  const int nb = min(a.br, n - r0), nc = min(a.bc, n - c0);
  const int lz = r0 == 0 ? 0 : nb;  // the local row of the sample's row 0
  const size_t base = (size_t)blockIdx.z * n * n;
  const float* xb = a.x + base;
  const float* hb = a.hebb + base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const float a_scalar = SCALAR_ALPHA ? a.alpha[0] : 0.0f;
  float *xs, *es, *x0s, *y0s, *hs;  // hs: row r0 + lr of hebb's stripe at hs + lr * hstride
  int hstride;

  if constexpr (WHOLE) {
    const int nn = n * n, HB = (nn + 6) / 4 * 4;
    float* eb = smem;
    float* hf = eb + max(n * ES, HB);
    xs = hf + HB;
    x0s = xs + max(n * XS, n * ES);
    y0s = x0s + (n + 3) / 4 * 4;
    es = eb;
    // activin and hebb: two flat copies, mostly 16 bytes each. w and alpha (the same for every
    // sample, so in L2) into registers meanwhile: WQ quads of each a thread, which the plan ensures.
    const int mx = copy_flat(eb, xb, nn);
    const int mh = copy_flat(hf, hb, nn);
    cp_async_commit();
    float4 wq[WQ], aq[WQ];
    const bool vec = ((reinterpret_cast<size_t>(a.w) | (SCALAR_ALPHA ? 0 : reinterpret_cast<size_t>(a.alpha))) & 15) == 0;
#pragma unroll
    for (int i = 0; i < WQ; ++i) {
      const int j = 4 * (tid + i * blockDim.x);
      if (j + 3 < nn && vec) {
        wq[i] = *reinterpret_cast<const float4*>(a.w + j);
        if (!SCALAR_ALPHA) aq[i] = *reinterpret_cast<const float4*>(a.alpha + j);
      } else if (j < nn) {
        float t[2][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          t[0][u] = j + u < nn ? a.w[j + u] : 0.0f;
          t[1][u] = j + u < nn && !SCALAR_ALPHA ? a.alpha[j + u] : 0.0f;
        }
        wq[i] = make_float4(t[0][0], t[0][1], t[0][2], t[0][3]);
        aq[i] = make_float4(t[1][0], t[1][1], t[1][2], t[1][3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    // activin k-major: four rows at a time (a warp a group, lanes along k), a 16-byte store
    // each; row 0 kept for the trace update.
    for (int r = 4 * warp; r < n; r += 4 * nwarps) {
      const float* row = eb + mx + r * n;
      for (int k = lane; k < n; k += 32) {
        float4 v;
        v.x = row[k];
        v.y = r + 1 < n ? row[n + k] : 0.0f;
        v.z = r + 2 < n ? row[2 * n + k] : 0.0f;
        v.w = r + 3 < n ? row[3 * n + k] : 0.0f;
        *reinterpret_cast<float4*>(xs + k * XS + r) = v;
      }
    }
    for (int r = tid; r < n; r += blockDim.x) x0s[r] = eb[mx + r];
    __syncthreads();
    // eff over the flat x, which is read no more: each thread its quads.
#pragma unroll
    for (int i = 0; i < WQ; ++i) {
      const int j = 4 * (tid + i * blockDim.x);
      if (j >= nn) continue;
      const float wv[4] = {wq[i].x, wq[i].y, wq[i].z, wq[i].w}, av[4] = {aq[i].x, aq[i].y, aq[i].z, aq[i].w};
      int k = j / n, c = j - k * n;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (j + u < nn) {
          const float al = SCALAR_ALPHA ? a_scalar : av[u];
          es[k * ES + c] = wv[u] + al * hf[mh + j + u];
        }
        if (++c == n) c = 0, ++k;
      }
    }
    hs = hf + mh;
    hstride = n;
  } else {
    xs = smem;
    es = xs + max(n * XS, a.br * ES);
    float* as = es + n * ES;
    hs = as + (SCALAR_ALPHA ? 0 : n * ES);
    x0s = hs + n * ES;
    y0s = x0s + a.br;
    // Every copy (4 bytes each) before a single wait: activin's rows (a warp a
    // row, lanes along k), row 0's band segment, and the column stripes.
    for (int lr = warp; lr < nb + (r0 > 0); lr += nwarps) {
      const float* src = xb + (size_t)(lr < nb ? r0 + lr : 0) * n;
      for (int k = lane; k < n; k += 32) cp_async4(xs + k * XS + lr, src + k);
    }
    for (int lr = tid; lr < nb; lr += blockDim.x) cp_async4(x0s + lr, xb + r0 + lr);
    const int dq = blockDim.x / nc, dr = blockDim.x - dq * nc;  // (k, lc) of i = tid, tid + T, ...
    for (int i = tid, k = tid / nc, lc = tid - tid / nc * nc; i < n * nc; i += blockDim.x) {
      const size_t j = (size_t)k * n + c0 + lc;
      cp_async4(es + k * ES + lc, a.w + j);
      if (!SCALAR_ALPHA) cp_async4(as + k * ES + lc, a.alpha + j);
      cp_async4(hs + k * ES + lc, hb + j);
      lc += dr, k += dq;
      if (lc >= nc) lc -= nc, ++k;
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    for (int i = tid, k = tid / nc, lc = tid - tid / nc * nc; i < n * nc; i += blockDim.x) {
      const int e = k * ES + lc;
      const float al = SCALAR_ALPHA ? a_scalar : as[e];
      es[e] = es[e] + al * hs[e];
      lc += dr, k += dq;
      if (lc >= nc) lc -= nc, ++k;
    }
    hs += r0 * ES;
    hstride = ES;
  }
  __syncthreads();

  // The products: one fmaf chain per output over k = 0 .. n-1, the next KU k's
  // operands loaded before this KU k's FMAs.
  const int ct_n = (a.bc + TC - 1) / TC;
  const int rt_n = (a.br + (n > a.br) + TR - 1) / TR;
  const bool computes = tid < rt_n * ct_n;
  const int lr0 = (tid / ct_n) * TR, lc0 = (tid % ct_n) * TC;
  float acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.0f;
  if (computes) {
    const float* xp = xs + lr0;
    const float* ep = es + lc0;
    if constexpr (KU == 1) {
      float xa[TR], ea[TC], xb2[TR], eb2[TC];
      load_vec<TR>(xa, xp);
      load_vec<TC>(ea, ep);
      int k = 0;
      for (; k + 2 <= n; k += 2) {
        load_vec<TR>(xb2, xp + (k + 1) * XS);
        load_vec<TC>(eb2, ep + (k + 1) * ES);
        fma_tile<TR, TC>(acc, xa, ea);
        if (k + 2 < n) {
          load_vec<TR>(xa, xp + (k + 2) * XS);
          load_vec<TC>(ea, ep + (k + 2) * ES);
        }
        fma_tile<TR, TC>(acc, xb2, eb2);
      }
      if (k < n) fma_tile<TR, TC>(acc, xa, ea);
    } else {  // KU k steps at a time: their loads together, then their FMAs in k order
      int k = 0;
      for (; k + KU <= n; k += KU) {
        float xv[KU][TR], ev[KU][TC];
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          load_vec<TR>(xv[u], xp + (k + u) * XS);
          load_vec<TC>(ev[u], ep + (k + u) * ES);
        }
#pragma unroll
        for (int u = 0; u < KU; ++u) fma_tile<TR, TC>(acc, xv[u], ev[u]);
      }
      for (; k < n; ++k) {
        float xv[TR], ev[TC];
        load_vec<TR>(xv, xp + k * XS);
        load_vec<TC>(ev, ep + k * ES);
        fma_tile<TR, TC>(acc, xv, ev);
      }
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      if (lr0 + i != lz) continue;
#pragma unroll
      for (int j = 0; j < TC; ++j)
        if (lc0 + j < nc) y0s[lc0 + j] = sigmoidf(acc[i][j]);
    }
  }
  __syncthreads();  // xs is read no more; y0s is complete
  float* st = xs;   // st[lr * ES + lc] = activ of band row lr
  if (computes) {
#pragma unroll
    for (int i = 0; i < TR; ++i)
      if (lr0 + i < nb) store_vec<TC>(st + (lr0 + i) * ES + lc0, acc[i]);
  }
  __syncthreads();

  // Flat over the band's outputs, consecutive threads on consecutive ones; each thread loads the
  // operands of EPI outputs before it computes and stores any.
  const float et = a.eta[0];
  const int per = nb * nc, T = blockDim.x;
  const int dq = T / nc, dr = T - dq * nc;
  int lr = tid / nc, lc = tid - lr * nc;
  const size_t band = base + (size_t)r0 * n + c0;
  for (int e0 = tid; e0 < per; e0 += EPI * T) {
    float v[EPI], h[EPI], y[EPI], x0[EPI];
    int off[EPI];
#pragma unroll
    for (int u = 0; u < EPI; ++u) {
      if (e0 + u * T < per) {
        v[u] = st[lr * ES + lc], h[u] = hs[lr * hstride + lc], y[u] = y0s[lc], x0[u] = x0s[lr];
        off[u] = lr * n + lc;
      }
      lc += dr, lr += dq;
      if (lc >= nc) lc -= nc, ++lr;
    }
#pragma unroll
    for (int u = 0; u < EPI; ++u) {
      if (e0 + u * T >= per) continue;
      const size_t o = band + off[u];
      a.activ[o] = v[u];
      a.activout[o] = sigmoidf(v[u]);
      // The tile kernel's trace updates with the contractions nvcc gives them there (left to
      // itself it contracts the hebb rule the other way round here):
      // oja h + et * (x0 - h * y0) * y0, hebb (1 - et) * h + et * (x0 * y0).
      a.hebb_out[o] = OJA ? fmaf(et * fmaf(-h[u], y[u], x0[u]), y[u], h[u])
                          : fmaf(1.0f - et, h[u], et * (x0[u] * y[u]));
    }
  }
}

// The thread tiles of the two staged families; ops/plastic_head.py holds the same numbers.
// KU: the k steps whose operands are loaded ahead of their FMAs.
constexpr int SAMPLE_TR = 8, SAMPLE_TC = 4, SAMPLE_KU = 1, SAMPLE_MAXT = 512;
constexpr int SPREAD_TR = 1, SPREAD_TC = 1, SPREAD_KU = 8, SPREAD_MAXT = 128;

template <bool OJA, bool SCALAR_ALPHA, bool WHOLE, int TR, int TC, int KU, int MAXT>
int launch_staged(const StArgs& a, int batch, int threads, int smem, cudaStream_t s) {
  auto kernel = plastic_head_staged<OJA, SCALAR_ALPHA, WHOLE, TR, TC, KU, MAXT>;
  static const cudaError_t opted = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (opted != cudaSuccess) return (int)opted;
  if (threads > MAXT || threads % 32 != 0 || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  dim3 grid((a.n + a.bc - 1) / a.bc, (a.n + a.br - 1) / a.br, batch);
  kernel<<<grid, threads, smem, s>>>(a);
  return 0;
}

template <bool OJA, bool SCALAR_ALPHA>
int launch(int family, const StArgs& a, int batch, int threads, int smem, cudaStream_t s) {
  if (family == 0)
    return launch_tile<OJA, SCALAR_ALPHA>(a.x, a.w, a.alpha, a.eta, a.hebb, a.activ, a.activout, a.hebb_out,
                                          batch, a.n, s);
  if (family == 1)
    return launch_staged<OJA, SCALAR_ALPHA, true, SAMPLE_TR, SAMPLE_TC, SAMPLE_KU, SAMPLE_MAXT>(a, batch, threads, smem, s);
  if (family == 2)
    return launch_staged<OJA, SCALAR_ALPHA, false, SPREAD_TR, SPREAD_TC, SPREAD_KU, SPREAD_MAXT>(a, batch, threads, smem, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// family 0 "tile" (the plan's other fields unused), 1 "sample", 2 "spread";
// br, bc, xs, es, threads, smem as ops/plastic_head.py::HeadPlan gives them.
extern "C" int plastic_head_forward(const void* x, const void* w, const void* alpha, const void* eta,
                                    const void* hebb, void* activ, void* activout, void* hebb_out,
                                    int batch, int n, int oja, int scalar_alpha, int family, int br, int bc,
                                    int xs, int es, int threads, int smem, void* stream) {
  const StArgs a{(const float*)x, (const float*)w, (const float*)alpha, (const float*)eta, (const float*)hebb,
                 (float*)activ, (float*)activout, (float*)hebb_out, n, br, bc, xs, es};
  cudaStream_t s = (cudaStream_t)stream;
  int code;
  if (oja)
    code = scalar_alpha ? launch<true, true>(family, a, batch, threads, smem, s)
                        : launch<true, false>(family, a, batch, threads, smem, s);
  else
    code = scalar_alpha ? launch<false, true>(family, a, batch, threads, smem, s)
                        : launch<false, false>(family, a, batch, threads, smem, s);
  return code != 0 ? code : (int)cudaGetLastError();
}
