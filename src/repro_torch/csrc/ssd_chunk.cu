// Mamba-2 SSD chunk scan: y and the final (N, P) state of every (batch, head).
//
// Replaces: repro/kernels/ssd/kernel.py::ssd_pallas (the TPU kernel, grid
// (B*H, chunks) with the (N, P) state carried in VMEM scratch across the
// sequential chunk axis), computing what repro/kernels/ssd/ref.py
// ::ssd_chunked_ref returns, the final state included.  Per chunk of Q
// positions, all in f32:
//   la     = cumsum(dt) * a                        (inclusive log decay)
//   scores = (C Bᵀ) ⊙ exp(la_i − la_j) [i ≥ j]
//   y      = scores (dt ⊙ x) + (C ⊙ exp(la)) h + D x
//   h      = exp(la_Q) h + (B ⊙ exp(la_Q − la) dt)ᵀ x
//
// Bound on this card: operations, but only by a few times.  At the zamba2
// path's shape (B 4, S 1024, H 64, P 64, N 64, chunk 128) the scan reads and
// writes ~140 MB (0.04 ms at 3.35 TB/s) against ~13 GFLOP of f32 products
// (0.19 ms at 67 TFLOP/s).  This first kernel keeps every product in f32 on
// the CUDA cores, fed from shared memory.
//
// Design: one block of 256 threads per (b, h), looping over the chunks in
// order with the state in shared memory; this replaces the TPU's sequential
// chunk axis.  The kernel reads the model layout (B, S, H, P) and the group's
// B and C (group h / (H / G)) directly: nothing is transposed or repeated.
// Residency: x (Q, P), B (Q, N + 1; padded so that the 32 lanes reading
// B[j][n] for 32 consecutive j hit 32 banks) and the state (N, P) stay for
// the chunk; C and the Q x Q score matrix pass in strips of 32 rows.  So at
// Q 128, P 64 a block needs 106 KB at N 64 (two blocks per SM) and 162 KB at
// mamba2-780m's N 128, where keeping C and the whole score matrix as well
// would need 256 KB.  The cumulative sum is a warp scan.  Parallelism is only
// B*H blocks (256 on the zamba2 path, about two per SM): the first thing a
// later kernel should change, by splitting the sequence into chunk groups
// whose states are combined in a second pass.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int NT = 256, NW = NT / 32;   // 8 warps
constexpr int RS = 32;                  // rows of a C / score strip
constexpr int RPW = RS / NW;            // strip rows per warp

template <int PC>   // PC = ceil(P / 32): head-dim columns per lane
__global__ void __launch_bounds__(NT)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const float* __restrict__ bm,
                 const float* __restrict__ cm, const float* __restrict__ dv,
                 float* __restrict__ y, float* __restrict__ hout, int64_t s,
                 int64_t heads, int64_t groups, int p, int n, int q) {
  extern __shared__ float sm[];
  const int np = n + 1;
  float* xs = sm;                 // (Q, P)
  float* bs = xs + q * p;         // (Q, N + 1)
  float* hs = bs + q * np;        // (N, P)
  float* cs = hs + n * p;         // (RS, N)
  float* sc = cs + RS * n;        // (RS, Q)
  float* dts = sc + RS * q;       // (Q,)
  float* las = dts + q;           // (Q,)
  float* ws = las + q;            // (Q,)

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int64_t b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int64_t g = h / (heads / groups);
  const float av = a[h], dsk = dv[h];

  for (int idx = tid; idx < n * p; idx += NT) hs[idx] = 0.f;

  for (int64_t c0 = 0; c0 < s; c0 += q) {
    __syncthreads();              // the last chunk's reads and state writes are done
    for (int idx = tid; idx < q * p; idx += NT) {
      const int i = idx / p, pp = idx % p;
      xs[idx] = x[((b * s + c0 + i) * heads + h) * p + pp];
    }
    for (int idx = tid; idx < q * n; idx += NT) {
      const int i = idx / n, nn = idx % n;
      bs[i * np + nn] = bm[((b * s + c0 + i) * groups + g) * n + nn];
    }
    for (int i = tid; i < q; i += NT) dts[i] = dt[(b * s + c0 + i) * heads + h];
    __syncthreads();

    if (w == 0) {                 // la = cumsum(dt) * a, a warp scan over segments
      const int per = (q + 31) / 32, i0 = lane * per;
      float run = 0.f;
      for (int k = 0; k < per; ++k) {
        const int i = i0 + k;
        if (i < q) { run += dts[i]; las[i] = run; }
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += v;
      }
      const float before = __shfl_up_sync(0xffffffffu, tot, 1);
      for (int k = 0; k < per; ++k) {
        const int i = i0 + k;
        if (i < q) las[i] = (lane == 0 ? las[i] : las[i] + before) * av;
      }
    }
    __syncthreads();
    const float la_tot = las[q - 1];

    for (int r0 = 0; r0 < q; r0 += RS) {
      for (int idx = tid; idx < RS * n; idx += NT) {
        const int ii = idx / n, nn = idx % n, i = r0 + ii;
        cs[idx] = i < q ? cm[((b * s + c0 + i) * groups + g) * n + nn] : 0.f;
      }
      __syncthreads();
      // The score strip: rows r0..r0+RS-1, columns j < min(Q, r0 + RS).
      const int jmax = min(q, r0 + RS);
      for (int j0 = 0; j0 < jmax; j0 += 32) {
        const int j = j0 + lane;
        if (j >= jmax) continue;
        float acc[RPW];
#pragma unroll
        for (int t = 0; t < RPW; ++t) acc[t] = 0.f;
        for (int nn = 0; nn < n; ++nn) {
          const float bv = bs[j * np + nn];
#pragma unroll
          for (int t = 0; t < RPW; ++t) acc[t] = fmaf(cs[(w + NW * t) * n + nn], bv, acc[t]);
        }
#pragma unroll
        for (int t = 0; t < RPW; ++t) {
          const int ii = w + NW * t, i = r0 + ii;
          sc[ii * q + j] = (i < q && j <= i) ? acc[t] * expf(las[i] - las[j]) : 0.f;
        }
      }
      __syncthreads();
      // y for the strip's rows.
#pragma unroll
      for (int t = 0; t < RPW; ++t) {
        const int ii = w + NW * t, i = r0 + ii;
        if (i >= q) continue;
        float yi[PC], ys[PC];
#pragma unroll
        for (int c = 0; c < PC; ++c) yi[c] = ys[c] = 0.f;
        for (int j = 0; j <= i; ++j) {
          const float sv = sc[ii * q + j], dj = dts[j];
#pragma unroll
          for (int c = 0; c < PC; ++c) {
            const int pp = lane + 32 * c;
            if (pp < p) yi[c] = fmaf(sv, xs[j * p + pp] * dj, yi[c]);
          }
        }
        const float e = expf(las[i]);
        for (int nn = 0; nn < n; ++nn) {
          const float cv = cs[ii * n + nn] * e;
#pragma unroll
          for (int c = 0; c < PC; ++c) {
            const int pp = lane + 32 * c;
            if (pp < p) ys[c] = fmaf(cv, hs[nn * p + pp], ys[c]);
          }
        }
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          const int pp = lane + 32 * c;
          if (pp < p)
            y[((b * s + c0 + i) * heads + h) * p + pp] = yi[c] + ys[c] + dsk * xs[i * p + pp];
        }
      }
      __syncthreads();            // the strip's C and scores are read
    }

    // The state update: h = exp(la_Q) h + (B ⊙ w)ᵀ x, w = exp(la_Q − la) dt.
    for (int i = tid; i < q; i += NT) ws[i] = expf(la_tot - las[i]) * dts[i];
    __syncthreads();
    const float etot = expf(la_tot);
    for (int nn = w; nn < n; nn += NW) {
#pragma unroll
      for (int c = 0; c < PC; ++c) {
        const int pp = lane + 32 * c;
        if (pp >= p) continue;
        float acc = 0.f;
        for (int j = 0; j < q; ++j) acc = fmaf(bs[j * np + nn] * ws[j], xs[j * p + pp], acc);
        hs[nn * p + pp] = etot * hs[nn * p + pp] + acc;
      }
    }
  }
  __syncthreads();
  if (hout != nullptr) {
    float* ho = hout + (b * heads + h) * (int64_t)n * p;
    for (int idx = tid; idx < n * p; idx += NT) ho[idx] = hs[idx];
  }
}

template <int PC>
int launch(const float* x, const float* dt, const float* a, const float* bm,
           const float* cm, const float* dv, float* y, float* hout, int64_t batch,
           int64_t s, int64_t heads, int64_t groups, int p, int n, int q, void* stream) {
  const int bytes = 4 * (q * p + q * (n + 1) + n * p + RS * n + RS * q + 3 * q);
  auto kern = ssd_chunk_kernel<PC>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)(batch * heads), NT, bytes, (cudaStream_t)stream>>>(
      x, dt, a, bm, cm, dv, y, hout, s, heads, groups, p, n, q);
  return (int)cudaGetLastError();
}

}  // namespace

// Contiguous f32 inputs in the model layout: x (B, S, H, P), dt (B, S, H),
// a and d (H,), b and c (B, S, G, N).  y (B, S, H, P); hout (B, H, N, P) or
// null.  S must be a multiple of the chunk q.
extern "C" int ssd_chunk_f32(const void* x, const void* dt, const void* a, const void* bm,
                             const void* cm, const void* dv, void* y, void* hout,
                             int64_t batch, int64_t s, int64_t heads, int64_t groups,
                             int64_t p, int64_t n, int64_t q, void* stream) {
  const float *xf = (const float*)x, *dtf = (const float*)dt, *af = (const float*)a,
              *bf = (const float*)bm, *cf = (const float*)cm, *df = (const float*)dv;
  float *yf = (float*)y, *hf = (float*)hout;
  switch ((p + 31) / 32) {
    case 1: return launch<1>(xf, dtf, af, bf, cf, df, yf, hf, batch, s, heads, groups,
                             (int)p, (int)n, (int)q, stream);
    case 2: return launch<2>(xf, dtf, af, bf, cf, df, yf, hf, batch, s, heads, groups,
                             (int)p, (int)n, (int)q, stream);
    case 3: return launch<3>(xf, dtf, af, bf, cf, df, yf, hf, batch, s, heads, groups,
                             (int)p, (int)n, (int)q, stream);
    case 4: return launch<4>(xf, dtf, af, bf, cf, df, yf, hf, batch, s, heads, groups,
                             (int)p, (int)n, (int)q, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
