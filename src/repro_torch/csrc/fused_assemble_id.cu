// Fused assemble + greedy column-pivoted QR for the row IDs of one tree level.
//
// Replaces: repro/kernels/compress/kernel.py::fused_assemble_id_pallas
// (both branches).  Per node b (one thread block each):
//   A^T = K(xp_b, xc_b) * cmask_b         (s x m: proxies x candidates)
//     gaussian:  exp(-max(|xp|^2 + |xc|^2 - 2 xp.xc, 0) / 2h^2)
//     laplacian: exp(-|xp - xc|_1 / h), the L1 sum in f32 in feature order
//                and a true division by h, as _assemble_laplacian has it
//   k greedy CPQR steps on A^T, exactly as repro/core/idqr.py::cpqr_select:
//     p = argmax of the available column norms (ties -> lowest index),
//     q = resid[:, p] / sqrt(max(|resid[:, p]|^2, 1e-30)),
//     q -= Q (Q^T q), q /= sqrt(max(q.q, 1e-30))   ("twice is enough"),
//     resid -= q (q^T resid), resid[:, p] = 0 exactly, p no longer available
//   piv[b] = the k pivots, R[b] = Q^T A^T (k x m).
// The idqr.finish_interp tail (triangular solve) stays in torch.
//
// Bound on this card: operations.  Each node does about 8 k s m f32 flops
// (deflation, norms, R) against O((s + m) f + k m) bytes in and out; at the
// leaf shape (m=256, s=64, k=32) that is ~4.9 Mflop per node for ~44 KB.
// All dot products are plain f32 FMA (no TF32).
//
// Design: the s x m residual stays in shared memory for all k steps (64 KiB
// at the leaf shape); A^T itself is NOT kept beside it as the TPU plan did.
// For the final R = Q^T A^T the block re-evaluates A^T from the points,
// which costs s m exp's but no storage, so shapes whose A^T and residual
// together exceed the card's 227 KB still fit.  One thread owns one column
// (candidate): column norms, the q^T resid dot, the deflation and the next
// step's norm are one pass over the column with no synchronisation.  Q is
// stored direction-major (Q[i*s + r]) so both the per-direction dot
// products and the per-row update read shared memory without bank
// conflicts.  The launcher computes the shared-memory need.  Where Q does
// not fit beside the residual (the accurate preset's leaf: m=256, s=192,
// k=64 needs 249,952 B with Q, 200,800 B without), Q lives in a per-node
// global scratch that the caller allocates: only the nodes in flight (one
// per SM) touch it, ~6 MB, so it stays in the 50 MB L2.  After the k steps
// the residual is dead and Q is copied into its place for R.  Shapes that
// fit with Q keep it in shared memory (the QG = false instantiation, the
// code of the gaussian-only kernel).  kSmemTooLarge: no launch.
#include <cuda_runtime.h>
#include <cfloat>
#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KCHUNK = 32;          // R rows accumulated in registers per pass
constexpr int kSmemTooLarge = -2;
constexpr int kNeedScratch = -3;

enum Kind { kGaussian = 0, kLaplacian = 1 };

size_t smem_bytes(int m, int s, int k, bool q_global) {
  const size_t floats = (size_t)s * m      // residual
                        + (q_global ? 0 : (size_t)s * k)    // Q
                        + 2 * (size_t)m    // column norms, candidate point norms
                        + 2 * (size_t)s    // q, proxy point norms
                        + (size_t)k        // Q^T q
                        + 2 * WARPS;       // reduction scratch (max, sum)
  return floats * 4 + WARPS * 4 /* argmax index scratch */ + (size_t)m /* avail */;
}

// One entry of A^T.  param is -1/2h^2 (gaussian) or h (laplacian); the
// point norms nc, np are read by the gaussian branch only.
template <int KIND>
__device__ __forceinline__ float entry(const float* __restrict__ xc_j,
                                       const float* __restrict__ xp_r, int f,
                                       float nc, float np, float param) {
  if constexpr (KIND == kLaplacian) {
    float d1 = 0.f;
    for (int c = 0; c < f; ++c) d1 += fabsf(__ldg(xc_j + c) - __ldg(xp_r + c));
    return expf(-d1 / param);
  } else {
    float cross = 0.f;
    for (int c = 0; c < f; ++c) cross = fmaf(__ldg(xc_j + c), __ldg(xp_r + c), cross);
    const float sq = fmaxf((nc + np) - 2.f * cross, 0.f);
    return expf(sq * param);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the block; every thread gets the total.  Two barriers.
__device__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) total += scratch[w];
  __syncthreads();
  return total;
}

template <int KIND, bool QG>
__global__ void __launch_bounds__(THREADS)
fused_assemble_id_kernel(const float* __restrict__ xc, const float* __restrict__ xp,
                         const float* __restrict__ cmask, int* __restrict__ piv_out,
                         float* __restrict__ r_out, float* __restrict__ q_scratch,
                         int m, int s, int f, int k, float scale) {
  extern __shared__ float smem[];
  float* resid = smem;                    // [r * m + j]
  // Q, [i * s + r]: in shared memory, or in this node's global scratch.
  float* qs = QG ? q_scratch + (size_t)blockIdx.x * s * k : resid + (size_t)s * m;
  float* norms = resid + (size_t)s * m + (QG ? 0 : (size_t)s * k);   // [j]
  float* n_c = norms + m;                 // [j]
  float* q = n_c + m;                     // [r]
  float* n_p = q + s;                     // [r]
  float* proj = n_p + s;                  // [i]
  float* red_max = proj + k;              // [warp]
  float* red_sum = red_max + WARPS;       // [warp]
  int* red_idx = (int*)(red_sum + WARPS); // [warp]
  unsigned char* avail = (unsigned char*)(red_idx + WARPS);  // [j]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;
  const float* xc_b = xc + b * m * f;
  const float* xp_b = xp + b * s * f;
  const float* cm_b = cmask + b * m;

  for (int j = tid; j < m; j += THREADS) {
    if constexpr (KIND == kGaussian) {
      float acc = 0.f;
      for (int c = 0; c < f; ++c) { const float v = xc_b[(size_t)j * f + c]; acc += v * v; }
      n_c[j] = acc;
    }
    avail[j] = 1;
  }
  if constexpr (KIND == kGaussian) {
    for (int r = tid; r < s; r += THREADS) {
      float acc = 0.f;
      for (int c = 0; c < f; ++c) { const float v = xp_b[(size_t)r * f + c]; acc += v * v; }
      n_p[r] = acc;
    }
  }
  // Only Q's first i directions are read at step i, so the global scratch
  // needs no clearing.
  if constexpr (!QG)
    for (int idx = tid; idx < s * k; idx += THREADS) qs[idx] = 0.f;
  __syncthreads();

  // Assemble A^T (masked by cmask) and its column norms.
  for (int j = tid; j < m; j += THREADS) {
    const float cm = cm_b[j];
    float nrm = 0.f;
    for (int r = 0; r < s; ++r) {
      const float a = entry<KIND>(xc_b + (size_t)j * f, xp_b + (size_t)r * f, f, n_c[j], n_p[r], scale) * cm;
      resid[(size_t)r * m + j] = a;
      nrm += a * a;
    }
    norms[j] = nrm;
  }
  __syncthreads();

  for (int i = 0; i < k; ++i) {
    // p = argmax over available columns; unavailable ones count as -1.
    float best = -FLT_MAX;
    int bi = INT_MAX;
    for (int j = tid; j < m; j += THREADS) {
      const float v = avail[j] ? norms[j] : -1.f;
      if (v > best) { best = v; bi = j; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (ov > best || (ov == best && oi < bi)) { best = ov; bi = oi; }
    }
    if (lane == 0) { red_max[warp] = best; red_idx[warp] = bi; }
    __syncthreads();
    best = red_max[0];
    bi = red_idx[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      const float ov = red_max[w];
      const int oi = red_idx[w];
      if (ov > best || (ov == best && oi < bi)) { best = ov; bi = oi; }
    }
    const int p = bi;
    const float nrm = sqrtf(fmaxf(norms[p], 1e-30f));
    for (int r = tid; r < s; r += THREADS) q[r] = resid[(size_t)r * m + p] / nrm;
    __syncthreads();

    // Re-orthogonalise against the i earlier directions (later ones are 0).
    for (int jj = warp; jj < i; jj += WARPS) {
      float acc = 0.f;
      for (int r = lane; r < s; r += 32) acc = fmaf(qs[(size_t)jj * s + r], q[r], acc);
      acc = warp_sum(acc);
      if (lane == 0) proj[jj] = acc;
    }
    __syncthreads();
    float part = 0.f;
    for (int r = tid; r < s; r += THREADS) {
      float t = 0.f;
      for (int jj = 0; jj < i; ++jj) t = fmaf(qs[(size_t)jj * s + r], proj[jj], t);
      const float v = q[r] - t;
      q[r] = v;
      part += v * v;
    }
    const float qn = sqrtf(fmaxf(block_sum(part, red_sum), 1e-30f));
    for (int r = tid; r < s; r += THREADS) {
      const float v = q[r] / qn;
      q[r] = v;
      qs[(size_t)i * s + r] = v;
    }
    __syncthreads();

    // Deflate every column, zero the chosen one, refresh the norms.
    for (int j = tid; j < m; j += THREADS) {
      float nrm_j = 0.f;
      if (j == p) {
        for (int r = 0; r < s; ++r) resid[(size_t)r * m + j] = 0.f;
      } else {
        float qr = 0.f;
        for (int r = 0; r < s; ++r) qr = fmaf(q[r], resid[(size_t)r * m + j], qr);
        for (int r = 0; r < s; ++r) {
          const float v = resid[(size_t)r * m + j] - q[r] * qr;
          resid[(size_t)r * m + j] = v;
          nrm_j += v * v;
        }
      }
      norms[j] = nrm_j;
    }
    if (tid == 0) {
      avail[p] = 0;
      piv_out[b * k + i] = p;
    }
    __syncthreads();
  }

  // R = Q^T A^T with A^T evaluated again from the points.  The residual is
  // dead now: a global Q moves into its place first (k <= m).
  const float* qr_s = qs;
  if constexpr (QG) {
    for (int idx = tid; idx < s * k; idx += THREADS) resid[idx] = qs[idx];
    __syncthreads();
    qr_s = resid;
  }
  for (int j = tid; j < m; j += THREADS) {
    const float cm = cm_b[j];
    for (int i0 = 0; i0 < k; i0 += KCHUNK) {
      float acc[KCHUNK];
#pragma unroll
      for (int ii = 0; ii < KCHUNK; ++ii) acc[ii] = 0.f;
      for (int r = 0; r < s; ++r) {
        const float a = entry<KIND>(xc_b + (size_t)j * f, xp_b + (size_t)r * f, f, n_c[j], n_p[r], scale) * cm;
#pragma unroll
        for (int ii = 0; ii < KCHUNK; ++ii)
          if (i0 + ii < k) acc[ii] = fmaf(qr_s[(size_t)(i0 + ii) * s + r], a, acc[ii]);
      }
#pragma unroll
      for (int ii = 0; ii < KCHUNK; ++ii)
        if (i0 + ii < k) r_out[(b * k + i0 + ii) * m + j] = acc[ii];
    }
  }
}

template <int KIND, bool QG>
int launch_one(const void* xc, const void* xp, const void* cmask, void* piv, void* r,
               void* q_scratch, int batch, int m, int s, int f, int k, float param,
               size_t bytes, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      fused_assemble_id_kernel<KIND, QG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  fused_assemble_id_kernel<KIND, QG><<<batch, THREADS, bytes, stream>>>(
      (const float*)xc, (const float*)xp, (const float*)cmask, (int*)piv, (float*)r,
      (float*)q_scratch, m, s, f, k, param);
  return (int)cudaGetLastError();
}

template <int KIND>
int launch_kind(const void* xc, const void* xp, const void* cmask, void* piv, void* r,
                void* q_scratch, int batch, int m, int s, int f, int k, float param,
                int where, cudaStream_t stream) {
  if (where == 0)
    return launch_one<KIND, false>(xc, xp, cmask, piv, r, nullptr, batch, m, s, f, k,
                                   param, smem_bytes(m, s, k, false), stream);
  return launch_one<KIND, true>(xc, xp, cmask, piv, r, q_scratch, batch, m, s, f, k,
                                param, smem_bytes(m, s, k, true), stream);
}

}  // namespace

extern "C" long long fused_assemble_id_smem_bytes(int m, int s, int k, int q_global) {
  return (long long)smem_bytes(m, s, k, q_global != 0);
}

// *where = 0 (Q in shared memory), 1 (Q in the global scratch) or
// kSmemTooLarge.  Returns the cudaError_t of the attribute query.
extern "C" int fused_assemble_id_plan(int m, int s, int k, int device, int* where) {
  int optin = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (smem_bytes(m, s, k, false) <= (size_t)optin) *where = 0;
  else if (smem_bytes(m, s, k, true) <= (size_t)optin) *where = 1;
  else *where = kSmemTooLarge;
  return (int)cudaSuccess;
}

// kind: 0 gaussian (param = -1/2h^2), 1 laplacian (param = h).  q_scratch
// holds batch * k * s floats, or is null when Q fits in shared memory.
// Returns 0 on success, kSmemTooLarge (without launching) when the node
// does not fit, kNeedScratch when it fits only with a scratch that was not
// given, else the cudaError_t of the attribute call or the launch.
extern "C" int fused_assemble_id_launch(int kind, const void* xc, const void* xp,
                                        const void* cmask, void* piv, void* r,
                                        void* q_scratch, int batch, int m, int s,
                                        int f, int k, float param, int device,
                                        void* stream) {
  int where = 0;
  const int err = fused_assemble_id_plan(m, s, k, device, &where);
  if (err != 0) return err;
  if (where == kSmemTooLarge) return kSmemTooLarge;
  if (where == 1 && q_scratch == nullptr) return kNeedScratch;
  if (kind == kLaplacian)
    return launch_kind<kLaplacian>(xc, xp, cmask, piv, r, q_scratch, batch, m, s, f, k,
                                   param, where, (cudaStream_t)stream);
  return launch_kind<kGaussian>(xc, xp, cmask, piv, r, q_scratch, batch, m, s, f, k,
                                param, where, (cudaStream_t)stream);
}
