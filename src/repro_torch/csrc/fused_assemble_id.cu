// Fused assemble + greedy column-pivoted QR for the row IDs of one tree level.
//
// Replaces: repro/kernels/compress/kernel.py::fused_assemble_id_pallas
// (both branches).  Per node b:
//   A^T = K(xp_b, xc_b) * cmask_b         (s x m: proxies x candidates)
//     gaussian:  exp(-max(|xp|^2 + |xc|^2 - 2 xp.xc, 0) / 2h^2)
//     laplacian: exp(-|xp - xc|_1 / h), the L1 sum in f32 in feature order
//                and a true division by h, as _assemble_laplacian has it
//   k greedy CPQR steps on A^T, exactly as repro/core/idqr.py::cpqr_select:
//     p = argmax of the available column norms (ties -> lowest index),
//     q = resid[:, p] / sqrt(max(|resid[:, p]|^2, 1e-30)),
//     q -= Q (Q^T q), q /= sqrt(max(q.q, 1e-30))   ("twice is enough"),
//     resid -= q (q^T resid), resid[:, p] = 0 exactly, p no longer available
//   piv[b] = the k pivots, R[b] = Q^T A^T (k x m), A^T evaluated again from
//   the points.  Every dot product is a plain f32 FMA chain (no TF32).
// The idqr.finish_interp tail (triangular solve) stays in torch.
//
// Bound on this card: operations.  A node does about 8 k s m f32 flops
// (deflation, norms, R) against O((s + m) f + k m) bytes in and out; in
// practice a step is a chain of dependent phases (argmax, q, deflation)
// whose latency, and the shared-memory traffic of the deflation, bound it.
// What held the one-block-per-node kernel back: one thread per column
// walking all s rows twice a step, too few warps to hide it (one 256-thread
// block an SM at the accurate shapes), most SMs idle at the upper levels
// (2 nodes at level 11), Q in a global scratch at the accurate leaf, and a
// block barrier or tree after every small phase.
//
// Design: one node per thread-block cluster of C CTAs, C in {1, 2, 4, 8}
// (cudaLaunchKernelEx with a cluster dimension; grid.x = B * C).  CTA r of
// the cluster owns candidate columns [r m/C, (r+1) m/C), their residual in
// its shared memory.  TPC threads (a power of two) share a column, each a
// block of rows, and a column's dots and norms reduce with shuffles.  Q
// (s x k) is replicated in every CTA.  A step:
//   1. argmax over the CTA's columns (a warp tree, a barrier, a warp tree);
//      in a cluster, the local winner's column and (norm, index) go into a
//      buffer of every CTA (remote stores through distributed shared
//      memory, double-buffered by step parity) and one cluster barrier
//      follows, so no CTA ever reads another's memory;
//   2. q0 = the winner's column over its norm; proj = Q^T q0 (a warp a
//      direction, four at a time); q = q0 - Q proj (G lanes a row, four
//      chains a lane); q /= |q|.  Every CTA runs the same arithmetic in the
//      same order on the same values, so q and Q are bitwise equal in all;
//   3. each CTA deflates its columns (q read as float4) and refreshes their
//      norms; the pivot's lanes zero it.  No barrier ends the step.
// R = Q^T A^T: A^T's rows are evaluated again into the dead residual, row-
// major, and each thread accumulates a 4 x 4 tile of R.
// Where a node's residual and Q do not fit one CTA's shared memory (the
// accurate leaf, m=256, s=192, k=64: 255 KB), one CTA can still take the
// node by keeping REG_ROWS rows a lane of the residual in registers
// (RREG; at most 512 threads, up to 128 registers each).  The launcher in
// kernels/compress/kernel.py chooses (C, TPC, RREG) in plain Python
// (`plan`): C = 1 wherever the level has a node for every SM (measured
// fastest there), else the largest C that keeps B C CTAs in one wave; TPC
// for the fewest waves of CTAs, then the most threads up to 512.  Its
// shared-memory count is `layout` below, and fused_assemble_id_smem_bytes
// exports it for the launcher to check against.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cfloat>
#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_CLUSTER = 8;
constexpr int REG_ROWS = 16;       // residual rows a lane holds in registers, where used
constexpr int kBadPlan = -2;

enum Kind { kGaussian = 0, kLaplacian = 1 };

// Lanes a row in the re-orthogonalisation: the largest power of two <= 32
// with G s <= threads (each lane sums every G-th earlier direction).
__host__ __device__ inline int row_lanes_log2(int s, int nthreads) {
  int g = 0;
  while (g < 5 && (s << (g + 1)) <= nthreads) ++g;
  return g;
}

inline int block_threads(int m, int c, int tpc) { return ((m / c) * tpc + 31) / 32 * 32; }

// One CTA's shared memory, offsets in floats.  The first s_sm rows of the
// residual live here; rows s_sm..s-1, if any, in registers (RREG a lane).
// Lane t of a column owns the rows [t rb, (t+1) rb) of its shared part
// (rb a multiple of 4, so q reads as float4; the last lanes may hold fewer),
// stored from t rbs on, so that the TPC lanes of a column, and with the
// column stride ss = 1 mod 32 the columns of a warp, read 32 banks.
struct Layout {
  int s_sm, rb, rbs, ss, qs;  // shared rows, rows a lane, their stride, column stride, Q's
  size_t resid, basis, q, q0, n_p, proj, cand_col, cand_val, red_a, red_s, bytes;
};

__host__ __device__ inline Layout layout(int m, int s, int k, int c, int tpc, int rreg) {
  Layout L;
  const int mc = m / c, threads = (mc * tpc + 31) / 32 * 32, warps = threads / 32;
  L.s_sm = s - rreg * tpc;
  const int s32 = (s + 31) / 32 * 32;
  // A multiple of `unit` that is an odd multiple puts the TPC lanes of a
  // column on distinct banks; for TPC <= 8 the blocks themselves get that
  // length (q's float4 reads then spread too), beyond it only their stride.
  const int rb0 = ((L.s_sm + tpc - 1) / tpc + 3) / 4 * 4, unit = 32 / tpc;
  const int odd = ((rb0 + unit - 1) / unit | 1) * unit;
  L.rb = tpc == 1 || tpc > 8 ? rb0 : odd;
  L.rbs = tpc == 1 ? rb0 : odd;
  L.ss = tpc * L.rbs + 1;
  L.qs = s32 + (32 >> row_lanes_log2(s, threads));  // a row's G lanes: 32 banks
  size_t o = 0;
  L.resid = o; o += ((size_t)mc * L.ss + 3) / 4 * 4;  // A^T as [r * mc + jl] for R
  L.basis = o; o += ((size_t)k * L.qs + 3) / 4 * 4;
  L.q = o; o += (s + 3) / 4 * 4;        // this step's q (float4-aligned)
  L.q0 = o; o += s;                     // the pivot column over its norm
  L.n_p = o; o += s;                    // proxy point norms
  L.proj = o; o += k;                   // Q^T q0
  const size_t cc = c > 1 ? c : 0;      // a cluster's exchange buffers
  L.cand_col = o; o += 2 * cc * s;      // [parity][rank][r]: candidate columns
  L.cand_val = o; o += 2 * cc * 2;      // [parity][rank]: (norm, index bits)
  L.red_a = o; o += 2 * warps;          // per-warp argmax (value, index bits)
  L.red_s = o; o += warps;              // per-warp partial sums
  L.bytes = o * 4;
  return L;
}

// A candidate point, its first FMAX features in registers (the rest, if
// any, are read from memory as they are needed).
constexpr int FMAX = 8;
struct Cand {
  const float* x;
  float v[FMAX];
};

__device__ __forceinline__ Cand load_cand(const float* __restrict__ x, int f) {
  Cand c;
  c.x = x;
#pragma unroll
  for (int i = 0; i < FMAX; ++i) c.v[i] = i < f ? __ldg(x + i) : 0.f;
  return c;
}

// One entry of A^T, the features summed in order.  param is -1/2h^2
// (gaussian) or h (laplacian); the point norms nc, np are read by the
// gaussian branch only.
template <int KIND>
__device__ __forceinline__ float entry(const Cand& xc_j, const float* __restrict__ xp_r, int f,
                                       float nc, float np, float param) {
  if constexpr (KIND == kLaplacian) {
    float d1 = 0.f;
#pragma unroll
    for (int c = 0; c < FMAX; ++c)
      if (c < f) d1 += fabsf(xc_j.v[c] - __ldg(xp_r + c));
    for (int c = FMAX; c < f; ++c) d1 += fabsf(__ldg(xc_j.x + c) - __ldg(xp_r + c));
    return expf(-d1 / param);
  } else {
    float cross = 0.f;
#pragma unroll
    for (int c = 0; c < FMAX; ++c)
      if (c < f) cross = fmaf(xc_j.v[c], __ldg(xp_r + c), cross);
    for (int c = FMAX; c < f; ++c) cross = fmaf(__ldg(xc_j.x + c), __ldg(xp_r + c), cross);
    const float sq = fmaxf((nc + np) - 2.f * cross, 0.f);
    return expf(sq * param);
  }
}

// |x|^2 of one point, summed in feature order.
__device__ __forceinline__ float sq_norm(const float* __restrict__ x, int f) {
  float acc = 0.f;
  for (int c = 0; c < f; ++c) { const float v = __ldg(x + c); acc += v * v; }
  return acc;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum over groups of `width` consecutive lanes (a power of two); every lane
// of a group gets the same bits (the butterfly adds the same pairs in each).
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// (value, index) argmax over the warp, ties to the lowest index; every lane
// gets the same winner.
__device__ __forceinline__ void warp_argmax(float& v, int& ix) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, ix, off);
    if (ov > v || (ov == v && oi < ix)) { v = ov; ix = oi; }
  }
}

template <int KIND, int RREG>
__global__ void __launch_bounds__(RREG ? MAX_THREADS / 2 : MAX_THREADS, 1)
fused_assemble_id_kernel(const float* __restrict__ xc, const float* __restrict__ xp,
                         const float* __restrict__ cmask, int* __restrict__ piv_out,
                         float* __restrict__ r_out, int m, int s, int f, int k, float scale,
                         int tpc_log2) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tpc = 1 << tpc_log2;
  const Layout L = layout(m, s, k, n_cta, tpc, RREG);
  const int s_sm = L.s_sm;
  extern __shared__ float smem[];
  float* resid = smem + L.resid;
  float* basis = smem + L.basis;          // Q, [i * qs + r]
  float* q = smem + L.q;                  // [r]
  float* q0 = smem + L.q0;                // [r]
  float* n_p = smem + L.n_p;              // [r]
  float* proj = smem + L.proj;            // [i]
  float* cand_col = smem + L.cand_col;    // [(parity * C + rank) * s + r]
  float* cand_val = smem + L.cand_val;    // [(parity * C + rank) * 2 + 0/1]
  float* red_a = smem + L.red_a;          // [warp], [nwarps + warp]
  float* red_s = smem + L.red_s;          // [warp]

  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mc = m / n_cta, jl = tid >> tpc_log2, t = tid & (tpc - 1);
  const bool has_col = jl < mc;           // the block is rounded up to whole warps
  const int jg = rank * mc + jl;
  const size_t b = blockIdx.x / n_cta;
  const float* xc_b = xc + b * m * f;
  const float* xp_b = xp + b * s * f;
  const float* cm_b = cmask + b * m + rank * mc;
  float* col = resid + (size_t)(has_col ? jl : 0) * L.ss + t * L.rbs;   // this lane's rows
  const int r0 = t * L.rb;                // its first row
  const int nrow = max(0, min(L.rb, s_sm - r0));
  // Row r of a column in shared memory: at (r / rb) rbs + r % rb.
  auto at = [&](int r) { return (r / L.rb) * L.rbs + r % L.rb; };
  const int g_log2 = row_lanes_log2(s, nthreads);
  const int g_width = 1 << g_log2, g = tid & (g_width - 1), rows_per_pass = nthreads >> g_log2;

  if constexpr (KIND == kGaussian) {
    for (int r = tid; r < s; r += nthreads) {
      n_p[r] = sq_norm(xp_b + (size_t)r * f, f);
    }
  }
  __syncthreads();

  // Assemble this CTA's columns of A^T (masked by cmask) and their norms;
  // rows past s_sm go to registers.  A column's norm and availability live
  // in registers of its lanes.
  const float* xc_col = xc_b + (size_t)(has_col ? jg : 0) * f;
  const float n_cj = KIND == kGaussian ? sq_norm(xc_col, f) : 0.f;   // every lane of the column
  float xr[RREG > 0 ? RREG : 1];
  float nrm = 0.f;
  const Cand xc_j = load_cand(xc_col, f);  // reloaded for R: not held across the steps
  if (has_col) {
    for (int u = 0; u < nrow; ++u) {
      const int r = r0 + u;
      const float a = entry<KIND>(xc_j, xp_b + (size_t)r * f, f, n_cj, n_p[r], scale)
                      * cm_b[jl];
      col[u] = a;
      nrm += a * a;
    }
  }
#pragma unroll
  for (int ii = 0; ii < RREG; ++ii) {
    const int r = s_sm + t + (ii << tpc_log2);
    xr[ii] = has_col
        ? entry<KIND>(xc_j, xp_b + (size_t)r * f, f, n_cj, n_p[r], scale) * cm_b[jl] : 0.f;
    nrm += xr[ii] * xr[ii];
  }
  float norm_j = group_sum(nrm, tpc);
  bool avail_j = has_col;
  if (n_cta > 1) cluster.sync();          // every CTA runs before any remote store

  for (int i = 0; i < k; ++i) {
    const int par = i & 1;
    // 1. This CTA's argmax over its available columns (others count as -1).
    float pv = has_col && t == 0 ? (avail_j ? norm_j : -1.f) : -FLT_MAX;
    int p = has_col && t == 0 ? jg : INT_MAX;
    warp_argmax(pv, p);
    if (lane == 0) { red_a[warp] = pv; red_a[nwarps + warp] = __int_as_float(p); }
    __syncthreads();
    pv = lane < nwarps ? red_a[lane] : -FLT_MAX;
    p = lane < nwarps ? __float_as_int(red_a[nwarps + lane]) : INT_MAX;
    warp_argmax(pv, p);
    const float* src;                     // the pivot column, raw, rows < s_sm
    if (n_cta > 1) {
      // Publish the local winner's column and (norm, index) into every
      // CTA's buffer of this parity; then take the cluster's winner.
      const int slot = par * n_cta + rank;
      const float* lcol = resid + (size_t)(p - rank * mc) * L.ss;
      for (int r = tid; r < s_sm; r += nthreads) {
        const float v = lcol[at(r)];
        for (int c = 0; c < n_cta; ++c)
          (c == rank ? cand_col : cluster.map_shared_rank(cand_col, c))[(size_t)slot * s + r] = v;
      }
      if (has_col && jg == p) {
#pragma unroll
        for (int ii = 0; ii < RREG; ++ii) {
          const int r = s_sm + t + (ii << tpc_log2);
          for (int c = 0; c < n_cta; ++c)
            (c == rank ? cand_col : cluster.map_shared_rank(cand_col, c))[(size_t)slot * s + r] =
                xr[ii];
        }
      }
      if (tid < n_cta) {
        float* cv = tid == rank ? cand_val : cluster.map_shared_rank(cand_val, tid);
        cv[slot * 2] = pv;
        cv[slot * 2 + 1] = __int_as_float(p);
      }
      cluster.sync();
      float v = -FLT_MAX;
      int ix = INT_MAX;
      if (lane < n_cta) {
        v = cand_val[(par * n_cta + lane) * 2];
        ix = __float_as_int(cand_val[(par * n_cta + lane) * 2 + 1]);
      }
      warp_argmax(v, ix);
      pv = v;
      p = ix;
      src = cand_col + (size_t)(par * n_cta + p / mc) * s;
    } else {
      src = resid + (size_t)p * L.ss;
    }
    const float nrm_p = sqrtf(fmaxf(pv, 1e-30f));
    if (tid == 0 && rank == 0) piv_out[b * k + i] = p;
    const bool is_p = has_col && jg == p;
    if (is_p) avail_j = false;
    const int rows_src = n_cta > 1 ? s : s_sm;   // the rest come from the pivot's registers
    for (int r = tid; r < rows_src; r += nthreads) q0[r] = src[n_cta > 1 ? r : at(r)] / nrm_p;
    if (n_cta == 1 && is_p) {
#pragma unroll
      for (int ii = 0; ii < RREG; ++ii) q0[s_sm + t + (ii << tpc_log2)] = xr[ii] / nrm_p;
    }
    __syncthreads();

    // 2. Re-orthogonalise q0 against the i earlier directions (later ones
    //    are 0): proj = Q^T q0, a warp a direction, four at a time ...
    for (int jj = warp; jj < i; jj += 4 * nwarps) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
      for (int r = lane; r < s; r += 32) {
        const float qr = q0[r];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (jj + u * nwarps < i) a[u] = fmaf(basis[(size_t)(jj + u * nwarps) * L.qs + r], qr, a[u]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < 4; ++u) a[u] += __shfl_down_sync(0xffffffffu, a[u], off);
      if (lane == 0)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (jj + u * nwarps < i) proj[jj + u * nwarps] = a[u];
    }
    __syncthreads();
    //    ... q0 - Q proj, G lanes a row, four chains a lane; then |q|^2.
    float part = 0.f;
    for (int base = 0; base < s; base += rows_per_pass) {
      const int r = base + (tid >> g_log2);
      float tc[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < s) {
        int jj = g;
        for (; jj + 3 * g_width < i; jj += 4 * g_width)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            tc[u] = fmaf(basis[(size_t)(jj + u * g_width) * L.qs + r], proj[jj + u * g_width], tc[u]);
        for (; jj < i; jj += g_width) tc[0] = fmaf(basis[(size_t)jj * L.qs + r], proj[jj], tc[0]);
      }
      const float tt = group_sum((tc[0] + tc[1]) + (tc[2] + tc[3]), g_width);
      if (r < s && g == 0) {
        const float v = q0[r] - tt;
        q[r] = v;
        part += v * v;
      }
    }
    part = warp_sum(part);
    if (lane == 0) red_s[warp] = part;
    __syncthreads();
    float qq = lane < nwarps ? red_s[lane] : 0.f;
    qq = group_sum(qq, 32);                // the same bits in every warp and CTA
    const float qn = sqrtf(fmaxf(qq, 1e-30f));
    for (int r = tid; r < s; r += nthreads) {
      const float v = q[r] / qn;
      q[r] = v;
      basis[(size_t)i * L.qs + r] = v;
    }
    __syncthreads();

    // 3. Deflate this CTA's columns, zero the pivot, refresh the norms.
    //    q in float4s over this lane's block of rows (nrow a multiple of
    //    4 but on the last lane of a column).
    float dot = 0.f;
    const int nrow4 = nrow & ~3;
    if (has_col && !is_p) {
#pragma unroll 2
      for (int u = 0; u < nrow4; u += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(q + r0 + u);
        dot = fmaf(q4.x, col[u], dot);
        dot = fmaf(q4.y, col[u + 1], dot);
        dot = fmaf(q4.z, col[u + 2], dot);
        dot = fmaf(q4.w, col[u + 3], dot);
      }
      for (int u = nrow4; u < nrow; ++u) dot = fmaf(q[r0 + u], col[u], dot);
#pragma unroll
      for (int ii = 0; ii < RREG; ++ii) dot = fmaf(q[s_sm + t + (ii << tpc_log2)], xr[ii], dot);
    }
    dot = group_sum(dot, tpc);
    float nj = 0.f;
    if (is_p) {
      for (int u = 0; u < nrow; ++u) col[u] = 0.f;
#pragma unroll
      for (int ii = 0; ii < RREG; ++ii) xr[ii] = 0.f;
    } else if (has_col) {
#pragma unroll 2
      for (int u = 0; u < nrow4; u += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(q + r0 + u);
        const float v0 = col[u] - q4.x * dot, v1 = col[u + 1] - q4.y * dot;
        const float v2 = col[u + 2] - q4.z * dot, v3 = col[u + 3] - q4.w * dot;
        col[u] = v0;
        col[u + 1] = v1;
        col[u + 2] = v2;
        col[u + 3] = v3;
        nj += v0 * v0;
        nj += v1 * v1;
        nj += v2 * v2;
        nj += v3 * v3;
      }
      for (int u = nrow4; u < nrow; ++u) {
        const float v = col[u] - q[r0 + u] * dot;
        col[u] = v;
        nj += v * v;
      }
#pragma unroll
      for (int ii = 0; ii < RREG; ++ii) {
        const float v = xr[ii] - q[s_sm + t + (ii << tpc_log2)] * dot;
        xr[ii] = v;
        nj += v * v;
      }
    }
    norm_j = group_sum(nj, tpc);
    // No barrier here: the next step's argmax reads registers and writes
    // red_a, which nobody reads until its barrier; everything else it
    // writes comes after that barrier, and the exchange buffers alternate
    // by parity.
  }

  // R = Q^T A^T over this CTA's columns.  A^T's first s_sm rows are
  // evaluated again into the dead residual, row-major ([r * mc + j]), and
  // each thread accumulates a 4 x 4 tile of R over them: directions warp +
  // nwarps u, columns lane + 32 v.  The rows in registers are added after,
  // by the columns' lanes.
  __syncthreads();
  const Cand xc_r = load_cand(xc_col, f);
  if (has_col)
    for (int r = r0; r < r0 + nrow; ++r)
      resid[(size_t)r * mc + jl] =
          entry<KIND>(xc_r, xp_b + (size_t)r * f, f, n_cj, n_p[r], scale) * cm_b[jl];
  __syncthreads();
  for (int i0 = warp; i0 < k; i0 += 4 * nwarps) {
    for (int j0 = lane; j0 < mc; j0 += 128) {
      bool iv[4], jv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        iv[u] = i0 + u * nwarps < k;
        jv[u] = j0 + 32 * u < mc;
      }
      float acc[4][4] = {};
      for (int r = 0; r < s_sm; ++r) {
        float qv[4], av[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          qv[u] = iv[u] ? basis[(size_t)(i0 + u * nwarps) * L.qs + r] : 0.f;
          av[u] = jv[u] ? resid[(size_t)r * mc + j0 + 32 * u] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(qv[u], av[v], acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (iv[u] && jv[v])
            r_out[(b * k + i0 + u * nwarps) * m + rank * mc + j0 + 32 * v] = acc[u][v];
    }
  }
  if constexpr (RREG > 0) {
    __syncthreads();                      // the tile writes above, before their updates
#pragma unroll
    for (int ii = 0; ii < RREG; ++ii) {
      const int r = s_sm + t + (ii << tpc_log2);
      xr[ii] = has_col
          ? entry<KIND>(xc_r, xp_b + (size_t)r * f, f, n_cj, n_p[r], scale) * cm_b[jl] : 0.f;
    }
    for (int i = 0; i < k; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int ii = 0; ii < RREG; ++ii)
        acc = fmaf(basis[(size_t)i * L.qs + s_sm + t + (ii << tpc_log2)], xr[ii], acc);
      acc = group_sum(acc, tpc);
      if (has_col && t == (i & (tpc - 1))) r_out[(b * k + i) * m + jg] += acc;
    }
  }
}

using KernelFn = decltype(&fused_assemble_id_kernel<kGaussian, 0>);

// The launch of `kind` at (C, TPC): its kernel and configuration, or kBadPlan.
int configure(int kind, KernelFn* fn, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
              int batch, int m, int s, int k, int c, int tpc, int rreg, int device,
              cudaStream_t stream) {
  if (!(c == 1 || c == 2 || c == 4 || c == MAX_CLUSTER) || m % c != 0 || tpc < 1 || tpc > 32
      || (tpc & (tpc - 1)) != 0 || !(rreg == 0 || rreg == REG_ROWS) || rreg * tpc >= s
      || block_threads(m, c, tpc) > (rreg ? MAX_THREADS / 2 : MAX_THREADS))
    return kBadPlan;
  if (rreg)
    *fn = kind == kLaplacian ? fused_assemble_id_kernel<kLaplacian, REG_ROWS>
                             : fused_assemble_id_kernel<kGaussian, REG_ROWS>;
  else
    *fn = kind == kLaplacian ? fused_assemble_id_kernel<kLaplacian, 0>
                             : fused_assemble_id_kernel<kGaussian, 0>;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                           device);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = layout(m, s, k, c, tpc, rreg).bytes;
  if (bytes > (size_t)optin) return kBadPlan;
  err = cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)batch * (unsigned)c);
  cfg->blockDim = dim3((unsigned)block_threads(m, c, tpc));
  cfg->dynamicSmemBytes = bytes;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

int log2_of(int tpc) {
  int l = 0;
  while ((1 << l) < tpc) ++l;
  return l;
}

}  // namespace

// Shared memory of one CTA at cluster size c and tpc threads a column.
extern "C" long long fused_assemble_id_smem_bytes(int m, int s, int k, int c, int tpc,
                                                  int rreg) {
  return (long long)layout(m, s, k, c, tpc, rreg).bytes;
}

// How many clusters of (c, tpc) the card holds at once
// (cudaOccupancyMaxActiveClusters); kBadPlan when the plan is not launchable.
extern "C" int fused_assemble_id_max_clusters(int kind, int m, int s, int k, int c, int tpc,
                                              int rreg, int device, int* out) {
  KernelFn fn;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int err = configure(kind, &fn, &cfg, &attr, 1, m, s, k, c, tpc, rreg, device,
                            nullptr);
  if (err != 0) return err;
  return (int)cudaOccupancyMaxActiveClusters(out, fn, &cfg);
}

// kind: 0 gaussian (param = -1/2h^2), 1 laplacian (param = h); one node per
// cluster of c CTAs, tpc threads a column (both from kernel.py's plan).
// Returns 0 on success, kBadPlan (without launching) for a plan the card
// cannot take, else the cudaError_t of the attribute call or the launch.
extern "C" int fused_assemble_id_launch(int kind, const void* xc, const void* xp,
                                        const void* cmask, void* piv, void* r, int batch,
                                        int m, int s, int f, int k, float param, int c,
                                        int tpc, int rreg, int device, void* stream) {
  KernelFn fn;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int err = configure(kind, &fn, &cfg, &attr, batch, m, s, k, c, tpc, rreg, device,
                            (cudaStream_t)stream);
  if (err != 0) return err;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, fn, (const float*)xc, (const float*)xp, (const float*)cmask, (int*)piv,
      (float*)r, m, s, f, k, param, log2_of(tpc));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
