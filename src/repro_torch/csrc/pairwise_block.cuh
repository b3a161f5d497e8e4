// The batched pairwise kernel block shared by gaussian_block.cu (K1) and
// laplacian_block.cu (K4): out[b] = K(xa[b], xb[b]) for (B, Ma, F) x (B, Mb, F),
// accumulated in f32 whatever the input type, stored in the input type.
//
// Bound on this card: bytes.  F is small (2-8 on every path), so each
// output costs a few operations per feature against 4 bytes stored (2 in
// bf16); the 2048 x 2^20 scoring block is 8.6 GB of output, about 2.6 ms at
// 3.35 TB/s.  A skinny block (2 query rows against 2^20 support rows) is
// bound by reading the support instead.
//
// Three launch plans, chosen in Python by kernels/pairwise.py (``plan``),
// which also sizes the grid and the dynamic shared memory; the launcher
// here refuses a plan whose shared memory is not its own count.  Every plan
// is one launch, whatever the batch.
//   skinny (Ma <= 16 rows against a long support):  the entry's query rows
//          sit in shared memory and are read as broadcasts; each thread owns
//          4 consecutive support columns, reads their rows with 16-byte
//          loads and writes one 16-byte store (8 in bf16) a query row.  The
//          grid is persistent over the column quads (x) and loops over the
//          batch (y, at most 65535 blocks).
//   packed (many small blocks, Ma·Mb <= 4096: the couplings, the streamed
//          level batches):  one block takes P consecutive batch entries,
//          stages their rows feature-major in shared memory with their
//          norms, and writes their outputs, one contiguous run of P·Ma·Mb
//          elements, 4 at a time.  The batch sits on grid.x.
//   wide   (everything else: leaf D, scoring, the 128-row serving tick,
//          the dense K):  one output tile a block (64 x 128 in f32, 32 x 256
//          in bf16) on a (column tiles, row tiles, batch) grid, the batch
//          looped over past 65535.  A thread owns RM rows of RN consecutive
//          columns (8 x 4 in f32, 4 x 8 in bf16: 16 bytes a row), the row
//          norms are summed once where the rows are staged, rows and columns
//          index in 32 bits, and interior tiles store without bounds checks,
//          16 bytes a store straight from the registers.  K1 runs 3 blocks
//          an SM (77-80 registers), K4 4 (56-64).  The designs tried on the
//          way (a cp.async.bulk epilogue through a shared-memory stage, a
//          persistent block walking a run or a strided set of tiles,
//          coalesced staging, smaller tiles) were slower on the card
//          (PERF.md, K1/K4 findings).
// The kinds differ only in the inner accumulate and the finish:
//   kGaussian:  one FMA per feature for the cross term;
//               exp(max(|a|^2 + |b|^2 - 2 a.b, 0) * scale), scale = -1/2h^2;
//   kLaplacian: one fabsf-add per feature (the |.| is an operand modifier
//               of the add), summed from 0.f over the features in order, as
//               the plain version does; exp(d1 * scale), scale = -f32(1/h).
// The cross term stays on the CUDA cores in f32 (no tensor cores: F is 2-8
// and TF32 would break the f32 sums).  expf, not __expf: the plain
// versions' exp is the accurate one.  The ragged edge is masked
// (zero-filled loads, skipped stores).  Offsets into the arrays are 64-bit:
// the scoring block alone has 2^31 entries.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

enum PairKind { kGaussian = 0, kLaplacian = 1 };
enum PairFamily { kSkinny = 0, kPacked = 1, kWide = 2 };
constexpr int kVecLoad = 1;             // flags: 16-byte loads of the support rows (skinny)
constexpr int kBadPlan = -2;            // returned for a plan the kernels cannot take

constexpr int THREADS = 256;
constexpr int FC = 8;                   // features a staged chunk (skinny, wide)

// The wide tile: RN consecutive columns a thread (16 bytes of T) over RM
// rows, 32 accumulators; the staged rows sit feature-major SA = TM + 4 and
// SB = TN + 4 floats apart (16-byte aligned rows).  MINB: blocks an SM in
// the launch bounds (K1 keeps its norms in registers as well).
template <int KIND, typename T> struct Wide {
  static constexpr int RN = 16 / (int)sizeof(T);
  static constexpr int RM = 32 / RN;
  static constexpr int TM = (THREADS / 32) * RM, TN = 32 * RN;
  static constexpr int SA = TM + 4, SB = TN + 4;
  static constexpr int MINB = KIND == kGaussian ? 3 : 4;
};

__host__ __device__ inline int64_t round4(int64_t n) { return (n + 3) & ~int64_t(3); }

// Dynamic shared memory of a plan (bytes): the layout of each kernel below.
template <typename T>
int64_t smem_bytes(int family, int64_t ma, int64_t mb, int64_t f, int param) {
  using W = Wide<kGaussian, T>;
  switch (family) {
    case kSkinny: return 4 * (ma * f + ma);                        // q, qn
    case kPacked: return 4 * (round4(param * ma * f) + round4(param * mb * f)
                              + param * ma + param * mb);          // sa, sb, na, nb
    case kWide: return 4 * (int64_t)(FC * W::SA + FC * W::SB + W::TM + W::TN);  // sa, sb, sna, snb
    default: return -1;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 16 bytes at a 16-byte aligned p as f32 values (4 f32 or 8 bf16; bf16 to
// f32 is exact: the bits shifted up).
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// N consecutive outputs (4 or 8) in one vector store: 16 bytes in f32 (N 4),
// 8 or 16 in bf16; p aligned to the store's width.
template <int N> __device__ __forceinline__ void store_vec(float* p, const float* v) {
  static_assert(N == 4, "f32 rows store 4 at a time");
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <int N> __device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  static_assert(N == 4 || N == 8, "bf16 rows store 4 or 8 at a time");
  if constexpr (N == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                              pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
}

template <int KIND> __device__ __forceinline__ float accum(float acc, float a, float b) {
  if constexpr (KIND == kGaussian) return fmaf(a, b, acc);
  else return acc + fabsf(a - b);
}

template <int KIND>
__device__ __forceinline__ float finish(float acc, float na, float nb, float scale) {
  if constexpr (KIND == kGaussian) return expf(fmaxf((na + nb) - 2.f * acc, 0.f) * scale);
  else return expf(acc * scale);
}

// ---- skinny ------------------------------------------------------------ //
template <int KIND, typename T, int ROWS>
__global__ void __launch_bounds__(THREADS)
pairwise_block_skinny(const T* __restrict__ xa, const T* __restrict__ xb, T* __restrict__ out,
                      int64_t batch, int ma, int64_t mb, int f, float scale, int flags) {
  extern __shared__ __align__(16) float sk_smem[];
  float* q = sk_smem;                    // the entry's query rows, row-major (f32)
  float* qn = sk_smem + ma * f;          // their squared norms (gaussian)
  constexpr int VN = 16 / (int)sizeof(T);
  const int64_t quads = (mb + 3) >> 2;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const bool vec_load = (flags & kVecLoad) != 0;
  const bool vec_store = (mb & 3) == 0;
  for (int64_t b = blockIdx.y; b < batch; b += gridDim.y) {
    __syncthreads();                     // the previous entry's rows are read out
    const T* qa = xa + b * ma * f;
    for (int i = threadIdx.x; i < ma * f; i += THREADS) q[i] = to_f32(qa[i]);
    __syncthreads();
    if (KIND == kGaussian && threadIdx.x < ma) {
      float s = 0.f;
      for (int c = 0; c < f; ++c) s = fmaf(q[threadIdx.x * f + c], q[threadIdx.x * f + c], s);
      qn[threadIdx.x] = s;
    }
    __syncthreads();
    const T* xb_b = xb + b * mb * f;
    T* out_b = out + b * ma * mb;
    for (int64_t qd = (int64_t)blockIdx.x * THREADS + threadIdx.x; qd < quads; qd += stride) {
      const int64_t c0 = qd << 2;
      const int nc = mb - c0 < 4 ? (int)(mb - c0) : 4;
      const T* rows = xb_b + c0 * f;
      float acc[ROWS][4], nb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        nb[j] = 0.f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r][j] = 0.f;
      }
      for (int k0 = 0; k0 < f; k0 += FC) {
        const int kc = f - k0 < FC ? f - k0 : FC;
        float v[4][FC];
        if (vec_load && nc == 4) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int k = 0; k < FC; k += VN)
              if (k < kc) load16(rows + j * f + k0 + k, &v[j][k]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int k = 0; k < FC; ++k)
              v[j][k] = (j < nc && k < kc) ? to_f32(rows[j * f + k0 + k]) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < FC; ++k) {
          if (k < kc) {
            if constexpr (KIND == kGaussian) {
#pragma unroll
              for (int j = 0; j < 4; ++j) nb[j] = fmaf(v[j][k], v[j][k], nb[j]);
            }
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
              if (r < ma) {
                const float a = q[r * f + k0 + k];
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[r][j] = accum<KIND>(acc[r][j], a, v[j][k]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < ma) {
          const float na = KIND == kGaussian ? qn[r] : 0.f;
          float e[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) e[j] = finish<KIND>(acc[r][j], na, nb[j], scale);
          T* o = out_b + r * mb + c0;
          if (vec_store && nc == 4) {
            store_vec<4>(o, e);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (j < nc) store(o + j, e[j]);
          }
        }
      }
    }
  }
}

// ---- packed ------------------------------------------------------------ //
template <int KIND, typename T>
__global__ void __launch_bounds__(THREADS)
pairwise_block_packed(const T* __restrict__ xa, const T* __restrict__ xb, T* __restrict__ out,
                      int64_t batch, int ma, int mb, int f, float scale, int per_block) {
  extern __shared__ __align__(16) float pk_smem[];
  float* sa = pk_smem;                                        // [e][c][r]
  float* sb = sa + round4((int64_t)per_block * ma * f);       // [e][c][col], 16-byte aligned
  float* na = sb + round4((int64_t)per_block * mb * f);       // [e][r]
  float* nb = na + per_block * ma;                            // [e][col]
  const int64_t b0 = (int64_t)blockIdx.x * per_block;
  const int k = batch - b0 < per_block ? (int)(batch - b0) : per_block;
  const T* xa_b = xa + b0 * ma * f;
  const T* xb_b = xb + b0 * mb * f;
  // one thread a row: its features into the feature-major tile, and its norm
  for (int i = threadIdx.x; i < k * (ma + mb); i += THREADS) {
    const bool is_a = i < k * ma;
    const int row = is_a ? i : i - k * ma;
    const int m = is_a ? ma : mb;
    const int e = row / m, r = row - e * m;
    const T* src = (is_a ? xa_b : xb_b) + (int64_t)row * f;
    float* dst = (is_a ? sa : sb) + e * m * f + r;
    float s = 0.f;
    for (int c = 0; c < f; ++c) {
      const float v = to_f32(src[c]);
      dst[c * m] = v;
      if constexpr (KIND == kGaussian) s = fmaf(v, v, s);
    }
    (is_a ? na : nb)[row] = s;
  }
  __syncthreads();
  const int per = ma * mb;
  const int n_out = k * per;
  T* o = out + b0 * per;
  if ((mb & 3) == 0) {
    // 4 consecutive outputs of one row a step: one 16-byte store (8 in bf16)
    for (int qi = threadIdx.x; qi < n_out >> 2; qi += THREADS) {
      const int flat = qi << 2;
      const int e = flat / per, rem = flat - e * per;
      const int r = rem / mb, c = rem - r * mb;
      const float* a = sa + e * ma * f + r;
      const float* bq = sb + e * mb * f + c;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int cc = 0; cc < f; ++cc) {
        const float av = a[cc * ma];
        const float4 bv = *reinterpret_cast<const float4*>(bq + cc * mb);
        acc[0] = accum<KIND>(acc[0], av, bv.x);
        acc[1] = accum<KIND>(acc[1], av, bv.y);
        acc[2] = accum<KIND>(acc[2], av, bv.z);
        acc[3] = accum<KIND>(acc[3], av, bv.w);
      }
      const float nav = na[e * ma + r];
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = finish<KIND>(acc[j], nav, nb[e * mb + c + j], scale);
      store_vec<4>(o + flat, v);
    }
  } else {
    for (int i = threadIdx.x; i < n_out; i += THREADS) {
      const int e = i / per, rem = i - e * per;
      const int r = rem / mb, c = rem - r * mb;
      const float* a = sa + e * ma * f + r;
      const float* bq = sb + e * mb * f + c;
      float acc = 0.f;
      for (int cc = 0; cc < f; ++cc) acc = accum<KIND>(acc, a[cc * ma], bq[cc * mb]);
      store(o + i, finish<KIND>(acc, na[e * ma + r], nb[e * mb + c], scale));
    }
  }
}

// ---- wide -------------------------------------------------------------- //
// N (4 or 8) f32 values of shared memory, 16-byte aligned.
template <int N> __device__ __forceinline__ void lds(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 u = *reinterpret_cast<const float4*>(p + i);
    v[i] = u.x; v[i + 1] = u.y; v[i + 2] = u.z; v[i + 3] = u.w;
  }
}

template <int KIND, typename T>
__global__ void __launch_bounds__(THREADS, (Wide<KIND, T>::MINB))
pairwise_block_wide(const T* __restrict__ xa, const T* __restrict__ xb, T* __restrict__ out,
                    int64_t batch, int ma, int mb, int f, float scale) {
  using W = Wide<KIND, T>;
  constexpr int RM = W::RM, RN = W::RN, TM = W::TM, TN = W::TN, SA = W::SA, SB = W::SB;
  constexpr int STAGE_ROWS = (TN + TM + THREADS - 1) / THREADS;   // rows a thread stages
  extern __shared__ __align__(16) float wd_smem[];
  float* sa = wd_smem;                   // [FC][SA]
  float* sb = sa + FC * SA;              // [FC][SB]
  float* sna = sb + FC * SB;             // [TM]
  float* snb = sna + TM;                 // [TN]
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int col0 = blockIdx.x * TN, row0 = blockIdx.y * TM;
  const bool rows16 = (mb * (int)sizeof(T)) % 16 == 0;   // each output row 16-byte aligned
  const bool interior = rows16 && row0 + TM <= ma && col0 + TN <= mb;
  for (int64_t b = blockIdx.z; b < batch; b += gridDim.z) {
    const T* xa_b = xa + b * ma * f;
    const T* xb_b = xb + b * mb * f;
    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
    for (int c0 = 0; c0 < f; c0 += FC) {
      const int kc = f - c0 < FC ? f - c0 : FC;
      __syncthreads();                   // the last chunk's (or entry's) readers are done
      // a thread a row: xb's TN rows, then xa's TM; its features, its norm.
      // In bf16 there are TN + TM = 288 rows, so warp 0 stages two: every
      // load of the thread is issued before its first shared-memory store,
      // so that its second row does not wait a memory round trip behind the
      // first while the other warps wait at the barrier.
      float v[STAGE_ROWS][FC];
#pragma unroll
      for (int it = 0; it < STAGE_ROWS; ++it) {
        const int i = tid + it * THREADS;
        const bool is_b = i < TN;
        const int r = is_b ? i : i - TN;
        const int gr = (is_b ? col0 : row0) + r;
        const bool live = i < TN + TM && gr < (is_b ? mb : ma);
        const T* src = (is_b ? xb_b : xa_b) + (int64_t)gr * f + c0;
#pragma unroll
        for (int c = 0; c < FC; ++c) v[it][c] = (live && c < kc) ? to_f32(src[c]) : 0.f;
      }
#pragma unroll
      for (int it = 0; it < STAGE_ROWS; ++it) {
        const int i = tid + it * THREADS;
        if (i < TN + TM) {
          const bool is_b = i < TN;
          const int r = is_b ? i : i - TN;
          float* dst = (is_b ? sb : sa) + r;
          const int stride = is_b ? SB : SA;
          float* nrm = (is_b ? snb : sna) + r;
          float s = c0 == 0 ? 0.f : *nrm;
#pragma unroll
          for (int c = 0; c < FC; ++c) {
            dst[c * stride] = v[it][c];
            if constexpr (KIND == kGaussian) { if (c < kc) s = fmaf(v[it][c], v[it][c], s); }
          }
          *nrm = s;
        }
      }
      __syncthreads();
      for (int c = 0; c < kc; ++c) {
        float a[RM], bv[RN];
        lds<RM>(sa + c * SA + ty * RM, a);
        lds<RN>(sb + c * SB + tx * RN, bv);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = accum<KIND>(acc[i][j], a[i], bv[j]);
      }
    }
    float nb[RN];
#pragma unroll
    for (int j = 0; j < RN; ++j) nb[j] = KIND == kGaussian ? snb[tx * RN + j] : 0.f;
    T* out_b = out + b * ma * mb;
    const int cb = col0 + tx * RN;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = row0 + ty * RM + i;
      const float na = KIND == kGaussian ? sna[ty * RM + i] : 0.f;
      float e[RN];
#pragma unroll
      for (int j = 0; j < RN; ++j) e[j] = finish<KIND>(acc[i][j], na, nb[j], scale);
      T* o = out_b + (int64_t)r * mb + cb;
      if (interior) {
        store_vec<RN>(o, e);
      } else if (r < ma) {
        if (rows16 && cb + RN <= mb) {
          store_vec<RN>(o, e);
        } else {
#pragma unroll
          for (int j = 0; j < RN; ++j)
            if (cb + j < mb) store(o + j, e[j]);
        }
      }
    }
  }
}

// One launch of a plan of kernels/pairwise.py: family, grid (gx, gy, gz), the
// dynamic shared memory (checked against smem_bytes), param (skinny: the
// row bucket, 2/4/8/16; packed: entries a block) and flags (skinny: kVecLoad).
template <int KIND, typename T>
int launch_pairwise(const void* xa, const void* xb, void* out, int64_t batch, int64_t ma,
                    int64_t mb, int64_t f, float scale, int family, int gx, int gy, int gz,
                    int smem, int param, int flags, void* stream) {
  if (gx < 1 || gy < 1 || gz < 1 || gy > 65535 || gz > 65535
      || smem != smem_bytes<T>(family, ma, mb, f, param))
    return kBadPlan;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)gz);
  const T* a = (const T*)xa;
  const T* b = (const T*)xb;
  T* o = (T*)out;
  switch (family) {
    case kSkinny:
      if (ma > param || gz != 1) return kBadPlan;
      switch (param) {
        case 2: pairwise_block_skinny<KIND, T, 2><<<grid, THREADS, smem, s>>>(
                    a, b, o, batch, (int)ma, mb, (int)f, scale, flags); break;
        case 4: pairwise_block_skinny<KIND, T, 4><<<grid, THREADS, smem, s>>>(
                    a, b, o, batch, (int)ma, mb, (int)f, scale, flags); break;
        case 8: pairwise_block_skinny<KIND, T, 8><<<grid, THREADS, smem, s>>>(
                    a, b, o, batch, (int)ma, mb, (int)f, scale, flags); break;
        case 16: pairwise_block_skinny<KIND, T, 16><<<grid, THREADS, smem, s>>>(
                     a, b, o, batch, (int)ma, mb, (int)f, scale, flags); break;
        default: return kBadPlan;
      }
      break;
    case kPacked:
      if (param < 1 || gy != 1 || gz != 1 || (int64_t)gx * param < batch
          || ma * mb * param > (1 << 30))
        return kBadPlan;
      pairwise_block_packed<KIND, T><<<grid, THREADS, smem, s>>>(
          a, b, o, batch, (int)ma, (int)mb, (int)f, scale, param);
      break;
    case kWide: {
      using W = Wide<KIND, T>;
      if (ma >= (int64_t)1 << 31 || mb >= (int64_t)1 << 31
          || (int64_t)gx * W::TN < mb || (int64_t)gy * W::TM < ma)
        return kBadPlan;
      pairwise_block_wide<KIND, T><<<grid, THREADS, smem, s>>>(
          a, b, o, batch, (int)ma, (int)mb, (int)f, scale);
      break;
    }
    default:
      return kBadPlan;
  }
  return (int)cudaGetLastError();
}

}  // namespace
