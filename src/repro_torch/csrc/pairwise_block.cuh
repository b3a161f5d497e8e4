// The batched pairwise kernel block shared by gaussian_block.cu (K1) and
// laplacian_block.cu (K4): out[b] = K(xa[b], xb[b]) for (B, Ma, F) x (B, Mb, F),
// accumulated in f32 whatever the input type, stored in the input type.
//
// Bound on this card: bytes written.  The feature width F is small (8 for
// the SVM data), so each output costs a few operations per feature against
// 4 bytes stored; the 2048 x 2^20 scoring block is 8.6 GB of output, about
// 2.6 ms at 3.35 TB/s.
//
// Design: one 64 x 128 output tile per block of 32 x 8 threads.  Both row
// tiles go through shared memory in F-chunks of 8 (feature-major, so the
// inner loop broadcasts an xa value across the warp and reads consecutive
// xb values); each thread keeps an 8 x 4 sub-tile of accumulators in
// registers and writes it so that the 32 lanes of a warp store 32
// consecutive outputs of one row.  The kinds differ only in the inner
// accumulate and the epilogue:
//   kGaussian:  one FMA per feature for the cross term, plus the two row
//               norms; exp(max(|a|^2 + |b|^2 - 2 a.b, 0) * scale),
//               scale = -1/2h^2;
//   kLaplacian: one fabsf-add per feature (the |.| is an operand modifier
//               of the add), summed in feature order as the plain version
//               does; exp(d1 * scale), scale = -f32(1/h).
// expf, not __expf: the plain versions' exp is the accurate one.  The
// ragged edge is masked (zero-filled loads, skipped stores) instead of
// padded as the TPU wrappers did.  All offsets are 64-bit: the scoring
// block alone has 2^31 entries.  The batch sits on grid.z, which holds
// 65535: a larger batch (10^7 points make 131072 leaves at leaf 128)
// launches in chunks of 65535.  Folding the batch into grid.x instead costs
// an integer division per thread, which made leaf D 4-17% slower on the
// card (PERF.md).
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

enum PairKind { kGaussian = 0, kLaplacian = 1 };

constexpr int TX = 32, TY = 8;          // 256 threads
constexpr int TM = 64, TN = 128;        // output tile
constexpr int RM = TM / TY, RN = TN / TX;
constexpr int FC = 8;                   // feature chunk staged in shared memory
constexpr int64_t MAX_GRID_Z = 65535;   // batch entries per launch

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <int KIND, typename T>
__global__ void __launch_bounds__(TX * TY)
pairwise_block_kernel(const T* __restrict__ xa, const T* __restrict__ xb,
                      T* __restrict__ out, int64_t ma, int64_t mb, int64_t f,
                      float scale) {
  __shared__ float sa[FC][TM + 1];
  __shared__ float sb[FC][TN + 1];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int64_t b = blockIdx.z;
  const int64_t row0 = (int64_t)blockIdx.y * TM, col0 = (int64_t)blockIdx.x * TN;
  const T* xa_b = xa + b * ma * f;
  const T* xb_b = xb + b * mb * f;

  // na, nb: the gaussian row norms (dead code for the laplacian kind).
  float acc[RM][RN], na[RM], nb[RN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    na[i] = 0.f;
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < RN; ++j) nb[j] = 0.f;

  for (int64_t c0 = 0; c0 < f; c0 += FC) {
    for (int idx = tid; idx < TM * FC; idx += TX * TY) {
      const int r = idx / FC, c = idx % FC;
      const int64_t gr = row0 + r, gc = c0 + c;
      sa[c][r] = (gr < ma && gc < f) ? to_f32(xa_b[gr * f + gc]) : 0.f;
    }
    for (int idx = tid; idx < TN * FC; idx += TX * TY) {
      const int r = idx / FC, c = idx % FC;
      const int64_t gr = col0 + r, gc = c0 + c;
      sb[c][r] = (gr < mb && gc < f) ? to_f32(xb_b[gr * f + gc]) : 0.f;
    }
    __syncthreads();
    const int cmax = (int)((f - c0) < FC ? (f - c0) : FC);
    for (int c = 0; c < cmax; ++c) {
      float a[RM], bv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        a[i] = sa[c][ty + i * TY];
        if constexpr (KIND == kGaussian) na[i] += a[i] * a[i];
      }
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        bv[j] = sb[c][tx + j * TX];
        if constexpr (KIND == kGaussian) nb[j] += bv[j] * bv[j];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          if constexpr (KIND == kGaussian) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
          else acc[i][j] += fabsf(a[i] - bv[j]);
        }
    }
    __syncthreads();
  }

  T* out_b = out + b * ma * mb;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t r = row0 + ty + i * TY;
    if (r >= ma) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int64_t col = col0 + tx + j * TX;
      if (col >= mb) continue;
      float e;
      if constexpr (KIND == kGaussian) e = fmaxf((na[i] + nb[j]) - 2.f * acc[i][j], 0.f);
      else e = acc[i][j];
      store(out_b + r * mb + col, expf(e * scale));
    }
  }
}

template <int KIND, typename T>
int launch_pairwise(const void* xa, const void* xb, void* out, int64_t batch,
                    int64_t ma, int64_t mb, int64_t f, float scale, void* stream) {
  const dim3 block(TX, TY);
  for (int64_t b0 = 0; b0 < batch; b0 += MAX_GRID_Z) {
    const int64_t nb = batch - b0 < MAX_GRID_Z ? batch - b0 : MAX_GRID_Z;
    const dim3 grid((unsigned)((mb + TN - 1) / TN), (unsigned)((ma + TM - 1) / TM),
                    (unsigned)nb);
    pairwise_block_kernel<KIND, T><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const T*)xa + b0 * ma * f, (const T*)xb + b0 * mb * f,
        (T*)out + b0 * ma * mb, ma, mb, f, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace
