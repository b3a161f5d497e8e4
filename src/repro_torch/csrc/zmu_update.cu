// Fused ADMM z-projection and multiplier update over a flat f32 block:
//   z = clip(x - mu * (1/beta), 0, c),   mu_out = mu - beta * (x - z).
//
// Replaces: repro/kernels/admm_update/kernel.py::fused_zmu_update_pallas.
// Like that kernel it multiplies by 1/beta (rounded to f32 by the caller);
// the plain version divides by beta, so the two agree to rounding, not bit
// for bit.  The products are kept out of FMA contraction (__fmul_rn) so the
// only difference from the plain version is that reciprocal.
//
// Bound on this card: bytes.  Three f32 reads and two f32 writes per
// element, 20 bytes, and 6 flops; at d*k = 2^20 that is 21 MB, about 6 us at
// 3.35 TB/s.  Design: one grid-stride loop, consecutive threads on
// consecutive elements, so every load and store is coalesced.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void zmu_update_kernel(const float* __restrict__ x, const float* __restrict__ mu,
                                  const float* __restrict__ c, float* __restrict__ z,
                                  float* __restrict__ mu_out, int64_t n, float inv_beta,
                                  float beta) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float xi = x[i], mi = mu[i];
    const float zi = fminf(fmaxf(xi - __fmul_rn(mi, inv_beta), 0.f), c[i]);
    z[i] = zi;
    mu_out[i] = mi - __fmul_rn(beta, xi - zi);
  }
}

}  // namespace

extern "C" int zmu_update_f32(const void* x, const void* mu, const void* c, void* z,
                              void* mu_out, int64_t n, float inv_beta, float beta,
                              void* stream) {
  constexpr int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  zmu_update_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)mu, (const float*)c, (float*)z, (float*)mu_out, n,
      inv_beta, beta);
  return (int)cudaGetLastError();
}
