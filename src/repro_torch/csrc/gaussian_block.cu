// Batched Gaussian kernel block: out[b] = exp(-max(|xa|^2 + |xb|^2 - 2 xa xb^T, 0) / 2h^2).
//
// Replaces: repro/kernels/gaussian/kernel.py::gaussian_block_pallas (the TPU
// tile kernel), with the norm rule of repro/core/kernelfn.py::_sqdist: the
// row norms and the cross term are summed in f32 whatever the input type,
// and the block is stored in the input type (f32 or bf16).
//
// Each output costs 2F+5 flops against 4 bytes stored, so the bytes bound:
// the 2048 x 2^20 scoring block's flops need about 0.7 ms at the 67 TFLOP/s
// f32 rate against its 2.6 ms of writes.  The kernels and their launch
// plans (skinny, packed, wide) are those of pairwise_block.cuh, shared with
// the laplacian block (K4); kernels/pairwise.py chooses the plan.
#include "pairwise_block.cuh"

// scale = -0.5 / h^2 (rounded to f32 by the caller, as the reference does);
// family, gx, gy, gz, smem, param, flags: the plan (kernels/pairwise.py).
extern "C" int gaussian_block_f32(const void* xa, const void* xb, void* out,
                                  int64_t batch, int64_t ma, int64_t mb, int64_t f,
                                  float scale, int family, int gx, int gy, int gz, int smem,
                                  int param, int flags, void* stream) {
  return launch_pairwise<kGaussian, float>(xa, xb, out, batch, ma, mb, f, scale, family,
                                           gx, gy, gz, smem, param, flags, stream);
}

extern "C" int gaussian_block_bf16(const void* xa, const void* xb, void* out,
                                   int64_t batch, int64_t ma, int64_t mb, int64_t f,
                                   float scale, int family, int gx, int gy, int gz, int smem,
                                   int param, int flags, void* stream) {
  return launch_pairwise<kGaussian, __nv_bfloat16>(xa, xb, out, batch, ma, mb, f, scale,
                                                   family, gx, gy, gz, smem, param, flags, stream);
}

// The kernels' own count of a plan's dynamic shared memory (-1: no family).
extern "C" long long gaussian_block_smem_bytes(int elem_bytes, int family, int64_t ma,
                                               int64_t mb, int64_t f, int param) {
  return elem_bytes == 2 ? smem_bytes<__nv_bfloat16>(family, ma, mb, f, param)
                         : smem_bytes<float>(family, ma, mb, f, param);
}
